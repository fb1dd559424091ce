"""The benchmark of `copula_var_tpu_torch` on one NVIDIA GPU.

    python3 varbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout. The last line of standard output is the
run's result as one JSON object; the compared numbers and their limits
are the last lines of standard error. See varbench/README.md.
"""

import time

T_START = time.perf_counter()  # set-up counts from here

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def prepare_environment() -> None:
    """Before torch is imported: every kernel cache at a fixed path
    inside the checkout (the port's own nvcc builds go to
    build/torch_kernels/), few threads, and the checkout importable."""
    caches = ROOT / "build" / "varbench"
    os.environ["TRITON_CACHE_DIR"] = str(caches / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(caches / "torch_extensions")
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS",
                "OPENBLAS_NUM_THREADS"):
        os.environ.setdefault(var, "1")
    sys.path.insert(0, str(ROOT))


if __name__ == "__main__":
    prepare_environment()
    from varbench.harness.main import main

    sys.exit(main(sys.argv[1:], T_START))
