"""The run's guard against JAX and the JAX package: whole top-level
names."""

from varbench.harness.imports import forbidden_loaded


def test_catches_jax_and_the_jax_package():
    assert forbidden_loaded({"jax": 0, "numpy": 0}) == ["jax"]
    assert forbidden_loaded({"jax.numpy": 0}) == ["jax"]
    assert forbidden_loaded({"jaxlib.xla_client": 0}) == ["jaxlib"]
    assert forbidden_loaded({"flax": 0}) == ["flax"]
    assert forbidden_loaded({"copula_var_tpu": 0}) == ["copula_var_tpu"]
    assert forbidden_loaded({"copula_var_tpu.ops.quadrature": 0}) == [
        "copula_var_tpu"]


def test_passes_the_port_and_lookalikes():
    names = {"copula_var_tpu_torch": 0, "copula_var_tpu_torch.ops": 0,
             "jaxtyping": 0, "flaxen": 0, "torch": 0, "varbench": 0}
    assert forbidden_loaded(names) == []


def test_the_harness_and_the_port_load_neither():
    """A fresh process that imports the harness, the reference and the
    port's serving path holds none of the forbidden names."""
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[2]
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "import varbench.harness.main, varbench.harness.program, "
            "varbench.harness.faults, varbench.reference.msm_student; "
            "import copula_var_tpu_torch.backtest, "
            "copula_var_tpu_torch.utils.artifacts, "
            "copula_var_tpu_torch.data; "
            "from varbench.harness.imports import forbidden_loaded; "
            "print(forbidden_loaded())")
    out = subprocess.run([sys.executable, "-c", code, str(root)],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
