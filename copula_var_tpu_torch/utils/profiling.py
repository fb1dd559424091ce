"""Tracing and profiling hooks (counterpart of
`copula_var_tpu/utils/profiling.py`).

  * `StageTimer`: named-stage wall timing, as a dict, with the JAX
    module's `report()` format.
  * `trace_to`: a context manager around `torch.profiler` that writes a
    TensorBoard-loadable trace (`<host>_<pid>.<ms>.pt.trace.json`) of the
    host work and, when a GPU is present, of the device work; a no-op for
    a logdir of None. A CUDA launch returns before the device finishes,
    so a stage that ends in device work should synchronize inside it.
"""

from __future__ import annotations

import contextlib
import logging
import time
from typing import Dict, Optional

logger = logging.getLogger("copula_var_tpu_torch")


class StageTimer:
    """Accumulates wall time per named stage.

    with timer.stage("integration"): ...
    timer.totals -> {"integration": 1.23, ...}
    """

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.time()
        try:
            yield self
        finally:
            dt = time.time() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1
            logger.debug("stage %s: %.4fs (total %.4fs)", name, dt,
                         self.totals[name])

    def report(self) -> str:
        lines = [
            f"{name}: {tot:.3f}s over {self.counts[name]} call(s)"
            for name, tot in sorted(self.totals.items())
        ]
        return "\n".join(lines)


@contextlib.contextmanager
def trace_to(logdir: Optional[str]):
    """torch.profiler trace written into `logdir` on exit; no-op when
    logdir is None."""
    if logdir is None:
        yield
        return
    import torch
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)):
        yield
