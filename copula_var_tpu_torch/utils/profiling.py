"""Tracing and profiling hooks (counterpart of
`copula_var_tpu/utils/profiling.py`), the port's one tracing system.

  * `span(name)`: the port's span "cvt.<name>" around a stage, recorded
    by any running torch profiler (`trace_to`, or a caller's own
    `torch.profiler.profile`) on the clock it gives the device's
    activities, kept in its memory and written by its own exporter. A
    span's parent is the span that encloses it. With no profiler
    recording, `span` returns one shared no-op context and records
    nothing (one flag read). Spans are cpu_op events
    (`torch._C._profiler._RecordFunctionFast`), not user annotations, so
    the device's timeline gets no copy of them. The spans and what reads
    them are listed in PERF.md.
  * `count(name, n)` / `counters()` / `reset_counters()`: one table of
    ints, always on: `launch.<wrapper>` (`.f32`) for each kernel launch,
    `solve.halvings`, `prep.table_bytes`, `prep.flag_bytes`,
    `prep.flagged_rows`, `build.compiled` / `build.loaded`, and
    `t_ppf.passes` / `betainc.passes`, one for each pass of their loops,
    each counted beside the host read that ends the pass (the spans
    `cvt.sync.t_ppf` / `cvt.sync.betainc`), so counting reads nothing.
  * `StageTimer`: named-stage wall timing (the host's `perf_counter`),
    as a dict, with the JAX module's `report()` format; each stage is
    also a span.
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

import torch
import torch.autograd.profiler as _autograd_profiler

logger = logging.getLogger("copula_var_tpu_torch")

PREFIX = "cvt."
_OFF = contextlib.nullcontext()  # the span of an unrecorded stage
# the recorder of a span: a cpu_op event, where record_function's user
# annotation would also be copied onto the device's timeline over the
# kernels it launches (and counted there as device work)
_Recorder = torch._C._profiler._RecordFunctionFast
_counts: Dict[str, int] = {}


def span(name: str):
    """The context of stage `name`: the span "cvt." + name while a torch
    profiler records, else the shared no-op."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Recorder(PREFIX + name)


def count(name: str, n: int = 1) -> None:
    """Add `n` to counter `name`."""
    _counts[name] = _counts.get(name, 0) + n


def counters() -> Dict[str, int]:
    """A copy of every counter."""
    return dict(_counts)


def reset_counters() -> None:
    """Clear every counter."""
    _counts.clear()


class StageTimer:
    """Accumulates wall time per named stage (each stage is also the
    span `name`).

    with timer.stage("integration"): ...
    timer.totals -> {"integration": 1.23, ...}
    """

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            with span(name):
                yield self
        finally:
            dt = time.perf_counter() - t0
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
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)):
        yield
