"""The closed loop: one caller, each request sent when the last one's
result is in hand (the library is synchronous and has no queue).

The window starts requests until `seconds` have passed and ends when the
last one started is answered, so its length holds whole requests only. A
traced window instead runs exactly `count` requests. Each request is
timed by the host's clock from the call to its numpy result in hand, as
the caller waits for it.
"""

from __future__ import annotations

import time
import traceback

import numpy as np


class Window:
    """What a window did: requests attempted and failed, its length, the
    rows answered, each request's latency, and the requests kept for the
    check with their results."""

    def __init__(self):
        self.attempted = 0
        self.failed = 0
        self.errors = []
        self.elapsed_s = 0.0
        self.rows = 0
        self.latency_s = []
        self.kept = []  # (index, request, result)


class Reservoir:
    """A uniform sample of `k` of the requests, drawn by `rng`."""

    def __init__(self, k: int, rng):
        self.k, self.rng, self.items, self.seen = k, rng, [], 0

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
            return
        j = int(self.rng.integers(self.seen))
        if j < self.k:
            self.items[j] = item


def run(serve, traffic, cuda: bool, keep, seconds=None, count=None,
        span=None):
    """Run the window over `traffic` through `serve(request) -> (R, T)`;
    `keep` is a Reservoir (or None to keep every request). Exactly one of
    `seconds` and `count` is given."""
    import contextlib

    span = span or (lambda name: contextlib.nullcontext())
    win = Window()
    if cuda:
        import torch

        torch.cuda.synchronize()
    with span("varbench.window"):
        t0 = time.perf_counter()
        while (win.attempted < count if count is not None
               else time.perf_counter() - t0 < seconds):
            request = traffic.next()
            win.attempted += 1
            t_call = time.perf_counter()
            try:
                out = np.asarray(serve(request))
            except Exception:  # a request that raises is failed, not fatal
                win.failed += 1
                if len(win.errors) < 3:
                    win.errors.append(traceback.format_exc())
                continue
            win.latency_s.append(time.perf_counter() - t_call)
            win.rows += out.shape[0]
            item = (win.attempted - 1, request, out)
            if keep is None:
                win.kept.append(item)
            else:
                keep.offer(item)
        if cuda:
            torch.cuda.synchronize()
        win.elapsed_s = time.perf_counter() - t0
    if keep is not None:
        win.kept = sorted(keep.items, key=lambda item: item[0])
    return win
