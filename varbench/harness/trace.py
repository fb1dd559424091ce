"""The traced window: torch.profiler over the card (CUPTI) and the host,
and its reduction to the device's busy time, its activities, the kernels
that took most time and the idle gaps named by what the host was doing.

torch.profiler has been seen to drop a session's first device
activities on the H100, so each session first launches PAD spin kernels
and only what follows the last pad recorded is read; a session that lost
every pad is run again, up to ATTEMPTS times, and then reads nothing.
The harness's spans (`varbench.*`, torch.profiler.record_function around
each call into the program) name the idle gaps.
"""

from __future__ import annotations

import collections

PAD = 128
PAD_CYCLES = 10000  # ~5 us each
PAD_NAME = "spin_kernel"  # torch.cuda._sleep's kernel
ATTEMPTS = 3
WINDOW_SPAN = "varbench.window"
TOP = 10


def span(name):
    """The harness's span `name`, recorded in the trace."""
    from torch.profiler import record_function

    return record_function(name)


def profiled(fn):
    """Run `fn()` under torch.profiler after the pad kernels; returns
    (fn's result, the trace's reduction, or None when every session lost
    every pad)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(ATTEMPTS):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(PAD):
                torch.cuda._sleep(PAD_CYCLES)
            torch.cuda.synchronize()
            result = fn()
        reduced = reduce(prof.events())
        if reduced is not None:
            return result, reduced
    return result, None


def _union(intervals):
    """Total length of the union of (start, end) intervals, and the
    merged intervals in order."""
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return sum(b - a for a, b in merged), merged


def reduce(events):
    """{busy_s, window_s, device_ops, device_ops_top, idle_gaps} of the
    traced window, times in seconds, or None if no pad was recorded."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    # the device's activities; the harness's spans also appear on the
    # device's timeline (as annotations), and are not work
    device = sorted((e.time_range.start, e.time_range.end, e.name)
                    for e in events if e.device_type == cuda
                    and not e.name.startswith("varbench."))
    pads = [i for i, (_, _, name) in enumerate(device) if PAD_NAME in name]
    windows = [e for e in events
               if e.device_type != cuda and e.name == WINDOW_SPAN]
    if not pads or not windows:
        return None
    win = windows[-1]
    w0, w1 = win.time_range.start, win.time_range.end
    after = device[pads[-1] + 1:]
    device = [(max(a, w0), min(b, w1), name) for a, b, name in after
              if b > w0 and a < w1]
    busy_us, merged = _union([(a, b) for a, b, _ in device])
    by_name = collections.Counter()
    for a, b, name in device:
        by_name[name[:120]] += (b - a) / 1e6
    host = sorted(((e.time_range.start, e.time_range.end, e.name)
                   for e in events
                   if e.device_type != cuda and e.thread == win.thread
                   and w0 <= e.time_range.start < w1),
                  key=lambda s: (s[0], -s[1]))
    gaps = []
    edge = w0
    for a, b in merged + [[w1, w1]]:
        if a > edge:
            gaps.append((edge, a))
        edge = max(edge, b)
    return {"busy_s": busy_us / 1e6, "window_s": (w1 - w0) / 1e6,
            "device_ops": len(device),
            "device_ops_top": [[k, v] for k, v in by_name.most_common(TOP)],
            "idle_gaps": _name_gaps(gaps, host)}


def _name_gaps(gaps, host):
    """Idle seconds summed by what the host was doing in each gap (at its
    midpoint): the innermost harness span and the innermost operation
    under it, as "span/op"; the TOP largest, as [name, seconds]."""
    total = collections.Counter()
    mids = sorted(((a + b) / 2.0, b - a) for a, b in gaps)
    stack, k = [], 0
    for mid, length in mids:
        while k < len(host) and host[k][0] <= mid:
            stack = [s for s in stack if s[1] >= host[k][0]]
            stack.append(host[k])
            k += 1
        open_ = [s for s in stack if s[1] >= mid]
        spans = [s[2] for s in open_ if s[2].startswith("varbench.")]
        ops = [s[2] for s in open_ if not s[2].startswith("varbench.")]
        where = spans[-1] if spans else "host"
        if ops:
            where = f"{where}/{ops[-1]}"
        total[where[:120]] += length / 1e6
    return [[k, v] for k, v in total.most_common(TOP)]
