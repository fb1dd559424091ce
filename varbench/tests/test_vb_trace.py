"""The trace's reduction, on a hand-made timeline (times in us)."""

from types import SimpleNamespace

import pytest
import torch

from varbench.harness import trace

CUDA = torch.autograd.DeviceType.CUDA
CPU = torch.autograd.DeviceType.CPU


def ev(name, a, b, device=CPU, thread=1):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=a,
                                                                 end=b),
                           device_type=device, thread=thread)


def test_reduce_busy_idle_and_names():
    events = [
        ev("void spin_kernel(long)", 0, 10, CUDA),
        ev("void early_kernel()", 11, 12, CUDA),  # before the window
        ev("varbench.window", 20, 100),
        ev("varbench.request", 25, 58),
        ev("aten::x", 28, 38),
        ev("varbench.request", 62, 95),
        ev("varbench.request", 25, 58, CUDA),  # an annotation, not work
        ev("kernel_a", 40, 50, CUDA),
        ev("kernel_b", 70, 75, CUDA),
        ev("kernel_a", 74, 80, CUDA),  # overlaps kernel_b
        ev("aten::other_thread", 85, 99, thread=2),
    ]
    r = trace.reduce(events)
    assert r["busy_s"] == pytest.approx(20e-6)
    assert r["window_s"] == pytest.approx(80e-6)
    assert r["device_ops"] == 3
    assert r["device_ops_top"][0] == ["kernel_a", pytest.approx(16e-6)]
    gaps = dict(r["idle_gaps"])
    assert gaps == {"varbench.request/aten::x": pytest.approx(20e-6),
                    "varbench.window": pytest.approx(20e-6),
                    "varbench.request": pytest.approx(20e-6)}


def test_no_pad_reads_nothing():
    assert trace.reduce([ev("varbench.window", 0, 10),
                         ev("kernel", 1, 2, CUDA)]) is None
