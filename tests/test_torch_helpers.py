"""Port parity for the carried-over helpers on the CPU: `native` (the
ctypes bindings of `native/libgrid_builder.so`), `utils/profiling.py`
(`StageTimer`, `trace_to`) and `plots.py`, each against its JAX-package
counterpart on the same inputs."""

import glob
import json
import os
import subprocess
import sys
import time

import matplotlib

matplotlib.use("Agg")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from copula_var_tpu import native as jnative  # noqa: E402
from copula_var_tpu import plots as jplots  # noqa: E402
from copula_var_tpu.ops.grids import garch_grid, msm_grid  # noqa: E402
from copula_var_tpu.utils import profiling as jprof  # noqa: E402
from copula_var_tpu_torch import native as tnative  # noqa: E402
from copula_var_tpu_torch import plots as tplots  # noqa: E402
from copula_var_tpu_torch.ops import quadrature as tq  # noqa: E402
from copula_var_tpu_torch.utils import profiling as tprof  # noqa: E402

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = np.array([0.3, 0.7])
BOUNDS = [(-100.0, -3.0), (-3.5, -2.0), (-7.5, 0.0), (-2.0, 1.5),
          (-100.0, -1.0), (-100.0, 100.0)]


def test_native_grid_equals_jax_bindings(rng):
    assert tnative.available()
    n, q = 24, 3
    x, dx = msm_grid(n)
    vols = np.sort(rng.uniform(0.5, 1.5, size=(2, q)), axis=1)
    dens = np.exp(-0.5 * (x[None, None, :] / vols[:, :, None]) ** 2) / (
        np.sqrt(2 * np.pi) * vols[:, :, None])
    combos = np.stack(np.meshgrid(np.arange(q), np.arange(q), indexing="ij"),
                      axis=-1).reshape(-1, 2)
    for lo, up in BOUNDS[:4]:
        got_g, got_d = tnative.build_nested_grid(x, dx, dens, combos, lo, up,
                                                 WEIGHTS)
        want_g, want_d = jnative.build_nested_grid(x, dx, dens, combos, lo,
                                                   up, WEIGHTS)
        assert got_g.shape[1] == 2 and got_d.shape == (got_g.shape[0], q * q)
        np.testing.assert_array_equal(got_g, want_g)
        np.testing.assert_array_equal(got_d, want_d)
    with pytest.raises(ValueError, match="state indices"):
        tnative.build_nested_grid(x, dx, dens, combos + q, -3.5, -2.0,
                                  WEIGHTS)


def test_native_masked_integrals_equal_jax_and_the_plain_sweep(rng):
    """The bindings equal JAX's on the same library; the library equals
    the port's plain dim-2 sweep at rtol 1e-10. The library is built with
    -O3 -march=native, where g++ fuses x0 w1 into the bound's subtraction
    (a fused multiply-add) and the plain sweep rounds the product first:
    on bounds that put the inner cut exactly on a grid point they may
    include different cells. So the plain sweep is held at weights (0.5,
    0.5), whose products are exact (JAX's own test), and at unequal
    weights on bounds off the round grid values."""
    x, dx = garch_grid(32)
    T = len(BOUNDS)
    fv = rng.uniform(0.7, 1.5, size=(T, 2))
    corr = torch.tensor([[1.0, 0.45], [0.45, 1.0]], dtype=torch.float64)
    V = tq.garch_day_tensors(torch.as_tensor(fv), torch.as_tensor(x),
                             tq.CopulaSpec("gaussian", (corr,)))
    bounds = np.array(BOUNDS)
    got = tnative.masked_integrals(V.numpy(), x, dx, bounds, WEIGHTS)
    want = jnative.masked_integrals(V.numpy(), x, dx, bounds, WEIGHTS)
    np.testing.assert_array_equal(got, want)
    off_grid = bounds - 0.0123
    for b, w in ((bounds, np.array([0.5, 0.5])), (off_grid, WEIGHTS)):
        got = tnative.masked_integrals(V.numpy(), x, dx, b, w)
        plain = tq.garch_integrals_cached(
            torch.as_tensor(b), V, torch.as_tensor(x), torch.as_tensor(dx),
            torch.as_tensor(w))
        np.testing.assert_allclose(got, plain.numpy(), rtol=1e-10)
    with pytest.raises(ValueError, match="day_tensors"):
        tnative.masked_integrals(V.numpy()[:, :4], x, dx, bounds, WEIGHTS)


def test_native_import_loads_nothing():
    """Importing the port's native module neither loads nor builds the
    library, and pulls in nothing of JAX."""
    code = """
import sys
sys.modules["jax"] = None
import copula_var_tpu_torch.native as m
assert m._load.cache_info().currsize == 0
leaked = [k for k, mod in sys.modules.items() if mod is not None
          and k.split(".")[0] in ("jax", "copula_var_tpu")]
assert not leaked, leaked
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=dict(os.environ, PYTHONPATH=ROOT),
                         timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_stage_timer_reports_as_jax(monkeypatch):
    clock = iter(np.arange(0.0, 100.0, 0.25))
    # the JAX timer reads time.time, the port's time.perf_counter
    for fn in ("time", "perf_counter"):
        monkeypatch.setattr(time, fn, lambda: float(next(clock)))
    reports = []
    for mod in (tprof, jprof):
        timer = mod.StageTimer()
        for name in ("solve", "prep", "solve"):
            with timer.stage(name):
                pass
        assert timer.totals == {"solve": 0.5, "prep": 0.25}
        assert timer.counts == {"solve": 2, "prep": 1}
        reports.append(timer.report())
    assert reports[0] == reports[1]
    assert reports[0] == ("prep: 0.250s over 1 call(s)\n"
                          "solve: 0.500s over 2 call(s)")


def test_trace_to_writes_a_trace(tmp_path):
    with tprof.trace_to(None):
        torch.ones(3).sum()
    logdir = str(tmp_path / "trace")
    with tprof.trace_to(logdir):
        (torch.arange(64.0).reshape(8, 8) @ torch.ones(8)).sum()
    files = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        trace = json.load(f)
    assert any(e.get("name", "").startswith("aten::") for e in
               trace["traceEvents"])


def _lines(fig):
    return [[np.asarray(line.get_ydata()) for line in ax.get_lines()]
            for ax in fig.axes]


def _same_figure(got, want):
    assert [ax.get_title() for ax in got.axes] == \
        [ax.get_title() for ax in want.axes]
    g, w = _lines(got), _lines(want)
    assert [len(a) for a in g] == [len(a) for a in w]
    for ga, wa in zip(g, w):
        for gl, wl in zip(ga, wa):
            np.testing.assert_array_equal(gl, wl)


def test_plots_draw_the_jax_figures(rng):
    import matplotlib.pyplot as plt

    T = 40
    ret = rng.standard_normal(T)
    var = np.full(T, -1.2) + 0.1 * rng.standard_normal(T)
    probs = rng.dirichlet(np.ones(4), size=T)
    states = rng.integers(0, 4, T)
    marg = rng.uniform(size=(T, 2))
    eps = rng.standard_normal((T, 2))
    cases = [
        ("var_vs_returns", ({"msm": var}, ret), ({"msm": torch.tensor(var)},
                                                 torch.tensor(ret))),
        ("var_vs_returns", ({"a": var, "b": var - 0.5}, ret),
         ({"a": var, "b": torch.tensor(var - 0.5)}, ret)),
        ("msm_state_probabilities", (probs, states),
         (torch.tensor(probs), torch.tensor(states))),
        ("marginals_and_innovations", (marg, eps[:, 0], eps[:, 1]),
         (torch.tensor(marg), torch.tensor(eps[:, 0]), eps[:, 1])),
        ("residual_series", (eps[:, 0],), (torch.tensor(eps[:, 0]),)),
    ]
    for name, jargs, targs in cases:
        got = getattr(tplots, name)(*targs)
        want = getattr(jplots, name)(*jargs)
        assert isinstance(got, matplotlib.figure.Figure)
        _same_figure(got, want)
        plt.close(got)
        plt.close(want)
