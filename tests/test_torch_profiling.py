"""The port's spans and counters (`copula_var_tpu_torch/utils/profiling.py`):
the off path creates nothing, the gate is the profiler's own flag, a span
is a cpu_op event (the device's timeline gets no copy of it), the solve's
and the prep's spans nest as PERF.md lists them on the CPU route at dim 2
and 3, and the counters count halvings, launches, table bytes and builds
(the last three on the card only), and the row flags' bytes and flagged
rows (on the CPU twin and on the card)."""

import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from copula_var_tpu_torch.data import from_csv, from_returns
from copula_var_tpu_torch.ops import _build
from copula_var_tpu_torch.ops import cuda_quadrature as cq
from copula_var_tpu_torch.ops import cuda_quadrature3 as cq3
from copula_var_tpu_torch.ops import cuda_solver as cs
from copula_var_tpu_torch.utils import profiling
from copula_var_tpu_torch.utils.artifacts import load_artifacts

DATA = os.path.join(os.path.dirname(os.path.dirname(__file__)), "data")
CSV = os.path.join(DATA, "flagship.csv")
N_IN = 1135
DAYS = 4


def _cut_book(tmp_path_factory, artifacts, csv):
    """The MSM or GARCH artifact `artifacts` cut to its first DAYS days,
    and the matching returns of `csv`."""
    z = np.load(os.path.join(DATA, artifacts))
    arrays = {k: z[k] for k in z.files}
    for k in ("ii_forecasts_by_states", "ii_forecast_combos",
              "ii_forecast_vols"):
        if k in arrays:
            arrays[k] = arrays[k][:DAYS]
    path = str(tmp_path_factory.mktemp("book") / "book.npz")
    np.savez(path, **arrays)
    full = from_csv(csv, n_insample=N_IN)
    return path, from_returns(full.returns[:N_IN + DAYS], full.tickers, N_IN)


@pytest.fixture(scope="module")
def book(tmp_path_factory):
    """The flagship book cut to its first DAYS days."""
    return _cut_book(tmp_path_factory, "flagship_artifacts_msm.npz", CSV)


@pytest.fixture(scope="module")
def garch_book(tmp_path_factory):
    """The flagship's GARCH book cut to its first DAYS days."""
    return _cut_book(tmp_path_factory, "flagship_artifacts_garch.npz", CSV)


@pytest.fixture(scope="module")
def book3(tmp_path_factory):
    """The three-asset book cut to its first DAYS days."""
    return _cut_book(tmp_path_factory, "dim3_artifacts_msm.npz",
                     os.path.join(DATA, "dim3.csv"))


def _spans(prof):
    """[(name, name of the nearest enclosing cvt. span or None)] of every
    cvt. span the profiler recorded, in order."""
    out = []
    for e in prof.events():
        if not e.name.startswith(profiling.PREFIX):
            continue
        up = e.cpu_parent
        while up is not None and not up.name.startswith(profiling.PREFIX):
            up = up.cpu_parent
        out.append((e.name, None if up is None else up.name))
    return out


def test_span_without_a_profiler_is_the_shared_noop(monkeypatch):
    def refuse(name):
        raise AssertionError(f"a recorder was created for {name}")

    monkeypatch.setattr(profiling, "_Recorder", refuse)
    assert not torch.autograd.profiler._is_profiler_enabled
    first = profiling.span("solve")
    assert first is profiling.span("prep.day_tensors") is profiling._OFF
    with first:
        with profiling.span("sync.gather"):
            pass


def test_span_gate_is_the_profilers_enabled_flag():
    """The gate reads torch.autograd.profiler._is_profiler_enabled, which
    any torch profiler sets while it records."""
    assert isinstance(torch.autograd.profiler._is_profiler_enabled, bool)
    with profile(activities=[ProfilerActivity.CPU]):
        assert torch.autograd.profiler._is_profiler_enabled
        assert profiling.span("solve") is not profiling._OFF
    assert not torch.autograd.profiler._is_profiler_enabled
    assert profiling.span("solve") is profiling._OFF


def test_span_is_a_cpu_op_and_not_a_user_annotation(tmp_path):
    """A user annotation (record_function) is copied onto the device's
    timeline over the kernels it launches; the port's spans are cpu_op
    events, so the device's timeline gets no copy of them."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("solve"):
            torch.ones(4).sum()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("name") == "cvt.solve"]
    assert len(events) == 1
    assert events[0]["cat"] == "cpu_op"
    assert _spans(prof) == [("cvt.solve", None)]


def test_portfolio_solve_and_prep_spans_nest(book):
    path, data = book
    bt = load_artifacts(path, data, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        bt.sweep_operands()
        var = bt.calc_var_portfolios([[0.5, 0.5]], obj_var=0.05)
    assert var.shape == (1, DAYS)
    spans = _spans(prof)
    parent = dict(spans)
    for child in ("cvt.prep.day_tensors", "cvt.prep.operands",
                  "cvt.sync.prep"):
        assert parent[child] == "cvt.prep"
    assert parent["cvt.t_ppf"] == "cvt.prep.day_tensors"
    assert parent["cvt.prep"] is None and parent["cvt.solve"] is None
    for child in ("cvt.solve.stage1", "cvt.solve.bracket",
                  "cvt.solve.bisect", "cvt.solve.gather"):
        assert parent[child] == "cvt.solve"
    assert parent["cvt.sync.gather"] == "cvt.solve.gather"
    # the CPU route's while-loop reads its exit once a halving, and once
    # more to leave
    exits = [p for name, p in spans if name == "cvt.sync.bisect_exit"]
    assert exits and set(exits) == {"cvt.solve.bisect"}
    order = [name for name, p in spans if p == "cvt.solve"]
    assert order == ["cvt.solve.stage1", "cvt.solve.bracket",
                     "cvt.solve.bisect", "cvt.solve.gather"]


def test_dim3_prep_and_solve_spans_nest(book3):
    """At dim 3 the operands' correlation factor (with its host read) and
    state weights are spans of their own inside `cvt.prep.operands`, and
    the solve's spans nest as at dim 2."""
    path, data = book3
    bt = load_artifacts(path, data, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        bt.sweep_operands()
        var = bt.calc_var_portfolios([[0.5, 0.3, 0.2]], obj_var=0.05)
    assert var.shape == (1, DAYS)
    spans = _spans(prof)
    parent = dict(spans)
    for child in ("cvt.prep.factor", "cvt.prep.state_weights"):
        assert parent[child] == "cvt.prep.operands"
    assert parent["cvt.sync.logdet"] == "cvt.prep.factor"
    assert parent["cvt.prep.operands"] == "cvt.prep"
    order = [name for name, p in spans if p == "cvt.solve"]
    assert order == ["cvt.solve.stage1", "cvt.solve.bracket",
                     "cvt.solve.bisect", "cvt.solve.gather"]


def test_ingest_and_load_spans(book):
    path, data = book
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        from_csv(CSV, n_insample=N_IN)
        load_artifacts(path, data, device="cpu")
    assert _spans(prof) == [("cvt.ingest", None), ("cvt.load", None)]


def test_halvings_count_the_while_loops_iterations(book):
    path, data = book
    bt = load_artifacts(path, data, device="cpu")
    bt.sweep_operands()
    profiling.reset_counters()
    assert profiling.counters() == {}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        bt.calc_var_portfolios([[0.3, 0.7], [0.6, 0.4]], obj_var=0.05)
    exits = sum(name == "cvt.sync.bisect_exit" for name, _ in _spans(prof))
    halvings = profiling.counters()["solve.halvings"]
    assert halvings == exits - 1 > 0
    # a CPU solve launches nothing
    assert not any(k.startswith("launch.") for k in profiling.counters())
    bt.calc_var_portfolios([[0.3, 0.7]], obj_var=0.05)
    assert profiling.counters()["solve.halvings"] > halvings
    profiling.reset_counters()
    assert profiling.counters() == {}


def test_counters_are_a_copy_and_launch_count_reads_them():
    profiling.reset_counters()
    profiling.count("solve.halvings", 5)
    snap = profiling.counters()
    snap["solve.halvings"] = 0
    assert profiling.counters() == {"solve.halvings": 5}
    cq.count_launch(cq.masked_sweep, torch.float64)
    cq.count_launch(cq.masked_sweep, torch.float32)
    cq.count_launch(cq.masked_sweep, torch.float32)
    assert profiling.counters()["launch.masked_sweep"] == 1
    assert cq.launch_count(cq.masked_sweep) == 1
    assert cq.launch_count(cq.masked_sweep, torch.float32) == 2
    assert cq.launch_count(cs.bisect_levels) == 0
    profiling.reset_counters()


def _poked_flags_operands(ops, i0):
    """`ops` with asset 0's column not finite at grid point i0 on day 0:
    every cell of the n rows (0, i0, i1) is NaN, so those rows, and no
    others on the book, are flagged."""
    z, fin, lu = ops.cols
    fin = fin.clone()
    fin[0, 0, i0] = False
    return ops._replace(cols=(z, fin, lu), fin=fin.contiguous())


def test_flag_counters_on_the_cpu_twin(book3):
    """The plain twin of the row flags counts their bytes (T n^2, one a
    row) and the rows flagged, with no launch."""
    path, data = book3
    ops = load_artifacts(path, data, device="cpu").sweep_operands()
    n = ops.x.shape[0]
    profiling.reset_counters()
    flags = cq3.contract3_row_flags(ops)
    assert profiling.counters() == {"prep.flag_bytes": DAYS * n * n,
                                    "prep.flagged_rows": 0}
    profiling.reset_counters()
    flags = cq3.contract3_row_flags(_poked_flags_operands(ops, 7))
    assert int(flags.sum()) == n and bool(flags[0, 7].all())
    assert profiling.counters() == {"prep.flag_bytes": flags.nbytes,
                                    "prep.flagged_rows": n}
    profiling.reset_counters()


def _nearest_span(event):
    """The name of the nearest cvt. span that encloses `event`, or None."""
    up = event.cpu_parent
    while up is not None and not up.name.startswith(profiling.PREFIX):
        up = up.cpu_parent
    return None if up is None else up.name


@pytest.mark.parametrize("family", ["msm", "garch"])
def test_prep_columns_and_pdf_product_spans(family, book, garch_book):
    """The marginal columns are a span of their own inside the day
    tensors, before `t_ppf`; the GARCH book's pdf product and nan_to_num
    are one more, after the copula density, and enclose that work."""
    path, data = book if family == "msm" else garch_book
    bt = load_artifacts(path, data, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        bt.sweep_operands()
    spans = _spans(prof)
    inside = [name for name, p in spans if p == "cvt.prep.day_tensors"]
    if family == "msm":
        assert inside == ["cvt.prep.columns", "cvt.t_ppf"]
        return
    assert inside == ["cvt.prep.columns", "cvt.t_ppf",
                      "cvt.prep.pdf_product"]
    where = {}
    for e in prof.events():
        if e.name in ("aten::erfc", "aten::nan_to_num"):
            where.setdefault(e.name, set()).add(_nearest_span(e))
    assert where == {"aten::erfc": {"cvt.prep.columns"},
                     "aten::nan_to_num": {"cvt.prep.pdf_product"}}


@pytest.mark.parametrize("family,passes", [
    ("msm", {"betainc.passes": 261, "t_ppf.passes": 9}),
    ("garch", {"betainc.passes": 431, "t_ppf.passes": 10}),
])
def test_pass_counters_count_the_sync_spans(family, passes):
    """`t_ppf.passes` and `betainc.passes` count the passes of their
    loops, one a `cvt.sync.t_ppf` / `cvt.sync.betainc` read, in the prep
    of each of the flagship's whole books (nu = 11.22 and 44.37)."""
    bt = load_artifacts(
        os.path.join(DATA, f"flagship_artifacts_{family}.npz"),
        from_csv(CSV, n_insample=N_IN), device="cpu")
    profiling.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        bt.sweep_operands()
    got = profiling.counters()
    syncs = [name for name, _ in _spans(prof)]
    assert got["t_ppf.passes"] == syncs.count("cvt.sync.t_ppf")
    assert got["betainc.passes"] == syncs.count("cvt.sync.betainc")
    assert {k: got[k] for k in passes} == passes
    profiling.reset_counters()


def test_pass_counters_add_no_device_read(monkeypatch):
    """`t_ppf` reads the device once a pass of its loops and of
    `betainc`'s, with or without the counters: counting reads nothing."""
    from copula_var_tpu_torch.ops import special

    reads = [0]
    for name in ("__bool__", "item", "tolist", "__float__", "__int__"):
        method = getattr(torch.Tensor, name)

        def counted(self, *args, _method=method, **kwargs):
            reads[0] += 1
            return _method(self, *args, **kwargs)
        monkeypatch.setattr(torch.Tensor, name, counted)
    u = torch.linspace(0.0, 1.0, 257, dtype=torch.float64)

    def run():
        reads[0] = 0
        profiling.reset_counters()
        z = special.t_ppf(u, 44.36629112477989)
        return reads[0], profiling.counters(), z

    counted_reads, got, z = run()
    monkeypatch.setattr(special, "count", lambda name, n=1: None)
    plain_reads, none, z_plain = run()
    assert none == {}
    assert counted_reads == plain_reads == (got["t_ppf.passes"]
                                            + got["betainc.passes"])
    assert got["t_ppf.passes"] > 0 and got["betainc.passes"] > 0
    assert torch.equal(z, z_plain)
    profiling.reset_counters()


def test_stage_timer_stages_are_spans():
    timer = profiling.StageTimer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timer.stage("fit"):
            with timer.stage("fit.copula"):
                pass
    assert _spans(prof) == [("cvt.fit", None), ("cvt.fit.copula", "cvt.fit")]
    assert timer.counts == {"fit": 1, "fit.copula": 1}


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_card_counters_and_spans_of_a_query(dev, book):
    """On the card: the P build counts its launch and its bytes; a query
    (float64, one card, n <= 169) takes the fused route, one solve_stages
    launch and one K1 launch that counts its halvings on the device, so
    no K2 launch and no `solve.halvings`, and reads the device once (the
    gather); no cvt. span appears on the device's timeline."""
    path, data = book
    bt = load_artifacts(path, data, device="cuda")
    profiling.reset_counters()
    ops = bt.sweep_operands()
    got = profiling.counters()
    assert got["launch.sweep_table"] == 1
    assert got["prep.table_bytes"] == ops.P.nbytes + ops.flags.nbytes
    profiling.reset_counters()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        bt.calc_var_portfolios([[0.5, 0.5]], obj_var=0.05)
        torch.cuda.synchronize()
    got = profiling.counters()
    assert got["launch.solve_stages"] == 1
    assert got.get("launch.masked_sweep", 0) == 0
    assert got["launch.bisect_levels"] == 1
    assert "solve.halvings" not in got
    spans = _spans(prof)
    assert [n for n, _ in spans if n.startswith("cvt.sync.")] == [
        "cvt.sync.gather"]
    assert dict(spans)["cvt.launch.solve_stages"] == "cvt.solve.bracket"
    assert dict(spans)["cvt.launch.bisect_levels"] == "cvt.solve.bisect"
    cuda = torch.autograd.DeviceType.CUDA
    assert not [e.name for e in prof.events() if e.device_type == cuda
                and e.name.startswith(profiling.PREFIX)]


@pytest.mark.cuda
def test_card_counters_and_spans_of_a_dim3_query(dev, book3):
    """On the card at dim 3: the table U is built once with its row flags
    and counted (U's and the flags' bytes; the flagged rows, none on the
    book, read once inside the prep); a query takes the fused table
    route, one `solve_stages3` launch (both stage sweeps and the bracket)
    and one `bisect3` launcher call (the halvings counted on the device,
    so `solve.halvings` is not counted), no K4 sweep of its own and none
    of the rebuild, and reads the device once (the gather)."""
    path, data = book3
    bt = load_artifacts(path, data, device="cuda")
    profiling.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]) as prep:
        ops = bt.sweep_operands()
    got = profiling.counters()
    assert got["launch.contract3_weights"] == 1
    assert got["prep.table_bytes"] == ops.U.nbytes + ops.flags.nbytes
    assert got["prep.flagged_rows"] == int(ops.flags.sum()) == 0
    spans = _spans(prep)
    parent = dict(spans)
    assert [n for n, _ in spans if n == "cvt.sync.flagged_rows"] == [
        "cvt.sync.flagged_rows"]
    assert parent["cvt.sync.flagged_rows"] == "cvt.launch.contract3_weights"
    assert parent["cvt.launch.contract3_weights"] == "cvt.prep.operands"
    assert parent["cvt.prep.operands"] == "cvt.prep"
    profiling.reset_counters()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        bt.calc_var_portfolios([[0.5, 0.3, 0.2]], obj_var=0.05)
        torch.cuda.synchronize()
    got = profiling.counters()
    assert "solve.halvings" not in got
    assert got["launch.solve_stages3"] == 1
    assert got["launch.bisect3"] == 1
    assert got.get("launch.masked_contract3", 0) == 0
    assert got.get("launch.masked_contract3_rebuild", 0) == 0
    spans = _spans(prof)
    assert [n for n, _ in spans if n.startswith("cvt.sync.")] == [
        "cvt.sync.gather"]
    assert dict(spans)["cvt.launch.solve_stages3"] == "cvt.solve.bracket"
    assert dict(spans)["cvt.launch.bisect3"] == "cvt.solve.bisect"
    assert "cvt.solve.stage1" not in dict(spans)
    cuda = torch.autograd.DeviceType.CUDA
    assert not [e.name for e in prof.events() if e.device_type == cuda
                and e.name.startswith(profiling.PREFIX)]


@pytest.mark.cuda
def test_card_flag_counters(dev, book3):
    """On the card the flag kernel counts the rows it flags (one host
    read, the span `cvt.sync.flagged_rows` inside the launch's), the same
    count as its plain twin's, and the flags' bytes."""
    path, data = book3
    ops = load_artifacts(path, data, device="cuda").sweep_operands()
    n = ops.x.shape[0]
    poked = _poked_flags_operands(ops, 7)
    profiling.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        flags = cq3.contract3_row_flags(poked)
    got = profiling.counters()
    assert got["prep.flag_bytes"] == flags.nbytes == DAYS * n * n
    assert got["prep.flagged_rows"] == int(flags.sum()) == n
    assert torch.equal(flags.cpu(), cq3.contract3_row_flags_reference(
        poked).cpu())
    assert dict(_spans(prof))["cvt.sync.flagged_rows"] == (
        "cvt.launch.contract3_row_flags")
    profiling.reset_counters()
    cq3.contract3_row_flags(ops)
    assert profiling.counters()["prep.flagged_rows"] == 0
    profiling.reset_counters()


@pytest.mark.cuda
def test_card_build_counters(dev):
    """`build.loaded` counts libraries found built, `build.compiled` the
    nvcc builds."""
    _build.load()
    profiling.reset_counters()
    _build.build()
    assert profiling.counters() == {"build.loaded": len(_build.SOURCES)}
    profiling.reset_counters()
