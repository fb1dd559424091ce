"""The streamed reference (`reference/msm_student_stream.py`) and the book
of `d3-msm4-t-n300`. On the CPU: the streamed reference equals
`msm_student` on seeded small books, forms no more than a block of days
at a time, reproduces the dim-3 record, and agrees with the program's
CPU path on a seeded book wider than 169 points; the n300 book holds the
record's integration inputs and loads. On the card: the streamed
reference reproduces the record of this book at 300 points."""

import json

import numpy as np
import pytest

from varbench.harness.spec import Bench
from varbench.reference import msm_student as ref
from varbench.reference import msm_student_stream as stream

BAR = 1e-9  # the records' bar (tests/test_flagship.py)
N_INSAMPLE = 1135
N300 = "varbench/books/dim3_n300_artifacts_msm.npz"
BOOKS = {2: ("flagship.csv", "flagship_artifacts_msm.npz"),
         3: ("dim3.csv", "dim3_artifacts_msm.npz")}


def seeded_book(tmp_path, dim, n, T, seed):
    """A book of `dim` assets cut to its first T out-of-sample days, with
    the committed book's fits and seeded integration inputs on an
    n-point grid: (csv path, artifacts path)."""
    data = Bench().root / "data"
    csv_name, art_name = BOOKS[dim]
    lines = (data / csv_name).read_text().splitlines()
    csv = tmp_path / f"d{dim}_n{n}.csv"
    csv.write_text("\n".join(lines[:1 + N_INSAMPLE + T + 1]) + "\n")
    with np.load(data / art_name, allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files}
    meta = json.loads(str(arrays["meta"]))
    meta["num_points"] = n
    q = arrays["ii_unique_vols"].shape[1]
    rng = np.random.default_rng(seed)
    x = np.linspace(-5.0, 5.0, n)
    fbs = rng.dirichlet(np.ones(q), size=(T, dim))
    combos = fbs[:, 0]
    for d in range(1, dim):
        combos = (combos[:, :, None] * fbs[:, d, None, :]).reshape(T, -1)
    arrays.update(
        meta=json.dumps(meta), ii_x=x, ii_dx=np.full(n, x[1] - x[0]),
        ii_densities=rng.uniform(0.05, 0.45, (dim, q, n)),
        ii_unique_vols=np.sort(rng.uniform(0.5, 3.0, (dim, q)), axis=1),
        ii_forecasts_by_states=fbs, ii_forecast_combos=combos)
    artifacts = tmp_path / f"d{dim}_n{n}.npz"
    np.savez(artifacts, **arrays)
    return csv, artifacts


def _rows(dim, L, seed):
    rng = np.random.default_rng(seed)
    return (rng.dirichlet(np.full(dim, 2.0), size=L),
            rng.choice([0.01, 0.025, 0.05, 0.1], size=L))


@pytest.mark.parametrize("chunk_days", [None, 2])
@pytest.mark.parametrize("dim,n,T", [(3, 24, 6), (2, 40, 7)])
def test_stream_equals_the_whole_density(tmp_path, monkeypatch, dim, n, T,
                                         chunk_days):
    if chunk_days is not None:
        monkeypatch.setattr(ref, "CHUNK_CELLS", chunk_days * n ** dim)
    csv, art = seeded_book(tmp_path, dim, n, T, seed=100 + dim)
    weights, levels = _rows(dim, 3, seed=7)
    want, want_h = ref.solve(ref.Book(str(csv), N_INSAMPLE, str(art)),
                             weights, levels)
    got, got_h = stream.solve(stream.Book(str(csv), N_INSAMPLE, str(art)),
                              weights, levels)
    assert got.shape == want.shape == (3, T)
    assert got_h == want_h
    assert np.array_equal(np.isnan(got), np.isnan(want))
    both = np.isfinite(want)
    assert np.max(np.abs(got[both] - want[both])) <= 1e-12


def test_stream_forms_a_block_of_days_at_a_time(tmp_path, monkeypatch):
    n, T = 24, 6
    monkeypatch.setattr(ref, "CHUNK_CELLS", 2 * n ** 3)
    formed = []
    density = ref.Book._density

    def counted(self, fbs, *args):
        formed.append(fbs.shape[0])
        return density(self, fbs, *args)

    monkeypatch.setattr(ref.Book, "_density", counted)
    csv, art = seeded_book(tmp_path, 3, n, T, seed=11)
    book = stream.Book(str(csv), N_INSAMPLE, str(art))
    assert formed == [] and not hasattr(book.C, "shape")
    stream.solve(book, *_rows(3, 1, seed=3))
    assert formed and max(formed) == 2
    assert sum(formed) % T == 0  # every sweep formed every day once


def test_stream_reproduces_the_first_days_of_the_dim3_record():
    days = slice(0, 8)
    data = Bench().root / "data"
    book = stream.Book(str(data / "dim3.csv"), N_INSAMPLE,
                       str(data / "dim3_artifacts_msm.npz"), days=days)
    rec = np.load(data / "dim3_var.npz")
    out, _ = stream.solve(book, rec["weights"][None],
                          np.array([float(rec["obj_var"])]))
    assert np.max(np.abs(out[0] - rec["msm_var"][days])) <= BAR


def test_program_cpu_path_agrees_past_169_points(tmp_path):
    from copula_var_tpu_torch.data import from_csv
    from copula_var_tpu_torch.utils.artifacts import load_artifacts

    n, T = 172, 3
    csv, art = seeded_book(tmp_path, 3, n, T, seed=172)
    weights, levels = _rows(3, 2, seed=5)
    bt = load_artifacts(str(art), from_csv(str(csv), N_INSAMPLE),
                        device="cpu")
    assert bt.num_points == n
    got = np.asarray(bt.calc_var_portfolios(weights, obj_var=levels))
    want, _ = stream.solve(stream.Book(str(csv), N_INSAMPLE, str(art)),
                           weights, levels)
    assert got.shape == want.shape == (2, T)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    both = np.isfinite(want)
    assert np.max(np.abs(got[both] - want[both])) <= BAR


def test_the_n300_book_holds_the_record_s_inputs_and_loads():
    from copula_var_tpu_torch.data import from_csv
    from copula_var_tpu_torch.utils.artifacts import load_artifacts

    bench = Bench()
    config = bench.config("d3-msm4-t-n300")
    assert config["book"]["artifacts"] == N300
    rec = np.load(bench.root / "data" / "wide_grid_var.npz")
    days = int(rec["dim3_days"])
    with np.load(bench.path(N300), allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        fields = [k for k in z.files if k.startswith("ii_")]
        assert len(fields) == 6
        for k in fields:
            v = z[k][:days] if z[k].shape[0] == 500 else z[k]
            assert np.array_equal(v, rec[f"dim3_msm_n300_{k}"]), k
    assert meta["num_points"] == 300 and meta["adapter"] == "msm"
    data = from_csv(str(bench.path(config["book"]["csv"])),
                    int(config["book"]["n_insample"]))
    bt = load_artifacts(str(bench.path(N300)), data, device="cpu")
    assert bt.num_points == 300 and data.out_sample_n == 500


@pytest.mark.cuda
def test_stream_reproduces_the_n300_record(cuda_device):
    bench = Bench()
    rec = np.load(bench.root / "data" / "wide_grid_var.npz")
    days = slice(0, int(rec["dim3_days"]))
    book = stream.Book(str(bench.path("varbench/books/dim3.csv")),
                       N_INSAMPLE, str(bench.path(N300)), device=cuda_device,
                       days=days)
    out, _ = stream.solve(book, rec["weights3"][None],
                          np.array([float(rec["obj_var"])]))
    assert np.max(np.abs(out[0] - rec["dim3_msm_n300_var"])) <= BAR
