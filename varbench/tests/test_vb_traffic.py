"""The request generator: the same seed gives the same requests."""

import numpy as np

from varbench.harness.spec import Bench
from varbench.harness.traffic import Traffic

SEED = (1 << 33) + 12345  # past 32 signed bits


def _draw(mix, dim, seed, stream="window", k=12):
    t = Traffic(mix, dim, seed, stream)
    return [t.next() for _ in range(k)]


def _same(a, b):
    return all(np.array_equal(x["weights"], y["weights"])
               and np.array_equal(x["levels"], y["levels"])
               for x, y in zip(a, b))


def test_draws_repeat_per_seed():
    bench = Bench()
    for name in ("query", "grid", "reload"):
        mix = bench.mix(name)
        for dim in (2, 3):
            assert _same(_draw(mix, dim, SEED), _draw(mix, dim, SEED))
            assert not _same(_draw(mix, dim, SEED), _draw(mix, dim, SEED + 1))
            assert not _same(_draw(mix, dim, SEED, "warmup"),
                             _draw(mix, dim, SEED, "window"))


def test_requests_have_the_mix_shapes():
    bench = Bench()
    q = _draw(bench.mix("query"), 3, SEED, k=8)
    assert all(r["weights"].shape == (1, 3) for r in q)
    assert all(np.allclose(r["weights"].sum(axis=1), 1.0) for r in q)
    # every level of the ladder once in each block of four requests
    levels = [float(r["levels"][0]) for r in q]
    assert sorted(levels[:4]) == sorted(levels[4:]) == [0.01, 0.025, 0.05,
                                                        0.1]
    g = _draw(bench.mix("grid"), 2, SEED, k=2)
    assert g[0]["weights"].shape == (32, 2)
    assert list(g[0]["levels"]) == [0.01, 0.025, 0.05, 0.1]
    r = _draw(bench.mix("reload"), 3, SEED, k=3)
    assert all(list(x["levels"]) == [0.05] for x in r)
