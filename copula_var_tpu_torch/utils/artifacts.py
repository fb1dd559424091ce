"""Load saved precompute artifacts into a solve-ready backtest
(counterpart of `copula_var_tpu/utils/artifacts.py::load_artifacts`).

Reads the same `.npz` schema the JAX package writes (`save_artifacts`):
a JSON `meta` with the fitted model and copula parameters, the
integration inputs as `ii_<field>` arrays, and the in-sample marginals
and densities. No refit happens.
"""

from __future__ import annotations

import json

import numpy as np

from copula_var_tpu_torch import backtest as bt_mod
from copula_var_tpu_torch.copulas import fit as copula_fit_mod
from copula_var_tpu_torch.models import fit as model_fit_mod

_FORMAT_VERSION = 1


def _restore(v):
    arr = np.asarray(v)
    return arr.item() if arr.ndim == 0 else arr


def load_artifacts(path: str, data, device="cpu", adapter=None,
                   reference_quirks=False):
    """Rebuild a solve-ready `VaRBacktest` on `device` ("cpu" or "cuda";
    CUDA without a GPU raises) from saved artifacts and the same
    ReturnsData."""
    z = np.load(path, allow_pickle=False)
    meta = json.loads(str(z["meta"]))
    if meta["version"] != _FORMAT_VERSION:
        raise ValueError(f"artifact version {meta['version']} unsupported")
    if adapter is None:
        if meta["adapter"] not in bt_mod._ADAPTERS:
            raise ValueError(
                f"adapter {meta['adapter']!r} is not ported yet (the port "
                f"serves {sorted(bt_mod._ADAPTERS)}; ROADMAP.md queue 1)"
            )
        adapter = bt_mod._ADAPTERS[meta["adapter"]]()
    fit_cls = getattr(model_fit_mod, meta["fit_type"])
    model_fits = [
        fit_cls(**{k: _restore(v) for k, v in f.items()})
        for f in meta["model_fits"]
    ]
    cfit_cls = getattr(copula_fit_mod, meta["copula_fit_type"])
    copula_fit = cfit_cls(
        **{k: _restore(v) for k, v in meta["copula_fit"].items()}
    )
    inputs_cls = getattr(bt_mod, meta["inputs_kind"])
    inputs = inputs_cls(*[z[f"ii_{k}"] for k in inputs_cls._fields])
    return bt_mod.VaRBacktest(
        data, adapter, meta["copula"], copula_fit, model_fits, inputs,
        marginals=z["marginals"], densities=z["densities"],
        num_points=meta["num_points"],
        box=tuple(meta.get("box", (-5.0, 5.0))), device=device,
        reference_quirks=reference_quirks,
    )
