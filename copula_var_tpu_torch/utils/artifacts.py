"""Save and load a backtest's precompute artifacts (counterpart of
`copula_var_tpu/utils/artifacts.py`).

The `.npz` schema is the JAX package's, format version 1: a JSON `meta`
with the fitted model and copula parameters, the integration inputs as
`ii_<field>` arrays, and the in-sample marginals and densities. Either
package loads the other's files. Loading refits nothing.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from copula_var_tpu_torch import backtest as bt_mod
from copula_var_tpu_torch.copulas import fit as copula_fit_mod
from copula_var_tpu_torch.models import fit as model_fit_mod
from copula_var_tpu_torch.utils.profiling import span

_FORMAT_VERSION = 1


def _restore(v):
    arr = np.asarray(v)
    return arr.item() if arr.ndim == 0 else arr


def save_artifacts(path: str, backtest) -> None:
    """Serialize a backtest's fitted state and integration inputs."""
    ii = backtest.integration_inputs

    def host(v):
        return v.cpu().numpy() if torch.is_tensor(v) else np.asarray(v)

    meta = {
        "version": _FORMAT_VERSION,
        "copula": backtest.copula,
        "adapter": backtest.adapter.name,
        "num_points": backtest.num_points,
        "box": list(backtest.box),
        "inputs_kind": type(ii).__name__,
        "model_fits": [
            {k: np.asarray(v).tolist() for k, v in f._asdict().items()}
            for f in backtest.model_fits
        ],
        "fit_type": type(backtest.model_fits[0]).__name__,
        "copula_fit": {
            k: np.asarray(v).tolist()
            for k, v in backtest.copula_fit._asdict().items()
        },
        "copula_fit_type": type(backtest.copula_fit).__name__,
    }
    arrays = {f"ii_{k}": host(v) for k, v in ii._asdict().items()}
    arrays["marginals"] = host(backtest.marginals)
    arrays["densities"] = host(backtest.densities)
    np.savez_compressed(path, meta=json.dumps(meta), **arrays)


def load_artifacts(path: str, data, device="cuda", adapter=None,
                   reference_quirks=False, refine_root=False, mesh=None):
    """Rebuild a solve-ready `VaRBacktest` on `device` ("cuda", the
    default, or "cpu"; CUDA without a GPU raises) from saved artifacts and
    the same ReturnsData, with the solve options `reference_quirks` and
    `refine_root`. With a `mesh` every rank loads the whole file and
    serves its block of days (`parallel.mesh.DayMesh`) or its outer grid
    rows (`parallel.mesh.GridMesh`)."""
    with span("load"):
        return _load_artifacts(path, data, device, adapter,
                               reference_quirks, refine_root, mesh)


def _load_artifacts(path, data, device, adapter, reference_quirks,
                    refine_root, mesh):
    """`load_artifacts` inside its span."""
    z = np.load(path, allow_pickle=False)
    meta = json.loads(str(z["meta"]))
    if meta["version"] != _FORMAT_VERSION:
        raise ValueError(f"artifact version {meta['version']} unsupported")
    if adapter is None:
        if meta["adapter"] not in bt_mod._ADAPTERS:
            raise ValueError(
                f"unknown adapter {meta['adapter']!r} (the port serves "
                f"{sorted(bt_mod._ADAPTERS)}; register_adapter adds one)"
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
        reference_quirks=reference_quirks, refine_root=refine_root,
        mesh=mesh,
    )
