"""The run's guard against the JAX side of the repository: the program
under test is the PyTorch port, and no process of the benchmark may load
JAX or the JAX package. Names are compared whole, by their top-level part
(before the first dot): the port's name begins with the JAX package's."""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "copula_var_tpu"})


def forbidden_loaded(modules=None) -> list:
    """The forbidden top-level names among `modules` (sys.modules by
    default), sorted."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & FORBIDDEN)
