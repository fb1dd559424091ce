"""The dim-3 sweep kernels' wrappers (counterpart of
`copula_var_tpu/ops/pallas_quadrature3.py`).

`contract3_weights` builds, once per backtest, the bounds-invariant table
U[t, i0, i1, i2] = V_t[i0, i1, i2] * sum_{b,c} W1[b, i1] G[t, i0, b, c]
W2[c, i2] (the density folded with its state weights); `masked_contract3`
evaluates L rows of (T,) slab integrals of a three-asset backtest as
masked sums of U; `masked_contract3_rebuild` evaluates the same sums with
no table, rebuilding every slab's cells from the transform columns on
each launch, as the TPU kernel does. Tensors on a CUDA device launch the
hand-written kernels of csrc/contract3.cu (`contract3_weights_kernel`;
`contract3_sweep_kernel` and `contract3_sum_kernel`;
`contract3_rebuild_kernel` and the same sum kernel), which replace the
Pallas kernel `_kernel3` (K4); tensors on the CPU run the plain twins
`contract3_weights_reference` and `masked_contract3_reference`, i.e. the
transform-cached sweeps of `ops/quadrature.py`, row by row. There is no
other route.

The route is `contract3_route(T, n, q, rows, free_bytes)`: the table when
n <= `table_max_grid_points(q)` (one slab in a block's shared memory:
169 at q = 5) and U fits in the card's free memory, else the rebuild
(n <= 1024, the interval rule's rows). `contract3_operands` builds U only
on the table route; operands without U sweep by the rebuild kernel. The
two routes give the same bits where both serve (the rebuild's 64-row
tiles are the table sweep's lookup spans), so U's memory is a matter of
speed, not of the answer.

U holds T*n^3 float64 (4.0 GB at T = 500, n = 100, 4.04 GB with its
pads) on the card. Its rows have an odd pitch (`row_pitch`) and its
(t, i0) slabs an even stride (`slab_stride`), so every slab starts on 16
bytes, as the sweep's bulk copies need, and one thread per row scans the
slab without bank conflicts; `table_cells` views the cells.

The routes and the rebuild's tile are computed here, from the limits
`ops/_build.py` compiles into the kernels (a block's shared memory, the
interval rule's rows), so the route can be chosen, and tested, without
the library; the launchers refuse what passes those limits.

Grid sharding (`parallel/`): operands built with `rows=(i0, i1)` hold the
table of outer slabs i0 in [i0, i1) only, U (T, i1 - i0, slab_stride(n)),
1.01 GB per rank at T = 500, n = 100 over four ranks; the columns and G
stay whole. The sweep and its plain twin then return those slabs' share
of each sweep (`parallel.mesh.GridMesh.grid_sum` adds the shares).

The operands are the float64 counterparts of `build_msm_dim3_cache` /
`build_garch_dim3_cache`, without the TPU layout: no packed f32
constants or bounds, no one-hot reads, no f32 booleans, no unit pdf
columns for the MSM family. The state reduction is folded into
G[t, i0, b, c] = sum_a W0[a, i0] FC[t, a, b, c] (W0 = densities[2] dx,
the rotated rows); the GARCH family is the q = 1 case with G = dx.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from copula_var_tpu_torch.ops import _build
from copula_var_tpu_torch.ops.cuda_quadrature import (
    MAX_SHARED_BYTES,
    SWEEP_MAX_GRID_POINTS,
    _check_operand,
    free_device_bytes,
    require_ascending,
    row_pitch,
)
from copula_var_tpu_torch.ops.quadrature import (
    CopulaSpec,
    _chol_inv_logdet,
    _chunks,
    _pdf_product,
    copula_density_cols,
    outer_slice,
    row_range,
    state_weight_matrices,
    student_log_norm,
)
from copula_var_tpu_torch.ops.tcached import tcached_sweep


class Contract3Operands(NamedTuple):
    """Bounds-invariant operands of every dim-3 sweep of one backtest.

    Plain twin's inputs: spec; cols, the transform columns (leaves
    (T, 3, n)); p_cols (T, 3, n) for the GARCH family, else None; x, dx
    (n,); densities (3, q, n) and forecast_combos (T, q^3) for the MSM
    family, else None.
    Build kernel's inputs: z, lu (T, 3, n) float64 and fin (T, 3, n) bool
    (for the Gaussian copula fin is all true and lu unused); w1, w2 (q, n)
    the weight rows of grid dims 1 and 2; G (T, n, q, q); sigma_inv
    (3, 3); the Student normalizer log_norm (incl. -logdet / 2), logdet
    and nu as floats.
    Sweep kernel's input: U (T, r, slab_stride(n)), the table built from
    those on a CUDA device for the r outer slabs held; None on the CPU.
    rows: (i0, i1), the outer grid rows (slabs i0) held, or None for
    all."""

    spec: CopulaSpec
    cols: tuple
    p_cols: Optional[torch.Tensor]
    x: torch.Tensor
    dx: torch.Tensor
    densities: Optional[torch.Tensor]
    forecast_combos: Optional[torch.Tensor]
    z: torch.Tensor
    fin: torch.Tensor
    lu: torch.Tensor
    w1: torch.Tensor
    w2: torch.Tensor
    G: torch.Tensor
    sigma_inv: torch.Tensor
    log_norm: float
    logdet: float
    nu: float
    U: Optional[torch.Tensor] = None
    rows: Optional[Tuple[int, int]] = None

    @property
    def days(self) -> int:
        return self.z.shape[0]

    @property
    def row0(self) -> int:
        return 0 if self.rows is None else self.rows[0]

    @property
    def n_rows(self) -> int:
        """Outer slabs held (n but for a range of rows)."""
        n = self.x.shape[0]
        return n if self.rows is None else self.rows[1] - self.rows[0]


def _require_kernel_copula(kind: str) -> None:
    if kind not in ("gaussian", "student"):
        raise ValueError(
            f"the dim-3 path takes the Gaussian or Student copula, not "
            f"{kind!r} (the Plackett copula is bivariate)"
        )


def slab_stride(n: int) -> int:
    """Float64 entries per (t, i0) slab of U: n rows of `row_pitch(n)`,
    rounded up to even, so each slab is a multiple of 16 bytes."""
    m = n * row_pitch(n)
    return m + m % 2


def table_bytes(T: int, n: int, rows: Optional[int] = None) -> int:
    """Bytes of the padded U table, (T, rows, slab_stride(n)) float64
    (rows: the outer slabs held, n by default)."""
    return T * (n if rows is None else rows) * slab_stride(n) * 8


def require_table_fits(T: int, n: int, free_bytes: int,
                       rows: Optional[int] = None) -> None:
    """Raise unless the U table of `rows` outer slabs (n by default)
    fits in `free_bytes` of device memory."""
    need = table_bytes(T, n, rows)
    if need > free_bytes:
        held = "" if rows is None or rows == n else f" ({rows} outer slabs)"
        raise RuntimeError(
            f"the dim-3 table U of T={T} days at num_points={n}{held} needs "
            f"{need} bytes ({need / 2**30:.2f} GiB) of device memory, but "
            f"only {free_bytes} bytes are free; `contract3_operands` builds "
            "no table for such a backtest, and its sweeps rebuild the "
            "slabs on every launch (`masked_contract3_rebuild`)"
        )


def _sweep_shared_bytes(n: int) -> int:
    """The table sweep's shared memory at one slab buffer: two mbarriers,
    the slab, x and a flag byte per row (the layout of csrc
    `sweep_shared_bytes`)."""
    return 16 + (slab_stride(n) + n) * 8 + n


def table_max_grid_points(q: int) -> int:
    """The largest n of the table route at q states (169 at q = 5): one
    padded n x n slab, x and the row flags in one block's shared memory,
    rows no longer than the interval rule's, and the build kernel's
    (q, n) fold."""
    n = 1
    while True:
        m = n + 1
        if (m > SWEEP_MAX_GRID_POINTS
                or _sweep_shared_bytes(m) > MAX_SHARED_BYTES
                or q * m * 8 > MAX_SHARED_BYTES):
            return n
        n = m


def rebuild_tile_rows(n: int, q: int) -> int:
    """i1 rows per block of the rebuild kernel at (n, q), which the
    launcher takes: 64 (a lookup span of the table sweep, so both routes
    give the same bits), or the largest power of two below it whose rows,
    x and the (q, n) fold fit in one block's shared memory (csrc
    `rebuild_shared_bytes`); 0 when none does or n passes the interval
    rule's rows."""
    if not 0 < n <= SWEEP_MAX_GRID_POINTS or q <= 0:
        return 0
    r = 64
    while r and (n + q * n + r * row_pitch(n)) * 8 + r > MAX_SHARED_BYTES:
        r //= 2
    return r


def _rebuild_rows(n: int, q: int) -> int:
    """`rebuild_tile_rows(n, q)`; a grid the rebuild does not take raises,
    naming the limit."""
    rows = rebuild_tile_rows(n, q)
    if rows == 0:
        raise ValueError(
            f"num_points={n}: the dim-3 kernels take n <= "
            f"{SWEEP_MAX_GRID_POINTS} (the interval rule's rows, "
            f"csrc/interval.cuh kMaxRow) with the (q, n) fold in shared "
            f"memory (q={q})")
    return rows


def contract3_route(T: int, n: int, q: int, rows: Optional[int],
                    free_bytes: int) -> str:
    """"table" or "rebuild": how a CUDA device sweeps a dim-3 backtest of
    T days at num_points n, q states, `rows` outer slabs held (n when
    None), with `free_bytes` of device memory. The table when its sweep
    takes n and U fits; else the rebuild kernel; a grid neither takes
    raises."""
    _rebuild_rows(n, q)
    if (n <= table_max_grid_points(q)
            and table_bytes(T, n, rows) <= free_bytes):
        return "table"
    return "rebuild"


def table_cells(U: torch.Tensor, n: int) -> torch.Tensor:
    """(T, r, n, n) view of the padded table (T, r, slab_stride(n))."""
    p = row_pitch(n)
    return U[..., : n * p].reshape(U.shape[0], U.shape[1], n, p)[..., :n]


def table_pads(U: torch.Tensor, n: int) -> torch.Tensor:
    """The table's pad cells, flattened (all zero as built)."""
    p = row_pitch(n)
    rows = U[..., : n * p].reshape(U.shape[0], U.shape[1], n, p)[..., n:]
    return torch.cat([rows.reshape(-1), U[..., n * p:].reshape(-1)])


def contract3_operands(cols, x, dx, spec: CopulaSpec, densities=None,
                       forecast_combos=None, p_cols=None, rows=None):
    """Contract3Operands for the MSM family (densities and
    forecast_combos given) or the GARCH family (p_cols given); with
    `rows` (i0, i1) those of outer slabs [i0, i1) (the columns whole). On
    a CUDA device the table U is built here, once, where `contract3_route`
    takes the table; else U stays None and every sweep rebuilds the
    slabs."""
    _require_kernel_copula(spec.kind)
    if spec.kind == "student":
        nu, corr = spec.params
        z, fin, lu = cols
        nu = float(nu)
    else:
        (corr,) = spec.params
        (z,) = cols
        fin = torch.ones(z.shape, dtype=torch.bool, device=z.device)
        lu = torch.zeros_like(z)
        nu = 0.0
    T, dim, n = z.shape
    if dim != 3:
        raise ValueError(f"Contract3Operands: expected 3 assets, got {dim}")
    sigma_inv, logdet = _chol_inv_logdet(corr)
    log_norm = (float(student_log_norm(nu, logdet, 3))
                if spec.kind == "student" else 0.0)
    if densities is None:
        w1 = w2 = dx[None, :]
        G = dx[None, :, None, None].expand(T, n, 1, 1)
    else:
        w0, w1, w2 = state_weight_matrices(densities, dx)
        q = w0.shape[0]
        G = torch.einsum("ai,tabc->tibc", w0,
                         forecast_combos.reshape(T, q, q, q))
    ops = Contract3Operands(
        spec, tuple(cols), None if p_cols is None else p_cols.contiguous(),
        x, dx, densities, forecast_combos,
        z.contiguous(), fin.contiguous(), lu.contiguous(), w1.contiguous(),
        w2.contiguous(), G.contiguous(), sigma_inv.contiguous(), log_norm,
        float(logdet), nu,
        rows=None if rows is None else row_range(rows, n),
    )
    if z.device.type == "cuda":
        require_ascending(x)
        route = contract3_route(T, n, ops.w1.shape[0], ops.n_rows,
                                free_device_bytes(z.device))
        if route == "table":
            ops = ops._replace(U=contract3_weights(ops))
    return ops


def contract3_weights_reference(ops: Contract3Operands, days=slice(None)):
    """Plain PyTorch twin of the table, on any device: U for the days
    `days` selects and the operands' outer slabs, (D, r, n, n),
    unpadded, built in day chunks from the transform columns as the
    transform-cached sweeps build their density."""
    outer = outer_slice(ops.rows)
    cols = tuple(c[days] for c in ops.cols)
    p = None if ops.p_cols is None else ops.p_cols[days]
    G = ops.G[days] if outer is None else ops.G[days][:, outer]
    D, n = G.shape[0], ops.x.shape[0]
    out = torch.empty((D, ops.n_rows, n, n), dtype=torch.float64,
                      device=ops.x.device)
    for s in _chunks(D, n, 3, ops.x.device, None, outer):
        V = copula_density_cols(tuple(c[s] for c in cols), ops.spec, outer)
        if p is not None:
            V = torch.nan_to_num(V * _pdf_product(p[s], outer))
        out[s] = V * torch.einsum("bj,tibc,ck->tijk", ops.w1, G[s], ops.w2)
    return out


def contract3_weights(ops: Contract3Operands):
    """The padded table U (T, r, slab_stride(n)) of the operands' r outer
    slabs on their CUDA device: the build kernel (one block per (day, i0)
    slab), launched after checking that the card's free memory holds the
    table. Other devices raise: the CPU route sums
    `contract3_weights_reference`'s cells through the plain sweep and
    needs no table."""
    dev = ops.z.device
    if dev.type != "cuda":
        raise ValueError(f"contract3_weights: unsupported device {dev} "
                         "(the table is built on a CUDA device only)")
    T, n, q = check_contract3_operands(ops)
    r = ops.n_rows
    require_table_fits(T, n, free_device_bytes(dev), r)
    U = torch.empty((T, r, slab_stride(n)), dtype=torch.float64, device=dev)
    p = None if ops.p_cols is None else ops.p_cols.data_ptr()
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = lib.cvt_contract3_weights(
            ops.z.data_ptr(), ops.fin.data_ptr(), ops.lu.data_ptr(), p,
            ops.w1.data_ptr(), ops.w2.data_ptr(), ops.G.data_ptr(),
            ops.sigma_inv.data_ptr(), int(ops.spec.kind == "student"),
            ops.nu, ops.log_norm, ops.logdet, U.data_ptr(), T, n, ops.row0,
            r, q, row_pitch(n), slab_stride(n), stream,
        )
    _build.check(status, "contract3_weights")
    contract3_weights.launches += 1
    return U


contract3_weights.launches = 0  # kernel launches (CUDA path only)


def masked_contract3_reference(ops: Contract3Operands, bounds, weights,
                               box_min=-5.0):
    """Plain PyTorch twin, on any device: row l is the transform-cached
    sweep of `ops/quadrature.py` at bounds[l] (T, 2) and weights[l] (3,)
    (`ops/tcached.py::tcached_sweep`), the share of the operands' outer
    slabs. Returns (L, T)."""
    return tcached_sweep(ops, bounds, weights, box_min)


def _check_columns(ops: Contract3Operands):
    """Validate the columns, grid, weights and G the build and rebuild
    kernels read; returns (T, n, q)."""
    _require_kernel_copula(ops.spec.kind)
    T, _, n = ops.z.shape
    q = ops.w1.shape[0]
    dev = ops.z.device
    for name in ("z", "lu"):
        _check_operand(name, getattr(ops, name), (T, 3, n), dev)
    _check_operand("fin", ops.fin, (T, 3, n), dev, torch.bool)
    if ops.p_cols is not None:
        _check_operand("p_cols", ops.p_cols, (T, 3, n), dev)
    _check_operand("x", ops.x, (n,), dev)
    _check_operand("w1", ops.w1, (q, n), dev)
    _check_operand("w2", ops.w2, (q, n), dev)
    _check_operand("G", ops.G, (T, n, q, q), dev)
    _check_operand("sigma_inv", ops.sigma_inv, (3, 3), dev)
    return T, n, q


def check_contract3_operands(ops: Contract3Operands):
    """Validate the build kernel's operands; returns (T, n, q)."""
    T, n, q = _check_columns(ops)
    n_max = table_max_grid_points(q)
    if n > n_max:
        raise ValueError(
            f"num_points={n} needs an {n}x{n} float64 slab in one block's "
            f"shared memory; the dim-3 table and its sweep take n <= "
            f"{n_max} at q={q} (wider grids sweep by the rebuild kernel, "
            "`masked_contract3_rebuild`)"
        )
    return T, n, q


def masked_contract3(ops: Contract3Operands, bounds, weights, box_min=-5.0):
    """(L, T) slab integrals for bounds (L, T, 2) and per-row portfolio
    weights (L, 3) ([inner, outer0, outer1]), the share of the operands'
    outer slabs. CPU tensors run the plain twin; CUDA tensors launch the sweep kernel on the table U (persistent
    blocks stream its slabs through shared memory; each bound row is a
    prefix-interval sum per grid row), then a fixed-order sum over the
    outer index; any other device raises."""
    dev = ops.z.device
    if dev.type == "cpu":
        return masked_contract3_reference(ops, bounds, weights, box_min)
    if dev.type != "cuda":
        raise ValueError(f"masked_contract3: unsupported device {dev}")
    if ops.U is None:
        raise ValueError("masked_contract3: the operands carry no table U "
                         "(build them with contract3_operands)")
    T, n, r = ops.days, ops.x.shape[0], ops.n_rows
    _check_operand("U", ops.U, (T, r, slab_stride(n)), dev)
    _check_operand("x", ops.x, (n,), dev)
    L = bounds.shape[0]
    _check_operand("bounds", bounds, (L, T, 2), dev)
    _check_operand("weights", weights, (L, 3), dev)
    lib = _build.load()
    # the kernel's partials per (row, day): one per i0 held and span of 64
    # i1, summed in order
    partial = torch.empty((L, T, r * -(-n // 64)), dtype=torch.float64,
                          device=dev)
    out = torch.empty((L, T), dtype=torch.float64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = lib.cvt_masked_contract3(
            ops.U.data_ptr(), ops.x.data_ptr(), bounds.data_ptr(),
            weights.data_ptr(), float(box_min), partial.data_ptr(),
            out.data_ptr(), T, n, ops.row0, r, L, row_pitch(n),
            slab_stride(n), stream,
        )
    _build.check(status, "masked_contract3")
    masked_contract3.launches += 1
    return out


masked_contract3.launches = 0  # kernel launches (CUDA path only)


def masked_contract3_rebuild(ops: Contract3Operands, bounds, weights,
                             box_min=-5.0):
    """`masked_contract3` without the table: (L, T) slab integrals for
    bounds (L, T, 2) and weights (L, 3), the share of the operands' outer
    slabs. CPU tensors run the plain twin; CUDA tensors launch the
    rebuild kernel (one block per (day, i0) slab and tile of i1 rows: the
    slab's cells from the transform columns, each row a prefix-interval
    sum per bound row), then a fixed-order sum of the tiles' partials;
    any other device raises."""
    dev = ops.z.device
    if dev.type == "cpu":
        return masked_contract3_reference(ops, bounds, weights, box_min)
    if dev.type != "cuda":
        raise ValueError(f"masked_contract3_rebuild: unsupported device {dev}")
    T, n, q = _check_columns(ops)
    tile_rows = _rebuild_rows(n, q)
    r = ops.n_rows
    L = bounds.shape[0]
    _check_operand("bounds", bounds, (L, T, 2), dev)
    _check_operand("weights", weights, (L, 3), dev)
    p = None if ops.p_cols is None else ops.p_cols.data_ptr()
    lib = _build.load()
    # one partial per (row, day, i0 held, tile of i1), summed in order
    partial = torch.empty((L, T, r * -(-n // tile_rows)), dtype=torch.float64,
                          device=dev)
    out = torch.empty((L, T), dtype=torch.float64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = lib.cvt_masked_contract3_rebuild(
            ops.z.data_ptr(), ops.fin.data_ptr(), ops.lu.data_ptr(), p,
            ops.w1.data_ptr(), ops.w2.data_ptr(), ops.G.data_ptr(),
            ops.sigma_inv.data_ptr(), int(ops.spec.kind == "student"),
            ops.nu, ops.log_norm, ops.logdet, ops.x.data_ptr(),
            bounds.data_ptr(), weights.data_ptr(), float(box_min),
            partial.data_ptr(), out.data_ptr(), T, n, ops.row0, r, q, L,
            tile_rows, stream,
        )
    _build.check(status, "masked_contract3_rebuild")
    masked_contract3_rebuild.launches += 1
    return out


masked_contract3_rebuild.launches = 0  # kernel launches (CUDA path only)
