"""The dim-3 sweep kernels' wrappers (counterpart of
`copula_var_tpu/ops/pallas_quadrature3.py`).

`contract3_weights` builds, once per backtest, the bounds-invariant table
U[t, i0, i1, i2] = V_t[i0, i1, i2] * sum_{b,c} W1[b, i1] G[t, i0, b, c]
W2[c, i2] (the density folded with its state weights) in its stored form:
each (day, i0, i1) row as its inclusive prefix sum over i2, or as its
cells where the row is flagged, with the row flags. A row is flagged where
a cell of it lies outside [-MAX_CELL, MAX_CELL] or is NaN (the interval
rule then sums it cell by cell). `masked_contract3` evaluates L rows of
(T,) slab integrals of a three-asset backtest as masked sums of U: each
row lookup reads the two prefixes at its interval's ends.
`masked_contract3_rebuild` evaluates the same sums with no table, forming
on each launch, from the transform columns, the cells its lookups read
(each row's prefix up to the longest interval's end).
`contract3_row_flags` builds the row flags alone, once per backtest swept
that way. Tensors on a CUDA device launch the hand-written kernels of
csrc/contract3.cu (`contract3_weights_kernel` and `contract3_scan_kernel`;
`contract3_sweep_kernel`; `contract3_flags_kernel`;
`contract3_rebuild_kernel` and `contract3_sum_kernel`), which replace the
Pallas kernel `_kernel3` (K4); tensors on the CPU run the plain twins
`contract3_weights_reference`, `contract3_table_reference`,
`contract3_row_flags_reference` and `masked_contract3_reference`, i.e. the
transform-cached sweeps of `ops/quadrature.py`, row by row. There is no
other route.

The route is `contract3_route(T, n, q, rows, free_bytes)`, one of three:
"table" when n <= `table_max_grid_points(q)` (one slab in a block's
shared memory for the build's scan: 169 at q = 5) and U fits in the
card's free memory;
"rebuild" when the flag table (T rows n bytes, 45 MB at T = 500, n =
300) fits; else "rebuild_full", the same rebuild kernel without flags,
which walks every row with an interval whole and flags it by the scan.
All take n <= 1024 (the interval rule's rows). `contract3_operands`
builds U and its flags on the table route and the flags on the rebuild
route. The routes give the same bits wherever they serve (the rebuild's
64-row tiles are the table sweep's lookup spans, and every row takes the
table's branch), so memory is a matter of speed, not of the answer.

U holds T*n^3 float64 (4.0 GB at T = 500, n = 100, 4.04 GB with its
pads) on the card, and its flags T*n^2 bytes (5 MB). Its rows have an odd
pitch (`row_pitch`) and its (t, i0) slabs a stride rounded to 16 bytes
(`slab_stride`), so one thread per row scans a slab in shared memory
without bank conflicts; `table_cells` views the stored rows.

The routes and the rebuild's tile are computed here, from the limits
`ops/_build.py` compiles into the kernels (a block's shared memory, the
interval rule's rows), so the route can be chosen, and tested, without
the library; the launchers refuse what passes those limits.

Grid sharding (`parallel/`): operands built with `rows=(i0, i1)` hold the
table of outer slabs i0 in [i0, i1) only, U (T, i1 - i0, slab_stride(n)),
1.01 GB per rank at T = 500, n = 100 over four ranks; the columns and G
stay whole. The sweep and its plain twin then return those slabs' share
of each sweep (`parallel.mesh.GridMesh.grid_sum` adds the shares).

Day sharding (`parallel/`): operands built with `days=` (a slice of the
T days) hold one rank's block, cut after G is formed over all T, and U
(or the flags) of that block only. On an empty block (T = 0) every
wrapper returns its empty result and launches nothing.

The f32 engine (`engine="pallas"`): `contract3_operands(...,
dtype=torch.float32)` holds the f64 prep cast to float32 (the transform
and pdf columns, the weight rows, G formed in float64 and cast, x, dx),
as JAX's `build_{msm,garch}_dim3_cache` casts it; sigma_inv stays float64
and the kernels round each constant they form from it once to float32,
as the plain twin's torch operations do. The same kernels in float32 (U
of float32: 2.02 GB at T = 500, n = 100; a slab's stride rounded to four
floats, 16 bytes; the table sweep up to the short rows, n <= 192) and the
same routes, sized by the float32 bytes (`contract3_route(..., dtype)`).
Its plain twins are the f64 twins run on the float32 tensors. Each
wrapper counts its launches as `cuda_quadrature.py`'s do, and its host
side is the span `launch.<wrapper>`.

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
    BISECT_MAX_ROW,
    F32,
    F64,
    MAX_CELL,
    MAX_SHARED_BYTES,
    SWEEP_MAX_GRID_POINTS,
    _check_operand,
    count_launch,
    cut_days,
    free_device_bytes,
    itemsize,
    require_ascending,
    require_full_f32_matmul,
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
from copula_var_tpu_torch.utils.profiling import count, span


class Contract3Operands(NamedTuple):
    """Bounds-invariant operands of every dim-3 sweep of one backtest.

    Plain twin's inputs: spec; cols, the transform columns (leaves
    (T, 3, n)); p_cols (T, 3, n) for the GARCH family, else None; x, dx
    (n,); densities (3, q, n) and forecast_combos (T, q^3) for the MSM
    family, else None.
    Build kernel's inputs: z, lu (T, 3, n) and fin (T, 3, n) bool (for
    the Gaussian copula fin is all true and lu unused); w1, w2 (q, n)
    the weight rows of grid dims 1 and 2; G (T, n, q, q); sigma_inv
    (3, 3) float64; the Student normalizer log_norm (incl. -logdet / 2),
    logdet and nu as floats. Every other floating tensor is float64 (the
    f64 engine) or float32 (the f32 engine).
    Sweep kernel's input: U (T, r, slab_stride(n)), the table built from
    those on a CUDA device for the r outer slabs held, in its stored form
    (prefix rows, flagged rows as cells); None on the CPU.
    flags (T, r, n) bool, the row flags of the r outer slabs held (the
    "table" and "rebuild" routes); None on the full-row route and on the
    CPU, where the rebuild walks full rows.
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
    flags: Optional[torch.Tensor] = None

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

    @property
    def dtype(self) -> torch.dtype:
        return self.z.dtype


def _require_kernel_copula(kind: str) -> None:
    if kind not in ("gaussian", "student"):
        raise ValueError(
            f"the dim-3 path takes the Gaussian or Student copula, not "
            f"{kind!r} (the Plackett copula is bivariate)"
        )


def slab_stride(n: int, dtype=F64) -> int:
    """Entries of `dtype` per (t, i0) slab of U: n rows of
    `row_pitch(n)`, rounded up to a multiple of 16 bytes (2 float64 or 4
    float32 entries)."""
    m, unit = n * row_pitch(n), 16 // itemsize(dtype)
    return -(-m // unit) * unit


def table_bytes(T: int, n: int, rows: Optional[int] = None,
                dtype=F64) -> int:
    """Bytes of the padded U table, (T, rows, slab_stride(n)) of `dtype`
    (rows: the outer slabs held, n by default)."""
    return (T * (n if rows is None else rows) * slab_stride(n, dtype)
            * itemsize(dtype))


def flag_table_bytes(T: int, n: int, rows: Optional[int] = None) -> int:
    """Bytes of the rebuild's row flags, (T, rows, n) bool (rows: the
    outer slabs held, n by default)."""
    return T * (n if rows is None else rows) * n


def require_table_fits(T: int, n: int, free_bytes: int,
                       rows: Optional[int] = None, dtype=F64) -> None:
    """Raise unless the U table of `rows` outer slabs (n by default)
    fits in `free_bytes` of device memory."""
    need = table_bytes(T, n, rows, dtype)
    if need > free_bytes:
        held = "" if rows is None or rows == n else f" ({rows} outer slabs)"
        raise RuntimeError(
            f"the dim-3 table U of T={T} days at num_points={n}{held} needs "
            f"{need} bytes ({need / 2**30:.2f} GiB) of device memory, but "
            f"only {free_bytes} bytes are free; `contract3_operands` builds "
            "no table for such a backtest, and its sweeps rebuild the "
            "slabs on every launch (`masked_contract3_rebuild`)"
        )


def _scan_shared_bytes(n: int, dtype=F64) -> int:
    """The build's scan's shared memory: one padded slab (csrc
    `scan_shared_bytes`)."""
    return slab_stride(n, dtype) * itemsize(dtype)


def table_max_grid_points(q: int, dtype=F64) -> int:
    """The largest n of the table route at q states (169 at q = 5 in
    float64, 192 in float32): one padded n x n slab in one block's shared
    memory (the build's scan), rows no longer than the short rows the
    sweep searches, and the build kernel's (q, n) fold."""
    isz = itemsize(dtype)
    n = 1
    while True:
        m = n + 1
        if (m > BISECT_MAX_ROW
                or _scan_shared_bytes(m, dtype) > MAX_SHARED_BYTES
                or q * m * isz > MAX_SHARED_BYTES):
            return n
        n = m


def rebuild_tile_rows(n: int, q: int, dtype=F64) -> int:
    """i1 rows per block of the rebuild kernel at (n, q): 64 (a lookup
    span of the table sweep, so both routes give the same bits) when x,
    the (q, n) fold of `dtype`, the float64 lookup state of
    `_build.WALK_ROWS` bound rows and the walk's schedule (two stages of
    64 cells of `dtype` and 260 ints) fit in one block's shared memory
    (csrc `rebuild_shared_bytes`, walking full rows); 0 when they do not
    or n passes the interval rule's rows."""
    if not 0 < n <= SWEEP_MAX_GRID_POINTS or q <= 0:
        return 0
    lookups = _build.WALK_ROWS * 64
    cols = -(-(n + q * n) * itemsize(dtype) // 8) * 8
    walk = 2 * 64 * itemsize(dtype) + 4 * (4 * 64 + 4)
    fits = cols + 2 * lookups * 8 + 4 * lookups + walk <= MAX_SHARED_BYTES
    return 64 if fits else 0


def _rebuild_rows(n: int, q: int, dtype=F64) -> int:
    """`rebuild_tile_rows(n, q, dtype)`; a grid the rebuild does not take
    raises, naming the limit."""
    rows = rebuild_tile_rows(n, q, dtype)
    if rows == 0:
        raise ValueError(
            f"num_points={n}: the dim-3 kernels take n <= "
            f"{SWEEP_MAX_GRID_POINTS} (the interval rule's rows, "
            f"csrc/interval.cuh kMaxRow) with the (q, n) fold in shared "
            f"memory (q={q})")
    return rows


def contract3_route(T: int, n: int, q: int, rows: Optional[int],
                    free_bytes: int, dtype=F64) -> str:
    """"table", "rebuild" or "rebuild_full": how a CUDA device sweeps a
    dim-3 backtest of T days at num_points n, q states, `rows` outer slabs
    held (n when None), with `free_bytes` of device memory, in `dtype`
    (float64, or float32 for the f32 engine). The table when its sweep
    takes n and U fits; else the rebuild kernel with its row flags when
    they fit; else the rebuild kernel walking full rows; a grid none takes
    raises."""
    _rebuild_rows(n, q, dtype)
    if (n <= table_max_grid_points(q, dtype)
            and table_bytes(T, n, rows, dtype) <= free_bytes):
        return "table"
    if flag_table_bytes(T, n, rows) <= free_bytes:
        return "rebuild"
    return "rebuild_full"


def table_cells(U: torch.Tensor, n: int) -> torch.Tensor:
    """(T, r, n, n) view of the padded table (T, r, slab_stride(n,
    U.dtype)): its stored rows."""
    p = row_pitch(n)
    return U[..., : n * p].reshape(U.shape[0], U.shape[1], n, p)[..., :n]


def table_pads(U: torch.Tensor, n: int) -> torch.Tensor:
    """The table's pad cells, flattened (all zero as built)."""
    p = row_pitch(n)
    rows = U[..., : n * p].reshape(U.shape[0], U.shape[1], n, p)[..., n:]
    return torch.cat([rows.reshape(-1), U[..., n * p:].reshape(-1)])


def contract3_operands(cols, x, dx, spec: CopulaSpec, densities=None,
                       forecast_combos=None, p_cols=None, rows=None,
                       dtype=F64, days=None):
    """Contract3Operands of `dtype` for the MSM family (densities and
    forecast_combos given) or the GARCH family (p_cols given), from the
    float64 columns and inputs; with `rows` (i0, i1) those of outer slabs
    [i0, i1) (the columns whole). float32 (the f32 engine): the columns,
    weight rows, G (formed in float64), x, dx, densities and combos cast
    to float32, as JAX's f32 dim-3 caches. With `days` (a slice of the T
    days: a day mesh's block) the operands of those days, cut after G is
    formed over all T. On a CUDA device the table U of the operands' days
    and its row flags are built here, once, where `contract3_route` takes
    the table, and the row flags alone where it takes the rebuild; else
    both stay None (on the CPU, and on the full-row route)."""
    itemsize(dtype)
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
    with span("prep.factor"):
        sigma_inv, logdet = _chol_inv_logdet(corr)
        with span("sync.logdet"):
            logdet = float(logdet)
    log_norm = (float(student_log_norm(nu, logdet, 3))
                if spec.kind == "student" else 0.0)
    with span("prep.state_weights"):
        if densities is None:
            w1 = w2 = dx[None, :]
            G = dx[None, :, None, None].expand(T, n, 1, 1)
        else:
            w0, w1, w2 = state_weight_matrices(densities, dx)
            q = w0.shape[0]
            G = torch.einsum("ai,tabc->tibc", w0,
                             forecast_combos.reshape(T, q, q, q))
    if dtype == F32:
        require_full_f32_matmul(z.device)
        f32 = lambda t: None if t is None else t.to(F32)  # noqa: E731
        cols = tuple(c if c.dtype == torch.bool else f32(c) for c in cols)
        z, lu, w1, w2, G, p_cols, x, dx, densities, forecast_combos = (
            f32(t) for t in (z, lu, w1, w2, G, p_cols, x, dx, densities,
                             forecast_combos))
    if days is not None:
        cols = tuple(cut_days(c, days) for c in cols)
        z, fin, lu, G = (cut_days(t, days) for t in (z, fin, lu, G))
        p_cols, forecast_combos = (
            None if t is None else cut_days(t, days)
            for t in (p_cols, forecast_combos))
        T = z.shape[0]
    ops = Contract3Operands(
        spec, tuple(cols), None if p_cols is None else p_cols.contiguous(),
        x, dx, densities, forecast_combos,
        z.contiguous(), fin.contiguous(), lu.contiguous(), w1.contiguous(),
        w2.contiguous(), G.contiguous(), sigma_inv.contiguous(), log_norm,
        logdet, nu,
        rows=None if rows is None else row_range(rows, n),
    )
    if z.device.type == "cuda":
        require_ascending(x)
        route = contract3_route(T, n, ops.w1.shape[0], ops.n_rows,
                                free_device_bytes(z.device), dtype)
        if route == "table":
            U, flags = contract3_weights(ops)
            ops = ops._replace(U=U, flags=flags)
        elif route == "rebuild":
            ops = ops._replace(flags=contract3_row_flags(ops))
    return ops


def _table_chunks(ops: Contract3Operands, days):
    """(day slice, cells (d, r, n, n)) for each day chunk: the cells of U
    for the days `days` selects and the operands' outer slabs, built from
    the transform columns as the transform-cached sweeps build their
    density."""
    outer = outer_slice(ops.rows)
    cols = tuple(c[days] for c in ops.cols)
    p = None if ops.p_cols is None else ops.p_cols[days]
    G = ops.G[days] if outer is None else ops.G[days][:, outer]
    for s in _chunks(G.shape[0], ops.x.shape[0], 3, ops.x.device, None,
                     outer):
        V = copula_density_cols(tuple(c[s] for c in cols), ops.spec, outer)
        if p is not None:
            V = torch.nan_to_num(V * _pdf_product(p[s], outer))
        yield s, V * torch.einsum("bj,tibc,ck->tijk", ops.w1, G[s], ops.w2)


def contract3_weights_reference(ops: Contract3Operands, days=slice(None)):
    """Plain PyTorch twin of the table, on any device: U for the days
    `days` selects and the operands' outer slabs, (D, r, n, n),
    unpadded, built in day chunks from the transform columns as the
    transform-cached sweeps build their density."""
    n = ops.x.shape[0]
    out = torch.empty((ops.G[days].shape[0], ops.n_rows, n, n),
                      dtype=ops.dtype, device=ops.x.device)
    for s, U in _table_chunks(ops, days):
        out[s] = U
    return out


def contract3_table_reference(ops: Contract3Operands, days=slice(None)):
    """Plain PyTorch twin of the table's stored form, on any device:
    (S (D, r, n, n), flags (D, r, n) bool) for the days `days` selects and
    the operands' outer slabs, unpadded. A row of U holding a cell outside
    [-MAX_CELL, MAX_CELL] (NaN included) is flagged and kept as its cells;
    every other row is its inclusive prefix sum over i2, accumulated in
    float64 in index order and rounded to the operands' type once, as the
    build's scan stores it."""
    U = contract3_weights_reference(ops, days)
    flags = ~(U.abs() <= MAX_CELL).all(dim=-1)
    prefix = torch.cumsum(U.to(F64), dim=-1).to(U.dtype)
    return torch.where(flags[..., None], U, prefix), flags


def contract3_row_flags_reference(ops: Contract3Operands,
                                  days=slice(None)):
    """Plain PyTorch twin of the row flags, on any device: (D, r, n) bool
    for the days `days` selects and the operands' outer slabs, True where
    a cell of the row (day, i0, i1) of U lies outside [-MAX_CELL,
    MAX_CELL] or is NaN; U is formed a day chunk at a time."""
    out = torch.empty((ops.G[days].shape[0], ops.n_rows, ops.x.shape[0]),
                      dtype=torch.bool, device=ops.x.device)
    for s, U in _table_chunks(ops, days):
        out[s] = ~(U.abs() <= MAX_CELL).all(dim=-1)
    return out


def contract3_row_flags(ops: Contract3Operands):
    """The row flags (T, r, n) bool of the operands' r outer slabs. CPU
    tensors run the plain twin; CUDA tensors launch the flag kernel (one
    block per (day, i0) slab, the cells of the whole slab formed as the
    table build forms them, one byte per row out, the flagged rows
    counted); any other device raises. Either way the flags' bytes
    (`prep.flag_bytes`) and the flagged rows, which the rebuild sums
    cell by cell (`prep.flagged_rows`, one host read), are counted."""
    dev = ops.z.device
    if dev.type == "cpu":
        flags = contract3_row_flags_reference(ops)
        count("prep.flag_bytes", flags.nbytes)
        count("prep.flagged_rows", int(flags.sum()))
        return flags
    if dev.type != "cuda":
        raise ValueError(f"contract3_row_flags: unsupported device {dev}")
    with span("launch.contract3_row_flags"):
        T, n, q = _check_columns(ops)
        _rebuild_rows(n, q, ops.dtype)
        r = ops.n_rows
        flags = torch.empty((T, r, n), dtype=torch.bool, device=dev)
        count("prep.flag_bytes", flags.nbytes)
        if T == 0:  # an empty day block: no launch
            count("prep.flagged_rows", 0)
            return flags
        p = None if ops.p_cols is None else ops.p_cols.data_ptr()
        # the kernel's count of flagged rows, as the table build's
        flagged = torch.zeros(1, dtype=torch.int32, device=dev)
        fn = _build.function("cvt_contract3_row_flags", ops.dtype)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            status = fn(
                ops.z.data_ptr(), ops.fin.data_ptr(), ops.lu.data_ptr(), p,
                ops.w1.data_ptr(), ops.w2.data_ptr(), ops.G.data_ptr(),
                ops.sigma_inv.data_ptr(), int(ops.spec.kind == "student"),
                ops.nu, ops.log_norm, ops.logdet, flags.data_ptr(),
                flagged.data_ptr(), T, n, ops.row0, r, q, stream,
            )
        _build.check(status, "contract3_row_flags")
        with span("sync.flagged_rows"):
            count("prep.flagged_rows", int(flagged))
    count_launch(contract3_row_flags, ops.dtype)
    return flags


def contract3_weights(ops: Contract3Operands):
    """The padded table U (T, r, slab_stride(n)) of the operands' r outer
    slabs in its stored form, and its row flags (T, r, n) bool, on their
    CUDA device: the build kernel (one block per (day, i0) slab), then the
    scan (each slab's rows into their prefix sums in place, a flagged row
    kept as its cells), launched after checking that the card's free
    memory holds the table. The flagged rows are counted
    (`prep.flagged_rows`, one host read), and U's and the flags' bytes
    (`prep.table_bytes`). Other devices raise: the CPU route sums
    `contract3_weights_reference`'s cells through the plain sweep and
    needs no table."""
    dev = ops.z.device
    if dev.type != "cuda":
        raise ValueError(f"contract3_weights: unsupported device {dev} "
                         "(the table is built on a CUDA device only)")
    with span("launch.contract3_weights"):
        T, n, q = check_contract3_operands(ops)
        r, dt = ops.n_rows, ops.dtype
        require_table_fits(T, n, free_device_bytes(dev), r, dt)
        U = torch.empty((T, r, slab_stride(n, dt)), dtype=dt, device=dev)
        flags = torch.empty((T, r, n), dtype=torch.bool, device=dev)
        count("prep.table_bytes", U.nbytes + flags.nbytes)
        if T == 0:  # an empty day block: no launch
            count("prep.flagged_rows", 0)
            return U, flags
        p = None if ops.p_cols is None else ops.p_cols.data_ptr()
        # the kernel's count of flagged rows (a sum over the flags would
        # cast all of them to int64 first)
        flagged = torch.zeros(1, dtype=torch.int32, device=dev)
        fn = _build.function("cvt_contract3_weights", dt)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            status = fn(
                ops.z.data_ptr(), ops.fin.data_ptr(), ops.lu.data_ptr(), p,
                ops.w1.data_ptr(), ops.w2.data_ptr(), ops.G.data_ptr(),
                ops.sigma_inv.data_ptr(), int(ops.spec.kind == "student"),
                ops.nu, ops.log_norm, ops.logdet, U.data_ptr(),
                flags.data_ptr(), flagged.data_ptr(), T, n, ops.row0, r, q,
                row_pitch(n), slab_stride(n, dt), stream,
            )
        _build.check(status, "contract3_weights")
        with span("sync.flagged_rows"):
            count("prep.flagged_rows", int(flagged))
    count_launch(contract3_weights, dt)
    return U, flags


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
    dev, dt = ops.z.device, ops.dtype
    itemsize(dt)
    for name in ("z", "lu"):
        _check_operand(name, getattr(ops, name), (T, 3, n), dev, dt)
    _check_operand("fin", ops.fin, (T, 3, n), dev, torch.bool)
    if ops.p_cols is not None:
        _check_operand("p_cols", ops.p_cols, (T, 3, n), dev, dt)
    _check_operand("x", ops.x, (n,), dev, dt)
    _check_operand("w1", ops.w1, (q, n), dev, dt)
    _check_operand("w2", ops.w2, (q, n), dev, dt)
    _check_operand("G", ops.G, (T, n, q, q), dev, dt)
    _check_operand("sigma_inv", ops.sigma_inv, (3, 3), dev)
    return T, n, q


def check_contract3_operands(ops: Contract3Operands):
    """Validate the build kernel's operands; returns (T, n, q)."""
    T, n, q = _check_columns(ops)
    n_max = table_max_grid_points(q, ops.dtype)
    if n > n_max:
        raise ValueError(
            f"num_points={n} needs an {n}x{n} {ops.dtype} slab in one "
            f"block's shared memory; the dim-3 table's build and its sweep "
            f"take n <= {n_max} at q={q} (wider grids sweep by the rebuild "
            "kernel, `masked_contract3_rebuild`)"
        )
    return T, n, q


def check_table(ops: Contract3Operands, what: str):
    """Validate the table U, its row flags and x that a table sweep reads
    (`masked_contract3`, and the fused dim-3 solve's kernels); returns (T,
    n, r), r the outer slabs held."""
    if ops.U is None or ops.flags is None:
        raise ValueError(f"{what}: the operands carry no table U (build "
                         "them with contract3_operands)")
    dev, dt = ops.z.device, ops.dtype
    T, n, r = ops.days, ops.x.shape[0], ops.n_rows
    itemsize(dt)
    _check_operand("U", ops.U, (T, r, slab_stride(n, dt)), dev, dt)
    _check_operand("flags", ops.flags, (T, r, n), dev, torch.bool)
    _check_operand("x", ops.x, (n,), dev, dt)
    return T, n, r


def masked_contract3(ops: Contract3Operands, bounds, weights, box_min=-5.0):
    """(L, T) slab integrals for bounds (L, T, 2) and per-row portfolio
    weights (L, 3) ([inner, outer0, outer1]), the share of the operands'
    outer slabs. CPU tensors run the plain twin; CUDA tensors launch the
    sweep kernel on the table U and its flags (one block per day: each row
    lookup reads the two prefixes at its interval's ends, or a flagged
    row's cells, then the day's fixed-order sum over the outer index, in
    the same launch); any other device raises."""
    dev = ops.z.device
    if dev.type == "cpu":
        return masked_contract3_reference(ops, bounds, weights, box_min)
    if dev.type != "cuda":
        raise ValueError(f"masked_contract3: unsupported device {dev}")
    with span("launch.masked_contract3"):
        T, n, r = check_table(ops, "masked_contract3")
        dt = ops.dtype
        L = bounds.shape[0]
        _check_operand("bounds", bounds, (L, T, 2), dev, dt)
        _check_operand("weights", weights, (L, 3), dev, dt)
        fn = _build.function("cvt_masked_contract3", dt)
        out = torch.empty((L, T), dtype=dt, device=dev)
        if out.numel() == 0:  # an empty day block: no launch
            return out
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            status = fn(
                ops.U.data_ptr(), ops.flags.data_ptr(), ops.x.data_ptr(),
                bounds.data_ptr(), weights.data_ptr(), float(box_min),
                out.data_ptr(), T, n, ops.row0, r, L, row_pitch(n),
                slab_stride(n, dt), stream,
            )
        _build.check(status, "masked_contract3")
    count_launch(masked_contract3, dt)
    return out


def masked_contract3_rebuild(ops: Contract3Operands, bounds, weights,
                             box_min=-5.0):
    """`masked_contract3` without the table: (L, T) slab integrals for
    bounds (L, T, 2) and weights (L, 3), the share of the operands' outer
    slabs. CPU tensors run the plain twin; CUDA tensors launch the
    rebuild kernel (one block per (day, i0) slab and tile of 64 i1 rows:
    each row's intervals from x, the bounds and the weights, then each
    row's cells from the transform columns as far as its intervals reach,
    summed into its prefix in index order; with the operands' row flags,
    or, without them, over whole rows flagged by the scan), then a
    fixed-order sum of the tiles' partials; any other device raises."""
    dev = ops.z.device
    if dev.type == "cpu":
        return masked_contract3_reference(ops, bounds, weights, box_min)
    if dev.type != "cuda":
        raise ValueError(f"masked_contract3_rebuild: unsupported device {dev}")
    with span("launch.masked_contract3_rebuild"):
        T, n, q = _check_columns(ops)
        dt = ops.dtype
        tile_rows = _rebuild_rows(n, q, dt)
        r = ops.n_rows
        L = bounds.shape[0]
        _check_operand("bounds", bounds, (L, T, 2), dev, dt)
        _check_operand("weights", weights, (L, 3), dev, dt)
        if ops.flags is not None:
            _check_operand("flags", ops.flags, (T, r, n), dev, torch.bool)
        p = None if ops.p_cols is None else ops.p_cols.data_ptr()
        flags = None if ops.flags is None else ops.flags.data_ptr()
        fn = _build.function("cvt_masked_contract3_rebuild", dt)
        # one float64 partial per (row, day, i0 held, tile of i1), summed
        # in order
        partial = torch.empty((L, T, r * -(-n // tile_rows)), dtype=F64,
                              device=dev)
        out = torch.empty((L, T), dtype=dt, device=dev)
        if out.numel() == 0:  # an empty day block: no launch
            return out
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            status = fn(
                ops.z.data_ptr(), ops.fin.data_ptr(), ops.lu.data_ptr(), p,
                ops.w1.data_ptr(), ops.w2.data_ptr(), ops.G.data_ptr(),
                ops.sigma_inv.data_ptr(), int(ops.spec.kind == "student"),
                ops.nu, ops.log_norm, ops.logdet, flags, ops.x.data_ptr(),
                bounds.data_ptr(), weights.data_ptr(), float(box_min),
                partial.data_ptr(), out.data_ptr(), T, n, ops.row0, r, q, L,
                stream,
            )
        _build.check(status, "masked_contract3_rebuild")
    count_launch(masked_contract3_rebuild, dt)
    return out
