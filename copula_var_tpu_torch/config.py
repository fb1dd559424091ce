"""Typed configuration of a backtest run and the config-driven pipeline
(counterpart of `copula_var_tpu/config.py`).

The dataclasses collect the reference's knobs (`main.py:25-50`, the
constructor defaults of `utils/calc_var_class.py:9-20,95,111-112,201-202`
and the optimizers' hyperparameters) with the reference's defaults;
`run_backtest` is the reference's `main.py` pipeline: fit, build, solve.

Here the device picks the path (the card's kernels or the plain twins on
the CPU), and the JAX config's engines mean: "xla" the f64 path on one
device; "pallas" the f32 engine on one device (`VaRBacktest(engine=
"pallas")`: the f32 kernels, roots within the plateau bound of the f64
engine's); "sharded" the day-sharded serving of `parallel/` over a mesh
of `n_mesh_devices` ranks on the f64 path, and "sharded_pallas" the f32
engine on such a mesh (`VaRBacktest(engine="pallas", mesh=<DayMesh>)`);
and "grid_sharded" the grid-sharded serving of `parallel/` over a (1, D)
('days', 'grid') mesh. `pallas_day_block` (the day block of the JAX f32
kernel's TPU grid) is kept for the round trip: the port's f32 kernels
run one block per day, and JAX's f32 roots do not move with the block
(tests/test_torch_config.py holds both). `BacktestConfig.from_dict`
takes a dict written by the JAX `to_dict`.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple

import numpy as np

# the JAX engines the port serves: one device (f64 or f32), day-sharded
# over a mesh (f64 or f32), or grid-sharded over a (1, D) ('days', 'grid')
# mesh
ENGINES = ("xla", "pallas", "sharded", "sharded_pallas", "grid_sharded")
SHARDED_ENGINES = ("sharded", "sharded_pallas")
PALLAS_ENGINES = ("pallas", "sharded_pallas")  # the f32 engine


@dataclass
class MsmConfig:
    """`opti.py:9-23,113` + `main.py:69` (k=4)."""

    k: int = 4
    basin_iter: int = 100
    step_size: float = 0.2
    b_grid: Tuple[float, float, int] = (1.0, 50.0, 10)
    m0_bounds: Tuple[float, float] = (0.2, 0.8)
    b_bounds: Tuple[float, float] = (1.0, 50.0)
    gamma_bounds: Tuple[float, float] = (0.05, 0.95)
    gamma_weight: float = 0.0
    b_weight: float = 0.0
    seed: int = 0
    # the reference's min-LL start selection (not ported: raises)
    reference_quirks: bool = False


@dataclass
class GarchConfig:
    """`garch/opti.py:8-18`."""

    p_max: int = 3
    q_max: int = 3
    newton_tol: float = 1e-10
    newton_max_iter: int = 1000
    fd_epsilon: float = 1e-5  # also the positivity floor base
    # the reference's FD-Newton trajectory (not ported: raises)
    reference_quirks: bool = False


@dataclass
class MeanRevertingConfig:
    """`kalman_mean_reverting/optimize.py:7-26` + the fixed init
    (`mean_reverting_estimation.py:41-47`)."""

    a0: float = 0.99
    l0: float = 0.5
    q0: float = 0.1
    em_max_iter: int = 1000
    em_tol: float = 1e-6
    perturb_scale: float = 0.05
    restart_attempts: int = 5
    seed: int = 0
    # the reference's frozen-a EM M-step
    reference_quirks: bool = False


@dataclass
class CopulaConfig:
    """`student/opti.py:9`, `plackett/opti.py:66`, shared tol/maxiter."""

    nu_grid: Tuple[float, float, int] = (2.1, 30.0, 10)
    nu_bounds: Tuple[float, float] = (2.01, 50.0)
    theta_grid: Tuple[float, float, int] = (0.5, 50.0, 10)
    tol: float = 1e-9
    max_iter: int = 5000


@dataclass
class SolverConfig:
    """`calc_var_class.py:95,111-112,201-202` + tol at `:256`."""

    obj_var: float = 0.05
    # when set, solve the whole confidence ladder in one batched solve
    # (`VaRBacktest.calc_var_levels`) instead of the single obj_var
    obj_levels: Optional[Tuple[float, ...]] = None
    first_guess: float = -3.0
    second_guess: Tuple[float, float] = (-3.5, -2.0)
    min_var_value: float = -7.5
    max_var_value: float = 0.0
    box: Tuple[float, float] = (-5.0, 5.0)
    tolerance: float = 1e-6


@dataclass
class BacktestConfig:
    """Top-level run config (`main.py:25-50` + `calc_var_class.py:9-20`)."""

    estimation_type: str = "garch"  # 'msm' | 'garch' | 'mean_reverting'
    copula_type: str = "student"  # 'gaussian' | 'student' | 'plackett'
    n_insample: int = 1135
    num_points: int = 100
    # 'xla': one device, f64; 'pallas': one device, the f32 engine;
    # 'sharded' / 'sharded_pallas': the day-sharded f64 path / f32 engine
    # over a mesh of n_mesh_devices ranks (None: the whole world);
    # 'grid_sharded': the outer grid axis split over them
    engine: str = "xla"
    n_mesh_devices: Optional[int] = None
    # the JAX f32 kernel's TPU day block: kept for the round trip (the
    # port's f32 kernels run one block per day)
    pallas_day_block: int = 32
    weights: Optional[Sequence[float]] = None  # default equal weights
    msm: MsmConfig = field(default_factory=MsmConfig)
    garch: GarchConfig = field(default_factory=GarchConfig)
    mean_reverting: MeanRevertingConfig = field(
        default_factory=MeanRevertingConfig)
    copula: CopulaConfig = field(default_factory=CopulaConfig)
    solver: SolverConfig = field(default_factory=SolverConfig)

    def __post_init__(self):
        if self.engine not in ENGINES:
            raise ValueError(
                f"engine={self.engine!r}: the port serves {ENGINES} (the "
                "device picks the path)")
        block = self.pallas_day_block
        if (isinstance(block, bool) or not isinstance(block, int)
                or block < 1):
            raise ValueError(
                f"pallas_day_block={block!r}: the JAX f32 kernel's day "
                "block is a positive number of days")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "BacktestConfig":
        """The config of a dict from `to_dict`, of this package or of the
        JAX package (whose `engine` must be one the port serves)."""
        d = dict(d)
        for name, sub in (
            ("msm", MsmConfig),
            ("garch", GarchConfig),
            ("mean_reverting", MeanRevertingConfig),
            ("copula", CopulaConfig),
            ("solver", SolverConfig),
        ):
            if name in d and isinstance(d[name], dict):
                d[name] = sub(**d[name])
        return cls(**d)


def adapter_kwargs(cfg: BacktestConfig) -> dict:
    """Map the config onto the factory's adapter kwargs (every knob)."""
    if cfg.estimation_type == "msm":
        m = cfg.msm
        return dict(
            k=m.k, basin_iter=m.basin_iter, seed=m.seed,
            step_size=m.step_size,
            b_values=np.linspace(*m.b_grid[:2], int(m.b_grid[2])),
            gamma_weight=m.gamma_weight, b_weight=m.b_weight,
            bounds=np.array([m.m0_bounds, m.b_bounds, m.gamma_bounds]),
            reference_quirks=m.reference_quirks,
        )
    if cfg.estimation_type == "garch":
        g = cfg.garch
        return dict(
            p_max=g.p_max, q_max=g.q_max,
            newton_max_iter=g.newton_max_iter, newton_tol=g.newton_tol,
            eps=g.fd_epsilon, reference_quirks=g.reference_quirks,
        )
    if cfg.estimation_type == "mean_reverting":
        m = cfg.mean_reverting
        return dict(
            em_max_iter=m.em_max_iter, seed=m.seed, a0=m.a0, l0=m.l0,
            q0=m.q0, em_tol=m.em_tol, perturb_scale=m.perturb_scale,
            restart_attempts=m.restart_attempts,
            reference_quirks=m.reference_quirks,
        )
    raise ValueError(f"Unsupported estimation type: {cfg.estimation_type}")


def copula_fit_kwargs(cfg: BacktestConfig) -> dict:
    """Map CopulaConfig onto the IFM fitter kwargs."""
    c = cfg.copula
    if cfg.copula_type == "student":
        return dict(
            nu_values=np.linspace(*c.nu_grid[:2], int(c.nu_grid[2])),
            nu_bounds=c.nu_bounds, tol=c.tol, max_iter=c.max_iter,
        )
    if cfg.copula_type == "plackett":
        return dict(
            theta_range=np.linspace(*c.theta_grid[:2], int(c.theta_grid[2])),
            tol=c.tol, max_iter=c.max_iter,
        )
    return dict(tol=c.tol, max_iter=c.max_iter)


def run_backtest(data, cfg: BacktestConfig, device="cuda", mesh=None):
    """Config-driven pipeline (the reference `main.py`): the factory
    fits and builds the backtest on `device` (the card unless the caller
    asks for "cpu"), then the VaR series of `solver.obj_var`, or of every
    level of `solver.obj_levels` in one batched solve. A sharded `engine`
    serves over `mesh`, or when none is given over `make_mesh(
    n_mesh_devices, device)` (the initialized world), at "grid_sharded" a
    (1, D) ('days', 'grid') mesh of its D ranks (JAX `config.py:203-209`,
    `_get_mesh`); a given `mesh` is used at every engine. "pallas" and
    "sharded_pallas" build the f32 engine (`engine="pallas"`), the
    latter on the day mesh. Returns (VaRBacktest, var)."""
    from copula_var_tpu_torch.backtest import create_var_backtest
    from copula_var_tpu_torch.parallel.mesh import make_mesh

    if mesh is None and cfg.engine in SHARDED_ENGINES:
        mesh = make_mesh(cfg.n_mesh_devices, device)
    elif mesh is None and cfg.engine == "grid_sharded":
        mesh = make_mesh(cfg.n_mesh_devices, device, axis_names=("grid",))
    bt = create_var_backtest(
        data,
        cfg.estimation_type,
        cfg.copula_type,
        num_points=cfg.num_points,
        box=cfg.solver.box,
        copula_fit_kwargs=copula_fit_kwargs(cfg),
        device=device,
        mesh=mesh,
        engine="pallas" if cfg.engine in PALLAS_ENGINES else "xla",
        **adapter_kwargs(cfg),
    )
    common = dict(
        first_guess=cfg.solver.first_guess,
        second_guess=cfg.solver.second_guess,
        tolerance=cfg.solver.tolerance,
        min_var_value=cfg.solver.min_var_value,
        max_var_value=cfg.solver.max_var_value,
    )
    if cfg.solver.obj_levels is not None:
        var = bt.calc_var_levels(tuple(cfg.solver.obj_levels), **common)
    else:
        var = bt.calc_var(obj_var=cfg.solver.obj_var, **common)
    return bt, var
