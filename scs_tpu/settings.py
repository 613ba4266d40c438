"""Solver settings: names, defaults, and validation.

Mirrors the reference solver's 17 runtime settings (parsed by keyword in the
reference C extension, /root/reference/scs/scsobject.h:467-495) plus the
NaN/Inf validation policy documented at scsobject.h:802-868:

  * max_iters > 0
  * acceleration_lookback >= 0 (0 disables AA)
  * acceleration_interval > 0
  * acceleration_regularization finite, >= 0
  * acceleration_relaxation finite, in [0, 2]
  * scale finite, > 0
  * time_limit_secs >= 0 (0 disables; +inf allowed)
  * eps_abs / eps_rel / eps_infeas >= 0 (+inf allowed, NaN rejected)
  * alpha finite, in (0, 2)
  * rho_x finite, > 0

Extras with no reference analogue are grouped at the bottom of the
dataclass: dtype control, linear-solver strategy, CG knobs, and the
device-loop chunking interval.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Optional, Union

# Default operating point of the reference solver (BASELINE.md "Reference
# default operating point"; reference README.md:98-104).
DEFAULTS = dict(
    verbose=True,
    normalize=True,
    adaptive_scale=True,
    max_iters=100_000,
    scale=0.1,
    eps_abs=1e-4,
    eps_rel=1e-4,
    eps_infeas=1e-7,
    alpha=1.5,
    rho_x=1e-6,
    time_limit_secs=0.0,
    acceleration_lookback=10,
    acceleration_interval=10,
    acceleration_type_1=1,
    acceleration_regularization=1e-8,
    acceleration_relaxation=1.0,
    write_data_filename=None,
    log_csv_filename=None,
)


def _err(msg):
    raise ValueError(msg)


_CACHE_DONE = False

# Persistent compile cache used when JAX_COMPILATION_CACHE_DIR is unset:
# a fixed directory inside the checkout (the path is part of the cache
# key, so it must not move between processes).
DEFAULT_COMPILE_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


def compile_cache_dir() -> Optional[str]:
    """The directory ensure_compile_cache sets, or None when
    JAX_COMPILATION_CACHE_DIR is set (JAX reads that variable itself)."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return DEFAULT_COMPILE_CACHE


def ensure_compile_cache():
    """Turn on JAX's persistent compilation cache, once per process.

    The solver's setup cost is XLA compilation; the on-disk cache
    amortizes it across processes. Called by the library, the bench,
    chip_smoke.py and the tests, so all of them share one policy. A
    directory the host application already configured is left alone.
    """
    global _CACHE_DONE
    if _CACHE_DONE:
        return
    _CACHE_DONE = True
    import jax

    path = compile_cache_dir()
    if path is None or jax.config.jax_compilation_cache_dir:
        return
    jax.config.update("jax_compilation_cache_dir", path)


@dataclasses.dataclass
class Settings:
    """Validated solver settings (reference parity + extras)."""

    verbose: bool = True
    normalize: bool = True
    adaptive_scale: bool = True
    max_iters: int = 100_000
    scale: float = 0.1
    eps_abs: float = 1e-4
    eps_rel: float = 1e-4
    eps_infeas: float = 1e-7
    alpha: float = 1.5
    rho_x: float = 1e-6
    time_limit_secs: float = 0.0
    acceleration_lookback: int = 10
    acceleration_interval: int = 10
    acceleration_type_1: int = 1
    acceleration_regularization: float = 1e-8
    acceleration_relaxation: float = 1.0
    write_data_filename: Optional[str] = None
    log_csv_filename: Optional[str] = None

    # --- extras (no reference analogue) ---
    # Numeric dtype of the on-device solve: "auto" | "float64" | "float32".
    # "auto" resolves to float64 on every backend (reference parity: the
    # reference core is f64 unless built with -DSFLOAT).
    dtype: str = "auto"
    # Linear-system strategy (maps the reference's LinearSolver backends onto
    # this package's paths): "auto" | "direct" (batched dense Cholesky) |
    # "indirect" (matrix-free CG on dense A) | "bell" (matrix-free CG with
    # block-ELL SpMV — the sparse path for large sparse problems).
    solver_strategy: str = "auto"
    # Tile size for the block-ELL pack (bell strategy); smaller tiles only
    # make sense for CPU testing (PERF.md records the H100 measurement).
    bell_block_size: int = 128
    # Direct-strategy linear solve: "cholesky" applies the cached factor via
    # two triangular solves (sequential along n — right for one problem at
    # high accuracy); "inverse" precomputes S^-1 once at setup and applies
    # it as a single dense matvec, one bandwidth-bound op per problem (the
    # batched path defaults to it; not yet re-measured on the H100).
    direct_solver: str = "cholesky"
    # CG controls for the indirect path (reference: linsys/cpu/indirect,
    # tolerance tightened per-iteration at rate cg_rate).
    cg_rate: float = 2.0
    cg_max_iters: int = 1000
    cg_tol_min: float = 1e-12
    # Inexact-Krylov slack: CG tolerance = cg_tol_factor x the previous
    # DR step size (see solver._step_lin). Larger = fewer CG iterations
    # per linear solve at slightly more DR iterations. 2.0 lands the
    # measured avg-CG-iterations at the reference indirect backend's
    # operating point ('avg cg its: 9.73', scs_qp.ipynb cell 20).
    cg_tol_factor: float = 2.0
    # How many ADMM iterations each on-device chunk runs between host-side
    # checks (verbose print, time limit, SIGINT). Residual/termination checks
    # happen on device at this granularity too.
    check_interval: int = 25
    # Silent solves poll the host only every host_poll_chunks chunks (the
    # device early-exits between polls once terminated): each poll is a
    # device round-trip. Verbose/CSV/time-limited solves poll every chunk
    # regardless. The default is not re-derived on the H100 yet.
    host_poll_chunks: int = 8
    # Per-phase timing (info dict lin_sys_time/cone_time/accel_time).
    # "always": instrumented mode — split per-phase dispatches, REAL
    #   accumulated wall-clock timers, one CSV row per iteration
    #   (check_interval forced to 1; slower).
    # "auto": cheap estimate (per-call calibration x phase counts) when
    #   the solve is verbose or long enough (>0.3 s) to amortize the
    #   calibration compile. NOTE: fast silent solves report 0.0 timers
    #   under "auto" — use "always" when timers must be populated.
    # "off": never measure.
    phase_timing: str = "auto"
    # AA safeguarding: accept a candidate if its fixed-point residual is at
    # most aa_safeguard_factor x the current one; optionally clear the AA
    # memory after a rejection (the rejected direction stays poisonous
    # otherwise — the reference core resets its AA state similarly).
    aa_safeguard_factor: float = 2.0
    aa_reset_on_reject: bool = False
    # Batched-solve retirement (BatchedSCS): compact the batch to a
    # smaller static shape when enough problems have terminated, instead
    # of running every problem in lockstep until the slowest finishes.
    # batch_compact_interval = device chunks (of check_interval iterations
    # each) between host-side retirement checkpoints.
    batch_compaction: bool = True
    batch_compact_interval: int = 4
    # Where the adaptive-scale refactorization runs: True = inside the
    # compiled solve loop (single-problem path); False = in a separate
    # program between segments (BatchedSCS sets this — keeps the hot
    # loop's XLA memory plan free of the S/chol/S^-1 transients).
    rescale_in_chunk: bool = True
    # Iterative-refinement passes on the direct factor solve. -1 = auto:
    # one pass for float32 (the factor-solve roundoff otherwise floors
    # the achievable residual around cond(S)*eps_f32), zero for float64.
    # Each pass costs one extra S matvec + factor apply per iteration.
    lin_refine_steps: int = -1
    # Adaptive-scale update guards (reference core: scale updated when the
    # primal/dual residual ratio drifts; 'factorizations: 8' in logs).
    rescale_min_iters: int = 100
    rescale_factor_band: float = 2.0
    min_scale: float = 1e-6
    max_scale: float = 1e6

    def __post_init__(self):
        f = float
        if int(self.max_iters) <= 0:
            _err("max_iters must be positive")
        if int(self.acceleration_lookback) < 0:
            _err(
                "acceleration_lookback must be nonnegative "
                "(use acceleration_type_1=0 for type-II AA)"
            )
        if int(self.acceleration_interval) <= 0:
            _err("acceleration_interval must be positive")
        r = f(self.acceleration_regularization)
        if not math.isfinite(r) or r < 0:
            _err("acceleration_regularization must be a nonnegative finite number")
        r = f(self.acceleration_relaxation)
        if not math.isfinite(r) or r < 0 or r > 2:
            _err("acceleration_relaxation must be in [0, 2]")
        if not math.isfinite(f(self.scale)) or f(self.scale) <= 0:
            _err("scale must be a positive finite number")
        t = f(self.time_limit_secs)
        if math.isnan(t) or t < 0:
            _err("time_limit_secs must be nonnegative")
        for name in ("eps_abs", "eps_rel", "eps_infeas"):
            v = f(getattr(self, name))
            if math.isnan(v) or v < 0:
                _err(f"{name} must be nonnegative")
        a = f(self.alpha)
        if not math.isfinite(a) or a <= 0 or a >= 2:
            _err("alpha must be in (0, 2)")
        rx = f(self.rho_x)
        if not math.isfinite(rx) or rx <= 0:
            _err("rho_x must be a positive finite number")
        if self.dtype not in ("auto", "float64", "float32"):
            _err("dtype must be 'auto', 'float64' or 'float32'")
        if self.dtype == "auto":
            self.dtype = "float64"
        if int(self.check_interval) < 1:
            _err("check_interval must be >= 1")
        if int(self.host_poll_chunks) < 1:
            _err("host_poll_chunks must be >= 1")
        if int(self.batch_compact_interval) < 1:
            # a non-positive segment would spin BatchedSCS.solve forever
            # (run_seg's chunk condition is immediately false; ADVICE r3)
            _err("batch_compact_interval must be >= 1")
        if self.phase_timing not in ("auto", "always", "off"):
            _err("phase_timing must be 'auto', 'always' or 'off'")
        if self.direct_solver not in ("cholesky", "inverse"):
            _err("direct_solver must be 'cholesky' or 'inverse'")
        if self.solver_strategy not in ("auto", "direct", "indirect", "bell"):
            _err(
                "solver_strategy must be 'auto', 'direct', 'indirect' or"
                " 'bell' (block-ELL matrix-free)"
            )

    @classmethod
    def from_kwargs(cls, **kwargs) -> "Settings":
        """Build Settings, rejecting unknown keys with TypeError.

        The reference raises TypeError from PyArg_ParseTupleAndKeywords for
        unknown keywords (tested at test_scs_object.py:113-133); mirror that.
        """
        valid = {fld.name for fld in dataclasses.fields(cls)}
        for k in kwargs:
            if k not in valid:
                raise TypeError(f"'{k}' is an invalid keyword argument for SCS()")
        # bool-typed settings must be genuine bools in the reference
        # (parsed with O! PyBool_Type); accept ints 0/1 too for convenience.
        return cls(**kwargs)


StrOrNone = Union[str, None]
