"""scs_tpu — a JAX conic quadratic-program solver framework.

Solves   minimize    (1/2) x'Px + c'x
         subject to  Ax + s = b,  s in K

for K a product of zero, nonnegative, box, second-order, PSD (real and
complex), exponential, power, and spectral (logdet / nuclear / ell1 /
sum-of-largest) cones — the capability surface of the reference scs-python
package, re-designed for accelerators: dense-block batched linear algebra,
jit-compiled ADMM loops, vmap/sharded scenario batching, and matrix-free
CG (dense or block-ELL sparse) for large problems.
"""

import jax as _jax

# The solver operates in float64 by default (reference parity); enabling
# x64 only changes what types are representable — float32 paths still run
# in float32 when requested via Settings.dtype.
_jax.config.update("jax_enable_x64", True)

# NOTE on matmul precision: at default precision XLA may run float32 matmuls
# in TF32 on NVIDIA GPUs (~1e-3 relative error) — fatal for an iterative
# solver whose linear projection must be accurate to ~1e-6 (the DR iteration
# stalls at the matmul noise floor). The solver pins "highest" precision at TRACE time inside its
# own compiled functions (solver._hp) rather than mutating the process-global
# jax_default_matmul_precision config, so host applications embedding the
# solver keep their own matmul precision/perf trade-offs.

__version__ = "1.0.0"  # framework version; tracks reference capability 3.2.11

from .api import SCS, solve, LinearSolver  # noqa: E402,F401
from .batch import BatchedSCS, solve_batch  # noqa: E402,F401
from .cones import ConeSpec  # noqa: E402,F401
from .settings import Settings  # noqa: E402,F401
from .info import (  # noqa: E402,F401
    INFEASIBLE_INACCURATE,
    UNBOUNDED_INACCURATE,
    SIGINT,
    FAILED,
    INDETERMINATE,
    INFEASIBLE,
    UNBOUNDED,
    UNFINISHED,
    SOLVED,
    SOLVED_INACCURATE,
)

__sizeof_int__ = 8
__sizeof_float__ = 8
