"""relp_tpu — an exact linear-programming framework on a JAX accelerator.

A ground-up re-design of the capabilities of ``vandenheuvel/relp`` (an exact,
single-core, rational-arithmetic revised-simplex library in Rust) for an
accelerator via JAX/XLA (an NVIDIA GPU; CPU for tests):

* The *data pipeline* (MPS import, GeneralForm, presolve, prescale,
  standardization) runs host-side in exact rational arithmetic
  (``fractions.Fraction``), mirroring the semantics of the reference
  (reference: src/io, src/data/linear_program).
* The *simplex engine* runs on the device in floating point: dense padded
  standard-form arrays, jitted two-phase revised simplex with product-form or
  LU basis inverses and Dantzig / steepest-edge pricing
  (reference semantics: src/algorithm/two_phase).
* The *exactness guarantee* is restored by a host-side exact certification
  pass: the optimal basis found in floats is re-solved in exact rational
  arithmetic (Dixon p-adic lifting) and optimality is verified via exact
  reduced costs (reference analog: relp-num arithmetic +
  tableau debug_assert_in_basic_feasible_solution_state).
* *Scale-out* uses jax.sharding meshes: column-sharded pricing with a
  cross-device all-reduce argmax, and vmapped scenario batches.
"""

from relp_tpu.config import SolverConfig, default_config
from relp_tpu.io import import_file
from relp_tpu.simplex import solve_relaxation, OptimizationResult
from relp_tpu.data.solution import Solution

__version__ = "0.1.0"

__all__ = [
    "SolverConfig",
    "default_config",
    "import_file",
    "solve_relaxation",
    "OptimizationResult",
    "Solution",
]
