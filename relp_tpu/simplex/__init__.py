"""The device simplex engine.

Re-architecture of the reference's ``src/algorithm/two_phase`` for a JAX
accelerator:

* All solver state (basis inverse, b-bar, pi, basis indices, steepest-edge
  weights) lives in static-shape device arrays — the reference's ``Carry``
  (inverse_maintenance/carry/mod.rs:46-66) becomes the
  :class:`~relp_tpu.simplex.state.SimplexState` pytree.
* One simplex iteration (pricing scan -> FTRAN -> ratio test -> product-form
  update, reference call stack SURVEY.md section 3.3) is a fused jitted step;
  iterations run in chunks inside ``lax.while_loop`` to amortize dispatch.
* Refactorization (reference: LU refactor after 30 eta updates) is an
  f32 device inverse refined by Newton-Schulz iterations (dense matmuls).
* Phase 1 / phase 2 (reference: phase_one.rs / phase_two.rs) share the same
  kernel with different cost vectors; artificials are physical identity
  columns appended to the tableau.
"""

from relp_tpu.simplex.result import OptimizationResult, SolveStatus
from relp_tpu.simplex.driver import solve_relaxation, solve_general_form

__all__ = [
    "OptimizationResult",
    "SolveStatus",
    "solve_relaxation",
    "solve_general_form",
]
