"""Device-resident simplex state.

The device analog of the reference's ``Carry`` inverse maintainer
(carry/mod.rs:46-66): basis inverse, basic solution b-bar, duals pi, objective
and basis bookkeeping — all static-shape arrays forming one jittable pytree.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

# Status codes (int32 on device).
RUNNING = 0
OPTIMAL = 1
UNBOUNDED = 2
SINGULAR = 3  # refactorization failed / numerical breakdown
INFEASIBLE = 4  # dual simplex: a negative basic value with no eligible
#                 entering column (primal infeasible; the driver re-proves
#                 this through the exact phase-1 Farkas path)


class SimplexState(NamedTuple):
    """One LP's solver state.

    Shapes: M = padded row count, N = padded column count (real + artificial).
    """

    Binv: jnp.ndarray  # (M, M) basis inverse
    basis: jnp.ndarray  # (M,) int32: column occupying each row
    xB: jnp.ndarray  # (M,) basic solution values (b-bar)
    pi: jnp.ndarray  # (M,) simplex multipliers (duals for current costs)
    obj: jnp.ndarray  # () objective value c_B . xB
    in_basis: jnp.ndarray  # (N,) bool
    gamma: jnp.ndarray  # (N,) steepest-edge reference weights
    iteration: jnp.ndarray  # () int32 — total pivots taken
    status: jnp.ndarray  # () int32
    degen_count: jnp.ndarray  # () int32 — consecutive degenerate pivots
    inner: jnp.ndarray  # () int32 — iterations taken in the current chunk
    price_start: jnp.ndarray  # () int32 — round-robin pricing resume point
    d: jnp.ndarray  # (N,) reduced costs in scan precision (for current pi/c)
