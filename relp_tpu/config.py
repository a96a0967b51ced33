"""Solver configuration.

The reference configures everything at compile time through generics (number
type x basis inverse x provider x pivot rule, reference: src/lib.rs:7-11) and
hard-codes two tunables (refactorization threshold 30,
lower_upper/mod.rs:249-252; presolve no-progress budget,
general_form/mod.rs:391-400).  Here those become a real runtime config.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional


def _enable_x64() -> None:
    """Enable 64-bit floats in JAX (needed for numerically robust simplex)."""
    import jax

    jax.config.update("jax_enable_x64", True)


@dataclasses.dataclass
class SolverConfig:
    """Runtime configuration of the simplex engine.

    Tolerances follow standard floating-point simplex practice; the reference
    needs none of them (exact rationals), so these are new design surface.
    """

    # Working dtype on device.  "float32" is the fast path (half the bytes
    # of f64 on every memory-bound scan and update); correctness is
    # guaranteed by the exact rational certification pass, with automatic
    # escalation to "float64" when an f32 solve cannot be certified.
    dtype: str = "float32"

    # dtype of the tableau copy used for the full-width pricing /
    # steepest-edge scans ("float32" | "bfloat16" | "same").  The scans are
    # memory-bound; under an f64 carry an f32 copy halves their traffic.
    # The driver polishes with full-precision chunks at phase end, and the
    # exact certifier backstops correctness.
    scan_dtype: str = "float32"

    # Carry representation: "native" (the working dtype) or "df32"
    # (double-float: B^-1/x_B/pi as hi+lo f32 pairs updated with compensated
    # EFT arithmetic — ~2^-48 accuracy at native-f32 speed; the middle rung
    # of the escalation ladder on backends without native f64, see
    # relp_tpu.backend).
    # Requires dtype="float32" and basis_inverse="dense".
    carry: str = "native"

    # Pricing rule: "dantzig" | "steepest" | "first" | "first_memory"
    # (reference: strategy/pivot_rule.rs: SteepestDescentAlongVariable,
    # SteepestDescentAlongObjective, FirstProfitable, FirstProfitableWithMemory).
    pricing: str = "steepest"

    # Optimality tolerance on reduced costs.
    opt_tol: float = 1e-9
    # Pivot-element tolerance in the ratio test.
    pivot_tol: float = 1e-9
    # Feasibility tolerance on basic values.
    feas_tol: float = 1e-9
    # Phase-1 objective considered zero below this.
    phase1_tol: float = 1e-8
    # Treat |x| below this as zero when reading solutions off the device.
    zero_tol: float = 1e-11

    # Refactorize the basis inverse every this many pivots
    # (reference hard-codes 30, lower_upper/mod.rs:251).
    refactor_period: int = 60

    # How many simplex iterations to run per jitted device chunk before the
    # host checks status.  Must be <= refactor_period unless device_refactor
    # handles the cadence inside the chunk.
    chunk_size: int = 60

    # Scenario-batch driver only: run the refactorization cadence *inside*
    # the jitted chunk (vmapped Newton-Schulz refresh every refactor_period
    # loop steps, batch.py batched_run_chunk) so one dispatch can carry
    # several refactor periods of pivots.  With this on, chunk_size may
    # exceed refactor_period and the host round-trip count drops
    # proportionally.
    device_refactor: bool = False

    # Iteration budget (0 = no limit beyond a very large default).
    max_iterations: int = 200_000

    # Fall back to Bland's rule after this many consecutive degenerate pivots
    # (anti-cycling; reference relies on exact Bland tie-breaks,
    # tableau/mod.rs:294-309).
    bland_threshold: int = 300

    # Pad device array dimensions up to a multiple of this (shape bucketing:
    # nearby problem sizes share one compiled executable).
    pad_to: int = 128

    # Basis-inverse backend: "dense" (explicit inverse, product-form rank-1
    # updates — the fast fused device path) or "lu" (LU factors + eta ring —
    # the robustness/cross-check backend; reference analog:
    # BasisInverseRows vs LUDecomposition).
    basis_inverse: str = "dense"

    # Steepest-edge weight refresh cadence at chunk exits (1 = refresh at
    # every exit).  The in-kernel Goldfarb update keeps gamma approximately
    # current within a chunk; the full (M,M)@(M,N) refresh matmul dominates
    # chunk-exit cost at m >= ~4k buckets, so big-bucket routes raise this.
    # Stale weights only degrade pivot CHOICE, never correctness (the
    # polish/certification layers absorb pricing noise — see CLAUDE.md).
    gamma_refresh_period: int = 1

    # Execution backend: "device" (dense jitted tableau on the accelerator),
    # "host_sparse" (scipy sparse revised simplex on the host — the CPU
    # fallback for huge, very sparse instances, closest to the reference's
    # own execution model), or "auto" (host_sparse only when on the CPU
    # backend AND the dense lowering would be huge and nearly empty; see
    # host_sparse.should_use_host_sparse and relp_tpu.backend).
    backend: str = "auto"

    # Feasibility strategy: "two_phase" (the reference's phase 1 / phase 2
    # split, phase_one.rs) or "bigm" (single composite walk on
    # c2 + M * c1; host_sparse backend only).  Big-M lets the REAL cost
    # gradients break pricing ties from the first pivot, which escapes the
    # massively degenerate pure-phase-1 plateaus of assignment-structured
    # LPs (QAP12/QAP15: flat 200k-pivot walks at phase-1 objective 24.0).
    # Correctness is unaffected: the basis it lands on goes through the
    # same exact certification as any other, and a composite optimum with
    # nonzero artificials falls back to the classic phase 1.
    phase1: str = "two_phase"

    # Run the exact rational certification pass after solving.
    certify: bool = True
    # If certification finds exact negative reduced costs, run exact cleanup
    # pivots host-side until exactly optimal.
    exact_cleanup: bool = True
    # Maximum number of exact cleanup pivots before giving up.
    exact_cleanup_budget: int = 2_000
    # Wall-clock budget for the exact cleanup walk.  One exact
    # Sherman-Morrison pivot is O(m^2) big-rational operations — tens of
    # seconds at m ~ 1500 — so the pivot budget alone admits multi-hour
    # walks when a noisy device basis lands far from the exact optimum
    # (netlib CYCLE under noisy default-precision scans).  Exhaustion fails
    # certification, which sends the driver up the escalation ladder for a
    # cleaner basis instead of grinding exact pivots.
    exact_cleanup_time_s: float = 600.0

    # Presolve on/off (reference: general_form/mod.rs:351-375).
    presolve: bool = True
    # Prescale on/off (reference: presolve/scale; opt-in there too).
    prescale: bool = False

    # Device platform override (None = let JAX choose).
    platform: Optional[str] = None

    # Dual-simplex warm restart: when a warm-start basis is dual feasible
    # but primal infeasible (the rhs changed since the basis was optimal —
    # the scenario-resolve case), restore primal feasibility with dual
    # pivots instead of falling back to a cold phase-1 start.  Beyond
    # reference scope (its warm start, carry/mod.rs:444-478, requires
    # primal feasibility).  Dense engine only; others ignore the flag.
    dual_restart: bool = True

    # Runtime BFS invariant checking at refactorization boundaries
    # (reference: debug_assert_in_basic_feasible_solution_state,
    # tableau/mod.rs:319-357, which runs per iteration in debug builds).
    debug_validate: bool = False

    def __post_init__(self) -> None:
        if self.dtype not in ("float32", "float64"):
            raise ValueError(f"unsupported dtype {self.dtype!r}")
        if self.scan_dtype not in ("float32", "bfloat16", "same"):
            raise ValueError(f"unsupported scan_dtype {self.scan_dtype!r}")
        if self.basis_inverse not in ("dense", "lu"):
            raise ValueError(f"unsupported basis_inverse {self.basis_inverse!r}")
        if self.carry not in ("native", "df32"):
            raise ValueError(f"unsupported carry {self.carry!r}")
        if self.carry == "df32" and (
            self.dtype != "float32" or self.basis_inverse != "dense"
        ):
            raise ValueError(
                "carry='df32' requires dtype='float32' and "
                "basis_inverse='dense'"
            )
        if self.backend not in ("auto", "device", "host_sparse"):
            raise ValueError(f"unsupported backend {self.backend!r}")
        if self.phase1 not in ("two_phase", "bigm"):
            raise ValueError(f"unsupported phase1 {self.phase1!r}")
        # Remember the pre-clamp tolerances: dataclasses.replace() rebuilds
        # from the (possibly f32-clamped) field values, so dtype escalation
        # in the driver must restore these to get genuine f64 tolerances.
        self.requested_tolerances = {
            "opt_tol": self.opt_tol,
            "pivot_tol": self.pivot_tol,
            "feas_tol": self.feas_tol,
            "phase1_tol": self.phase1_tol,
        }
        if self.dtype == "float32" and self.carry == "df32":
            # Double-float carry: values are accurate to ~2^-48, and f32
            # comparisons have *relative* resolution, so near-zero
            # thresholds are meaningful at f64-grade levels.
            self.opt_tol = max(self.opt_tol, 1e-9)
            self.pivot_tol = max(self.pivot_tol, 1e-8)
            self.feas_tol = max(self.feas_tol, 1e-9)
            self.phase1_tol = max(self.phase1_tol, 1e-8)
        elif self.dtype == "float32":
            # f32 working precision: tolerances below f32 resolution are
            # noise; the exact certifier (and the f64 escalation in the
            # driver) backstop correctness.
            self.opt_tol = max(self.opt_tol, 1e-5)
            self.pivot_tol = max(self.pivot_tol, 1e-5)
            self.feas_tol = max(self.feas_tol, 1e-5)
            self.phase1_tol = max(self.phase1_tol, 1e-4)
        if self.pricing not in ("dantzig", "steepest", "first", "first_memory"):
            raise ValueError(f"unsupported pricing rule {self.pricing!r}")
        # 64-bit mode: the f32 path's carry-health check runs f64 device
        # matvecs (kernels.carry_health), and the escalation ladder's f64
        # rungs need it; without it every rejected refresh falls back to a
        # host LAPACK inverse.
        _enable_x64()
        if self.chunk_size > self.refactor_period and not self.device_refactor:
            self.chunk_size = self.refactor_period


_DEFAULT: Optional[SolverConfig] = None


def default_config() -> SolverConfig:
    """The process-wide default configuration."""
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = SolverConfig(
            dtype=os.environ.get("RELP_TPU_DTYPE", "float32"),
        )
    return _DEFAULT
