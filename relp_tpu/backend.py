"""What the solver assumes about the machine it runs on, in one table.

Every hardware-dependent decision (matmul noise guards, the escalation
ladder's order, host-sparse routing) reads :func:`backend_facts`.  The table
is keyed by ``jax.default_backend()`` and holds only platforms whose facts
were measured; any other platform is refused rather than given guesses.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class BackendFacts:
    # f64 arithmetic runs at hardware rate, so the escalation ladder goes
    # straight from f32 to f64; the double-float (df32) carry stays a rung a
    # user can pick but is not inserted before f64.
    f64_native: bool
    # Max relative error of default-precision f32 matmul products (the wide
    # pricing / Goldfarb scans), with margin; 0.0 means true IEEE f32.  A
    # positive value turns on the noisy-scan guards in the simplex kernels
    # (noise-scaled eligibility floor, pick recheck, clean-chunk-entry
    # arbiter for OPTIMAL).
    scan_noise_eps: float
    # backend="auto" may send huge, nearly empty LPs to the host sparse
    # solver (simplex/host_sparse.py) instead of the dense device path.
    host_sparse_auto: bool


_FACTS = {
    "cpu": BackendFacts(f64_native=True, scan_noise_eps=0.0, host_sparse_auto=True),
    # NVIDIA H100: native f64 units; default-precision f32 matmuls run in
    # TF32 (10-bit mantissa).  Measured max error / max|result| of those
    # products: 3.2e-4 (chip_smoke.py precision phase: stacked (3,M)@(M,N)
    # and (M,)@(M,N) at M=20352, N=50816); 1e-3 is that with a 3x margin.
    "gpu": BackendFacts(f64_native=True, scan_noise_eps=1e-3, host_sparse_auto=False),
}


class UnsupportedBackendError(RuntimeError):
    """The JAX backend has no entry in the backend-facts table."""


def backend_facts(platform: Optional[str] = None) -> BackendFacts:
    """Facts for ``platform`` (default: ``jax.default_backend()``)."""
    if platform is None:
        import jax

        platform = jax.default_backend()
    try:
        return _FACTS[platform]
    except KeyError:
        raise UnsupportedBackendError(
            f"no backend facts for platform {platform!r} "
            f"(known: {sorted(_FACTS)})"
        ) from None
