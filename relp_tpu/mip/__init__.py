"""Exact mixed-integer programming via batched branch & bound.

Beyond reference scope: vandenheuvel/relp's README roadmap lists branch &
bound (and Gomory cuts) as unimplemented (reference README.md:60-70);
its miplib tests solve root relaxations only (tests/miplib/mod.rs:48-72).
"""

from relp_tpu.mip.branch_bound import MipResult, solve_mip

__all__ = ["MipResult", "solve_mip"]
