"""Double-float (two-f32) compensated arithmetic.

On a device without native f64, f64 is emulated and the escalation
ladder's f64 retry is expensive.  This module provides "double-float"
arithmetic — each value is an unevaluated sum ``hi + lo`` of two f32s,
giving ~2^-48 relative accuracy (f64-grade for simplex-carry purposes) with
*native f32 ops*.

Built on error-free transformations (EFT):

* ``two_sum`` (Knuth) — exact: ``a + b == s + err`` in real arithmetic;
* ``two_prod`` (Dekker split, no FMA required) — exact for f32 inputs:
  products of 12-bit halves are exactly representable in a 24-bit mantissa.

Both survive XLA compilation bit-exactly on the CPU and on an NVIDIA H100
(no unsafe FP reassociation, and no FMA contraction that breaks the split):
tests/test_df32.py::test_eft_exactness_under_jit checks the CPU, and the
"df32 EFT" phase of chip_smoke.py the card.

The simplex carry (the state the reference maintains exactly in rationals —
B^-1, x_B, pi; carry/mod.rs:46-66) drifts under f32 rank-1 updates *and*
f32 matvec accumulation; both are replaced here by compensated equivalents.
The one op double-float cannot speed up is dense refactorization (a df
Newton-Schulz step would need O(m^3) compensated accumulation); the df32
engine refactorizes on the host in f64 instead and splits the result.

Conventions: a df value is a pair of equal-shape f32 arrays ``(hi, lo)``
with ``|lo| <= ulp(hi)/2``; all functions take and return such pairs as
separate arguments (pytree-friendly, no wrapper class in the hot path).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

# 2^12 + 1: Dekker split constant for f32 (24-bit mantissa -> 12-bit halves).
_SPLIT = np.float32(4097.0)


def two_sum(a, b):
    """Knuth's exact addition: returns (s, err) with a + b == s + err."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def fast_two_sum(a, b):
    """Dekker's exact addition, valid when |a| >= |b| (or a == 0)."""
    s = a + b
    return s, b - (s - a)


def _split(a):
    t = _SPLIT * a
    hi = t - (t - a)
    return hi, a - hi


def two_prod(a, b):
    """Dekker's exact product: returns (p, err) with a * b == p + err."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, err


def df_add(xh, xl, yh, yl):
    """df + df -> df (Dekker add2; relative error ~2^-47)."""
    s, e = two_sum(xh, yh)
    e = e + (xl + yl)
    return fast_two_sum(s, e)


def df_neg(xh, xl):
    return -xh, -xl


def df_sub(xh, xl, yh, yl):
    return df_add(xh, xl, -yh, -yl)


def df_mul_f(xh, xl, y):
    """df * f32 -> df."""
    p, e = two_prod(xh, y)
    e = e + xl * y
    return fast_two_sum(p, e)


def df_mul(xh, xl, yh, yl):
    """df * df -> df (drops the lo*lo term: ~2^-47)."""
    p, e = two_prod(xh, yh)
    e = e + (xh * yl + xl * yh)
    return fast_two_sum(p, e)


def df_div(xh, xl, yh, yl):
    """df / df -> df via one Newton correction of the f32 quotient."""
    q1 = xh / yh
    # r = x - y*q1, computed in df.
    ph, pl = df_mul_f(yh, yl, q1)
    rh, rl = df_sub(xh, xl, ph, pl)
    q2 = (rh + rl) / yh
    return fast_two_sum(q1, q2)


def df_from_f64(x):
    """Split a host f64 array into a df pair (hi, lo) of f32 device arrays."""
    x = np.asarray(x, dtype=np.float64)
    hi = x.astype(np.float32)
    lo = (x - hi.astype(np.float64)).astype(np.float32)
    return jnp.asarray(hi), jnp.asarray(lo)


def df_to_f64(hi, lo):
    """Collapse a df pair to host f64."""
    return np.asarray(hi, dtype=np.float64) + np.asarray(lo, dtype=np.float64)


def df_reduce_sum(h, l, axis: int):
    """Compensated sum along ``axis`` via pairwise df folding.

    log2(n) vectorized df_add levels; error ~2^-47 * log2(n), vs the f32
    matmul's ~sqrt(n) * 2^-24 random-walk accumulation error.
    """
    h = jnp.moveaxis(h, axis, -1)
    l = jnp.moveaxis(l, axis, -1)
    n = h.shape[-1]
    while n > 1:
        k = (n + 1) // 2
        if n % 2:
            pad = [(0, 0)] * (h.ndim - 1) + [(0, 1)]
            h = jnp.pad(h, pad)
            l = jnp.pad(l, pad)
        h, l = df_add(h[..., :k], l[..., :k], h[..., k:], l[..., k:])
        n = k
    return h[..., 0], l[..., 0]


def df_matvec(Mh, Ml, vh, vl):
    """(df matrix) @ (df vector) -> df vector, fully compensated.

    Products are exact (two_prod) with first-order cross terms; the j-sum is
    the pairwise df reduction.  All native f32 — this is the FTRAN
    ``w = B^-1 a_q`` that f32 accumulation gets wrong on ill-conditioned
    bases (the CYCLE/GROW7 failure mode).
    """
    ph, pl = two_prod(Mh, vh[None, :])
    pl = pl + (Mh * vl[None, :] + Ml * vh[None, :])
    return df_reduce_sum(ph, pl, axis=-1)


def df_vecmat(vh, vl, Mh, Ml):
    """(df vector) @ (df matrix) -> df vector (compensated BTRAN-style)."""
    ph, pl = two_prod(Mh, vh[:, None])
    pl = pl + (Mh * vl[:, None] + Ml * vh[:, None])
    return df_reduce_sum(ph, pl, axis=0)


def df_dot(xh, xl, yh, yl):
    """Compensated dot product of two df vectors -> df scalar."""
    ph, pl = two_prod(xh, yh)
    pl = pl + (xh * yl + xl * yh)
    return df_reduce_sum(ph, pl, axis=-1)


def df_axpy(ah, al, xh, xl, yh, yl):
    """y - a*x elementwise on df operands (the rank-1 update primitive)."""
    ph, pl = df_mul(ah, al, xh, xl)
    return df_sub(yh, yl, ph, pl)
