"""Exact rational linear solves via Dixon p-adic lifting.

Solves ``B x = b`` exactly for sparse rational B:

1. clear denominators by row scaling (solution-invariant) to get an
   integer system,
2. invert the matrix mod a word-size prime with vectorized numpy
   Gauss-Jordan elimination,
3. lift a p-adic expansion of the solution digit by digit (each digit is one
   mod-p matvec + one exact sparse integer matvec),
4. rationally reconstruct the entries, sharing the discovered common
   denominator across entries,
5. verify ``B x = b`` exactly (guards the lifting-bound estimate).

This replaces the reference's relp-num arbitrary-precision arithmetic for the
certification path; asymptotically it is O(m^3) word ops + O(m * bits^2)
reconstruction, far faster than fraction Gaussian elimination.
"""

from __future__ import annotations

import math
from fractions import Fraction
from typing import List, Optional, Sequence, Tuple

import numpy as np

Entry = Tuple[int, Fraction]

_PRIMES = [1_000_003, 999_983, 1_000_033, 999_979, 1_000_037]


class ExactSingularError(Exception):
    """The matrix is singular (exactly)."""


_MODP_LIB = None
_MODP_CHECKED = False


def _load_modp():
    """Native mod-p kernels (native/modp.cpp), built at first use."""
    global _MODP_LIB, _MODP_CHECKED
    if _MODP_CHECKED:
        return _MODP_LIB
    _MODP_CHECKED = True
    import ctypes

    from relp_tpu.utils.native_build import native_library

    path = native_library("libmodp.so")
    if path is not None:
        lib = ctypes.CDLL(path)
        lib.modp_invert.restype = ctypes.c_int32
        lib.modp_invert.argtypes = [
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64,
            ctypes.c_int64,
        ]
        _MODP_LIB = lib
    return _MODP_LIB


def _modinv_matrix(A_mod: np.ndarray, p: int) -> Optional[np.ndarray]:
    """Inverse of A mod p; native C++ Gauss-Jordan when available."""
    import ctypes

    lib = _load_modp()
    m = A_mod.shape[0]
    if lib is not None and m > 0:
        a = np.ascontiguousarray(A_mod % p, dtype=np.int64)
        out = np.zeros((m, m), dtype=np.int64)
        status = lib.modp_invert(
            a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            m,
            p,
        )
        return out if status == 0 else None
    return _modinv_matrix_numpy(A_mod, p)


def _modinv_matrix_numpy(A_mod: np.ndarray, p: int) -> Optional[np.ndarray]:
    """Pure-numpy fallback: Gauss-Jordan with outer-product updates."""
    m = A_mod.shape[0]
    M = A_mod % p
    inv = np.eye(m, dtype=np.int64)
    for k in range(m):
        col = M[k:, k] % p
        nz = np.nonzero(col)[0]
        if nz.size == 0:
            return None
        pivot_row = k + int(nz[0])
        if pivot_row != k:
            M[[k, pivot_row]] = M[[pivot_row, k]]
            inv[[k, pivot_row]] = inv[[pivot_row, k]]
        piv_inv = pow(int(M[k, k]), p - 2, p)
        M[k] = (M[k] * piv_inv) % p
        inv[k] = (inv[k] * piv_inv) % p
        factors = M[:, k].copy()
        factors[k] = 0
        # Rank-1 elimination update; entries stay below p^2 * 1 before the mod.
        M -= np.outer(factors, M[k])
        inv -= np.outer(factors, inv[k])
        M %= p
        inv %= p
    return inv


def _clear_denominators(
    columns: Sequence[Sequence[Entry]], b: Sequence[Fraction]
) -> Tuple[List[List[Tuple[int, int]]], List[int]]:
    """Integerize by *row* scaling: (D B) x = (D b) has the same solution x.

    Per-row lcm keeps integer sizes local — a single global lcm over all of
    b can be astronomically large when presolve has produced fractions with
    unrelated denominators.
    """
    m = len(b)
    row_lcm = [v.denominator for v in b]
    for col in columns:
        for i, v in col:
            d = v.denominator
            row_lcm[i] = row_lcm[i] * d // math.gcd(row_lcm[i], d)
    int_columns: List[List[Tuple[int, int]]] = [
        [(i, int(v * row_lcm[i])) for i, v in col] for col in columns
    ]
    int_b = [int(v * row_lcm[i]) for i, v in enumerate(b)]
    return int_columns, int_b


def _log2_int(n: int) -> float:
    n = abs(n)
    return float(n.bit_length()) if n > 1 else 0.0


def _lift_bound(int_columns: List[List[Tuple[int, int]]], int_b: List[int], p: int) -> int:
    """Number of p-adic digits needed: p^K > 2 * numerator_bound * den_bound.

    Hadamard: |det| <= prod_j ||col_j||_2; Cramer numerators similarly with b
    substituted.  Works in base-2 logs via bit lengths (entries can exceed
    float range).
    """
    log2_h = 0.0
    for col in int_columns:
        # log2 ||col||_2 <= log2(sqrt(nnz) * max|entry|)
        if not col:
            continue
        max_log = max(_log2_int(v) for _, v in col)
        log2_h += max_log + 0.5 * math.log2(max(len(col), 1))
    log2_b = max((_log2_int(v) for v in int_b), default=0.0) + 0.5 * math.log2(
        max(len(int_b), 1)
    )
    log2_num = log2_h + max(log2_b, 0.0)
    # The reconstruction uses the *symmetric* bound sqrt(p^K / 2) for both
    # numerator and denominator, so p^K must exceed 2*max(num, den)^2 —
    # not just 2*num*den (numerators dominate when the rhs is large).
    log2_total = 2.0 * max(log2_num, log2_h) + 1.0
    log2_p = math.log2(p)
    return max(2, int(math.ceil(log2_total / log2_p)) + 2)


def _rational_reconstruct(a: int, modulus: int, bound: int) -> Optional[Fraction]:
    """Find n/d with n ≡ a·d (mod modulus), |n| <= bound, 0 < d <= modulus//(2*bound)."""
    r0, r1 = modulus, a % modulus
    t0, t1 = 0, 1
    while r1 > bound:
        q = r0 // r1
        r0, r1 = r1, r0 - q * r1
        t0, t1 = t1, t0 - q * t1
    if t1 == 0:
        return None
    if t1 < 0:
        r1, t1 = -r1, -t1
    if math.gcd(r1 if r1 >= 0 else -r1, t1) != 1:
        # Not guaranteed unique; verification will catch failures.
        pass
    return Fraction(r1, t1)


def _peel_order(
    columns: Sequence[Sequence[Entry]],
) -> Tuple[List[Tuple[int, int]], List[List[Entry]]]:
    """Structural column-singleton peel of a basis matrix.

    A basic column with a single (structurally) nonzero row can be solved
    *last*: remove its row and column and recurse.  LP bases are dominated
    by slack / bound-slack identity-like columns, so this typically shrinks
    the dense Dixon core by 3-10x — certification cost is O(core^3), not
    O(m^3) (80BAU3B: m = 4984 -> core ~ hundreds).

    Returns (peels, rows): ``peels`` is the list of (column, row) pairs in
    peel order; ``rows`` the row-major structure used for back-substitution.
    """
    m = len(columns)
    rows: List[List[Entry]] = [[] for _ in range(m)]
    for j, col in enumerate(columns):
        for i, v in col:
            rows[i].append((j, v))

    col_nnz = [len(col) for col in columns]
    row_active = [True] * m
    col_active = [True] * m
    stack = [j for j in range(m) if col_nnz[j] == 1]
    peels: List[Tuple[int, int]] = []
    while stack:
        j = stack.pop()
        if not col_active[j] or col_nnz[j] != 1:
            continue
        i = next(
            (i for i, _ in columns[j] if row_active[i]),
            None,
        )
        if i is None:
            continue  # structurally singular; the core inversion will fail
        peels.append((j, i))
        col_active[j] = False
        row_active[i] = False
        for k, _ in rows[i]:
            if col_active[k]:
                col_nnz[k] -= 1
                if col_nnz[k] == 1:
                    stack.append(k)
    return peels, rows


def _btf_order(
    columns: Sequence[Sequence[Entry]],
) -> Optional[List[Tuple[List[int], List[int]]]]:
    """Block-triangular (Dulmage–Mendelsohn) ordering of a structurally
    nonsingular square sparse matrix.

    A maximum bipartite matching permutes rows so the diagonal is
    structurally nonzero; the strongly connected components of the column
    digraph (edge j -> i per off-diagonal nonzero of the permuted matrix)
    are the diagonal blocks of a block-triangular permutation PAQ, and their
    condensation's topological order is the forward-substitution solve
    order.  Column singletons (the old peel) come out as 1x1 blocks, so
    this strictly generalizes :func:`_peel_order`; on bases like DFL001's
    (12k rows) it shrinks the dense Dixon core from O(m^3) to the largest
    irreducible bump.

    Returns blocks as (columns, matched rows) in solve order, or ``None``
    when scipy is unavailable, the matrix is structurally singular (the
    dense path reports that), or there is only one block.
    """
    m = len(columns)
    if m < 3:
        return None
    try:
        from scipy import sparse as sp
        from scipy.sparse import csgraph
    except Exception:  # noqa: BLE001 — scipy is optional here
        return None

    indptr = [0]
    idx: List[int] = []
    for col in columns:
        idx.extend(i for i, v in col if v)
        indptr.append(len(idx))
    A = sp.csc_matrix(
        (
            np.ones(len(idx), dtype=np.int8),
            np.asarray(idx, dtype=np.int32),
            np.asarray(indptr, dtype=np.int32),
        ),
        shape=(m, m),
    )
    row_perm = csgraph.maximum_bipartite_matching(A, perm_type="row")
    if (row_perm < 0).any():
        return None
    B = A[row_perm, :]  # structurally nonzero diagonal
    n_comp, labels = csgraph.connected_components(
        B, directed=True, connection="strong"
    )
    if n_comp <= 1:
        return None

    # Condensation DAG: edge label[j] -> label[i] per off-diagonal nonzero
    # B[i, j] ("column j's block must be solved before equation i's block").
    Bc = B.tocoo()
    li = labels[Bc.row]
    lj = labels[Bc.col]
    cross = li != lj
    edges = set(zip(lj[cross].tolist(), li[cross].tolist()))
    indeg = [0] * n_comp
    adj: List[List[int]] = [[] for _ in range(n_comp)]
    for u, v in edges:
        adj[u].append(v)
        indeg[v] += 1
    from collections import deque

    queue = deque(c for c in range(n_comp) if indeg[c] == 0)
    order: List[int] = []
    while queue:
        u = queue.popleft()
        order.append(u)
        for v in adj[u]:
            indeg[v] -= 1
            if indeg[v] == 0:
                queue.append(v)
    assert len(order) == n_comp  # the condensation is acyclic

    cols_of: List[List[int]] = [[] for _ in range(n_comp)]
    for j in range(m):
        cols_of[labels[j]].append(j)
    return [
        (cols_of[c], [int(row_perm[j]) for j in cols_of[c]]) for c in order
    ]


class ExactSolver:
    """Cached exact solver for one basis matrix.

    Clears denominators and computes the mod-p inverse once; every
    subsequent :meth:`solve` is just lifting + reconstruction — the repeated
    solves of certification and cleanup ratio tests share the O(m^3) work.

    ``peel`` controls structural column-singleton peeling (see
    :func:`_peel_order`): ``None`` (default) peels when it shrinks the core
    by >= 25%, ``True`` always, ``False`` never.  Peeled solvers answer
    :meth:`solve` through a dense core + exact back-substitution;
    :meth:`replace_column` requires an unpeeled solver (callers rebuild).
    """

    def __init__(self, columns: Sequence[Sequence[Entry]], peel=None):
        self.m = len(columns)
        self.columns = columns
        self._transposed_memo: Optional["ExactSolver"] = None
        self.btf_blocks: Optional[list] = None

        if peel is not False and self.m > 0:
            blocks = _btf_order(columns)
            if blocks is not None:
                max_block = max(len(c) for c, _ in blocks)
                # Same spirit as the old >=25% peel rule: block-triangular
                # structure must shrink the dense core meaningfully, else
                # keep the flat inverse (which supports O(m^2) updates).
                if peel is True or max_block <= (3 * self.m) // 4:
                    self._build_btf(blocks)
                    return

        peels: List[Tuple[int, int]] = []
        rows: List[List[Entry]] = []
        if peel is not False and self.m > 0:
            peels, rows = _peel_order(columns)
            if peel is None and len(peels) < self.m // 4:
                peels = []
        self.peels = peels
        if peels:
            self._rows = rows
            peeled_rows = {i for _, i in peels}
            peeled_cols = {j for j, _ in peels}
            self.core_rows = [i for i in range(self.m) if i not in peeled_rows]
            self.core_cols = [j for j in range(self.m) if j not in peeled_cols]
            row_map = {i: k for k, i in enumerate(self.core_rows)}
            core_columns = [
                [(row_map[i], v) for i, v in columns[j] if i in row_map]
                for j in self.core_cols
            ]
            self._core = ExactSolver(core_columns, peel=False)
            return

        self.row_lcm = _row_lcms(columns)
        self.int_columns = [
            [(i, int(v * self.row_lcm[i])) for i, v in col] for col in columns
        ]
        for p in _PRIMES:
            A_mod = np.zeros((self.m, self.m), dtype=np.int64)
            for j, col in enumerate(self.int_columns):
                for i, v in col:
                    A_mod[i, j] = v % p
            inv_p = _modinv_matrix(A_mod, p)
            if inv_p is not None:
                break
        else:
            raise ExactSingularError("matrix singular modulo several primes")
        self.p = p
        self.inv_p = inv_p

    def _build_btf(self, blocks: List[Tuple[List[int], List[int]]]) -> None:
        """Construct per-block sub-solvers for a block-triangular ordering.

        Each block is ``("one", col, row, pivot)`` for 1x1 blocks (direct
        exact division) or ``("core", cols, rows, ExactSolver)``; the
        expensive mod-p inversions cost sum(block^3) instead of m^3.
        """
        self.peels = []
        built = []
        for cols, rows_b in blocks:
            if len(cols) == 1:
                j, r = cols[0], rows_b[0]
                pivot = next(v for i, v in self.columns[j] if i == r and v)
                built.append(("one", j, r, pivot))
                continue
            local = {r: k for k, r in enumerate(rows_b)}
            sub_columns = [
                [(local[i], v) for i, v in self.columns[j] if i in local and v]
                for j in cols
            ]
            built.append(
                ("core", cols, rows_b, ExactSolver(sub_columns, peel=False))
            )
        self.btf_blocks = built

    def _solve_btf(self, b: Sequence[Fraction]) -> List[Fraction]:
        """Block forward substitution: every block's equations reference only
        its own columns and columns of earlier blocks (topological order), so
        solving in order with rhs updates is exact."""
        x: List[Optional[Fraction]] = [None] * self.m
        s = list(b)
        for block in self.btf_blocks:
            if block[0] == "one":
                _, j, r, pivot = block
                xj = s[r] / pivot
                x[j] = xj
                if xj:
                    for i, v in self.columns[j]:
                        s[i] -= v * xj
                continue
            _, cols, rows_b, core = block
            sub_x = core.solve([s[r] for r in rows_b])
            for j, xj in zip(cols, sub_x):
                x[j] = xj
                if xj:
                    for i, v in self.columns[j]:
                        s[i] -= v * xj
        return x  # type: ignore[return-value]

    def transposed(self) -> "ExactSolver":
        """Solver for B^T, reusing this solver's mod-p inversion.

        With M = D_r B (this solver's integer matrix) and inv_p = M^-1 mod p:
        B^-1 = inv_p D_r, so (B^T)^-1 = D_r inv_p^T.  The transpose solver's
        integer matrix is N = D_c B^T (D_c = per-column denominator lcms of
        B), whose inverse mod p is D_r inv_p^T D_c^-1 — three diagonal
        scalings instead of a second O(m^3) Gauss-Jordan.

        A peeled solver instead builds (and memoizes) a full transposed
        solver, which peels B^T's own row-singleton structure — still
        O(core^3), not O(m^3).
        """
        m = self.m
        # Columns of B^T = rows of B, entries indexed by original column.
        t_columns: List[List[Entry]] = [[] for _ in range(m)]
        for j, col in enumerate(self.columns):
            for i, v in col:
                t_columns[i].append((j, v))

        if self.peels or self.btf_blocks:
            if self._transposed_memo is None:
                self._transposed_memo = ExactSolver(t_columns)
            return self._transposed_memo

        out = ExactSolver.__new__(ExactSolver)
        out.m = m
        out.columns = t_columns
        out.peels = []
        out.btf_blocks = None
        out._transposed_memo = None
        out.row_lcm = _row_lcms(t_columns)  # = D_c
        out.int_columns = [
            [(i, int(v * out.row_lcm[i])) for i, v in col] for col in t_columns
        ]
        p = self.p
        if any(l % p == 0 for l in self.row_lcm) or any(
            l % p == 0 for l in out.row_lcm
        ):
            # A denominator lcm divisible by p breaks the diagonal-scaling
            # shortcut; rebuild from scratch (rare).
            return ExactSolver(t_columns)
        d_r = np.fromiter(
            ((l % p) for l in self.row_lcm), dtype=np.int64, count=m
        )
        d_c_inv = np.fromiter(
            (pow(int(l % p), p - 2, p) for l in out.row_lcm),
            dtype=np.int64,
            count=m,
        )
        inv_t = (self.inv_p.T * d_r[:, None]) % p
        inv_t = (inv_t * d_c_inv[None, :]) % p
        out.p = p
        out.inv_p = inv_t
        return out

    def replace_column(self, r: int, new_col: Sequence[Entry]) -> "ExactSolver":
        """O(m^2) solver for the basis with column ``r`` replaced.

        Mod-p Sherman–Morrison (product-form) update of the cached inverse —
        the analog of the reference's BasisInverseRows::change_basis
        (basis_inverse_rows.rs:131-145) carried out in exact modular
        arithmetic, so the exact-cleanup loop costs O(m^2) per pivot instead
        of a fresh O(m^3) Gauss-Jordan.

        Raises :class:`ExactSingularError` when the update is impossible mod
        p (pivot divisible by p, or a denominator-lcm growth divisible by
        p), and on peeled solvers (no full-size inverse to update); callers
        rebuild from scratch then.
        """
        if self.peels or self.btf_blocks:
            raise ExactSingularError("peeled solver cannot update in place")
        p = self.p
        m = self.m

        # Row lcms may grow to clear the new column's denominators (they are
        # kept monotone: removing the old column never shrinks them — larger
        # integers, same solutions).
        new_lcm = list(self.row_lcm)
        for i, v in new_col:
            d = v.denominator
            new_lcm[i] = new_lcm[i] * d // math.gcd(new_lcm[i], d)

        inv_p = self.inv_p
        if new_lcm != self.row_lcm:
            # M' = F M with F = diag(growth): inv' = inv F^-1 (column scale).
            f_inv = np.ones(m, dtype=np.int64)
            growth = [1] * m
            for i in range(m):
                if new_lcm[i] != self.row_lcm[i]:
                    g = new_lcm[i] // self.row_lcm[i]
                    growth[i] = g
                    gm = g % p
                    if gm == 0:
                        raise ExactSingularError("lcm growth divisible by p")
                    f_inv[i] = pow(gm, p - 2, p)
            inv_p = (inv_p * f_inv[None, :]) % p
            int_columns = [
                [(i, v * growth[i]) for i, v in col] for col in self.int_columns
            ]
        else:
            int_columns = [list(col) for col in self.int_columns]

        new_int_col = [(i, int(v * new_lcm[i])) for i, v in new_col]
        col_vec = np.zeros(m, dtype=np.int64)
        for i, v in new_int_col:
            col_vec[i] = v % p
        w = (inv_p @ col_vec) % p  # M^-1 a_q mod p
        w_r = int(w[r])
        if w_r == 0:
            raise ExactSingularError("replacement pivot zero mod p")
        new_row_r = (inv_p[r] * pow(w_r, p - 2, p)) % p
        w_off = w.copy()
        w_off[r] = 0
        inv_new = (inv_p - np.outer(w_off, new_row_r)) % p
        inv_new[r] = new_row_r

        out = ExactSolver.__new__(ExactSolver)
        out.m = m
        columns = list(self.columns)
        columns[r] = list(new_col)
        out.columns = columns
        out.peels = []
        out.btf_blocks = None
        out._transposed_memo = None
        out.row_lcm = new_lcm
        int_columns[r] = new_int_col
        out.int_columns = int_columns
        out.p = p
        out.inv_p = inv_new
        return out

    def solve(self, b: Sequence[Fraction]) -> List[Fraction]:
        if self.btf_blocks:
            return self._solve_btf(b)
        if self.peels:
            return self._solve_peeled(b)
        # Row lcms were computed from the matrix alone; clear any remaining
        # rhs denominators with one global multiplier lam, solving
        # (D B) x' = (D b) * lam and returning x = x' / lam.
        scaled = [v * self.row_lcm[i] for i, v in enumerate(b)]
        lam = 1
        for v in scaled:
            d = v.denominator
            lam = lam * d // math.gcd(lam, d)
        int_b = [int(v * lam) for v in scaled]
        return _lift_and_reconstruct(
            self.columns,
            self.int_columns,
            int_b,
            b,
            self.p,
            self.inv_p,
            scale=lam,
        )

    def _solve_peeled(self, b: Sequence[Fraction]) -> List[Fraction]:
        """Core Dixon solve + exact back-substitution of the peeled pairs.

        A pair (j, i) was peeled while every *other* column with an entry in
        row i was still active, so processing the pairs in reverse peel
        order guarantees those columns' values are already known.
        """
        x: List[Optional[Fraction]] = [None] * self.m
        core_b = [b[i] for i in self.core_rows]
        core_x = self._core.solve(core_b)
        for j, v in zip(self.core_cols, core_x):
            x[j] = v
        for j, i in reversed(self.peels):
            s = b[i]
            pivot: Optional[Fraction] = None
            for k, v in self._rows[i]:
                if k == j:
                    pivot = v
                elif x[k] is not None:
                    if x[k]:
                        s -= v * x[k]
                else:
                    raise ExactSingularError(
                        "peel back-substitution hit an unresolved column"
                    )
            assert pivot is not None
            x[j] = s / pivot
        return x  # type: ignore[return-value]


def _row_lcms(columns: Sequence[Sequence[Entry]]) -> List[int]:
    m = len(columns)
    row_lcm = [1] * m
    for col in columns:
        for i, v in col:
            d = v.denominator
            row_lcm[i] = row_lcm[i] * d // math.gcd(row_lcm[i], d)
    return row_lcm


def exact_solve(
    columns: Sequence[Sequence[Entry]],
    b: Sequence[Fraction],
) -> List[Fraction]:
    """Solve B x = b exactly; B given as sparse exact columns.

    Raises :class:`ExactSingularError` if B is singular.
    """
    m = len(b)
    assert len(columns) == m
    int_columns, int_b = _clear_denominators(columns, b)

    # Dense mod-p copy.
    for p in _PRIMES:
        A_mod = np.zeros((m, m), dtype=np.int64)
        for j, col in enumerate(int_columns):
            for i, v in col:
                A_mod[i, j] = v % p
        inv_p = _modinv_matrix(A_mod, p)
        if inv_p is not None:
            break
    else:
        raise ExactSingularError("matrix singular modulo several primes")
    return _lift_and_reconstruct(columns, int_columns, int_b, b, p, inv_p)


def _reconstruct_digits(
    digits: List[np.ndarray], p: int, m: int, exact_early: bool
) -> Optional[List[Fraction]]:
    """Rational vector from p-adic digits, or None if reconstruction fails
    (only possible on a truncated — checkpoint — modulus)."""
    # Horner per entry.
    y_int: List[int] = []
    for i in range(m):
        acc = 0
        for d in reversed(digits):
            acc = acc * p + int(d[i])
        y_int.append(acc)

    if exact_early:
        return [Fraction(v) for v in y_int]
    modulus = p ** len(digits)
    half = modulus // 2
    bound = math.isqrt(half)
    den = 1
    y = [Fraction(0)] * m
    for i in range(m):
        y_mod_i = y_int[i] % modulus
        scaled = (y_mod_i * den) % modulus
        if scaled > half:
            scaled -= modulus
        # The shared-denominator fast path is only sound while
        # bound*den < half: scaled is already reduced into (-half, half],
        # so once den >= half/bound the acceptance test is vacuously true
        # and a wrong numerator could slip through (it would then fail
        # the exact verification and needlessly abort the solve).
        if bound * den < half and abs(scaled) <= bound * den:
            y[i] = Fraction(scaled, den)
        else:
            rec = _rational_reconstruct(y_mod_i, modulus, bound)
            if rec is None:
                return None
            y[i] = rec
            den = den * rec.denominator // math.gcd(den, rec.denominator)
    return y


def _verify_exact(columns, x: List[Fraction], b) -> bool:
    """Exact check of B x = b over the original rational columns."""
    residual: List[Fraction] = [-v for v in b]
    for j, col in enumerate(columns):
        if x[j]:
            for i, v in col:
                residual[i] += v * x[j]
    return not any(residual)


def _lift_and_reconstruct(
    columns, int_columns, int_b, b, p, inv_p, scale: int = 1
) -> List[Fraction]:
    m = len(int_b)
    K = _lift_bound(int_columns, int_b, p)
    # The Hadamard/Cramer bound K is astronomically pessimistic for the
    # structured bases LPs actually produce (DFL001: thousands of digits
    # bounded vs tens needed — the r3 certification blew its 1000 s budget
    # entirely inside this loop).  Lift adaptively instead: attempt
    # reconstruction at geometric checkpoints; B is nonsingular, so the
    # exact verification accepts only THE solution — a premature
    # reconstruction either fails or verifies wrong and we keep lifting.
    checkpoint = min(K, 24)

    # p-adic lifting.
    r: List[int] = list(int_b)
    digits: List[np.ndarray] = []
    exact_early = False
    while len(digits) < K:
        if not any(r):
            # Residual is exactly zero: the digits so far ARE the solution
            # (a nonnegative integer vector) — skip the remaining digits
            # and the modular reconstruction entirely.
            exact_early = True
            break
        rp = np.fromiter((ri % p for ri in r), dtype=np.int64, count=m)
        d = (inv_p @ rp) % p
        # r <- (r - B d) / p exactly, via the sparse integer columns.
        Bd = [0] * m
        for j in range(m):
            dj = int(d[j])
            if dj:
                for i, aij in int_columns[j]:
                    Bd[i] += aij * dj
        r = [(ri - bdi) // p for ri, bdi in zip(r, Bd)]
        digits.append(d)
        if len(digits) == checkpoint and len(digits) < K:
            y = _reconstruct_digits(digits, p, m, exact_early=False)
            if y is not None:
                x = y if scale == 1 else [v / scale for v in y]
                if _verify_exact(columns, x, b):
                    return x
            checkpoint = min(K, checkpoint * 4)

    y = _reconstruct_digits(digits, p, m, exact_early)
    if y is None:
        raise ExactSingularError("rational reconstruction failed")

    # Row scaling preserves the solution; undo the rhs multiplier if any.
    x = y if scale == 1 else [v / scale for v in y]

    # Exact verification of B x = b (guards the bound estimate).
    if not _verify_exact(columns, x, b):
        raise ExactSingularError("exact verification failed (lift bound too small)")
    return x


def exact_solve_transpose(
    columns: Sequence[Sequence[Entry]], c: Sequence[Fraction]
) -> List[Fraction]:
    """Solve B^T y = c exactly (duals)."""
    m = len(c)
    rows: List[List[Entry]] = [[] for _ in range(m)]
    for j, col in enumerate(columns):
        for i, v in col:
            rows[i].append((j, v))
    return exact_solve(rows, c)
