"""Exact Gomory mixed-integer (GMI) cuts at the branch & bound root.

Beyond reference scope: Gomory cuts are the third unimplemented item on the
reference's README roadmap (with branch & bound and floating-point
arithmetic — reference README.md:60-70).

Everything is exact: the tableau row is re-derived from the root basis with
Dixon solves (one ``B^T y = e_i`` per cut via the cached
:class:`~relp_tpu.exact.dixon.ExactSolver`), the GMI coefficients are
Fraction arithmetic, and the resulting inequalities are globally valid for
the MIP — so they are added ONCE to the standard form and shared by every
B&B node (the node frontier stays a perturbed-rhs family of one matrix).

GMI derivation (minimize form, all columns >= 0, equality row
``x_B[i] + sum_j abar_j x_j = xbar_i`` with every nonbasic at 0):
with ``f0 = frac(xbar_i)`` and ``f_j = frac(abar_j)``,

    sum_{j int, f_j <= f0} f_j x_j
  + sum_{j int, f_j >  f0} f0 (1 - f_j) / (1 - f0) x_j
  + sum_{j cont, abar_j > 0} abar_j x_j
  + sum_{j cont, abar_j < 0} f0 (-abar_j) / (1 - f0) x_j   >=   f0.

Treating an integer column as continuous is always valid (weaker cut), so
slacks and any integrality-ambiguous columns take the continuous branch.
"""

from __future__ import annotations

import math
from fractions import Fraction
from typing import Dict, List, Optional, Sequence, Set, Tuple

from relp_tpu.exact.dixon import ExactSingularError, ExactSolver
from relp_tpu.linalg.sparse import SparseVector
from relp_tpu.providers.base import (
    BoundDirection,
    MatrixProvider,
    PartialInitialBasis,
)
from relp_tpu.providers.column import Column, SparseColumn


class CutProvider(PartialInitialBasis):
    """A provider with inequality cut rows appended to the standard form.

    Cut t becomes row ``base_m + t``: ``sum_j c_tj x_j + s_t * slack_t =
    rhs_t`` with a fresh column ``base_n + t`` (cost 0).  ``senses[t]`` is
    ``">="`` (the default; surplus, coefficient -1) or ``"<="`` (slack,
    coefficient +1).  Rows are normalized so ``rhs_t >= 0`` (the standard
    form's b >= 0 invariant): a row whose rhs would be negative is negated,
    flipping its sense.  A ``<=`` row's +1 slack serves as an initial pivot
    (no phase-1 artificial needed); a ``>=`` row's surplus cannot, so the
    lowering gives it an artificial automatically — exactly how such rows
    enter the standard form.
    """

    def __init__(
        self,
        inner: MatrixProvider,
        cuts: Sequence[Dict[int, Fraction]],
        rhs: Sequence[Fraction],
        senses: Optional[Sequence[str]] = None,
    ):
        assert len(cuts) == len(rhs)
        if senses is None:
            senses = [">="] * len(cuts)
        assert len(senses) == len(cuts)
        self.inner = inner
        self.cuts: List[Dict[int, Fraction]] = []
        self.cut_rhs: List[Fraction] = []
        self.cut_signs: List[Fraction] = []  # slack coefficient: -1 or +1
        for cut, r, sense in zip(cuts, rhs, senses):
            assert sense in (">=", "<=")
            r = Fraction(r)
            if r < 0:  # normalize to b >= 0 by negating the row
                cut = {j: -v for j, v in cut.items()}
                r = -r
                sense = "<=" if sense == ">=" else ">="
            self.cuts.append(dict(cut))
            self.cut_rhs.append(r)
            self.cut_signs.append(
                Fraction(-1) if sense == ">=" else Fraction(1)
            )
        self._base_m = inner.nr_rows()
        self._base_n = inner.nr_columns()

    # --- shape ---
    def nr_rows(self) -> int:
        return self._base_m + len(self.cuts)

    def nr_columns(self) -> int:
        return self._base_n + len(self.cuts)

    def nr_constraints(self) -> int:
        return self.inner.nr_constraints() + len(self.cuts)

    def nr_variable_bounds(self) -> int:
        return self.inner.nr_variable_bounds()

    # --- data ---
    def column(self, j: int) -> Column:
        if j >= self._base_n:
            t = j - self._base_n
            return SparseColumn([(self._base_m + t, self.cut_signs[t])])
        entries = list(self.inner.column(j).iter_entries())
        for t, cut in enumerate(self.cuts):
            v = cut.get(j)
            if v:
                entries.append((self._base_m + t, v))
        return SparseColumn(entries)

    def cost_value(self, j: int) -> Fraction:
        if j >= self._base_n:
            return Fraction(0)
        return self.inner.cost_value(j)

    def right_hand_side(self) -> List[Fraction]:
        return list(self.inner.right_hand_side()) + list(self.cut_rhs)

    def bound_row_index(self, j: int, direction: BoundDirection):
        if j >= self._base_n:
            return None
        return self.inner.bound_row_index(j, direction)

    def pivot_element_indices(self) -> List[Tuple[int, int]]:
        # ``<=`` cut rows offer their +1 slack as an initial pivot; ``>=``
        # rows (surplus -1) cannot and get phase-1 artificials.  The inner
        # provider's slack pivots pass through unchanged.
        inner_pivots = (
            self.inner.pivot_element_indices()
            if isinstance(self.inner, PartialInitialBasis)
            else []
        )
        return list(inner_pivots) + [
            (self._base_m + t, self._base_n + t)
            for t, sign in enumerate(self.cut_signs)
            if sign > 0
        ]

    def reconstruct_solution(self, column_values: SparseVector) -> SparseVector:
        entries = [(i, v) for i, v in column_values if i < self._base_n]
        return self.inner.reconstruct_solution(
            SparseVector(entries, self._base_n, _trusted=True)
        )


def _frac(v: Fraction) -> Fraction:
    return v - math.floor(v)


def flatten_cut_over_base(
    cut: Dict[int, Fraction],
    cut_rhs_value: Fraction,
    base_n: int,
    prior_cuts: Sequence[Dict[int, Fraction]],
    prior_rhs: Sequence[Fraction],
    prior_signs: Optional[Sequence[Fraction]] = None,
) -> Tuple[Dict[int, Fraction], Fraction]:
    """Express a cut derived on a cut-augmented provider over BASE columns.

    A later GMI round runs on ``CutProvider(base, prior_cuts, prior_rhs)``
    and may put (nonnegative) coefficients on the prior cuts' slack/surplus
    columns ``base_n + t``.  Each satisfies exactly
    ``s_t = <c_t, x> - rhs_t`` (``>=`` row, sign -1) or
    ``s_t = rhs_t - <c_t, x>`` (``<=`` row, sign +1), so substituting it
    out keeps the inequality valid and yields a cut over base columns only
    — which keeps every B&B node a perturbed-rhs family of ONE flat
    CutProvider instead of a nest.  ``prior_signs`` defaults to all ``>=``.
    """
    flat: Dict[int, Fraction] = {}
    rhs = cut_rhs_value
    for j, coef in cut.items():
        if j >= base_n:
            t = j - base_n
            surplus = prior_signs is None or prior_signs[t] < 0
            if surplus:  # s_t = <c_t, x> - rhs_t
                for jj, cc in prior_cuts[t].items():
                    flat[jj] = flat.get(jj, Fraction(0)) + coef * cc
                rhs += coef * prior_rhs[t]
            else:  # s_t = rhs_t - <c_t, x>
                for jj, cc in prior_cuts[t].items():
                    flat[jj] = flat.get(jj, Fraction(0)) - coef * cc
                rhs -= coef * prior_rhs[t]
        else:
            flat[j] = flat.get(j, Fraction(0)) + coef
    return {j: v for j, v in flat.items() if v}, rhs


def knapsack_cover_cuts(
    gf,
    counts: Tuple[int, int, int, int],
    binaries: Sequence[int],
    x_active,
    *,
    max_cuts: int = 8,
) -> Tuple[List[Dict[int, Fraction]], List[Fraction], List[str]]:
    """Exact minimal-cover cuts from the standardized constraint rows.

    For a ``<=`` row ``a.x <= b`` (``>=`` rows are negated), restrict to the
    binary columns with positive coefficients and absorb every other term's
    worst case into the rhs: ``b' = b - sum_{a_j<0} a_j u_j`` (active lower
    bounds are 0 after standardization; rows with an unbounded negative
    term are skipped).  A cover ``C`` with ``sum_C a_j > b'`` yields the
    globally valid cut ``sum_C x_j <= |C| - 1``; greedy separation picks
    columns by descending LP value, minimalizes the cover, and emits only
    cuts the point ``x_active`` violates exactly.  Valid at every B&B node:
    branching only tightens upper bounds, which only shrinks ``b'``.

    ``binaries``: active column indices with integer type and bounds [0,1].
    ``x_active``: exact active-space values (SparseVector or dict-like via
    ``.get``).  Returns (cuts, rhs, senses) over active structural columns.
    """
    from collections import defaultdict

    nr_eq, nr_range, nr_le, nr_ge = counts
    bin_set = set(binaries)

    row_entries: Dict[int, List[Tuple[int, Fraction]]] = defaultdict(list)
    for j, col in enumerate(gf.constraints.columns):
        for i, v in col:
            row_entries[i].append((j, v))

    le_start = nr_eq + nr_range
    candidate_rows: List[Tuple[List[Tuple[int, Fraction]], Fraction]] = []
    for i in range(le_start, le_start + nr_le):
        candidate_rows.append((row_entries.get(i, []), gf.b[i]))
    for i in range(le_start + nr_le, le_start + nr_le + nr_ge):
        candidate_rows.append(
            ([(j, -v) for j, v in row_entries.get(i, [])], -gf.b[i])
        )

    cuts: List[Dict[int, Fraction]] = []
    rhs_out: List[Fraction] = []
    seen: set = set()
    for entries, b in candidate_rows:
        if len(cuts) >= max_cuts:
            break
        b_eff = b
        items = []  # (j, a_j > 0, j binary)
        ok = True
        for j, a in entries:
            if a > 0 and j in bin_set:
                items.append((j, a))
            elif a < 0:
                u = gf.variables[j].upper_bound
                if u is None:
                    ok = False
                    break
                b_eff = b_eff - a * u
            # a > 0, non-binary: worst case x_j = 0 contributes nothing.
        if not ok or len(items) < 2:
            continue
        total = sum(a for _, a in items)
        if total <= b_eff:
            continue  # no cover exists in this row
        # Greedy cover: take columns by descending LP value until the
        # weight exceeds b'.
        items.sort(key=lambda ja: (x_active.get(ja[0]) or Fraction(0)), reverse=True)
        cover = []
        weight = Fraction(0)
        for j, a in items:
            cover.append((j, a))
            weight += a
            if weight > b_eff:
                break
        if weight <= b_eff:
            continue
        # Minimalize: drop light members while the cover property holds.
        cover.sort(key=lambda ja: ja[1])
        minimal = []
        for idx, (j, a) in enumerate(cover):
            if weight - a > b_eff:
                weight -= a
            else:
                minimal.append((j, a))
        if len(minimal) < 2:
            continue
        lhs_value = sum(
            (x_active.get(j) or Fraction(0)) for j, _ in minimal
        )
        if lhs_value <= len(minimal) - 1:
            continue  # not violated by the current point
        key = frozenset(j for j, _ in minimal)
        if key in seen:
            continue
        seen.add(key)
        cuts.append({j: Fraction(1) for j, _ in minimal})
        rhs_out.append(Fraction(len(minimal) - 1))
    return cuts, rhs_out, ["<="] * len(cuts)


def gomory_mixed_cuts(
    provider: MatrixProvider,
    basis: Sequence[int],
    integer_cols: Set[int],
    *,
    max_cuts: int = 8,
    max_denominator: int = 10**12,
) -> Tuple[List[Dict[int, Fraction]], List[Fraction]]:
    """Exact GMI cuts from the fractional integer-basic rows of ``basis``.

    Returns (cuts, rhs) over ``provider``'s columns; empty when the basic
    solution is integral (or the basis is exactly singular).  Cuts whose
    coefficients exceed ``max_denominator`` are skipped — exact arithmetic
    makes monster rationals possible and they densify the float lowering
    for no practical gain.
    """
    m = provider.nr_rows()
    n = provider.nr_columns()
    columns = [provider.column(j).entries() for j in basis]
    try:
        solver = ExactSolver(columns, peel=False)
    except ExactSingularError:
        return [], []
    x = solver.solve(provider.right_hand_side())

    # Rank fractional integer-basic rows by how central the fraction is.
    rows = [
        (abs(_frac(x[i]) - Fraction(1, 2)), i)
        for i in range(m)
        if basis[i] in integer_cols and x[i].denominator != 1
    ]
    rows.sort()

    in_basis = set(basis)
    nonbasic = [j for j in range(n) if j not in in_basis]
    # Nonbasic columns as dense-by-row dicts once (shared across cuts).
    col_entries = {j: provider.column(j).entries() for j in nonbasic}

    transposed = solver.transposed()
    cuts: List[Dict[int, Fraction]] = []
    rhs: List[Fraction] = []
    for _, i in rows[:max_cuts]:
        e_i = [Fraction(0)] * m
        e_i[i] = Fraction(1)
        try:
            y = transposed.solve(e_i)  # row i of B^{-1}, exactly
        except ExactSingularError:
            continue
        f0 = _frac(x[i])
        one_minus = 1 - f0
        cut: Dict[int, Fraction] = {}
        ok = True
        for j in nonbasic:
            abar = sum((y[r] * v for r, v in col_entries[j]), Fraction(0))
            if not abar:
                continue
            if j in integer_cols:
                fj = _frac(abar)
                coef = fj if fj <= f0 else f0 * (1 - fj) / one_minus
            else:
                coef = abar if abar > 0 else f0 * (-abar) / one_minus
            if coef:
                if coef.denominator > max_denominator:
                    ok = False
                    break
                cut[j] = coef
        if ok and cut:
            cuts.append(cut)
            rhs.append(f0)
    return cuts, rhs
