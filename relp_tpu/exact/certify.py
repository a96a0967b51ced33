"""Exact certification and repair of a candidate optimal basis.

Given the basis the float device solver found, this module re-derives the exact
basic solution and duals (Dixon solves), checks primal feasibility and exact
nonnegative reduced costs — the same invariants the reference asserts in
``debug_assert_in_basic_feasible_solution_state`` (tableau/mod.rs:319-357) —
and, when the float basis is *not* exactly optimal, finishes the solve with
exact simplex pivots (Bland's rule, guaranteed to terminate).
"""

from __future__ import annotations

from fractions import Fraction
from typing import List, Optional, Sequence, Tuple

from relp_tpu.config import SolverConfig
from relp_tpu.linalg.sparse import SparseVector
from relp_tpu.providers.base import MatrixProvider
from relp_tpu.exact.dixon import ExactSingularError, ExactSolver


def _transpose(columns):
    m = len(columns)
    rows = [[] for _ in range(m)]
    for j, col in enumerate(columns):
        for i, v in col:
            rows[i].append((j, v))
    return rows


def _basis_columns(
    provider: MatrixProvider, basis: Sequence[int], art_offset: Optional[int] = None
):
    """Exact columns for a basis that may include artificials.

    An artificial column ``j >= art_offset`` is the identity column of its
    row with cost 0 (the phase-2 artificial cost): a basis containing
    zero-valued artificials still yields a valid primal/dual optimality
    certificate for the real LP.
    """
    columns = []
    for j in basis:
        if art_offset is not None and j >= art_offset:
            columns.append([(j - art_offset, Fraction(1))])
        else:
            columns.append(provider.column(j).entries())
    return columns


def _cost_of(provider: MatrixProvider, j: int, art_offset: Optional[int]) -> Fraction:
    if art_offset is not None and j >= art_offset:
        return Fraction(0)
    return provider.cost_value(j)


def certify_basis(
    provider: MatrixProvider,
    basis: Sequence[int],
    solver: "ExactSolver" = None,
    art_offset: Optional[int] = None,
    exclude_cols: frozenset = frozenset(),
) -> Tuple[List[Fraction], List[Fraction], Optional[int], Optional[int], "ExactSolver"]:
    """Exact x_B, duals y, index of an infeasible row (or None), an entering
    column with exactly negative reduced cost (or None), and the cached
    solver for further solves against this basis.

    ``exclude_cols`` never enter (columns fixed at 0, e.g. the signed
    artificials of an exact dual-start walk); their reduced-cost signs are
    irrelevant to the real LP's certificate."""
    columns = _basis_columns(provider, basis, art_offset)
    b = provider.right_hand_side()
    if solver is None:
        solver = ExactSolver(columns)
    x = solver.solve(b)

    infeasible_row: Optional[int] = None
    for i, v in enumerate(x):
        if v < 0:
            infeasible_row = i
            break
        if v != 0 and (
            (art_offset is not None and basis[i] >= art_offset)
            or basis[i] in exclude_cols
        ):
            # A basic artificial with nonzero exact value: the real LP is
            # not actually satisfied at this point.
            infeasible_row = i
            break

    cB = [_cost_of(provider, j, art_offset) for j in basis]
    y = solver.transposed().solve(cB)

    entering: Optional[int] = None
    in_basis = set(basis)
    for j in range(provider.nr_columns()):
        if j in in_basis or j in exclude_cols:
            continue
        d = provider.cost_value(j)
        for i, v in provider.column(j).iter_entries():
            d -= y[i] * v
        if d < 0:
            entering = j
            break
    return x, y, infeasible_row, entering, solver


def _exact_ratio_test(
    provider: MatrixProvider,
    basis: List[int],
    x: List[Fraction],
    q: int,
    solver: "ExactSolver",
) -> Optional[int]:
    """Exact min-ratio row with Bland tie-break on the leaving column index
    (reference: select_primal_pivot_row, tableau/mod.rs:287-313)."""
    a_q = provider.column(q).entries()
    rhs = [Fraction(0)] * len(basis)
    for i, v in a_q:
        rhs[i] = v
    w = solver.solve(rhs)

    best: Optional[Tuple[Fraction, int, int]] = None  # (ratio, basis col, row)
    for i, wi in enumerate(w):
        if wi > 0:
            ratio = x[i] / wi
            key = (ratio, basis[i])
            if best is None or key < (best[0], best[1]):
                best = (ratio, basis[i], i)
    return None if best is None else best[2]


def _rebuild_flat(provider, basis, art_offset):
    """Flat (updatable) solver for the current basis, or None to let the
    next certify_basis rebuild structurally.

    Cleanup walks pivot hundreds of times; only a flat inverse supports the
    O(m^2) mod-p Sherman-Morrison updates, so pay its O(m^3) construction
    once when m is small enough (above that, per-pivot block-triangular
    rebuilds are the cheaper trade)."""
    if len(basis) > 4096:
        return None
    try:
        return ExactSolver(
            _basis_columns(provider, basis, art_offset), peel=False
        )
    except ExactSingularError:
        return None


def exact_cleanup(
    provider: MatrixProvider,
    basis: List[int],
    cfg: SolverConfig,
    art_offset: Optional[int] = None,
    exclude_cols: frozenset = frozenset(),
) -> Tuple[List[int], List[Fraction], List[Fraction], int, bool]:
    """Run exact simplex pivots until exactly optimal (or budget runs out).

    Returns (basis, x, y, pivots_used, optimal).

    The :class:`ExactSolver` is carried across pivots via mod-p
    Sherman–Morrison column replacement (O(m^2) per pivot instead of a
    fresh O(m^3) mod-p Gauss-Jordan; a failed update — pivot divisible by
    the prime — falls back to a rebuild).
    """
    import logging
    import time as _time

    log = logging.getLogger("relp_tpu.exact")
    t0 = _time.time()
    time_budget = getattr(cfg, "exact_cleanup_time_s", 600.0)
    pivots = 0
    solver = None
    while True:
        x, y, infeasible_row, entering, solver = certify_basis(
            provider, basis, solver=solver, art_offset=art_offset,
            exclude_cols=exclude_cols,
        )
        if infeasible_row is not None:
            # The float solver returned an exactly-infeasible basis; exact
            # primal pivoting can't repair that from here.
            return basis, x, y, pivots, False
        if entering is None:
            return basis, x, y, pivots, True
        elapsed = _time.time() - t0
        if pivots >= cfg.exact_cleanup_budget or (
            time_budget and elapsed > time_budget
        ):
            log.info(
                "exact cleanup gave up after %d pivots / %.0fs "
                "(budget %d pivots / %.0fs) — certification fails and the "
                "escalation ladder retries with a cleaner basis",
                pivots, elapsed, cfg.exact_cleanup_budget, time_budget,
            )
            return basis, x, y, pivots, False
        if pivots and pivots % 25 == 0:
            log.info("exact cleanup: %d pivots, %.0fs", pivots, elapsed)
        r = _exact_ratio_test(provider, basis, x, entering, solver)
        if r is None:
            # Exactly unbounded — caller decides.
            return basis, x, y, pivots, False
        basis[r] = entering
        pivots += 1
        try:
            solver = solver.replace_column(
                r, provider.column(entering).entries()
            )
        except ExactSingularError:
            # Structural (BTF/peeled) solvers refuse in-place updates; a
            # long cleanup walk amortizes one flat O(m^3) inversion over
            # O(m^2) Sherman-Morrison pivots, so rebuild FLAT once the walk
            # is demonstrably long (short walks keep the cheap structural
            # rebuilds the next certify_basis performs).
            solver = (
                _rebuild_flat(provider, basis, art_offset)
                if pivots >= 10
                else None
            )


def exact_dual_cleanup(
    provider: MatrixProvider,
    basis: List[int],
    cfg: SolverConfig,
    art_offset: Optional[int] = None,
    solver: "ExactSolver" = None,
) -> Tuple[List[int], List[Fraction], List[Fraction], int, str]:
    """Exact dual simplex (Bland) from a dual-feasible, primal-infeasible
    basis — the state a float "optimal" verdict on an exactly-infeasible LP
    leaves behind (the float phase 1 tolerated a tiny violation; the exact
    basic solution has a negative entry).

    Returns ``(basis, x, y, pivots, verdict)`` with verdict one of
    ``"optimal"`` (primal feasibility restored, reduced costs stay exactly
    nonnegative by the dual ratio test), ``"infeasible"`` (a row with
    exactly negative basic value and no negative pivot entry over the real
    columns — the row of B^-1 is an exact Farkas certificate), or
    ``"gave_up"`` (budget exhausted / dual feasibility did not hold).

    Anti-cycling: the leaving row is the *smallest basic column index* among
    exactly-negative rows, and ratio ties pick the smallest entering column
    index (Bland's rule on the dual problem, guaranteed to terminate).
    """
    import time as _time

    t0 = _time.time()
    time_budget = getattr(cfg, "exact_cleanup_time_s", 600.0)
    pivots = 0
    while True:
        x, y, infeasible_row, entering, solver = certify_basis(
            provider, basis, solver=solver, art_offset=art_offset
        )
        if entering is not None:
            # Not dual feasible: the dual ratio test below would be unsound.
            return basis, x, y, pivots, "gave_up"
        # Leaving candidates: strictly negative basic values.  (A *positive*
        # basic artificial also flags infeasible_row in certify_basis but is
        # not repairable by a dual pivot; the caller re-checks it on exit.)
        neg = [i for i, v in enumerate(x) if v < 0]
        if not neg:
            return basis, x, y, pivots, "optimal"
        if pivots >= cfg.exact_cleanup_budget or (
            time_budget and _time.time() - t0 > time_budget
        ):
            return basis, x, y, pivots, "gave_up"
        r = min(neg, key=lambda i: basis[i])
        # Exact row r of B^-1: rho = B^-T e_r.
        e_r = [Fraction(0)] * len(basis)
        e_r[r] = Fraction(1)
        rho = solver.transposed().solve(e_r)
        in_basis = set(basis)
        best = None  # (ratio, j)
        for j in range(provider.nr_columns()):
            if j in in_basis:
                continue
            alpha = Fraction(0)
            for i, v in provider.column(j).iter_entries():
                alpha += rho[i] * v
            if alpha >= 0:
                continue
            d = provider.cost_value(j)
            for i, v in provider.column(j).iter_entries():
                d -= y[i] * v
            key = (d / -alpha, j)
            if best is None or key < best:
                best = key
        if best is None:
            # Row r proves infeasibility: x_r < 0 while (B^-1 A)_r >= 0 for
            # every real column, so y_f = -rho satisfies y_f^T a_j <= 0 for
            # all j and y_f^T b = -x_r > 0 — an exact Farkas certificate.
            return basis, x, y, pivots, "infeasible"
        j = best[1]
        basis[r] = j
        pivots += 1
        try:
            solver = solver.replace_column(r, provider.column(j).entries())
        except ExactSingularError:
            solver = (
                _rebuild_flat(provider, basis, art_offset)
                if pivots >= 10
                else None
            )


def exact_dual_bounded(
    provider: MatrixProvider,
    basis: List[int],
    cfg: SolverConfig,
    fixed_cols: frozenset,
    perturb_seed: Optional[int] = None,
    lift_costs: bool = False,
) -> Tuple[List[int], List[Fraction], List[Fraction], int, str]:
    """Exact bounded dual simplex: columns in ``fixed_cols`` are pinned to
    the degenerate interval [0, 0] — they may LEAVE the basis (toward 0)
    but never enter.

    This is the textbook dual-feasible cold start for an all-equality LP
    with c >= 0 (QAP12/QAP15, whose primal phase-1 walks pin to a 200k-pivot
    degenerate plateau — ROADMAP.md): a basis of signed zero-cost
    artificials gives y = 0 and d_j = c_j >= 0 exactly, and dual pivots
    drive every artificial to exactly 0 (or out of the basis) while reduced
    costs stay exactly nonnegative by the ratio test.  Unlike
    :func:`exact_dual_cleanup`, a basic FIXED column at any nonzero value
    (either sign) is an infeasibility; the mirrored (upper-violation) ratio
    test enters on alpha > 0.

    Returns ``(basis, x, y, pivots, verdict)`` with verdict "optimal"
    (primal feasible, fixed basics exactly 0), "infeasible" (a violated
    row admits no entering column over the non-fixed columns — an exact
    Farkas row for the real LP), or "gave_up" (budget, or dual
    infeasibility on entry).
    """
    import logging
    import time as _time

    log = logging.getLogger("relp_tpu.exact")
    t0 = _time.time()
    time_budget = getattr(cfg, "exact_cleanup_time_s", 600.0)
    pivots = 0
    n = provider.nr_columns()
    m = len(basis)
    b = provider.right_hand_side()

    # Exact columns and costs are immutable: cache them once (the scans
    # below touch every column every pivot).
    cols = [provider.column(j).entries() for j in range(n)]
    cost = [provider.cost_value(j) for j in range(n)]
    if perturb_seed is not None:
        # Exact random cost perturbation: QAP-class LPs are dual-degenerate
        # too (hundreds of zero-cost columns -> zero-length dual steps; the
        # unperturbed walk froze at dual objective 37.6 on QAP8).  Generic
        # perturbed costs make every ratio-test minimum unique, so every
        # dual step strictly increases the dual objective — termination in
        # at most #bases pivots with no anti-cycling rule needed.  The
        # caller removes the perturbation afterwards with an exact primal
        # cleanup on the TRUE costs from the returned basis (cost
        # perturbation with exact removal at optimality).
        import random as _random

        rng = _random.Random(perturb_seed)
        scale = Fraction(1, 1 << 40)
        cost = [
            cj + scale * Fraction(rng.randrange(1, 1 << 20), 1 << 20)
            if j not in fixed_cols
            else cj
            for j, cj in enumerate(cost)
        ]

    def _fresh(basis):
        solver = ExactSolver([cols[j] for j in basis])
        x = solver.solve(b)
        y = solver.transposed().solve([cost[j] for j in basis])
        d = list(cost)
        for j in range(n):
            acc = d[j]
            for i, v in cols[j]:
                acc -= y[i] * v
            d[j] = acc
        return solver, x, y, d

    solver, x, y, d = _fresh(basis)
    in_basis = set(basis)
    if lift_costs:
        # A warm-start basis from a FLOAT dual walk is only dual feasible
        # to float tolerance: a few exact reduced costs are slightly
        # negative.  Lift those columns' costs exactly (plus a random
        # epsilon to keep ratio minima unique) so THIS basis is exactly
        # dual feasible for the lifted problem; the caller removes lift +
        # perturbation afterwards with an exact primal cleanup on the true
        # costs (correctness never depends on the lifted problem).
        import random as _random

        rng_l = _random.Random((perturb_seed or 0) ^ 0x5EED)
        scale_l = Fraction(1, 1 << 40)
        lifted = 0
        for j in range(n):
            if j in in_basis or j in fixed_cols:
                continue
            if d[j] < 0:
                bump = -d[j] + scale_l * Fraction(
                    rng_l.randrange(1, 1 << 20), 1 << 20
                )
                cost[j] += bump
                d[j] += bump
                lifted += 1
        if lifted:
            log.info("exact dual bounded: lifted %d float-negative reduced "
                     "costs", lifted)
    if any(
        d[j] < 0
        for j in range(n)
        if j not in in_basis and j not in fixed_cols
    ):
        return basis, x, y, pivots, "gave_up"

    # The dual objective g = c_B . x_B increases monotonically on
    # nonzero-length dual steps; zero-length (dual-degenerate) steps are
    # where cycling lives.  Default to the practical max-violation leaving
    # rule and switch to Bland's (finite-termination) rule only while g
    # stalls — the exact-arithmetic analog of the float driver's
    # stall->Bland escalation.
    g = sum(cost[basis[i]] * xi for i, xi in enumerate(x) if xi)
    stall = 0
    bland_mode = False

    while True:
        violated = [
            i
            for i, v in enumerate(x)
            if v < 0 or (basis[i] in fixed_cols and v != 0)
        ]
        if not violated:
            # Recompute duals fresh for the returned certificate.
            solver, x, y, d = _fresh(basis)
            return basis, x, y, pivots, "optimal"
        if pivots >= cfg.exact_cleanup_budget or (
            time_budget and _time.time() - t0 > time_budget
        ):
            return basis, x, y, pivots, "gave_up"
        if pivots and pivots % 25 == 0:
            log.info(
                "exact dual bounded: %d pivots, %d violated rows, "
                "dual obj %.6f%s, %.0fs",
                pivots, len(violated), float(g),
                " [bland]" if bland_mode else "", _time.time() - t0,
            )

        if bland_mode:
            r = min(violated, key=lambda i: basis[i])
        else:
            r = max(violated, key=lambda i: (abs(x[i]), -basis[i]))
        upper = x[r] > 0  # fixed column above its (zero) upper bound
        e_r = [Fraction(0)] * m
        e_r[r] = Fraction(1)
        rho = solver.transposed().solve(e_r)

        # One alpha scan; reduced costs update incrementally from it
        # (d'_k = d_k - t*alpha_k with t = d_j*/alpha_j*), so the per-pivot
        # cost is a single pass over the nonzeros instead of three.
        alpha = {}
        best = None  # (ratio, j)
        for j in range(n):
            if j in in_basis:
                continue
            a = Fraction(0)
            for i, v in cols[j]:
                if rho[i]:
                    a += rho[i] * v
            if a:
                alpha[j] = a
            if j in fixed_cols:
                continue
            if (a >= 0) if not upper else (a <= 0):
                continue
            key = (d[j] / abs(a), j)
            if best is None or key < best:
                best = key
        if best is None:
            return basis, x, y, pivots, "infeasible"
        q = best[1]
        t = d[q] / alpha[q]
        for j, a in alpha.items():
            d[j] -= t * a
        leaving = basis[r]
        d[leaving] = -t  # rho . a_leaving == 1 (its own unit row)

        # Primal update from the entering column's exact FTRAN.
        rhs = [Fraction(0)] * m
        for i, v in cols[q]:
            rhs[i] = v
        w = solver.solve(rhs)
        theta = x[r] / w[r]
        x = [xi - theta * wi for xi, wi in zip(x, w)]
        x[r] = theta
        in_basis.discard(leaving)
        in_basis.add(q)
        basis[r] = q
        g_new = sum(cost[basis[i]] * xi for i, xi in enumerate(x) if xi)
        if g_new > g:
            stall = 0
            bland_mode = False
        else:
            stall += 1
            if stall >= 30:
                bland_mode = True
        g = g_new
        pivots += 1
        try:
            solver = solver.replace_column(r, cols[q])
        except ExactSingularError:
            solver = (
                _rebuild_flat(provider, basis, None) if pivots >= 10 else None
            )
            if solver is None:
                solver = ExactSolver([cols[j] for j in basis])


def certify_and_repair(
    result,
    provider: MatrixProvider,
    basis: List[int],
    cfg: SolverConfig,
    art_offset: Optional[int] = None,
) -> None:
    """Certify ``result`` in place; repair with exact pivots if needed.

    A primal-side failure (the exact basic solution has a negative entry —
    the float solver shipped a tolerance-level-infeasible "optimum") is
    repaired by the exact *dual* simplex, which either restores feasibility
    or proves the LP exactly INFEASIBLE; the verdict is corrected in place
    (status flip FINITE_OPTIMUM -> INFEASIBLE with ``certified=True``).
    Without this, an exactly-infeasible LP whose float relaxations look
    optimal ships as uncertified FINITE_OPTIMUM forever (seen as an
    infinite branch loop in the exact MIP tree)."""
    from relp_tpu.simplex.result import SolveStatus

    basis = list(basis)
    try:
        x, y, infeasible_row, entering, _solver = certify_basis(
            provider, basis, art_offset=art_offset
        )
        optimal = infeasible_row is None and entering is None
        if not optimal and cfg.exact_cleanup and infeasible_row is None:
            basis, x, y, pivots, optimal = exact_cleanup(
                provider, basis, cfg, art_offset=art_offset
            )
            result.stats.exact_cleanup_pivots = pivots
        elif (
            not optimal
            and cfg.exact_cleanup
            and infeasible_row is not None
            and x[infeasible_row] < 0
        ):
            basis, x, y, pivots, verdict = exact_dual_cleanup(
                provider, basis, cfg, art_offset=art_offset, solver=_solver
            )
            result.stats.exact_cleanup_pivots = pivots
            if verdict == "infeasible":
                result.status = SolveStatus.INFEASIBLE
                result.objective = None
                result.bfs = None
                result.exact_bfs = None
                result.exact_objective = None
                result.basis = basis
                result.art_offset = art_offset
                result.stats.certified = True
                return
            if verdict == "optimal":
                # Dual pivots keep reduced costs exactly nonnegative, but a
                # zero-level artificial check still applies below.
                optimal = all(v >= 0 for v in x) and not (
                    art_offset is not None
                    and any(
                        x[i] != 0
                        for i, j in enumerate(basis)
                        if j >= art_offset
                    )
                )
    except ExactSingularError:
        result.stats.certified = False
        _fallback_float_bfs(result, provider)
        return

    if not optimal:
        result.stats.certified = False
        _fallback_float_bfs(result, provider)
        return

    n = provider.nr_columns()
    entries = [
        (j, x[i]) for i, j in enumerate(basis) if j < n and x[i] != 0
    ]
    result.exact_bfs = SparseVector(entries, n)
    objective = Fraction(0)
    for i, j in enumerate(basis):
        objective += _cost_of(provider, j, art_offset) * x[i]
    result.exact_objective = objective
    result.exact_duals = y
    result.basis = basis
    # Basic artificials (zero-valued) may remain in the basis; record the
    # offset so downstream consumers (exact sensitivity) can interpret them.
    result.art_offset = art_offset
    result.bfs = result.exact_bfs
    result.objective = float(objective)
    result.stats.certified = True


def certify_infeasible(
    provider: MatrixProvider,
    basis: Sequence[int],
    art_offset: int,
) -> bool:
    """Exactly certify infeasibility from a phase-1-optimal basis.

    The basis may contain artificial columns (index >= ``art_offset``; the
    artificial for row i is ``art_offset + i`` with column e_i and phase-1
    cost 1).  Checks the Farkas certificate: with exact duals y of the
    phase-1 basis, y^T a_j <= 0 for every real column while y^T b > 0 — no
    nonnegative x can satisfy Ax = b.
    """
    n = provider.nr_columns()
    b = provider.right_hand_side()
    m = len(b)

    columns = []
    cB = []
    for j in basis:
        if j >= art_offset:
            row = j - art_offset
            if row >= m:
                return False
            columns.append([(row, Fraction(1))])
            cB.append(Fraction(1))
        else:
            columns.append(provider.column(j).entries())
            cB.append(Fraction(0))

    try:
        solver = ExactSolver(columns)
        x = solver.solve(b)
        if any(v < 0 for v in x):
            return False
        phase1_obj = sum(
            (c * v for c, v in zip(cB, x)), Fraction(0)
        )
        if phase1_obj <= 0:
            return False
        y = solver.transposed().solve(cB)
    except ExactSingularError:
        return False

    for j in range(n):
        total = Fraction(0)
        for i, v in provider.column(j).iter_entries():
            total += y[i] * v
        # Phase-1 reduced cost of a real column is 0 - y.a_j; optimality
        # requires y.a_j <= 0 exactly.
        if total > 0:
            return False
    return True


def certify_unbounded(
    provider: MatrixProvider,
    basis: Sequence[int],
    art_offset: Optional[int] = None,
) -> bool:
    """Exactly certify unboundedness at the current basis: some column has
    exactly negative reduced cost and an exactly nonpositive FTRAN column
    (an improving ray; reference: OptimizationResult::Unbounded).

    The basis may contain zero-level artificials (index >= ``art_offset``):
    they are treated as identity columns at cost 0 and their exact basic
    value must be 0, so the certificate still applies to the real LP."""
    columns = _basis_columns(provider, basis, art_offset)
    b = provider.right_hand_side()
    try:
        solver = ExactSolver(columns)
        x = solver.solve(b)
        if any(v < 0 for v in x):
            return False  # not even a feasible basis
        if art_offset is not None and any(
            x[i] != 0 for i, j in enumerate(basis) if j >= art_offset
        ):
            return False  # nonzero artificial: the real LP is not satisfied
        cB = [_cost_of(provider, j, art_offset) for j in basis]
        y = solver.transposed().solve(cB)
    except ExactSingularError:
        return False

    in_basis = set(basis)
    m = len(basis)
    for j in range(provider.nr_columns()):
        if j in in_basis:
            continue
        entries = provider.column(j).entries()
        d = provider.cost_value(j) - sum(
            (y[i] * v for i, v in entries), Fraction(0)
        )
        if d >= 0:
            continue
        rhs = [Fraction(0)] * m
        for i, v in entries:
            rhs[i] = v
        try:
            w = solver.solve(rhs)
        except ExactSingularError:
            return False
        if all(wi <= 0 for wi in w):
            return True
    return False


def _fallback_float_bfs(result, provider: MatrixProvider) -> None:
    entries = getattr(result, "float_entries", [])
    result.bfs = SparseVector(
        [(j, Fraction(float(v))) for j, v in entries], provider.nr_columns()
    )
