"""Column-sharded simplex.

The constraint store (the (M, N) tableau) is sharded by columns across the
mesh's "col" axis — the device replacement for the reference's lazy
``MatrixProvider`` scan (pricing is the only full-n pass, SURVEY.md section 5
"long-context" analog).  The carry state (Binv, xB, pi, basis) is small and
replicated.

Under ``jit`` with these shardings, XLA/GSPMD compiles the pricing matvec
``pi @ A`` into a per-shard local scan and inserts the cross-device argmax
combine automatically; the entering column gather becomes an all-gather of one
(M,) column.  This is the "annotate shardings, let XLA insert collectives"
recipe — no hand-written NCCL analog.
"""

from __future__ import annotations


def _p():
    from jax.sharding import PartitionSpec

    return PartitionSpec


def shard_problem(mesh, A, b, c, candidate_mask):
    """Place the tableau column-sharded and the small vectors replicated."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    col = NamedSharding(mesh, P(None, "col"))
    rep_cols = NamedSharding(mesh, P("col"))
    rep = NamedSharding(mesh, P())
    A = jax.device_put(A, col)
    b = jax.device_put(b, rep)
    c = jax.device_put(c, rep_cols)
    candidate_mask = jax.device_put(candidate_mask, rep_cols)
    return A, b, c, candidate_mask


def shard_state(mesh, state):
    """Replicate the carry state, except the (N,)-sized members which follow
    the column sharding."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    rep = NamedSharding(mesh, P())
    cols = NamedSharding(mesh, P("col"))
    return state._replace(
        Binv=jax.device_put(state.Binv, rep),
        basis=jax.device_put(state.basis, rep),
        xB=jax.device_put(state.xB, rep),
        pi=jax.device_put(state.pi, rep),
        obj=jax.device_put(state.obj, rep),
        in_basis=jax.device_put(state.in_basis, cols),
        gamma=jax.device_put(state.gamma, cols),
        iteration=jax.device_put(state.iteration, rep),
        status=jax.device_put(state.status, rep),
        degen_count=jax.device_put(state.degen_count, rep),
        inner=jax.device_put(state.inner, rep),
        price_start=jax.device_put(state.price_start, rep),
        d=jax.device_put(state.d, cols),
    )


def shard_batch_problem(mesh, A, b, c, candidate_mask, A_scan=None):
    """Place batched (B, ...) problem arrays over the batch x col mesh.

    The (B, M, N) tableaus shard batch x columns; the (B, M) right-hand
    sides shard over batch only (they are small and row-indexed); the (B, N)
    costs/masks shard batch x columns.  When B does not divide the mesh's
    "batch" axis the batch dimension is replicated (columns still shard).
    """
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    batch_axis = "batch" if A.shape[0] % mesh.shape["batch"] == 0 else None
    tab = NamedSharding(mesh, P(batch_axis, None, "col"))
    vec = NamedSharding(mesh, P(batch_axis, "col"))
    rows = NamedSharding(mesh, P(batch_axis))
    A = jax.device_put(A, tab)
    b = jax.device_put(b, rows)
    c = jax.device_put(c, vec)
    candidate_mask = jax.device_put(candidate_mask, vec)
    if A_scan is not None:
        A_scan = jax.device_put(A_scan, tab)
    return A, b, c, candidate_mask, A_scan


def shard_batch_state(mesh, batch_state):
    """Shard a batched SimplexState: per-LP carry members over "batch",
    (B, N)-sized members additionally over "col"."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    B = batch_state.basis.shape[0]
    batch_axis = "batch" if B % mesh.shape["batch"] == 0 else None
    rows = NamedSharding(mesh, P(batch_axis))
    vec = NamedSharding(mesh, P(batch_axis, "col"))
    return batch_state._replace(
        Binv=jax.device_put(batch_state.Binv, rows),
        basis=jax.device_put(batch_state.basis, rows),
        xB=jax.device_put(batch_state.xB, rows),
        pi=jax.device_put(batch_state.pi, rows),
        obj=jax.device_put(batch_state.obj, rows),
        in_basis=jax.device_put(batch_state.in_basis, vec),
        gamma=jax.device_put(batch_state.gamma, vec),
        iteration=jax.device_put(batch_state.iteration, rows),
        status=jax.device_put(batch_state.status, rows),
        degen_count=jax.device_put(batch_state.degen_count, rows),
        inner=jax.device_put(batch_state.inner, rows),
        price_start=jax.device_put(batch_state.price_start, rows),
        d=jax.device_put(batch_state.d, vec),
    )


def sharded_run_chunk(mesh, state, A_scan, A_full, c, candidate_mask, **kwargs):
    """Run a chunk with the tableau column-sharded over the mesh.

    Identical math to :func:`relp_tpu.simplex.kernels.run_chunk`; the
    shardings of the inputs drive GSPMD partitioning.
    """
    from relp_tpu.simplex.kernels import run_chunk

    return run_chunk(state, A_scan, A_full, c, candidate_mask, **kwargs)
