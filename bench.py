"""Benchmark: simplex pivot throughput on one GPU.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, "device": {...},
   "detail": {...}}

Primary metric: marginal simplex iterations/s of the fused device hot loop
(pricing scan + FTRAN + Harris ratio test + rank-1 inverse update +
steepest-edge update) on a dense 1024x4096 standard-form tableau in the f32
fast path (the production configuration: f32 device arithmetic with exact
rational certification and automatic f64 escalation on top).

Methodology: the time of a chunk of K pivots is measured for two K values
(host clock around ``block_until_ready``) and differenced, so the fixed
dispatch cost cancels and the per-pivot device cost remains.  The same
differencing gives the f64-carry, df32-carry and batched (vmapped XLA)
rates in ``detail``.

Baseline: the reference publishes no numbers (BASELINE.md); as a proxy we
use 1,000 exact-rational iterations/s for single-core RELP on problems of
this size.  vs_baseline = measured / 1000.

Fails (exit 1, no JSON) when JAX finds no GPU: a number from another
device is never reported under this metric.
"""

import json
import subprocess
import sys
import time

import numpy as np

RELP_PROXY_ITERS_PER_S = 1000.0


def _note(msg):
    print(f"[bench +{time.time() - _T0:7.1f}s] {msg}", file=sys.stderr, flush=True)


_T0 = time.time()


def _timed(fn):
    """Seconds for ``fn()`` including device completion, and its result."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    return time.perf_counter() - t0, out


def _marginal(run, chunks, count):
    """Per-pivot seconds by interleaved small/large chunk differencing.

    ``run(chunk)`` returns the chunk's output; ``count(out)`` its pivots.
    Both chunk sizes compile outside the timed region; the median of the
    per-rep differences is reported.
    """
    for chunk in chunks:
        count(_timed(lambda: run(chunk))[1])
    estimates = []
    for _ in range(5):
        t_s, out_s = _timed(lambda: run(chunks[0]))
        t_b, out_b = _timed(lambda: run(chunks[1]))
        di = count(out_b) - count(out_s)
        if di > 0:
            estimates.append((t_b - t_s) / di)
    if not estimates:
        return None
    return float(np.median(estimates))


def _single(kernels, state0, A_scan, A_full, c, cand, run_chunk=None):
    run_chunk = run_chunk or kernels.run_chunk
    kw = dict(
        pricing=kernels.PRICE_STEEPEST, opt_tol=1e-7, pivot_tol=1e-7,
        degen_tol=1e-7,
    )
    return _marginal(
        lambda chunk: run_chunk(state0, A_scan, A_full, c, cand, chunk=chunk, **kw),
        (10, 300),
        lambda out: int(out.iteration),
    )


def _batched(kernels, B, m, n, seed):
    import jax.numpy as jnp

    from __graft_entry__ import _make_state, _synthetic_problem
    from relp_tpu.parallel.batch import batched_run_chunk, make_batch_state

    states, As, cs, cands = [], [], [], []
    for s in range(B):
        A, b, c1, _c2, cand, basis = _synthetic_problem(
            m=m, n=n, pad=128, seed=seed + s, dtype=np.float32
        )
        states.append(_make_state(A, b, c1, basis))
        As.append(A)
        cs.append(c1)
        cands.append(cand)
    batch = make_batch_state(states)
    A_b = jnp.asarray(np.stack(As))
    c_b = jnp.asarray(np.stack(cs))
    cand_b = jnp.asarray(np.stack(cands))
    kw = dict(
        pricing=kernels.PRICE_STEEPEST, opt_tol=1e-7, pivot_tol=1e-7,
        degen_tol=1e-7,
    )
    return _marginal(
        lambda chunk: batched_run_chunk(
            batch, A_b, A_b, c_b, cand_b, chunk=chunk, **kw
        ),
        (10, 120),
        lambda out: int(np.asarray(out.iteration).sum()),
    )


def _rate(per):
    return round(1.0 / per, 1) if per else None


def main():
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"bench: no GPU (JAX backend {devices[0].platform})", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, file=sys.stderr)

    from __graft_entry__ import _make_state, _synthetic_problem
    from relp_tpu.ops.df32 import df_from_f64
    from relp_tpu.simplex import kernels
    from relp_tpu.simplex.df_kernels import df_make_state, df_run_chunk
    from relp_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    m, n = 1024, 4096
    detail = {
        "problem": f"dense {m}x{n} standard form + {m} artificials",
        "pricing": "steepest-edge",
        "methodology": "marginal chunk differencing (10 vs 300 pivots)",
        "card": card,
    }

    # --- fast path: f32 carry + f32 scans ---
    A, b, c1, _c2, cand, basis = _synthetic_problem(
        m=m, n=n, pad=128, seed=7, dtype=np.float32
    )
    A_d = jnp.asarray(A)
    per_f32 = _single(
        kernels, _make_state(A, b, c1, basis), A_d, A_d, jnp.asarray(c1),
        jnp.asarray(cand),
    )
    detail["fast_path_f32_ms_per_iter"] = (
        round(per_f32 * 1e3, 4) if per_f32 else None
    )
    _note(f"f32: {detail['fast_path_f32_ms_per_iter']} ms/iter")

    # --- robust path: f64 carry + f32 scans ---
    A64, b64, c164, _c264, cand64, basis64 = _synthetic_problem(
        m=m, n=n, pad=128, seed=7, dtype=np.float64
    )
    A64_d = jnp.asarray(A64)
    per_f64 = _single(
        kernels, _make_state(A64, b64, c164, basis64),
        A64_d.astype(jnp.float32), A64_d, jnp.asarray(c164),
        jnp.asarray(cand64),
    )
    detail["robust_path_f64_carry_iters_per_s"] = _rate(per_f64)
    _note(f"f64 carry: {detail['robust_path_f64_carry_iters_per_s']} it/s")

    # --- df32 carry: compensated two-f32 ---
    Ah, Al = df_from_f64(A64)
    ch, cl = df_from_f64(c164)

    def df_chunk(st, A_scan, _A_full, _c, cand, **kw):
        return df_run_chunk(st, A_scan, Ah, Al, ch, cl, cand, **kw)

    per_df = _single(
        kernels, df_make_state(A64, b64, c164, basis64), Ah, Ah,
        None, jnp.asarray(cand64), run_chunk=df_chunk,
    )
    detail["df32_carry_iters_per_s"] = _rate(per_df)
    _note(f"df32 carry: {detail['df32_carry_iters_per_s']} it/s")

    # --- scenario batches through the vmapped XLA chunk loop ---
    detail["batched_64x_m256_pivots_per_s"] = _rate(
        _batched(kernels, 64, 256, 512, seed=100)
    )
    _note(f"batched 64x m256: {detail['batched_64x_m256_pivots_per_s']} pivots/s")
    detail["batched_128x_m512_pivots_per_s"] = _rate(
        _batched(kernels, 128, 512, 1024, seed=300)
    )
    _note(f"batched 128x m512: {detail['batched_128x_m512_pivots_per_s']} pivots/s")

    value = 1.0 / per_f32 if per_f32 else 0.0
    print(json.dumps({
        "metric": "simplex_iterations_per_s",
        "value": round(value, 1),
        "unit": "iter/s",
        "vs_baseline": round(value / RELP_PROXY_ITERS_PER_S, 2),
        "device": {
            "platform": devices[0].platform,
            "kind": devices[0].device_kind,
            "count": len(devices),
        },
        "detail": detail,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
