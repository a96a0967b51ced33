"""First-order (PDHG) throughput at scale on the device.

The PDHG inner loop is two dense matvecs + a box projection per iteration —
no pivot sequencing, no basis, nothing host-bound — so it is the method
whose throughput actually scales with problem size on this hardware.
This probe measures steady-state PDHG iterations/s at growing (m, n) on a
synthetic feasible box LP by chunk differencing (as bench.py does), timed
around ``block_until_ready``.

Usage: python scripts/pdhg_scale_probe.py [--sizes 1024x4096 2048x8192 ...]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def synthetic_box_lp(m, n, seed=0):
    """Feasible, bounded standard-form LP: A >= 0 dense-ish, b = A x_feas,
    box 0 <= x <= u with u finite on a third of the columns."""
    rng = np.random.default_rng(seed)
    A = np.abs(rng.standard_normal((m, n))).astype(np.float64) + 0.05
    x_feas = np.abs(rng.standard_normal(n))
    b = A @ x_feas
    c = rng.standard_normal(n)
    u = np.full(n, np.inf)
    u[::3] = np.abs(rng.standard_normal((n + 2) // 3)) * 2 + 1.0
    return A, b, c, u


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", nargs="*",
                    default=["1024x4096", "2048x8192", "4096x16384"])
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from relp_tpu.firstorder.pdhg import (
        _pdhg_chunk_jitted,
        ruiz_equilibrate,
    )

    print(f"device: {jax.devices()[0]}", flush=True)

    for size in args.sizes:
        m, n = (int(v) for v in size.split("x"))
        A_np, b_np, c_np, u_np = synthetic_box_lp(m, n)
        As, dr, dc = ruiz_equilibrate(A_np)
        A = jnp.asarray(As, jnp.float32)
        b = jnp.asarray((b_np * dr), jnp.float32)
        c = jnp.asarray((c_np * dc), jnp.float32)
        u = jnp.asarray((u_np / dc), jnp.float32)
        x = jnp.zeros(n, jnp.float32)
        y = jnp.zeros(m, jnp.float32)
        chunk_fn = _pdhg_chunk_jitted()

        def run(chunk):
            t0 = time.perf_counter()
            jax.block_until_ready(
                chunk_fn(x, y, x, y, 0.0, 1e-3, 1e-3, A, b, c, u, chunk=chunk)
            )
            return time.perf_counter() - t0

        for chunk in (20, 400):
            run(chunk)  # compile
        ests = []
        for _ in range(args.reps):
            d_s = run(20)
            d_b = run(400)
            if d_b > d_s:
                ests.append((d_b - d_s) / 380.0)
        if not ests:
            print(f"{size}: no positive difference, no estimate", flush=True)
            continue
        per_iter = float(np.median(ests))
        flops = 2 * 2 * m * n  # two matvecs
        print(
            f"{size:>12s}: {1.0 / per_iter:10.0f} PDHG iters/s  "
            f"({per_iter * 1e6:7.1f} us/iter, "
            f"{flops / per_iter / 1e12:6.2f} TFLOP/s sustained)",
            flush=True,
        )


if __name__ == "__main__":
    main()
