"""Microbenchmarks with in-jit repetition (8 chained ops per dispatch) so
the per-dispatch launch latency amortizes away.

Run:  python benchmarks/sort_micro.py
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

R = 8  # in-jit repetitions


def timeit_chain(fn, x0, iters=8):
    import jax

    x = fn(x0)
    jax.block_until_ready(x)
    t0 = time.time()
    for _ in range(iters):
        x = fn(x)
    jax.block_until_ready(x)
    return (time.time() - t0) / (iters * R) * 1e3  # ms per single op


def main():
    import jax
    import jax.numpy as jnp

    from cammiq_tpu.utils.jitcache import enable_persistent_cache

    enable_persistent_cache()

    n = 1_314_483
    rng = np.random.default_rng(0)
    a = jnp.asarray(rng.integers(0, 2**32, size=n, dtype=np.uint32))
    b = jnp.asarray(rng.integers(0, 2**32, size=n, dtype=np.uint32))
    C = jnp.uint32(0x9E3779B1)

    def rep(body):
        def f(x):
            for _ in range(R):
                x = body(x)
            return x
        return jax.jit(f)

    f1 = rep(lambda x: jax.lax.sort([x], num_keys=1, is_stable=False)[0]
             * C + jnp.uint32(1))

    def b2(xy):
        sx, sy = jax.lax.sort(list(xy), num_keys=2, is_stable=False)
        return (sx * C + jnp.uint32(1), sy ^ sx)

    def b1p(xy):
        sx, sy = jax.lax.sort(list(xy), num_keys=1, is_stable=False)
        return (sx * C + jnp.uint32(1), sy ^ sx)

    f2 = rep(b2)
    f1p = rep(b1p)

    print(f"n = {n} (chained, x{R} in-jit)")
    print(f"1 key          : {timeit_chain(f1, a):7.3f} ms")
    print(f"1 key + payload: {timeit_chain(f1p, (a, b)):7.3f} ms")
    print(f"2 keys         : {timeit_chain(f2, (a, b)):7.3f} ms")

    for c in (2048, 4096, 8192):
        m = (n // c) * c
        fseg = rep(lambda x: jax.lax.sort(
            [x], dimension=1, num_keys=1, is_stable=False)[0] * C
            + jnp.uint32(1))
        a3 = a[:m].reshape(-1, c)
        print(f"segmented 1key c={c:5d}: {timeit_chain(fseg, a3):7.3f} ms")

    # segmented 2key
    for c in (4096,):
        m = (n // c) * c

        def bseg(xy):
            sx, sy = jax.lax.sort(list(xy), dimension=1, num_keys=2,
                                  is_stable=False)
            return (sx * C + jnp.uint32(1), sy ^ sx)

        fseg2 = rep(bseg)
        print(f"segmented 2key c={c:5d}: "
              f"{timeit_chain(fseg2, (a[:m].reshape(-1, c), b[:m].reshape(-1, c))):7.3f} ms")

    fel = rep(lambda x: x * C + jnp.uint32(7))
    ms = timeit_chain(fel, a, iters=8)
    print(f"elementwise pass: {ms:7.3f} ms ({n*8/ms*1e3/1e9:.0f} GB/s)")

    # scatter-add
    bins = 85685
    for k in (38400, 8192):
        idx0 = jnp.asarray(rng.integers(0, bins, size=k, dtype=np.int32))

        def bsc(idx, k=k):
            h = jnp.zeros(bins + 1, jnp.int32).at[idx].add(1)
            return (idx + h[:k]) % bins

        print(f"scatter-add {k:6d} -> {bins}: "
              f"{timeit_chain(rep(bsc), idx0):7.3f} ms")

    # gather
    src = jnp.asarray(rng.integers(1, 2**31, size=n, dtype=np.int32))
    for k in (19200, 38400):
        gidx0 = jnp.asarray(rng.integers(0, n, size=k, dtype=np.int32))

        def bg(gi):
            v = src[gi]
            return (gi + v) % n

        print(f"gather {k:6d} from {n}: {timeit_chain(rep(bg), gidx0):7.3f} ms")

    srcr = jnp.asarray(rng.integers(1, 2**31, size=(n // 4, 5), dtype=np.int32))
    gidx1 = jnp.asarray(rng.integers(0, n // 4, size=19200, dtype=np.int32))

    def bgr(gi):
        v = srcr[gi]
        return (gi + v[:, 0] + v[:, 4]) % (n // 4)

    print(f"row-gather 19200x5: {timeit_chain(rep(bgr), gidx1):7.3f} ms")


if __name__ == "__main__":
    main()
