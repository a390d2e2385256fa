"""Microbench: gather cost vs operand size on the device.

Per-element gather cost can grow with operand size, which decides the
bloom and directory sizes in query/sortjoin.py.  This sweeps:
  a) independent uint32 word-gathers, N indices into 2^w-word operands
  b) independent [2]-wide uint64 row-gathers (the cuckoo-cell shape)
  c) chains of D dependent gather rounds (the binary-search shape)
so bloom sizing and the search-stage redesign are chosen from measured
numbers, not theory.  Timing: R enqueues, one jax.block_until_ready.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=614400)
    ap.add_argument("--k", type=int, default=19200)
    ap.add_argument("--repeats", type=int, default=30)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from cammiq_tpu.utils.jitcache import enable_persistent_cache

    enable_persistent_cache()

    rng = np.random.default_rng(0)
    N, K, R = args.n, args.k, args.repeats
    out = {"n": N, "k": K}

    def bench(name, f, *fargs):
        t0 = time.time()
        jax.block_until_ready(f(*fargs))
        comp = time.time() - t0
        t0 = time.time()
        for _ in range(R):
            o = f(*fargs)
        jax.block_until_ready(o)
        ms = (time.time() - t0) / R * 1000
        print(f"  {name:34s} {ms:8.3f} ms  (compile {comp:.1f}s)",
              file=sys.stderr, flush=True)
        out[name] = round(ms, 4)

    # ---- a) independent word gathers, N indices, operand 2^w words ----
    for w in (22, 24, 25, 26, 27):
        tab = jnp.asarray(rng.integers(0, 1 << 32, 1 << w, np.uint64)
                          .astype(np.uint32))
        idx = jnp.asarray(rng.integers(0, 1 << w, N).astype(np.int32))
        f = jax.jit(lambda t, i: t[i].astype(jnp.uint32).sum())
        bench(f"word_gather_N_2^{w}w_{4 << (w - 20)}MB", f, tab, idx)

    # ---- b) row gathers [2] uint64 (cuckoo cells), K indices ----
    for w, kk in ((24, K), (25, K), (26, K), (26, 2 * K), (27, K)):
        tab = jnp.asarray(rng.integers(0, 1 << 63, (1 << w, 2), np.uint64))
        idx = jnp.asarray(rng.integers(0, 1 << w, kk).astype(np.int32))
        f = jax.jit(lambda t, i: t[i].sum())
        bench(f"row2x8_gather_{kk}_2^{w}r_{16 << (w - 20)}MB", f, tab, idx)

    # ---- b2) row gathers [2] uint64 at full N (bloomless probe probe) --
    tab = jnp.asarray(rng.integers(0, 1 << 63, (1 << 26, 2), np.uint64))
    idx = jnp.asarray(rng.integers(0, 1 << 26, N).astype(np.int32))
    f = jax.jit(lambda t, i: t[i].sum())
    bench("row2x8_gather_N_2^26r_1024MB", f, tab, idx)

    # ---- c) dependent gather chains, K indices, operand 2^w words ----
    for w, d in ((24, 8), (26, 8), (26, 2)):
        tab_np = rng.integers(0, 1 << w, 1 << w).astype(np.int32)
        tab = jnp.asarray(tab_np)
        idx = jnp.asarray(rng.integers(0, 1 << w, K).astype(np.int32))

        def dep(t, i, d=d, w=w):
            def body(_, x):
                return t[x] & ((1 << w) - 1)
            return jax.lax.fori_loop(0, d, body, i).sum()

        f = jax.jit(dep)
        bench(f"dep{d}_gather_K_2^{w}w_{4 << (w - 20)}MB", f, tab, idx)

    js = json.dumps(out)
    print(js)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(js + "\n")


if __name__ == "__main__":
    main()
