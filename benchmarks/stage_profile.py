"""Per-stage profile of the sort-join classify step on the device:
enqueue R repeats, then one jax.block_until_ready.

All index arrays are passed to the jitted stage functions as ARGUMENTS
(mirroring make_sortjoin_classifier's _DM_ARRAYS pattern) — a closure
capture would bake the multi-GB index into each stage executable as
constants, blowing up compile time and misrepresenting the production
argument-passing path.

Usage:
  python benchmarks/stage_profile.py [merged_dir] [--repeats R] [--out F]

Prints a JSON breakdown: whole-step time plus isolated stage times
(pack, join sort / dir search, first-of-run scan, compaction, bucket
scan, distinct sort, case analysis, rcount scatter) at the production
index shape.
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
    ap.add_argument("merged", nargs="?",
                    default=os.path.join(REPO, "bench_cache/g1000_l300k/merged"))
    ap.add_argument("--repeats", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--join", default="auto", choices=["auto", "sort", "dir"])
    ap.add_argument("--out", default=None, help="also write the JSON here")
    ap.add_argument("--skip", default="", help="comma-separated stage names to skip")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from cammiq_tpu.utils.jitcache import enable_persistent_cache

    enable_persistent_cache()

    from cammiq_tpu.index.artifact import load_merged_artifact
    from cammiq_tpu.query.classify import MatchSlots, case_analysis
    from cammiq_tpu.query.sortjoin import (
        _DM_ARRAYS, _DM_STATIC, DeviceMergedIndex, _first_of_run_scan,
        collect_matches_sortjoin, make_sortjoin_classifier, pack_rolling16,
        to_device_merged_artifact)

    skip = set(s for s in args.skip.split(",") if s)
    art = load_merged_artifact(args.merged)
    dm = to_device_merged_artifact(art)
    dm_arrays = {k: getattr(dm, k) for k in _DM_ARRAYS
                 if getattr(dm, k) is not None}
    dm_static = {k: getattr(dm, k) for k in _DM_STATIC}
    B, Lp = args.batch, 100
    h, kw = dm.h, dm.kw
    O = Lp - h + 1
    N = B * O
    NB = art.NB
    rng = np.random.default_rng(1)
    codes = jnp.asarray(rng.integers(0, 4, size=(B, Lp)).astype(np.int8))
    lengths = jnp.asarray(np.full(B, Lp, np.int32))
    R = args.repeats

    def bench(name, f, *fargs):
        """R enqueues, one block_until_ready. Returns ms/call."""
        if name in skip:
            return None
        t_c = time.time()
        jax.block_until_ready(f(*fargs))  # compile + drain
        compile_s = time.time() - t_c
        t0 = time.time()
        for _i in range(R):
            o = f(*fargs)
        jax.block_until_ready(o)
        ms = (time.time() - t0) / R * 1000
        print(f"  {name:34s} {ms:9.3f} ms   (compile {compile_s:.1f}s)",
              file=sys.stderr, flush=True)
        return round(ms, 3)

    out = {"E": art.E, "NB": NB, "N": N, "B": B,
           "max_bucket": art.max_bucket, "n_colors": art.n_colors,
           "dir_bits": dm.dir_bits, "dir_span_steps": dm.dir_span_steps}

    # ---- whole step (arrays as args — the production path)
    classify = make_sortjoin_classifier(dm, 1001)
    out["classify_full"] = bench(
        "classify (part1+part2)",
        lambda c, l: classify(c, l, True, False, None)[0].cnts_u, codes, lengths)
    out["classify_nor"] = bench(
        "classify (part1 only)",
        lambda c, l: classify(c, l, False, False, None)[0].cnts_u, codes, lengths)

    def collect(arrays, c, l):
        dmi = DeviceMergedIndex(**dm_static, **arrays)
        return collect_matches_sortjoin(dmi, c, l, join=args.join)[0].slots
    out["collect_only"] = bench(
        "collect_matches (join=%s)" % args.join,
        jax.jit(collect), dm_arrays, codes, lengths)

    # ---- isolated stages (shapes mirror collect_matches internals)
    out["pack"] = bench("pack_rolling16",
                        jax.jit(lambda c: pack_rolling16(c)), codes)

    khlo = jnp.asarray(rng.integers(0, 2**32, size=N, dtype=np.uint64)
                       .astype(np.uint32))
    if dm.pref_lo is not None:
        jw2 = jnp.asarray(rng.integers(0, 2**31, size=N + NB, dtype=np.uint64)
                          .astype(np.uint32))
        out["join_sort"] = bench(
            "join sort 2op n=%d" % (N + NB),
            jax.jit(lambda plo, k, b: jax.lax.sort(
                [jnp.concatenate([plo, k]), b], num_keys=2,
                is_stable=False)[0][:8]),
            dm.pref_lo, khlo, jw2)
        v1 = jnp.asarray(rng.integers(0, 2, size=N + NB).astype(np.int32))
        st = jnp.asarray(rng.random(N + NB) < 0.5).at[0].set(True)
        out["for_scan"] = bench(
            "first-of-run scan n=%d" % (N + NB),
            jax.jit(lambda s, a, b: _first_of_run_scan(s, a, b)[0][:8]),
            st, v1, v1)
    if dm.dir_start is not None:
        db = dm.dir_bits
        steps = dm.dir_span_steps

        def dirsearch(ds, plo, khlo):
            top = (khlo >> jnp.uint32(32 - db)).astype(jnp.int32)
            blo = ds[top]
            bhi = ds[top + 1]

            def bs_body(_, lh):
                lo, hi2 = lh
                active = lo < hi2
                mid = (lo + hi2) >> 1
                v = plo[jnp.clip(mid, 0, NB - 1)]
                less = v < khlo
                return (jnp.where(active & less, mid + 1, lo),
                        jnp.where(active & ~less, mid, hi2))

            blo, bhi = jax.lax.fori_loop(0, steps, bs_body, (blo, bhi))
            return blo

        out["dir_search"] = bench(
            "directory search N=%d (%d steps)" % (N, steps),
            jax.jit(lambda ds, plo, k: dirsearch(ds, plo, k)[:8]),
            dm.dir_start, dm.pref_lo, khlo)

    K = min(max(N // 32, 256), N)
    fkey = jnp.asarray(rng.integers(0, 2**30, size=N).astype(np.int32))
    out["compact_sort"] = bench(
        "compaction sort 1op n=%d" % N,
        jax.jit(lambda a: jax.lax.sort([a], num_keys=1, is_stable=False)[0][:K][:8]),
        fkey)

    eidx = jnp.asarray(rng.integers(0, art.E, size=K).astype(np.int32))
    out["erec_gather"] = bench(
        "erec row-gather K=%d" % K,
        jax.jit(lambda er, i: er[i][:8]), dm.erec, eidx)
    out["brec_gather"] = bench(
        "brec row-gather K=%d" % K,
        jax.jit(lambda br, i: br[i][:8]), dm.brec,
        jnp.asarray(rng.integers(0, NB, size=K).astype(np.int32)))

    # distinct-slot sort: K*NC rows, 4 operands, 2 sort keys
    NC = art.n_colors
    KN = K * NC
    mr = jnp.asarray(rng.integers(0, B + 1, size=KN).astype(np.int32))
    mg = jnp.asarray(rng.integers(0, art.E, size=KN).astype(np.int32))
    out["distinct_sort"] = bench(
        "distinct sort 4op n=%d" % KN,
        jax.jit(lambda a, b: jax.lax.sort([a, b, b, b], num_keys=2,
                                          is_stable=False)[0][:8]),
        mr, mg)

    # case analysis on [B, maxm] slots
    maxm = 16
    sl = jnp.asarray(rng.integers(0, art.E, size=(B, maxm)).astype(np.int32))
    r1 = jnp.asarray(rng.integers(1, 1001, size=(B, maxm)).astype(np.int32))
    ms_slots = MatchSlots(slots=sl, rid1=r1, rid2=jnp.zeros_like(r1),
                          in_u=sl < art.eu)
    out["case_analysis"] = bench(
        "case analysis B=%d maxm=%d" % (B, maxm),
        jax.jit(lambda m, l: case_analysis(m, l, 1001).cnts_u), ms_slots,
        lengths)

    # part2: rcount scatter into the full entry space
    etot = art.E
    tgt = jnp.asarray(rng.integers(0, etot + 1, size=KN).astype(np.int32))
    out["rcount_scatter"] = bench(
        "rcount scatter E=%d n=%d" % (etot, KN),
        jax.jit(lambda t: jnp.zeros(etot + 1, jnp.int32).at[t].add(1)[:8]),
        tgt)

    js = json.dumps(out)
    print(js)
    if args.out:
        with open(args.out, "w") as f:
            f.write(js + "\n")


if __name__ == "__main__":
    main()
