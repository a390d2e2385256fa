"""Cut-based per-stage profile of the sort-join classify step.

Instead of isolated microbenches, every measurement jits the PRODUCTION
collect_matches_sortjoin program truncated after a named stage (the `cut`
hook): each cut's program is a prefix of the full one, so consecutive
deltas are the true cost of each stage with XLA fusion intact, and no
exotic standalone program shapes are involved.

Timing: R enqueues, then one jax.block_until_ready.

Usage: python benchmarks/stage_cuts.py [merged_dir] [--repeats R]
       [--batch B] [--out F] [--cuts hash,search,...]
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

CUTS = ["hash", "filter", "compact", "search", "bucket", "payload",
        "collect", "part1", "full"]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("merged", nargs="?",
                    default=os.path.join(REPO, "bench_cache/g1000_l300k/merged"))
    ap.add_argument("--repeats", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--join", default="auto",
                    choices=["auto", "sort", "dir", "bloom"])
    ap.add_argument("--frac", type=int, default=32,
                    help="hit_capacity_frac (bench.py widens to 16 at the "
                         "4K/20K-genome shapes; profile the real regime)")
    ap.add_argument("--cuts", default=",".join(CUTS))
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from cammiq_tpu.utils.jitcache import enable_persistent_cache

    enable_persistent_cache()

    from cammiq_tpu.index.artifact import load_merged_artifact
    from cammiq_tpu.query.sortjoin import (
        _DM_ARRAYS, _DM_STATIC, DeviceMergedIndex,
        collect_matches_sortjoin, make_sortjoin_classifier,
        to_device_merged_artifact)

    t0 = time.time()
    art = load_merged_artifact(args.merged)
    dm = to_device_merged_artifact(art)
    dm_arrays = {k: getattr(dm, k) for k in _DM_ARRAYS
                 if getattr(dm, k) is not None}
    dm_static = {k: getattr(dm, k) for k in _DM_STATIC}
    B, Lp = args.batch, 100
    N = B * (Lp - dm.h + 1)
    rng = np.random.default_rng(1)
    codes = jnp.asarray(rng.integers(0, 4, size=(B, Lp)).astype(np.int8))
    lengths = jnp.asarray(np.full(B, Lp, np.int32))
    R = args.repeats
    print(f"# session up in {time.time() - t0:.1f}s  E={art.E} NB={art.NB} "
          f"N={N} dir_bits={dm.dir_bits} steps={dm.dir_span_steps}",
          file=sys.stderr, flush=True)

    def bench(name, f, *fargs):
        t_c = time.time()
        jax.block_until_ready(f(*fargs))
        compile_s = time.time() - t_c
        t1 = time.time()
        for _i in range(R):
            o = f(*fargs)
        jax.block_until_ready(o)
        ms = (time.time() - t1) / R * 1000
        print(f"  {name:12s} {ms:9.3f} ms   (compile+warm {compile_s:.1f}s)",
              file=sys.stderr, flush=True)
        return round(ms, 3)

    out = {"E": art.E, "NB": art.NB, "N": N, "B": B, "join": args.join, "frac": args.frac,
           "dir_bits": dm.dir_bits, "dir_span_steps": dm.dir_span_steps,
           "max_bucket": art.max_bucket, "n_colors": art.n_colors}

    def make_cut(cut):
        def f(arrays, c, l):
            dmi = DeviceMergedIndex(**dm_static, **arrays)
            r = collect_matches_sortjoin(dmi, c, l, join=args.join,
                                         hit_capacity_frac=args.frac,
                                         cut=None if cut == "collect" else cut)
            if cut == "collect":
                return r[0].slots[:2, :2]
            return r
        return jax.jit(f)

    classify = make_sortjoin_classifier(dm, 1001, hit_capacity_frac=args.frac)
    for cut in args.cuts.split(","):
        if cut == "part1":
            out[cut] = bench(cut, lambda c, l: classify(
                c, l, False, False, None)[0].cnts_u, codes, lengths)
        elif cut == "full":
            out[cut] = bench(cut, lambda c, l: classify(
                c, l, True, False, None)[0].cnts_u, codes, lengths)
        else:
            try:
                out[cut] = bench(cut, make_cut(cut), dm_arrays, codes, lengths)
            except ValueError as e:  # e.g. cut='filter' on a non-bloom path
                print(f"  {cut:12s} skipped: {e}", file=sys.stderr, flush=True)
                out[cut] = None

    js = json.dumps(out)
    print(js)
    if args.out:
        with open(args.out, "w") as f:
            f.write(js + "\n")


if __name__ == "__main__":
    main()
