"""Measure the REALIZED free-EXIST candidate count on a config-#4-scale
mixture (r4 VERDICT item 2 tail: the tripwire pinned the realistic
strain mixture at n_free=16, but the 50-random-genome test already
realized 40 — what does the 4000-genome index itself produce?).

Simulates a lognormal mixture of `--present` genomes out of the cached
4K-genome DB, classifies `--batches` x 8192 reads, builds the quant
problem with the reference pre-filter, and reports n_free plus the
solver's certification outcome at default caps.
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
    ap.add_argument("--genomes", type=int, default=4000)
    ap.add_argument("--glen", type=int, default=300000)
    ap.add_argument("--present", type=int, default=60)
    ap.add_argument("--batches", type=int, default=12)
    ap.add_argument("--solve", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    os.environ.setdefault("CAMMIQ_BENCH_GENOMES", str(args.genomes))
    os.environ.setdefault("CAMMIQ_BENCH_GLEN", str(args.glen))
    import jax
    import jax.numpy as jnp

    from cammiq_tpu.utils.jitcache import enable_persistent_cache

    enable_persistent_cache()

    import bench as benchmod
    from cammiq_tpu.config import FineParams
    from cammiq_tpu.index.artifact import load_merged_artifact
    from cammiq_tpu.models.quant import build_problem, solve_quant
    from cammiq_tpu.query.sortjoin import (make_sortjoin_classifier,
                                           to_device_merged_artifact)

    benchmod.BENCH_GENOMES = args.genomes
    benchmod.BENCH_GLEN = args.glen
    cdir = benchmod.bench_cache_dir()
    mdir = os.path.join(cdir, "merged")
    art = load_merged_artifact(mdir)
    dm = to_device_merged_artifact(art)
    G = args.genomes + 1
    genomes = benchmod.gen_bench_genomes()

    rng = np.random.default_rng(9)
    present = rng.choice(args.genomes, args.present, replace=False)
    weights = rng.lognormal(0.0, 1.0, args.present)
    weights /= weights.sum()

    classify = make_sortjoin_classifier(dm, G, hit_capacity_frac=16,
                                        maxm=16)
    B = 8192
    cnts_u = np.zeros(G, np.int64)
    cnts_d = np.zeros(G, np.int64)
    rcu = np.zeros(art.eu, np.int64)
    rcd = np.zeros(art.ed, np.int64)
    t0 = time.time()
    from cammiq_tpu.ops.packing import SYMBOL_IDX

    for it in range(args.batches):
        codes = np.zeros((B, 100), np.int8)
        lengths = np.full(B, 100, np.int32)
        gsel = present[rng.choice(args.present, B, p=weights)]
        for b in range(B):
            c = genomes[gsel[b]][0]
            p = int(rng.integers(0, len(c) - 100))
            codes[b] = SYMBOL_IDX[np.frombuffer(c[p:p + 100], np.uint8)]
        errs = rng.random((B, 100)) < 0.01
        codes = np.where(errs, rng.integers(0, 4, (B, 100)), codes).astype(np.int8)
        flip = rng.random(B) < 0.5
        codes[flip] = (3 - codes[flip])[:, ::-1]
        out, ovh, ovs = classify(jnp.asarray(codes), jnp.asarray(lengths),
                                 with_rcounts=True, sc_mode=False,
                                 uniform_len=100)
        assert int(np.asarray(ovh)) == 0 and int(np.asarray(ovs)) == 0
        cnts_u += np.asarray(out.cnts_u, np.int64)
        cnts_d += np.asarray(out.cnts_d, np.int64)
        rcu += np.asarray(out.rcount_u, np.int64)
        rcd += np.asarray(out.rcount_d, np.int64)
        print(f"# batch {it + 1}/{args.batches} classified "
              f"({time.time() - t0:.0f}s)", file=sys.stderr, flush=True)

    def meta(name):
        vals = {}
        with open(os.path.join(mdir, name)) as f:
            for line in f:
                a, b = line.split()
                vals[int(a)] = float(b)
        out_a = np.zeros(G)
        for k, v in vals.items():
            out_a[k] = v
        return out_a

    glength = meta("genome_lengths.out")
    nus = meta("unique_lmer_count_u.out")
    nds = meta("unique_lmer_count_d.out")
    up, dp = art.payloads()
    res = {"genomes": args.genomes, "present": args.present,
           "reads": B * args.batches}
    # default reference prefilter AND the hole-structure stress variant:
    # the synthetic pool corpus has almost no doubly-unique content, so
    # the faithful doubly-count test zeroes every candidate (the
    # reference would too on this DB); the stress variant disables it
    # to measure how many EXIST holes a 4000-genome mixture realizes
    for tag, fine in (("default", FineParams()),
                      ("stress", FineParams(read_cnt_thres=1,
                                            easy_to_identify_thres=10**9,
                                            ilp_alpha=1e-9))):
        prob = build_problem(up, dp, rcu, rcd, cnts_u.astype(float),
                             cnts_d.astype(float), nus, nds, glength, 100,
                             B * args.batches, 0.01, fine)
        forced = prob.exist0 & (prob.lb > 0)
        n_free = int((prob.exist0 & ~forced).sum())
        res[f"{tag}_candidates"] = int(prob.exist0.sum())
        res[f"{tag}_forced"] = int(forced.sum())
        res[f"{tag}_n_free"] = n_free
    if args.solve:
        t1 = time.time()
        exist, cov, info = solve_quant(prob)   # the stress problem
        res.update(solver_exhaustive=bool(info.get("exhaustive", True)),
                   stopped_by=info.get("stopped_by", "no_candidates"),
                   selected=int(exist.sum()),
                   solve_s=round(time.time() - t1, 1))
    js = json.dumps(res)
    print(js)
    if args.out:
        with open(args.out, "w") as f:
            f.write(js + "\n")


if __name__ == "__main__":
    main()
