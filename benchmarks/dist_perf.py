"""Distributed classify THROUGHPUT measurement (every dist test asserts
exactness only).

Measures, on the production merged artifact:
- single-device baseline batch time (same process, no mesh);
- DistSortJoinSession batch time at (data, model) mesh shapes, with and
  without the per-batch E-sized rcount psum, so the collective cost is
  a measured delta, not a guess;
- analytic all_gather volume at the session's maxm.

Run on the virtual CPU mesh (default: JAX_PLATFORMS=cpu,
xla_force_host_platform_device_count=8) for collective-overhead shape,
and with CAMMIQ_DIST_PERF_MESH=1,1 on one GPU for the session-wrapper
overhead at mesh size 1.  Writes one JSON line (--out).
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
                    default=os.path.join(REPO,
                                         "bench_cache/g1000_l300k/merged"))
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--repeats", type=int, default=20)
    ap.add_argument("--meshes", default="1x8,2x4,8x1")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    if "xla_force_host_platform_device_count" not in os.environ.get(
            "XLA_FLAGS", "") and os.environ.get("JAX_PLATFORMS") == "cpu":
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + " --xla_force_host_platform_device_count=8")

    import jax

    import jax.numpy as jnp
    from jax.sharding import Mesh

    from cammiq_tpu.utils.jitcache import enable_persistent_cache

    enable_persistent_cache()

    from cammiq_tpu.index.artifact import load_merged_artifact
    from cammiq_tpu.parallel.dist_query import DistSortJoinSession
    from cammiq_tpu.query.sortjoin import (make_sortjoin_classifier,
                                           to_device_merged_artifact)

    art = load_merged_artifact(args.merged)
    B = args.batch
    R = args.repeats
    rng = np.random.default_rng(1)
    codes = rng.integers(0, 4, size=(B, 100)).astype(np.int8)
    lengths = np.full(B, 100, np.int32)
    ndev = len(jax.devices())
    G = 20001
    out = {"E": art.E, "NB": art.NB, "B": B, "backend": jax.default_backend(),
           "devices": ndev}

    def steady(fn):
        jax.block_until_ready(fn())
        t0 = time.time()
        for _ in range(R):
            o = fn()
        jax.block_until_ready(o)
        return (time.time() - t0) / R * 1000

    # ---- single-device baseline ----
    dm = to_device_merged_artifact(art)
    classify = make_sortjoin_classifier(dm, G, hit_capacity_frac=16,
                                        maxm=16)
    cd, ld = jnp.asarray(codes), jnp.asarray(lengths)
    ms_single = steady(
        lambda: classify(cd, ld, with_rcounts=True, sc_mode=False,
                         uniform_len=100)[0])
    out["single_ms"] = round(ms_single, 2)
    print(f"# single-device: {ms_single:.2f} ms/batch", file=sys.stderr,
          flush=True)
    del dm, classify

    for mesh_s in args.meshes.split(","):
        dpn, mpn = (int(x) for x in mesh_s.split("x"))
        if dpn * mpn > ndev:
            continue
        devs = np.array(jax.devices()[: dpn * mpn]).reshape(dpn, mpn)
        mesh = Mesh(devs, ("data", "model"))
        sess = DistSortJoinSession(mesh, merged=art, num_genome_slots=G,
                                   hit_capacity_frac=16, maxm=16)
        key = f"mesh{dpn}x{mpn}"
        for wr in (True, False):
            ms = steady(
                lambda: sess._get_fn(16, 16, wr)(sess._shards, cd, ld))
            out[f"{key}_{'rc' if wr else 'norc'}_ms"] = round(ms, 2)
            print(f"# {key} rcounts={wr}: {ms:.2f} ms/batch",
                  file=sys.stderr, flush=True)
        # analytic all_gather volume over 'model' at maxm=16: 4 int32
        # MatchSlots arrays of [B/dp, maxm] per shard, each device
        # receives (mp-1) remote shards
        ag = (B // dpn) * 16 * 4 * 4 * (mpn - 1)
        out[f"{key}_allgather_bytes_per_device"] = ag
        del sess

    # E-sized rcount psum bytes (per batch, if not deferred)
    out["rcount_psum_bytes"] = int(art.E) * 4
    js = json.dumps(out)
    print(js)
    if args.out:
        with open(args.out, "w") as f:
            f.write(js + "\n")


if __name__ == "__main__":
    main()
