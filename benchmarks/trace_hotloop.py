"""Capture a jax.profiler trace of the hot loop and print top device ops.

Run:  python benchmarks/trace_hotloop.py [trace_dir]
"""

from __future__ import annotations

import glob
import gzip
import json
import os
import sys

import numpy as np


def main():
    import jax
    import jax.numpy as jnp

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
    from bench import build_bench_index, sample_read_batch

    from cammiq_tpu.utils.jitcache import enable_persistent_cache

    enable_persistent_cache()

    from cammiq_tpu.query.sortjoin import (
        build_merged_index, make_sortjoin_classifier, to_device_merged,
    )

    rng = np.random.default_rng(1)
    corpus, genomes, art = build_bench_index()
    dm = to_device_merged(build_merged_index(art.unique_index, art.doubly_index))
    G = len(genomes) + 1
    B = 8192
    codes, lengths = sample_read_batch(rng, genomes, B)
    codes_d = jnp.asarray(codes)
    lengths_d = jnp.asarray(lengths)
    classify = make_sortjoin_classifier(dm, G)

    def fn():
        out, _, _ = classify(codes_d, lengths_d, with_rcounts=True,
                             sc_mode=False, uniform_len=100)
        return out

    jax.block_until_ready(fn())  # compile

    tdir = sys.argv[1] if len(sys.argv) > 1 else "/tmp/cammiq_trace"
    with jax.profiler.trace(tdir):
        for _ in range(8):
            out = fn()
        jax.block_until_ready(out)

    # parse the trace: sum device-op durations by op name
    paths = glob.glob(os.path.join(tdir, "**", "*.trace.json.gz"),
                      recursive=True)
    if not paths:
        print("no trace found under", tdir)
        return
    path = max(paths, key=os.path.getmtime)
    with gzip.open(path, "rt") as f:
        trace = json.load(f)
    events = trace.get("traceEvents", [])
    # device track pids (device compute lanes)
    pid_names = {}
    for e in events:
        if e.get("ph") == "M" and e.get("name") == "process_name":
            pid_names[e["pid"]] = e["args"].get("name", "")
    dev_pids = {p for p, n in pid_names.items()
                if "/device" in n.lower() or "Device" in n}
    tot = {}
    cnt = {}
    total_dur = 0.0
    for e in events:
        if e.get("ph") != "X" or e.get("pid") not in dev_pids:
            continue
        name = e.get("name", "?")
        dur = e.get("dur", 0)
        tot[name] = tot.get(name, 0) + dur
        cnt[name] = cnt.get(name, 0) + 1
        total_dur += dur
    print(f"# device tracks: {[pid_names[p] for p in dev_pids]}")
    print(f"# total device time: {total_dur/1e3:.2f} ms over 8 iters "
          f"({total_dur/8e3:.3f} ms/iter)")
    for name, d in sorted(tot.items(), key=lambda kv: -kv[1])[:40]:
        print(f"{d/8e3:9.4f} ms/iter  x{cnt[name]//8:<4d} {name[:110]}")


if __name__ == "__main__":
    main()
