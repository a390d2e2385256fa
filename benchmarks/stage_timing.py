"""Stage-level timing of the sort-join hot loop on the current backend.

Rebuilds the bench index, then times cumulative prefixes of the
collect_matches_sortjoin pipeline as separately-jitted functions; the
difference between consecutive prefixes is the stage cost.  Diagnostic
tool only (not part of the library API).

Run:  python benchmarks/stage_timing.py
"""

from __future__ import annotations

import sys
import time

import numpy as np


def timeit(fn, *args, iters=64):
    import jax

    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.time()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.time() - t0) / iters * 1e3  # ms


def main():
    import jax
    import jax.numpy as jnp

    import os

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
    from bench import build_bench_index, sample_read_batch

    from cammiq_tpu.utils.jitcache import enable_persistent_cache

    enable_persistent_cache()

    from cammiq_tpu.query.sortjoin import (
        _HHI_BITS, _first_of_run_scan, _hash_prefix, build_merged_index,
        make_sortjoin_classifier, to_device_merged,
    )
    from cammiq_tpu.query.probe import pack_rolling16

    rng = np.random.default_rng(1)
    corpus, genomes, art = build_bench_index()
    dm = to_device_merged(build_merged_index(art.unique_index, art.doubly_index))
    G = len(genomes) + 1
    B = 8192
    codes, lengths = sample_read_batch(rng, genomes, B)
    codes_d = jnp.asarray(codes)
    lengths_d = jnp.asarray(lengths)

    h, kw = dm.h, dm.kw
    Lp = codes.shape[1]
    O = Lp - h + 1
    NB = dm.pref_lo.shape[0]
    N = 2 * B * O
    print(f"# B={B} O={O} N={N} NB={NB} kw={kw} max_bucket={dm.max_bucket}",
          file=sys.stderr)

    # ---- stage prefixes -------------------------------------------------
    def prep(codes, lengths):
        rl = 100
        rc = (3 - codes[:, :rl])[:, ::-1].astype(codes.dtype)
        codes2 = jnp.concatenate([codes, rc], axis=0)
        p16 = pack_rolling16(codes2)

        def window_word(w):
            start = 16 * w
            if start >= Lp:
                return jnp.zeros((2 * B, O), jnp.uint32)
            sl = p16[:, start:]
            if sl.shape[1] < O:
                sl = jnp.concatenate(
                    [sl, jnp.zeros((2 * B, O - sl.shape[1]), jnp.uint32)],
                    axis=1)
            return sl[:, :O]

        p16s = jnp.stack([window_word(w) for w in range(kw)], axis=-1)
        p16s = p16s.reshape(-1, kw)
        W0 = p16s[:, 0].reshape(2 * B, O)
        nb0 = min(h, 16)
        m0 = jnp.uint32(0xFFFFFFFF if nb0 >= 16 else (1 << (2 * nb0)) - 1)
        if h > 16:
            W1 = p16s[:, 1].reshape(2 * B, O)
            nb1 = h - 16
            m1 = jnp.uint32(0xFFFFFFFF if nb1 >= 16 else (1 << (2 * nb1)) - 1)
            khi = (W1 & m1).reshape(-1)
        else:
            khi = jnp.zeros((2 * B * O,), jnp.uint32)
        klo = (W0 & m0).reshape(-1)
        khlo, khhi = _hash_prefix(klo, khi, jnp)
        return p16s, khlo, khhi

    def joinkeys(codes, lengths):
        p16s, khlo, khhi = prep(codes, lengths)
        row_bits = max(int(max(N, NB) - 1).bit_length(), 1)
        hb = min(_HHI_BITS, 31 - row_bits)
        jw1 = jnp.concatenate([dm.pref_lo, khlo])
        jhhi = jnp.concatenate([dm.pref_hi, khhi]) & jnp.uint32((1 << hb) - 1)
        jtag = jnp.concatenate(
            [jnp.zeros(NB, jnp.uint32), jnp.ones(N, jnp.uint32)])
        jrow = jnp.concatenate(
            [jnp.arange(NB, dtype=jnp.uint32), jnp.arange(N, dtype=jnp.uint32)])
        jw2 = (jhhi << (row_bits + 1)) | (jtag << row_bits) | jrow
        return p16s, jw1, jw2, row_bits

    def to_sort(codes, lengths):
        p16s, jw1, jw2, row_bits = joinkeys(codes, lengths)
        sw1, sw2 = jax.lax.sort([jw1, jw2], num_keys=2, is_stable=False)
        return p16s, sw1, sw2

    def to_scan(codes, lengths):
        p16s, jw1, jw2, row_bits = joinkeys(codes, lengths)
        sw1, sw2 = jax.lax.sort([jw1, jw2], num_keys=2, is_stable=False)
        stag = ((sw2 >> row_bits) & 1).astype(jnp.int32)
        sval = (sw2 & jnp.uint32((1 << row_bits) - 1)).astype(jnp.int32)
        srun = sw2 >> (row_bits + 1)
        is_start = jnp.concatenate(
            [jnp.ones(1, bool), (sw1[1:] != sw1[:-1]) | (srun[1:] != srun[:-1])])
        has_tab = jnp.where(is_start, (stag == 0).astype(jnp.int32), 0)
        # the first-of-run propagation is XLA's associative scan
        pbid, ptab = _first_of_run_scan(is_start, sval, has_tab)
        probe_hit = (stag == 1) & (ptab > 0)
        return p16s, sval, pbid, probe_hit

    def to_compact(codes, lengths):
        p16s, sval, pbid, probe_hit = to_scan(codes, lengths)
        K = max(N // 64, 256)
        rows = jnp.arange(N + NB, dtype=jnp.int32)
        BIGOFF = jnp.int32(1 << 30)
        fkey = jnp.where(probe_hit, rows, rows + BIGOFF)
        skey = jax.lax.sort([fkey], num_keys=1, is_stable=False)[0][:K]
        cv = skey < BIGOFF
        crow_c = jnp.where(cv, skey, 0)
        cpos = jnp.where(cv, sval[crow_c], -1)
        cbid = pbid[crow_c]
        return p16s, cpos, cbid

    from cammiq_tpu.query.sortjoin import collect_matches_sortjoin

    def full_collect(codes, lengths):
        return collect_matches_sortjoin(dm, codes, lengths, uniform_len=100)

    classify = make_sortjoin_classifier(dm, G)

    def full_classify(codes, lengths):
        out, _, _ = classify(codes, lengths, with_rcounts=True,
                             sc_mode=False, uniform_len=100)
        return out

    stages = [
        ("prep (rc+pack+hash)", jax.jit(prep)),
        ("+join keys", jax.jit(joinkeys)),
        ("+2-key sort", jax.jit(to_sort)),
        ("+scan", jax.jit(to_scan)),
        ("+compaction sort", jax.jit(to_compact)),
        ("full collect", jax.jit(full_collect)),
        ("full classify+rcounts", full_classify),
    ]
    prev = 0.0
    for name, fn in stages:
        ms = timeit(fn, codes_d, lengths_d)
        print(f"{name:28s} {ms:8.3f} ms  (+{ms - prev:7.3f})")
        prev = ms


if __name__ == "__main__":
    main()
