"""Benchmark: sort-join classification throughput on one device, at
production index scale.

Builds (once, cached under bench_cache/) a 1000-genome index — BASELINE
config-#3 shape: ~600 MB corpus incl. reverse complements, several
million unique entries — persists the merged query artifact
(index/artifact.py), then measures the steady-state jitted
classify step on batches of simulated reads.

Prints ONE JSON line:
  {"metric": "reads_per_sec_per_chip", "value": N, "unit": "reads/s",
   ...supporting fields...}

Env knobs:
  CAMMIQ_BENCH_TOY=1        round-1/2 toy index (64 genomes x 50 kb)
  CAMMIQ_BENCH_GENOMES / CAMMIQ_BENCH_GLEN   override the corpus shape
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

BENCH_GENOMES = int(os.environ.get("CAMMIQ_BENCH_GENOMES", "1000"))
BENCH_GLEN = int(os.environ.get("CAMMIQ_BENCH_GLEN", "300000"))


def log(msg: str) -> None:
    print(f"# {msg}", file=sys.stderr, flush=True)


def bench_cache_dir() -> str:
    return os.path.join(
        REPO, "bench_cache", f"g{BENCH_GENOMES}_l{BENCH_GLEN // 1000}k")


def gen_bench_genomes():
    from benchmarks.build_scale import gen_genomes

    return gen_genomes(BENCH_GENOMES, BENCH_GLEN)


def ensure_production_index() -> str:
    """Build + persist the merged artifact once; return its directory."""
    cdir = bench_cache_dir()
    mdir = os.path.join(cdir, "merged")
    if os.path.exists(os.path.join(mdir, "meta.json")):
        return mdir

    from cammiq_tpu.config import BuildConfig
    from cammiq_tpu.index.artifact import prepare_merged
    from cammiq_tpu.index.builder import build_index, save_index
    from cammiq_tpu.io.fasta import corpus_from_sequences

    t0 = time.time()
    genomes = gen_bench_genomes()
    corpus = corpus_from_sequences(genomes)
    del genomes
    log(f"bench corpus: {corpus.n / 1e9:.3f} GB "
        f"({BENCH_GENOMES} genomes x {BENCH_GLEN / 1e3:.0f} kb + RC)")
    cfg = BuildConfig(k=26, L=100, Lmax=50, h=26, mode="both")
    art = build_index(corpus, cfg, engine="auto", verbose=True)
    save_index(art, cdir)
    log(f"index built in {time.time() - t0:.1f}s: "
        f"unique={art.unique_index.num_entries} "
        f"doubly={art.doubly_index.num_entries} entries")
    del art, corpus
    t1 = time.time()
    prepare_merged(os.path.join(cdir, "index_u.npz"),
                   os.path.join(cdir, "index_d.npz"), mdir, verbose=True)
    log(f"merged artifact prepared in {time.time() - t1:.1f}s")
    return mdir


def sample_read_batch(rng, genomes, batch, L=100, Lpad=100, erate=0.01,
                      rc_frac=0.5):
    from cammiq_tpu.ops.packing import SYMBOL_IDX

    num = len(genomes)
    codes = np.zeros((batch, Lpad), np.int8)
    lengths = np.full(batch, L, np.int32)
    gsel = rng.integers(0, num, size=batch)
    for b in range(batch):
        c = genomes[gsel[b]][0]
        p = int(rng.integers(0, len(c) - L))
        arr = SYMBOL_IDX[np.frombuffer(c[p : p + L], np.uint8)]
        codes[b, :L] = arr
    errs = rng.random((batch, L)) < erate
    codes[:, :L] = np.where(errs, rng.integers(0, 4, size=(batch, L)),
                            codes[:, :L])
    # reverse-complement half the reads (production read sets hit both
    # strands; the classifier handles RC via the key augmentation)
    flip = rng.random(batch) < rc_frac
    rc = (3 - codes[flip, :L])[:, ::-1]
    codes[flip, :L] = rc
    return codes, lengths


# ---------------------------------------------------------------- toy path

def build_toy_index(num_genomes=64, glen=50_000, seed=0):
    from cammiq_tpu.config import BuildConfig
    from cammiq_tpu.index.builder import build_index
    from cammiq_tpu.io.fasta import corpus_from_sequences

    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8)
    shared = rng.integers(0, 4, size=glen // 5)
    genomes = []
    for g in range(num_genomes):
        own = rng.integers(0, 4, size=glen)
        ins = int(rng.integers(0, glen - len(shared)))
        seq = np.concatenate([own[:ins], shared, own[ins:]])
        genomes.append([alpha[seq].tobytes()])
    corpus = corpus_from_sequences(genomes)
    cfg = BuildConfig(k=26, L=100, Lmax=50, h=26, mode="both")
    art = build_index(corpus, cfg, engine="auto")
    return genomes, art


def main():
    import jax
    import jax.numpy as jnp

    from cammiq_tpu.utils.jitcache import enable_persistent_cache

    enable_persistent_cache()

    toy = os.environ.get("CAMMIQ_BENCH_TOY", "") == "1"
    rng = np.random.default_rng(1)
    t0 = time.time()
    extra = {}

    if toy:
        genomes, art = build_toy_index()
        from cammiq_tpu.query.sortjoin import (
            build_merged_index, make_sortjoin_classifier, to_device_merged)

        dm = to_device_merged(build_merged_index(art.unique_index,
                                                 art.doubly_index))
        G = len(genomes) + 1
        log(f"toy index: unique={art.unique_index.num_entries} "
            f"doubly={art.doubly_index.num_entries}")
    else:
        mdir = ensure_production_index()
        from cammiq_tpu.index.artifact import load_merged_artifact
        from cammiq_tpu.query.sortjoin import (
            make_sortjoin_classifier, to_device_merged_artifact)

        t_sess = time.time()
        artifact = load_merged_artifact(mdir)
        dm = to_device_merged_artifact(artifact)
        session_start_s = time.time() - t_sess
        G = BENCH_GENOMES + 1
        log(f"merged artifact: E={artifact.E} NB={artifact.NB} "
            f"max_bucket={artifact.max_bucket} n_colors={artifact.n_colors}; "
            f"session start (lazy load + device put) {session_start_s:.1f}s")
        extra = {
            "genomes": BENCH_GENOMES,
            "index_entries": int(artifact.E),
            "session_start_s": round(session_start_s, 1),
        }
        genomes = gen_bench_genomes()

    batch = 8192
    # >=8 distinct batch realizations rotated through the steady-state
    # loop: data-dependent costs (sort runs, bloom hit pattern, compaction
    # occupancy) are averaged over batch content instead of measured on
    # one realization (r4 VERDICT weak #5)
    n_batches = 8
    batches = []
    for _ in range(n_batches):
        codes, lengths = sample_read_batch(rng, genomes, batch)
        batches.append((jnp.asarray(codes), jnp.asarray(lengths)))
    codes_d, lengths_d = batches[0]

    def sync(o):
        return jax.block_until_ready(o)

    # warmup doubles as the overflow check: the timed batch repeats this
    # exact batch, so a clean warmup means the steady state is clean too.
    # On overflow, widen capacity like QuerySession._widen and recompile.
    from cammiq_tpu.query.sortjoin import make_sortjoin_classifier as _mk

    # seed capacity from index density like QuerySession does (the
    # 61-77M-row indexes measurably need frac=16; starting at 32 just
    # burns one guaranteed overflow -> recompile cycle per fresh run)
    frac = 16 if (not toy and artifact.NB > (1 << 25)) else 32
    # maxm stays 16 (pipeline default): production mixes realize <= 7
    # distinct matches/read (mean 1.6) so maxm=8 is capacity-safe, but
    # it measured +1% at configs #3/#4 and -3% at #5 — not worth
    # diverging from the product session's shape
    maxm = 16
    tc = time.time()
    while True:
        classify = _mk(dm, G, hit_capacity_frac=frac, maxm=maxm)

        def fn(codes, lengths):
            out, ovh, ovs = classify(codes, lengths, with_rcounts=True,
                                     sc_mode=False, uniform_len=100)
            return out

        # warm up + overflow-check EVERY rotated batch: the steady state
        # replays these exact batches, so all-clean here means clean there
        ovh = ovs = 0
        for cb, lb in batches:
            out, o1, o2 = classify(cb, lb, with_rcounts=True,
                                   sc_mode=False, uniform_len=100)
            sync(out)
            ovh += int(np.asarray(o1))
            ovs += int(np.asarray(o2))
        if not ovh and not ovs:
            break
        log(f"capacity overflow (hits={ovh}, slots={ovs}); widening "
            f"frac {frac}->{max(frac // 2, 1)}" if ovh else
            f"slot overflow; widening maxm {maxm}->{maxm * 2}")
        if ovh:
            frac = max(frac // 2, 1)
        if ovs:
            maxm *= 2
        if frac < 1 or maxm > 4096:
            raise RuntimeError("capacity overflow persists")
    t_compile = time.time() - tc
    log(f"compile+warmup {t_compile:.1f}s (total elapsed {time.time()-t0:.1f}s)")
    extra["compile_s"] = round(t_compile, 1)
    extra["frac"], extra["maxm"] = frac, maxm

    # steady state: enqueue batches, sync every <=256 iters (each sync
    # bounds the number of in-flight output buffers); timing assumes the
    # device executes enqueued programs in order, which holds for the
    # single-stream XLA dispatch used here.  Grow until >= 3 s measured.
    iters = 8
    while True:
        t1 = time.time()
        done = 0
        chunk_ms = []
        while done < iters:
            chunk = min(256, iters - done)
            tch = time.time()
            for i in range(chunk):
                out = fn(*batches[(done + i) % n_batches])
            sync(out)
            chunk_ms.append((time.time() - tch) / chunk * 1000)
            done += chunk
        dt = time.time() - t1
        if dt > 3.0 or iters >= 4096:
            break
        iters *= 4
    reads_per_sec = batch * iters / dt
    classified = int(np.asarray(out.cnts_u).sum() + np.asarray(out.cnts_d).sum() / 2)
    spread = (f"chunk ms min {min(chunk_ms):.2f} max {max(chunk_ms):.2f}"
              if len(chunk_ms) > 1 else "single chunk")
    log(f"{iters} iters in {dt:.2f}s; {classified}/{batch} reads assigned; "
        f"{spread}")
    if len(chunk_ms) > 1:
        extra["batch_ms_min"] = round(min(chunk_ms), 2)
        extra["batch_ms_max"] = round(max(chunk_ms), 2)

    # sc-mode (identification) throughput: the pair binary search
    # (pipeline sc path) was unmeasured at scale before r5
    t_sc = time.time()
    out_sc, _, _ = classify(codes_d, lengths_d, with_rcounts=False,
                            sc_mode=True, uniform_len=100)
    sync(out_sc)
    sc_compile_s = time.time() - t_sc
    sc_iters = max(iters // 4, 8)
    t1 = time.time()
    done = 0
    while done < sc_iters:
        chunk = min(256, sc_iters - done)
        for i in range(chunk):
            out_sc, _, _ = classify(*batches[(done + i) % n_batches],
                                    with_rcounts=False, sc_mode=True,
                                    uniform_len=100)
        sync(out_sc)
        done += chunk
    sc_dt = time.time() - t1
    extra["sc_reads_per_sec"] = round(batch * sc_iters / sc_dt, 1)
    log(f"sc-mode: {sc_iters} iters in {sc_dt:.2f}s "
        f"({extra['sc_reads_per_sec']:.0f} reads/s; compile+warm "
        f"{sc_compile_s:.1f}s)")

    print(json.dumps({
        "metric": "reads_per_sec_per_chip",
        "value": round(reads_per_sec, 1),
        "unit": "reads/s",
        **extra,
    }))


if __name__ == "__main__":
    main()
