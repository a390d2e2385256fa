"""Smoke run of the product path (build -> query -> quantify) on NVIDIA GPUs.

    python chip_smoke.py           # one card, every phase below
    python chip_smoke.py --multi   # four cards: -t 4 and --model_shards 4
                                   # against one card, same outputs

One card, in order; any failure exits non-zero:
  0  device: JAX must report platform 'gpu' (no CPU fallback);
  1  index: the config-#3 deployment (1000 synthetic genomes x 300 kb,
     k=26 L=100 Lmax=50 h=26) written as FASTA + genome_map.out, built by
     `cammiq_tpu.cli --build --both` with the native C++ engine, merged by
     `cammiq_tpu.index.artifact`; cached under bench_cache/ by shape;
  2  reads: 1,000,000 simulated 100 bp reads (e=0.01, lognormal over 50
     of the genomes, fixed seed) by `cammiq_tpu.tools.simulate`;
  3  quantification end to end: `python -m cammiq_tpu.cli --query`;
  4  identification: the same query with --read_cnts and with
     --read_cnts --doubly_unique;
  5  comparison with the plain references (tolerances below);
  6  batch shape: steady-state passes of a query session at B=8192 (the
     bloom join: NB > 4N) and B=65536 (the CLI default; the sort join at
     this index size).

The card runs one process at a time: this process never opens it, and the
GPU steps run in subprocesses one after another, on a quiet host.  Only
then do the CPU reference (subprocesses with JAX_PLATFORMS=cpu, which
never open the card) and the scalar oracle run.

Tolerances (phase 5):
  (a) counts, rcounts and pair counts over all reads, GPU vs CPU: exact,
      for the CLI's three modes and for sessions at each batch shape;
  (b) the first ORACLE_READS reads, GPU at each batch shape vs the scalar
      oracle (tests/query_oracle.py) on the build's .npz tables: exact;
  (c) --read_cnts and --doubly_unique outputs, GPU vs CPU: byte-identical;
  (d) quantification, GPU vs CPU: the same reported genomes and
      max |abundance difference| <= ABUNDANCE_TOL.  The QP's dots run at
      HIGHEST precision; what remains is the summation order of the GPU's
      atomic scatter-adds.

The last line of stdout is {"ok": true, "device": {...}}; everything else
comes before it.  Subprocess logs stay in the run directory.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import threading
import time

import numpy as np

from cammiq_tpu.utils.jitcache import cache_dir, enable_persistent_cache

REPO = os.path.dirname(os.path.abspath(__file__))

GENOMES, GLEN = 1000, 300_000
K, L, LMAX, H = 26, 100, 50, 26
N_READS, ERATE, SIM_GENOMES, SEED = 1_000_000, 0.01, 50, 7
ORACLE_READS = 2000
ABUNDANCE_TOL = 1e-3
BATCH_SHAPES = (8192, 65536)
DEADLINE_S = 1150          # the whole run, compilation included
MULTI_CARDS = 4
# --multi compares the identification output (--read_cnts
# --doubly_unique): an exact per-genome integer table that the unique and
# pair cases both feed.  The quant mode would add its solve, which does
# not depend on the mesh, to each of the three runs.
MULTI_MODE = "doubly"

T0 = time.monotonic()


def say(msg: str) -> None:
    print(msg, flush=True)


def remaining() -> float:
    left = DEADLINE_S - (time.monotonic() - T0)
    if left <= 0:
        raise TimeoutError(f"smoke exceeded its {DEADLINE_S} s budget")
    return left


class Job:
    """One subprocess with its output in a log file.  Every started job is
    listed in RUNNING until it ends, so that main() can stop them all."""

    def __init__(self, cmd, log: str, env=None):
        self.cmd, self.log, self.t0 = cmd, log, time.monotonic()
        self._out = open(log, "w")
        self.proc = subprocess.Popen(cmd, cwd=REPO, env=env,
                                     stdout=self._out,
                                     stderr=subprocess.STDOUT)
        self.t_end = None
        # notes when the process ends, however late finish() is called
        self._reaper = threading.Thread(target=self._reap, daemon=True)
        self._reaper.start()
        RUNNING.append(self)

    def _reap(self) -> None:
        self.proc.wait()
        self.t_end = time.monotonic()

    def finish(self) -> float:
        """Wait for the end; raise on a non-zero exit.  Returns its wall
        seconds, start to exit."""
        try:
            self._reaper.join(timeout=remaining())
            if self._reaper.is_alive():
                raise TimeoutError(f"{self.cmd[:3]} still running at the "
                                   f"smoke's {DEADLINE_S} s budget")
            rc = self.proc.returncode
        finally:
            self.stop()
        if rc != 0:
            with open(self.log) as f:
                tail = f.read()[-4000:]
            raise RuntimeError(f"{' '.join(map(str, self.cmd))} exited {rc}; "
                               f"log {self.log}:\n{tail}")
        return self.t_end - self.t0

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self._reaper.join()
        self._out.close()
        if self in RUNNING:
            RUNNING.remove(self)


RUNNING: list = []


def run(cmd, log: str, env=None) -> float:
    return Job(cmd, log, env).finish()


def cpu_env() -> dict:
    return dict(os.environ, JAX_PLATFORMS="cpu")


def log_value(log: str, prefix: str) -> str:
    """The text after `prefix` on the last log line that starts with it."""
    val = None
    with open(log) as f:
        for line in f:
            if line.startswith(prefix):
                val = line[len(prefix):].strip().rstrip(".")
    if val is None:
        raise RuntimeError(f"{log}: no line starting {prefix!r}")
    return val


# ------------------------------------------------------------- phase 0

def probe_device(n_cards: int) -> dict:
    code = ("import json, jax; d = jax.devices(); print(json.dumps("
            "{'platform': d[0].platform, 'kind': d[0].device_kind, "
            "'count': len(d), 'jax': jax.__version__}))")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        raise RuntimeError(f"device probe failed:\n{r.stderr[-4000:]}")
    dev = json.loads(r.stdout.strip().splitlines()[-1])
    if dev["platform"] != "gpu":
        raise SystemExit(f"chip_smoke: JAX reports platform "
                         f"{dev['platform']!r}, not 'gpu'; this smoke runs "
                         f"only on an NVIDIA GPU")
    if dev["count"] < n_cards:
        raise SystemExit(f"chip_smoke: needs {n_cards} GPUs, JAX reports "
                         f"{dev['count']}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    say(f"[0] nvidia-smi: {smi.stdout.strip()}")
    say(f"[0] jax {dev['jax']}; devices {dev['count']} x {dev['kind']}")
    say(f"[0] XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    say(f"[0] compile cache: {cache_dir()}")
    return dev


# ------------------------------------------------------------- phase 1-2

def shape_dir() -> str:
    return os.path.join(REPO, "bench_cache",
                        f"g{GENOMES}_l{GLEN // 1000}k_k{K}_L{L}_Lmax{LMAX}"
                        f"_h{H}")


def write_genomes(gdir: str) -> str:
    """FASTA files + genome_map.out for the synthetic deployment."""
    from benchmarks.build_scale import gen_genomes

    os.makedirs(gdir, exist_ok=True)
    rows = []
    for i, (seq,) in enumerate(gen_genomes(GENOMES, GLEN), start=1):
        fn = f"g{i:05d}.fa"
        with open(os.path.join(gdir, fn), "wb") as f:
            f.write(b">g%05d\n" % i + seq + b"\n")
        rows.append(f"{fn}\t{i}\t{100000 + i}\tgenome_{i}\n")
    mp = os.path.join(gdir, "genome_map.out")
    with open(mp + ".tmp", "w") as f:
        f.writelines(rows)
    os.replace(mp + ".tmp", mp)
    return mp


def ensure_inputs(sdir: str) -> dict:
    """Phases 1-2: the index and the reads, each built unless cached.  The
    simulator (one host core) runs beside the build."""
    gdir = os.path.join(sdir, "genomes")
    idx = os.path.join(sdir, "index")
    merged = os.path.join(sdir, "merged")
    rdir = os.path.join(sdir, f"reads_n{N_READS}_e{ERATE}_s{SEED}")
    paths = {"map": os.path.join(gdir, "genome_map.out"), "gdir": gdir,
             "idx_u": os.path.join(idx, "index_u.npz"),
             "idx_d": os.path.join(idx, "index_d.npz"), "merged": merged,
             "fq": os.path.join(rdir, "reads.fq"),
             "truth": os.path.join(rdir, "truth.out")}
    have_index = os.path.exists(os.path.join(merged, "meta.json"))
    have_reads = os.path.exists(paths["truth"])
    if not os.path.exists(paths["map"]):
        t = time.monotonic()
        write_genomes(gdir)
        say(f"[1] corpus: {GENOMES} FASTA files written in "
            f"{time.monotonic() - t:.1f} s")
    sim = None
    if not have_reads:
        os.makedirs(rdir, exist_ok=True)
        sim = Job([sys.executable, "-m", "cammiq_tpu.tools.simulate",
                   "-f", paths["map"], "-D", gdir, "-o", paths["fq"],
                   "-r", paths["truth"] + ".tmp", "-n", str(N_READS),
                   "-l", str(L), "-e", str(ERATE), "--dist", "lognormal",
                   "-m", str(SIM_GENOMES), "--seed", str(SEED)],
                  os.path.join(rdir, "simulate.log"), env=cpu_env())
    if have_index:
        say(f"[1] index: cached at {merged}")
    else:
        from cammiq_tpu import native

        # fail fast: without the C++ engine the build falls back to numpy,
        # which at this size takes far longer than the whole budget
        t = time.monotonic()
        if not (native.available() and native.has_sweeps()
                and native.has_bsort()):
            raise RuntimeError("the native C++ build engine is unavailable "
                               "(make's output is above)")
        say(f"[1] native engine ready in {time.monotonic() - t:.1f} s")
        log = os.path.join(sdir, "build.log")
        secs = run([sys.executable, "-m", "cammiq_tpu.cli", "--build",
                    "--both", "-f", paths["map"], "-D", gdir,
                    "-k", str(K), "-L", str(L), "-Lmax", str(LMAX),
                    "-h", str(H), "-i", paths["idx_u"], paths["idx_d"]],
                   log, env=cpu_env())
        engine = log_value(log, "Build engine:")
        say(f"[1] build: {secs:.1f} s; engine {engine}")
        if not engine.startswith("native (C++ sweeps)"):
            raise RuntimeError(f"the build did not run the native C++ "
                               f"engine ({engine}); see {log}")
        secs = run([sys.executable, "-m", "cammiq_tpu.index.artifact",
                    "-i", paths["idx_u"], paths["idx_d"], "-o", merged],
                   os.path.join(sdir, "artifact.log"), env=cpu_env())
        say(f"[1] merged artifact: {secs:.1f} s")
    with open(os.path.join(merged, "meta.json")) as f:
        meta = json.load(f)
    say(f"[1] entries: unique {meta['eu']}, doubly {meta['ed']}, merged "
        f"E={meta['E']} NB={meta['NB']} max_bucket={meta['max_bucket']} "
        f"n_colors={meta['n_colors']}")
    if sim is None:
        say(f"[2] reads: cached at {paths['fq']}")
    else:
        secs = sim.finish()
        os.replace(paths["truth"] + ".tmp", paths["truth"])
        say(f"[2] simulate: {secs:.1f} s, start to exit (beside the build)")
    return paths


def easy_threshold(merged: str) -> int:
    """One above the largest per-genome unique L-mer count, so that the
    prefilter keeps the candidates that reads support."""
    nus = np.loadtxt(os.path.join(merged, "unique_lmer_count_u.out"),
                     dtype=np.int64, ndmin=2)[:, 1]
    return int(nus.max()) + 1


def query_argv(paths: dict, out: str, mode: str, fq: str | None = None):
    argv = ["--query", "-f", paths["map"], "-i", paths["merged"],
            "-q", fq or paths["fq"], "-o", out, "-e", str(ERATE),
            "--easy_to_identify_thres", str(easy_threshold(paths["merged"]))]
    return argv + {"quant": [], "read_cnts": ["--read_cnts"],
                   "doubly": ["--read_cnts", "--doubly_unique"]}[mode]


# ------------------------------------------------------------- workers

MODES = ("quant", "read_cnts", "doubly")


def counts_arrays(prefix: str, c) -> dict:
    pairs = sorted(c.pair_counts.items())
    return {
        f"{prefix}cnts_u": c.cnts_u, f"{prefix}cnts_d": c.cnts_d,
        f"{prefix}rcount_u": c.rcount_u, f"{prefix}rcount_d": c.rcount_d,
        f"{prefix}nundet": np.int64(c.nundet),
        f"{prefix}nconf": np.int64(c.nconf),
        f"{prefix}pairs": np.asarray([(a, b, n) for (a, b), n in pairs],
                                     np.int64).reshape(-1, 3),
    }


def worker(spec: dict) -> None:
    """One process on one platform.  Runs each of spec["modes"] through
    the CLI's `run_query` (output file + counts); on the GPU it then runs,
    for each of BATCH_SHAPES, a query session over all reads in both
    classify modes, a timed second pass, the first ORACLE_READS reads
    alone, and the compiled step's memory analysis.  Writes <out>.npz and
    <out>.json."""
    import jax

    from cammiq_tpu import cli
    from cammiq_tpu.utils.timing import CompileMeter

    enable_persistent_cache()
    platform = jax.devices()[0].platform
    if platform != spec["platform"]:
        raise RuntimeError(f"worker wants {spec['platform']}, JAX reports "
                           f"{platform}")
    paths = spec["paths"]
    arrays, info = {}, {}
    for mode in spec["modes"]:
        out = os.path.join(spec["dir"], f"{mode}.out")
        t = time.perf_counter()
        with CompileMeter() as m:
            (counts,) = cli.run_query(cli.parse_args(
                query_argv(paths, out, mode)))
        info[mode] = {"seconds": time.perf_counter() - t,
                      "compile_s": m.seconds, "cache_hits": m.cache_hits}
        arrays.update(counts_arrays(f"{mode}_", counts))
    if platform == "gpu":
        from cammiq_tpu.index.artifact import load_merged_artifact

        art, rs = load_merged_artifact(paths["merged"]), _reads(paths)
        info["batch_shapes"] = {}
        for B in BATCH_SHAPES:
            a, info["batch_shapes"][str(B)] = batch_shape(art, paths, rs, B)
            arrays.update(a)
    np.savez(spec["out"] + ".npz", **arrays)
    with open(spec["out"] + ".json", "w") as f:
        json.dump(info, f)


def genome_slots(paths: dict) -> int:
    from cammiq_tpu.io.mapfile import load_smap

    return load_smap(paths["map"]).n_species + 1


def _reads(paths: dict):
    from cammiq_tpu.io.fastq import ReadSet, read_fastq

    rs = read_fastq(paths["fq"])
    w = int(rs.lengths.max())
    return ReadSet(codes=rs.codes[:, :w], lengths=rs.lengths,
                   total_len=rs.total_len, name=rs.name)


def oracle_slice(rs, B: int):
    """The first ORACLE_READS reads, padded with empty reads to B so that
    a session runs its batch-B program on them."""
    from cammiq_tpu.io.fastq import ReadSet

    codes = np.zeros((B, rs.codes.shape[1]), rs.codes.dtype)
    lengths = np.zeros(B, rs.lengths.dtype)
    codes[:ORACLE_READS] = rs.codes[:ORACLE_READS]
    lengths[:ORACLE_READS] = rs.lengths[:ORACLE_READS]
    return ReadSet(codes=codes, lengths=lengths,
                   total_len=int(lengths.sum()), name="oracle_slice")


def batch_shape(art, paths: dict, rs, B: int) -> tuple:
    """A query session with batch_size=B over all reads: quant-mode counts
    (with rcounts), a timed second pass, sc-mode counts (pairs), the
    oracle slice in both modes, and the compiled step's memory analysis.
    Returns (count arrays, info)."""
    from cammiq_tpu.config import QueryConfig
    from cammiq_tpu.query.pipeline import QuerySession

    t = time.perf_counter()
    sess = QuerySession.from_artifact(
        art, genome_slots(paths),
        QueryConfig(h=art.h, erate=ERATE, batch_size=B))
    sess.wait_ready()
    start_s = time.perf_counter() - t
    arrays = counts_arrays(f"b{B}_quant_", sess.run(rs, sc_mode=False))
    t = time.perf_counter()
    sess.run(rs, sc_mode=False)   # ends in one device_get: synchronised
    secs = time.perf_counter() - t
    arrays.update(counts_arrays(f"b{B}_doubly_", sess.run(rs, sc_mode=True)))
    sl = oracle_slice(rs, B)
    arrays.update(counts_arrays(f"b{B}_slice_", sess.run(sl, sc_mode=False)))
    arrays[f"b{B}_slice_sc_pairs"] = counts_arrays(
        "", sess.run(sl, sc_mode=True))["pairs"]
    mem = step_memory(art, genome_slots(paths), rs, B)
    n_batches = -(-rs.num_reads // B)
    return arrays, {
        "session_start_s": start_s, "pass_s": secs, "batches": n_batches,
        "ms_per_batch": secs / n_batches * 1e3,
        "reads_per_s": rs.num_reads / secs,
        "bloom_join": bool(art.NB > 4 * B * (L - H + 1)),
        "temp_bytes": int(mem.temp_size_in_bytes),
        "argument_bytes": int(mem.argument_size_in_bytes),
        "output_bytes": int(mem.output_size_in_bytes),
    }


def step_memory(art, G: int, rs, B: int):
    """memory_analysis() of one quant-mode classify step at batch B, as
    XLA compiles it for this device, with the index as arguments."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from cammiq_tpu.query.sortjoin import (make_sortjoin_classifier,
                                           to_device_merged_artifact)

    dm = to_device_merged_artifact(art)
    arrays = {f.name: getattr(dm, f.name) for f in dataclasses.fields(dm)
              if isinstance(getattr(dm, f.name), jax.Array)}

    def step(arrays, codes, lengths):
        # the session's capacity at this index size (QuerySession)
        classify = make_sortjoin_classifier(
            dataclasses.replace(dm, **arrays), G, maxm=16)
        return classify(codes, lengths)

    codes = jnp.asarray(rs.codes[:B])
    lengths = jnp.asarray(rs.lengths[:B])
    return jax.jit(step).lower(arrays, codes, lengths).compile() \
        .memory_analysis()


def start_worker(platform: str, modes, paths: dict, rdir: str,
                 name: str) -> Job:
    out = os.path.join(rdir, f"worker_{name}")
    wdir = os.path.join(rdir, platform)
    os.makedirs(wdir, exist_ok=True)
    spec = {"platform": platform, "modes": list(modes), "paths": paths,
            "dir": wdir, "out": out}
    code = ("import json, sys, chip_smoke; "
            "chip_smoke.worker(json.loads(sys.argv[1]))")
    job = Job([sys.executable, "-c", code, json.dumps(spec)], out + ".log",
              env=cpu_env() if platform == "cpu" else None)
    job.out = out
    return job


def worker_results(job: Job) -> tuple:
    """(count arrays, info) a finished worker wrote."""
    with open(job.out + ".json") as f:
        info = json.load(f)
    return dict(np.load(job.out + ".npz")), info


# ------------------------------------------------------------- phase 5

COUNT_KEYS = ("cnts_u", "cnts_d", "rcount_u", "rcount_d", "nundet", "nconf",
              "pairs")


def compare_counts(got: dict, want: dict, keys=COUNT_KEYS) -> list:
    """Names of the count arrays that differ (shape or any value)."""
    bad = []
    for k in keys:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        if a.shape != b.shape or not np.array_equal(a, b):
            bad.append(k)
    return bad


def describe_diff(got: dict, want: dict, keys) -> str:
    """How the named count arrays differ, for the failure message."""
    out = []
    for k in keys:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        if a.shape != b.shape:
            out.append(f"{k}: shape {a.shape} vs {b.shape}")
        else:
            d = a.astype(np.int64) - b.astype(np.int64)
            out.append(f"{k}: {int(np.count_nonzero(d))} of {d.size} "
                       f"differ, sum {int(d.sum())}, sum|d| "
                       f"{int(np.abs(d).sum())}")
    return "; ".join(out)


def oracle_counts(paths: dict, n: int) -> dict:
    """The scalar oracle on the first n reads, in the worker's layout."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from query_oracle import oracle_classify

    from cammiq_tpu.index.table import load_flat_index_pair
    from cammiq_tpu.io.fastq import read_fastq

    iu, idd = load_flat_index_pair(paths["idx_u"], paths["idx_d"])
    rs = read_fastq(paths["fq"])
    o = oracle_classify(iu, idd, rs.codes[:n], rs.lengths[:n],
                        genome_slots(paths))
    return oracle_layout(o, iu.num_entries, idd.num_entries)


def oracle_layout(o: dict, eu: int, ed: int) -> dict:
    """tests/query_oracle.py's result in the worker's count layout."""
    pairs = sorted(o["pair_counts"].items())
    return {
        "cnts_u": o["cnts_u"], "cnts_d": o["cnts_d"],
        "rcount_u": o["rcount_u"][:eu], "rcount_d": o["rcount_d"][:ed],
        "nundet": np.int64(o["nundet"]), "nconf": np.int64(o["nconf"]),
        "pairs": np.asarray([(a, b, c) for (a, b), c in pairs],
                            np.int64).reshape(-1, 3),
    }


def strip(prefix: str, d: dict) -> dict:
    return {k[len(prefix):]: v for k, v in d.items() if k.startswith(prefix)}


def quant_table(path: str) -> dict:
    from cammiq_tpu.models.output import parse_quant_output

    (block,) = parse_quant_output(path)
    return {taxid: ab for taxid, ab, _ in block["rows"]}


def truth_l1(quant: dict, truth_path: str) -> float:
    truth = {}
    with open(truth_path) as f:
        for line in f:
            gid, ab = line.split()
            truth[100000 + int(gid)] = float(ab)
    keys = set(truth) | set(quant)
    return sum(abs(quant.get(k, 0.0) - truth.get(k, 0.0)) for k in keys)


def same_bytes(a: str, b: str) -> bool:
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


# ------------------------------------------------------------- main

def cache_label(compile_line: str) -> str:
    """'cold' or 'warm' from the CLI's 'N persistent-cache hits'."""
    m = re.search(r"\((\d+) persistent-cache hits\)", compile_line)
    if m is None:
        raise RuntimeError(f"no cache-hit count in {compile_line!r}")
    return "warm" if int(m.group(1)) else "cold"


def single_card() -> dict:
    dev = probe_device(1)
    sdir = shape_dir()
    paths = ensure_inputs(sdir)
    rdir = os.path.join(sdir, "smoke")
    os.makedirs(rdir, exist_ok=True)

    # 3: the CLI end to end, as a user runs it
    quant_out = os.path.join(rdir, "quant.out")
    log = os.path.join(rdir, "cli_quant.log")
    secs = run([sys.executable, "-m", "cammiq_tpu.cli"]
               + query_argv(paths, quant_out, "quant"), log)
    compiled = log_value(log, "Time for compiling:")
    say(f"[3] cli --query: {secs:.1f} s wall; session start "
        f"{log_value(log, 'Time for session start:')}; query "
        f"{log_value(log, 'Time for query:')}; compile "
        f"({cache_label(compiled)} cache) {compiled}; solve "
        f"{log_value(log, 'Time for quantification:')}; "
        f"{log_value(log, 'Number of unlabeled reads:')} unlabeled")

    # 4 and 6, and the GPU's counts for 5: one worker, alone on the host
    gjob = start_worker("gpu", MODES, paths, rdir, "gpu")
    secs = gjob.finish()
    gpu, ginfo = worker_results(gjob)
    say(f"[4] GPU worker: {secs:.1f} s")
    for mode in MODES:
        i = ginfo[mode]
        say(f"[4] {mode}: {i['seconds']:.1f} s in the GPU worker; compile "
            f"{i['compile_s']:.1f} s ({i['cache_hits']} persistent-cache "
            f"hits)")
    for B, r in ginfo["batch_shapes"].items():
        say(f"[6] B={B} ({'bloom' if r['bloom_join'] else 'sort'} join): "
            f"{r['ms_per_batch']:.3f} ms/batch, {r['reads_per_s']:.0f} "
            f"reads/s ({r['batches']} batches in {r['pass_s']:.3f} s, "
            f"second pass); session start {r['session_start_s']:.1f} s; "
            f"step temp {r['temp_bytes']} B, args {r['argument_bytes']} B, "
            f"out {r['output_bytes']} B")

    # then the host-side references: the CPU run, one process per mode
    # (XLA's CPU sorts use few cores; none opens the card), and the
    # scalar oracle in this process
    t = time.monotonic()
    cjobs = [start_worker("cpu", [m], paths, rdir, f"cpu_{m}")
             for m in MODES]
    want = oracle_counts(paths, ORACLE_READS)
    say(f"[5] scalar oracle: {time.monotonic() - t:.1f} s")
    cpu = {}
    for job in cjobs:
        job.finish()
        cpu.update(worker_results(job)[0])
    gdir, cdir = os.path.join(rdir, "gpu"), os.path.join(rdir, "cpu")
    say(f"[5] CPU reference workers done at {time.monotonic() - t:.1f} s")

    # 5a: every count over all reads, GPU vs CPU, exact
    pairs = [(f"{m}_", f"{m}_") for m in MODES]
    for B in BATCH_SHAPES:
        pairs += [(f"b{B}_quant_", "quant_"), (f"b{B}_doubly_", "doubly_")]
    failed = []

    def gate(ok: bool, msg: str) -> None:
        say(msg if ok else f"FAILED {msg}")
        failed.extend([] if ok else [msg.split(":")[0]])

    for gp, cp in pairs:
        g, c = strip(gp, gpu), strip(cp, cpu)
        bad = compare_counts(g, c)
        gate(not bad, f"[5a] {gp[:-1]}: GPU vs CPU over all reads: "
             + (describe_diff(g, c, bad) if bad else "exact"))

    # 5b: the first ORACLE_READS reads, GPU vs the scalar oracle, exact
    for B in BATCH_SHAPES:
        got = strip(f"b{B}_slice_", gpu)
        oq = dict(want, pairs=np.zeros((0, 3), np.int64))
        bad = compare_counts(got, oq)
        msg = describe_diff(got, oq, bad)
        if compare_counts({"pairs": got["sc_pairs"]}, want, ("pairs",)):
            bad.append("sc pairs")
            msg += (f"; sc pairs: {len(got['sc_pairs'])} vs "
                    f"{len(want['pairs'])} rows")
        gate(not bad, f"[5b] B={B}: first {ORACLE_READS} reads, GPU vs "
             f"scalar oracle: " + (msg if bad else "exact"))

    # 5c: identification outputs byte-identical
    for mode in ("read_cnts", "doubly"):
        ok = same_bytes(os.path.join(gdir, f"{mode}.out"),
                        os.path.join(cdir, f"{mode}.out"))
        gate(ok, f"[5c] {mode}.out, GPU vs CPU: "
             + ("byte-identical" if ok else "differs"))

    # 5d: quantification within ABUNDANCE_TOL
    qg = quant_table(quant_out)
    qc = quant_table(os.path.join(cdir, "quant.out"))
    gate(set(qg) == set(qc) and bool(qg),
         f"[5d] quant genome set: GPU {len(qg)}, CPU {len(qc)}, GPU-only "
         f"{sorted(set(qg) - set(qc))}, CPU-only {sorted(set(qc) - set(qg))}")
    dmax = max((abs(qg[k] - qc.get(k, 0.0)) for k in qg), default=0.0)
    rerun = same_bytes(quant_out, os.path.join(gdir, "quant.out"))
    gate(dmax <= ABUNDANCE_TOL,
         f"[5d] quant: max |dAbund| GPU vs CPU {dmax:.3g} (limit "
         f"{ABUNDANCE_TOL}); L1 to truth GPU "
         f"{truth_l1(qg, paths['truth']):.4f}, CPU "
         f"{truth_l1(qc, paths['truth']):.4f}; second GPU run "
         f"{'byte-identical' if rerun else 'differs in its printed digits'}")
    if failed:
        raise AssertionError(f"phase 5 failed: {failed}")
    return dev


def multi_card() -> dict:
    dev = probe_device(MULTI_CARDS)
    sdir = shape_dir()
    paths = ensure_inputs(sdir)
    rdir = os.path.join(sdir, "smoke_multi")
    os.makedirs(rdir, exist_ok=True)
    outs = {}
    for name, extra in (("single", []),
                        ("t4", ["-t", str(MULTI_CARDS)]),
                        ("ms4", ["--model_shards", str(MULTI_CARDS)])):
        outs[name] = os.path.join(rdir, f"{name}.out")
        log = os.path.join(rdir, f"{name}.log")
        secs = run([sys.executable, "-m", "cammiq_tpu.cli"]
                   + query_argv(paths, outs[name], MULTI_MODE) + extra, log)
        compiled = log_value(log, "Time for compiling:")
        if extra:   # the mesh the CLI built, or it fell back to one card
            say(f"[m] {name}: mesh "
                f"{log_value(log, 'Distributed query mesh:')}")
        say(f"[m] {name}: {secs:.1f} s wall; session start "
            f"{log_value(log, 'Time for session start:')}; query "
            f"{log_value(log, 'Time for query:')}; compile "
            f"({cache_label(compiled)} cache) {compiled}")
        # compared at once, so that a run cut short keeps what it showed
        if extra and not same_bytes(outs[name], outs["single"]):
            raise AssertionError(f"[m] {name} output differs from the "
                                 f"single-card output")
        if extra:
            say(f"[m] {name}: output byte-identical to the single card's")
    say(f"[m] --read_cnts --doubly_unique with -t {MULTI_CARDS} and with "
        f"--model_shards {MULTI_CARDS}: outputs byte-identical to the "
        f"single-card output")
    return dev


def main(argv) -> int:
    multi = argv == ["--multi"]
    if argv and not multi:
        raise SystemExit("usage: python chip_smoke.py [--multi]")
    say(f"chip_smoke: config #3 deployment, {GENOMES} genomes x "
        f"{GLEN // 1000} kb, k={K} L={L} Lmax={LMAX} h={H}; {N_READS} reads "
        f"of {L} bp, e={ERATE}, lognormal over {SIM_GENOMES} genomes"
        + (f"; {MULTI_CARDS} cards" if multi else "; one card"))
    try:
        dev = multi_card() if multi else single_card()
    finally:
        for job in list(RUNNING):
            job.stop()
    say(json.dumps({"ok": True, "device": {
        "platform": dev["platform"], "kind": dev["kind"],
        "count": dev["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
