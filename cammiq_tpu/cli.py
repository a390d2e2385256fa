"""cammiq-compatible command-line interface.

Mirrors the reference CLI surface (src/main.cpp:48-552):

  cammiq-tpu --build (--unique|--doubly_unique|--both) -f MAP -D DIR \
      [-k K] [-L L] [-Lmax LMAX] [-h H [H2]] [-i IDX_U IDX_D] [-t T] \
      [--exact_sa] [--merged DIR]
  cammiq-tpu --query [--read_cnts [--doubly_unique]] -f MAP \
      -i IDX_U [IDX_D] (-q FASTQ... | -Q DIR) -o OUT [-e ERATE] [-h H] \
      [--read_length_filter N] [fine parameter flags]

Index files use the .npz flat format (plus the three text meta files,
byte-compatible with the reference).
"""

from __future__ import annotations

import os
import sys
import time
from typing import List, Optional

import numpy as np

from .config import BuildConfig, FineParams, IdentFineParams, QueryConfig


def _err(msg: str) -> None:
    print(msg, file=sys.stderr)
    sys.exit(1)


def parse_args(argv: List[str]) -> dict:
    a = {
        "mode": None, "idx_option": None, "id_mode": 0,
        "K": None, "L": None, "Lmax": None, "h": None, "h1": None, "h2": None,
        "fa_dir": "", "fm_name": "", "fq_dir": "", "fq_names": [],
        "fi_u": "", "fi_d": "", "output": "", "erate": 0.0, "t": 1,
        "min_rl": 0, "debug": False,
        "read_cnt_thres": -1.0, "easy_thres": -1.0, "ilp_eps": -1.0,
        "ilp_alpha": -1.0, "max_cov": -1.0,
        "u_thres": -1.0, "d_thres": -1.0,
        "engine": "auto", "profile": "", "model_shards": 1,
        "build_hosts": 0,
        "ilp_time_limit": 10800.0, "ilp_enum_cap": 8, "merged": "",
        "exact_sa": False,
    }
    i = 0
    while i < len(argv):
        v = argv[i]
        if v == "--help":
            print(__doc__)
            sys.exit(0)
        elif v == "--build":
            a["mode"] = 0
        elif v == "--query":
            a["mode"] = 1
        elif v == "--unique":
            if a["mode"] == 0:
                a["idx_option"] = "unique"
        elif v == "--doubly_unique":
            if a["mode"] == 0:
                a["idx_option"] = "doubly_unique"
            else:
                a["id_mode"] = 2
        elif v == "--both":
            a["idx_option"] = "both"
        elif v == "--read_cnts":
            a["id_mode"] = max(a["id_mode"], 1)
        elif v == "--enable_ilp_display":
            a["debug"] = True
        elif v == "--read_length_filter":
            i += 1
            a["min_rl"] = int(argv[i])
        elif v == "--read_cnt_thres":
            i += 1
            a["read_cnt_thres"] = float(argv[i])
        elif v == "--easy_to_identify_thres":
            i += 1
            a["easy_thres"] = float(argv[i])
        elif v == "--ilp_epsilon":
            i += 1
            a["ilp_eps"] = float(argv[i])
        elif v == "--ilp_alpha":
            i += 1
            a["ilp_alpha"] = float(argv[i])
        elif v == "--max_depth":
            i += 1
            a["max_cov"] = float(argv[i])
        elif v == "--merged":
            i += 1
            a["merged"] = argv[i]
        elif v == "--ilp_time_limit":
            i += 1
            a["ilp_time_limit"] = float(argv[i])
        elif v == "--ilp_enum_cap":
            i += 1
            a["ilp_enum_cap"] = int(argv[i])
        elif v == "--unique_read_cnt_thres":
            i += 1
            a["u_thres"] = float(argv[i])
        elif v == "--doubly_unique_read_cnt_thres":
            i += 1
            a["d_thres"] = float(argv[i])
        elif v == "--engine":
            i += 1
            a["engine"] = argv[i]
        elif v == "--exact_sa":
            a["exact_sa"] = True
        elif v == "--model_shards":
            i += 1
            a["model_shards"] = int(argv[i])
        elif v == "--build_hosts":
            i += 1
            a["build_hosts"] = int(argv[i])
        elif v == "--profile":
            i += 1
            a["profile"] = argv[i]
        elif v == "-k":
            i += 1
            a["K"] = int(argv[i])
        elif v == "-L":
            i += 1
            a["L"] = int(argv[i])
        elif v == "-Lmax":
            i += 1
            a["Lmax"] = int(argv[i])
        elif v == "-h":
            vals = []
            while i + 1 < len(argv) and not argv[i + 1].startswith("-"):
                i += 1
                vals.append(int(argv[i]))
            if len(vals) == 1:
                a["h"] = vals[0]
            elif len(vals) >= 2:
                a["h1"], a["h2"] = vals[0], vals[1]
        elif v == "-f":
            i += 1
            a["fm_name"] = argv[i]
        elif v == "-D":
            i += 1
            a["fa_dir"] = argv[i]
        elif v == "-Q":
            i += 1
            a["fq_dir"] = argv[i]
        elif v == "-q":
            while i + 1 < len(argv) and not argv[i + 1].startswith("-"):
                i += 1
                a["fq_names"].append(argv[i])
        elif v == "-i":
            vals = []
            while i + 1 < len(argv) and not argv[i + 1].startswith("-"):
                i += 1
                vals.append(argv[i])
            if vals:
                a["fi_u"] = vals[0]
            if len(vals) > 1:
                a["fi_d"] = vals[1]
        elif v == "-o":
            i += 1
            a["output"] = argv[i]
        elif v == "-e":
            i += 1
            a["erate"] = float(argv[i])
        elif v == "-t":
            i += 1
            a["t"] = int(argv[i])
        else:
            _err(f"Failed to recognize option: {v}.")
        i += 1
    return a


def run_build(a: dict) -> None:
    from .index.builder import build_index, save_index
    from .io.fasta import build_corpus, list_fasta_dir, read_map_file

    cfg = BuildConfig(
        k=a["K"] or 26,
        L=a["L"] or 100,
        Lmax=a["Lmax"] or 50,
        h=a["h"] or a["h1"] or 26,
        h2=a["h2"],
        mode=a["idx_option"] or "both",
        num_groups=min(a["t"], 4),
        # --exact_sa: full SA-IS sort instead of the depth-bounded suffix
        # sort (identical index; deep-repeat skipped-candidate bookkeeping
        # parity, see BuildConfig.bounded_sa)
        bounded_sa=not a["exact_sa"],
    )
    if a["fm_name"]:
        files = read_map_file(a["fm_name"], a["fa_dir"])
        files.sort(key=lambda x: x[0])  # reference std::map path order
    elif a["fa_dir"]:
        files = list_fasta_dir(a["fa_dir"])
    else:
        _err("Please specify a map file (-f) or fasta directory (-D).")
    hosts = a.get("build_hosts", 0)
    use_dist = hosts > 1 and not (cfg.occ_u8_wrap or cfg.unique_if_advance)
    if use_dist:
        from . import native as _native

        use_dist = _native.available() and _native.has_bsort()
    wd = None
    if use_dist:
        # memory-honest cross-host pipeline: the corpus STREAMS to disk
        # (the driver holds O(largest contig)), then sharded sort +
        # distributed merge + chunk-carried sweeps + per-shard
        # selection; identical index to
        # build_index(num_groups=min(hosts,4,M)) (the text shards ARE
        # the reference's per-thread selection groups)
        import tempfile

        from .io.fasta import build_corpus_streaming
        from .parallel.dist_build import dist_build_index

        wd = tempfile.mkdtemp(prefix="cammiq_dist_")
        corpus = build_corpus_streaming(
            files, os.path.join(wd, "src_corpus.bin"))
    else:
        corpus = build_corpus(files)
    print(
        f"****************************\n"
        f"Total num bases: {corpus.n}\n"
        f"Total num genomes: {corpus.num_files}\n"
        f"Total num contigs: {corpus.num_contigs}\n"
        f"****************************",
        file=sys.stderr,
    )
    if use_dist:
        art, rss = dist_build_index(corpus, cfg, hosts, wd, verbose=True)
    else:
        art = build_index(corpus, cfg, engine=a["engine"], verbose=True,
                          sa_hosts=hosts)
    outdir = os.path.dirname(a["fi_u"]) or "."
    from .index.builder import write_meta_outputs
    from .index.table import save_flat_index

    os.makedirs(outdir, exist_ok=True)
    if art.unique_index is not None:
        save_flat_index(a["fi_u"] or os.path.join(outdir, "index_u.npz"),
                        art.unique_index)
    if art.doubly_index is not None:
        save_flat_index(a["fi_d"] or os.path.join(outdir, "index_d.npz"),
                        art.doubly_index)
    write_meta_outputs(art, outdir)
    if a["merged"]:
        # persist the query-ready merged index too (--merged DIR): query
        # sessions then start with a lazy memmap load instead of host
        # lexsorts over the full tables
        if art.unique_index is None:
            _err("--merged requires a unique index (--unique or --both).")
        from .index.artifact import save_merged_artifact
        from .query.sortjoin import build_merged_index

        m = build_merged_index(art.unique_index, art.doubly_index)
        save_merged_artifact(m, art.unique_index, art.doubly_index,
                             a["merged"])
        write_meta_outputs(art, a["merged"])
        print(f"Merged query artifact written to {a['merged']}.",
              file=sys.stderr)
    if wd is not None:
        import shutil

        del art, corpus   # drop the memmap handles before removing
        shutil.rmtree(wd, ignore_errors=True)


def run_query(a: dict) -> list:
    """Classify and solve every query file; returns the QueryCounts of
    each file in order."""
    from .utils.timing import CompileMeter

    with CompileMeter() as meter:
        return _run_query(a, meter)


def _run_query(a: dict, meter) -> list:
    from .index.table import load_flat_index_pair
    from .io.fastq import list_fastq_dir, read_fastq
    from .io.mapfile import load_genome_lengths, load_smap
    from .models import output as outmod
    from .models.ident import solve_ident
    from .models.quant import abundances, build_problem, solve_quant
    from .query.pipeline import QuerySession

    if not a["fi_u"]:
        _err("Please specify index files (-i).")
    from .index.artifact import is_merged_artifact, load_merged_artifact

    t_start = time.perf_counter()
    artifact = None
    if is_merged_artifact(a["fi_u"]):
        # -i MERGED_DIR: precomputed merged-index artifact - lazy memmap
        # load, no session-time lexsorts (index/artifact.py)
        artifact = load_merged_artifact(a["fi_u"])
        index_u, index_d = artifact.payloads()
    else:
        index_u, index_d = load_flat_index_pair(
            a["fi_u"],
            a["fi_d"] if a["fi_d"] and os.path.exists(a["fi_d"]) else None)

    table = load_smap(a["fm_name"])
    idx_dir = (a["fi_u"] if artifact is not None
               else os.path.dirname(a["fi_u"]) or ".")
    need_meta = a["id_mode"] == 0
    if need_meta:
        load_genome_lengths(table, idx_dir, require_doubly=index_d is not None)
    G = table.n_species + 1

    fine = FineParams(
        read_cnt_thres=int(a["read_cnt_thres"]) if a["read_cnt_thres"] > 0 else 100,
        easy_to_identify_thres=int(a["easy_thres"]) if a["easy_thres"] > 0 else 10000,
        ilp_epsilon=a["ilp_eps"] if a["ilp_eps"] > 0 else 0.01,
        ilp_alpha=a["ilp_alpha"] if a["ilp_alpha"] > 0 else 0.0001,
        max_cov=a["max_cov"] if a["max_cov"] > 0 else 100.0,
    )
    identp = IdentFineParams(
        unique_read_cnt_thres=int(a["u_thres"]) if a["u_thres"] > 0 else 10,
        doubly_unique_read_cnt_thres=int(a["d_thres"]) if a["d_thres"] > 0 else 5,
    )
    qcfg = QueryConfig(h=index_u.h, erate=a["erate"], min_read_len=a["min_rl"],
                       id_mode=a["id_mode"], fine=fine, ident=identp)
    engine = {"auto": "sortjoin"}.get(a["engine"], a["engine"])
    if engine not in ("sortjoin", "gather"):
        engine = "sortjoin"
    # -t N at query time = N-way device parallelism over the 'data' mesh
    # axis (the reference's -t sets OpenMP threads, src/main.cpp:358-359;
    # here devices are the unit of parallelism); --model_shards M
    # additionally shards the index over the 'model' axis
    mesh = None
    if a["t"] > 1 or a["model_shards"] > 1:
        import jax

        from .parallel.mesh import make_mesh
        from .parallel.multihost import initialize_cluster

        initialize_cluster()
        nd = len(jax.devices())
        model = max(1, min(a["model_shards"], nd))
        data = max(1, min(a["t"] if a["t"] > 1 else nd // model, nd // model))
        if data * model > 1:
            mesh = make_mesh(data=data, model=model)
            print(f"Distributed query mesh: data={data} x model={model}.",
                  file=sys.stderr)
        else:
            print(f"-t {a['t']} requested but only {nd} device(s) present; "
                  f"running single-device.", file=sys.stderr)
    if artifact is not None:
        sess = QuerySession.from_artifact(artifact, G, qcfg, mesh=mesh)
    else:
        sess = QuerySession(index_u, index_d, G, qcfg, engine=engine,
                            mesh=mesh)
    sess.wait_ready()
    print(f"Time for session start: "
          f"{(time.perf_counter() - t_start) * 1e3:.0f} ms.", file=sys.stderr)

    files = a["fq_names"] or (list_fastq_dir(a["fq_dir"]) if a["fq_dir"] else [])
    if not files:
        _err("Please specify at least one query file or directory.")
    out_path = a["output"] or "./quantification_results.out"

    gl, nus, nds = table.arrays()
    mode = "w"
    from .utils.profiling import device_trace

    prof = device_trace(a.get("profile") or None)
    prof.__enter__()
    results = []
    for fi, path in enumerate(files):
        reads = read_fastq(path, min_len=a["min_rl"])
        sc = a["id_mode"] > 0
        c0, h0 = meter.seconds, meter.cache_hits
        counts = sess.run(reads, sc_mode=sc, verbose=True)
        results.append(counts)
        print(f"Time for compiling: {(meter.seconds - c0) * 1e3:.0f} ms "
              f"({meter.cache_hits - h0} persistent-cache hits).",
              file=sys.stderr)
        print(f"Number of unlabeled reads: {counts.nundet}.", file=sys.stderr)
        print(f"Number of reads with conflict labels: {counts.nconf}.", file=sys.stderr)
        name = os.path.basename(path)
        with open(out_path, mode) as f:
            if a["id_mode"] == 0:
                prob = build_problem(
                    index_u, index_d,
                    counts.rcount_u, counts.rcount_d,
                    counts.cnts_u.astype(np.float64), counts.cnts_d.astype(np.float64),
                    nus.astype(np.float64), nds.astype(np.float64),
                    gl, counts.mean_read_len, counts.num_reads,
                    a["erate"], fine,
                )
                exist, cov, info = solve_quant(
                    prob, verbose=a["debug"],
                    time_limit=a["ilp_time_limit"],
                    enum_cap=a["ilp_enum_cap"],
                )
                print(f"{int(prob.exist0.sum())} genomes may exist in query "
                      f"{name}.", file=sys.stderr)
                print(f"Time for quantification: "
                      f"{info['solve_time']*1e3:.0f} ms.", file=sys.stderr)
                outmod.write_quant_block(f, name, table, exist, cov,
                                         last_file=(fi == len(files) - 1))
            elif a["id_mode"] == 1:
                if fi == 0:
                    outmod.write_counts_header(f, table)
                outmod.write_counts_row(f, name, counts.cnts_u, table.n_species)
            else:
                if fi == 0:
                    outmod.write_counts_header(f, table)
                exist, redist = solve_ident(
                    counts.cnts_u, counts.cnts_d, counts.pair_counts, identp
                )
                outmod.write_counts_row(f, name, redist, table.n_species)
        mode = "a"
    prof.__exit__(None, None, None)
    return results


def main(argv: Optional[List[str]] = None) -> None:
    a = parse_args(list(sys.argv[1:] if argv is None else argv))
    from .utils.jitcache import enable_persistent_cache

    enable_persistent_cache()
    if a["mode"] == 0:
        run_build(a)
    elif a["mode"] == 1:
        run_query(a)
    else:
        _err("Specify --build or --query.")


if __name__ == "__main__":
    main()
