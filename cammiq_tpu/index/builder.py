"""Build-pipeline orchestrator (reference: FastaReader::allocSuffixArray +
computeIndex, src/build.cpp:268-739; SuffixArray::run, src/gsa.cpp:786-833).

Pipeline: corpus -> SA -> LCP -> GSA -> (unique | doubly) LCP0 -> OCC ->
MU -> sparsify -> FlatIndex (+ meta outputs).
"""

from __future__ import annotations

import dataclasses
import os
import sys
from typing import Optional

import numpy as np

from ..config import BuildConfig
from ..io.fasta import Corpus
from ..utils.timing import Timings, stage_timer
from ..ops.lcp import lcp_from_sa_numpy
from ..ops.sa import suffix_array_numpy
from .sparsify import SelectedSubstrings, select_substrings
from .table import FlatIndex, build_flat_index, save_flat_index
from .unique import (
    compute_gsa,
    doubly_lcp0,
    min_unique,
    occ_doubly,
    occ_unique,
    unique_lcp0,
)


@dataclasses.dataclass
class BuildArtifacts:
    unique_index: Optional[FlatIndex]
    doubly_index: Optional[FlatIndex]
    ulm_count_u: Optional[np.ndarray]   # per-file unique-L-mer counts
    ulm_count_d: Optional[np.ndarray]
    genome_lengths: np.ndarray          # per-file
    corpus: Corpus
    timings: Timings


def _suffix_array(seq_with_sentinels: np.ndarray, engine: str) -> np.ndarray:
    if engine == "native":
        from .. import native

        if native.available():
            return native.suffix_array(seq_with_sentinels)
        engine = "numpy"
    if engine == "jax":
        from ..ops.sa import suffix_array_jax

        return np.asarray(suffix_array_jax(seq_with_sentinels)).astype(np.int64)
    return suffix_array_numpy(seq_with_sentinels)


def _lcp(seq: np.ndarray, sa: np.ndarray, engine: str) -> np.ndarray:
    if engine == "native":
        from .. import native

        if native.available():
            return native.lcp_kasai(seq, sa)
        engine = "numpy"
    if engine == "jax":
        from ..ops.lcp import LCP_CLAMP, lcp_jax

        return np.asarray(
            lcp_jax(seq, np.asarray(sa, np.int32), max_lcp=LCP_CLAMP)
        ).astype(np.int64)
    return lcp_from_sa_numpy(seq, sa)


def build_index(
    corpus: Corpus,
    cfg: BuildConfig,
    engine: str = "auto",
    verbose: bool = False,
    stage_dir: Optional[str] = None,
    sa_hosts: int = 0,
) -> BuildArtifacts:
    """Run the full build pipeline.

    engine: 'auto' (native C++ if built, else numpy), 'native', 'numpy',
    or 'jax' (SA/LCP/LCP0/MU/OCC on device).
    stage_dir: optional directory for disk staging of the SA/LCP stages
    (resume support + RAM relief, the reference's gsa.bin/lcp.bin spills).
    sa_hosts: > 1 shards the bounded suffix sort into that many corpus
    slices sorted in separate processes and merged on bounded keys
    (parallel/dist_build.py) — the cross-host construction path.
    """
    timings = Timings()
    if engine == "auto":
        from .. import native

        engine = "native" if native.available() else "numpy"

    store = None
    if stage_dir is not None:
        from .staging import StageStore

        store = StageStore(stage_dir)

    from .staging import staged

    n = corpus.n
    device = engine == "jax"
    # production host path: the C++ streaming sweeps with tight dtypes
    # (lcp uint16, gsa int32, occ uint8, mu uint16), the layout that keeps
    # a multi-gigabase corpus within the reference's ~37N-byte RAM budget
    # (README.md:187); the numpy/jax engines remain the oracle twins
    from .. import native

    sweeps = engine == "native" and native.has_sweeps()
    bounded = sweeps and cfg.bounded_sa and native.has_bsort()
    if verbose:
        print(f"Build engine: {engine}"
              f"{' (C++ sweeps)' if sweeps else ''}"
              f"{' (bounded suffix sort)' if bounded else ''}.",
              file=sys.stderr)
    # the reference computes the SA over n + sentinels but keeps ranks of
    # the n real suffixes only (divsufsort over n chars; src/build.cpp:286)
    with stage_timer("computing suffix array", timings, verbose):
        if bounded:
            # depth-bounded suffix sort: exact for every consumer that
            # thresholds LCPs at <= L+2 (all of them); parallel, one
            # counting-sort pass + per-bucket bounded sorts
            if sa_hosts > 1:
                from ..parallel.dist_build import dist_bounded_sa

                sa = staged(store, f"bsa{cfg.sa_depth}_h{sa_hosts}",
                            lambda: dist_bounded_sa(corpus.seq, cfg.sa_depth,
                                                    sa_hosts))
            else:
                sa = staged(store, f"bsa{cfg.sa_depth}",
                            lambda: native.bounded_sa(corpus.seq, cfg.sa_depth))
        else:
            sa = staged(store, "sa",
                        lambda: _suffix_array(corpus.seq, engine)[:n])
    with stage_timer("computing LCP array", timings, verbose):
        if bounded:
            lcp = staged(store, f"blcp16_{cfg.sa_depth}",
                         lambda: native.bounded_lcp_u16(corpus.seq, sa,
                                                        cfg.sa_depth))
        elif sweeps:
            lcp = staged(store, "lcp16",
                         lambda: native.kasai_u16(corpus.seq[:n], sa))
        else:
            lcp = staged(store, "lcp", lambda: _lcp(corpus.seq, sa, engine))
    with stage_timer("computing generalized suffix array", timings, verbose):
        if sweeps:
            gsa = native.gsa32(sa, corpus.ref_pos, corpus.ref_id)
        else:
            gsa = compute_gsa(sa, corpus.ref_pos, corpus.ref_id)

    unique_index = None
    doubly_index = None
    ulm_u = None
    ulm_d = None

    el = cfg.k - 1            # minuL - 1 (src/build.cpp:289)
    ulmax = cfg.L             # passed as ulmax to run() (src/build.cpp:289)

    if device:
        import jax.numpy as jnp

        from . import unique_jax as uj

        sa_j = jnp.asarray(sa, jnp.int32)
        lcp_j = jnp.asarray(lcp, jnp.int32)
        gsa_j = jnp.asarray(gsa, jnp.int32)

    if cfg.mode in ("unique", "both"):
        with stage_timer("computing LCP0 array", timings, verbose):
            if device:
                lcp0_j = uj.unique_lcp0_jax(gsa_j, lcp_j, el)
                lcp0 = np.asarray(lcp0_j).astype(np.int64)
            elif sweeps:
                lcp0 = native.unique_lcp0_32(gsa, lcp, el)
            else:
                lcp0 = unique_lcp0(gsa, lcp, el)
        with stage_timer("computing OCC array", timings, verbose):
            if device:
                if cfg.occ_u8_wrap:
                    raise ValueError("occ_u8_wrap (bit-parity mode) requires a host engine")
                occ = np.asarray(uj.occ_unique_jax(sa_j, gsa_j, lcp_j, lcp0_j)).astype(np.int64)
            elif sweeps:
                occ = native.occ_unique_u8(sa, gsa, lcp, lcp0,
                                           wrap=cfg.occ_u8_wrap)
            else:
                occ = occ_unique(sa, gsa, lcp, lcp0, wrap_u8=cfg.occ_u8_wrap)
        with stage_timer("computing minimum unique substrings", timings, verbose):
            if device:
                mu = np.asarray(uj.min_unique_jax(sa_j, lcp0_j, n)).astype(np.int64)
            elif sweeps:
                mu = native.min_unique_u16(sa, lcp0, n)
            else:
                mu = min_unique(sa, lcp0, n)
        with stage_timer("organizing index", timings, verbose):
            sel = select_substrings(
                corpus, mu, occ, cfg.L, cfg.Lmax, num_groups=cfg.num_groups,
                engine="native" if sweeps else "fast",
                unique_if_advance=cfg.unique_if_advance,
            )
            unique_index = build_flat_index(corpus.seq, sel, cfg.h, cfg.Lmax, False)
            ulm_u = sel.ulm_count
        # free per-stage arrays before the doubly pass (each is gigabytes
        # at a multi-GB corpus)
        if not device:
            del lcp0, occ, mu, sel

    if cfg.mode in ("doubly_unique", "both"):
        with stage_timer("computing LCP0-D array", timings, verbose):
            if device:
                dl_j, g2_j = uj.doubly_lcp0_jax(sa_j, gsa_j, lcp_j, el, ulmax)
                from .unique import DoublyResult

                dres = DoublyResult(np.asarray(dl_j).astype(np.int64),
                                    np.asarray(g2_j).astype(np.int64))
            elif sweeps:
                from .unique import DoublyResult

                dl, g2 = native.doubly_lcp0_32(sa, gsa, lcp, el, ulmax)
                dres = DoublyResult(dl, g2)
            else:
                dres = doubly_lcp0(sa, gsa, lcp, el, ulmax)
        with stage_timer("computing OCC array (doubly)", timings, verbose):
            if device:
                if cfg.occ_u8_wrap:
                    raise ValueError("occ_u8_wrap (bit-parity mode) requires a host engine")
                od_j, od2_j = uj.occ_doubly_jax(sa_j, gsa_j, g2_j, lcp_j, dl_j, ulmax)
                occ_d = np.asarray(od_j).astype(np.int64)
                occ2_d = np.asarray(od2_j).astype(np.int64)
            elif sweeps:
                occ_d, occ2_d = native.occ_doubly_u8(
                    sa, gsa, dres.gsa2, lcp, dres.lcp0, ulmax,
                    wrap=cfg.occ_u8_wrap)
            else:
                occ_d, occ2_d = occ_doubly(sa, gsa, dres.gsa2, lcp, dres.lcp0,
                                           ulmax, wrap_u8=cfg.occ_u8_wrap)
        with stage_timer("computing minimum unique substrings (doubly)", timings, verbose):
            if device:
                mu_d = np.asarray(uj.min_unique_jax(sa_j, dl_j, n, ulmax=ulmax)).astype(np.int64)
            elif sweeps:
                mu_d = native.min_unique_u16(sa, dres.lcp0, n, ulmax=ulmax)
            else:
                mu_d = min_unique(sa, dres.lcp0, n, ulmax=ulmax)
        with stage_timer("organizing index (doubly)", timings, verbose):
            sel_d = select_substrings(
                corpus, mu_d, occ_d, cfg.L, cfg.Lmax,
                gsa2_text=dres.gsa2, occ2=occ2_d, num_groups=cfg.num_groups,
                engine="native" if sweeps else "fast",
            )
            doubly_index = build_flat_index(
                corpus.seq, sel_d, cfg.h_doubly, cfg.Lmax, True
            )
            ulm_d = sel_d.ulm_count

    return BuildArtifacts(
        unique_index=unique_index,
        doubly_index=doubly_index,
        ulm_count_u=ulm_u,
        ulm_count_d=ulm_d,
        genome_lengths=corpus.genome_lengths(),
        corpus=corpus,
        timings=timings,
    )


def write_meta_outputs(art: BuildArtifacts, outdir: str) -> None:
    """genome_lengths.out + unique_lmer_count_{u,d}.out, byte-compatible
    with the reference (src/build.cpp:671-738)."""
    os.makedirs(outdir, exist_ok=True)
    rid = art.corpus.ref_id
    if art.ulm_count_u is not None:
        with open(os.path.join(outdir, "unique_lmer_count_u.out"), "w") as f:
            for i in range(len(rid)):
                f.write(f"{int(rid[i])}\t{int(art.ulm_count_u[i])}\n")
    if art.ulm_count_d is not None:
        with open(os.path.join(outdir, "unique_lmer_count_d.out"), "w") as f:
            for i in range(len(rid)):
                f.write(f"{int(rid[i])}\t{int(art.ulm_count_d[i])}\n")
    with open(os.path.join(outdir, "genome_lengths.out"), "w") as f:
        gl = art.genome_lengths
        for i in range(len(rid)):
            f.write(f"{int(rid[i])}\t{int(gl[i])}\n")


def save_index(art: BuildArtifacts, outdir: str) -> None:
    os.makedirs(outdir, exist_ok=True)
    if art.unique_index is not None:
        save_flat_index(os.path.join(outdir, "index_u.npz"), art.unique_index)
    if art.doubly_index is not None:
        save_flat_index(os.path.join(outdir, "index_d.npz"), art.doubly_index)
    write_meta_outputs(art, outdir)
