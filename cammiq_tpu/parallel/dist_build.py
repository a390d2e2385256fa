"""Cross-host suffix-array construction: per-slice bounded sorts + an
exact bounded-key merge (SURVEY §7 hard part (a)).

The single-host build bounded-sorts the whole concatenation in one
threaded pass (native/bsort.cpp).  At the reference's corpus cap
(maxN = 2^36 bytes, src/util.hpp:13) no single host holds the text, so
the sort must shard:

1. The corpus splits into H contiguous byte slices.  Host h sees ONLY
   its slice plus a `depth`-byte halo from the next slice (`depth` =
   cfg.sa_depth = L+2, the bound every LCP0/OCC/MU comparison in the
   pipeline thresholds at — src/gsa.cpp:239-712).  It bounded-sorts the
   subtext with native/bsort.cpp and keeps the suffixes starting in its
   slice: every kept suffix has its full `depth`-byte window inside the
   subtext, so the kept order equals the global bounded order.
2. Each host ships (global positions, `depth`-byte keys packed as
   big-endian uint64 words + a length tiebreak) — O(n_h · depth) bytes;
   no host ever touches another's corpus bytes.
3. Slices merge pairwise (log2 H rounds) with a vectorized
   lexicographic binary-search rank merge on the bounded keys.  Key
   comparison reproduces the sorter's virtual-sentinel convention
   (shorter suffix first on exhaustion — corpus bytes CAN be zero, the
   first contig separator is 4 zero bytes, so zero padding alone would
   conflate and the suffix length breaks the tie).
4. Ties at the depth cap stay in arbitrary order, exactly like the
   single-host bounded sort; the downstream pipeline is tie-insensitive
   (the bsort-vs-SAIS index-equality tests prove it), so the dist build
   produces an IDENTICAL index (tests/test_dist_build.py).

Host emulation: slice sorts run in separate PROCESSES, each handed only
its subtext bytes (multiprocessing pickles the slice — the honest
analog of a host reading its shard).  Reference single-node anchor:
src/gsa.cpp:20-58.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def _pack_keys(subtext: np.ndarray, local_sa: np.ndarray, depth: int,
               tail_len: int | None = None):
    """(words, lens) bounded sort keys for suffixes `local_sa` of
    subtext: the first `depth` bytes as big-endian uint64 words (numpy
    '>u8' compares lexicographically) plus the in-text suffix length
    (min(depth, bytes to text end)) as the exhaustion tiebreak.
    tail_len: bytes of subtext that reach the GLOBAL text end (None =
    subtext ends at the global end, i.e. the last slice)."""
    n = subtext.shape[0]
    d8 = (depth + 7) // 8
    padded = np.concatenate([subtext, np.zeros(d8 * 8, np.uint8)])
    win = np.lib.stride_tricks.sliding_window_view(padded, d8 * 8)
    rows = np.ascontiguousarray(win[local_sa][:, : d8 * 8])
    # the comparator must be EXACTLY as coarse as the bounded sort: bytes
    # past `depth` in the final word would order ties the sorter left
    # arbitrary, contradicting the per-slice order the merge assumes
    rows[:, depth:] = 0
    words = rows.view(">u8").reshape(rows.shape[0], d8)
    if tail_len is None:
        lens = np.minimum(n - local_sa, depth).astype(np.int64)
    else:
        # middle slice: subtext ends at a halo cut, not the text end —
        # every kept suffix has `depth` real bytes available
        lens = np.full(local_sa.shape[0], depth, np.int64)
    return words, lens


def _slice_worker(args):
    """Bounded-sort one slice's suffixes from its subtext only.
    args: (subtext bytes, slice_len, global_start, depth, is_last)."""
    from .. import native

    sub_b, slice_len, start, depth, is_last = args
    sub = np.frombuffer(sub_b, np.uint8)
    sa = native.bounded_sa(sub, depth)
    keep = sa < slice_len
    local = sa[keep]
    words, lens = _pack_keys(sub, local, depth,
                             tail_len=None if is_last else depth)
    return (local + start).astype(np.int64), words, lens


def _lex_less(xw, xl, yw, yl):
    """Bounded-suffix 'strictly less': big-endian word compare, shorter
    suffix first when the padded words tie (virtual sentinel)."""
    m, d8 = xw.shape
    neq = xw != yw
    any_neq = neq.any(axis=1)
    first = np.argmax(neq, axis=1)
    rows = np.arange(m)
    xb = xw[rows, first]
    yb = yw[rows, first]
    return np.where(any_neq, xb < yb, xl < yl)


def _rank(keys_w, keys_l, q_w, q_l, side: str) -> np.ndarray:
    """Vectorized binary search of queries in a sorted key list:
    side='left' counts keys < q, side='right' counts keys <= q."""
    n = keys_w.shape[0]
    m = q_w.shape[0]
    lo = np.zeros(m, np.int64)
    hi = np.full(m, n, np.int64)
    for _ in range(max(int(n).bit_length(), 1)):
        act = lo < hi
        mid = (lo + hi) >> 1
        midc = np.minimum(mid, max(n - 1, 0))
        kw = keys_w[midc]
        kl = keys_l[midc]
        if side == "left":
            go_right = _lex_less(kw, kl, q_w, q_l)
        else:
            go_right = ~_lex_less(q_w, q_l, kw, kl)
        lo = np.where(act & go_right, mid + 1, lo)
        hi = np.where(act & ~go_right, mid, hi)
    return lo


def merge_sorted_slices(a, b):
    """Stable merge of two (pos, words, lens) sorted slices (a first on
    ties — ties at the depth bound are interchangeable anyway)."""
    pa, wa, la = a
    pb, wb, lb = b
    na, nb = pa.shape[0], pb.shape[0]
    if na == 0:
        return b
    if nb == 0:
        return a
    idx_a = np.arange(na) + _rank(wb, lb, wa, la, "left")
    idx_b = np.arange(nb) + _rank(wa, la, wb, lb, "right")
    n = na + nb
    pos = np.empty(n, np.int64)
    words = np.empty((n, wa.shape[1]), dtype=wa.dtype)
    lens = np.empty(n, np.int64)
    pos[idx_a], pos[idx_b] = pa, pb
    words[idx_a], words[idx_b] = wa, wb
    lens[idx_a], lens[idx_b] = la, lb
    return pos, words, lens


def dist_bounded_sa(seq: np.ndarray, depth: int, hosts: int,
                    processes: bool = True) -> np.ndarray:
    """Depth-bounded suffix array of `seq` built from `hosts` corpus
    slices, each sorted from its own subtext in a separate process.
    Output ordering contract == native.bounded_sa (ties arbitrary)."""
    n = seq.shape[0]
    hosts = max(1, min(hosts, n))
    cuts = [n * i // hosts for i in range(hosts + 1)]
    jobs = []
    for h in range(hosts):
        start, stop = cuts[h], cuts[h + 1]
        sub = seq[start : min(stop + depth, n)]
        jobs.append((sub.tobytes(), stop - start, start, depth,
                     stop + depth >= n))
    if processes and hosts > 1:
        import multiprocessing as mp

        with mp.get_context("spawn").Pool(min(hosts, 4)) as pool:
            parts = pool.map(_slice_worker, jobs)
    else:
        parts = [_slice_worker(j) for j in jobs]
    while len(parts) > 1:
        nxt: List[Tuple] = []
        for i in range(0, len(parts) - 1, 2):
            nxt.append(merge_sorted_slices(parts[i], parts[i + 1]))
        if len(parts) % 2:
            nxt.append(parts[-1])
        parts = nxt
    return parts[0][0]


# ---------------------------------------------------------------------------
# Memory-honest full cross-host build (r5).
#
# dist_bounded_sa above proves the ALGORITHM (slice sorts + exact bounded
# merge) but centralizes every host's packed keys in the driver and runs
# the downstream sweeps on full-corpus arrays.  dist_build_index below is
# the memory-honest pipeline:
#
#   P0  driver writes the corpus text + slice bounds to workdir; samples
#       bounded keys per slice and broadcasts H-1 splitters (O(H) keys).
#   P1  one worker per SLICE: bounded-sorts its subtext, packs keys,
#       partitions its sorted run by the splitters, spills per-OWNER
#       segment files.  Peak ~ (keybytes+16) * n_slice.
#   P2  one worker per OWNER: merges its H segments (globally contiguous
#       SA chunk), derives gid (searchsorted on the tiny ref_pos) and the
#       adjacent-key LCP, writes chunk files, drops the keys.  Boundary
#       LCPs are patched from neighbours' edge keys (O(1) each).
#   P3  one SWEEP worker streams the chunks with the carried scans of
#       index/chunked.py (LCP0 unique+doubly, OCC via halos) and spills
#       per-candidate records binned by TEXT shard.  Peak ~ chunk+halo.
#   P4  one worker per TEXT shard (file-aligned): reassembles its mu/occ/
#       g2/occ2 slices from the records, runs the UNCHANGED selection on
#       a padded corpus view, extracts entry words against its local
#       text.  Selection state resets at contig boundaries (reference
#       thread partitioning, src/build.cpp:660-666), so file-aligned
#       shards reproduce the monolithic output exactly.
#   P5  driver concatenates the (small) entries and assembles the
#       FlatIndexes.
#
# Every worker reports ru_maxrss; no process ever materializes a
# full-corpus array (the driver holds the corpus text only to write it
# out once — a stand-in for hosts reading their own shard of a shared
# filesystem).  maxN is no longer bounded by one host's RAM but by
# H * (per-host RAM / ~(keybytes+16) bytes per suffix).
# ---------------------------------------------------------------------------

import os


def _sample_keys(seq, samp: np.ndarray, depth: int, n: int):
    """Bounded keys for a FEW sampled positions via direct window
    extraction — _pack_keys would concatenate a full-corpus copy, which
    the streaming-corpus driver must never do."""
    d8 = (depth + 7) // 8
    rows = np.zeros((len(samp), d8 * 8), np.uint8)
    for i, p in enumerate(np.asarray(samp, np.int64)):
        w = np.asarray(seq[p:min(p + depth, n)])
        rows[i, : w.shape[0]] = w
    rows[:, depth:] = 0
    words = rows.view(">u8").reshape(rows.shape[0], d8)
    lens = np.minimum(n - np.asarray(samp, np.int64), depth)
    return words, lens


def _maxrss_mb() -> float:
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


def _key_lcp_u16(words: np.ndarray, lens: np.ndarray, depth: int) -> np.ndarray:
    """lcp[i] = common-prefix length of bounded keys i-1 and i, clamped
    at min(depth, len_{i-1}, len_i); lcp[0] = 0.  Matches
    native.bounded_lcp_u16 (zero-padded key bytes can only over-extend a
    match past a suffix's end, which the length min removes)."""
    m = words.shape[0]
    lcp = np.zeros(m, np.int64)
    if m < 2:
        return lcp.astype(np.uint16)
    by = np.ascontiguousarray(words).view(np.uint8).reshape(m, -1)
    # blocked so the [m, depth] bool temp never exceeds ~64 MB
    B = max((1 << 26) // max(by.shape[1], 1), 1024)
    for a in range(1, m, B):
        b = min(a + B, m)
        neq = by[a:b] != by[a - 1:b - 1]
        any_neq = neq.any(axis=1)
        first = np.argmax(neq, axis=1)
        lcp[a:b] = np.where(any_neq, first, by.shape[1])
    np.minimum(lcp[1:], np.minimum(lens[1:], lens[:-1]), out=lcp[1:])
    np.minimum(lcp[1:], depth, out=lcp[1:])
    return lcp.astype(np.uint16)


def _baseline_worker(_):
    """No-op worker: measures the spawn + import RSS floor so scaling
    assertions can subtract it."""
    return _maxrss_mb()


def _p1_worker(args):
    (wd, h, start, stop, depth, n, spl_w, spl_l, hosts) = args
    from .. import native

    sub = np.memmap(os.path.join(wd, "corpus.bin"), dtype=np.uint8,
                    mode="r")[start:min(stop + depth, n)]
    sub = np.ascontiguousarray(sub)
    sa = native.bounded_sa(sub, depth)
    keep = sa < (stop - start)
    local = sa[keep]
    del sa, keep
    words, lens = _pack_keys(sub, local, depth,
                             tail_len=None if stop + depth >= n else depth)
    pos = (local + start).astype(np.int64)
    del local, sub
    # partition the sorted run by the splitters
    bounds = [0]
    for o in range(hosts - 1):
        qw = np.repeat(spl_w[o][None, :], 1, axis=0)
        ql = np.asarray([spl_l[o]], np.int64)
        bounds.append(int(_rank(words, lens, qw, ql, "left")[0]))
    bounds.append(pos.shape[0])
    for o in range(hosts):
        a, b = bounds[o], bounds[o + 1]
        np.save(os.path.join(wd, f"seg_{h}_{o}_pos.npy"), pos[a:b])
        np.save(os.path.join(wd, f"seg_{h}_{o}_w.npy"), words[a:b])
        np.save(os.path.join(wd, f"seg_{h}_{o}_l.npy"), lens[a:b])
    return _maxrss_mb()


def _p2_worker(args):
    (wd, o, hosts, depth, ref_pos, ref_id) = args
    parts = []
    for h in range(hosts):
        parts.append((np.load(os.path.join(wd, f"seg_{h}_{o}_pos.npy")),
                      np.load(os.path.join(wd, f"seg_{h}_{o}_w.npy")),
                      np.load(os.path.join(wd, f"seg_{h}_{o}_l.npy"))))
    while len(parts) > 1:
        nxt = []
        for i in range(0, len(parts) - 1, 2):
            nxt.append(merge_sorted_slices(parts[i], parts[i + 1]))
        if len(parts) % 2:
            nxt.append(parts[-1])
        parts = nxt
    pos, words, lens = parts[0]
    j = np.searchsorted(np.asarray(ref_pos, np.int64), pos, side="right")
    gid = np.asarray(ref_id, np.int64)[j].astype(np.int32)
    lcp = _key_lcp_u16(words, lens, depth)
    edge_first = (np.concatenate([words[0].astype(np.uint64),
                                  [np.uint64(lens[0])]])
                  if pos.shape[0] else None)
    edge_last = (np.concatenate([words[-1].astype(np.uint64),
                                 [np.uint64(lens[-1])]])
                 if pos.shape[0] else None)
    del words, lens, parts
    np.save(os.path.join(wd, f"ch{o:04d}_pos.npy"), pos)
    np.save(os.path.join(wd, f"ch{o:04d}_gid.npy"), gid)
    np.save(os.path.join(wd, f"ch{o:04d}_lcp.npy"), lcp)
    # edge keys for the driver's O(1) boundary-LCP patch
    if edge_first is not None:
        np.save(os.path.join(wd, f"edge_{o}_first.npy"), edge_first)
        np.save(os.path.join(wd, f"edge_{o}_last.npy"), edge_last)
    return _maxrss_mb()


def _p3_worker(args):
    (wd, nchunks, n, el, ulmax, mode, text_cuts) = args
    from ..index import chunked as ck

    nruns = ck.forward_pass(wd, nchunks)
    ck.backward_pass(wd, nchunks, nruns, el, ulmax, mode)
    # end_excl: top of the GLOBAL first run
    end_excl = -1
    base = 0
    for c in range(nchunks):
        rid = np.load(os.path.join(wd, f"ch{c:04d}_rid.npy"), mmap_mode="r")
        nz = np.nonzero(np.asarray(rid) > 0)[0]
        if nz.size:
            end_excl = base + int(nz[0]) - 1
            break
        base += rid.shape[0]
    if end_excl < 0:
        end_excl = n - 1
    ck.occ_emit_pass(wd, nchunks, n, ulmax, mode,
                     np.asarray(text_cuts, np.int64), end_excl)
    return _maxrss_mb()


def _p4_worker(args):
    (wd, s, nchunks, f0, f1, base, hi, pad, contig_pos, ref_pos, ref_id,
     depth, cfg_d) = args
    from ..index.sparsify import select_substrings
    from ..index.table import extract_entry_words
    from ..io.fasta import Corpus

    L, Lmax, h, h_doubly, mode, num_groups = (
        cfg_d["L"], cfg_d["Lmax"], cfg_d["h"], cfg_d["h_doubly"],
        cfg_d["mode"], cfg_d["num_groups"])
    seq = np.asarray(np.memmap(os.path.join(wd, "corpus.bin"),
                               dtype=np.uint8, mode="r")[base:hi])
    if pad:
        seq = np.concatenate([np.zeros(pad, np.uint8), seq])
    cp = np.asarray(contig_pos, np.int64)
    rp = np.asarray(ref_pos, np.int64)
    cm = (cp > base) & (cp <= hi)
    local_cp = cp[cm] - base + pad
    local_rp = rp[f0:f1] - base + pad
    rid_loc = np.asarray(ref_id)[f0:f1]
    if pad:
        # fake leading file+contig covering the pad: candidates crossing
        # the shard base become cross-file and are skipped, exactly as
        # the monolithic run skips them
        local_cp = np.concatenate([[pad], local_cp])
        local_rp = np.concatenate([[pad], local_rp])
        rid_loc = np.concatenate([[0], rid_loc])
    view = Corpus(seq=seq, contig_pos=local_cp.astype(np.uint64),
                  ref_pos=local_rp.astype(np.uint64),
                  ref_id=np.asarray(rid_loc, np.uint32),
                  filenames=["pad"] * (1 if pad else 0) + [
                      f"f{i}" for i in range(f0, f1)])
    ln = seq.shape[0]
    out = {}
    kw = max(2, (Lmax + 15) // 16)
    for tbl, pre in (("u", "ut"), ("d", "dt")):
        if tbl == "u" and mode not in ("unique", "both"):
            continue
        if tbl == "d" and mode not in ("doubly_unique", "both"):
            continue
        MU_EMPTY = 0xFFFF
        mu = np.full(ln + 1, MU_EMPTY, np.int64)
        occ = np.zeros(ln, np.int64)
        g2 = np.zeros(ln, np.int64)
        occ2 = np.zeros(ln, np.int64)
        for c in range(nchunks):
            p = os.path.join(wd, f"{pre}_{c:04d}_{s:03d}.npy")
            rec = np.load(p)
            if not rec.size:
                continue
            e_loc = rec[:, 0] + rec[:, 1] + 1 - base + pad
            p_loc = rec[:, 0] - base + pad
            np.minimum.at(mu, e_loc, rec[:, 1])
            occ[p_loc] = rec[:, 2]
            if tbl == "d":
                occ2[p_loc] = rec[:, 3]
                g2[p_loc] = rec[:, 4]
        # one shard == one selection group (the shard cuts mirror
        # select_substrings' group rule; see dist_build_index).
        # start_file=1 starts the group exactly at the first real file
        # with monolithic group-boundary state (the pad file is
        # context-only) — pad > L so the fresh start=0 state behaves
        # shift-invariantly, matching the monolithic group start
        sel = select_substrings(
            view, mu, occ, L, Lmax,
            gsa2_text=g2 if tbl == "d" else None,
            occ2=occ2 if tbl == "d" else None,
            num_groups=1, start_file=1 if pad else 0,
        )
        words = extract_entry_words(seq, sel, kw)
        ulm = sel.ulm_count[1:] if pad else sel.ulm_count
        out[tbl] = dict(words=words, lens=sel.length, rid=sel.rid,
                        occ=sel.occ, rid2=sel.rid2, occ2=sel.occ2, ulm=ulm)
    return out, _maxrss_mb()


def dist_build_index(corpus, cfg, hosts: int, workdir: str,
                     processes: bool = True, verbose: bool = False):
    """Memory-honest cross-host build (see module comment above).

    Returns (BuildArtifacts, rss_report) where rss_report maps phase ->
    list of per-worker peak RSS MB.  Requires the native bounded sort;
    rejects the bit-parity flags that need unbounded walks."""
    import multiprocessing as mp

    from .. import native
    from ..index.builder import BuildArtifacts, Timings
    from ..index.table import build_flat_index_from_entries

    if not (native.available() and native.has_bsort()):
        raise RuntimeError("dist_build_index requires the native bounded sort")
    if cfg.occ_u8_wrap or cfg.unique_if_advance:
        raise ValueError(
            "occ_u8_wrap / unique_if_advance (bit-parity modes) need "
            "unbounded walks and are single-host only")
    os.makedirs(workdir, exist_ok=True)
    n = corpus.n
    depth = cfg.sa_depth
    hosts = max(1, min(hosts, max(n // (4 * depth), 1)))
    rss = {}

    # P0: corpus text to disk (chunked: the seq may itself be a memmap
    # from io.fasta.build_corpus_streaming, so the driver never holds the
    # full text) + splitters from sampled key windows (window extraction,
    # NOT _pack_keys, which would materialize a full-corpus copy)
    cpath = os.path.join(workdir, "corpus.bin")
    with open(cpath, "wb") as f:
        CH = 1 << 26
        for a in range(0, n, CH):
            f.write(np.ascontiguousarray(corpus.seq[a:a + CH]).tobytes())
    cuts = [n * i // hosts for i in range(hosts + 1)]
    rng = np.random.default_rng(0xD157)
    samp = np.sort(rng.integers(0, n, 64 * hosts).astype(np.int64))
    sw, sl = _sample_keys(corpus.seq, samp, depth, n)
    order = np.lexsort(tuple(sw[:, c] for c in range(sw.shape[1] - 1, -1, -1))
                       + (sl,))
    spl_idx = [order[(i + 1) * len(order) // hosts] for i in range(hosts - 1)]
    spl_w = [sw[i] for i in spl_idx]
    spl_l = [int(sl[i]) for i in spl_idx]

    def run(fn, jobs, phase):
        if processes and len(jobs) > 1:
            with mp.get_context("spawn").Pool(min(len(jobs), 4)) as pool:
                res = pool.map(fn, jobs)
        else:
            res = [fn(j) for j in jobs]
        return res

    if processes:
        rss["baseline"] = run(_baseline_worker, [0, 1], "p0")
    r1 = run(_p1_worker, [
        (workdir, h, cuts[h], cuts[h + 1], depth, n, spl_w, spl_l, hosts)
        for h in range(hosts)], "p1")
    rss["p1_sort_partition"] = r1
    r2 = run(_p2_worker, [
        (workdir, o, hosts, depth, corpus.ref_pos, corpus.ref_id)
        for o in range(hosts)], "p2")
    rss["p2_merge_chunks"] = r2
    for h in range(hosts):
        for o in range(hosts):
            for suf in ("pos", "w", "l"):
                p = os.path.join(workdir, f"seg_{h}_{o}_{suf}.npy")
                if os.path.exists(p):
                    os.remove(p)
    # boundary LCP patch: chunk o's lcp[0] = LCP(last key of o-1, first of o)
    for o in range(1, hosts):
        fa = os.path.join(workdir, f"edge_{o - 1}_last.npy")
        fb = os.path.join(workdir, f"edge_{o}_first.npy")
        if not (os.path.exists(fa) and os.path.exists(fb)):
            continue
        a = np.load(fa)
        b = np.load(fb)
        w2 = np.stack([a[:-1], b[:-1]]).astype(">u8")
        l2 = np.asarray([a[-1], b[-1]], np.int64)
        v = _key_lcp_u16(w2, l2, depth)[1]
        lcp = np.load(os.path.join(workdir, f"ch{o:04d}_lcp.npy"))
        if lcp.shape[0]:
            lcp[0] = v
            np.save(os.path.join(workdir, f"ch{o:04d}_lcp.npy"), lcp)

    # text shards ARE the selection groups: the greedy covering state
    # carries across genome files within a group (reference: per-thread
    # genome ranges, capped at 4 pthreads, src/build.cpp:660-666), so the
    # shard cuts must mirror select_substrings' own group rule — then
    # dist_build_index(hosts=H) output == build_index(num_groups=
    # min(H, 4, M)), i.e. the reference's t=H thread behavior
    rp = corpus.ref_pos.astype(np.int64)
    M = rp.shape[0]
    # an explicit num_groups (the CLI's -t, reference thread count) wins;
    # otherwise one group per host — either way output == build_index
    # with that num_groups
    want = cfg.num_groups if cfg.num_groups > 1 else hosts
    nsh = max(1, min(want, 4, M))
    nref = M // nsh
    fcuts = [0] + [tid * nref for tid in range(1, nsh)] + [M]
    text_cuts = np.asarray(
        [0] + [int(rp[f - 1]) for f in fcuts[1:]], np.int64)

    el = cfg.k - 1
    ulmax = cfg.L
    r3 = run(_p3_worker, [(workdir, hosts, n, el, ulmax, cfg.mode,
                           text_cuts)], "p3")
    rss["p3_sweeps"] = r3

    cfg_d = dict(L=cfg.L, Lmax=cfg.Lmax, h=cfg.h, h_doubly=cfg.h_doubly,
                 mode=cfg.mode, num_groups=cfg.num_groups)
    jobs = []
    for sidx in range(nsh):
        f0, f1 = fcuts[sidx], fcuts[sidx + 1]
        base = int(rp[f0 - 1]) if f0 else 0
        hi = int(rp[f1 - 1])
        pad = 0 if sidx == 0 else depth + 8
        jobs.append((workdir, sidx, hosts, f0, f1, base, hi, pad,
                     corpus.contig_pos, corpus.ref_pos, corpus.ref_id,
                     depth, cfg_d))
    r4 = run(_p4_worker, jobs, "p4")
    rss["p4_select"] = [r[1] for r in r4]

    def assemble(tbl, h_len, is_doubly):
        parts = [r[0][tbl] for r in r4 if tbl in r[0]]
        if not parts:
            return None, None
        words = np.concatenate([p["words"] for p in parts])
        lens = np.concatenate([p["lens"] for p in parts])
        rid = np.concatenate([p["rid"] for p in parts])
        occ = np.concatenate([p["occ"] for p in parts])
        rid2 = np.concatenate([p["rid2"] for p in parts])
        occ2 = np.concatenate([p["occ2"] for p in parts])
        ulm = np.concatenate([p["ulm"] for p in parts])
        idx = build_flat_index_from_entries(
            words, lens, rid, occ, rid2, occ2, h_len, is_doubly)
        return idx, ulm

    unique_index = doubly_index = None
    ulm_u = ulm_d = None
    if cfg.mode in ("unique", "both"):
        unique_index, ulm_u = assemble("u", cfg.h, False)
    if cfg.mode in ("doubly_unique", "both"):
        doubly_index, ulm_d = assemble("d", cfg.h_doubly, True)
    art = BuildArtifacts(
        unique_index=unique_index, doubly_index=doubly_index,
        ulm_count_u=ulm_u, ulm_count_d=ulm_d,
        genome_lengths=corpus.genome_lengths(), corpus=corpus,
        timings=Timings(),
    )
    if verbose:
        import sys

        for k, v in rss.items():
            print(f"[dist-build] {k}: peak RSS MB per worker = "
                  f"{[round(x, 1) for x in v]}", file=sys.stderr)
    return art, rss
