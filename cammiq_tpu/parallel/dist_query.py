"""Distributed query: data-parallel reads x model-parallel index shards.

The device-mesh replacement for the reference's OpenMP read loop with
omp-critical counter updates (src/query.cpp:650-889):

- reads are sharded over the 'data' mesh axis;
- the flat index is split into bucket-aligned entry shards over the
  'model' axis (replication = model=1);
- each device probes its read shard against its index shard; per-read
  match slots are all_gathered over 'model'; the case analysis runs
  replicated; per-genome counts merge with psum over the mesh and
  per-entry rcounts stay sharded over 'model'.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from ..index.table import FlatIndex, hash_prefix
from ..query.classify import (
    BatchCounts,
    MatchSlots,
    case_analysis,
    collect_matches,
    rcounts_from_case,
)
from ..query.probe import DeviceIndex
from .mesh import shard_map_fn


@dataclasses.dataclass
class ShardedIndex:
    """A FlatIndex split into `mp` equal-shape shards (stacked arrays)."""

    h: int
    kw: int
    mp: int
    e_pad: int                 # entries per shard (padded)
    max_probes: int
    max_bucket: int
    key_words: np.ndarray      # uint32 [mp, e_pad, kw]
    length: np.ndarray         # int32 [mp, e_pad]
    rid1: np.ndarray
    rid2: np.ndarray
    ucount1: np.ndarray
    ucount2: np.ndarray
    table_lo: np.ndarray       # uint32 [mp, T]
    table_hi: np.ndarray
    table_start: np.ndarray
    table_count: np.ndarray
    orig_id: np.ndarray        # int32 [mp, e_pad] original entry id or -1


def shard_flat_index(idx: FlatIndex, mp: int, load_factor: float = 0.5) -> ShardedIndex:
    """Split bucket-sorted entries into mp contiguous bucket-aligned
    chunks, rebuild a same-size hash table per shard."""
    E = idx.num_entries
    # bucket boundaries in the entry array
    if E:
        plo, phi = _entry_prefixes(idx)
        newb = np.ones(E, dtype=bool)
        newb[1:] = (plo[1:] != plo[:-1]) | (phi[1:] != phi[:-1])
        bstart = np.nonzero(newb)[0]
    else:
        plo = phi = np.zeros(0, np.uint32)
        bstart = np.zeros(0, np.int64)
    nb = len(bstart)

    # contiguous bucket ranges with ~equal entries
    cuts = [0]
    for m in range(1, mp):
        target = E * m // mp
        bi = int(np.searchsorted(bstart, target, side="left"))
        cuts.append(int(bstart[bi]) if bi < nb else E)
    cuts.append(E)

    shards: List[dict] = []
    e_pad = 1
    t_size = 8
    probes = 1
    maxb = 1
    for m in range(mp):
        lo, hi = cuts[m], cuts[m + 1]
        cnt = hi - lo
        e_pad = max(e_pad, cnt)
        shards.append({"lo": lo, "hi": hi})
    # shared table size
    max_buckets = 1
    for m in range(mp):
        lo, hi = shards[m]["lo"], shards[m]["hi"]
        if hi > lo:
            nb_m = int(np.sum((bstart >= lo) & (bstart < hi)))
            max_buckets = max(max_buckets, nb_m)
    while t_size < max_buckets / load_factor:
        t_size *= 2

    out = ShardedIndex(
        h=idx.h, kw=idx.kw, mp=mp, e_pad=e_pad,
        max_probes=1, max_bucket=max(1, idx.max_bucket),
        key_words=np.zeros((mp, e_pad, idx.kw), np.uint32),
        length=np.full((mp, e_pad), 1 << 30, np.int32),
        rid1=np.zeros((mp, e_pad), np.int32),
        rid2=np.zeros((mp, e_pad), np.int32),
        ucount1=np.zeros((mp, e_pad), np.int32),
        ucount2=np.zeros((mp, e_pad), np.int32),
        table_lo=np.zeros((mp, t_size), np.uint32),
        table_hi=np.zeros((mp, t_size), np.uint32),
        table_start=np.full((mp, t_size), -1, np.int32),
        table_count=np.zeros((mp, t_size), np.int32),
        orig_id=np.full((mp, e_pad), -1, np.int32),
    )

    from ..index.table import _assign_slots

    # vectorized per-shard slot assignment; grow the (shared) table size
    # until every shard fits with bounded displacement
    shard_slots = None
    while True:
        shard_slots = []
        ok = True
        for m in range(mp):
            lo, hi = shards[m]["lo"], shards[m]["hi"]
            bsel = (bstart >= lo) & (bstart < hi)
            hv = hash_prefix(plo[bstart[bsel]], phi[bstart[bsel]]).astype(np.int64) & (t_size - 1)
            slots, disp = _assign_slots(hv, t_size)
            if slots is None:
                ok = False
                break
            shard_slots.append((bsel, slots, disp))
        if ok:
            break
        t_size *= 2
        out.table_lo = np.zeros((mp, t_size), np.uint32)
        out.table_hi = np.zeros((mp, t_size), np.uint32)
        out.table_start = np.full((mp, t_size), -1, np.int32)
        out.table_count = np.zeros((mp, t_size), np.int32)

    for m in range(mp):
        lo, hi = shards[m]["lo"], shards[m]["hi"]
        cnt = hi - lo
        if cnt == 0:
            continue
        out.key_words[m, :cnt] = idx.key_words[lo:hi]
        out.length[m, :cnt] = idx.length[lo:hi]
        out.rid1[m, :cnt] = idx.rid1[lo:hi]
        out.rid2[m, :cnt] = idx.rid2[lo:hi]
        out.ucount1[m, :cnt] = idx.ucount1[lo:hi]
        out.ucount2[m, :cnt] = idx.ucount2[lo:hi]
        out.orig_id[m, :cnt] = np.arange(lo, hi, dtype=np.int32)
        bsel, slots, disp = shard_slots[m]
        bs = bstart[bsel] - lo
        bc = np.diff(np.concatenate([bs, [cnt]]))
        out.table_lo[m, slots] = plo[bstart[bsel]]
        out.table_hi[m, slots] = phi[bstart[bsel]]
        out.table_start[m, slots] = bs
        out.table_count[m, slots] = bc
        probes = max(probes, disp + 1)
    out.max_probes = probes
    return out


def _entry_prefixes(idx: FlatIndex) -> Tuple[np.ndarray, np.ndarray]:
    from ..index.table import _prefix_lo_hi

    return _prefix_lo_hi(idx.key_words, idx.h)


def _local_didx(sh, h, kw, max_probes, max_bucket):
    """Build a DeviceIndex view from a shard's (leading-axis-1) blocks."""
    return DeviceIndex(
        h=h, kw=kw, max_probes=max_probes, max_bucket=max_bucket,
        num_entries=int(sh["length"].shape[-1]),
        table_bits=int(sh["table_start"].shape[-1]).bit_length() - 1,
        key_words=sh["key_words"][0],
        length=sh["length"][0],
        rid1=sh["rid1"][0],
        rid2=sh["rid2"][0],
        ucount1=sh["ucount1"][0],
        ucount2=sh["ucount2"][0],
        table_lo=sh["table_lo"][0],
        table_hi=sh["table_hi"][0],
        table_start=sh["table_start"][0],
        table_count=sh["table_count"][0],
    )


def _shard_arrays(s: ShardedIndex) -> dict:
    return {
        "key_words": s.key_words, "length": s.length,
        "rid1": s.rid1, "rid2": s.rid2,
        "ucount1": s.ucount1, "ucount2": s.ucount2,
        "table_lo": s.table_lo, "table_hi": s.table_hi,
        "table_start": s.table_start, "table_count": s.table_count,
    }


@dataclasses.dataclass
class _MergedSource:
    """Uniform fused-record view over a MergedIndex (host arrays) or a
    MergedArtifact (memmaps): the shard builder slices these lazily, so a
    process only ever materializes ITS shards' pages."""

    h: int
    kw: int
    eu: int
    ed: int
    max_bucket: int
    n_colors: int
    E: int
    NB: int
    erec: np.ndarray       # uint32 [E, kw+1]
    prec: np.ndarray       # int32 [E, 3]
    pref_lo: np.ndarray    # uint32 [NB]
    pref_hi: np.ndarray    # uint32 [NB]
    bucket_start: np.ndarray
    bucket_count: np.ndarray

    @classmethod
    def from_merged(cls, m) -> "_MergedSource":
        from ..query.sortjoin import _fused_records

        erec, brec, prec = _fused_records(
            m.key_words, m.length, m.color, m.bucket_start, m.bucket_count,
            m.gid, m.rid1, m.rid2, np,
        )
        return cls(h=m.h, kw=m.kw, eu=m.eu, ed=m.ed,
                   max_bucket=m.max_bucket, n_colors=m.n_colors,
                   E=int(m.length.shape[0]), NB=int(m.pref_lo.shape[0]),
                   erec=erec, prec=prec,
                   pref_lo=m.pref_lo, pref_hi=m.pref_hi,
                   bucket_start=m.bucket_start, bucket_count=m.bucket_count)

    @classmethod
    def from_artifact(cls, a) -> "_MergedSource":
        return cls(h=a.h, kw=a.kw, eu=a.eu, ed=a.ed,
                   max_bucket=a.max_bucket, n_colors=a.n_colors,
                   E=a.E, NB=a.NB,
                   erec=a.erec, prec=a.prec,
                   pref_lo=a.pref_lo, pref_hi=a.pref_hi,
                   bucket_start=a.brec[:, 0], bucket_count=a.brec[:, 1])


def shard_merged_cuts(src: _MergedSource, mp: int):
    """Bucket-aligned equal-entry shard cuts.  Returns (cuts_b, e_lo, e_hi,
    e_pad, nb_pad, db).  Padded bucket rows carry bucket_count=0 and sort
    after real rows within a hash-tied run (row ids are part of the join
    sort key), so they can never shadow a real bucket; padded entries use
    the never-matching erec length."""
    from ..query.sortjoin import _HHI_BITS  # noqa: F401  (doc anchor)

    NB, E = src.NB, src.E
    # equal-ENTRY cuts (entries dominate shard memory; equal-bucket cuts
    # pad every shard to the most entry-heavy one on skewed indexes)
    bs = np.asarray(src.bucket_start)
    cuts_b = [0] + [
        int(np.searchsorted(bs, E * i // mp, side="left"))
        for i in range(1, mp)
    ] + [NB]
    for i in range(1, mp):
        cuts_b[i] = min(max(cuts_b[i], cuts_b[i - 1]), NB)
    # snap cuts forward so bucket rows sharing one entry span (hash
    # collisions merged by hlo) never split across shards
    for i in range(1, mp):
        c = cuts_b[i]
        while 0 < c < NB and src.bucket_start[c] == src.bucket_start[c - 1]:
            c += 1
        cuts_b[i] = min(max(c, cuts_b[i - 1]), NB)
    nb_pad = max(1, max(cuts_b[i + 1] - cuts_b[i] for i in range(mp)))
    e_lo = [int(src.bucket_start[cuts_b[i]]) if cuts_b[i] < NB else E
            for i in range(mp)]
    e_hi = e_lo[1:] + [E]
    e_pad = max(1, max(h - l for l, h in zip(e_lo, e_hi)))
    db = max(8, min(20, max(int(nb_pad).bit_length() - 5, 8)))
    # per-shard blocked bloom (see sortjoin._build_bloom); the log size is
    # shared across shards — it is baked into the jitted program.  Cap at
    # sortjoin.BLOOM_LOG_WORDS (not 2^24): a shard with nb_pad > ~16M rows
    # at a 2^24-word filter measured 3.5% FP and a throughput-halving
    # capacity widening (PERF.md "Index-size scaling").
    from ..query.sortjoin import BLOOM_LOG_WORDS

    bloom_log = min(max(int(nb_pad).bit_length(), 12), BLOOM_LOG_WORDS)
    # per-shard cuckoo span table at load <= 0.4 (the table shape is baked
    # into the multi-process jitted program, so the size must be derivable
    # from shard geometry alone; _build_cuckoo raises on the ~impossible
    # fixed-size placement failure)
    ck_log = max(int(np.ceil(np.log2(max(nb_pad, 2) / 1.6))), 10)
    return cuts_b, e_lo, e_hi, e_pad, nb_pad, db, bloom_log, ck_log


def build_fused_shard(src: _MergedSource, i: int, cuts_b, e_lo, e_hi,
                      e_pad: int, nb_pad: int, db: int,
                      bloom_log: int | None = None,
                      ck_log: int | None = None):
    """Materialize shard i's padded fused-record arrays (one host slice
    per array - with a memmap source this faults in only shard i's pages).
    Returns (dict of arrays, dir span steps)."""
    from ..query.sortjoin import (NEVER_LEN, _build_bloom, _build_cuckoo,
                                  _build_directory)

    kw1 = src.erec.shape[1]
    erec = np.zeros((e_pad, kw1), np.uint32)
    erec[:, kw1 - 1] = np.uint32(NEVER_LEN)
    prec = np.zeros((e_pad, 3), np.int32)
    pref_lo = np.full(nb_pad, 0xFFFFFFFF, np.uint32)
    pref_hi = np.full(nb_pad, 0xFFFFFFFF, np.uint32)
    brec = np.zeros((nb_pad, 2), np.int32)
    blo, bhi = cuts_b[i], cuts_b[i + 1]
    lo, hi = e_lo[i], e_hi[i]
    ec, bc = hi - lo, bhi - blo
    if ec:
        erec[:ec] = src.erec[lo:hi]
        prec[:ec] = src.prec[lo:hi]
    if bc:
        pref_lo[:bc] = src.pref_lo[blo:bhi]
        pref_hi[:bc] = src.pref_hi[blo:bhi]
        brec[:bc, 0] = np.asarray(src.bucket_start[blo:bhi], np.int64) - lo
        brec[:bc, 1] = src.bucket_count[blo:bhi]
    ds, _, steps = _build_directory(pref_lo, db=db)
    out = dict(erec=erec, prec=prec, pref_lo=pref_lo, pref_hi=pref_hi,
               brec=brec, dir_start=ds.astype(np.int32))
    if bloom_log is not None:
        # pads (0xFFFFFFFF rows) enter the filter too: a probe matching a
        # pad can only be a false positive, and pads carry a (0, 0) span
        out["bloom"] = _build_bloom(pref_lo, log_words=bloom_log)[0]
    if ck_log is not None:
        # real rows only: the pad key (0xFFFFFFFF, count 0) would read as
        # empty anyway, and bc rows are what the search must resolve
        from ..query.sortjoin import (BUCKET_SCAN_UNROLL,
                                      _cuckoo_kv_from_table)

        tab = _build_cuckoo(pref_lo[:max(bc, 1)], brec[:max(bc, 1), 0],
                            brec[:max(bc, 1), 1], tlog=ck_log)[0]
        out["cuckoo"] = (_cuckoo_kv_from_table(tab)
                         if src.max_bucket <= BUCKET_SCAN_UNROLL else tab)
    return out, steps


def _shard_dir_steps(pl_slice: np.ndarray, nb_pad: int, db: int) -> int:
    """Binary-search rounds a shard's directory needs - the padded-row
    variant of _build_directory's steps, computed WITHOUT materializing the
    padded arrays (pads are 0xFFFFFFFF and land in the last cell)."""
    pl = np.asarray(pl_slice, np.uint64)
    tops = (np.arange((1 << db) + 1, dtype=np.uint64) << np.uint64(32 - db))
    tops = np.minimum(tops, np.uint64(0xFFFFFFFF) + np.uint64(1))
    ds = np.searchsorted(pl, tops, side="left")
    spans = np.diff(ds).astype(np.int64)
    if spans.size:
        spans[-1] += nb_pad - pl.shape[0]
        max_span = int(spans.max())
    else:
        max_span = nb_pad
    return max(int(max_span).bit_length() + 1, 1)


class DistSortJoinSession:
    """Distributed sort-join classify over a ('data', 'model') mesh.

    Reads shard over 'data'; the merged index shards over 'model'
    (bucket-aligned).  Each device runs the local sort-join against its
    shard; per-read MatchSlots all_gather over 'model' (slot ids are
    global, so cross-shard dedup is automatic); the case analysis runs
    replicated and counts psum.
    """

    def __init__(
        self,
        mesh,
        index_u: Optional[FlatIndex] = None,
        index_d: Optional[FlatIndex] = None,
        num_genome_slots: int = 0,
        sc_mode: bool = False,
        maxm: int = 32,
        hit_capacity_frac: int = 32,
        merged=None,
        verbose: bool = False,
    ):
        """merged: optional precomputed source - a MergedIndex, or a
        MergedArtifact (index/artifact.py), in which case each process
        lazily faults in ONLY its model shards' pages from the memmapped
        artifact (no full-index host copies, no per-process lexsorts)."""
        import sys

        import jax
        from jax.sharding import NamedSharding, PartitionSpec as P

        from ..query.sortjoin import build_merged_index

        self.mesh = mesh
        self.G = num_genome_slots
        mp = mesh.shape["model"]
        dp = mesh.shape["data"]
        self.mp, self.dp = mp, dp
        self.sc = sc_mode
        if merged is None:
            src = _MergedSource.from_merged(build_merged_index(index_u, index_d))
        elif hasattr(merged, "path"):          # MergedArtifact
            src = _MergedSource.from_artifact(merged)
        else:                                   # prebuilt MergedIndex
            src = _MergedSource.from_merged(merged)
        self.eu, self.ed = src.eu, src.ed
        (cuts_b, e_lo, e_hi, e_pad, nb_pad, db,
         bloom_log, ck_log) = shard_merged_cuts(src, mp)
        # span steps must be a process-independent static (it is baked into
        # the jitted program): derive every shard's from its pref_lo slice
        span_steps = 1
        for i in range(mp):
            span_steps = max(span_steps, _shard_dir_steps(
                src.pref_lo[cuts_b[i]:cuts_b[i + 1]], nb_pad, db))
        self._meta = (src.h, src.kw, src.max_bucket, src.n_colors, db,
                      span_steps, bloom_log, ck_log)
        self._fns = {}
        self._maxm = maxm
        self._frac = hit_capacity_frac
        if verbose or mp > 1:
            sizes = [e_hi[i] - e_lo[i] for i in range(mp)]
            print(
                f"[dist] model shards: {mp} x {e_pad} entries (pad), "
                f"utilization min {min(sizes) / max(e_pad, 1):.2f} / max "
                f"{max(sizes) / max(e_pad, 1):.2f}, buckets pad {nb_pad}",
                file=sys.stderr,
            )

        from ..query.sortjoin import BUCKET_SCAN_UNROLL

        kv_cuckoo = src.max_bucket <= BUCKET_SCAN_UNROLL
        self._kv_cuckoo = kv_cuckoo
        # lazy shard materialization: the callback builds ONLY the shards
        # this process addresses (single- and multi-process alike), so no
        # full padded host stack ever exists
        kw1 = src.erec.shape[1]
        shapes = {
            "erec": ((mp, e_pad, kw1), np.uint32),
            "prec": ((mp, e_pad, 3), np.int32),
            "pref_lo": ((mp, nb_pad), np.uint32),
            "pref_hi": ((mp, nb_pad), np.uint32),
            "brec": ((mp, nb_pad, 2), np.int32),
            "dir_start": ((mp, (1 << db) + 1), np.int32),
            "bloom": ((mp, 1 << bloom_log), np.uint32),
            "cuckoo": ((mp, 1 << ck_log,
                        8 if kv_cuckoo else 12), np.uint32),
        }
        cache: dict = {}

        def get_shard(i: int) -> dict:
            if i not in cache:
                cache[i] = build_fused_shard(
                    src, i, cuts_b, e_lo, e_hi, e_pad, nb_pad, db,
                    bloom_log=bloom_log, ck_log=ck_log)[0]
            return cache[i]

        def make(name, shape, dtype):
            def cb(idx):
                rows = range(*idx[0].indices(mp))
                parts = [get_shard(i)[name][tuple(idx[1:])] for i in rows]
                return np.stack(parts).astype(dtype, copy=False)

            return jax.make_array_from_callback(
                shape, NamedSharding(mesh, P("model")), cb)

        self._shards = {k: make(k, s, d) for k, (s, d) in shapes.items()}
        cache.clear()

    def _get_fn(self, frac: int, maxm: int, with_rcounts: bool = True):
        key = (frac, maxm, with_rcounts)
        if key in self._fns:
            return self._fns[key]
        import jax
        import jax.numpy as jnp
        from jax.sharding import PartitionSpec as P

        from ..query.classify import MatchSlots, case_analysis, rcounts_from_case
        from ..query.sortjoin import DeviceMergedIndex, collect_matches_sortjoin

        (h, kw, max_bucket, n_colors, db, span_steps, bloom_log,
         ck_log) = self._meta
        kv_ck = self._kv_cuckoo
        eu, ed, mp, G, sc = self.eu, self.ed, self.mp, self.G, self.sc

        def local_fn(sh, codes, lengths):
            dmi = DeviceMergedIndex(
                h=h, kw=kw, eu=eu, ed=ed, max_bucket=max_bucket,
                n_colors=n_colors,
                pref_lo=sh["pref_lo"][0], pref_hi=sh["pref_hi"][0],
                dir_start=sh["dir_start"][0], dir_bits=db,
                dir_span_steps=span_steps,
                erec=sh["erec"][0], brec=sh["brec"][0], prec=sh["prec"][0],
                bloom=sh["bloom"][0], bloom_log=bloom_log,
                cuckoo_log=ck_log,
                **({"cuckoo_kv": sh["cuckoo"][0]} if kv_ck
                   else {"cuckoo": sh["cuckoo"][0]}),
            )
            ms, ovh, ovs = collect_matches_sortjoin(
                dmi, codes, lengths, hit_capacity_frac=frac, maxm=maxm)
            gathered = MatchSlots(
                *(jax.lax.all_gather(x, "model", axis=1, tiled=True) for x in ms)
            )
            case = case_analysis(gathered, lengths, G, sc_mode=sc)
            cnts_u = jax.lax.psum(case.cnts_u, ("data", "model")) // mp
            cnts_d = jax.lax.psum(case.cnts_d, ("data", "model")) // mp
            nundet = jax.lax.psum(case.nundet, ("data", "model")) // mp
            nconf = jax.lax.psum(case.nconf, ("data", "model")) // mp
            if with_rcounts:
                # DEFERRED reduction: rcounts leave as per-DATA-shard
                # partials ([1, E] per device, model-replicated since the
                # case analysis runs on the all_gathered matches) — a
                # per-batch E-sized psum here measured 9x the batch cost
                # on the virtual mesh (benchmarks/dist_perf.py) and would
                # move ~250 MB/batch between devices at the 61M-entry
                # index; the caller accumulates the sharded partials and
                # reduces ONCE per query pass
                rcu = rcounts_from_case(case, 0, max(eu, 1))[None, :]
                rcd = rcounts_from_case(case, eu, max(ed, 1))[None, :]
            else:
                rcu = jnp.zeros((1, 1), jnp.int32)
                rcd = jnp.zeros((1, 1), jnp.int32)
            ovh = jax.lax.psum(ovh, ("data", "model"))
            ovs = jax.lax.psum(ovs, ("data", "model"))
            return (cnts_u, cnts_d, rcu, rcd, nundet, nconf,
                    case.pair_lo, case.pair_hi, ovh, ovs)

        spec_sh = {k: P("model") for k in self._shards}
        fn = shard_map_fn(
            self.mesh, local_fn,
            in_specs=(spec_sh, P("data", None), P("data")),
            out_specs=(P(), P(), P("data", None), P("data", None), P(),
                       P(), P("data"), P("data"), P(), P()),
        )
        import jax as _jax

        self._fns[key] = _jax.jit(fn)
        return self._fns[key]

    def classify_raw(self, codes, lengths, with_rcounts: bool = True):
        """Device-resident classification of one (global) batch: returns
        (BatchCounts of device arrays, overflow_hits, overflow_slots)
        with NO host syncs — the caller accumulates across batches on
        device and checks overflow once per pass (query/pipeline.py)."""
        import jax
        import jax.numpy as jnp

        from ..query.classify import BatchCounts

        if not isinstance(codes, jax.Array):
            codes = jnp.asarray(codes)
        if not isinstance(lengths, jax.Array):
            lengths = jnp.asarray(lengths)
        out = self._get_fn(self._frac, self._maxm, with_rcounts)(
            self._shards, codes, lengths)
        (cnts_u, cnts_d, rcu, rcd, nundet, nconf, pair_lo, pair_hi,
         ovh, ovs) = out
        return (
            BatchCounts(
                cnts_u=cnts_u, cnts_d=cnts_d,
                # [dp, E] per-data-shard partials (deferred reduction;
                # sum over axis 0 once per pass)
                rcount_u=rcu[:, : self.eu],
                rcount_d=rcd[:, : self.ed],
                nundet=nundet, nconf=nconf,
                pair_lo=pair_lo, pair_hi=pair_hi,
            ),
            ovh, ovs,
        )

    def classify(self, codes: np.ndarray, lengths: np.ndarray):
        """Classify with overflow auto-widen: a capacity overflow on any
        shard re-runs the batch at a widened capacity (recompiles once per
        tier, then cached) instead of killing the run - mirroring the
        single-device retry in query/pipeline.py."""
        import jax
        import jax.numpy as jnp

        from ..query.classify import BatchCounts

        frac, maxm = self._frac, self._maxm
        # accept pre-assembled global arrays (multi-host callers build them
        # with multihost.global_batch_from_local)
        if not isinstance(codes, jax.Array):
            codes = jnp.asarray(codes)
        if not isinstance(lengths, jax.Array):
            lengths = jnp.asarray(lengths)
        while True:
            out = self._get_fn(frac, maxm)(self._shards, codes, lengths)
            (cnts_u, cnts_d, rcu, rcd, nundet, nconf, pair_lo, pair_hi,
             ovh, ovs) = out
            if not (int(ovh) or int(ovs)):
                break
            if int(ovh):
                frac = max(frac // 2, 1)
            if int(ovs):
                maxm *= 2
            if frac < 1 or maxm > 4096:
                raise RuntimeError(
                    f"sort-join capacity overflow persists across shards "
                    f"(hits={int(ovh)}, slots={int(ovs)})")
        if jax.process_count() > 1:
            # pair rows are data-sharded across processes; gather them so
            # every host sees the global per-read pair assignment
            from jax.experimental import multihost_utils

            pair_lo = multihost_utils.process_allgather(pair_lo, tiled=True)
            pair_hi = multihost_utils.process_allgather(pair_hi, tiled=True)
        # reduce the deferred [dp, E] rcount partials ON DEVICE to a
        # replicated [E] (a host-side sum would need non-addressable
        # shards under multi-process meshes)
        from jax.sharding import NamedSharding, PartitionSpec as _P

        red = jax.jit(lambda x: x.sum(axis=0),
                      out_shardings=NamedSharding(self.mesh, _P()))
        rcu = red(rcu)
        rcd = red(rcd)
        return BatchCounts(
            cnts_u=np.asarray(cnts_u), cnts_d=np.asarray(cnts_d),
            rcount_u=np.asarray(rcu)[: self.eu],
            rcount_d=np.asarray(rcd)[: self.ed],
            nundet=int(nundet), nconf=int(nconf),
            pair_lo=np.asarray(pair_lo), pair_hi=np.asarray(pair_hi),
        )


class DistQuerySession:
    """Distributed classify over a ('data', 'model') mesh."""

    def __init__(
        self,
        mesh,
        index_u: FlatIndex,
        index_d: Optional[FlatIndex],
        num_genome_slots: int,
        sc_mode: bool = False,
    ):
        import jax
        import jax.numpy as jnp
        from jax.sharding import NamedSharding, PartitionSpec as P

        self.mesh = mesh
        self.G = num_genome_slots
        mp = mesh.shape["model"]
        dp = mesh.shape["data"]
        self.mp, self.dp = mp, dp
        self.sc_mode = sc_mode

        if index_d is None:
            from ..index.sparsify import SelectedSubstrings
            from ..index.table import build_flat_index

            index_d = build_flat_index(
                np.zeros(1, np.uint8),
                SelectedSubstrings(
                    start=np.zeros(0, np.int64), length=np.zeros(0, np.int64),
                    rid=np.zeros(0, np.int64), occ=np.zeros(0, np.int64),
                    rid2=np.zeros(0, np.int64), occ2=np.zeros(0, np.int64),
                    ulm_count=np.zeros(0, np.int64),
                ),
                index_u.h, 32, True,
            )
        self.su = shard_flat_index(index_u, mp)
        self.sd = shard_flat_index(index_d, mp)
        self.index_u, self.index_d = index_u, index_d

        su, sd = self.su, self.sd
        G = num_genome_slots
        sc = sc_mode
        Eu_pad, Ed_pad = su.e_pad, sd.e_pad

        def local_fn(u_arrays, d_arrays, codes, lengths):
            m = jax.lax.axis_index("model")
            didx_u = _local_didx(u_arrays, su.h, su.kw, su.max_probes, su.max_bucket)
            didx_d = _local_didx(d_arrays, sd.h, sd.kw, sd.max_probes, sd.max_bucket)
            u_base = m * Eu_pad
            d_base = mp * Eu_pad + m * Ed_pad
            ms = collect_matches(didx_u, didx_d, codes, lengths,
                                 u_base=u_base, d_base=d_base)
            # gather match slots across index shards
            def gather(x):
                g = jax.lax.all_gather(x, "model", axis=1, tiled=True)
                return g

            ms_full = MatchSlots(*(gather(x) for x in ms))
            case = case_analysis(ms_full, lengths, G, sc_mode=sc)
            cnts_u = jax.lax.psum(case.cnts_u, "data")
            cnts_d = jax.lax.psum(case.cnts_d, "data")
            nundet = jax.lax.psum(case.nundet, "data")
            nconf = jax.lax.psum(case.nconf, "data")
            rcu = jax.lax.psum(rcounts_from_case(case, u_base, Eu_pad), "data")
            rcd = jax.lax.psum(rcounts_from_case(case, d_base, Ed_pad), "data")
            # counts are replicated along 'model' by construction; make the
            # replication explicit for shard_map's rep checker
            cnts_u = jax.lax.psum(cnts_u, "model") // mp
            cnts_d = jax.lax.psum(cnts_d, "model") // mp
            nundet = jax.lax.psum(nundet, "model") // mp
            nconf = jax.lax.psum(nconf, "model") // mp
            return (cnts_u, cnts_d, rcu, rcd, nundet, nconf,
                    case.pair_lo, case.pair_hi)

        spec_u = {k: P("model") for k in _shard_arrays(su)}
        spec_d = dict(spec_u)
        fn = shard_map_fn(
            self.mesh, local_fn,
            in_specs=(spec_u, spec_d, P("data", None), P("data")),
            out_specs=(P(), P(), P("model"), P("model"), P(), P(),
                       P("data"), P("data")),
        )
        self._fn = jax.jit(fn)
        self._u_arrays = jax.device_put(
            _shard_arrays(su),
            {k: NamedSharding(mesh, P("model")) for k in _shard_arrays(su)},
        )
        self._d_arrays = jax.device_put(
            _shard_arrays(sd),
            {k: NamedSharding(mesh, P("model")) for k in _shard_arrays(sd)},
        )

    def classify(self, codes: np.ndarray, lengths: np.ndarray) -> BatchCounts:
        """codes [B, Lp] with B divisible by dp.  Returns host BatchCounts
        with rcounts mapped back to original entry order."""
        import jax.numpy as jnp

        out = self._fn(self._u_arrays, self._d_arrays,
                       jnp.asarray(codes), jnp.asarray(lengths))
        cnts_u, cnts_d, rcu, rcd, nundet, nconf, pair_lo, pair_hi = out
        rcu = np.asarray(rcu).reshape(self.mp, self.su.e_pad)
        rcd = np.asarray(rcd).reshape(self.mp, self.sd.e_pad)
        rcount_u = np.zeros(self.index_u.num_entries, np.int64)
        rcount_d = np.zeros(self.index_d.num_entries, np.int64)
        sel = self.su.orig_id >= 0
        rcount_u[self.su.orig_id[sel]] = rcu[sel]
        seld = self.sd.orig_id >= 0
        rcount_d[self.sd.orig_id[seld]] = rcd[seld]
        return BatchCounts(
            cnts_u=np.asarray(cnts_u), cnts_d=np.asarray(cnts_d),
            rcount_u=rcount_u, rcount_d=rcount_d,
            nundet=int(nundet), nconf=int(nconf),
            pair_lo=np.asarray(pair_lo), pair_hi=np.asarray(pair_hi),
        )
