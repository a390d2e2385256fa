"""Sort-join probe: the hot loop restructured around lax.sort.

The baseline probe (probe.py) does O(max_probes + max_bucket * kw) random
gathers per (read, offset, strand, table).  This engine replaces the
hash-table lookup with a sort-merge join over fixed-shape batches:

1. both tables' entries are merged host-side into one bucket list keyed by
   a 41-bit HASH of the h-base prefix; every entry additionally gets a
   REVERSE-COMPLEMENT twin carrying the same global id, so the query
   probes ONLY the forward strand (read RC contains entry e iff the read
   contains RC(e)) - this halves every sort/scan in the hot loop.  The
   RC-augmented key set may lose the per-table prefix-freeness the
   ≤1-match-per-offset argument needs (RC twins form prefix chains when
   original keys share suffixes), so entries are CHAIN-COLORED host-side:
   within one color class keys are distinct and prefix-free, and the
   bucket scan keeps one found-slot per color.  Bucket entry spans are
   keyed by the 32-bit primary hash, so prefixes that collide share a
   span and the verify stage separates them;
2. per batch the probes join the bucket list by one of three exact
   strategies (join='auto' picks by regime):
   - PRODUCTION (NB > 4N, 'bloom'): one blocked-bloom gather per probe
     (no false negatives) filters the ~99% non-matching probes; the
     survivors compact to K and the span lookup runs on K rows only;
   - 'dir': directory + binary search at full N (the r3 design, kept as
     an equality-tested fallback);
   - small-index ('sort'): probe hashes and bucket hashes sorted
     together (lax.sort on TWO fused words: primary hash | (secondary
     hash, tag, row id)); a first-of-run associative scan propagates
     each bucket row onto its probe rows - zero gathers;
3. probe rows that joined a bucket are compacted to a fixed capacity K,
   so the masked-compare bucket scan does its gathers on ~hit-rate * N
   positions instead of N;
4. matches are assembled into per-read distinct slot arrays [B, MAXM]
   (sort by (read, entry) + segmented rank), feeding the unchanged case
   analysis.

Exactness matches probe.py (which probes both strands of the read against
the un-augmented tables): the strand bijection is
  RC(read)[o':o'+m] == e  <=>  read[rl-o'-m : rl-o'] == RC(e),
and matches dedup by (read, gid), so an entry found on both strands
counts once, exactly like the reference's distinct-pleafNode sets
(src/query.cpp:530-540).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np

from ..index.table import FlatIndex, _prefix_lo_hi
from ..ops.packing import length_masks, pack_words, rev2bit_u32
from .classify import BIG, MatchSlots, revcomp_batch
from .probe import pack_rolling16


@dataclasses.dataclass
class MergedIndex:
    """Both tables merged + RC-augmented into one bucket list (host numpy)."""

    h: int
    kw: int
    eu: int                   # unique-table entry count (global id base)
    ed: int
    max_bucket: int
    n_colors: int             # prefix-chain colors (found-slots per probe)
    # merged entries, bucket-sorted
    key_words: np.ndarray     # uint32 [E, kw]
    length: np.ndarray        # int32 [E]
    rid1: np.ndarray          # int32 [E]
    rid2: np.ndarray          # int32 [E]
    gid: np.ndarray           # int32 [E] global id (u: [0,Eu), d: [Eu,Eu+Ed))
    color: np.ndarray         # int32 [E] chain color (< n_colors)
    # bucket rows: one per distinct (hlo, hhi) prefix hash; rows sharing
    # an hlo (prefix collisions) reference the same full entry span
    pref_lo: np.ndarray       # uint32 [NB] primary 32-bit prefix hash
    pref_hi: np.ndarray       # uint32 [NB] secondary 9-bit prefix hash
    bucket_start: np.ndarray  # int32 [NB] entry span start (per hlo)
    bucket_count: np.ndarray  # int32 [NB] entry span length
    # hash-space directory for the large-NB probe path: dir_start[t] =
    # first bucket row whose top dir_bits of pref_lo equal t
    dir_start: np.ndarray = None   # int32 [2^dir_bits + 1]
    dir_bits: int = 0
    dir_span_steps: int = 0        # binary-search rounds within a cell


# directory cells (4 MB of int32 at the cap); ~NB/2^20 rows per cell.
# Any value is exact.  20 was chosen by timing on the previous
# accelerator (a 24-bit directory searched slower there); not yet
# measured on the H100.
DIR_BITS = 20

# blocked bloom filter cap: 2^26 uint32 words (256 MB) keeps the load at
# ~1 key/word up to NB = 64M (the 4K-genome config measures 61M bucket
# rows; capping at 2^24 there meant 3.6 keys/word, 3.5% false positives,
# and a 4x capacity widening that halved throughput)
BLOOM_LOG_WORDS = 26


def _build_bloom(pref_lo: np.ndarray, log_words: int | None = None):
    """Blocked bloom filter over the bucket hashes: one uint32 word per
    cell (top `log_words` bits of the key), 3 bit positions from the low
    key bits.  The hot loop tests membership with ONE gather per probe —
    ~99.9% of probes are non-matches at production scale, so the
    dir_span_steps binary-search rounds then run on only the compacted
    survivors instead of every (read, offset) candidate.

    pref_lo must be sorted ascending (bucket rows are), so equal cells
    are contiguous and the table builds with one bitwise_or.reduceat.
    Returns (table, log_words); the table sizes to ~1 word per key
    (capped at 2^BLOOM_LOG_WORDS = 64 MB)."""
    keys = np.ascontiguousarray(pref_lo, np.uint32)
    if log_words is None:
        log_words = min(max(int(max(keys.shape[0], 1)).bit_length(), 12),
                        BLOOM_LOG_WORDS)
    table = np.zeros(1 << log_words, np.uint32)
    if keys.shape[0]:
        w = (keys >> np.uint32(32 - log_words)).astype(np.int64)
        bits = _bloom_bits(keys, np)
        starts = np.nonzero(np.concatenate([[True], w[1:] != w[:-1]]))[0]
        table[w[starts]] = np.bitwise_or.reduceat(bits, starts)
    return table, log_words


def _bloom_bits(key, xp):
    """3-bit mask for a key: positions from a MULTIPLICATIVE remix of the
    full 32-bit key, taken from the product's upper half — the word index
    is the key's top bits, so positions derived from raw low-bit fields
    would be partially determined by the word and collapse the filter's
    discrimination within a word (measured 2% FP vs the intended ~0.06%).
    """
    with np.errstate(over="ignore"):
        z = key * xp.uint32(0x9E3779B1)
    return (
        (xp.uint32(1) << ((z >> xp.uint32(16)) & xp.uint32(31)))
        | (xp.uint32(1) << ((z >> xp.uint32(21)) & xp.uint32(31)))
        | (xp.uint32(1) << ((z >> xp.uint32(26)) & xp.uint32(31)))
    )


# device-side bloom cap when the exact cuckoo stage follows.  Folding
# adds no false negatives, and its higher FP rate at 60M+ keys only
# costs recompaction slots, not wrong results.  24 (64 MB) was chosen by
# timing on the previous accelerator; not yet measured on the H100
# (benchmarks/gather_scaling.py measures the gather-cost curve)
BLOOM_DEVICE_LOG = 24


def _fold_bloom(table: np.ndarray, to_log: int):
    """Shrink a blocked bloom to 2^to_log words by OR-folding: the word
    index is the key's TOP log bits, so halving merges words (2i, 2i+1);
    bit positions are log-independent (_bloom_bits).  No false negatives
    are introduced — only the FP rate rises with the per-word load."""
    lw = int(table.shape[0]).bit_length() - 1
    while lw > to_log:
        table = np.bitwise_or(table[0::2], table[1::2])
        lw -= 1
    return table, lw


def _bloom_kwargs(pref_lo: np.ndarray, jnp, cap: int | None = None):
    table, lw = _build_bloom(np.asarray(pref_lo))
    if cap is not None and lw > cap:
        table, lw = _fold_bloom(table, cap)
    return {"bloom": jnp.asarray(table), "bloom_log": lw}


def _bloom_maybe(bloom, khlo, log_words: int, xp):
    """Membership test: (word & need) == need; no false negatives."""
    word = bloom[(khlo >> xp.uint32(32 - log_words)).astype(xp.int32)]
    need = _bloom_bits(khlo, xp)
    return (word & need) == need


def _build_directory(pref_lo: np.ndarray, db: int | None = None):
    """(dir_start, dir_bits, span_steps) over the sorted bucket hashes."""
    nb = pref_lo.shape[0]
    if db is None:
        db = max(8, min(DIR_BITS, max(int(nb).bit_length() - 5, 8)))
    tops = (np.arange((1 << db) + 1, dtype=np.uint64) << (32 - db)).astype(np.uint64)
    tops = np.minimum(tops, np.uint64(0xFFFFFFFF) + np.uint64(1))
    dir_start = np.searchsorted(
        pref_lo.astype(np.uint64), tops, side="left"
    ).astype(np.int32)
    max_span = int(np.diff(dir_start).max()) if nb else 1
    steps = max(int(max_span).bit_length() + 1, 1)
    return dir_start, db, steps


# ---- cuckoo span table: the large-index search stage without dependent
# gathers.  The bloom path's remaining dependent chain was dir_span_steps
# (7-8) binary-search rounds gathering pref_lo[mid] from an NB-sized
# operand, where TWO independent row gathers suffice.  So the artifact
# precomputes a 2-choice, 4-slot-per-bucket hash table mapping each
# DISTINCT 32-bit bucket hash to its entry span: row layout
# [k0..k3, s0..s3, c0..c3] (keys, span starts, span counts), empty slots
# have count 0 (a real span never does).  Lookup = 2 independent row
# gathers + vector compares; exactness is by full 32-bit key equality,
# identical to the binary search's pref_lo[found] == ck test, and the
# bucket scan verifies entry content either way.
CUCKOO_SLOTS = 4
# target load keys/(slots*rows) <= ~0.6: greedy 2-choice placement (no
# eviction chains) converges in a few rounds there; on failure the build
# retries one size up
_CUCKOO_LOAD = 2.4  # keys per ROW target (= 0.6 * CUCKOO_SLOTS)


def _cuckoo_pos(key, which: int, tlog: int, xp=np):
    C = xp.uint32
    with np.errstate(over="ignore"):
        if which == 0:
            z = key * C(0x9E3779B1)
        else:
            z = (key ^ C(0x85EBCA6B)) * C(0xC2B2AE35)
            z = z ^ (z >> C(15))
        p = z >> C(32 - tlog)
    return p.astype(np.int64 if xp is np else xp.int32)


def _cuckoo_try_place(keys, starts, counts, tlog: int, rng,
                      max_rounds: int = 64):
    """Parallel cuckoo placement with priority aging: every round ALL
    keys compete for their current-choice bucket's CUCKOO_SLOTS slots,
    older (more-displaced) keys winning ties — so a stuck key eventually
    EVICTS a settled one, which re-places via its alternate bucket (the
    vectorized equivalent of cuckoo hashing's displacement chains; pure
    greedy without eviction measurably jams at load ~0.45: ~11% of
    buckets are already full after the first round).  Returns the table
    or None if max_rounds pass without a full placement."""
    S = CUCKOO_SLOTS
    T = 1 << tlog
    nd = keys.shape[0]
    if nd == 0:
        return np.zeros((T, 3 * S), np.uint32)
    if nd > S * T:
        return None
    h = np.stack([_cuckoo_pos(keys, 0, tlog), _cuckoo_pos(keys, 1, tlog)])
    choice = np.zeros(nd, np.uint8)
    age = np.zeros(nd, np.int64)
    # sticky per-key tiebreak: settled winners stay settled unless an
    # older (more-displaced) key arrives, so later rounds touch only the
    # contended buckets — round 1 is the only full-population sort
    pri = rng.integers(0, 1 << 62, nd)
    occ = np.full((T, S), -1, np.int64)
    pending = np.arange(nd)
    for _ in range(max_rounds):
        if pending.size == 0:
            bi, si = np.nonzero(occ >= 0)
            ki = occ[bi, si]
            tab = np.zeros((T, 3 * S), np.uint32)
            tab[bi, si] = keys[ki]
            tab[bi, S + si] = np.asarray(starts, np.uint32)[ki]
            tab[bi, 2 * S + si] = np.asarray(counts, np.uint32)[ki]
            return tab
        pb = h[choice[pending], pending]
        aff = np.unique(pb)                     # contended buckets
        old = occ[aff].ravel()
        old = old[old >= 0]
        occ[aff] = -1
        cont = np.concatenate([old, pending])
        cb = np.concatenate([h[choice[old], old], pb])
        order = np.lexsort((pri[cont], -age[cont], cb))
        cs = cb[order]
        n = cs.shape[0]
        run_start = np.empty(n, bool)
        run_start[0] = True
        np.not_equal(cs[1:], cs[:-1], out=run_start[1:])
        first_pos = np.nonzero(run_start)[0]
        rank = np.arange(n) - first_pos[np.cumsum(run_start) - 1]
        win = rank < S
        winners = cont[order[win]]
        occ[cs[win], rank[win]] = winners
        losers = cont[order[~win]]
        choice[losers] ^= 1
        age[losers] += 1
        pending = losers
    return None


def _build_cuckoo(pref_lo, bucket_start, bucket_count,
                  tlog: int | None = None):
    """(table [T, 3*CUCKOO_SLOTS] uint32, tlog) over the DISTINCT primary
    bucket hashes; each key's span is its hlo run's full entry span (the
    first bucket row of the run — identical to lower_bound semantics).

    tlog=None sizes to keys/rows <= _CUCKOO_LOAD and retries one size up
    on placement failure.  A fixed tlog (the dist path: table shape is
    baked into a multi-process jitted program, so every process must
    agree statically) raises on failure instead — callers there size for
    load <= 0.4, where greedy 2-choice placement failing is a
    cryptographic-grade anomaly."""
    pref_lo = np.ascontiguousarray(pref_lo, np.uint32)
    nb = pref_lo.shape[0]
    first = np.ones(nb, bool)
    first[1:] = pref_lo[1:] != pref_lo[:-1]
    keys = pref_lo[first]
    starts = np.ascontiguousarray(bucket_start)[first]
    counts = np.ascontiguousarray(bucket_count)[first]
    nd = keys.shape[0]
    rng = np.random.default_rng(0xC0C0)
    if tlog is not None:
        tab = _cuckoo_try_place(keys, starts, counts, tlog, rng)
        if tab is None:
            raise RuntimeError(
                f"cuckoo span table: fixed-size placement failed at 2^{tlog}"
                f" rows for {nd} keys")
        return tab, tlog
    tl = max(int(np.ceil(np.log2(max(nd, 2) / _CUCKOO_LOAD))), 10)
    while tl <= 30:
        tab = _cuckoo_try_place(keys, starts, counts, tl, rng)
        if tab is not None:
            return tab, tl
        tl += 1
    raise RuntimeError("cuckoo span table: placement failed up to 2^30 rows")


def _cuckoo_lookup(tab, tlog: int, ck, jnp):
    """(found, span_start, span_count) for probe keys ck — two independent
    row gathers, exact by 32-bit key equality (empty slots have count 0)."""
    S = CUCKOO_SLOTS

    def side(which):
        r = tab[_cuckoo_pos(ck, which, tlog, jnp)]       # [K, 3S]
        hit = (r[:, 0:S] == ck[:, None]) & (r[:, 2 * S : 3 * S] > 0)
        f = hit.any(axis=1)
        st = jnp.sum(jnp.where(hit, r[:, S : 2 * S], 0), axis=1)
        ct = jnp.sum(jnp.where(hit, r[:, 2 * S : 3 * S], 0), axis=1)
        return f, st, ct

    f1, s1, c1 = side(0)
    f2, s2, c2 = side(1)
    found = f1 | f2
    st = jnp.where(f1, s1, s2).astype(jnp.int32)
    ct = jnp.where(f1, c1, c2).astype(jnp.int32)
    return found, st, ct


def _cuckoo_session_kwargs(tab: np.ndarray, tlog: int, max_bucket: int,
                           jnp) -> dict:
    """Device form of the span table: the packed kv layout (one gather
    per side) when the unrolled bucket scan applies, else the full
    12-word layout (the expand-path scan needs true span counts)."""
    if max_bucket <= BUCKET_SCAN_UNROLL:
        return {"cuckoo_kv": jnp.asarray(_cuckoo_kv_from_table(tab)),
                "cuckoo_log": tlog}
    return {"cuckoo": jnp.asarray(tab), "cuckoo_log": tlog}


def _cuckoo_kv_from_table(tab: np.ndarray) -> np.ndarray:
    """Pack the [T, 12] span table into [T, 2*CUCKOO_SLOTS] uint32 rows
    [k0..k3, s0+1..s3+1] (0 in the start half = empty slot).  The packed
    form drops the span COUNT: the unrolled bucket scan verifies entry
    content, and a full content match implies an equal h-prefix hash,
    i.e. the entry is in the probe's own bucket — so scanning a fixed
    max_bucket entries from the span start can never produce a
    cross-bucket match, and the count mask is redundant there.  Column
    slices of a gathered row fuse into the gather and split it, so a
    narrower row with fewer slices is the cheaper layout; the count
    columns buy nothing the verify does not."""
    S = CUCKOO_SLOTS
    keys = tab[:, 0:S]
    starts = tab[:, S:2 * S]
    counts = tab[:, 2 * S:3 * S]
    sp1 = np.where(counts > 0, starts + 1, 0).astype(np.uint32)
    return np.concatenate([keys, sp1], axis=1)


def _cuckoo_kv_lookup(kv, tlog: int, ck, max_bucket: int, jnp):
    """(found, span_start, span_count=max_bucket) — one [2S]-word row
    gather per hash side."""
    S = CUCKOO_SLOTS

    def side(which):
        r = kv[_cuckoo_pos(ck, which, tlog, jnp)]        # [K, 2S] uint32
        sp1 = r[:, S:2 * S]
        hit = (r[:, 0:S] == ck[:, None]) & (sp1 != 0)
        f = hit.any(axis=1)
        st = jnp.sum(jnp.where(hit, sp1, 0), axis=1)
        return f, st

    f1, s1 = side(0)
    f2, s2 = side(1)
    found = f1 | f2
    st1 = jnp.where(f1, s1, s2).astype(jnp.int32)    # start + 1, or 0
    st = jnp.where(found, st1 - 1, 0)
    ct = jnp.where(found, jnp.int32(max_bucket), 0)
    return found, st, ct


_HHI_BITS = 9  # secondary-hash width stored per bucket row

# bucket scan strategy cutover: max_bucket <= this unrolls a masked
# c-step sweep (fully fused); above it the scan segment-expands to one
# work item per candidate entry, keeping program size and runtime
# independent of max_bucket
BUCKET_SCAN_UNROLL = 8
# found-slot strategy: n_colors <= this uses per-color vector selects in
# the unrolled scan instead of a per-round [K, NC+1] scatter; above it,
# the single-scatter form keeps program size independent of n_colors.
# Both cutovers are exact either way and were chosen by timing on the
# previous accelerator; not yet measured on the H100.
COLOR_SELECT_UNROLL = 4


def _hash_prefix(lo, hi, xp=np):
    """Mix a (lo, hi) 2x32-bit packed h-prefix into a 32-bit primary hash
    and a 9-bit secondary hash (murmur3-style finalizers; identical uint32
    wraparound arithmetic under numpy and jax.numpy).

    The sort-join joins probes to buckets on (hlo, hhi) hash equality
    instead of the exact 52-bit prefix: the bucket scan fully verifies
    every candidate entry against the read, so a hash collision can only
    add a rejected candidate, never a wrong match.  Missed matches are
    impossible because bucket spans are keyed by hlo alone (equal prefix
    => equal hashes => joins the bucket's run)."""
    C = xp.uint32
    lo = lo.astype(xp.uint32)
    hi = hi.astype(xp.uint32)
    x = lo ^ (hi * C(0x9E3779B1))
    x = (x ^ (x >> C(16))) * C(0x85EBCA6B)
    x = (x ^ (x >> C(13))) * C(0xC2B2AE35)
    x = x ^ (x >> C(16))
    y = hi ^ (lo * C(0x27D4EB2F))
    y = (y ^ (y >> C(15))) * C(0x165667B1)
    y = y ^ (y >> C(13))
    return x, y & C((1 << _HHI_BITS) - 1)


_rev2bit_u32 = rev2bit_u32  # shared with index/table.py's prefix-free check


def _revcomp_packed(key_words: np.ndarray, length: np.ndarray, kw: int) -> np.ndarray:
    """Reverse-complement 2-bit-packed keys: rc[t] = 3 - key[len-1-t].

    Pure packed-word bit-twiddling (complement = XOR, base reversal =
    2-bit-group reversal + reversed word order, then a per-entry right
    shift by the padding width) - the unpack-to-codes route costs
    ~24 s per million entries at session build, this one is ~100x faster.
    """
    E = key_words.shape[0]
    length = np.asarray(length, np.int64)
    with np.errstate(over="ignore"):
        # full-width reverse complement: complement codes, reverse 2-bit
        # groups per word, reverse word order
        wrev = _rev2bit_u32(key_words[:, ::-1] ^ np.uint32(0xFFFFFFFF))
        # shift right by the pad bases so base 0 of the RC lands at bit 0
        sb = kw * 16 - length                      # pad width in bases
        ws = (sb // 16).astype(np.int64)           # whole-word shift
        bs = (2 * (sb % 16)).astype(np.uint32)     # in-word bit shift
        ext = np.concatenate([wrev, np.zeros((E, 1), np.uint32)], axis=1)
        w_idx = np.arange(kw, dtype=np.int64)[None, :] + ws[:, None]
        w_idx = np.minimum(w_idx, kw)
        lo = np.take_along_axis(ext, w_idx, axis=1)
        hi = np.take_along_axis(ext, np.minimum(w_idx + 1, kw), axis=1)
        bs_c = bs[:, None]
        out = np.where(
            bs_c == 0, lo,
            (lo >> bs_c) | (hi << ((np.uint32(32) - bs_c) & np.uint32(31))),
        ).astype(np.uint32)
        out &= length_masks(length, kw)
    return out


def _adjacent_lcp(words_sorted: np.ndarray, lens_sorted: np.ndarray,
                  kw: int) -> np.ndarray:
    """alcp[i] = common-prefix length (in bases) of symbol-lex-sorted
    keys i-1 and i; alcp[0] = -1 sentinel.  Pure packed-word bit math:
    the first differing base is ctz(xor)/2 of the first differing word."""
    E = words_sorted.shape[0]
    alcp = np.full(E, -1, np.int64)
    if E < 2:
        return alcp
    first_diff = np.full(E - 1, kw * 16, np.int64)
    found = np.zeros(E - 1, bool)
    with np.errstate(over="ignore"):
        for w in range(kw):
            x = words_sorted[1:, w] ^ words_sorted[:-1, w]
            nz = (~found) & (x != 0)
            if nz.any():
                xv = x[nz]
                low = (xv & (~xv + np.uint32(1))).astype(np.float64)
                bit = np.frexp(low)[1] - 1        # ctz via exponent
                first_diff[nz] = 16 * w + (bit >> 1)
                found |= x != 0
            if found.all():
                break
    alcp[1:] = np.minimum(
        first_diff, np.minimum(lens_sorted[1:], lens_sorted[:-1])
    )
    return alcp


def _chain_colors_sorted(lens_sorted: np.ndarray,
                         alcp: np.ndarray) -> np.ndarray:
    """Chain colors over keys ALREADY in symbol-lex order (length as the
    tiebreak): color[i] = #{j < i : len_j <= min(alcp[j+1..i])}, i.e. the
    number of earlier keys that are prefixes of key i — proper prefixes
    plus earlier exact duplicates, which IS (prefix depth + duplicate
    rank).  In this order the extensions of key j form one contiguous
    interval (j, end_j], where end_j is the last position before alcp
    drops below len_j; colors are interval-open counts, computed with one
    suffix-min and one bincount per DISTINCT length (O(D*E), exact)."""
    E = lens_sorted.shape[0]
    if E == 0:
        return np.zeros(0, np.int32)
    idx = np.arange(E, dtype=np.int64)
    starts_all = []
    ends_all = []
    for t in np.unique(lens_sorted):
        # nxt[p] = first position >= p with alcp < t (suffix-min trick)
        cand = np.where(alcp < t, idx, E)
        nxt = np.minimum.accumulate(cand[::-1])[::-1]
        js = np.nonzero(lens_sorted == t)[0]
        starts = js + 1
        inb = starts < E
        ends = np.full(js.shape[0], E, np.int64)
        ends[inb] = nxt[starts[inb]]
        ok = starts < ends
        starts_all.append(starts[ok])
        ends_all.append(ends[ok])
    delta = (
        np.bincount(np.concatenate(starts_all), minlength=E + 1)[:E]
        - np.bincount(np.concatenate(ends_all), minlength=E + 1)[:E]
    )
    return np.cumsum(delta).astype(np.int32)


def _symlex_order(key_words: np.ndarray, length: np.ndarray, kw: int,
                  *extra_keys: np.ndarray) -> np.ndarray:
    """Stable symbol-lexicographic sort order (zero padding = base A) with
    (length, *extra_keys) as tiebreaks."""
    rw = rev2bit_u32(key_words)
    keys = tuple(reversed(extra_keys)) + (length,) + tuple(
        rw[:, c] for c in range(kw - 1, -1, -1)
    )
    return np.lexsort(keys)


def _chain_colors(key_words: np.ndarray, length: np.ndarray, kw: int) -> np.ndarray:
    """Color keys so that within one color class keys are DISTINCT and
    PREFIX-FREE (then at most one entry per color can match a given read
    offset).  color = (#keys that are proper prefixes of this key, with
    multiplicity) + (rank among exact duplicates).  If k1 is a proper
    prefix of k2, every prefix of k1 (and k1 itself, all its copies) is a
    prefix of k2, so color(k2) > color(any k1 copy); exact duplicates get
    distinct ranks.  One symbol-lex sort + exact adjacent-LCP intervals
    (no hashing; see _chain_colors_sorted)."""
    order = _symlex_order(key_words, length, kw)
    ws = key_words[order]
    ls = np.asarray(length, np.int64)[order]
    cs = _chain_colors_sorted(ls, _adjacent_lcp(ws, ls, kw))
    color = np.empty(ws.shape[0], np.int32)
    color[order] = cs
    return color


def build_merged_index(index_u: FlatIndex, index_d: Optional[FlatIndex]) -> MergedIndex:
    h, kw = index_u.h, index_u.kw
    eu = index_u.num_entries
    if index_d is not None and index_d.num_entries:
        if index_d.h != h:
            raise ValueError("unique/doubly hash lengths must match")
        kwd = index_d.kw
        kw = max(kw, kwd)

        def pad(wds, k):
            if wds.shape[1] == k:
                return wds
            return np.concatenate(
                [wds, np.zeros((wds.shape[0], k - wds.shape[1]), np.uint32)], axis=1
            )

        key_words = np.concatenate([pad(index_u.key_words, kw), pad(index_d.key_words, kw)])
        length = np.concatenate([index_u.length, index_d.length])
        rid1 = np.concatenate([index_u.rid1, index_d.rid1])
        rid2 = np.concatenate([index_u.rid2, index_d.rid2])
        ed = index_d.num_entries
    else:
        key_words = index_u.key_words
        length = index_u.length
        rid1, rid2 = index_u.rid1, index_u.rid2
        ed = 0
    gid = np.arange(eu + ed, dtype=np.int32)

    if length.shape[0] == 0:
        ds, db, steps = _build_directory(np.zeros(1, np.uint32))
        return MergedIndex(
            h=h, kw=kw, eu=eu, ed=ed, max_bucket=1, n_colors=1,
            key_words=np.zeros((1, kw), np.uint32),
            length=np.full(1, 1 << 30, np.int32),
            rid1=np.zeros(1, np.int32), rid2=np.zeros(1, np.int32),
            gid=np.zeros(1, np.int32), color=np.zeros(1, np.int32),
            pref_lo=np.zeros(1, np.uint32), pref_hi=np.zeros(1, np.uint32),
            bucket_start=np.zeros(1, np.int32), bucket_count=np.zeros(1, np.int32),
            dir_start=ds, dir_bits=db, dir_span_steps=steps,
        )

    # ---- RC augmentation: every entry gets a reverse-complement twin with
    # the SAME gid/payload, so the query probes the forward strand only.
    rc_words = _revcomp_packed(key_words, length, kw)
    key_words = np.concatenate([key_words, rc_words])
    length = np.concatenate([length, length])
    rid1 = np.concatenate([rid1, rid1])
    rid2 = np.concatenate([rid2, rid2])
    gid = np.concatenate([gid, gid])
    # drop duplicates with IDENTICAL payload (palindromic twins); keys
    # equal as strings but with different gids are real double matches and
    # must both stay (they get distinct colors below)
    full = np.concatenate(
        [key_words, length[:, None].astype(np.uint32), gid[:, None].astype(np.uint32)],
        axis=1,
    )
    order = np.lexsort(tuple(full[:, c] for c in range(full.shape[1] - 1, -1, -1)))
    fs = full[order]
    first = np.ones(fs.shape[0], bool)
    first[1:] = (fs[1:] != fs[:-1]).any(axis=1)
    keep = np.sort(order[first])
    key_words, length = key_words[keep], length[keep]
    rid1, rid2, gid = rid1[keep], rid2[keep], gid[keep]
    E = length.shape[0]

    color = _chain_colors(key_words, length, kw)
    n_colors = int(color.max()) + 1

    plo, phi = _prefix_lo_hi(key_words, h)
    hlo, hhi = _hash_prefix(plo, phi)
    # group entries by primary hash (prefixes colliding in hlo merge into
    # one span; the probe-time verify separates them), then secondary
    # hash, then prefix
    order = np.lexsort((length, plo, phi, hhi, hlo))
    key_words = key_words[order]
    length = length[order]
    rid1, rid2 = rid1[order], rid2[order]
    gid, color = gid[order], color[order]
    hlo, hhi = hlo[order], hhi[order]
    # spans: runs of equal hlo (the scannable entry ranges)
    newspan = np.ones(E, bool)
    newspan[1:] = hlo[1:] != hlo[:-1]
    span_id = np.cumsum(newspan) - 1
    sstart = np.nonzero(newspan)[0]
    scount = np.diff(np.concatenate([sstart, [E]]))
    # bucket rows: one per distinct (hlo, hhi); collision rows of one span
    # each reference the FULL span, so a probe joining under any hhi mask
    # width still scans every candidate of its hlo
    newb = np.ones(E, bool)
    newb[1:] = newspan[1:] | (hhi[1:] != hhi[:-1])
    brow = np.nonzero(newb)[0]
    pref_lo_b = hlo[brow].astype(np.uint32)
    ds, db, steps = _build_directory(pref_lo_b)
    return MergedIndex(
        h=h, kw=kw, eu=eu, ed=ed, max_bucket=int(scount.max()),
        n_colors=n_colors,
        key_words=key_words.astype(np.uint32),
        length=length.astype(np.int32),
        rid1=rid1.astype(np.int32), rid2=rid2.astype(np.int32),
        gid=gid.astype(np.int32), color=color.astype(np.int32),
        pref_lo=pref_lo_b, pref_hi=hhi[brow].astype(np.uint32),
        bucket_start=sstart[span_id[brow]].astype(np.int32),
        bucket_count=scount[span_id[brow]].astype(np.int32),
        dir_start=ds, dir_bits=db, dir_span_steps=steps,
    )


@dataclasses.dataclass
class DeviceMergedIndex:
    h: int
    kw: int
    eu: int
    ed: int
    max_bucket: int
    n_colors: int
    # base arrays: ONLY read when the fused records below are absent (the
    # session path leaves them None so multi-GB duplicates of erec/prec
    # are never transferred to the device)
    key_words: Any = None
    length: Any = None
    rid1: Any = None
    rid2: Any = None
    gid: Any = None
    color: Any = None
    pref_lo: Any = None
    pref_hi: Any = None
    bucket_start: Any = None
    bucket_count: Any = None
    dir_start: Any = None
    dir_bits: int = 0
    dir_span_steps: int = 0
    # fused per-entry / per-bucket records, precomputed ONCE at session
    # setup so the hot loop does pure row-gathers instead of rebuilding
    # multi-GB concatenations every batch:
    #   erec [E, kw+1]: key words + (length | color<<16)
    #   brec [NB, 2]:   bucket (start, count)
    #   prec [E, 3]:    (gid, rid1, rid2) payloads
    erec: Any = None
    brec: Any = None
    prec: Any = None
    # blocked bloom filter over pref_lo (one-gather probe prefilter)
    bloom: Any = None
    bloom_log: int = 0
    # cuckoo span table (two-row-gather search stage, see _build_cuckoo);
    # cuckoo_kv is the packed one-gather-per-side form, usable when
    # max_bucket <= BUCKET_SCAN_UNROLL (see _cuckoo_kv_from_table)
    cuckoo: Any = None
    cuckoo_log: int = 0
    cuckoo_kv: Any = None


# array fields passed into the jitted classifier as ARGUMENTS (a closure
# capture would bake gigabytes of index into the executable as constants)
_DM_ARRAYS = ("key_words", "length", "rid1", "rid2", "gid", "color",
              "pref_lo", "pref_hi", "bucket_start", "bucket_count",
              "dir_start", "erec", "brec", "prec", "bloom", "cuckoo",
              "cuckoo_kv")
_DM_STATIC = ("h", "kw", "eu", "ed", "max_bucket", "n_colors", "dir_bits",
              "dir_span_steps", "bloom_log", "cuckoo_log")

NEVER_LEN = 0xFFFF  # erec length field for oversize/pad entries


def _fused_records(key_words, length, color, bucket_start, bucket_count,
                   gid, rid1, rid2, xp):
    elen_pack = (
        xp.minimum(length, NEVER_LEN).astype(xp.int32)
        | (color.astype(xp.int32) << 16)
    )
    erec = xp.concatenate(
        [key_words.astype(xp.uint32), elen_pack[:, None].astype(xp.uint32)],
        axis=1,
    )
    brec = xp.stack([bucket_start, bucket_count], axis=-1)
    prec = xp.stack([gid, rid1, rid2], axis=-1)
    return erec, brec, prec


def to_device_merged(m: MergedIndex) -> DeviceMergedIndex:
    """Device session view: ONLY the fused records + join hashes travel to
    the device (the base arrays they were fused from stay on host - at a
    production index they are a redundant multi-GB copy)."""
    import jax.numpy as jnp

    erec, brec, prec = _fused_records(
        m.key_words, m.length, m.color, m.bucket_start, m.bucket_count,
        m.gid, m.rid1, m.rid2, np,
    )
    ck_tab, ck_log = _build_cuckoo(m.pref_lo, m.bucket_start, m.bucket_count)
    ck_kw = _cuckoo_session_kwargs(ck_tab, ck_log, m.max_bucket, jnp)
    return DeviceMergedIndex(
        h=m.h, kw=m.kw, eu=m.eu, ed=m.ed, max_bucket=m.max_bucket,
        n_colors=m.n_colors,
        pref_lo=jnp.asarray(m.pref_lo), pref_hi=jnp.asarray(m.pref_hi),
        dir_start=(jnp.asarray(m.dir_start) if m.dir_start is not None else None),
        dir_bits=m.dir_bits, dir_span_steps=m.dir_span_steps,
        erec=jnp.asarray(erec), brec=jnp.asarray(brec),
        prec=jnp.asarray(prec),
        **ck_kw,
        **_bloom_kwargs(m.pref_lo, jnp, cap=BLOOM_DEVICE_LOG),
    )


def to_device_merged_artifact(a) -> DeviceMergedIndex:
    """Device session view straight from a MergedArtifact: memmap -> device
    transfers, nothing recomputed (the artifact stores the fused records)."""
    import jax.numpy as jnp

    plo = np.asarray(a.pref_lo)
    ds, db, steps = _build_directory(plo)
    has_ck = getattr(a, "cuckoo", None) is not None
    cap = BLOOM_DEVICE_LOG if has_ck else None
    if getattr(a, "bloom", None) is not None:
        bt, bl = np.asarray(a.bloom), a.bloom_log
        if cap is not None and bl > cap:
            bt, bl = _fold_bloom(bt, cap)
        bkw = {"bloom": jnp.asarray(bt), "bloom_log": bl}
    else:  # pre-r4 artifact: derive the filter from the bucket hashes
        bkw = _bloom_kwargs(plo, jnp, cap=cap)
    if has_ck:
        # precomputed span table (r5 artifacts); pre-cuckoo artifacts fall
        # back to the directory binary search rather than paying a ~30 s
        # host build at session start — index.artifact.ensure_cuckoo
        # upgrades them in place
        bkw.update(_cuckoo_session_kwargs(np.asarray(a.cuckoo),
                                          a.cuckoo_log, a.max_bucket, jnp))
    return DeviceMergedIndex(
        h=a.h, kw=a.kw, eu=a.eu, ed=a.ed, max_bucket=a.max_bucket,
        n_colors=a.n_colors,
        pref_lo=jnp.asarray(plo),
        pref_hi=jnp.asarray(np.asarray(a.pref_hi)),
        dir_start=jnp.asarray(ds), dir_bits=db, dir_span_steps=steps,
        erec=jnp.asarray(np.asarray(a.erec)),
        brec=jnp.asarray(np.asarray(a.brec)),
        prec=jnp.asarray(np.asarray(a.prec)),
        **bkw,
    )


def _first_of_run_scan(is_start, *values):
    """Propagate the value at each run start over the run.  values are
    int32 arrays; returns propagated arrays."""
    import jax
    import jax.numpy as jnp

    flags = is_start.astype(jnp.int32)

    def op(a, b):
        af, *avals = a
        bf, *bvals = b
        f = jnp.maximum(af, bf)
        outs = [jnp.where(bf > 0, bv, av) for av, bv in zip(avals, bvals)]
        return (f, *outs)

    init = (flags, *values)
    out = jax.lax.associative_scan(op, init)
    return out[1:]


def collect_matches_sortjoin(
    dm: DeviceMergedIndex,
    codes,
    lengths,
    hit_capacity_frac: int = 32,
    maxm: int = 32,
    uniform_len: int | None = None,
    return_compact: bool = False,
    join: str = "auto",
    cut: str | None = None,
):
    """MatchSlots [B, maxm] via the sort-join probe (forward strand only;
    the merged index is RC-augmented, see module docstring).

    hit_capacity_frac: K = N // frac compacted probe capacity.
    uniform_len: accepted for API compatibility (the fwd-only probe no
    longer computes reverse complements, so it changes nothing).
    Also returns (overflow_hits, overflow_slots) diagnostics.
    return_compact: additionally return the compacted distinct match rows
    (read_id, gid, distinct mask; n_colors*K each) so rcounts can be
    scattered at match granularity (~hits) instead of B*maxm slots.
    join: 'auto' (bloom-prefiltered directory when NB > 4N), 'bloom',
    'dir' (directory binary search at full N, no bloom), or 'sort'.
    cut: profiling hook - return early (a tiny reduction of the live
    intermediates, so nothing downstream is built) after the named stage:
    'hash' (probe words + prefix hashes), 'filter' (bloom membership,
    bloom path only), 'search' (join/dir search), 'compact' (hit
    compaction sort), 'bucket' (bucket scan), 'payload' (match payload
    gathers).  The traced program is the production program's prefix, so
    cut-to-cut deltas are true per-stage costs (bloom-path stage order is
    hash, filter, compact, search).
    """
    import jax
    import jax.numpy as jnp

    def _cut_out(*xs):
        return sum(jnp.sum(x.astype(jnp.int32) if x.dtype == bool else x)
                   for x in xs)

    B, Lp = codes.shape
    h, kw = dm.h, dm.kw
    O = max(Lp - h + 1, 1)
    NB = dm.pref_lo.shape[0]
    NC = dm.n_colors

    p16 = pack_rolling16(codes)                       # [B, Lp] uint32

    def window_word(w):
        start = 16 * w
        if start >= Lp:
            return jnp.zeros((B, O), jnp.uint32)
        sl = p16[:, start:]
        if sl.shape[1] < O:
            sl = jnp.concatenate(
                [sl, jnp.zeros((B, O - sl.shape[1]), jnp.uint32)], axis=1
            )
        return sl[:, :O]

    # probe words laid out [B*O, kw]: the kw verify words of every
    # (read, offset) candidate become ONE contiguous row-gather later
    # instead of kw scalar gathers
    p16s = jnp.stack([window_word(w) for w in range(kw)], axis=-1)
    p16s = p16s.reshape(-1, kw)
    W0 = p16s[:, 0].reshape(B, O)
    nb0 = min(h, 16)
    m0 = jnp.uint32(0xFFFFFFFF if nb0 >= 16 else (1 << (2 * nb0)) - 1)
    if h > 16:
        W1 = p16s[:, 1].reshape(B, O) if kw > 1 else window_word(1)
        nb1 = h - 16
        m1 = jnp.uint32(0xFFFFFFFF if nb1 >= 16 else (1 << (2 * nb1)) - 1)
        khi = (W1 & m1).reshape(-1)
    else:
        khi = jnp.zeros((B * O,), jnp.uint32)
    klo = (W0 & m0).reshape(-1)
    N = B * O

    khlo, khhi = _hash_prefix(klo, khi, jnp)
    if cut == "hash":
        return _cut_out(p16s, khlo, khhi)
    BIGOFF = jnp.int32(1 << 30)
    use_bloom = dm.bloom is not None and dm.dir_start is not None and (
        join == "bloom" or (join == "auto" and NB > 4 * N)
    )
    use_dir = not use_bloom and dm.dir_start is not None and (
        join == "dir" or (join == "auto" and NB > 4 * N)
    )
    if cut == "filter" and not use_bloom:
        # without this, a 'filter' cut on the dir/sort paths silently runs
        # the FULL pipeline and the stage profiler reports end-to-end time
        # as the filter stage
        raise ValueError(
            "cut='filter' requires the bloom join path (join='bloom', or "
            "'auto' with a bloom table and NB > 4N); this call resolved to "
            f"{'dir' if use_dir else 'sort'}")
    if use_bloom:
        # ---- bloom-prefiltered directory join (large-index regime).  The
        # dir path's weakness is dir_span_steps DEPENDENT gather rounds at
        # ALL N candidates; but ~99% of candidates match nothing.  One
        # blocked-bloom gather per candidate (no false negatives) filters
        # first; candidates compact to K; the binary search then runs on K
        # rows only.  A bloom false positive (~0.1%) survives compaction
        # with ccnt forced to 0, so it can never produce a match — it only
        # costs a compaction slot, covered by the overflow accounting.
        maybe = _bloom_maybe(dm.bloom, khlo, dm.bloom_log, jnp)
        probe_hit = maybe
        if cut == "filter":
            return _cut_out(maybe)
        K = min(max(N // hit_capacity_frac, 256), N)
        # with the exact cuckoo stage downstream, bloom false positives
        # are cheap (they die before the bucket scan in the recompaction
        # below), so when the filter runs above ~1.5 keys/word (the
        # fold-reduced 64 MB filter at 60M+ keys, FP ~2-4%) the
        # pre-search capacity doubles to absorb them
        fp_heavy = NB > (3 << dm.bloom_log) // 2
        have_ck = dm.cuckoo is not None or dm.cuckoo_kv is not None
        # FP budget: the folded 64 MB filter runs at <= ~3% FP in the
        # fp_heavy regime, so N/24 extra slots absorb the false maybes;
        # sizing K1 to the budget (instead of 2K) keeps the cuckoo +
        # payload gathers near the true-hit count
        K1 = (min(K + (N // 24 if fp_heavy else 0), N) if have_ck else K)
        rows = jnp.arange(N, dtype=jnp.int32)
        fkey = jnp.where(maybe, rows, rows + BIGOFF)
        skey = jax.lax.sort([fkey], num_keys=1, is_stable=False)[0][:K1]
        cv = skey < BIGOFF
        cpos = jnp.where(cv, skey, -1)
        if cut == "compact":
            return _cut_out(cv, cpos)
        # exact membership on the K1 survivors
        ck = khlo[jnp.maximum(cpos, 0)]
        if dm.cuckoo_kv is not None or dm.cuckoo is not None:
            # cuckoo span table: independent row gathers replace the
            # dir_span_steps dependent binary-search rounds AND the brec
            # span gather (the span rides in the table cells)
            if dm.cuckoo_kv is not None:
                realf, cstart_k, ccnt_k = _cuckoo_kv_lookup(
                    dm.cuckoo_kv, dm.cuckoo_log, ck, dm.max_bucket, jnp)
            else:
                realf, cstart_k, ccnt_k = _cuckoo_lookup(
                    dm.cuckoo, dm.cuckoo_log, ck, jnp)
            real = cv & realf
            if cut == "search":
                return _cut_out(real, cstart_k)
            # ---- recompaction: only cuckoo-CONFIRMED candidates reach
            # the bucket scan / payload / collect stages, so bloom FPs
            # cost one K1 slot + one cheap row-gather, nothing more.
            # Survivors sort by SPAN START, not probe order: the later
            # erec/prec row-gathers then walk the big operands
            # quasi-sequentially (and it saves one K1-sized gather: the
            # sorted key IS cstart); candidate order is free since
            # collect re-sorts by (read, gid)
            rows1 = jnp.arange(K1, dtype=jnp.int32)
            fkey2 = jnp.where(real, cstart_k, BIGOFF)
            skey2, sslot = jax.lax.sort([fkey2, rows1], num_keys=1,
                                        is_stable=False)
            skey2, sslot = skey2[:K], sslot[:K]
            cv = skey2 < BIGOFF
            sel = jnp.where(cv, sslot, 0)
            cpos = jnp.where(cv, cpos[sel], -1)
            cbid = None
            span_pre = (jnp.where(cv, skey2, 0),
                        jnp.where(cv, ccnt_k[sel], 0))
            # exact overflow accounting: found beyond K is lost work (the
            # maybe > K1 term below covers pre-search loss)
            found_total = jnp.sum(real.astype(jnp.int32))
            extra_overflow = jnp.maximum(found_total - K, 0)
        else:
            # directory + binary search (pre-cuckoo artifacts)
            db = dm.dir_bits
            top = (ck >> jnp.uint32(32 - db)).astype(jnp.int32)
            blo = dm.dir_start[top]
            bhi = dm.dir_start[top + 1]

            def bs_body_k(_, lh):
                lo, hi2 = lh
                active = lo < hi2
                mid = (lo + hi2) >> 1
                v = dm.pref_lo[jnp.clip(mid, 0, NB - 1)]
                less = v < ck
                nlo = jnp.where(less, mid + 1, lo)
                nhi = jnp.where(less, hi2, mid)
                return (jnp.where(active, nlo, lo),
                        jnp.where(active, nhi, hi2))

            blo, bhi = jax.lax.fori_loop(0, dm.dir_span_steps, bs_body_k,
                                         (blo, bhi))
            found_row = jnp.minimum(blo, NB - 1)
            real = cv & (blo < NB) & (dm.pref_lo[found_row] == ck)
            cv = real
            cpos = jnp.where(real, cpos, -1)
            cbid = found_row
            span_pre = None
            if cut == "search":
                return _cut_out(real, found_row)
    elif use_dir:
        # ---- directory + binary-search join (large-index regime).  When
        # the bucket list dwarfs the probe list, sorting NB+N rows per
        # batch pays NB log(NB) for static data; instead the top dir_bits
        # of each probe hash index a precomputed directory cell, and a
        # fixed-round lower_bound over the (sorted) cell finds the bucket
        # row: O(N * dir_span_steps) gathers, independent of NB.
        db = dm.dir_bits
        top = (khlo >> jnp.uint32(32 - db)).astype(jnp.int32)
        blo = dm.dir_start[top]
        bhi = dm.dir_start[top + 1]

        def bs_body(_, lh):
            lo, hi2 = lh
            active = lo < hi2
            mid = (lo + hi2) >> 1
            v = dm.pref_lo[jnp.clip(mid, 0, NB - 1)]
            less = v < khlo
            nlo = jnp.where(less, mid + 1, lo)
            nhi = jnp.where(less, hi2, mid)
            return (jnp.where(active, nlo, lo), jnp.where(active, nhi, hi2))

        blo, bhi = jax.lax.fori_loop(0, dm.dir_span_steps, bs_body, (blo, bhi))
        found_row = jnp.minimum(blo, NB - 1)
        probe_hit = (blo < NB) & (dm.pref_lo[found_row] == khlo)   # [N]
        if cut == "search":
            return _cut_out(probe_hit, found_row)
        # compact hit probes to capacity K with one single-operand sort
        K = min(max(N // hit_capacity_frac, 256), N)
        rows = jnp.arange(N, dtype=jnp.int32)
        fkey = jnp.where(probe_hit, rows, rows + BIGOFF)
        skey = jax.lax.sort([fkey], num_keys=1, is_stable=False)[0][:K]
        cv = skey < BIGOFF
        cpos = jnp.where(cv, skey, -1)
        cbid = found_row[jnp.maximum(cpos, 0)]
        span_pre = None
    else:
        # ---- sort-merge join of probe prefixes with table buckets, on a
        # HASHED key: word1 = 32-bit primary hash, word2 fuses the
        # secondary hash | tag | row id, so the whole join sorts TWO
        # operands (the join sort is the single largest HBM consumer in
        # the hot loop).  A hash false-join only wastes a compaction slot
        # — the bucket scan fully verifies candidates — and expected false
        # joins are N*NB/2^(32+hb) per batch.  Row ids are part of the
        # sort key, so within a tied run real bucket rows (low ids) sort
        # before shard padding rows (high ids) and can never be shadowed.
        row_bits = max(int(max(N, NB) - 1).bit_length(), 1)
        hb = min(_HHI_BITS, 31 - row_bits)
        if hb < 0:
            raise ValueError(
                f"sort-join row id needs {row_bits} bits (> 31): shard the "
                f"index (NB={NB}) or reduce the batch (N={N})")
        jw1 = jnp.concatenate([dm.pref_lo, khlo])
        jhhi = jnp.concatenate([dm.pref_hi, khhi]) & jnp.uint32((1 << hb) - 1)
        jtag = jnp.concatenate(
            [jnp.zeros(NB, jnp.uint32), jnp.ones(N, jnp.uint32)]
        )
        jrow = jnp.concatenate(
            [jnp.arange(NB, dtype=jnp.uint32), jnp.arange(N, dtype=jnp.uint32)]
        )
        jw2 = (jhhi << (row_bits + 1)) | (jtag << row_bits) | jrow
        sw1, sw2 = jax.lax.sort([jw1, jw2], num_keys=2, is_stable=False)
        stag = ((sw2 >> row_bits) & 1).astype(jnp.int32)
        sval = (sw2 & jnp.uint32((1 << row_bits) - 1)).astype(jnp.int32)
        srun = sw2 >> (row_bits + 1)  # secondary hash bits
        is_start = jnp.concatenate(
            [jnp.ones(1, bool),
             (sw1[1:] != sw1[:-1]) | (srun[1:] != srun[:-1])]
        )
        # first-of-run is the table row iff the bucket exists (tag first).
        # The propagation is XLA's associative scan: the production
        # (bloom) path runs only K-sized scans, so a hand-written kernel
        # waits for a device trace that shows this scan costs.
        has_tab = jnp.where(is_start, (stag == 0).astype(jnp.int32), 0)
        pbid, ptab = _first_of_run_scan(is_start, sval, has_tab)
        probe_hit = (stag == 1) & (ptab > 0)
        if cut == "search":
            return _cut_out(probe_hit, pbid)

        # ---- compact hits to capacity K: a single 1-key sort on a fused
        # (miss-flag | sorted-row) key brings the hit rows (in order) to
        # the front; per-hit fields gather from the sorted arrays
        K = min(max(N // hit_capacity_frac, 256), N + NB)
        rows = jnp.arange(N + NB, dtype=jnp.int32)
        fkey = jnp.where(probe_hit, rows, rows + BIGOFF)
        # unstable single-operand sort (keys are distinct; jnp.sort would
        # add a tiebreak-iota payload column)
        skey = jax.lax.sort([fkey], num_keys=1, is_stable=False)[0][:K]
        cv = skey < BIGOFF
        crow_c = jnp.where(cv, skey, 0)
        cpos = jnp.where(cv, sval[crow_c], -1)
        cbid = pbid[crow_c]
        span_pre = None
    if cut == "compact":
        return _cut_out(cv, cpos, cbid if cbid is not None else cv)
    if span_pre is not None:
        cstart, ccnt = span_pre   # cuckoo cells carried the span already
    else:
        # bucket (start, count) as one row-gather (precomputed at session
        # setup when available; rebuilding costs a full-index copy per
        # batch)
        brec = dm.brec if dm.brec is not None else jnp.stack(
            [dm.bucket_start, dm.bucket_count], axis=-1)
        crec = brec[cbid]
        cstart = jnp.where(cv, crec[:, 0], 0)
        ccnt = jnp.where(cv, crec[:, 1], 0)
    n_hits = jnp.sum(probe_hit.astype(jnp.int32))
    if use_bloom and (dm.cuckoo is not None or dm.cuckoo_kv is not None):
        # two-stage accounting: bloom-maybes beyond K1, plus confirmed
        # candidates beyond K (extra_overflow from the recompaction)
        overflow_hits = jnp.maximum(n_hits - K1, 0) + extra_overflow
    else:
        overflow_hits = jnp.maximum(n_hits - K, 0)

    # ---- bucket scan on compacted candidates.  Per-entry fields are
    # packed into one [E, kw+1] record (kw key words + length|color) so
    # each scan step is a single row-gather; the probe's verify words are
    # one row-gather from p16s (outside the scan loop entirely).  One
    # found-slot per chain color: within a color, keys are distinct and
    # prefix-free, so at most one entry per color matches an offset.
    cvalid = cpos >= 0
    r2 = jnp.where(cvalid, cpos // O, 0)              # read row
    o2 = jnp.where(cvalid, cpos % O, 0)
    avail = lengths[r2] - o2
    if dm.erec is not None:
        erec = dm.erec                                # [E, kw+1] (session)
    else:
        elen_pack = (jnp.minimum(dm.length, NEVER_LEN)
                     | (dm.color.astype(jnp.int32) << 16))
        erec = jnp.concatenate(
            [dm.key_words.astype(jnp.uint32),
             elen_pack[:, None].astype(jnp.uint32)], axis=1,
        )
    Emax = erec.shape[0]
    pwords = p16s[jnp.maximum(cpos, 0)]               # [K, kw]
    # one found-slot per chain color, held as a [K, NC+1] matrix (column
    # NC is a dump slot for non-matches) so the traced program does one
    # scatter per bucket-scan step instead of NC where-chains — program
    # size stays constant in n_colors (a data-dependent quantity)
    found = jnp.full((K, NC + 1), -1, jnp.int32)
    overflow_work = jnp.zeros((), jnp.int32)

    def _verify(match, pw, er, elen):
        for w in range(kw):
            nb = jnp.clip(elen - 16 * w, 0, 16)
            mask = jnp.where(
                nb >= 16, jnp.uint32(0xFFFFFFFF),
                (jnp.uint32(1) << (2 * nb.astype(jnp.uint32))) - jnp.uint32(1),
            )
            match = match & ((pw[:, w] & mask) == er[:, w])
        return match

    if dm.max_bucket <= BUCKET_SCAN_UNROLL and NC <= COLOR_SELECT_UNROLL:
        # small buckets, few colors: masked c-step sweep with per-color
        # VECTOR selects instead of a per-round [K, NC+1] scatter (a
        # K-sized scatter costs like a K-sized gather); at NC <= 4 a
        # chain of wheres is pure fused elementwise work
        fcols = [jnp.full((K,), -1, jnp.int32) for _ in range(NC)]
        for c in range(dm.max_bucket):
            e = jnp.minimum(cstart + c, Emax - 1)
            er = erec[e]                              # [K, kw+1] row-gather
            elen = (er[:, kw] & jnp.uint32(0xFFFF)).astype(jnp.int32)
            ecol = (er[:, kw] >> 16).astype(jnp.int32)
            match = _verify(cvalid & (c < ccnt) & (elen <= avail),
                            pwords, er, elen)
            # within a color, keys are distinct + prefix-free: at most one
            # entry per color matches this candidate over the whole scan
            for col in range(NC):
                fcols[col] = jnp.where(match & (ecol == col), e,
                                       fcols[col])
        found = jnp.stack(
            fcols + [jnp.full((K,), -1, jnp.int32)], axis=1)
    elif dm.max_bucket <= BUCKET_SCAN_UNROLL:
        # small buckets: a masked c-step sweep, fused by XLA
        rows_k = jnp.arange(K)
        for c in range(dm.max_bucket):
            e = jnp.minimum(cstart + c, Emax - 1)
            er = erec[e]                              # [K, kw+1] row-gather
            elen = (er[:, kw] & jnp.uint32(0xFFFF)).astype(jnp.int32)
            ecol = (er[:, kw] >> 16).astype(jnp.int32)
            match = _verify(cvalid & (c < ccnt) & (elen <= avail),
                            pwords, er, elen)
            # within a color, keys are distinct + prefix-free: at most one
            # entry per color matches this candidate over the whole scan
            found = found.at[rows_k, jnp.where(match, ecol, NC)].set(e)
    else:
        # ---- segment-expanded scan: one work item per candidate ENTRY,
        # so cost ∝ Σ bucket sizes (the true candidate count) instead of
        # K * max_bucket — and the traced program no longer scales with
        # max_bucket (a data-dependent quantity that reaches hundreds on
        # a production index; the reference trie walk is naturally
        # per-entry, src/hashtrie.cpp:350-369)
        KE = min(max(2 * K, 512), 4 * K)
        coff = jnp.cumsum(ccnt) - ccnt                # exclusive offsets
        total = coff[-1] + ccnt[-1]
        overflow_work = jnp.maximum(total - KE, 0)
        head = jnp.where((ccnt > 0) & (coff < KE), coff, KE)
        wid = jnp.full(KE + 1, -1, jnp.int32).at[head].max(
            jnp.arange(K, dtype=jnp.int32))[:KE]
        wid = jax.lax.cummax(wid)                     # candidate per slot
        widc = jnp.maximum(wid, 0)
        pos = jnp.arange(KE, dtype=jnp.int32) - coff[widc]
        work_ok = (wid >= 0) & (pos < ccnt[widc])
        e = jnp.minimum(cstart[widc] + pos, Emax - 1)
        er = erec[e]                                  # [KE, kw+1] row-gather
        elen = (er[:, kw] & jnp.uint32(0xFFFF)).astype(jnp.int32)
        ecol = (er[:, kw] >> 16).astype(jnp.int32)
        match = _verify(
            work_ok & cvalid[widc] & (elen <= avail[widc]),
            pwords[widc], er, elen,
        )
        # non-matches dump into column NC of whatever row; at most one
        # entry per (candidate, color) matches, so the scatter is
        # conflict-free on real slots
        found = found.at[jnp.where(match, widc, 0),
                         jnp.where(match, ecol, NC)].set(e)

    if cut == "bucket":
        return _cut_out(found)
    # a work-capacity overflow widens K (and with it KE) like a hit
    # overflow: both mean candidates went unscanned
    overflow_hits = overflow_hits + overflow_work

    # ---- match compaction: most of the [K, NC] found slots are empty
    # (avg matched colors per candidate ~1 and only ~hit-rate of K are
    # candidates at all), and the payload row-gather hits the multi-GB
    # prec operand — so compact found slots
    # to KP first with one cheap 1-key sort, then gather payloads for KP
    # rows only.  KP = K + K//4 covers every candidate matching one color
    # plus slack for multi-color matches; beyond that is an overflow
    # (auto-widen), counted exactly below.
    prec = dm.prec if dm.prec is not None else jnp.stack(
        [dm.gid, dm.rid1, dm.rid2], axis=-1)
    frf = found[:, :NC].reshape(-1)                   # [K*NC]
    KNC = frf.shape[0]
    KP = min(K + K // 4 + 256, KNC)
    rows3 = jnp.arange(KNC, dtype=jnp.int32)
    pkey = jnp.where(frf >= 0, rows3, rows3 + BIGOFF)
    spkey = jax.lax.sort([pkey], num_keys=1, is_stable=False)[0][:KP]
    pv = spkey < BIGOFF
    slot3 = jnp.where(pv, spkey, 0)
    fr = jnp.where(pv, frf[slot3], -1)                # [KP]
    n_match = jnp.sum((frf >= 0).astype(jnp.int32))
    overflow_hits = overflow_hits + jnp.maximum(n_match - KP, 0)
    hitf = fr >= 0
    pr = prec[jnp.maximum(fr, 0)]                     # [KP, 3] row-gather
    m_gid = jnp.where(hitf, pr[:, 0], BIG)
    m_r1 = jnp.where(hitf, pr[:, 1], 0)
    m_r2 = jnp.where(hitf, pr[:, 2], 0)
    if cut == "payload":
        return _cut_out(m_gid, m_r1, m_r2)

    # ---- assemble per-read distinct slots [B, maxm]
    read_of = jnp.where(cvalid, r2, B)                # B = padded row
    m_read = read_of[slot3 // NC]                     # [KP]
    m_read = jnp.where(m_gid < BIG, m_read, B)
    # unstable: duplicate (read, gid) rows carry identical payloads
    sread, sgid, sr1, sr2 = jax.lax.sort(
        [m_read, m_gid, m_r1, m_r2], num_keys=2, is_stable=False
    )
    valid_m = (sread < B) & (sgid < BIG)
    newkey = jnp.concatenate(
        [jnp.ones(1, bool),
         (sread[1:] != sread[:-1]) | (sgid[1:] != sgid[:-1])]
    )
    distinct = valid_m & newkey
    # rank within read
    newread = jnp.concatenate([jnp.ones(1, bool), sread[1:] != sread[:-1]])
    # rank counts only distinct slots: rank = (#distinct before i in read)
    dcum = jnp.cumsum(distinct.astype(jnp.int32))
    dstart = _first_of_run_scan(newread, dcum - distinct.astype(jnp.int32))[0]
    rank = dcum - distinct.astype(jnp.int32) - dstart
    put = distinct & (rank < maxm)
    overflow_slots = jnp.sum(distinct & (rank >= maxm))
    flat_t = jnp.where(put, sread * maxm + rank, B * maxm)
    slots = jnp.full(B * maxm + 1, BIG, jnp.int32).at[flat_t].set(sgid)[: B * maxm]
    rid1 = jnp.zeros(B * maxm + 1, jnp.int32).at[flat_t].set(sr1)[: B * maxm]
    rid2 = jnp.zeros(B * maxm + 1, jnp.int32).at[flat_t].set(sr2)[: B * maxm]
    slots = slots.reshape(B, maxm)
    rid1 = rid1.reshape(B, maxm)
    rid2 = rid2.reshape(B, maxm)
    hit = slots < BIG
    in_u = hit & (slots < dm.eu)
    ms = MatchSlots(slots=slots, rid1=rid1, rid2=rid2, in_u=in_u)
    if return_compact:
        return ms, overflow_hits, overflow_slots, (sread, sgid, distinct)
    return ms, overflow_hits, overflow_slots


def make_sortjoin_classifier(dm: DeviceMergedIndex, num_genome_slots: int,
                             hit_capacity_frac: int = 32, maxm: int = 32):
    """Two-jit classifier: (collect+case) and (rcounts) compile separately.
    The split was chosen on the previous accelerator, where the fused
    single program compiled and ran slower; not yet measured on the H100.

    Returns classify(codes, lengths, with_rcounts, sc_mode, uniform_len)
    -> (BatchCounts, overflow_hits, overflow_slots).
    """
    import jax
    import jax.numpy as jnp

    from .classify import BatchCounts, case_analysis

    # index arrays travel as jit ARGUMENTS (device-resident, zero-copy per
    # call); a closure capture would bake the multi-GB index into the
    # compiled executable as constants
    dm_arrays = {k: getattr(dm, k) for k in _DM_ARRAYS
                 if getattr(dm, k) is not None}
    dm_static = {k: getattr(dm, k) for k in _DM_STATIC}

    @partial_jit(static_argnames=("sc_mode",))
    def part1(arrays, codes, lengths, sc_mode):
        dmi = DeviceMergedIndex(**dm_static, **arrays)
        # uniform_len is a no-op in the fwd-only probe; keeping it out of
        # the jit signature avoids one recompile per distinct read length
        ms, ovh, ovs, compact = collect_matches_sortjoin(
            dmi, codes, lengths, hit_capacity_frac=hit_capacity_frac,
            maxm=maxm, uniform_len=None, return_compact=True,
        )
        case = case_analysis(ms, lengths, num_genome_slots, sc_mode=sc_mode)
        return case, ovh, ovs, compact

    @partial_jit(static_argnames=())
    def part2(sread, sgid, distinct, assigned):
        # rcount[e] = #assigned reads whose distinct match set contains e,
        # scattered from the ~hits-sized compact rows instead of B*maxm
        # slots (the compact rows are exactly the distinct (read, entry)
        # pairs when no slot overflow occurred; overflow retries anyway)
        B = assigned.shape[0]
        etot = max(dm.eu + dm.ed, 1)
        ok = distinct & (sread < B)
        rr = jnp.minimum(sread, B - 1)
        ok = ok & assigned[rr]
        tgt = jnp.where(ok, jnp.minimum(sgid, etot), etot)
        rc = jnp.zeros(etot + 1, jnp.int32).at[tgt].add(1)[:etot]
        return rc[: dm.eu], rc[dm.eu : dm.eu + dm.ed]

    def classify(codes, lengths, with_rcounts=True, sc_mode=False,
                 uniform_len=None):
        del uniform_len  # no-op for the fwd-only probe (API compatibility)
        case, ovh, ovs, compact = part1(dm_arrays, codes, lengths,
                                        sc_mode=sc_mode)
        if with_rcounts:
            rcu, rcd = part2(*compact, case.assigned)
            if dm.eu == 0:
                rcu = jnp.zeros(0, jnp.int32)
            if dm.ed == 0:
                rcd = jnp.zeros(0, jnp.int32)
        else:
            rcu = jnp.zeros(dm.eu, jnp.int32)
            rcd = jnp.zeros(dm.ed, jnp.int32)
        return (
            BatchCounts(
                cnts_u=case.cnts_u, cnts_d=case.cnts_d,
                rcount_u=rcu, rcount_d=rcd,
                nundet=case.nundet, nconf=case.nconf,
                pair_lo=case.pair_lo, pair_hi=case.pair_hi,
            ),
            ovh, ovs,
        )

    return classify


def partial_jit(static_argnames):
    import jax

    def deco(f):
        return jax.jit(f, static_argnames=static_argnames)

    return deco


def classify_batch_sortjoin(
    dm: DeviceMergedIndex,
    codes,
    lengths,
    num_genome_slots: int,
    with_rcounts: bool = True,
    sc_mode: bool = False,
    hit_capacity_frac: int = 32,
    maxm: int = 32,
    uniform_len: int | None = None,
):
    """Single-device classification with the sort-join probe.

    Returns (BatchCounts, overflow_hits, overflow_slots); nonzero overflow
    means the capacities were exceeded and the caller should re-run with a
    larger hit_capacity_frac=... (smaller frac) or maxm.
    """
    import jax.numpy as jnp

    from .classify import BatchCounts, case_analysis, rcounts_from_case

    ms, ovh, ovs = collect_matches_sortjoin(
        dm, codes, lengths, hit_capacity_frac=hit_capacity_frac, maxm=maxm,
        uniform_len=uniform_len,
    )
    case = case_analysis(ms, lengths, num_genome_slots, sc_mode=sc_mode)
    Eu, Ed = dm.eu, dm.ed
    if with_rcounts:
        rcount_u = rcounts_from_case(case, 0, max(Eu, 1))[: max(Eu, 1)]
        rcount_d = rcounts_from_case(case, Eu, max(Ed, 1))[: max(Ed, 1)]
        if Eu == 0:
            rcount_u = jnp.zeros(0, jnp.int32)
        if Ed == 0:
            rcount_d = jnp.zeros(0, jnp.int32)
    else:
        rcount_u = jnp.zeros(Eu, jnp.int32)
        rcount_d = jnp.zeros(Ed, jnp.int32)
    return (
        BatchCounts(
            cnts_u=case.cnts_u, cnts_d=case.cnts_d,
            rcount_u=rcount_u, rcount_d=rcount_d,
            nundet=case.nundet, nconf=case.nconf,
            pair_lo=case.pair_lo, pair_hi=case.pair_hi,
        ),
        ovh,
        ovs,
    )
