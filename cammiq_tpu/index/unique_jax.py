"""On-device (JAX) twins of the uniqueness kernels in unique.py.

Same operational semantics as the host-numpy engine (which is validated
against the reference transcription); everything here is jittable with
static shapes, so the whole unique/doubly extraction pipeline runs on the
device: O(n log max_run) segmented scans + a bounded while_loop for the OCC
neighbor counts.
"""

from __future__ import annotations

from typing import NamedTuple

from ..ops.scans_jax import segmented_cummin_jax, segmented_cummin_rev_jax
from .unique import MU_EMPTY, OCC_SATURATE


class RunsJ(NamedTuple):
    starts: object
    ends: object
    rb: object
    rt: object
    rid: object
    nruns: object


def run_info_jax(gsa):
    import jax
    import jax.numpy as jnp

    n = gsa.shape[0]
    starts = jnp.concatenate([jnp.ones(1, bool), gsa[1:] != gsa[:-1]])
    ends = jnp.concatenate([starts[1:], jnp.ones(1, bool)])
    idx = jnp.arange(n, dtype=jnp.int32)
    rb = jax.lax.cummax(jnp.where(starts, idx, -1))
    rt = jax.lax.cummin(jnp.where(ends, idx, n)[::-1])[::-1]
    rid = jnp.cumsum(starts.astype(jnp.int32)) - 1
    return RunsJ(starts, ends, rb, rt, rid, rid[-1] + 1)


def compute_gsa_jax(sa, ref_pos, ref_id):
    import jax.numpy as jnp

    j = jnp.searchsorted(ref_pos.astype(jnp.int64), sa.astype(jnp.int64),
                         side="right")
    return ref_id.astype(jnp.int32)[j]


def _direction_mins_jax(lcp, runs):
    n = runs.starts.shape[0]
    A = segmented_cummin_rev_jax(lcp[1 : n + 1], runs.ends)
    B = segmented_cummin_jax(lcp[:n], runs.starts)
    return A, B


def unique_lcp0_jax(gsa, lcp, el: int):
    import jax.numpy as jnp

    runs = run_info_jax(gsa)
    n = gsa.shape[0]
    A, B = _direction_mins_jax(lcp.astype(jnp.int32), runs)
    first = runs.rid == 0
    last = runs.rid == runs.nruns - 1
    el = jnp.int32(el)
    out = jnp.maximum(jnp.maximum(A, B), el)
    out = jnp.where(first, jnp.maximum(A, el), out)
    out = jnp.where(last, B, out)
    return jnp.where(runs.nruns == 1, 0, out)


def doubly_lcp0_jax(sa, gsa, lcp, el: int, ulmax: int):
    import jax.numpy as jnp

    runs = run_info_jax(gsa)
    n = gsa.shape[0]
    sa = sa.astype(jnp.int32)
    lcp = lcp.astype(jnp.int32)
    sentinel = jnp.int32(ulmax + 2)
    A, B = _direction_mins_jax(lcp, runs)
    first = runs.rid == 0
    last = runs.rid == runs.nruns - 1

    nxt_top = jnp.minimum(runs.rt + 1, n - 1)
    g2_fwd = gsa[nxt_top]
    Aprime = jnp.where(last, 0, A)

    prev_top = jnp.maximum(runs.rb - 1, 0)
    g2_bwd = gsa[prev_top]
    m2b = jnp.minimum(B, B[prev_top])
    lcp0_case1 = jnp.maximum(jnp.maximum(Aprime, m2b), jnp.int32(el))
    case1 = jnp.where(lcp0_case1 >= B, sentinel, lcp0_case1)

    nxt_bottom = jnp.minimum(runs.rt + 1, n - 1)
    m2f = jnp.minimum(lcp[nxt_bottom], A[nxt_bottom])
    lcp0_case2 = jnp.maximum(jnp.maximum(B, m2f), jnp.int32(el))
    case2 = jnp.where(lcp0_case2 >= Aprime, sentinel, lcp0_case2)

    out = jnp.where(Aprime < B, case1,
                    jnp.where(Aprime > B, case2, sentinel))
    g2_rank = jnp.where(Aprime < B, g2_bwd, g2_fwd)
    out = jnp.where(first, Aprime, out)
    g2_rank = jnp.where(first, g2_fwd, g2_rank)
    out = jnp.where(runs.nruns == 1, 0, out)

    write = (~last) | (Aprime < B)
    write = write & (runs.nruns > 1)
    # sa is a permutation: every text position is written exactly once,
    # with its rank's g2 (or 0 for non-writing ranks)
    gsa2_text = jnp.zeros(n, jnp.int32).at[sa].set(
        jnp.where(write, g2_rank, 0).astype(jnp.int32)
    )
    return out, gsa2_text


def min_unique_jax(sa, lcp0, n: int, ulmax=None):
    import jax.numpy as jnp

    tgt = sa.astype(jnp.int64) + lcp0.astype(jnp.int64) + 1
    keep = tgt <= n
    if ulmax is not None:
        keep = keep & (lcp0 < ulmax)
    tgt = jnp.where(keep, tgt, n)
    mu = jnp.full(n + 1, MU_EMPTY, jnp.int32)
    vals = jnp.where(keep, lcp0.astype(jnp.int32), MU_EMPTY)
    mu = mu.at[tgt].min(vals)
    # slot n may hold garbage from dropped scatters; it is never read by
    # the selection (loop bound < n), reset anyway
    mu = mu.at[n].set(MU_EMPTY)
    return mu


def _adjacent_count_jax(lcp, thresh, gsa, sa, max_steps=OCC_SATURATE):
    """Unique-OCC neighbor counting: both directions, same-genome, running
    min LCP > thresh (monotone -> early-exit while_loop)."""
    import jax
    import jax.numpy as jnp

    n = gsa.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)

    def directional(sign):
        def cond(c):
            d, cnt, run_min, alive = c
            return jnp.logical_and(d <= max_steps, jnp.any(alive))

        def body(c):
            d, cnt, run_min, alive = c
            j = idx + sign * d
            inb = (j >= 0) & (j <= n - 1)
            jc = jnp.clip(j, 0, n - 1)
            if sign > 0:
                crossing = lcp[jnp.clip(idx + d, 0, n)]
            else:
                crossing = lcp[jnp.clip(idx - d + 1, 0, n)]
            run_min = jnp.where(alive & inb, jnp.minimum(run_min, crossing), run_min)
            ok = alive & inb & (gsa[jc] == gsa) & (run_min > thresh)
            cnt = cnt + ok.astype(jnp.int32)
            return d + 1, cnt, run_min, ok

        init = (jnp.int32(1), jnp.zeros(n, jnp.int32),
                jnp.full(n, jnp.iinfo(jnp.int32).max, jnp.int32),
                jnp.ones(n, bool))
        _, cnt, _, _ = jax.lax.while_loop(cond, body, init)
        return cnt

    return directional(1), directional(-1)


def occ_unique_jax(sa, gsa, lcp, lcp0):
    import jax.numpy as jnp

    n = gsa.shape[0]
    up, down = _adjacent_count_jax(lcp.astype(jnp.int32),
                                   lcp0.astype(jnp.int32), gsa, sa)
    occ_rank = jnp.minimum(1 + up + down, OCC_SATURATE)
    return jnp.zeros(n, jnp.int32).at[sa].set(occ_rank.astype(jnp.int32))


def occ_doubly_jax(sa, gsa, gsa2_text, lcp, lcp0, ulmax: int):
    import jax
    import jax.numpy as jnp

    n = gsa.shape[0]
    lcp = lcp.astype(jnp.int32)
    lcp0 = lcp0.astype(jnp.int32)
    runs = run_info_jax(gsa)
    g2_rank = gsa2_text[sa]
    end_excl = runs.rt[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    processed = (lcp0 <= ulmax) & (idx > end_excl)

    def directional(sign):
        def cond(c):
            d, c1, c2, run_min, alive = c
            return jnp.logical_and(d <= 2 * OCC_SATURATE + 1, jnp.any(alive))

        def body(c):
            d, c1, c2, run_min, alive = c
            j = idx + sign * d
            if sign > 0:
                inb = j <= n - 1
                crossing = lcp[jnp.clip(idx + d, 0, n)]
            else:
                inb = j >= end_excl
                crossing = lcp[jnp.clip(idx - d + 1, 0, n)]
            jc = jnp.clip(j, 0, n - 1)
            genome_ok = (gsa[jc] == gsa) | (gsa[jc] == g2_rank)
            act = alive & inb & genome_ok
            run_min = jnp.where(act, jnp.minimum(run_min, crossing), run_min)
            counting = act & (run_min > lcp0)
            c1 = c1 + (counting & (gsa[jc] == gsa)).astype(jnp.int32)
            c2 = c2 + (counting & (gsa[jc] == g2_rank)).astype(jnp.int32)
            return d + 1, c1, c2, run_min, counting

        init = (jnp.int32(1), jnp.zeros(n, jnp.int32), jnp.zeros(n, jnp.int32),
                jnp.full(n, jnp.iinfo(jnp.int32).max, jnp.int32), processed)
        _, c1, c2, _, _ = jax.lax.while_loop(cond, body, init)
        return c1, c2

    u1, u2 = directional(1)
    d1, d2 = directional(-1)
    occ_rank = jnp.where(processed, jnp.minimum(1 + u1 + d1, OCC_SATURATE), 0)
    occ2_rank = jnp.where(processed, jnp.minimum(u2 + d2, OCC_SATURATE), 0)
    occ = jnp.zeros(n, jnp.int32).at[sa].set(occ_rank.astype(jnp.int32))
    occ2 = jnp.zeros(n, jnp.int32).at[sa].set(occ2_rank.astype(jnp.int32))
    return occ, occ2
