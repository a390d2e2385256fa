"""Suffix-array construction.

Replaces the reference's external libdivsufsort call (src/gsa.cpp:20-37)
with three interchangeable engines:

- `suffix_array_numpy`:   prefix-doubling with numpy argsort (host fallback,
                          O(N log^2 N), used for tests and small corpora).
- `suffix_array_jax`:     the device engine - prefix doubling with
                          `jax.lax.sort` over (rank, next-rank, index)
                          triples; fully on-device, static shapes, int32.
- native SA-IS (C++):     see native/sais.cpp + cammiq_tpu/native.py, the
                          production host engine at RefSeq scale (O(N)).

All engines return the suffix array of s (uint8 text, caller appends
sentinels if desired) as indices sorted by suffix.
"""

from __future__ import annotations

import numpy as np


def suffix_array_numpy(s: np.ndarray) -> np.ndarray:
    """Prefix-doubling suffix array (Manber-Myers / Larsson-Sadakane style).

    s: uint8 array.  Returns int64 [n] suffix array.
    """
    s = np.asarray(s)
    n = s.shape[0]
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    # initial ranks = byte values
    rank = s.astype(np.int64)
    sa = np.argsort(rank, kind="stable")
    rank = rank[sa]
    # convert sorted byte values to dense ranks over sa order
    r = np.empty(n, dtype=np.int64)
    r[sa] = np.cumsum(np.concatenate([[0], (np.diff(rank) != 0).astype(np.int64)]))
    rank = r
    k = 1
    while k < n:
        # key = (rank[i], rank[i+k]) with rank[i+k] = -1 past the end
        rank2 = np.full(n, -1, dtype=np.int64)
        rank2[: n - k] = rank[k:]
        order = np.lexsort((rank2, rank))
        key1 = rank[order]
        key2 = rank2[order]
        changed = np.concatenate(
            [[0], ((np.diff(key1) != 0) | (np.diff(key2) != 0)).astype(np.int64)]
        )
        newrank = np.cumsum(changed)
        rank = np.empty(n, dtype=np.int64)
        rank[order] = newrank
        sa = order
        if newrank[-1] == n - 1:
            break
        k *= 2
    return sa.astype(np.int64)


def inverse_permutation(sa: np.ndarray) -> np.ndarray:
    """REV[SA[i]] = i (reference computeRevSuffixArray, src/gsa.cpp:39-58)."""
    sa = np.asarray(sa)
    rev = np.empty_like(sa)
    rev[sa] = np.arange(sa.shape[0], dtype=sa.dtype)
    return rev


def suffix_array_jax(s, max_rounds: int | None = None):
    """On-device prefix-doubling suffix array.

    s: jnp uint8/int32 array [n] (n < 2**31).  Returns int32 [n] suffix
    array.  Each doubling round is one multi-operand `lax.sort` plus O(n)
    elementwise ops; rounds = ceil(log2 n) (early-exit via cond on rank
    saturation is deliberately avoided to keep the trace static; saturated
    rounds are cheap no-ops numerically).
    """
    import jax
    import jax.numpy as jnp

    s = jnp.asarray(s)
    n = s.shape[0]
    if n == 0:
        return jnp.zeros(0, dtype=jnp.int32)
    rounds = max_rounds if max_rounds is not None else max(1, int(np.ceil(np.log2(max(n, 2)))))

    idx0 = jnp.arange(n, dtype=jnp.int32)
    rank0 = s.astype(jnp.int32)
    # densify initial ranks
    r_sorted, perm = jax.lax.sort([rank0, idx0], num_keys=1)
    dense = jnp.cumsum(
        jnp.concatenate([jnp.zeros(1, jnp.int32), (jnp.diff(r_sorted) != 0).astype(jnp.int32)])
    )
    rank = jnp.zeros(n, jnp.int32).at[perm].set(dense)

    # ks are static python ints -> unrolled loop keeps slicing static.
    sa = perm
    k = 1
    for _ in range(rounds):
        rank2 = jnp.concatenate([rank[k:], jnp.full((min(k, n),), -1, jnp.int32)])[:n]
        key_sorted1, key_sorted2, order = jax.lax.sort(
            [rank, rank2, idx0], num_keys=2
        )
        changed = jnp.concatenate(
            [
                jnp.zeros(1, jnp.int32),
                ((jnp.diff(key_sorted1) != 0) | (jnp.diff(key_sorted2) != 0)).astype(jnp.int32),
            ]
        )
        newrank = jnp.cumsum(changed)
        rank = jnp.zeros(n, jnp.int32).at[order].set(newrank)
        sa = order
        k *= 2
        if k >= n:
            # one extra safety round is never needed: ranks are strictly
            # refined and k >= n separates all suffixes
            break
    return sa.astype(jnp.int32)
