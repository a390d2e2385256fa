"""Query driver: probe + classify over batches, count accumulation.

Host-side equivalent of FqReader::queryFastq_p / _sc up to (but excluding)
the solver stage (src/query.cpp:231-369).  The distributed variant lives in
parallel/dist_query.py.

Counts accumulate ON DEVICE across batches (donated-buffer jitted add):
the steady-state loop issues two async dispatches per batch and never
blocks on a transfer — overflow flags are checked ONCE per pass, and a
capacity overflow re-runs the whole read set at a widened (sticky)
capacity instead of syncing per batch.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Dict, Optional, Tuple

import numpy as np

from ..config import QueryConfig
from ..index.table import FlatIndex
from ..io.fastq import ReadSet
from ..utils.timing import Timings, stage_timer
from .classify import classify_batch
from .probe import DeviceIndex, to_device_index



@dataclasses.dataclass
class QueryCounts:
    """Accumulated classification results for one query file."""

    cnts_u: np.ndarray      # int64 [G] read_cnts_u by species id
    cnts_d: np.ndarray      # int64 [G]
    rcount_u: np.ndarray    # int64 [Eu] per unique-index entry
    rcount_d: np.ndarray    # int64 [Ed]
    nundet: int
    nconf: int
    pair_counts: Dict[Tuple[int, int], int]
    num_reads: int
    mean_read_len: int      # integer mean, reference: tlengths/reads.size()


class QuerySession:
    """Loads both indexes onto the device and classifies read sets."""

    def __init__(
        self,
        index_u: FlatIndex,
        index_d: Optional[FlatIndex],
        num_genome_slots: int,
        cfg: QueryConfig | None = None,
        engine: str = "gather",
        mesh=None,
    ):
        """engine: 'gather' (baseline per-position probe) or 'sortjoin'
        (lax.sort merge join; the product engine).

        mesh: optional ('data', 'model') jax Mesh - classification runs
        distributed (reads sharded over 'data', the merged index over
        'model', counts psum-merged; the device-mesh replacement for the
        reference's OpenMP read loop, src/query.cpp:650-889)."""
        import jax

        self.cfg = cfg or QueryConfig()
        self.mesh = mesh
        self._acc_step_fn = None
        self.num_genome_slots = num_genome_slots
        self.num_entries_u = index_u.num_entries
        self.num_entries_d = index_d.num_entries if index_d is not None else 0
        self._artifact = None
        self._pair_keys_dev = None
        self._pair_src = (
            None if index_d is None or not index_d.num_entries
            else (np.asarray(index_d.rid1), np.asarray(index_d.rid2))
        )
        if mesh is not None:
            from ..parallel.dist_query import DistSortJoinSession

            self._index_u, self._index_d = index_u, index_d
            self._dist_sessions: Dict[bool, DistSortJoinSession] = {}
            self.engine = "sortjoin-dist"
            return
        self.didx_u = to_device_index(index_u)
        if index_d is None:
            # empty doubly table: dummy never-matching index with same h
            from ..index.sparsify import SelectedSubstrings
            from ..index.table import build_flat_index

            empty = build_flat_index(
                np.zeros(1, np.uint8),
                SelectedSubstrings(
                    start=np.zeros(0, np.int64), length=np.zeros(0, np.int64),
                    rid=np.zeros(0, np.int64), occ=np.zeros(0, np.int64),
                    rid2=np.zeros(0, np.int64), occ2=np.zeros(0, np.int64),
                    ulm_count=np.zeros(0, np.int64),
                ),
                index_u.h, 32, True,
            )
            self.didx_d = to_device_index(empty)
        else:
            if index_d.h != index_u.h:
                # the reference asserts hash_len_u == hash_len_d at query
                # time (src/query.cpp:460)
                raise ValueError("unique/doubly hash lengths must match at query time")
            self.didx_d = to_device_index(index_d)

        self.engine = engine
        if engine == "sortjoin":
            from .sortjoin import build_merged_index, make_sortjoin_classifier, to_device_merged

            self._dm = to_device_merged(build_merged_index(index_u, index_d))
            self._classifiers = {}
            # fwd-only probe: N = B*O, so frac=32 gives the same absolute
            # hit capacity the 2-strand probe had at 64
            self._frac, self._maxm = 32, 16
        else:
            self._gather_fn = jax.jit(
                partial(
                    classify_batch,
                    self.didx_u,
                    self.didx_d,
                    num_genome_slots=num_genome_slots,
                ),
                static_argnames=("with_rcounts", "sc_mode"),
            )

    @classmethod
    def from_artifact(cls, artifact, num_genome_slots: int,
                      cfg: QueryConfig | None = None, mesh=None):
        """Start a session from a precomputed merged-index artifact
        (index/artifact.py): no host lexsorts, no RC re-augmentation -
        the memmapped fused records go straight to the device(s)."""
        self = cls.__new__(cls)
        self.cfg = cfg or QueryConfig()
        self.mesh = mesh
        self._acc_step_fn = None
        self.num_genome_slots = num_genome_slots
        self.num_entries_u = artifact.eu
        self.num_entries_d = artifact.ed
        self._artifact = artifact
        self._pair_keys_dev = None
        self._pair_src = "artifact" if artifact.ed else None
        if mesh is not None:
            self._index_u = self._index_d = None
            self._dist_sessions = {}
            self.engine = "sortjoin-dist"
            return self
        from .sortjoin import to_device_merged_artifact

        self._dm = to_device_merged_artifact(artifact)
        self._classifiers = {}
        # denser indexes hit more buckets per batch: the 61M-row config
        # measures ~2x the hit rate of the 15M-row one, so seed the
        # compaction capacity accordingly instead of paying a guaranteed
        # overflow pass (capacities still auto-widen if exceeded)
        self._frac = 16 if artifact.NB > (1 << 25) else 32
        self._maxm = 16
        self.engine = "sortjoin"
        return self

    # ---- per-engine classify returning DEVICE outputs (no syncs) ----

    def _classify_raw(self, codes, lengths, with_rcounts, sc_mode):
        """-> (BatchCounts on device, overflow_hits, overflow_slots)."""
        import jax.numpy as jnp

        if self.engine == "sortjoin-dist":
            sess = self._dist_session(sc_mode)
            return sess.classify_raw(codes, lengths,
                                     with_rcounts=with_rcounts)
        if self.engine == "sortjoin":
            from .sortjoin import make_sortjoin_classifier

            key = (self._frac, self._maxm)
            if key not in self._classifiers:
                self._classifiers[key] = make_sortjoin_classifier(
                    self._dm, self.num_genome_slots,
                    hit_capacity_frac=self._frac, maxm=self._maxm,
                )
            out, ovh, ovs = self._classifiers[key](
                codes, lengths, with_rcounts=with_rcounts, sc_mode=sc_mode)
            return out, ovh, ovs
        out = self._gather_fn(codes, lengths, with_rcounts=with_rcounts,
                              sc_mode=sc_mode)
        z = jnp.zeros((), jnp.int32)
        return out, z, z

    def wait_ready(self) -> None:
        """Block until the index arrays this session holds have reached
        the device (host-to-device copies are asynchronous)."""
        import jax

        held = [getattr(self, n, None) for n in ("_dm", "didx_u", "didx_d")]
        jax.block_until_ready([v for h in held if h is not None
                               for v in vars(h).values()
                               if isinstance(v, jax.Array)])

    def _dist_session(self, sc_mode: bool):
        from ..parallel.dist_query import DistSortJoinSession

        key = bool(sc_mode)
        if key not in self._dist_sessions:
            self._dist_sessions[key] = DistSortJoinSession(
                self.mesh, self._index_u, self._index_d,
                self.num_genome_slots, sc_mode=sc_mode,
                merged=self._artifact,
            )
        return self._dist_sessions[key]

    def _pair_keys(self):
        """Sorted device table (two int32 columns, lex order) of every
        pair the doubly index can assign: distinct unordered (rid1, rid2)
        rows.  case_pair always assigns a pair carried by some doubly
        entry, so a [P+1] accumulator indexed via an on-device binary
        search replaces the old [G+1, G+1] matrix — bounded memory at ANY
        genome count and no per-batch host fallback (the reference
        accumulates the same pairs in a std::map, src/query.cpp:994-997).
        """
        import jax
        import jax.numpy as jnp

        if self._pair_keys_dev is None:
            if self._pair_src is None:
                lo = hi = np.zeros(0, np.int32)
            else:
                if self._pair_src == "artifact":
                    prec = np.asarray(self._artifact.prec)
                    dd = prec[prec[:, 0] >= self._artifact.eu]
                    r1 = dd[:, 1].astype(np.int64)
                    r2 = dd[:, 2].astype(np.int64)
                else:
                    r1 = self._pair_src[0].astype(np.int64)
                    r2 = self._pair_src[1].astype(np.int64)
                lo = np.minimum(r1, r2)
                hi = np.maximum(r1, r2)
                uniq = np.unique(np.stack([lo, hi], axis=1), axis=0)
                lo = uniq[:, 0].astype(np.int32)
                hi = uniq[:, 1].astype(np.int32)
            pk = (jnp.asarray(lo), jnp.asarray(hi))
            if self.mesh is not None:
                from jax.sharding import NamedSharding, PartitionSpec as P

                pk = jax.device_put(pk, NamedSharding(self.mesh, P()))
            self._pair_keys_dev = pk
        return self._pair_keys_dev

    def _widen(self, ovh: int, ovs: int) -> None:
        """Sticky capacity widening after an overflowed pass."""
        if self.engine == "sortjoin-dist":
            for sess in self._dist_sessions.values():
                if ovh:
                    sess._frac = max(sess._frac // 2, 1)
                if ovs:
                    sess._maxm *= 2
                if sess._frac < 1 or sess._maxm > 4096:
                    raise RuntimeError(
                        f"sort-join capacity overflow persists across shards "
                        f"(hits={ovh}, slots={ovs})")
            return
        if ovh:
            self._frac = max(self._frac // 2, 1)
        if ovs:
            self._maxm *= 2
        if self._frac < 1 or self._maxm > 4096:
            raise RuntimeError(
                f"sort-join capacity overflow persists "
                f"(hits={ovh}, slots={ovs})")

    def _acc_step(self):
        """Jitted donated-buffer accumulator: acc <- acc + batch outputs.
        sc-mode pair counts scatter into the [P+1] pair-table accumulator
        on device (see _pair_keys)."""
        if self._acc_step_fn is None:
            import jax
            import jax.numpy as jnp

            def step(acc, pk_lo, pk_hi, cu, cd, rcu, rcd, nu, nc, ovh, ovs,
                     plo, phi):
                pa = acc["pairacc"]
                if pa.shape[0] > 1:  # static: sc mode with a doubly table
                    P = pk_lo.shape[0]
                    ok = plo >= 0
                    qlo = jnp.where(ok, plo, 0)
                    qhi = jnp.where(ok, phi, 0)
                    # lower_bound over the lex-sorted (lo, hi) pair table
                    lo_i = jnp.zeros_like(plo)
                    hi_i = jnp.full_like(plo, P)
                    for _ in range(max(int(P).bit_length(), 1)):
                        active = lo_i < hi_i
                        mid = (lo_i + hi_i) >> 1
                        midc = jnp.minimum(mid, P - 1)
                        kl = pk_lo[midc]
                        kh = pk_hi[midc]
                        less = (kl < qlo) | ((kl == qlo) & (kh < qhi))
                        lo_i = jnp.where(active & less, mid + 1, lo_i)
                        hi_i = jnp.where(active & ~less, mid, hi_i)
                    idx = jnp.minimum(lo_i, P - 1)
                    found = (ok & (lo_i < P)
                             & (pk_lo[idx] == qlo) & (pk_hi[idx] == qhi))
                    tgt = jnp.where(found, idx, P)
                    pa = pa.at[tgt].add(found.astype(jnp.int32))
                return dict(
                    cnts_u=acc["cnts_u"] + cu.astype(jnp.int32),
                    cnts_d=acc["cnts_d"] + cd.astype(jnp.int32),
                    rcount_u=acc["rcount_u"] + rcu.astype(jnp.int32),
                    rcount_d=acc["rcount_d"] + rcd.astype(jnp.int32),
                    nundet=acc["nundet"] + nu.astype(jnp.int32),
                    nconf=acc["nconf"] + nc.astype(jnp.int32),
                    ovh=jnp.maximum(acc["ovh"], ovh.astype(jnp.int32)),
                    ovs=jnp.maximum(acc["ovs"], ovs.astype(jnp.int32)),
                    pairacc=pa,
                )

            self._acc_step_fn = jax.jit(step, donate_argnums=0)
        return self._acc_step_fn

    def _run_pass(self, reads: ReadSet, bs: int, sc_mode: bool):
        """One full pass over the reads with device-side accumulation.
        Returns (acc dict on host, pair_counts) or None on overflow."""
        import jax
        import jax.numpy as jnp

        G = self.num_genome_slots
        pair_keys = self._pair_keys() if sc_mode else None
        n_pairs = int(pair_keys[0].shape[0]) if sc_mode else 0

        rc_shape = ((self.mesh.shape["data"],)
                    if (self.mesh is not None
                        and self.engine == "sortjoin-dist") else ())

        def _zeros():
            return dict(
                cnts_u=jnp.zeros(G, jnp.int32),
                cnts_d=jnp.zeros(G, jnp.int32),
                rcount_u=jnp.zeros(rc_shape + (self.num_entries_u,),
                                   jnp.int32),
                rcount_d=jnp.zeros(rc_shape + (self.num_entries_d,),
                                   jnp.int32),
                nundet=jnp.zeros((), jnp.int32),
                nconf=jnp.zeros((), jnp.int32),
                ovh=jnp.zeros((), jnp.int32),
                ovs=jnp.zeros((), jnp.int32),
                pairacc=jnp.zeros(
                    n_pairs + 1 if sc_mode and n_pairs else 0, jnp.int32),
            )

        if self.mesh is not None:
            # the accumulator must live replicated on the SAME mesh as the
            # distributed classify outputs, or the add-jit would mix
            # device sets
            from jax.sharding import NamedSharding, PartitionSpec as P

            shardings = {k: NamedSharding(self.mesh, P())
                         for k in _zeros()}
            if rc_shape:
                # rcount partials stay data-sharded (one [1, E] block per
                # data shard) until the end-of-pass reduction
                shardings["rcount_u"] = NamedSharding(self.mesh,
                                                      P("data", None))
                shardings["rcount_d"] = NamedSharding(self.mesh,
                                                      P("data", None))
            acc = jax.jit(_zeros, out_shardings=shardings)()
        else:
            acc = _zeros()
        pair_counts: Dict[Tuple[int, int], int] = {}
        step = self._acc_step()
        for batch in reads.batches(bs):
            out, ovh, ovs = self._classify_raw(
                jnp.asarray(batch.codes), jnp.asarray(batch.lengths),
                with_rcounts=not sc_mode, sc_mode=sc_mode,
            )
            # dist engine: [dp, E] per-data-shard partials (deferred
            # rcount reduction); single-device: [E]
            rcu = out.rcount_u[..., : self.num_entries_u]
            rcd = out.rcount_d[..., : self.num_entries_d]
            pk_lo, pk_hi = (pair_keys if n_pairs
                            else (jnp.zeros(0, jnp.int32),) * 2)
            acc = step(acc, pk_lo, pk_hi,
                       out.cnts_u, out.cnts_d, rcu, rcd,
                       out.nundet, out.nconf,
                       jnp.asarray(ovh), jnp.asarray(ovs),
                       out.pair_lo, out.pair_hi)
        if rc_shape:
            # reduce the deferred per-data-shard rcount partials on
            # device (replicated output is addressable from every
            # process; the host cannot sum non-addressable shards)
            from jax.sharding import NamedSharding, PartitionSpec as P

            red = jax.jit(lambda x: x.sum(axis=0),
                          out_shardings=NamedSharding(self.mesh, P()))
            acc = dict(acc, rcount_u=red(acc["rcount_u"]),
                       rcount_d=red(acc["rcount_d"]))
        host = jax.device_get(acc)   # the ONE blocking transfer per pass
        if int(host["ovh"]) or int(host["ovs"]):
            self._widen(int(host["ovh"]), int(host["ovs"]))
            return None
        if sc_mode and n_pairs:
            klo_h, khi_h = jax.device_get(pair_keys)
            pa = host["pairacc"][:n_pairs]
            for i in np.nonzero(pa)[0]:
                pair_counts[(int(klo_h[i]), int(khi_h[i]))] = int(pa[i])
        return host, pair_counts

    def run(self, reads: ReadSet, sc_mode: bool = False,
            timings: Timings | None = None, verbose: bool = False) -> QueryCounts:
        # avoid gross padding: shrink the batch to the read count (rounded
        # to a power of two) and the width to the longest read (rounded to
        # a multiple of 16)
        bs = self.cfg.batch_size
        if reads.num_reads < bs:
            bs = max(256, 1 << (max(reads.num_reads - 1, 1)).bit_length())
            bs = min(bs, self.cfg.batch_size)
        if self.mesh is not None:
            dp = self.mesh.shape["data"]
            bs = ((bs + dp - 1) // dp) * dp
        if reads.num_reads:
            # trim the batch width to the longest read: every extra column
            # adds probe offsets to the hot loop
            lp_eff = min(reads.codes.shape[1], int(reads.lengths.max()))
            if lp_eff < reads.codes.shape[1]:
                reads = ReadSet(
                    codes=reads.codes[:, :lp_eff], lengths=reads.lengths,
                    total_len=reads.total_len, name=reads.name,
                )
        with stage_timer("query", timings, verbose):
            while True:
                got = self._run_pass(reads, bs, sc_mode)
                if got is not None:
                    break
        host, pair_counts = got
        nr = reads.num_reads
        return QueryCounts(
            cnts_u=host["cnts_u"].astype(np.int64),
            cnts_d=host["cnts_d"].astype(np.int64),
            rcount_u=host["rcount_u"].astype(np.int64),
            rcount_d=host["rcount_d"].astype(np.int64),
            nundet=int(host["nundet"]), nconf=int(host["nconf"]),
            pair_counts=pair_counts,
            num_reads=nr,
            mean_read_len=(reads.total_len // nr) if nr else 0,
        )
