// Production host engine for the uniqueness pipeline at RefSeq scale.
//
// Implements the same semantics as the numpy segmented-scan engines in
// cammiq_tpu/index/unique.py (which re-derive the reference's directional
// run-sweeps, src/gsa.cpp:239-712) as streaming C++ sweeps with tight
// dtypes, so a multi-gigabase corpus fits in host RAM:
//   gsa    int32   (genome ids, maxM = 2^20)
//   lcp    uint16  (clamped at 0xFFFF like the reference, src/gsa.cpp:158)
//   lcp0   int32
//   occ    uint8   (saturate at 255, or reference uint8 wrap)
//   mu     uint16  (0xFFFF = empty, like the reference memset 0xFF)
//
// C ABI (see cammiq_tpu/native.py):
//   cammiq_kasai_u16     LCP with uint16 output
//   cammiq_gsa32         genome-id annotation of SA ranks
//   cammiq_unique_lcp0   shortest-unique-prefix lengths per rank
//   cammiq_doubly_lcp0   doubly-unique variant + second-genome ids
//   cammiq_occ_unique    own-genome occurrence counts
//   cammiq_occ_doubly    pair occurrence counts
//   cammiq_min_unique    MU scatter to substring end positions

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

#include "par.h"

namespace {

}  // namespace

extern "C" {

// Kasai LCP with per-thread carry, writing clamped uint16 (the reference
// clamps identically, src/gsa.cpp:158).  lcp has n+1 slots; lcp[0]=lcp[n]=0.
void cammiq_kasai_u16(const uint8_t* s, const int64_t* sa, uint16_t* lcp,
                      int64_t n) {
  if (n <= 0) return;
  std::vector<int64_t> rank(n);
  par::for_static(0, n, [&](int64_t i) { rank[sa[i]] = i; });
  par::region(par::num_threads(), [&](int tn, int nt) {
    int64_t lo = n * tn / nt, hi = n * (tn + 1) / nt;
    int64_t h = 0;
    for (int64_t i = lo; i < hi; ++i) {
      int64_t k = rank[i];
      if (k == 0) { h = 0; continue; }
      int64_t j = sa[k - 1];
      while (i + h < n && j + h < n && s[i + h] == s[j + h]) ++h;
      lcp[k] = (uint16_t)(h >= 0xFFFF ? 0xFFFF : h);
      if (h > 0) --h;
    }
  });
  lcp[0] = 0;
  lcp[n] = 0;
}

// GSA[i] = ref_id[first j with SA[i] < ref_pos[j]] (unique.py:compute_gsa;
// reference fillGnrSuffixArray, src/gsa.cpp:60-80).
void cammiq_gsa32(const int64_t* sa, const int64_t* ref_pos,
                  const int32_t* ref_id, int64_t m, int32_t* gsa,
                  int64_t n) {
  par::for_static(0, n, [&](int64_t i) {
    int64_t lo = 0, hi = m;  // first j with sa[i] < ref_pos[j]
    while (lo < hi) {
      int64_t mid = (lo + hi) >> 1;
      if (ref_pos[mid] <= sa[i]) lo = mid + 1;
      else hi = mid;
    }
    gsa[i] = (lo < m) ? ref_id[lo] : ref_id[m - 1];
  });
}

// LCP0[i] per unique_lcp0 (unique.py:90-109): first run = max(el, A);
// last run = B; middle = max(el, A, B); single-run corpus = zeros.
// Only A is materialized (uint16, 2n bytes); B streams in the forward
// sweep - at multi-gigabase n every avoided array matters.
void cammiq_unique_lcp0(const int32_t* gsa, const uint16_t* lcp, int64_t n,
                        int32_t el, int32_t* lcp0) {
  if (n == 0) return;
  bool single = true;
  for (int64_t i = 1; i < n && single; ++i) single = gsa[i] == gsa[0];
  if (single) { std::memset(lcp0, 0, sizeof(int32_t) * n); return; }
  std::vector<uint16_t> A(n);
  {
    uint16_t run = 0xFFFF;
    for (int64_t i = n - 1; i >= 0; --i) {
      if (i == n - 1 || gsa[i] != gsa[i + 1]) run = lcp[i + 1];
      else run = std::min(run, lcp[i + 1]);
      A[i] = run;
    }
  }
  int64_t first_end = 0;
  while (first_end + 1 < n && gsa[first_end + 1] == gsa[0]) ++first_end;
  int64_t last_begin = n - 1;
  while (last_begin > 0 && gsa[last_begin - 1] == gsa[n - 1]) --last_begin;
  uint16_t b = 0xFFFF;
  for (int64_t i = 0; i < n; ++i) {
    if (i == 0 || gsa[i] != gsa[i - 1]) b = lcp[i];
    else b = std::min(b, lcp[i]);
    if (i <= first_end) lcp0[i] = std::max((int32_t)A[i], el);
    else if (i >= last_begin) lcp0[i] = (int32_t)b;
    else lcp0[i] = std::max(std::max((int32_t)A[i], (int32_t)b), el);
  }
}

// Doubly-unique LCP0 + second-genome ids (unique.py:doubly_lcp0, the
// segmented re-derivation of computeGnrLcpArray16_d, src/gsa.cpp:311-406).
// lcp0 out int32 [n] (sentinel = ulmax+2); gsa2_text out int32 [n] by TEXT
// position (caller zero-fills).
void cammiq_doubly_lcp0(const int64_t* sa, const int32_t* gsa,
                        const uint16_t* lcp, int64_t n, int32_t el,
                        int32_t ulmax, int32_t* lcp0, int32_t* gsa2_text) {
  if (n == 0) return;
  bool single = true;
  for (int64_t i = 1; i < n && single; ++i) single = gsa[i] == gsa[0];
  if (single) { std::memset(lcp0, 0, sizeof(int32_t) * n); return; }
  const int32_t sentinel = ulmax + 2;
  // materialize only A (uint16, backward pass); B and the run boundaries
  // stream in a run-by-run forward sweep - the rt/rb int64 helper arrays
  // would cost 16n bytes at multi-gigabase n.
  std::vector<uint16_t> A(n);
  {
    uint16_t run = 0xFFFF;
    for (int64_t i = n - 1; i >= 0; --i) {
      if (i == n - 1 || gsa[i] != gsa[i + 1]) run = lcp[i + 1];
      else run = std::min(run, lcp[i + 1]);
      A[i] = run;
    }
  }
  int64_t s = 0;
  int32_t B_prev_top = 0;   // B at the top of the previous run
  int32_t g_prev = 0;       // previous run's genome
  bool first_run = true;
  while (s < n) {
    int64_t e = s;
    while (e + 1 < n && gsa[e + 1] == gsa[s]) ++e;
    bool is_last = (e == n - 1);
    int64_t nxt_top = std::min(e + 1, n - 1);       // rb of next run
    int32_t g2_fwd = gsa[nxt_top];
    // m2f = min(LCP[rb(next)], A[rb(next)]) (garbage for last run; masked)
    int32_t m2f = std::min((int32_t)lcp[nxt_top], (int32_t)A[nxt_top]);
    int32_t b = 0;
    for (int64_t i = s; i <= e; ++i) {
      b = (i == s) ? (int32_t)lcp[i] : std::min(b, (int32_t)lcp[i]);
      int32_t Ap = is_last ? 0 : (int32_t)A[i];
      int32_t out;
      int32_t g2;
      bool write_g2;
      if (first_run) {
        // first run: forward pass only (LCP0 = A', g2 = next-run genome)
        out = Ap;
        g2 = g2_fwd;
        write_g2 = true;
      } else if (Ap < b) {
        // case 1: g2 = previous run's genome; m2b = min(B[i], B[prev_top])
        int32_t m2b = std::min(b, B_prev_top);
        int32_t v = std::max(std::max(Ap, m2b), el);
        out = (v >= b) ? sentinel : v;
        g2 = g_prev;
        write_g2 = true;
      } else if (Ap > b) {
        // case 2: g2 = next run's genome
        int32_t v = std::max(std::max(b, m2f), el);
        out = (v >= Ap) ? sentinel : v;
        g2 = g2_fwd;
        write_g2 = !is_last;
      } else {
        out = sentinel;
        g2 = g2_fwd;
        write_g2 = !is_last;
      }
      lcp0[i] = out;
      if (write_g2) gsa2_text[sa[i]] = g2;
    }
    B_prev_top = b;
    g_prev = gsa[s];
    first_run = false;
    s = e + 1;
  }
}

// Own-genome occurrence counts (unique.py:occ_unique; reference
// computeOCC16/32, src/gsa.cpp:544-614).  occ out uint8 [n] by TEXT
// position; wrap!=0 emulates the reference's uint8 wrap-around, else
// saturate at 255.
void cammiq_occ_unique(const int64_t* sa, const int32_t* gsa,
                       const uint16_t* lcp, const int32_t* lcp0, int64_t n,
                       int wrap, uint8_t* occ) {
  par::for_dynamic(0, n, 4096, [&](int64_t i) {
    int64_t cnt = 1;
    // upward: neighbors i+d while same genome and min(LCP[i+1..i+d]) > LCP0
    int32_t run = INT32_MAX;
    for (int64_t d = 1; i + d <= n - 1; ++d) {
      run = std::min(run, (int32_t)lcp[i + d]);
      if (gsa[i + d] != gsa[i] || run <= lcp0[i]) break;
      ++cnt;
      if (!wrap && cnt > 255) break;  // saturated; down-walk only adds
    }
    // downward: neighbors i-d while same genome and min(LCP[i-d+1..i]) > LCP0
    run = INT32_MAX;
    for (int64_t d = 1; i - d >= 0; ++d) {
      run = std::min(run, (int32_t)lcp[i - d + 1]);
      if (gsa[i - d] != gsa[i] || run <= lcp0[i]) break;
      ++cnt;
      if (!wrap && cnt > 255 + 255) break;  // both loops contribute; cap conservatively
    }
    occ[sa[i]] = wrap ? (uint8_t)(cnt & 0xFF)
                      : (uint8_t)(cnt > 255 ? 255 : cnt);
  });
}

// Pair occurrence counts (unique.py:occ_doubly; reference computeOCC16_d,
// src/gsa.cpp:616-712).  occ/occ2 out uint8 [n] by TEXT position
// (caller zero-fills); gsa2_text int32 [n] by text position.
void cammiq_occ_doubly(const int64_t* sa, const int32_t* gsa,
                       const int32_t* gsa2_text, const uint16_t* lcp,
                       const int32_t* lcp0, int64_t n, int32_t ulmax,
                       int wrap, uint8_t* occ, uint8_t* occ2) {
  if (n == 0) return;
  int64_t end_excl = 0;  // top of the first run (gsa.cpp:625-626)
  while (end_excl + 1 < n && gsa[end_excl + 1] == gsa[0]) ++end_excl;
  par::for_dynamic(end_excl + 1, n, 4096, [&](int64_t i) {
    if (lcp0[i] > ulmax) return;
    int64_t p = sa[i];
    int32_t g = gsa[i], g2 = gsa2_text[p];
    int64_t c1 = 1, c2 = 0;
    // upward walk: neighbor genome in {g, g2}; early stop once the
    // running min drops (the min is nonincreasing, so no later step can
    // count - identical counts to the reference's keep-walking loop)
    int32_t run = INT32_MAX;
    for (int64_t d = 1; i + d <= n - 1; ++d) {
      int32_t gn = gsa[i + d];
      if (gn != g && gn != g2) break;
      run = std::min(run, (int32_t)lcp[i + d]);
      if (run <= lcp0[i]) break;
      if (gn == g) ++c1;
      if (gn == g2) ++c2;
      if (!wrap && c1 > 255 && c2 > 255) break;
    }
    // downward walk reaches ranks down to end_excl inclusive
    run = INT32_MAX;
    for (int64_t d = 1; i - d >= end_excl; ++d) {
      int32_t gn = gsa[i - d];
      if (gn != g && gn != g2) break;
      run = std::min(run, (int32_t)lcp[i - d + 1]);
      if (run <= lcp0[i]) break;
      if (gn == g) ++c1;
      if (gn == g2) ++c2;
      if (!wrap && c1 > 255 && c2 > 255) break;
    }
    occ[p] = wrap ? (uint8_t)(c1 & 0xFF) : (uint8_t)(c1 > 255 ? 255 : c1);
    occ2[p] = wrap ? (uint8_t)(c2 & 0xFF) : (uint8_t)(c2 > 255 ? 255 : c2);
  });
}

// MU[e] = min over ranks i with SA[i]+LCP0[i]+1 == e of LCP0[i]
// (unique.py:min_unique; reference computeMinUnique, src/gsa.cpp:505-542).
// mu out uint16 [n+1], caller prefills 0xFFFF; ulmax < 0 = unique mode.
void cammiq_min_unique(const int64_t* sa, const int32_t* lcp0, int64_t n,
                       int32_t ulmax, uint16_t* mu) {
  for (int64_t i = 0; i < n; ++i) {
    int32_t l = lcp0[i];
    if (ulmax >= 0 && l >= ulmax) continue;
    int64_t tgt = sa[i] + (int64_t)l + 1;
    if (tgt > n) continue;
    uint16_t v = (uint16_t)(l > 0xFFFE ? 0xFFFE : l);
    if (v < mu[tgt]) mu[tgt] = v;
  }
}

}  // extern "C"

extern "C" {

// Sparsified index selection (the semantics of
// cammiq_tpu/index/sparsify.py:select_substrings_exact, which transcribes
// the reference computeIndexmin/_d walk, src/build.cpp:336-629) as an
// O(n) sweep with O(1) state: walk MU candidates in text order per genome
// group, maintain the greedy covering state, count unique L-mers with
// contig-boundary corrections.  The non-ACGT window test uses a rolling
// last-bad-position pointer instead of a 8n-byte prefix-sum array.
//
// Outputs: (out_start, out_len, out_ri) for each emitted substring
// (out_ri = genome FILE index; the caller maps to species ids), ulm[M]
// unique-L-mer counts (caller zero-fills).  Returns the emitted count,
// or -1 if cap would be exceeded.
int64_t cammiq_select(const uint8_t* seq, const uint16_t* mu,
                      const int64_t* contig_pos, int64_t C,
                      const int64_t* ref_pos, int64_t M, int64_t n,
                      int32_t L, int32_t Lmax, int32_t num_groups,
                      int unique_if_advance, int64_t* out_start,
                      int32_t* out_len, int32_t* out_ri, int64_t* ulm,
                      int64_t cap) {
  if (M == 0 || n == 0) return 0;
  if (num_groups < 1) num_groups = 1;
  if (num_groups > 4) num_groups = 4;
  if (num_groups > (int32_t)M) num_groups = (int32_t)M;
  std::vector<uint8_t> exist_unique(C, 1);
  int64_t n_out = 0;

  // rolling non-ACGT tracker: last_bad = last position < scan_ptr whose
  // byte is not an offset-ACGT (A/C/G/T + 165 mod 256: 230/232/236/249)
  auto is_acgt = [](uint8_t b) {
    return b == 230 || b == 232 || b == 236 || b == 249;
  };
  int64_t scan_ptr = 0, last_bad = -1;

  int64_t nref = M / num_groups;
  for (int32_t tid = 0; tid < num_groups; ++tid) {
    int64_t i0 = (tid == 0) ? 1 : ref_pos[(int64_t)tid * nref - 1];
    int64_t nexti = (tid == num_groups - 1) ? ref_pos[M - 1]
                                            : ref_pos[((int64_t)tid + 1) * nref - 1];
    // ci = searchsorted(contig_pos, i0, right)
    int64_t ci = 0;
    {
      int64_t lo = 0, hi = C;
      while (lo < hi) {
        int64_t mid = (lo + hi) >> 1;
        if (contig_pos[mid] <= i0) lo = mid + 1;
        else hi = mid;
      }
      ci = lo;
    }
    int64_t ri = (int64_t)tid * nref;
    int64_t lastr = ri;
    int64_t start = 0, start_ = 0, lastj = 0, lastl = 0;

    for (int64_t i = (i0 < 1 ? 1 : i0); i < nexti; ++i) {
      if (mu[i] == 0xFFFF) continue;
      int64_t j = i - (int64_t)mu[i];

      // contig separator region (src/build.cpp:362-377 / 460-475)
      bool stopped = false;
      while (ci < C && i >= contig_pos[ci] - 4) {
        if (start + L + 2 >= contig_pos[ci] && exist_unique[ci])
          ulm[lastr] -= start + L + 3 - contig_pos[ci];
        start = std::max(contig_pos[ci], i - L);
        ++ci;
        if (ci >= C) { stopped = true; break; }
        if (ri < M && i >= ref_pos[ri] - 4) ++ri;
        if (start + L + 2 >= contig_pos[ci]) exist_unique[ci] = 0;
        if (unique_if_advance) break;
      }
      if (stopped || ci >= C) break;

      // substring spans two contigs (src/build.cpp:380-383)
      if (ci > 0 && j - 1 < contig_pos[ci - 1]) continue;
      // substring contains non-ACGT (rolling tracker; window seq[j-1..i-1])
      while (scan_ptr < i) {
        if (!is_acgt(seq[scan_ptr])) last_bad = scan_ptr;
        ++scan_ptr;
      }
      if (last_bad >= j - 1) continue;
      int64_t length = i - j + 1;
      if (length > Lmax) continue;

      // greedy covering insert (src/build.cpp:407-414)
      if (i > start_ + L && lastl > 0) {
        if (n_out >= cap) return -1;
        out_start[n_out] = lastj - 1;
        out_len[n_out] = (int32_t)lastl;
        out_ri[n_out] = (int32_t)lastr;
        ++n_out;
        start_ = lastj;
      }

      // unique L-mer aggregation (src/build.cpp:416-423)
      if (i <= start + L) ulm[ri] += j - start;
      else ulm[ri] += j + L - i;
      start = j;

      lastr = ri;
      lastl = length;
      lastj = j;
    }
  }
  return n_out;
}

}  // extern "C"
