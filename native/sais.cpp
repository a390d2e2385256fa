// Native kernels for CAMMiQ-TPU: SA-IS suffix array + Kasai LCP.
//
// Replaces the reference's external parallel-divsufsort dependency
// (reference src/gsa.cpp:20-37 calls divsufsort) with a from-scratch
// SA-IS (Nong, Zhang & Chan induced-sorting) implementation, and the
// Kasai LCP loop (reference src/gsa.cpp:145-167) with an OpenMP
// block-partitioned variant using per-block carry re-derivation.
//
// Exposed C ABI (see cammiq_tpu/native.py):
//   int  cammiq_sais64(const uint8_t* s, int64_t* sa, int64_t n);
//   void cammiq_kasai(const uint8_t* s, const int64_t* sa, int64_t* lcp,
//                     int64_t n, int64_t clamp);

#include <cstdint>
#include <cstring>
#include <vector>

#include "par.h"

namespace {

// Generic SA-IS over an integer string `s` of length n with alphabet size K.
// sa must have room for n entries.  Returns 0 on success.
template <typename CharT>
static int sais_core(const CharT* s, int64_t* sa, int64_t n, int64_t K,
                     std::vector<int64_t>& work) {
  if (n == 0) return 0;
  if (n == 1) { sa[0] = 0; return 0; }

  // 1. type array: t[i] = 1 if suffix i is S-type
  std::vector<uint8_t> t(n);
  t[n - 1] = 1;  // by convention the last (no sentinel appended) is S-type
  for (int64_t i = n - 2; i >= 0; --i)
    t[i] = (s[i] < s[i + 1]) || (s[i] == s[i + 1] && t[i + 1]);

  auto is_lms = [&](int64_t i) {
    return i > 0 && t[i] && !t[i - 1];
  };

  std::vector<int64_t> bkt(K + 1);
  auto count_buckets = [&]() {
    std::fill(bkt.begin(), bkt.end(), 0);
    for (int64_t i = 0; i < n; ++i) bkt[(int64_t)s[i] + 1]++;
    for (int64_t i = 0; i < K; ++i) bkt[i + 1] += bkt[i];
  };

  std::vector<int64_t> bkt_heads(K), bkt_tails(K);
  auto reset_heads = [&]() {
    for (int64_t c = 0; c < K; ++c) bkt_heads[c] = bkt[c];
  };
  auto reset_tails = [&]() {
    for (int64_t c = 0; c < K; ++c) bkt_tails[c] = bkt[c + 1];
  };

  auto induce = [&](const std::vector<int64_t>& lms, bool final_pass) {
    (void)final_pass;
    std::fill(sa, sa + n, -1);
    count_buckets();
    // place LMS suffixes at bucket tails in given order (reverse fill)
    reset_tails();
    for (int64_t i = (int64_t)lms.size() - 1; i >= 0; --i) {
      int64_t p = lms[i];
      sa[--bkt_tails[(int64_t)s[p]]] = p;
    }
    // induce L-type from left to right
    reset_heads();
    for (int64_t i = 0; i < n; ++i) {
      int64_t j = sa[i];
      if (j > 0 && !t[j - 1]) sa[bkt_heads[(int64_t)s[j - 1]]++] = j - 1;
    }
    // the suffix starting at n-1... if L-type, must be seeded: handled by
    // the convention that t[n-1] = S; when s has a unique smallest
    // sentinel the standard version works.  We ensure a virtual sentinel
    // below by treating position n-1 specially in the caller.
    // induce S-type from right to left
    reset_tails();
    for (int64_t i = n - 1; i >= 0; --i) {
      int64_t j = sa[i];
      if (j > 0 && t[j - 1]) sa[--bkt_tails[(int64_t)s[j - 1]]] = j - 1;
    }
  };

  // collect LMS positions in text order
  std::vector<int64_t> lms;
  lms.reserve(n / 2 + 1);
  for (int64_t i = 1; i < n; ++i)
    if (is_lms(i)) lms.push_back(i);

  if (lms.empty()) {
    // monotone non-increasing string: suffixes sort by position rules.
    // All suffixes are L-type except the last.  Induce with just bucket
    // scatter: sort by first char then by... simplest: insert positions
    // at bucket tails in increasing position order gives correct order
    // for non-increasing strings (longer suffix = smaller char first).
    count_buckets();
    reset_tails();
    for (int64_t i = 0; i < n; ++i) sa[--bkt_tails[(int64_t)s[i]]] = i;
    return 0;
  }

  // first induced sort to order LMS substrings
  induce(lms, false);

  // compact sorted LMS positions
  std::vector<int64_t> sorted_lms;
  sorted_lms.reserve(lms.size());
  for (int64_t i = 0; i < n; ++i)
    if (sa[i] > 0 && is_lms(sa[i])) sorted_lms.push_back(sa[i]);

  // name LMS substrings.  Names are stored per LMS ordinal (m-sized);
  // the text-position -> ordinal map is a binary search over `lms`
  // (sorted by construction), avoiding an n-sized int64 name array -
  // at multi-gigabase n that array alone would cost 8n bytes.
  int64_t m = (int64_t)lms.size();
  std::vector<int64_t> reduced(m, -1);
  auto lms_ord = [&](int64_t pos) {
    return (int64_t)(std::lower_bound(lms.begin(), lms.end(), pos) -
                     lms.begin());
  };
  int64_t names = 0;
  int64_t prev = -1;
  for (size_t k = 0; k < sorted_lms.size(); ++k) {
    int64_t cur = sorted_lms[k];
    if (prev < 0) {
      names = 1;
    } else {
      // compare LMS substrings at prev and cur
      bool same = true;
      for (int64_t d = 0;; ++d) {
        if (prev + d >= n || cur + d >= n) { same = false; break; }
        if (s[prev + d] != s[cur + d]) { same = false; break; }
        bool lp = d > 0 && is_lms(prev + d);
        bool lc = d > 0 && is_lms(cur + d);
        if (lp != lc) { same = false; break; }
        if (lp && lc) break;          // both ended with equal chars
      }
      if (!same) ++names;
    }
    reduced[lms_ord(cur)] = names - 1;
    prev = cur;
  }
  { std::vector<int64_t>().swap(sorted_lms); }  // free before recursion

  std::vector<int64_t> lms_order(m);
  if (names < m) {
    // recurse on the reduced string
    std::vector<int64_t> rsa(m);
    sais_core<int64_t>(reduced.data(), rsa.data(), m, names, work);
    for (int64_t i = 0; i < m; ++i) lms_order[i] = lms[rsa[i]];
  } else {
    // names unique: order directly
    for (int64_t i = 0; i < m; ++i) lms_order[reduced[i]] = lms[i];
  }
  { std::vector<int64_t>().swap(reduced); }

  induce(lms_order, true);
  return 0;
}

}  // namespace

extern "C" {

int cammiq_sais64(const uint8_t* s, int64_t* sa, int64_t n) {
  // Append a virtual 0 sentinel smaller than every character by shifting
  // the alphabet: build s' = s[i] + 1 with sentinel 0 at the end, run
  // SA-IS on n+1 chars, drop the sentinel entry.  This matches
  // divsufsort's ordering (shorter prefix-suffix sorts first).
  if (n < 0) return -1;
  if (n == 0) return 0;
  std::vector<uint16_t> sp(n + 1);
  for (int64_t i = 0; i < n; ++i) sp[i] = (uint16_t)s[i] + 1;
  sp[n] = 0;
  std::vector<int64_t> sa1(n + 1);
  std::vector<int64_t> work;
  int rc = sais_core<uint16_t>(sp.data(), sa1.data(), n + 1, 257, work);
  if (rc != 0) return rc;
  // sa1[0] == n (the sentinel); drop it
  int64_t k = 0;
  for (int64_t i = 0; i <= n; ++i)
    if (sa1[i] != n) sa[k++] = sa1[i];
  return (k == n) ? 0 : -2;
}

void cammiq_kasai(const uint8_t* s, const int64_t* sa, int64_t* lcp,
                  int64_t n, int64_t clamp) {
  if (n <= 0) return;
  std::vector<int64_t> rank(n);
  par::for_static(0, n, [&](int64_t i) { rank[sa[i]] = i; });

  // Kasai with per-thread carry (the reference runs the same loop with an
  // OpenMP firstprivate carry, src/gsa.cpp:150-160; the carry self-heals
  // within a few iterations of each thread's range).
  par::region(par::num_threads(), [&](int tn, int nt) {
    int64_t lo = n * tn / nt, hi = n * (tn + 1) / nt;
    int64_t h = 0;
    for (int64_t i = lo; i < hi; ++i) {
      int64_t k = rank[i];
      if (k == 0) { h = 0; continue; }
      int64_t j = sa[k - 1];
      while (i + h < n && j + h < n && s[i + h] == s[j + h]) ++h;
      lcp[k] = h >= clamp ? clamp : h;
      if (h > 0) --h;
    }
  });
  lcp[0] = 0;
  lcp[n] = 0;
}

}  // extern "C"
