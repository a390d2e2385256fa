// Depth-bounded suffix sort + bounded adjacent LCP.
//
// The CAMMiQ build pipeline only ever consumes LCP information up to the
// unique-substring length bound (ulmax = L, plus small offsets; every
// LCP0/OCC/MU comparison in src/gsa.cpp:239-712 thresholds at <= L+2).
// A full suffix array therefore over-sorts: suffixes that agree on their
// first `depth` bytes (depth >= L+2) are interchangeable for the final
// index.  This engine sorts suffixes by their first `depth` bytes only:
//
//   1. one counting-sort pass on an order-preserving 24-bit key packed
//      from the first 12 bases (2 bits each; 16M buckets), with an exact
//      escape rule for suffixes whose 12-byte window contains a non-ACGT
//      byte (separators, IUPAC codes, end of text): the suffix is placed
//      at the boundary bucket where it belongs and the in-bucket
//      comparator puts it in its exact position;
//   2. per-bucket multikey quicksort (Bentley-Sedgewick) on raw bytes,
//      depth-capped at `depth`; ties at the cap stay in arbitrary order.
//
// Both passes are OpenMP-parallel and make one sequential read of the
// text plus one scatter, replacing the serial SA-IS recursion
// (native/sais.cpp) as the production build path.  The reference gets
// its build parallelism from parallel-divsufsort (src/gsa.cpp:20-37);
// this is the same role, redesigned around the L-bounded semantics.
//
// End-of-text convention matches SA-IS/divsufsort: a virtual sentinel
// smaller than every byte value, so the shorter suffix sorts first on
// exhaustion.
//
// Exposed C ABI (see cammiq_tpu/native.py):
//   int  cammiq_bounded_sa(const uint8_t* s, int64_t n, int64_t depth,
//                          int64_t* sa);
//   void cammiq_bounded_lcp_u16(const uint8_t* s, int64_t n,
//                               const int64_t* sa, int64_t cap,
//                               uint16_t* lcp);

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

#include "par.h"

namespace {

constexpr int kPrefixBases = 12;               // 24-bit bucket key
constexpr int64_t kNumBuckets = int64_t(1) << (2 * kPrefixBases);

// Corpus byte values of A/C/G/T: ASCII + 165 mod 256 (src/build.cpp:206).
constexpr uint8_t kBaseA = uint8_t('A' + 165);
constexpr uint8_t kBaseC = uint8_t('C' + 165);
constexpr uint8_t kBaseG = uint8_t('G' + 165);
constexpr uint8_t kBaseT = uint8_t('T' + 165);

struct Luts {
  int8_t code[256];     // 0..3 for A/C/G/T, -1 otherwise
  uint8_t nless[256];   // number of base values strictly below this byte
};

Luts make_luts() {
  Luts l;
  for (int v = 0; v < 256; ++v) {
    l.code[v] = -1;
    l.nless[v] = uint8_t((v > kBaseA) + (v > kBaseC) + (v > kBaseG) +
                         (v > kBaseT));
  }
  l.code[kBaseA] = 0;
  l.code[kBaseC] = 1;
  l.code[kBaseG] = 2;
  l.code[kBaseT] = 3;
  return l;
}

// Bucket key of suffix i.  Escape rule at the first non-base byte v
// (including the virtual end-of-text sentinel, which is smaller than
// everything): the suffix sorts strictly between the buckets
// prefix|base(nless-1)|... and prefix|base(nless)|..., so it lands in the
// first bucket of the upper range (filler 00) where the byte comparator
// sends it to the front -- or, when v > 'T', in the last bucket of the
// prefix|T range (filler 11) where the comparator sends it to the back.
inline uint32_t bucket_key(const uint8_t* s, int64_t n, int64_t i,
                           const Luts& l, bool* misc) {
  uint32_t b = 0;
  for (int p = 0; p < kPrefixBases; ++p) {
    int64_t j = i + p;
    int c = (j < n) ? l.code[s[j]] : -1;
    if (c >= 0) {
      b = (b << 2) | uint32_t(c);
      continue;
    }
    *misc = true;
    int rem = kPrefixBases - 1 - p;
    uint8_t nl = (j < n) ? l.nless[s[j]] : 0;
    if (nl >= 4) {  // beyond T: last bucket of the prefix|T range
      b = (b << 2) | 3u;
      for (int q = 0; q < rem; ++q) b = (b << 2) | 3u;
    } else {        // first bucket of the prefix|base(nl) range
      b = (b << 2) | uint32_t(nl);
      b <<= 2 * rem;
    }
    return b;
  }
  *misc = false;
  return b;
}

inline uint64_t load_be64(const uint8_t* p) {
  uint64_t w;
  std::memcpy(&w, p, 8);
#if defined(__GNUC__)
  return __builtin_bswap64(w);
#else
  uint64_t r = 0;
  for (int k = 0; k < 8; ++k) r = (r << 8) | p[k];
  return r;
#endif
}

// Compare suffixes a,b on bytes [d, cap); the shorter suffix is smaller
// on exhaustion (virtual sentinel).  Returns <0, 0 (tie at cap), >0.
inline int cmp_bounded(const uint8_t* s, int64_t n, int64_t a, int64_t b,
                       int64_t d, int64_t cap) {
  while (d < cap) {
    int64_t ra = n - a - d, rb = n - b - d;  // bytes remaining
    if (ra <= 0 || rb <= 0) {
      if (ra <= 0 && rb <= 0) return 0;
      return ra <= 0 ? -1 : 1;
    }
    if (ra >= 8 && rb >= 8 && cap - d >= 8) {
      uint64_t wa = load_be64(s + a + d), wb = load_be64(s + b + d);
      if (wa != wb) return wa < wb ? -1 : 1;
      d += 8;
      continue;
    }
    int64_t lim = std::min<int64_t>(cap - d, std::min(ra, rb));
    for (int64_t k = 0; k < lim; ++k) {
      uint8_t ca = s[a + d + k], cb = s[b + d + k];
      if (ca != cb) return ca < cb ? -1 : 1;
    }
    d += lim;
  }
  return 0;
}

// Byte at depth d of suffix i, with -1 as the end-of-text sentinel.
inline int byte_at(const uint8_t* s, int64_t n, int64_t i, int64_t d) {
  int64_t j = i + d;
  return j < n ? int(s[j]) : -1;
}

void insertion_sort(const uint8_t* s, int64_t n, int64_t* a, int64_t m,
                    int64_t d, int64_t cap) {
  for (int64_t i = 1; i < m; ++i) {
    int64_t v = a[i];
    int64_t j = i;
    while (j > 0 && cmp_bounded(s, n, v, a[j - 1], d, cap) < 0) {
      a[j] = a[j - 1];
      --j;
    }
    a[j] = v;
  }
}

// Multikey quicksort on bytes, depth-capped.  Iterative on the middle
// (equal) partition; explicit stack for the side partitions keeps the
// recursion depth bounded on skewed inputs.
void mkqs(const uint8_t* s, int64_t n, int64_t* a, int64_t m, int64_t d,
          int64_t cap) {
  struct Job { int64_t* a; int64_t m; int64_t d; };
  std::vector<Job> stack;
  stack.push_back({a, m, d});
  while (!stack.empty()) {
    Job jb = stack.back();
    stack.pop_back();
    a = jb.a; m = jb.m; d = jb.d;
    for (;;) {
      if (m <= 1 || d >= cap) break;
      if (m <= 24) {
        insertion_sort(s, n, a, m, d, cap);
        break;
      }
      // median-of-3 pivot byte at depth d
      int b0 = byte_at(s, n, a[0], d);
      int b1 = byte_at(s, n, a[m / 2], d);
      int b2 = byte_at(s, n, a[m - 1], d);
      int pv = std::max(std::min(b0, b1), std::min(std::max(b0, b1), b2));
      // ternary partition (Dutch national flag)
      int64_t lt = 0, i = 0, gt = m;
      while (i < gt) {
        int c = byte_at(s, n, a[i], d);
        if (c < pv) std::swap(a[lt++], a[i++]);
        else if (c > pv) std::swap(a[i], a[--gt]);
        else ++i;
      }
      if (lt > 1) stack.push_back({a, lt, d});
      if (m - gt > 1) stack.push_back({a + gt, m - gt, d});
      // equal partition: advance depth unless pivot was the sentinel
      // (all exhausted suffixes are mutual ties; leave them)
      if (pv < 0 || gt - lt <= 1) break;
      a += lt;
      m = gt - lt;
      d += 1;
    }
  }
}

}  // namespace

extern "C" {

int cammiq_bounded_sa(const uint8_t* s, int64_t n, int64_t depth,
                      int64_t* sa) {
  if (n < 0 || depth < kPrefixBases) return -1;
  if (n == 0) return 0;
  const Luts luts = make_luts();

  const int nt = par::num_threads();
  // per-thread bucket histograms (thread-major), then an exclusive scan
  // in bucket-major, thread-minor order gives disjoint scatter cursors
  std::vector<int64_t> hist((size_t)nt * kNumBuckets, 0);
  std::vector<uint8_t> bucket_misc(kNumBuckets, 0);

  par::region(nt, [&](int t, int) {
    int64_t lo = n * t / nt, hi = n * (t + 1) / nt;
    int64_t* h = hist.data() + (size_t)t * kNumBuckets;
    for (int64_t i = lo; i < hi; ++i) {
      bool misc = false;
      uint32_t b = bucket_key(s, n, i, luts, &misc);
      h[b]++;
      if (misc) bucket_misc[b] = 1;  // benign race: only ever set to 1
    }
  });

  // exclusive scan -> per-(bucket, thread) start offsets; also record
  // per-bucket [start, end) for the sorting pass
  std::vector<int64_t> bstart(kNumBuckets + 1);
  {
    int64_t acc = 0;
    for (int64_t b = 0; b < kNumBuckets; ++b) {
      bstart[b] = acc;
      for (int t = 0; t < nt; ++t) {
        int64_t c = hist[(size_t)t * kNumBuckets + b];
        hist[(size_t)t * kNumBuckets + b] = acc;
        acc += c;
      }
    }
    bstart[kNumBuckets] = acc;
  }

  par::region(nt, [&](int t, int) {
    int64_t lo = n * t / nt, hi = n * (t + 1) / nt;
    int64_t* cur = hist.data() + (size_t)t * kNumBuckets;
    for (int64_t i = lo; i < hi; ++i) {
      bool misc = false;
      uint32_t b = bucket_key(s, n, i, luts, &misc);
      sa[cur[b]++] = i;
    }
  });

  // per-bucket bounded sort.  Pure buckets share their first 12 bytes by
  // construction; buckets containing an escaped suffix start at depth 0.
  par::for_dynamic(0, kNumBuckets, 256, [&](int64_t b) {
    int64_t m = bstart[b + 1] - bstart[b];
    if (m <= 1) return;
    int64_t d0 = bucket_misc[b] ? 0 : kPrefixBases;
    mkqs(s, n, sa + bstart[b], m, d0, depth);
  });
  return 0;
}

// Adjacent-pair LCP clamped at `cap`, written as uint16 into lcp[n+1]
// (lcp[0] = lcp[n] = 0), the layout the sweep kernels consume.  Direct
// neighbor comparison: with the bounded SA there is no rank array and no
// Kasai carry; every pair is independent and the scan parallelizes flat.
void cammiq_bounded_lcp_u16(const uint8_t* s, int64_t n, const int64_t* sa,
                            int64_t cap, uint16_t* lcp) {
  if (n <= 0) return;
  if (cap > 0xFFFF) cap = 0xFFFF;
  lcp[0] = 0;
  lcp[n] = 0;
  par::for_static(1, n, [&](int64_t r) {
    int64_t a = sa[r - 1], b = sa[r];
    int64_t lim = std::min(cap, std::min(n - a, n - b));
    int64_t h = 0;
    while (h + 8 <= lim) {
      uint64_t wa, wb;
      std::memcpy(&wa, s + a + h, 8);
      std::memcpy(&wb, s + b + h, 8);
      if (wa != wb) {
#if defined(__GNUC__)
        h += __builtin_ctzll(wa ^ wb) >> 3;
#else
        while (s[a + h] == s[b + h]) ++h;
#endif
        lcp[r] = (uint16_t)h;
        return;
      }
      h += 8;
    }
    while (h < lim && s[a + h] == s[b + h]) ++h;
    lcp[r] = (uint16_t)h;
  });
}

}  // extern "C"
