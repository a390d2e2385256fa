// Fork-join parallel loops on std::thread.  The build needs no OpenMP
// runtime: some toolchains ship g++ without libgomp.
#pragma once

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <thread>
#include <vector>

namespace par {

inline int num_threads() {
  unsigned n = std::thread::hardware_concurrency();
  return n ? static_cast<int>(n) : 1;
}

// f(t, nt) on nt threads (the calling thread is t = 0), then join.
template <class F>
void region(int nt, const F& f) {
  std::vector<std::thread> pool;
  pool.reserve(nt > 1 ? nt - 1 : 0);
  for (int t = 1; t < nt; ++t) pool.emplace_back([&f, t, nt] { f(t, nt); });
  f(0, nt);
  for (auto& th : pool) th.join();
}

// f(i) for i in [lo, hi): one contiguous slice per thread.
template <class F>
void for_static(int64_t lo, int64_t hi, const F& f) {
  if (hi <= lo) return;
  int nt = static_cast<int>(std::min<int64_t>(num_threads(), hi - lo));
  region(nt, [&](int t, int n) {
    int64_t a = lo + (hi - lo) * t / n, b = lo + (hi - lo) * (t + 1) / n;
    for (int64_t i = a; i < b; ++i) f(i);
  });
}

// f(i) for i in [lo, hi): chunks of `chunk` indices handed out on demand.
template <class F>
void for_dynamic(int64_t lo, int64_t hi, int64_t chunk, const F& f) {
  if (hi <= lo) return;
  std::atomic<int64_t> next(lo);
  region(num_threads(), [&](int, int) {
    for (;;) {
      int64_t a = next.fetch_add(chunk);
      if (a >= hi) break;
      int64_t b = std::min(a + chunk, hi);
      for (int64_t i = a; i < b; ++i) f(i);
    }
  });
}

}  // namespace par
