// Native host-runtime: threaded feature-table row gather.
//
// Replaces the per-example gather-join the reference performs inside
// DataLoader worker processes (drin/data.py:85-126): for each batch we
// gather B*C rows (each ~row_nbytes, e.g. 64*768*4 = 196KB for the WikiMEL
// entity text table) from a large (possibly mmap'd) table into one
// contiguous output buffer.  memcpy-bound; threads split the row list.
//
// Exposed via a tiny C ABI for ctypes (no pybind11 dependency).

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// Gather `n` rows of `row_nbytes` each from `src` (indexed by `rows[i]`)
// into `dst` (densely packed).  Returns 0 on success, nonzero on bad args.
int32_t drin_gather_rows(const void* src, void* dst, const int32_t* rows,
                         int64_t n, int64_t row_nbytes, int32_t n_threads) {
  if (src == nullptr || dst == nullptr || rows == nullptr || n < 0 ||
      row_nbytes <= 0) {
    return 1;
  }
  const char* s = static_cast<const char*>(src);
  char* d = static_cast<char*>(dst);
  if (n_threads < 1) n_threads = 1;
  if (n_threads > n) n_threads = static_cast<int32_t>(n > 0 ? n : 1);

  auto worker = [=](int64_t begin, int64_t end) {
    for (int64_t i = begin; i < end; ++i) {
      std::memcpy(d + i * row_nbytes,
                  s + static_cast<int64_t>(rows[i]) * row_nbytes,
                  static_cast<size_t>(row_nbytes));
    }
  };

  if (n_threads == 1) {
    worker(0, n);
    return 0;
  }
  // exceptions must not cross the extern "C" boundary into ctypes frames
  // (UB -> std::terminate): thread-creation failure (EAGAIN under cgroup
  // pid limits) or allocation failure degrades to the single-threaded copy
  try {
    std::vector<std::thread> threads;
    threads.reserve(n_threads);
    const int64_t chunk = (n + n_threads - 1) / n_threads;
    int64_t spawned_upto = 0;
    for (int32_t t = 0; t < n_threads; ++t) {
      const int64_t begin = t * chunk;
      const int64_t end = begin + chunk < n ? begin + chunk : n;
      if (begin >= end) break;
      try {
        threads.emplace_back(worker, begin, end);
        spawned_upto = end;
      } catch (...) {
        break;  // finish the tail on this thread below
      }
    }
    for (auto& th : threads) th.join();
    if (spawned_upto < n) worker(spawned_upto, n);
    return 0;
  } catch (...) {
    worker(0, n);  // vector/reserve failure: plain serial copy
    return 0;
  }
}

}  // extern "C"
