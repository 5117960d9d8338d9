// ThreadSanitizer stress harness for the threaded row gather.
//
// The reference has no race detection at all (SURVEY.md §5.2: its only
// concurrency is DataLoader worker *processes*).  This framework's native
// host gather (gather.cpp) is multi-threaded, so it gets a real sanitizer
// gate: build with `make tsan_stress` (-fsanitize=thread) and run; any data
// race aborts with a ThreadSanitizer report (tests/test_native.py runs this
// with TSAN_OPTIONS=halt_on_error=1 and asserts a clean exit).
//
// The harness hammers the racy-by-construction surface: many concurrent
// gathers from one shared table, overlapping row sets, thread counts that
// don't divide the row count, then verifies every output byte.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <random>
#include <thread>
#include <vector>

extern "C" int32_t drin_gather_rows(const void* src, void* dst,
                                    const int32_t* rows, int64_t n,
                                    int64_t row_nbytes, int32_t n_threads);
extern "C" void* drin_wp_build(const char* buf, int64_t n_bytes,
                               int32_t max_chars);
extern "C" void drin_wp_free(void* h);
extern "C" int64_t drin_bert_encode(void* h, const uint8_t* flags,
                                    const char* text, int64_t len,
                                    int32_t unk_id, int32_t* out_ids,
                                    int64_t cap);

namespace {

constexpr int64_t kRows = 513;       // table rows (prime-ish, off-aligned)
constexpr int64_t kRowBytes = 300;   // deliberately not a multiple of 8
constexpr int64_t kGather = 1000;    // rows per gather call
constexpr int kCallers = 4;          // concurrent gather callers
constexpr int kIters = 25;           // gathers per caller

bool one_caller(const std::vector<char>& table, unsigned seed) {
  std::mt19937 rng(seed);
  std::uniform_int_distribution<int32_t> pick(0, kRows - 1);
  std::vector<int32_t> rows(kGather);
  std::vector<char> out(kGather * kRowBytes);
  for (int it = 0; it < kIters; ++it) {
    for (auto& r : rows) r = pick(rng);
    const int32_t n_threads = 1 + static_cast<int32_t>(rng() % 9);
    if (drin_gather_rows(table.data(), out.data(), rows.data(), kGather,
                         kRowBytes, n_threads) != 0) {
      std::fprintf(stderr, "gather returned nonzero\n");
      return false;
    }
    for (int64_t i = 0; i < kGather; ++i) {
      if (std::memcmp(out.data() + i * kRowBytes,
                      table.data() + static_cast<int64_t>(rows[i]) * kRowBytes,
                      kRowBytes) != 0) {
        std::fprintf(stderr, "row %lld mismatch (src row %d)\n",
                     static_cast<long long>(i), rows[i]);
        return false;
      }
    }
  }
  return true;
}

bool tokenizer_caller(void* vocab, const uint8_t* flags, unsigned seed,
                      const int32_t* want, int64_t want_n) {
  // concurrent encodes over one SHARED read-only vocab handle + flags table
  // (the serving threads' usage pattern); results must be deterministic
  std::mt19937 rng(seed);
  const char text[] = "alpha beta gamma, delta! epsilon zeta eta theta";
  std::vector<int32_t> out(64);
  for (int it = 0; it < 200; ++it) {
    const int64_t n = drin_bert_encode(vocab, flags, text, sizeof(text) - 1, 1,
                                       out.data(), 64);
    if (n != want_n || std::memcmp(out.data(), want, n * sizeof(int32_t))) {
      std::fprintf(stderr, "tokenizer output diverged (n=%lld)\n",
                   static_cast<long long>(n));
      return false;
    }
  }
  return true;
}

}  // namespace

int main() {
  std::vector<char> table(kRows * kRowBytes);
  std::mt19937 rng(0);
  for (auto& b : table) b = static_cast<char>(rng());

  std::vector<std::thread> callers;
  std::vector<int> ok(kCallers, 0);
  for (int c = 0; c < kCallers; ++c) {
    callers.emplace_back([&, c] { ok[c] = one_caller(table, 1000u + c); });
  }
  for (auto& t : callers) t.join();
  for (int c = 0; c < kCallers; ++c) {
    if (!ok[c]) {
      std::fprintf(stderr, "caller %d failed\n", c);
      return 1;
    }
  }
  // shared-vocab concurrent tokenization (read-only after build)
  const char vocab_txt[] =
      "[PAD]\n[UNK]\nalpha\nbeta\ngamma\ndelta\nepsilon\nzeta\neta\n"
      "theta\n,\n!\n##a\n##l\nph";
  void* vocab = drin_wp_build(vocab_txt, sizeof(vocab_txt) - 1, 100);
  std::vector<uint8_t> flags(0x10000, 0);
  flags[' '] = 1;
  flags[','] = flags['!'] = 4;
  const char text[] = "alpha beta gamma, delta! epsilon zeta eta theta";
  std::vector<int32_t> want(64);
  const int64_t want_n =
      drin_bert_encode(vocab, flags.data(), text, sizeof(text) - 1, 1,
                       want.data(), 64);
  if (want_n <= 0) {  // a -1 here would wrap memcmp's size to ~SIZE_MAX
    std::fprintf(stderr, "reference encode failed (want_n=%lld) — cap/vocab\n",
                 static_cast<long long>(want_n));
    return 1;
  }
  std::vector<std::thread> toks;
  std::vector<int> tok_ok(kCallers, 0);
  for (int c = 0; c < kCallers; ++c) {
    toks.emplace_back([&, c] {
      tok_ok[c] = tokenizer_caller(vocab, flags.data(), 2000u + c, want.data(),
                                   want_n);
    });
  }
  for (auto& t : toks) t.join();
  drin_wp_free(vocab);
  for (int c = 0; c < kCallers; ++c) {
    if (!tok_ok[c]) {
      std::fprintf(stderr, "tokenizer caller %d failed\n", c);
      return 1;
    }
  }
  std::printf("tsan_stress ok: %d callers x %d gathers + concurrent "
              "tokenization verified\n",
              kCallers, kIters);
  return 0;
}
