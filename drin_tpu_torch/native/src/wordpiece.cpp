// Native host-runtime: WordPiece greedy longest-match tokenization.
//
// The reference depends on HF's Rust `tokenizers` wheel for WordPiece
// (SURVEY §2.12: prepare.py:33, baselines/data.py:212); this repo's
// in-framework tokenizer is pure Python (text/wordpiece.py) and GIL-bound —
// the online data path's dominant host cost.  This module implements the
// inner loop (per-word greedy longest-match against the vocab) natively:
// the Python BasicTokenizer still does the unicode-aware splitting (unicode
// category tables stay in Python), and each pre-split word batch is matched
// here in one ctypes call (which releases the GIL).
//
// Semantics are byte-exact with text/wordpiece.WordPieceTokenizer: match
// boundaries are UTF-8 CODEPOINTS (Python string slicing), continuation
// pieces carry the "##" prefix, words longer than max_chars codepoints or
// with an unmatchable tail collapse to a single [UNK].
//
// Exposed via a tiny C ABI for ctypes (no pybind11 dependency).

#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct WpVocab {
  std::unordered_map<std::string, int32_t> map;
  int32_t max_chars;
};

// one word's greedy longest-match (defined below, shared by every entry
// point); returns the new cumulative id count or -1 on overflow
int64_t wp_match(const WpVocab* v, const char* s, int64_t len, int32_t unk_id,
                 int32_t* out_ids, int64_t cap, int64_t total,
                 std::string& sub, std::vector<int64_t>& cps,
                 std::vector<int32_t>& word_ids);

}  // namespace

extern "C" {

// Build a vocab handle from a '\n'-separated token buffer; token i gets id i
// (the order of ids in vocab.txt).  Caller frees with drin_wp_free.
void* drin_wp_build(const char* buf, int64_t n_bytes, int32_t max_chars) {
  // exceptions (bad_alloc from new/unordered_map/string) must not cross
  // the extern "C" boundary into ctypes frames: return NULL instead, the
  // Python side raises and falls back to the pure-Python matcher
  try {
    auto* v = new WpVocab();
    v->max_chars = max_chars;
    int32_t id = 0;
    const char* p = buf;
    const char* end = buf + n_bytes;
    while (p < end) {
      const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
      const size_t len = nl ? static_cast<size_t>(nl - p)
                            : static_cast<size_t>(end - p);
      // assignment, not emplace: a duplicate token keeps the LAST id, matching
      // the Python dict loader (text/wordpiece.py vocab[line] = i)
      v->map[std::string(p, len)] = id++;
      p = nl ? nl + 1 : end;
    }
    return v;
  } catch (...) {
    return nullptr;
  }
}

void drin_wp_free(void* h) { delete static_cast<WpVocab*>(h); }

// Tokenize `n_words` pre-split words (concatenated UTF-8 in `words_buf`,
// word w spanning bytes [offsets[w], offsets[w+1])) into vocab ids.
// Writes ids densely into `out_ids` (capacity `cap`) and the cumulative id
// count after each word into `out_word_ends[w]`.  Returns the total id
// count, or -1 if `cap` is too small.
int64_t drin_wp_tokenize(void* h, const char* words_buf, const int64_t* offsets,
                         int64_t n_words, int32_t unk_id, int32_t* out_ids,
                         int64_t cap, int64_t* out_word_ends) {
  const auto* v = static_cast<const WpVocab*>(h);
  int64_t total = 0;
  std::string sub;
  std::vector<int64_t> cps;
  std::vector<int32_t> word_ids;
  for (int64_t w = 0; w < n_words; ++w) {
    total = wp_match(v, words_buf + offsets[w], offsets[w + 1] - offsets[w],
                     unk_id, out_ids, cap, total, sub, cps, word_ids);
    if (total < 0) return -1;
    out_word_ends[w] = total;
  }
  return total;
}

}  // extern "C"

namespace {

// classification flags built in Python from unicodedata (BMP only; texts
// containing 4-byte UTF-8 take the Python path so astral categories never
// need to live here)
constexpr uint8_t kWs = 1, kCtrl = 2, kPunct = 4, kCjk = 8, kDrop = 16;

int64_t wp_match(const WpVocab* v, const char* s, int64_t len, int32_t unk_id,
                 int32_t* out_ids, int64_t cap, int64_t total,
                 std::string& sub, std::vector<int64_t>& cps,
                 std::vector<int32_t>& word_ids) {
  // one word's greedy longest-match; returns new total or -1 on overflow
  cps.clear();
  for (int64_t i = 0; i < len;) {
    cps.push_back(i);
    const unsigned char c = static_cast<unsigned char>(s[i]);
    i += (c < 0x80) ? 1 : (c < 0xE0) ? 2 : (c < 0xF0) ? 3 : 4;
  }
  cps.push_back(len);
  const int64_t n_cp = static_cast<int64_t>(cps.size()) - 1;
  word_ids.clear();
  bool ok = n_cp <= v->max_chars;
  if (ok) {
    int64_t start = 0;
    while (start < n_cp) {
      int64_t end_cp = n_cp;
      int32_t cur = -1;
      while (start < end_cp) {
        sub.clear();
        if (start > 0) sub.append("##");
        sub.append(s + cps[start], static_cast<size_t>(cps[end_cp] - cps[start]));
        const auto it = v->map.find(sub);
        if (it != v->map.end()) {
          cur = it->second;
          break;
        }
        --end_cp;
      }
      if (cur < 0) {
        ok = false;
        break;
      }
      word_ids.push_back(cur);
      start = end_cp;
    }
  }
  if (!ok) {
    word_ids.clear();
    word_ids.push_back(unk_id);
  }
  if (total + static_cast<int64_t>(word_ids.size()) > cap) return -1;
  for (const int32_t id : word_ids) out_ids[total++] = id;
  return total;
}

}  // namespace

extern "C" {

// Full BERT tokenize -> vocab ids for one text (no CLS/SEP): the
// BasicTokenizer pass (clean / whitespace / CJK isolation / punctuation
// split; bert-base-cased semantics, i.e. no lowercasing) fused with the
// WordPiece match.  `flags` is the 65536-entry BMP classification table
// built from Python's unicodedata; the caller guarantees the text contains
// no 4-byte UTF-8 sequences.  Returns the id count or -1 on overflow.
int64_t drin_bert_encode(void* h, const uint8_t* flags, const char* text,
                         int64_t len, int32_t unk_id, int32_t* out_ids,
                         int64_t cap) {
  const auto* v = static_cast<const WpVocab*>(h);
  int64_t total = 0;
  std::string sub;
  std::vector<int64_t> cps;
  std::vector<int32_t> word_ids;
  int64_t wstart = -1;  // byte start of the in-flight word, -1 = none
  for (int64_t i = 0; i < len;) {
    const unsigned char c = static_cast<unsigned char>(text[i]);
    // malformed UTF-8 (stray continuation byte as lead, or a sequence
    // truncated at the buffer edge) must not drive an out-of-bounds read
    // of text[i+1]/text[i+2]: signal -2 so the caller takes the Python
    // path (today's Python wrappers always pass valid whole-text UTF-8,
    // but this symbol is a raw C export — its safety cannot rest on that)
    if (c >= 0x80 && c < 0xC0) return -2;
    const int n = (c < 0x80) ? 1 : (c < 0xE0) ? 2 : (c < 0xF0) ? 3 : 4;
    if (i + n > len) return -2;
    uint32_t cp = 0;
    if (n == 1) {
      cp = c;
    } else if (n == 2) {
      cp = ((c & 0x1Fu) << 6) | (text[i + 1] & 0x3Fu);
    } else {
      cp = ((c & 0x0Fu) << 12) | ((text[i + 1] & 0x3Fu) << 6) |
           (text[i + 2] & 0x3Fu);
    }
    const uint8_t f = flags[cp];
    if (f == 0) {  // regular char: extend the current word
      if (wstart < 0) wstart = i;
      i += n;
      continue;
    }
    // boundary of some kind: flush the in-flight word first
    if (wstart >= 0) {
      total = wp_match(v, text + wstart, i - wstart, unk_id, out_ids, cap,
                       total, sub, cps, word_ids);
      if (total < 0) return -1;
      wstart = -1;
    }
    if (f & kDrop) {
      // Python's _clean REMOVES control/NUL/U+FFFD chars, splicing the
      // surrounding word halves together — not representable as input
      // spans here; signal the caller to take the Python path
      return -2;
    }
    if (f & (kCjk | kPunct)) {  // single-char word
      total = wp_match(v, text + i, n, unk_id, out_ids, cap, total, sub, cps,
                       word_ids);
      if (total < 0) return -1;
    }
    // kWs: boundary only
    i += n;
  }
  if (wstart >= 0) {
    total = wp_match(v, text + wstart, len - wstart, unk_id, out_ids, cap,
                     total, sub, cps, word_ids);
  }
  return total;
}

}  // extern "C"

extern "C" {

// Batched drin_bert_encode: `n_texts` texts concatenated in `buf` (text t
// spanning bytes [offsets[t], offsets[t+1])), one foreign call for e.g. all
// B*C candidate strings of a batch (per-call overhead dominates short
// texts).  Per-text cumulative id counts land in `out_ends`; a text the
// span representation can't express (control/NUL/U+FFFD, see
// drin_bert_encode) gets out_ends[t] = -1 and contributes no ids — the
// caller re-encodes just that text in Python.  Returns the total id count
// or -1 if `cap` is too small.
int64_t drin_bert_encode_batch(void* h, const uint8_t* flags, const char* buf,
                               const int64_t* offsets, int64_t n_texts,
                               int32_t unk_id, int32_t* out_ids, int64_t cap,
                               int64_t* out_ends) {
  int64_t total = 0;
  for (int64_t t = 0; t < n_texts; ++t) {
    const int64_t r =
        drin_bert_encode(h, flags, buf + offsets[t], offsets[t + 1] - offsets[t],
                         unk_id, out_ids + total, cap - total);
    if (r == -1) return -1;
    if (r == -2) {
      out_ends[t] = -1;
      continue;
    }
    total += r;
    out_ends[t] = total;
  }
  return total;
}

}  // extern "C"
