// WordPiece tokenizer loop for the host.
//
// Copy of native/wordpiece_tokenizer.cpp (the JAX package's): greedy
// longest-match-first subword segmentation over a vocab loaded once, and a
// whole ASCII text split on \w+|[^\w\s] in one call, behind a C ABI loaded
// with ctypes (multimodal_tpu_torch/native/wordpiece.py). The Python
// WordPieceTokenizer (examples/mugen/bert_text_transform.py) is its plain
// version. Three departures from the copy, each to give the Python ids:
// a repeated vocab line keeps its last index (a Python dict's), whitespace
// is str.isspace()'s (Python's \s, U+001C-U+001F included), and the text
// comes with its length, so a NUL byte is a character like another.
//
// Build: g++ -O2 -shared -fPIC (multimodal_tpu_torch/native/_build.py).

#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct WordPiece {
  std::unordered_map<std::string, int32_t> vocab;
  int32_t unk_id = 0;
  int max_chars_per_word = 100;
};

}  // namespace

extern "C" {

// vocab_blob: '\n'-separated tokens, id = line index.
void* wp_create(const char* vocab_blob, const char* unk_token,
                int max_chars_per_word) {
  auto* wp = new WordPiece();
  wp->max_chars_per_word = max_chars_per_word;
  std::string blob(vocab_blob);
  size_t start = 0;
  int32_t id = 0;
  while (start <= blob.size()) {
    size_t nl = blob.find('\n', start);
    if (nl == std::string::npos) nl = blob.size();
    std::string tok = blob.substr(start, nl - start);
    if (!tok.empty()) wp->vocab[tok] = id;
    ++id;
    start = nl + 1;
    if (nl == blob.size()) break;
  }
  auto it = wp->vocab.find(unk_token);
  wp->unk_id = it == wp->vocab.end() ? 0 : it->second;
  return wp;
}

void wp_destroy(void* handle) { delete static_cast<WordPiece*>(handle); }

}  // extern "C"

namespace {

// Internal segmentation of one word into `ids`; returns false on UNK-collapse
// (caller should emit a single unk id).
bool segment_word(const WordPiece* wp, const std::string& w,
                  std::vector<int32_t>* ids) {
  if ((int)w.size() > wp->max_chars_per_word) return false;
  size_t start = 0;
  size_t first = ids->size();
  while (start < w.size()) {
    size_t end = w.size();
    int32_t piece = -1;
    size_t piece_end = start;
    while (start < end) {
      std::string sub = w.substr(start, end - start);
      if (start > 0) sub = "##" + sub;
      auto it = wp->vocab.find(sub);
      if (it != wp->vocab.end()) {
        piece = it->second;
        piece_end = end;
        break;
      }
      --end;
    }
    if (piece < 0) {
      ids->resize(first);
      return false;
    }
    ids->push_back(piece);
    start = piece_end;
  }
  return true;
}

inline bool is_word_char(unsigned char c) {
  // ASCII \w: [A-Za-z0-9_]; callers send non-ASCII text down the Python
  // path, so Unicode classes never reach this one.
  return (c >= 'a' && c <= 'z') || (c >= 'A' && c <= 'Z') ||
         (c >= '0' && c <= '9') || c == '_';
}

inline bool is_space_char(unsigned char c) {
  // str.isspace() on ASCII: \t \n \v \f \r, U+001C-U+001F and the space
  return c == ' ' || (c >= '\t' && c <= '\r') || (c >= 0x1c && c <= 0x1f);
}

}  // namespace

extern "C" {

// Tokenize a FULL ASCII text in one call: lowercase, split on the
// \w+|[^\w\s] pattern, greedy-longest-match each word. One ctypes crossing
// per text (the per-word variant lost to Python on marshalling overhead).
// Returns number of ids written.
int wp_encode_text(void* handle, const char* text, int64_t len, int lowercase,
                   int32_t* out, int max_out) {
  auto* wp = static_cast<WordPiece*>(handle);
  std::vector<int32_t> ids;
  std::string word;
  const char* p = text;
  const char* stop = text + len;
  auto flush_word = [&]() {
    if (word.empty()) return;
    if (!segment_word(wp, word, &ids)) ids.push_back(wp->unk_id);
    word.clear();
  };
  for (; p < stop; ++p) {
    unsigned char c = (unsigned char)*p;
    if (lowercase && c >= 'A' && c <= 'Z') c = c - 'A' + 'a';
    if (is_word_char(c)) {
      word.push_back((char)c);
    } else {
      flush_word();
      if (!is_space_char(c)) {
        // single punctuation character token
        std::string punct(1, (char)c);
        if (!segment_word(wp, punct, &ids)) ids.push_back(wp->unk_id);
      }
    }
  }
  flush_word();
  int n = (int)ids.size();
  if (n > max_out) n = max_out;
  if (n > 0) std::memcpy(out, ids.data(), n * sizeof(int32_t));
  return n;
}

}  // extern "C"
