// Byte-level BPE merge loop of the CLIP tokenizer, for the host.
//
// Copy of native/bpe_tokenizer.cpp (the JAX package's), with the special
// tokens: the Python tokenizer (transforms/clip_transform.py) maps a
// pre-token equal to <|startoftext|> or <|endoftext|> to its own id
// without merging, and so does this loop, whose cache bpe_create seeds
// with them. It runs the merge loop of CLIPBPETokenizer._merge_word
// (greedy lowest-rank adjacent merge, every occurrence of the pair at once)
// and the vocab lookup for one byte-mapped pre-token a call, behind a C ABI
// loaded with ctypes (multimodal_tpu_torch/native/bpe.py); pre-tokenization
// stays in Python.
//
// Build: g++ -O2 -shared -fPIC (multimodal_tpu_torch/native/_build.py).

#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct PairHash {
  size_t operator()(const std::pair<std::string, std::string>& p) const {
    std::hash<std::string> h;
    return h(p.first) * 1000003 ^ h(p.second);
  }
};

struct Tokenizer {
  std::unordered_map<std::pair<std::string, std::string>, int, PairHash> ranks;
  std::unordered_map<std::string, int> vocab;
  std::unordered_map<std::string, std::vector<int>> cache;
};

std::vector<std::string> split_utf8(const std::string& word) {
  // split a byte-mapped word into unicode codepoint strings
  std::vector<std::string> out;
  size_t i = 0;
  while (i < word.size()) {
    unsigned char c = word[i];
    size_t len = 1;
    if ((c & 0x80) == 0x00) len = 1;
    else if ((c & 0xE0) == 0xC0) len = 2;
    else if ((c & 0xF0) == 0xE0) len = 3;
    else if ((c & 0xF8) == 0xF0) len = 4;
    out.push_back(word.substr(i, len));
    i += len;
  }
  return out;
}

}  // namespace

extern "C" {

// Create a tokenizer. merges: "first second\n" lines; vocab: "token\n" lines
// in index order; specials: "token\n" lines, each encoded as its own id.
void* bpe_create(const char* merges, const char* vocab_tokens,
                 const char* specials) {
  auto* tok = new Tokenizer();
  {
    std::string s(merges);
    size_t pos = 0;
    int rank = 0;
    while (pos < s.size()) {
      size_t end = s.find('\n', pos);
      if (end == std::string::npos) end = s.size();
      std::string line = s.substr(pos, end - pos);
      pos = end + 1;
      if (line.empty()) continue;
      size_t sp = line.find(' ');
      if (sp == std::string::npos) continue;
      tok->ranks[{line.substr(0, sp), line.substr(sp + 1)}] = rank++;
    }
  }
  {
    std::string s(vocab_tokens);
    size_t pos = 0;
    int idx = 0;
    while (pos < s.size()) {
      size_t end = s.find('\n', pos);
      if (end == std::string::npos) end = s.size();
      std::string t = s.substr(pos, end - pos);
      pos = end + 1;
      if (!t.empty()) tok->vocab[t] = idx;
      idx++;
    }
  }
  {
    std::string s(specials);
    size_t pos = 0;
    while (pos < s.size()) {
      size_t end = s.find('\n', pos);
      if (end == std::string::npos) end = s.size();
      std::string t = s.substr(pos, end - pos);
      pos = end + 1;
      auto it = tok->vocab.find(t);
      if (!t.empty() && it != tok->vocab.end()) tok->cache[t] = {it->second};
    }
  }
  return tok;
}

void bpe_destroy(void* handle) { delete static_cast<Tokenizer*>(handle); }

// Encode one byte-mapped pre-token (utf-8 string of mapped byte chars).
// Writes up to max_out ids; returns the count, -1 for a symbol outside the
// vocab, -2 when the ids do not fit max_out.
int bpe_encode_word(void* handle, const char* word_c, int32_t* out,
                    int max_out) {
  auto* tok = static_cast<Tokenizer*>(handle);
  std::string word(word_c);

  auto cached = tok->cache.find(word);
  if (cached != tok->cache.end()) {
    int n = (int)cached->second.size();
    if (n > max_out) return -2;
    std::memcpy(out, cached->second.data(), n * sizeof(int32_t));
    return n;
  }

  std::vector<std::string> symbols = split_utf8(word);
  if (symbols.empty()) return 0;
  symbols.back() += "</w>";

  // greedy lowest-rank adjacent merge
  while (symbols.size() > 1) {
    int best_rank = -1;
    size_t best_i = 0;
    for (size_t i = 0; i + 1 < symbols.size(); ++i) {
      auto it = tok->ranks.find({symbols[i], symbols[i + 1]});
      if (it != tok->ranks.end() &&
          (best_rank < 0 || it->second < best_rank)) {
        best_rank = it->second;
        best_i = i;
      }
    }
    if (best_rank < 0) break;
    const std::string first = symbols[best_i];
    const std::string second = symbols[best_i + 1];
    std::vector<std::string> merged;
    merged.reserve(symbols.size());
    for (size_t i = 0; i < symbols.size();) {
      if (i + 1 < symbols.size() && symbols[i] == first &&
          symbols[i + 1] == second) {
        merged.push_back(first + second);
        i += 2;
      } else {
        merged.push_back(symbols[i]);
        i += 1;
      }
    }
    symbols.swap(merged);
  }

  std::vector<int> ids;
  ids.reserve(symbols.size());
  for (const auto& s : symbols) {
    auto it = tok->vocab.find(s);
    if (it == tok->vocab.end()) return -1;
    ids.push_back(it->second);
  }
  if ((int)ids.size() > max_out) return -2;
  std::memcpy(out, ids.data(), ids.size() * sizeof(int32_t));
  tok->cache[word] = ids;
  return (int)ids.size();
}

}  // extern "C"
