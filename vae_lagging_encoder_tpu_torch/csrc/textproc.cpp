// Native host-side text reader of vae_lagging_encoder_tpu_torch.
//
// The port's own copy of the JAX package's csrc/textproc.cpp: corpus
// tokenization, vocabulary counting and id-encoding in one pass over a
// buffered file with hash maps, in place of per-token Python dict lookups
// (the startup cost of a Yahoo-sized corpus: ~100k sentences x ~80 tokens).
// Plain C ABI, loaded with ctypes by data/native.py, which builds it with
// g++ at first use; the pure-Python reader of data/text.py is its plain
// version and computes the same vocabulary and ids.
//
// ABI (bytes are UTF-8; tokens split on ASCII whitespace):
//   tp_count_vocab(path, label_mode, /*out*/ TpVocabCounts*) -> int status
//   tp_encode_corpus(path, label_mode, vocab_words, vocab_len, unk_id,
//                    first_id, /*out*/ TpEncoded*) -> int status
//   tp_free_counts / tp_free_encoded
#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

// Read a whole file into memory (corpora are tens of MB).
bool read_file(const char* path, std::string* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long n = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  out->resize(static_cast<size_t>(n));
  size_t got = n ? std::fread(&(*out)[0], 1, static_cast<size_t>(n), f) : 0;
  std::fclose(f);
  return got == static_cast<size_t>(n);
}

inline bool is_space(char c) {
  // ASCII whitespace only (data/vocab.py::_ws_split keeps the same set).
  return c == ' ' || c == '\t' || c == '\r' || c == '\n' || c == '\v' ||
         c == '\f';
}

// Iterate sentences: for label_mode, a leading "<label>\t" is stripped and
// parsed strtol-style (as data/text.py::MonoTextData._read does).
template <typename SentFn>
void for_each_sentence(const std::string& buf, bool label_mode, SentFn fn) {
  size_t pos = 0, n = buf.size();
  while (pos < n) {
    size_t eol = buf.find('\n', pos);
    if (eol == std::string::npos) eol = n;
    size_t start = pos, end = eol;
    long label = -1;
    if (label_mode) {
      size_t tab = buf.find('\t', start);
      if (tab != std::string::npos && tab < end) {
        label = std::strtol(buf.c_str() + start, nullptr, 10);
        start = tab + 1;
      }
    }
    fn(buf.data() + start, end - start, label);
    pos = eol + 1;
  }
}

struct string_view_hash {
  size_t operator()(const std::string& s) const {
    return std::hash<std::string>()(s);
  }
};

}  // namespace

extern "C" {

struct TpVocabCounts {
  // parallel arrays: words as one '\n'-joined blob + counts
  char* words_blob;      // owned; free via tp_free_counts
  int64_t words_blob_len;
  int64_t* counts;       // owned
  int64_t num_words;
  int64_t num_sentences;
  int64_t num_tokens;
};

struct TpEncoded {
  // CSR-style: ids[offsets[i] : offsets[i+1]] is sentence i (w/o specials)
  int32_t* ids;          // owned
  int64_t* offsets;      // owned; length num_sentences + 1
  int64_t* labels;       // owned; length num_sentences (-1 if absent)
  int64_t num_sentences;
  int64_t num_ids;
};

int tp_count_vocab(const char* path, int label_mode, TpVocabCounts* out) {
  std::string buf;
  if (!read_file(path, &buf)) return 1;
  std::unordered_map<std::string, int64_t> counts;
  counts.reserve(1 << 16);
  int64_t n_sents = 0, n_toks = 0;
  for_each_sentence(buf, label_mode != 0,
                    [&](const char* s, size_t len, long) {
    bool any = false;
    size_t i = 0;
    while (i < len) {
      while (i < len && is_space(s[i])) ++i;
      size_t w0 = i;
      while (i < len && !is_space(s[i])) ++i;
      if (i > w0) {
        ++counts[std::string(s + w0, i - w0)];
        ++n_toks;
        any = true;
      }
    }
    if (any) ++n_sents;
  });

  // deterministic order mirrors Vocab.from_corpus: count desc, then lexicographic
  std::vector<std::pair<std::string, int64_t>> items(counts.begin(),
                                                     counts.end());
  std::sort(items.begin(), items.end(), [](const auto& a, const auto& b) {
    if (a.second != b.second) return a.second > b.second;
    return a.first < b.first;
  });

  size_t blob_len = 0;
  for (auto& kv : items) blob_len += kv.first.size() + 1;
  out->words_blob = static_cast<char*>(std::malloc(blob_len ? blob_len : 1));
  out->counts = static_cast<int64_t*>(
      std::malloc(sizeof(int64_t) * (items.size() ? items.size() : 1)));
  if (!out->words_blob || !out->counts) return 2;
  size_t off = 0;
  for (size_t k = 0; k < items.size(); ++k) {
    std::memcpy(out->words_blob + off, items[k].first.data(),
                items[k].first.size());
    off += items[k].first.size();
    out->words_blob[off++] = '\n';
    out->counts[k] = items[k].second;
  }
  out->words_blob_len = static_cast<int64_t>(off);
  out->num_words = static_cast<int64_t>(items.size());
  out->num_sentences = n_sents;
  out->num_tokens = n_toks;
  return 0;
}

int tp_encode_corpus(const char* path, int label_mode,
                     const char* vocab_blob, int64_t vocab_blob_len,
                     int32_t unk_id, int32_t first_id, TpEncoded* out) {
  // vocab_blob: '\n'-joined words, ids assigned first_id, first_id+1, ...
  std::string buf;
  if (!read_file(path, &buf)) return 1;

  std::unordered_map<std::string, int32_t> word2id;
  word2id.reserve(1 << 16);
  {
    int32_t next = first_id;
    size_t pos = 0, n = static_cast<size_t>(vocab_blob_len);
    while (pos < n) {
      const char* p = static_cast<const char*>(
          std::memchr(vocab_blob + pos, '\n', n - pos));
      size_t eol = p ? static_cast<size_t>(p - vocab_blob) : n;
      if (eol > pos)
        word2id.emplace(std::string(vocab_blob + pos, eol - pos), next);
      ++next;
      pos = eol + 1;
    }
  }

  std::vector<int32_t> ids;
  std::vector<int64_t> offsets{0};
  std::vector<int64_t> labels;
  ids.reserve(buf.size() / 5);
  for_each_sentence(buf, label_mode != 0,
                    [&](const char* s, size_t len, long label) {
    bool any = false;
    size_t i = 0;
    while (i < len) {
      while (i < len && is_space(s[i])) ++i;
      size_t w0 = i;
      while (i < len && !is_space(s[i])) ++i;
      if (i > w0) {
        auto it = word2id.find(std::string(s + w0, i - w0));
        ids.push_back(it == word2id.end() ? unk_id : it->second);
        any = true;
      }
    }
    if (any) {
      offsets.push_back(static_cast<int64_t>(ids.size()));
      labels.push_back(label);
    }
  });

  out->num_sentences = static_cast<int64_t>(offsets.size()) - 1;
  out->num_ids = static_cast<int64_t>(ids.size());
  out->ids = static_cast<int32_t*>(
      std::malloc(sizeof(int32_t) * (ids.size() ? ids.size() : 1)));
  out->offsets = static_cast<int64_t*>(
      std::malloc(sizeof(int64_t) * offsets.size()));
  out->labels = static_cast<int64_t*>(
      std::malloc(sizeof(int64_t) * (labels.size() ? labels.size() : 1)));
  if (!out->ids || !out->offsets || !out->labels) return 2;
  std::memcpy(out->ids, ids.data(), sizeof(int32_t) * ids.size());
  std::memcpy(out->offsets, offsets.data(), sizeof(int64_t) * offsets.size());
  std::memcpy(out->labels, labels.data(), sizeof(int64_t) * labels.size());
  return 0;
}

void tp_free_counts(TpVocabCounts* c) {
  std::free(c->words_blob);
  std::free(c->counts);
  c->words_blob = nullptr;
  c->counts = nullptr;
}

void tp_free_encoded(TpEncoded* e) {
  std::free(e->ids);
  std::free(e->offsets);
  std::free(e->labels);
  e->ids = nullptr;
  e->offsets = nullptr;
  e->labels = nullptr;
}

}  // extern "C"
