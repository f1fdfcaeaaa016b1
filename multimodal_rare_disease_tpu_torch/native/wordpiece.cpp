// Fast WordPiece tokenizer (C++), the host-side fast path of
// data/tokenizer.py's BertWordPieceTokenizer (a copy of the JAX package's
// native/wordpiece.cpp; host code, not a device kernel).
//
// The Python implementation is the reference semantics; this core is
// byte-exact with it for ASCII text; the tokenizer routes any
// non-ASCII batch to the Python path. Built by native/__init__.py.
//
// Exposed C ABI:
//   wp_create(vocab_blob, n_bytes)        -> handle (vocab: tokens \n-joined, id = line index)
//   wp_destroy(handle)
//   wp_encode(handle, text, max_len, lower, out_ids, out_mask) -> n_tokens
//   wp_encode_batch(handle, texts_blob, offsets, n_texts, max_len, lower,
//                   out_ids, out_mask)    (outputs [n_texts, max_len] row-major)

#include <cstdint>
#include <cstring>
#include <string>
#include <string_view>
#include <unordered_map>
#include <vector>

namespace {

struct Vocab {
  std::unordered_map<std::string, int32_t> map;
  int32_t pad_id = 0, unk_id = 1, cls_id = 2, sep_id = 3;
  int32_t max_word_chars = 100;
};

inline bool is_ascii_space(unsigned char c) {
  return c == ' ' || c == '\t' || c == '\n' || c == '\r' || c == '\f' ||
         c == '\v';
}

inline bool is_ascii_punct(unsigned char c) {
  return (c >= 33 && c <= 47) || (c >= 58 && c <= 64) ||
         (c >= 91 && c <= 96) || (c >= 123 && c <= 126);
}

inline bool is_control(unsigned char c) { return c < 32 && !is_ascii_space(c); }

// greedy longest-match-first wordpiece over one word [start, end)
void wordpiece(const Vocab& v, std::string_view word,
               std::vector<int32_t>& out) {
  if ((int32_t)word.size() > v.max_word_chars) {
    out.push_back(v.unk_id);
    return;
  }
  size_t start = 0;
  std::string buf;
  std::vector<int32_t> pieces;
  while (start < word.size()) {
    size_t end = word.size();
    int32_t cur = -1;
    size_t cur_end = start;
    while (start < end) {
      buf.clear();
      if (start > 0) buf += "##";
      buf.append(word.data() + start, end - start);
      auto it = v.map.find(buf);
      if (it != v.map.end()) {
        cur = it->second;
        cur_end = end;
        break;
      }
      // back off one UTF-8 codepoint
      do {
        --end;
      } while (end > start && (word[end] & 0xC0) == 0x80);
    }
    if (cur < 0) {
      out.push_back(v.unk_id);
      return;
    }
    pieces.push_back(cur);
    start = cur_end;
  }
  for (int32_t p : pieces) out.push_back(p);
}

// basic tokenize (ASCII whitespace/punct split; optional ASCII lowercase)
// + wordpiece, appending ids to out.
void tokenize(const Vocab& v, std::string_view text, bool lower,
              std::vector<int32_t>& out) {
  std::string word;
  auto flush_word = [&]() {
    if (!word.empty()) {
      wordpiece(v, word, out);
      word.clear();
    }
  };
  for (size_t i = 0; i < text.size(); ++i) {
    unsigned char c = text[i];
    if (c == 0 || is_control(c)) continue;
    if (is_ascii_space(c)) {
      flush_word();
    } else if (c < 128 && is_ascii_punct(c)) {
      flush_word();
      char p[2] = {(char)c, 0};
      wordpiece(v, std::string_view(p, 1), out);
    } else {
      word += (char)(lower && c >= 'A' && c <= 'Z' ? c + 32 : c);
    }
  }
  flush_word();
}

}  // namespace

extern "C" {

void* wp_create(const char* vocab_blob, int64_t n_bytes) {
  auto* v = new Vocab();
  int32_t id = 0;
  const char* p = vocab_blob;
  const char* endp = vocab_blob + n_bytes;
  while (p < endp) {
    const char* nl = (const char*)memchr(p, '\n', endp - p);
    size_t len = nl ? (size_t)(nl - p) : (size_t)(endp - p);
    if (len > 0) {
      std::string tok(p, len);
      v->map.emplace(tok, id);
      if (tok == "[PAD]") v->pad_id = id;
      else if (tok == "[UNK]") v->unk_id = id;
      else if (tok == "[CLS]") v->cls_id = id;
      else if (tok == "[SEP]") v->sep_id = id;
    }
    ++id;
    if (!nl) break;
    p = nl + 1;
  }
  return v;
}

void wp_destroy(void* handle) { delete (Vocab*)handle; }

int32_t wp_encode(void* handle, const char* text, int64_t text_len,
                  int32_t max_len, int32_t lower, int32_t* out_ids,
                  int32_t* out_mask) {
  const Vocab& v = *(const Vocab*)handle;
  std::vector<int32_t> ids;
  ids.reserve(max_len);
  tokenize(v, std::string_view(text, text_len), lower != 0, ids);
  if ((int32_t)ids.size() > max_len - 2) ids.resize(max_len - 2);
  int32_t n = (int32_t)ids.size() + 2;
  out_ids[0] = v.cls_id;
  for (size_t i = 0; i < ids.size(); ++i) out_ids[i + 1] = ids[i];
  out_ids[n - 1] = v.sep_id;
  for (int32_t i = n; i < max_len; ++i) out_ids[i] = v.pad_id;
  for (int32_t i = 0; i < max_len; ++i) out_mask[i] = i < n ? 1 : 0;
  return n;
}

void wp_encode_batch(void* handle, const char* texts_blob,
                     const int64_t* offsets, int32_t n_texts, int32_t max_len,
                     int32_t lower, int32_t* out_ids, int32_t* out_mask) {
  for (int32_t i = 0; i < n_texts; ++i) {
    wp_encode(handle, texts_blob + offsets[i], offsets[i + 1] - offsets[i],
              max_len, lower, out_ids + (int64_t)i * max_len,
              out_mask + (int64_t)i * max_len);
  }
}

}  // extern "C"
