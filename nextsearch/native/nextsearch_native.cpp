// nextsearch_native: C++17 acceleration for the host-side index runtime.
//
// The device compute path is JAX/XLA (ops/); this library natively implements
// the CPU-bound build/runtime pieces the reference implements in C++:
//   - tokenizer + stoplist + tf counting (reference: include/textutil.hpp)
//   - forward-index builder: intern terms, accumulate (doc, term, tf)
//     postings, invert to a lexicographically sorted-term CSR — the same
//     canonical layout as nextsearch.index.builder.build_segment_arrays
//   - metadata.csv offset scanner (reference: src/api_metadata.cpp:109-185)
//
// Exposed as a plain C ABI consumed through ctypes (native/__init__.py);
// byte-exact parity with the Python implementations is enforced by
// tests/test_native.py.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <string>
#include <string_view>
#include <unordered_map>
#include <vector>

namespace {

inline bool is_alnum_ascii(unsigned char c) {
  return (c >= '0' && c <= '9') || (c >= 'A' && c <= 'Z') ||
         (c >= 'a' && c <= 'z');
}

inline char lower_ascii(unsigned char c) {
  return (c >= 'A' && c <= 'Z') ? static_cast<char>(c + 32)
                                : static_cast<char>(c);
}

// The reference's 24-word stoplist (include/textutil.hpp:32-35).
bool is_stopword(std::string_view t) {
  switch (t.size()) {
    case 2:
      return t == "an" || t == "or" || t == "of" || t == "to" || t == "in" ||
             t == "on" || t == "by" || t == "as" || t == "is" || t == "be" ||
             t == "it" || t == "at";
    case 3:
      return t == "the" || t == "and" || t == "for" || t == "was" ||
             t == "are";
    case 4:
      return t == "with" || t == "were" || t == "been" || t == "this" ||
             t == "that" || t == "from";
    default:
      return false;  // "a" (len 1) is dropped by the len<2 filter anyway
  }
}

struct Builder {
  // term interning (first-encounter legacy ids)
  std::unordered_map<std::string, uint32_t> term_to_legacy;
  std::vector<std::string> legacy_terms;
  // flat postings in (doc-major, first-encounter order within doc)
  std::vector<uint32_t> post_legacy_tid;
  std::vector<uint32_t> post_tf;
  std::vector<uint32_t> post_doc;
  std::vector<uint32_t> doc_len;
  uint64_t total_len = 0;

  // finalize products (sorted-term CSR)
  std::vector<uint32_t> sort_order;    // sorted idx -> legacy id
  std::vector<uint32_t> term_df;       // [T]
  std::vector<int64_t> term_offsets;   // [T+1]
  std::vector<int32_t> out_post_doc;   // [P]
  std::vector<int32_t> out_post_tf;    // [P]
  bool finalized = false;

  // scratch reused across docs
  std::unordered_map<uint32_t, uint32_t> tf_scratch;
  std::vector<std::pair<uint32_t, uint32_t>> doc_terms_scratch;
};

}  // namespace

extern "C" {

void* ns_builder_new() { return new Builder(); }

void ns_builder_free(void* h) { delete static_cast<Builder*>(h); }

// Tokenize `text`, apply the len>=2 + stoplist filter, intern terms, and
// append this document's postings. Returns doc_len (0 => doc skipped; the
// caller must not count it).
uint32_t ns_builder_add_doc(void* h, const char* text, uint64_t n) {
  Builder& b = *static_cast<Builder*>(h);
  auto& tf = b.tf_scratch;
  tf.clear();

  uint32_t dl = 0;
  const char* p = text;
  const char* end = text + n;
  std::string cur;
  cur.reserve(32);

  auto flush = [&]() {
    if (cur.size() >= 2 && !is_stopword(cur)) {
      uint32_t tid;
      auto it = b.term_to_legacy.find(cur);
      if (it == b.term_to_legacy.end()) {
        tid = static_cast<uint32_t>(b.legacy_terms.size());
        b.term_to_legacy.emplace(cur, tid);
        b.legacy_terms.push_back(cur);
      } else {
        tid = it->second;
      }
      tf[tid] += 1;
      dl += 1;
    }
    cur.clear();
  };

  for (; p != end; ++p) {
    unsigned char c = static_cast<unsigned char>(*p);
    if (is_alnum_ascii(c)) {
      cur.push_back(lower_ascii(c));
    } else if (!cur.empty()) {
      flush();
    }
  }
  if (!cur.empty()) flush();

  if (dl == 0) return 0;

  uint32_t doc_id = static_cast<uint32_t>(b.doc_len.size());
  b.doc_len.push_back(dl);
  b.total_len += dl;

  // Deterministic per-doc posting order: first-encounter id ascending.
  auto& terms = b.doc_terms_scratch;
  terms.assign(tf.begin(), tf.end());
  std::sort(terms.begin(), terms.end());
  for (auto& [tid, cnt] : terms) {
    b.post_legacy_tid.push_back(tid);
    b.post_tf.push_back(cnt);
    b.post_doc.push_back(doc_id);
  }
  return dl;
}

// Invert to the sorted-term CSR layout. Returns total postings P.
uint64_t ns_builder_finalize(void* h) {
  Builder& b = *static_cast<Builder*>(h);
  const uint32_t T = static_cast<uint32_t>(b.legacy_terms.size());
  const uint64_t P = b.post_legacy_tid.size();

  b.sort_order.resize(T);
  std::iota(b.sort_order.begin(), b.sort_order.end(), 0u);
  std::sort(b.sort_order.begin(), b.sort_order.end(),
            [&](uint32_t a, uint32_t c) {
              return b.legacy_terms[a] < b.legacy_terms[c];
            });
  std::vector<uint32_t> rank(T);
  for (uint32_t i = 0; i < T; ++i) rank[b.sort_order[i]] = i;

  b.term_df.assign(T, 0);
  for (uint64_t p = 0; p < P; ++p) b.term_df[rank[b.post_legacy_tid[p]]]++;

  b.term_offsets.assign(T + 1, 0);
  for (uint32_t t = 0; t < T; ++t)
    b.term_offsets[t + 1] = b.term_offsets[t] + b.term_df[t];

  // Counting-sort by term rank keeps ascending doc order within each term
  // (postings were appended doc-major).
  b.out_post_doc.resize(P);
  b.out_post_tf.resize(P);
  std::vector<int64_t> cursor(b.term_offsets.begin(), b.term_offsets.end() - 1);
  for (uint64_t p = 0; p < P; ++p) {
    uint32_t r = rank[b.post_legacy_tid[p]];
    int64_t dst = cursor[r]++;
    b.out_post_doc[dst] = static_cast<int32_t>(b.post_doc[p]);
    b.out_post_tf[dst] = static_cast<int32_t>(b.post_tf[p]);
  }
  b.finalized = true;
  return P;
}

uint32_t ns_builder_num_terms(void* h) {
  return static_cast<uint32_t>(static_cast<Builder*>(h)->legacy_terms.size());
}

uint32_t ns_builder_num_docs(void* h) {
  return static_cast<uint32_t>(static_cast<Builder*>(h)->doc_len.size());
}

uint64_t ns_builder_total_len(void* h) {
  return static_cast<Builder*>(h)->total_len;
}

// Total bytes of all term strings concatenated in SORTED order.
uint64_t ns_builder_terms_blob_size(void* h) {
  Builder& b = *static_cast<Builder*>(h);
  uint64_t total = 0;
  for (const auto& t : b.legacy_terms) total += t.size();
  return total;
}

// Export everything into caller-allocated buffers (sorted-term layout):
//   terms_blob [terms_blob_size] — concatenated term bytes, sorted order
//   term_lens  [T] u32, legacy_ids [T] i32, term_df [T] i32,
//   term_offsets [T+1] i64, post_doc [P] i32, post_tf [P] i32,
//   doc_len [N] i32
void ns_builder_export(void* h, char* terms_blob, uint32_t* term_lens,
                       int32_t* legacy_ids, int32_t* term_df,
                       int64_t* term_offsets, int32_t* post_doc,
                       int32_t* post_tf, int32_t* doc_len_out) {
  Builder& b = *static_cast<Builder*>(h);
  const uint32_t T = static_cast<uint32_t>(b.legacy_terms.size());
  uint64_t blob_pos = 0;
  for (uint32_t i = 0; i < T; ++i) {
    const std::string& t = b.legacy_terms[b.sort_order[i]];
    std::memcpy(terms_blob + blob_pos, t.data(), t.size());
    blob_pos += t.size();
    term_lens[i] = static_cast<uint32_t>(t.size());
    legacy_ids[i] = static_cast<int32_t>(b.sort_order[i]);
    term_df[i] = static_cast<int32_t>(b.term_df[i]);
  }
  std::memcpy(term_offsets, b.term_offsets.data(),
              (T + 1) * sizeof(int64_t));
  std::memcpy(post_doc, b.out_post_doc.data(),
              b.out_post_doc.size() * sizeof(int32_t));
  std::memcpy(post_tf, b.out_post_tf.data(),
              b.out_post_tf.size() * sizeof(int32_t));
  std::memcpy(doc_len_out, b.doc_len.data(),
              b.doc_len.size() * sizeof(int32_t));
}

// ---------------------------------------------------------------------------
// Standalone tokenizer (tests/interop): writes tokens as
// [u32 len][bytes]... into out; returns number of tokens, or the required
// byte size if out_cap is too small (call with out=nullptr to size).
uint64_t ns_tokenize(const char* text, uint64_t n, char* out,
                     uint64_t out_cap, uint64_t* n_tokens) {
  uint64_t needed = 0;
  uint64_t count = 0;
  uint64_t pos = 0;
  std::string cur;
  cur.reserve(32);
  auto emit = [&]() {
    needed += 4 + cur.size();
    if (out && pos + 4 + cur.size() <= out_cap) {
      uint32_t len32 = static_cast<uint32_t>(cur.size());
      std::memcpy(out + pos, &len32, 4);
      std::memcpy(out + pos + 4, cur.data(), cur.size());
      pos += 4 + cur.size();
    }
    count++;
    cur.clear();
  };
  for (uint64_t i = 0; i < n; ++i) {
    unsigned char c = static_cast<unsigned char>(text[i]);
    if (is_alnum_ascii(c)) {
      cur.push_back(lower_ascii(c));
    } else if (!cur.empty()) {
      emit();
    }
  }
  if (!cur.empty()) emit();
  if (n_tokens) *n_tokens = count;
  return needed;
}

// ---------------------------------------------------------------------------
// metadata.csv offset scan (reference src/api_metadata.cpp:109-185): find the
// cord_uid column, then for each row record {offset, length, uid}. Output:
// offsets [cap] u64, lengths [cap] u32, uid blob [u32 len][bytes]...
// Returns number of rows recorded (first occurrence of each uid is NOT
// deduped here — Python keeps the first as the reference does).
uint64_t ns_scan_csv_offsets(const char* data, uint64_t n, uint64_t uid_col,
                             uint64_t* offsets, uint32_t* lengths,
                             char* uid_blob, uint64_t uid_blob_cap,
                             uint64_t* uid_blob_used, uint64_t cap) {
  uint64_t rows = 0;
  uint64_t blob = 0;
  // skip header
  uint64_t pos = 0;
  while (pos < n && data[pos] != '\n') pos++;
  if (pos < n) pos++;

  while (pos < n && rows < cap) {
    uint64_t line_start = pos;
    uint64_t eol = pos;
    while (eol < n && data[eol] != '\n') eol++;
    uint64_t line_len = (eol - line_start) + 1;

    // walk columns with quote toggling to find uid_col
    bool inq = false;
    uint64_t col = 0;
    uint64_t uid_start = line_start;
    uint64_t uid_end = eol;  // exclusive, before quote stripping
    bool found = (uid_col == 0);
    std::string uid;
    for (uint64_t i = line_start; i < eol; ++i) {
      char c = data[i];
      if (c == '"') {
        inq = !inq;
        continue;
      }
      if (!inq && c == ',') {
        if (col == uid_col) {
          uid_end = i;
          break;
        }
        col++;
        if (col == uid_col) {
          uid_start = i + 1;
          found = true;
        }
      }
    }
    if (found && col >= uid_col) {
      // rebuild the field with quotes removed (csv_row semantics)
      uid.clear();
      bool q = false;
      for (uint64_t i = uid_start; i < uid_end; ++i) {
        char c = data[i];
        if (c == '"') {
          q = !q;
          continue;
        }
        uid.push_back(c);
      }
      if (!uid.empty() && blob + 4 + uid.size() <= uid_blob_cap) {
        offsets[rows] = line_start;
        lengths[rows] = static_cast<uint32_t>(line_len);
        uint32_t len32 = static_cast<uint32_t>(uid.size());
        std::memcpy(uid_blob + blob, &len32, 4);
        std::memcpy(uid_blob + blob + 4, uid.data(), uid.size());
        blob += 4 + uid.size();
        rows++;
      }
    }
    pos = eol + 1;
  }
  if (uid_blob_used) *uid_blob_used = blob;
  return rows;
}

}  // extern "C"
