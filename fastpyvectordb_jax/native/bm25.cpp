// Native BM25 inverted index + tokenizer.
//
// The host-side text path is the one place the framework's Python is the
// bottleneck (the reference's BM25 is pure-Python dict crunching,
// hybrid_search.py:49-204; its only native code is the third-party hnswlib
// C++ index).  This module is the framework's first-party native runtime
// component: tokenization, postings maintenance, and BM25 scoring in C++,
// exposed through a plain C ABI consumed via ctypes
// (fastpyvectordb_jax/native/__init__.py).
//
// Build: g++ -O3 -std=c++17 -shared -fPIC bm25.cpp -o libfvdb_native.so

#include <algorithm>
#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <memory>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Posting {
    // doc id -> term frequency
    std::unordered_map<uint32_t, uint32_t> tf;
};

struct BM25Index {
    double k1 = 1.5;
    double b = 0.75;
    std::unordered_map<std::string, Posting> postings;
    std::unordered_map<uint32_t, uint32_t> doc_len;
    uint64_t total_len = 0;

    double avg_doc_len() const {
        return doc_len.empty() ? 0.0
                               : static_cast<double>(total_len) / doc_len.size();
    }

    double idf(const Posting& p) const {
        double df = static_cast<double>(p.tf.size());
        double n = static_cast<double>(doc_len.size());
        return std::log((n - df + 0.5) / (df + 0.5) + 1.0);
    }
};

void tokenize(const char* text, std::vector<std::string>& out) {
    out.clear();
    std::string cur;
    for (const unsigned char* p = reinterpret_cast<const unsigned char*>(text);
         *p; ++p) {
        unsigned char c = *p;
        // \w equivalent for ASCII; non-ASCII bytes are treated as word chars
        // so UTF-8 words survive intact (Python's \w matches them too).
        if (std::isalnum(c) || c == '_' || c >= 0x80) {
            cur.push_back(static_cast<char>(std::tolower(c)));
        } else if (!cur.empty()) {
            out.push_back(cur);
            cur.clear();
        }
    }
    if (!cur.empty()) out.push_back(cur);
}

}  // namespace

extern "C" {

void* bm25_create(double k1, double b) {
    auto* idx = new BM25Index();
    idx->k1 = k1;
    idx->b = b;
    return idx;
}

void bm25_destroy(void* h) { delete static_cast<BM25Index*>(h); }

int bm25_remove_document(void* h, uint32_t doc_id);

void bm25_add_document(void* h, uint32_t doc_id, const char* text) {
    auto* idx = static_cast<BM25Index*>(h);
    // replace semantics: drop the old version first (one scrub
    // implementation — a duplicated loop here drifted from remove's)
    bm25_remove_document(h, doc_id);
    std::vector<std::string> toks;
    tokenize(text, toks);
    idx->doc_len[doc_id] = static_cast<uint32_t>(toks.size());
    idx->total_len += toks.size();
    for (const auto& t : toks) idx->postings[t].tf[doc_id] += 1;
}

int bm25_remove_document(void* h, uint32_t doc_id) {
    auto* idx = static_cast<BM25Index*>(h);
    auto it = idx->doc_len.find(doc_id);
    if (it == idx->doc_len.end()) return 0;
    idx->total_len -= it->second;
    idx->doc_len.erase(it);
    for (auto pit = idx->postings.begin(); pit != idx->postings.end();) {
        pit->second.tf.erase(doc_id);
        if (pit->second.tf.empty())
            pit = idx->postings.erase(pit);
        else
            ++pit;
    }
    return 1;
}

uint64_t bm25_n_docs(void* h) {
    return static_cast<BM25Index*>(h)->doc_len.size();
}

uint64_t bm25_n_terms(void* h) {
    return static_cast<BM25Index*>(h)->postings.size();
}

double bm25_avg_doc_len(void* h) {
    return static_cast<BM25Index*>(h)->avg_doc_len();
}

double bm25_idf(void* h, const char* term) {
    auto* idx = static_cast<BM25Index*>(h);
    auto it = idx->postings.find(term);
    if (it == idx->postings.end()) return 0.0;
    return idx->idf(it->second);
}

double bm25_score(void* h, const char* query, uint32_t doc_id) {
    auto* idx = static_cast<BM25Index*>(h);
    auto dit = idx->doc_len.find(doc_id);
    if (dit == idx->doc_len.end()) return 0.0;
    std::vector<std::string> toks;
    tokenize(query, toks);
    double avgdl = std::max(idx->avg_doc_len(), 1e-9);
    double norm = idx->k1 * (1.0 - idx->b + idx->b * dit->second / avgdl);
    double s = 0.0;
    for (const auto& t : toks) {
        auto it = idx->postings.find(t);
        if (it == idx->postings.end()) continue;
        auto tfit = it->second.tf.find(doc_id);
        if (tfit == it->second.tf.end()) continue;
        double tf = tfit->second;
        s += idx->idf(it->second) * tf * (idx->k1 + 1.0) / (tf + norm);
    }
    return s;
}

// Top-k search: writes up to k (doc_id, score) pairs; returns the count.
int bm25_search(void* h, const char* query, int k, uint32_t* out_ids,
                double* out_scores) {
    auto* idx = static_cast<BM25Index*>(h);
    std::vector<std::string> toks;
    tokenize(query, toks);
    std::sort(toks.begin(), toks.end());
    toks.erase(std::unique(toks.begin(), toks.end()), toks.end());

    double avgdl = std::max(idx->avg_doc_len(), 1e-9);
    std::unordered_map<uint32_t, double> scores;
    for (const auto& t : toks) {
        auto it = idx->postings.find(t);
        if (it == idx->postings.end()) continue;
        double idf = idx->idf(it->second);
        for (const auto& [doc, tf] : it->second.tf) {
            double norm = idx->k1 *
                (1.0 - idx->b + idx->b * idx->doc_len[doc] / avgdl);
            scores[doc] += idf * tf * (idx->k1 + 1.0) / (tf + norm);
        }
    }
    std::vector<std::pair<uint32_t, double>> ranked(scores.begin(),
                                                    scores.end());
    int kk = std::min<int>(k, static_cast<int>(ranked.size()));
    std::partial_sort(
        ranked.begin(), ranked.begin() + kk, ranked.end(),
        [](const auto& a, const auto& b) {
            if (a.second != b.second) return a.second > b.second;
            return a.first < b.first;  // deterministic tie-break
        });
    for (int i = 0; i < kk; ++i) {
        out_ids[i] = ranked[i].first;
        out_scores[i] = ranked[i].second;
    }
    return kk;
}

}  // extern "C"

// ---------------------------------------------------------------------
// Binary state export/import (postings + doc lengths), so a persisted
// index reloads WITHOUT re-tokenizing the corpus.  Layout (little-endian):
//   u8[8]                     magic "FVBM25\0" + version byte 1
//   u64 n_docs, u64 n_terms, u64 total_len
//   n_docs  x (u32 doc_handle, u32 doc_len)
//   n_terms x (u32 term_len, term bytes,
//              u32 df, df x (u32 doc_handle, u32 tf))
// ---------------------------------------------------------------------

namespace {

const char kMagic[8] = {'F', 'V', 'B', 'M', '2', '5', '\0', 1};

template <typename T>
void put(std::string& out, T v) {
    out.append(reinterpret_cast<const char*>(&v), sizeof(T));
}

template <typename T>
bool get(const char*& p, const char* end, T* v) {
    if (p + sizeof(T) > end) return false;
    std::memcpy(v, p, sizeof(T));
    p += sizeof(T);
    return true;
}

std::string export_state(const BM25Index& idx) {
    std::string out;
    out.append(kMagic, 8);
    put<uint64_t>(out, idx.doc_len.size());
    put<uint64_t>(out, idx.postings.size());
    put<uint64_t>(out, idx.total_len);
    for (const auto& [doc, len] : idx.doc_len) {
        put<uint32_t>(out, doc);
        put<uint32_t>(out, len);
    }
    for (const auto& [term, p] : idx.postings) {
        put<uint32_t>(out, static_cast<uint32_t>(term.size()));
        out.append(term);
        put<uint32_t>(out, static_cast<uint32_t>(p.tf.size()));
        for (const auto& [doc, tf] : p.tf) {
            put<uint32_t>(out, doc);
            put<uint32_t>(out, tf);
        }
    }
    return out;
}

}  // namespace

extern "C" {

int64_t bm25_export_size(void* h) {
    return static_cast<int64_t>(
        export_state(*static_cast<BM25Index*>(h)).size());
}

// Writes the serialized state into buf (capacity cap); returns bytes
// written, or -1 if the buffer is too small.
int64_t bm25_export(void* h, char* buf, int64_t cap) {
    std::string s = export_state(*static_cast<BM25Index*>(h));
    if (static_cast<int64_t>(s.size()) > cap) return -1;
    std::memcpy(buf, s.data(), s.size());
    return static_cast<int64_t>(s.size());
}

// Returns a new index handle, or nullptr on a malformed buffer.
void* bm25_import(double k1, double b, const char* buf, int64_t len) {
    const char* p = buf;
    const char* end = buf + len;
    if (len < 8 || std::memcmp(p, kMagic, 8) != 0) return nullptr;
    p += 8;
    uint64_t n_docs, n_terms, total_len;
    if (!get(p, end, &n_docs) || !get(p, end, &n_terms) ||
        !get(p, end, &total_len))
        return nullptr;
    auto idx = std::make_unique<BM25Index>();
    idx->k1 = k1;
    idx->b = b;
    idx->total_len = total_len;
    idx->doc_len.reserve(n_docs);
    for (uint64_t i = 0; i < n_docs; ++i) {
        uint32_t doc, dl;
        if (!get(p, end, &doc) || !get(p, end, &dl)) return nullptr;
        idx->doc_len[doc] = dl;
    }
    idx->postings.reserve(n_terms);
    for (uint64_t i = 0; i < n_terms; ++i) {
        uint32_t tlen;
        if (!get(p, end, &tlen) || p + tlen > end) return nullptr;
        std::string term(p, tlen);
        p += tlen;
        uint32_t df;
        if (!get(p, end, &df)) return nullptr;
        auto& posting = idx->postings[std::move(term)];
        posting.tf.reserve(df);
        for (uint32_t j = 0; j < df; ++j) {
            uint32_t doc, tf;
            if (!get(p, end, &doc) || !get(p, end, &tf)) return nullptr;
            posting.tf[doc] = tf;
        }
    }
    return idx.release();
}

}  // extern "C"

extern "C" {

// Tokenize into a NUL-joined buffer (for reuse of the native tokenizer from
// Python).  Returns number of tokens; writes at most buf_len bytes.
int bm25_tokenize(const char* text, char* buf, int buf_len) {
    std::vector<std::string> toks;
    tokenize(text, toks);
    int written = 0, count = 0;
    for (const auto& t : toks) {
        int need = static_cast<int>(t.size()) + 1;
        if (written + need > buf_len) break;
        std::memcpy(buf + written, t.c_str(), need);
        written += need;
        ++count;
    }
    return count;
}

}  // extern "C"
