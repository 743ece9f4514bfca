// Native BoW runtime: vocabulary tree descent + inverted-file keyframe
// database.
//
// Host-side C++ equivalent of the reference's DBoW2 TemplatedVocabulary +
// KeyFrameDatabase (ORB-SLAM3's src/KeyFrameDatabase.cc,
// include/CustomVocabulary.h) — the parts SURVEY.md §7 flags as "gather-heavy
// and branchy — candidate for host CPU": per-descriptor tree descent is a
// pointer chase, and the inverted file only touches keyframes sharing words
// with the query (vs the dense tf-idf matrix of models/vocabulary.py,
// which stays the oracle and the on-device option).
//
// Semantics contract (held by tests/test_torch_native_bow.py):
//   * descend: per level, argmin Hamming over the k children, first index
//     wins ties (as models/vocabulary.py);
//   * BoW vector: tf * idf over valid descriptors, L1-normalized;
//   * score: DBoW2 L1 similarity s = 1 - 0.5 |v - w|_1 = sum_common min(v,w)
//     for L1-normalized vectors, accumulated via the inverted file.
//
// Descriptors cross the boundary packed as 4x uint64 (256 bits).

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <vector>

namespace {

inline int hamming(const uint64_t* a, const uint64_t* b) {
    return __builtin_popcountll(a[0] ^ b[0]) +
           __builtin_popcountll(a[1] ^ b[1]) +
           __builtin_popcountll(a[2] ^ b[2]) +
           __builtin_popcountll(a[3] ^ b[3]);
}

struct Entry {
    int32_t kf;
    float w;
};

struct BowDB {
    int n_words;
    int max_kf;
    std::vector<float> idf;                     // (n_words)
    std::vector<std::vector<Entry>> inv;        // per-word posting lists
    std::vector<std::vector<std::pair<int32_t, float>>> kf_vec;  // per-kf sparse vec
    std::vector<uint8_t> active;
};

// Sparse L1-normalized tf-idf vector from word ids.
void make_vec(const BowDB& db, const int32_t* words, const uint8_t* valid,
              int n, std::vector<std::pair<int32_t, float>>& out) {
    std::vector<int32_t> w;
    w.reserve(n);
    for (int i = 0; i < n; i++)
        if (valid[i] && words[i] >= 0 && words[i] < db.n_words)
            w.push_back(words[i]);
    std::sort(w.begin(), w.end());
    out.clear();
    double total = 0.0;
    for (size_t i = 0; i < w.size();) {
        size_t j = i;
        while (j < w.size() && w[j] == w[i]) j++;
        float v = float(j - i) * db.idf[w[i]];
        out.emplace_back(w[i], v);
        total += v;
        i = j;
    }
    if (total > 1e-9) {
        for (auto& p : out) p.second = float(p.second / total);
    }
}

}  // namespace

extern "C" {

// levels: all centroid descriptors concatenated (4 u64 each);
// level_off[l]: start of level l in descriptor units.
void bow_descend(const uint64_t* levels, const int64_t* level_off,
                 int k, int depth, const uint64_t* desc, int n,
                 int32_t* out_words) {
    for (int i = 0; i < n; i++) {
        const uint64_t* d = desc + 4 * (int64_t)i;
        int node = 0;
        for (int l = 0; l < depth; l++) {
            const uint64_t* base = levels + 4 * level_off[l];
            int best = 0, best_d = 1 << 30;
            for (int c = 0; c < k; c++) {
                int dist = hamming(d, base + 4 * (int64_t)(node * k + c));
                if (dist < best_d) { best_d = dist; best = c; }
            }
            node = node * k + best;
        }
        out_words[i] = node;
    }
}

void* bowdb_create(int n_words, int max_kf, const float* idf) {
    BowDB* db = new BowDB();
    db->n_words = n_words;
    db->max_kf = max_kf;
    db->idf.assign(idf, idf + n_words);
    db->inv.resize(n_words);
    db->kf_vec.resize(max_kf);
    db->active.assign(max_kf, 0);
    return db;
}

void bowdb_destroy(void* h) { delete static_cast<BowDB*>(h); }

void bowdb_add(void* h, int kf, const int32_t* words, const uint8_t* valid,
               int n) {
    BowDB* db = static_cast<BowDB*>(h);
    if (kf < 0 || kf >= db->max_kf) return;
    // re-add: remove prior postings of this keyframe
    if (db->active[kf]) {
        for (auto& p : db->kf_vec[kf]) {
            auto& lst = db->inv[p.first];
            lst.erase(std::remove_if(lst.begin(), lst.end(),
                                     [kf](const Entry& e) { return e.kf == kf; }),
                      lst.end());
        }
    }
    make_vec(*db, words, valid, n, db->kf_vec[kf]);
    for (auto& p : db->kf_vec[kf])
        db->inv[p.first].push_back({kf, p.second});
    db->active[kf] = 1;
}

// out_scores (max_kf): L1 similarity per keyframe; -1 for inactive slots.
void bowdb_query(void* h, const int32_t* words, const uint8_t* valid, int n,
                 float* out_scores) {
    BowDB* db = static_cast<BowDB*>(h);
    std::vector<std::pair<int32_t, float>> q;
    make_vec(*db, words, valid, n, q);
    std::vector<float> acc(db->max_kf, 0.0f);
    for (auto& p : q) {
        for (const Entry& e : db->inv[p.first])
            acc[e.kf] += std::min(p.second, e.w);
    }
    for (int kf = 0; kf < db->max_kf; kf++)
        out_scores[kf] = db->active[kf] ? acc[kf] : -1.0f;
}

int bowdb_n_active(void* h) {
    BowDB* db = static_cast<BowDB*>(h);
    int n = 0;
    for (uint8_t a : db->active) n += a;
    return n;
}

}  // extern "C"
