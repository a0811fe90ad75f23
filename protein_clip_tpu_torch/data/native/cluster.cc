// Greedy sequence clusterer: the port's copy of the TPU package's
// data/native/cluster.cc (the same source, so both packages cluster alike),
// which replaces the reference's shelled-out mmseqs2 (`mmseqs cluster ...
// --min-seq-id 0.5`, modules/data_utils.py:126-134). Same contract: every
// sequence is assigned to exactly one cluster, identified by its
// representative; the Python caller writes the identical
// "rep_id\tmember_id" TSV (data_utils.py:143-150).
//
// Algorithm (linclust/CD-HIT family):
//  1. sort sequences by length, longest first — the longest unassigned
//     sequence becomes the representative of a new cluster;
//  2. candidate reps for a query are found via a shared-k-mer inverted
//     index (k=5 over the 20-letter alphabet, so random collisions are
//     negligible);
//  3. candidates are scored with a banded ungapped best-offset identity
//     (matches / min(len)); >= min_seq_id joins the cluster.
//
// Exposed as a C ABI for ctypes; no Python.h dependency.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

constexpr int KMER = 5;

inline int8_t aa_code(char c) {
  // 0..19 canonical, -1 otherwise
  static const char* alpha = "ACDEFGHIKLMNPQRSTVWY";
  const char* p = std::strchr(alpha, c);
  return p ? static_cast<int8_t>(p - alpha) : static_cast<int8_t>(-1);
}

// pack a k-mer of 20-letter codes into a uint32 (20^5 < 2^23)
inline bool pack_kmer(const int8_t* codes, uint32_t* out) {
  uint32_t v = 0;
  for (int i = 0; i < KMER; ++i) {
    if (codes[i] < 0) return false;
    v = v * 20u + static_cast<uint32_t>(codes[i]);
  }
  *out = v;
  return true;
}

// best ungapped identity over offsets in [-band, band]:
// identity = max matches / min(lenA, lenB)
double banded_identity(const std::string& a, const std::string& b, int band) {
  const int la = static_cast<int>(a.size());
  const int lb = static_cast<int>(b.size());
  if (la == 0 || lb == 0) return 0.0;
  int best = 0;
  for (int off = -band; off <= band; ++off) {
    // b[j] aligned against a[j + off]
    int j0 = std::max(0, -off);
    int j1 = std::min(lb, la - off);
    int matches = 0;
    for (int j = j0; j < j1; ++j) {
      if (b[j] == a[j + off]) ++matches;
    }
    best = std::max(best, matches);
  }
  return static_cast<double>(best) / static_cast<double>(std::min(la, lb));
}

}  // namespace

extern "C" {

// seqs: array of n NUL-terminated strings.
// out_rep: length-n buffer; out_rep[i] = original index of i's representative.
// Returns number of clusters, or -1 on error.
int pct_cluster(const char** seqs, int n, double min_seq_id, int band,
                int* out_rep) {
  if (n <= 0 || min_seq_id <= 0.0) return -1;
  std::vector<std::string> sv(n);
  for (int i = 0; i < n; ++i) sv[i] = seqs[i];

  // order: longest first, ties by original index (deterministic)
  std::vector<int> order(n);
  for (int i = 0; i < n; ++i) order[i] = i;
  std::sort(order.begin(), order.end(), [&](int x, int y) {
    if (sv[x].size() != sv[y].size()) return sv[x].size() > sv[y].size();
    return x < y;
  });

  // inverted index: kmer -> representative original-indices
  std::unordered_map<uint32_t, std::vector<int>> index;
  std::vector<int> reps;  // original indices of representatives
  int n_clusters = 0;

  std::vector<int8_t> codes;
  std::vector<uint32_t> kmers;
  std::unordered_map<int, int> hits;  // rep -> shared kmer count

  for (int oi = 0; oi < n; ++oi) {
    const int i = order[oi];
    const std::string& s = sv[i];

    // collect query kmers
    codes.assign(s.size(), -1);
    for (size_t p = 0; p < s.size(); ++p) codes[p] = aa_code(s[p]);
    kmers.clear();
    for (size_t p = 0; p + KMER <= s.size(); ++p) {
      uint32_t v;
      if (pack_kmer(&codes[p], &v)) kmers.push_back(v);
    }
    std::sort(kmers.begin(), kmers.end());
    kmers.erase(std::unique(kmers.begin(), kmers.end()), kmers.end());

    // candidate reps by shared kmers
    hits.clear();
    for (uint32_t v : kmers) {
      auto it = index.find(v);
      if (it == index.end()) continue;
      for (int rep : it->second) ++hits[rep];
    }

    // visit candidates by hit count (desc), verify with banded identity
    std::vector<std::pair<int, int>> cands(hits.begin(), hits.end());
    std::sort(cands.begin(), cands.end(), [](auto& a, auto& b) {
      if (a.second != b.second) return a.second > b.second;
      return a.first < b.first;
    });

    // k-mer containment lower bound: identity ~i implies ~i^k kmer survival;
    // skip candidates sharing fewer than a loose fraction of query kmers.
    const double min_contain = 0.25 * min_seq_id * min_seq_id;  // permissive
    int assigned = -1;
    const int max_verify = 64;  // cap alignment work per query
    int verified = 0;
    for (auto& [rep, cnt] : cands) {
      if (!kmers.empty() &&
          static_cast<double>(cnt) / kmers.size() < min_contain)
        break;
      if (verified++ >= max_verify) break;
      if (banded_identity(sv[rep], s, band) >= min_seq_id) {
        assigned = rep;
        break;
      }
    }

    if (assigned >= 0) {
      out_rep[i] = assigned;
    } else {
      out_rep[i] = i;
      reps.push_back(i);
      ++n_clusters;
      for (uint32_t v : kmers) index[v].push_back(i);
    }
  }
  return n_clusters;
}

}  // extern "C"
