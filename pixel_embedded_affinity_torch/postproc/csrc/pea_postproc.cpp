// pea_postproc: native post-processing kernels for instance decoding.
//
// Host-side C++ replacements for the reference's external native deps
// (elf/affogato mutex watershed, mahotas cwatershed, waterz mean-affinity
// agglomeration, elf/nifty multicut). Interfaces are C ABI for ctypes.
//
// Conventions:
//  * images are flattened C-order; dims given explicitly (ndim 2 or 3)
//  * affinity channel c at pixel p is the affinity between p and p+offset[c]
//    (offsets negative: toward lower coordinates)
//
// Build: g++ -O3 -march=native -shared -fPIC -std=c++17

#include <algorithm>
#include <array>
#include <cstdint>
#include <cstring>
#include <cmath>
#include <queue>
#include <random>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

struct UnionFind {
    std::vector<uint32_t> parent;
    std::vector<uint32_t> rank_;

    explicit UnionFind(size_t n) : parent(n), rank_(n, 0) {
        for (size_t i = 0; i < n; ++i) parent[i] = (uint32_t)i;
    }
    uint32_t find(uint32_t x) {
        uint32_t root = x;
        while (parent[root] != root) root = parent[root];
        while (parent[x] != root) { uint32_t next = parent[x]; parent[x] = root; x = next; }
        return root;
    }
    // returns the surviving root after union (no mutex handling here)
    uint32_t merge(uint32_t a, uint32_t b) {
        if (rank_[a] < rank_[b]) std::swap(a, b);
        parent[b] = a;
        if (rank_[a] == rank_[b]) ++rank_[a];
        return a;
    }
};

inline void unravel(int64_t p, const int64_t* dims, int ndim, int64_t* coord) {
    for (int d = ndim - 1; d >= 0; --d) { coord[d] = p % dims[d]; p /= dims[d]; }
}

// ---------------------------------------------------------------------------
// Partition local search shared by the multicut solvers. Convention:
// positive cost = attraction; the objective being maximized is the total
// cost of within-component edges (equivalently: minimize the cut).
// ---------------------------------------------------------------------------
using AdjD = std::vector<std::unordered_map<uint32_t, double>>;

// greedy single-node moves (cheap pre-pass before Kernighan-Lin)
void greedy_node_moves(const AdjD& nadj, std::vector<uint32_t>& comp,
                       int max_iters) {
    const int64_t n = (int64_t)comp.size();
    bool changed = true;
    int iters = 0;
    while (changed && iters < max_iters) {
        changed = false;
        ++iters;
        for (int64_t v = 0; v < n; ++v) {
            std::unordered_map<uint32_t, double> gain;
            double stay = 0;
            for (auto& kv : nadj[v]) {
                if (comp[kv.first] == comp[v]) stay += kv.second;
                else gain[comp[kv.first]] += kv.second;
            }
            uint32_t best = comp[v];
            double best_gain = 0;
            for (auto& kv : gain) {
                double g = kv.second - stay;
                if (g > best_gain) { best_gain = g; best = kv.first; }
            }
            if (best != comp[v]) { comp[v] = best; changed = true; }
        }
    }
}

// One Kernighan-Lin two-set update (Keuper et al. 2015, as used by
// nifty/elf multicut_kernighan_lin): greedily build a sequence of
// highest-gain node switches between sets A and B, allowing negative
// intermediate gains, then commit the best prefix. Joining A and B
// entirely is reachable as the full prefix; with B empty this attempts a
// split of A into a new set. Mutates comp and the A/B member lists.
// Returns the total objective gain (>= 0).
double kl_bipartition(const AdjD& nadj, std::vector<uint32_t>& comp,
                      uint32_t la, uint32_t lb,
                      std::vector<uint32_t>& A, std::vector<uint32_t>& B,
                      int max_pass) {
    if (A.empty() || (B.empty() && A.size() < 2)) return 0.0;
    // working set U: boundary nodes plus their same-pair neighbors (interior
    // nodes can only usefully move after the boundary has moved; later
    // passes reach them as the boundary advances)
    std::vector<uint32_t> U;
    std::unordered_map<uint32_t, int> idx;
    auto add = [&](uint32_t v) {
        if (idx.emplace(v, (int)U.size()).second) U.push_back(v);
    };
    if (B.empty()) {
        if (A.size() > 4096) return 0.0;  // split attempt on a huge set
        for (uint32_t v : A) add(v);
    } else {
        for (uint32_t v : A)
            for (auto& kv : nadj[v])
                if (comp[kv.first] == lb) { add(v); break; }
        for (uint32_t v : B)
            for (auto& kv : nadj[v])
                if (comp[kv.first] == la) { add(v); break; }
        size_t n_boundary = U.size();
        for (size_t i = 0; i < n_boundary; ++i)
            for (auto& kv : nadj[U[i]]) {
                uint32_t u = kv.first;
                if (comp[u] == la || comp[u] == lb) add(u);
            }
    }
    if (U.size() < 2) return 0.0;

    std::vector<char> side(U.size());
    for (size_t i = 0; i < U.size(); ++i) side[i] = (comp[U[i]] == lb);
    std::vector<double> g(U.size());
    std::vector<char> moved(U.size());
    std::vector<int> seq;
    std::vector<double> cum;
    double total = 0.0;
    for (int pass = 0; pass < max_pass; ++pass) {
        // initial gain of switching each node's side. Edges to other
        // components are cut either way; edges to non-U members of A/B
        // count with that member frozen on its side.
        for (size_t i = 0; i < U.size(); ++i) {
            double gi = 0;
            char si = side[i];
            for (auto& kv : nadj[U[i]]) {
                uint32_t u = kv.first;
                char su;
                auto it = idx.find(u);
                if (it != idx.end()) su = side[it->second];
                else if (comp[u] == la) su = 0;
                else if (comp[u] == lb) su = 1;
                else continue;
                gi += (su != si) ? kv.second : -kv.second;
            }
            g[i] = gi;
        }
        std::fill(moved.begin(), moved.end(), 0);
        seq.clear();
        cum.clear();
        double run = 0.0;
        for (size_t step = 0; step < U.size(); ++step) {
            int best = -1;
            double bg = 0;
            for (size_t i = 0; i < U.size(); ++i)
                if (!moved[i] && (best < 0 || g[i] > bg)) {
                    bg = g[i];
                    best = (int)i;
                }
            if (best < 0) break;
            moved[best] = 1;
            run += g[best];
            side[best] ^= 1;
            seq.push_back(best);
            cum.push_back(run);
            for (auto& kv : nadj[U[best]]) {
                auto it = idx.find(kv.first);
                if (it == idx.end() || moved[it->second]) continue;
                g[it->second] += (side[it->second] == side[best])
                                     ? -2.0 * kv.second : 2.0 * kv.second;
            }
        }
        int bestk = -1;
        double bestv = 1e-9;
        for (size_t k = 0; k < cum.size(); ++k)
            if (cum[k] > bestv) { bestv = cum[k]; bestk = (int)k; }
        for (int k = (int)seq.size() - 1; k > bestk; --k) side[seq[k]] ^= 1;
        if (bestk < 0) break;
        total += bestv;
    }
    if (total > 0) {
        for (size_t i = 0; i < U.size(); ++i)
            comp[U[i]] = side[i] ? lb : la;
        std::vector<uint32_t> newA, newB;
        for (uint32_t v : A) (comp[v] == lb ? newB : newA).push_back(v);
        for (uint32_t v : B) (comp[v] == lb ? newB : newA).push_back(v);
        A.swap(newA);
        B.swap(newB);
    }
    return total;
}

// Kernighan-Lin refinement over the whole partition: repeated two-set
// updates over adjacent component pairs + split attempts, until no pass
// improves the objective. `pair_adj` is the graph used to enumerate
// adjacent pairs (local edges only in the lifted case, so merges keep
// components locally connected); `nadj` carries the full objective
// (local + lifted costs).
void kernighan_lin(const AdjD& nadj, const AdjD& pair_adj,
                   std::vector<uint32_t>& comp, int max_outer) {
    const int64_t n = (int64_t)comp.size();
    uint32_t next_label = 0;
    for (int64_t v = 0; v < n; ++v)
        next_label = std::max(next_label, comp[v] + 1);
    for (int outer = 0; outer < max_outer; ++outer) {
        std::unordered_map<uint32_t, std::vector<uint32_t>> groups;
        for (int64_t v = 0; v < n; ++v) groups[comp[v]].push_back((uint32_t)v);
        std::unordered_set<uint64_t> pairs;
        for (int64_t v = 0; v < n; ++v)
            for (auto& kv : pair_adj[v]) {
                uint32_t ca = comp[v], cb = comp[kv.first];
                if (ca == cb) continue;
                pairs.insert(ca < cb ? ((uint64_t)ca << 32) | cb
                                     : ((uint64_t)cb << 32) | ca);
            }
        double gained = 0.0;
        for (uint64_t key : pairs) {
            uint32_t ca = (uint32_t)(key >> 32), cb = (uint32_t)key;
            auto ia = groups.find(ca);
            auto ib = groups.find(cb);
            if (ia == groups.end() || ib == groups.end()) continue;
            gained += kl_bipartition(nadj, comp, ca, cb, ia->second,
                                     ib->second, 3);
        }
        std::vector<uint32_t> keys;
        keys.reserve(groups.size());
        for (auto& kv : groups) keys.push_back(kv.first);
        for (uint32_t ca : keys) {
            auto ia = groups.find(ca);
            if (ia == groups.end() || ia->second.size() < 2) continue;
            std::vector<uint32_t> empty;
            double gsp = kl_bipartition(nadj, comp, ca, next_label,
                                        ia->second, empty, 3);
            if (gsp > 0 && !empty.empty()) {
                gained += gsp;
                groups.emplace(next_label, std::move(empty));
                ++next_label;
            }
        }
        if (gained < 1e-9) break;
    }
}

// build a node->adjacent-cost map from an edge list
AdjD build_adj(int64_t n_nodes, int64_t n_edges, const uint64_t* uv,
               const double* costs) {
    AdjD adj((size_t)n_nodes);
    for (int64_t i = 0; i < n_edges; ++i) {
        uint32_t a = (uint32_t)uv[2 * i], b = (uint32_t)uv[2 * i + 1];
        if (a == b) continue;
        adj[a][b] += costs[i];
        adj[b][a] += costs[i];
    }
    return adj;
}

// consecutive relabel of comp into node_labels; returns #components
int64_t write_component_labels(const std::vector<uint32_t>& comp,
                               uint64_t* node_labels) {
    std::unordered_map<uint32_t, uint64_t> remap;
    uint64_t next = 0;
    for (size_t v = 0; v < comp.size(); ++v) {
        auto it = remap.find(comp[v]);
        if (it == remap.end()) {
            remap[comp[v]] = next;
            node_labels[v] = next;
            ++next;
        } else {
            node_labels[v] = it->second;
        }
    }
    return (int64_t)next;
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// Mutex watershed (compute_mws_segmentation semantics).
//
// weights: (C, N) edge priorities. Attractive channels (c < n_attractive):
// higher = stronger merge evidence (affinity). Repulsive channels: higher =
// stronger split evidence (1 - affinity). All edges processed in one global
// descending-priority order; attractive edges merge unless a mutex exists,
// repulsive edges install a mutex unless already merged.
// strides subsample repulsive edges on a source-pixel grid (or uniformly at
// random with the same density when randomize_strides).
// mask: optional (N) uint8; edges touching masked-out pixels are dropped and
// masked-out pixels get label 0. Returns number of segments.
// ---------------------------------------------------------------------------
int64_t mws_segmentation(const float* weights,
                         const int32_t* offsets,
                         int32_t n_channels, int32_t n_attractive,
                         const int64_t* dims, int32_t ndim,
                         const int32_t* strides,
                         int32_t randomize_strides, uint64_t seed,
                         const uint8_t* mask,
                         uint32_t* out) {
    int64_t n = 1;
    for (int d = 0; d < ndim; ++d) n *= dims[d];
    if ((int64_t)n_channels * n >= (int64_t)UINT32_MAX) return -1;

    // pixel strides for linear indexing
    int64_t pix_stride[4] = {0, 0, 0, 0};
    pix_stride[ndim - 1] = 1;
    for (int d = ndim - 2; d >= 0; --d) pix_stride[d] = pix_stride[d + 1] * dims[d + 1];

    double stride_density = 1.0;
    for (int d = 0; d < ndim; ++d) stride_density /= std::max(1, strides[d]);
    std::mt19937_64 rng(seed);
    std::uniform_real_distribution<double> uni(0.0, 1.0);

    // collect candidate edges as ids e = c * n + p
    std::vector<uint32_t> edges;
    edges.reserve((size_t)(n * (n_attractive + stride_density * (n_channels - n_attractive)) * 1.02));
    std::vector<int64_t> coord(ndim);
    for (int32_t c = 0; c < n_channels; ++c) {
        const int32_t* off = offsets + (size_t)c * ndim;
        bool repulsive = c >= n_attractive;
        for (int64_t p = 0; p < n; ++p) {
            if (mask && !mask[p]) continue;
            unravel(p, dims, ndim, coord.data());
            bool ok = true;
            int64_t q = p;
            for (int d = 0; d < ndim; ++d) {
                int64_t cd = coord[d] + off[d];
                if (cd < 0 || cd >= dims[d]) { ok = false; break; }
                q += (int64_t)off[d] * pix_stride[d];
            }
            if (!ok) continue;
            if (mask && !mask[q]) continue;
            if (repulsive) {
                if (randomize_strides) {
                    if (uni(rng) >= stride_density) continue;
                } else {
                    bool on_grid = true;
                    for (int d = 0; d < ndim; ++d)
                        if (coord[d] % std::max(1, strides[d]) != 0) { on_grid = false; break; }
                    if (!on_grid) continue;
                }
            }
            edges.push_back((uint32_t)((int64_t)c * n + p));
        }
    }

    // global descending sort by weight (stable for determinism)
    std::stable_sort(edges.begin(), edges.end(),
                     [&](uint32_t a, uint32_t b) { return weights[a] > weights[b]; });

    UnionFind uf((size_t)n);
    std::unordered_map<uint32_t, std::unordered_set<uint32_t>> mutexes;
    mutexes.reserve(1024);

    auto has_mutex = [&](uint32_t ra, uint32_t rb) -> bool {
        auto ia = mutexes.find(ra);
        auto ib = mutexes.find(rb);
        if (ia == mutexes.end() || ib == mutexes.end()) return false;
        const auto& small = ia->second.size() <= ib->second.size() ? ia->second : ib->second;
        uint32_t other = ia->second.size() <= ib->second.size() ? rb : ra;
        return small.count(other) > 0;
    };
    auto add_mutex = [&](uint32_t ra, uint32_t rb) {
        mutexes[ra].insert(rb);
        mutexes[rb].insert(ra);
    };
    auto merge_mutex = [&](uint32_t target, uint32_t source) {
        auto is = mutexes.find(source);
        if (is == mutexes.end()) return;
        auto moved = std::move(is->second);
        mutexes.erase(is);
        auto& tgt = mutexes[target];
        for (uint32_t x : moved) {
            auto ix = mutexes.find(x);
            if (ix != mutexes.end()) {
                ix->second.erase(source);
                ix->second.insert(target);
            }
            tgt.insert(x);
        }
    };

    for (uint32_t e : edges) {
        int64_t c = e / n;
        int64_t p = e % n;
        const int32_t* off = offsets + (size_t)c * ndim;
        int64_t q = p;
        for (int d = 0; d < ndim; ++d) q += (int64_t)off[d] * pix_stride[d];
        uint32_t ra = uf.find((uint32_t)p);
        uint32_t rb = uf.find((uint32_t)q);
        if (ra == rb) continue;
        if (c < n_attractive) {
            if (!has_mutex(ra, rb)) {
                uint32_t keep = uf.merge(ra, rb);
                uint32_t gone = keep == ra ? rb : ra;
                merge_mutex(keep, gone);
            }
        } else {
            add_mutex(ra, rb);
        }
    }

    // relabel roots consecutively (masked-out -> 0)
    std::unordered_map<uint32_t, uint32_t> remap;
    remap.reserve(1024);
    uint32_t next = 1;
    for (int64_t p = 0; p < n; ++p) {
        if (mask && !mask[p]) { out[p] = 0; continue; }
        uint32_t r = uf.find((uint32_t)p);
        auto it = remap.find(r);
        if (it == remap.end()) { remap[r] = next; out[p] = next; ++next; }
        else out[p] = it->second;
    }
    return (int64_t)(next - 1);
}

// ---------------------------------------------------------------------------
// Seeded watershed (mahotas.cwatershed semantics): region growing from seeds
// in ascending cost order; 4-connectivity in 2D.
// seeds: int32 labels (>0 seed, 0 unlabeled). out: final labels (whole image).
// ---------------------------------------------------------------------------
void seeded_watershed_2d(const float* cost, const int32_t* seeds,
                         int64_t h, int64_t w, int32_t* out) {
    const int64_t n = h * w;
    std::memcpy(out, seeds, sizeof(int32_t) * (size_t)n);

    struct QE { float c; int64_t order; int64_t idx; };
    struct Cmp { bool operator()(const QE& a, const QE& b) const {
        if (a.c != b.c) return a.c > b.c;  // min-heap on cost
        return a.order > b.order;          // FIFO tie-break
    } };
    std::priority_queue<QE, std::vector<QE>, Cmp> pq;
    int64_t order = 0;

    std::vector<uint8_t> in_queue((size_t)n, 0);
    for (int64_t p = 0; p < n; ++p)
        if (seeds[p] > 0) { pq.push({cost[p], order++, p}); in_queue[p] = 1; }

    const int64_t dy[4] = {-1, 1, 0, 0};
    const int64_t dx[4] = {0, 0, -1, 1};
    while (!pq.empty()) {
        QE e = pq.top(); pq.pop();
        int64_t p = e.idx;
        int32_t lab = out[p];
        int64_t y = p / w, x = p % w;
        for (int k = 0; k < 4; ++k) {
            int64_t yy = y + dy[k], xx = x + dx[k];
            if (yy < 0 || yy >= h || xx < 0 || xx >= w) continue;
            int64_t q = yy * w + xx;
            if (in_queue[q]) continue;
            out[q] = lab;
            in_queue[q] = 1;
            pq.push({cost[q], order++, q});
        }
    }
}

// ---------------------------------------------------------------------------
// Hierarchical agglomeration (waterz-equivalent scoring): merge fragment
// pairs while score < threshold, lowest score first. fragments uint64
// (label 0 = ignore). affs: (3, D, H, W), channel d = affinity to -1 along
// axis d. Writes merged labels to out; returns #segments.
// scoring (waterz scoring-function family; the reference default is
// OneMinus<EdgeStatisticValue<MeanAffinityProvider>>,
// scripts_ac3ac4/inference.py:211-224): 0 = 1-mean, 1 = 1-quantile50
// (histogram median), 2 = 1-quantile25, 3 = 1-quantile75, 4 = 1-quantile15,
// 5 = 1-quantile85, 6 = 1-max, 7 = 1-min. Quantiles use 256-bin histograms
// like waterz's HistogramQuantileProvider.
// discretize: 0 = exact priority queue; N>0 = N-level discretized bucket
// queue with FIFO order within a bucket — waterz's discretize_queue=256
// merge-order semantics (an edge popped from its bucket is re-scored; if
// its current bucket differs it is re-queued, ties in a bucket merge in
// insertion order).
// ---------------------------------------------------------------------------
namespace {
struct EdgeHist {
    double sum = 0;
    double cnt = 0;
    float max_a = -1e30f;
    float min_a = 1e30f;
    std::array<uint32_t, 256> bins{};

    void add(float a) {
        sum += a;
        cnt += 1;
        max_a = std::max(max_a, a);
        min_a = std::min(min_a, a);
        int b = (int)(a * 255.0f + 0.5f);
        bins[std::min(std::max(b, 0), 255)] += 1;
    }
    void merge(const EdgeHist& o) {
        sum += o.sum;
        cnt += o.cnt;
        max_a = std::max(max_a, o.max_a);
        min_a = std::min(min_a, o.min_a);
        for (int i = 0; i < 256; ++i) bins[i] += o.bins[i];
    }
    double mean() const { return sum / cnt; }
    double quantile(double q) const {
        double target = q * cnt;
        double acc = 0;
        for (int i = 0; i < 256; ++i) {
            acc += bins[i];
            if (acc >= target) return i / 255.0;
        }
        return 1.0;
    }
    double score(int scoring) const {
        switch (scoring) {
            case 1: return 1.0 - quantile(0.5);
            case 2: return 1.0 - quantile(0.25);
            case 3: return 1.0 - quantile(0.75);
            case 4: return 1.0 - quantile(0.15);
            case 5: return 1.0 - quantile(0.85);
            case 6: return 1.0 - (double)max_a;
            case 7: return 1.0 - (double)min_a;
            default: return 1.0 - mean();
        }
    }
};
}  // namespace

int64_t agglomerate_scored(const float* affs, const uint64_t* fragments,
                           int64_t dz, int64_t dy, int64_t dx,
                           double threshold, int32_t scoring,
                           int32_t discretize, uint64_t* out);

int64_t agglomerate_mean(const float* affs, const uint64_t* fragments,
                         int64_t dz, int64_t dy, int64_t dx,
                         double threshold, uint64_t* out) {
    return agglomerate_scored(affs, fragments, dz, dy, dx, threshold, 0, 0,
                              out);
}

int64_t agglomerate_scored(const float* affs, const uint64_t* fragments,
                           int64_t dz, int64_t dy, int64_t dx,
                           double threshold, int32_t scoring,
                           int32_t discretize, uint64_t* out) {
    const int64_t n = dz * dy * dx;
    // compact fragment ids
    std::unordered_map<uint64_t, uint32_t> idmap;
    idmap.reserve(4096);
    std::vector<uint64_t> rev;
    auto compact = [&](uint64_t f) -> uint32_t {
        auto it = idmap.find(f);
        if (it != idmap.end()) return it->second;
        uint32_t id = (uint32_t)rev.size();
        idmap[f] = id;
        rev.push_back(f);
        return id;
    };

    std::vector<std::unordered_map<uint32_t, EdgeHist>> adj;

    const int64_t strides[3] = {dy * dx, dx, 1};
    for (int64_t p = 0; p < n; ++p) {
        uint64_t fp = fragments[p];
        if (!fp) continue;
        uint32_t a = compact(fp);
        if (adj.size() <= a) adj.resize(a + 1);
        int64_t rem = p;
        int64_t cz = rem / strides[0]; rem %= strides[0];
        int64_t cy = rem / strides[1];
        int64_t cx = rem % strides[1];
        int64_t coord[3] = {cz, cy, cx};
        for (int d = 0; d < 3; ++d) {
            if (coord[d] - 1 < 0) continue;
            int64_t q = p - strides[d];
            uint64_t fq = fragments[q];
            if (!fq || fq == fp) continue;
            uint32_t b = compact(fq);
            if (adj.size() <= b) adj.resize(b + 1);
            float av = affs[(size_t)d * n + p];
            adj[a][b].add(av);
            adj[b][a].add(av);
        }
    }
    size_t n_nodes = rev.size();
    adj.resize(n_nodes);

    UnionFind uf(n_nodes);

    // contract rb into ra (after root-order normalization); requeue(u, v, s)
    // re-inserts the merged neighbor edge with its new score
    auto contract = [&](uint32_t ra, uint32_t rb, auto&& requeue) {
        if (adj[ra].size() < adj[rb].size()) std::swap(ra, rb);
        uint32_t keep = uf.merge(ra, rb);
        if (keep != ra) std::swap(ra, rb);
        adj[ra].erase(rb);
        for (auto& kv : adj[rb]) {
            uint32_t c = kv.first;
            if (c == ra) continue;
            uint32_t rc = uf.find(c);
            if (rc == ra) continue;
            auto ic = adj[rc].find(rb);
            if (ic != adj[rc].end()) {
                EdgeHist s2 = ic->second;
                adj[rc].erase(ic);
                adj[rc][ra].merge(s2);
            }
            adj[ra][rc].merge(kv.second);
            requeue(ra, rc, adj[ra][rc].score(scoring));
        }
        adj[rb].clear();
    };

    if (discretize > 0) {
        // waterz discretize_queue semantics: N score levels, FIFO per level
        const int NB = discretize;
        auto binof = [&](double s) {
            int b = (int)(s * (NB - 1) + 0.5);
            return std::min(std::max(b, 0), NB - 1);
        };
        struct BE { uint32_t a, b; };
        std::vector<std::vector<BE>> buckets((size_t)NB);
        std::vector<size_t> head((size_t)NB, 0);
        auto push = [&](uint32_t a, uint32_t b, double s, int at_least) {
            buckets[std::max(binof(s), at_least)].push_back({a, b});
        };
        for (uint32_t a = 0; a < n_nodes; ++a)
            for (auto& kv : adj[a])
                if (kv.first > a)
                    push(a, kv.first, kv.second.score(scoring), 0);
        for (int lvl = 0; lvl < NB; ++lvl) {
            while (head[lvl] < buckets[lvl].size()) {
                BE e = buckets[lvl][head[lvl]++];
                uint32_t ra = uf.find(e.a), rb = uf.find(e.b);
                if (ra == rb) continue;
                auto it = adj[ra].find(rb);
                if (it == adj[ra].end()) continue;
                double cur = it->second.score(scoring);
                if (cur >= threshold) continue;
                int cb = binof(cur);
                if (cb > lvl) {  // re-binned upward: re-queue
                    buckets[cb].push_back({ra, rb});
                    continue;
                }
                contract(ra, rb, [&](uint32_t u, uint32_t v, double s) {
                    push(u, v, s, lvl);
                });
            }
            buckets[lvl].clear();
            if ((double)lvl / (NB - 1) >= threshold) break;
        }
    } else {
        struct QE { double score; uint32_t a, b; };
        struct Cmp { bool operator()(const QE& x, const QE& y) const {
            return x.score > y.score; } };
        std::priority_queue<QE, std::vector<QE>, Cmp> pq;
        for (uint32_t a = 0; a < n_nodes; ++a)
            for (auto& kv : adj[a])
                if (kv.first > a)
                    pq.push({kv.second.score(scoring), a, kv.first});

        while (!pq.empty()) {
            QE e = pq.top(); pq.pop();
            if (e.score >= threshold) break;
            uint32_t ra = uf.find(e.a), rb = uf.find(e.b);
            if (ra == rb) continue;
            auto it = adj[ra].find(rb);
            if (it == adj[ra].end()) continue;
            double cur = it->second.score(scoring);
            if (cur > e.score + 1e-12) { pq.push({cur, ra, rb}); continue; }
            contract(ra, rb, [&](uint32_t u, uint32_t v, double s) {
                pq.push({s, u, v});
            });
        }
    }

    // write out merged labels (relabel consecutively, keep 0)
    std::unordered_map<uint32_t, uint64_t> remap;
    uint64_t next = 1;
    for (int64_t p = 0; p < n; ++p) {
        uint64_t fp = fragments[p];
        if (!fp) { out[p] = 0; continue; }
        uint32_t r = uf.find(idmap[fp]);
        auto it = remap.find(r);
        if (it == remap.end()) { remap[r] = next; out[p] = next; ++next; }
        else out[p] = it->second;
    }
    return (int64_t)(next - 1);
}

// ---------------------------------------------------------------------------
// RAG features: per-edge mean affinity and boundary size from fragments +
// nearest-neighbor affinities. Two-phase: call with uv==nullptr to count
// edges, then with allocated buffers.
// ---------------------------------------------------------------------------
int64_t rag_mean_affinity(const uint64_t* fragments, const float* affs,
                          int64_t dz, int64_t dy, int64_t dx,
                          uint64_t* uv, double* mean_aff, double* size) {
    const int64_t n = dz * dy * dx;
    struct Stat { double sum = 0; double cnt = 0; };
    std::unordered_map<uint64_t, Stat> edges;  // key = (min<<32)|max of compacted? use 64-bit pair hash
    std::unordered_map<uint64_t, uint32_t> idmap;
    std::vector<uint64_t> rev;
    auto compact = [&](uint64_t f) -> uint32_t {
        auto it = idmap.find(f);
        if (it != idmap.end()) return it->second;
        uint32_t id = (uint32_t)rev.size();
        idmap[f] = id; rev.push_back(f);
        return id;
    };
    const int64_t strides[3] = {dy * dx, dx, 1};
    for (int64_t p = 0; p < n; ++p) {
        uint64_t fp = fragments[p];
        if (!fp) continue;
        uint32_t a = compact(fp);
        int64_t rem = p;
        int64_t cz = rem / strides[0]; rem %= strides[0];
        int64_t cy = rem / strides[1];
        int64_t cx = rem % strides[1];
        int64_t coord[3] = {cz, cy, cx};
        for (int d = 0; d < 3; ++d) {
            if (coord[d] - 1 < 0) continue;
            int64_t q = p - strides[d];
            uint64_t fq = fragments[q];
            if (!fq || fq == fp) continue;
            uint32_t b = compact(fq);
            uint64_t key = a < b ? ((uint64_t)a << 32) | b : ((uint64_t)b << 32) | a;
            auto& s = edges[key];
            s.sum += affs[(size_t)d * n + p];
            s.cnt += 1;
        }
    }
    if (!uv) return (int64_t)edges.size();
    int64_t i = 0;
    for (auto& kv : edges) {
        uint32_t a = (uint32_t)(kv.first >> 32);
        uint32_t b = (uint32_t)(kv.first & 0xffffffffu);
        uv[2 * i] = rev[a];
        uv[2 * i + 1] = rev[b];
        mean_aff[i] = kv.second.sum / kv.second.cnt;
        size[i] = kv.second.cnt;
        ++i;
    }
    return i;
}

// ---------------------------------------------------------------------------
// Multicut via greedy additive edge contraction (GAEC) + local search.
// Positive cost = attraction.
// do_local_search: 0 = GAEC only; 1 = + greedy single-node moves;
// 2 = + Kernighan-Lin refinement (the reference's default decode runs
// elf/nifty multicut_kernighan_lin, scripts_ac3ac4/utils/lmc.py:17-22).
// nodes are 0..n_nodes-1; node_labels out: component ids (consecutive).
// ---------------------------------------------------------------------------
int64_t gaec_multicut(int64_t n_nodes, int64_t n_edges,
                      const uint64_t* uv, const double* costs,
                      int32_t do_local_search, uint64_t* node_labels) {
    std::vector<std::unordered_map<uint32_t, double>> adj((size_t)n_nodes);
    for (int64_t i = 0; i < n_edges; ++i) {
        uint32_t a = (uint32_t)uv[2 * i], b = (uint32_t)uv[2 * i + 1];
        if (a == b) continue;
        adj[a][b] += costs[i];
        adj[b][a] += costs[i];
    }
    UnionFind uf((size_t)n_nodes);
    struct QE { double c; uint32_t a, b; };
    struct Cmp { bool operator()(const QE& x, const QE& y) const { return x.c < y.c; } };
    std::priority_queue<QE, std::vector<QE>, Cmp> pq;  // max-heap on cost
    for (uint32_t a = 0; a < (uint32_t)n_nodes; ++a)
        for (auto& kv : adj[a])
            if (kv.first > a && kv.second > 0) pq.push({kv.second, a, kv.first});

    while (!pq.empty()) {
        QE e = pq.top(); pq.pop();
        uint32_t ra = uf.find(e.a), rb = uf.find(e.b);
        if (ra == rb) continue;
        auto it = adj[ra].find(rb);
        if (it == adj[ra].end()) continue;
        if (it->second != e.c) {  // stale
            if (it->second > 0) pq.push({it->second, ra, rb});
            continue;
        }
        if (e.c <= 0) break;
        if (adj[ra].size() < adj[rb].size()) std::swap(ra, rb);
        uint32_t keep = uf.merge(ra, rb);
        if (keep != ra) std::swap(ra, rb);
        adj[ra].erase(rb);
        for (auto& kv : adj[rb]) {
            uint32_t rc = uf.find(kv.first);
            if (rc == ra) continue;
            auto ic = adj[rc].find(rb);
            if (ic != adj[rc].end()) {
                double v = ic->second;
                adj[rc].erase(ic);
                adj[rc][ra] += v;
            }
            adj[ra][rc] += kv.second;
            if (adj[ra][rc] > 0) pq.push({adj[ra][rc], ra, rc});
        }
        adj[rb].clear();
    }

    std::vector<uint32_t> comp((size_t)n_nodes);
    for (int64_t v = 0; v < n_nodes; ++v) comp[v] = uf.find((uint32_t)v);
    if (do_local_search) {
        AdjD nadj = build_adj(n_nodes, n_edges, uv, costs);
        greedy_node_moves(nadj, comp, 3);
        if (do_local_search >= 2) kernighan_lin(nadj, nadj, comp, 10);
    }
    return write_component_labels(comp, node_labels);
}

// ---------------------------------------------------------------------------
// LIFTED multicut via greedy additive edge contraction: lifted edges
// contribute to contraction scores and the objective but only locally
// adjacent pairs may be contracted. Optional greedy node-move local search
// over the combined (local + lifted) cost graph.
// ---------------------------------------------------------------------------
int64_t lifted_gaec_multicut(int64_t n_nodes,
                             int64_t n_local, const uint64_t* uv_local,
                             const double* costs_local,
                             int64_t n_lifted, const uint64_t* uv_lifted,
                             const double* costs_lifted,
                             int32_t do_local_search, uint64_t* node_labels) {
    std::vector<std::unordered_map<uint32_t, double>> local((size_t)n_nodes);
    std::vector<std::unordered_map<uint32_t, double>> lifted((size_t)n_nodes);
    for (int64_t i = 0; i < n_local; ++i) {
        uint32_t a = (uint32_t)uv_local[2 * i], b = (uint32_t)uv_local[2 * i + 1];
        if (a == b) continue;
        local[a][b] += costs_local[i];
        local[b][a] += costs_local[i];
    }
    for (int64_t i = 0; i < n_lifted; ++i) {
        uint32_t a = (uint32_t)uv_lifted[2 * i], b = (uint32_t)uv_lifted[2 * i + 1];
        if (a == b) continue;
        lifted[a][b] += costs_lifted[i];
        lifted[b][a] += costs_lifted[i];
    }
    UnionFind uf((size_t)n_nodes);
    auto pair_score = [&](uint32_t a, uint32_t b) {
        double s = 0.0;
        auto il = local[a].find(b);
        if (il != local[a].end()) s += il->second;
        auto iq = lifted[a].find(b);
        if (iq != lifted[a].end()) s += iq->second;
        return s;
    };
    struct QE { double c; uint32_t a, b; };
    struct Cmp { bool operator()(const QE& x, const QE& y) const { return x.c < y.c; } };
    std::priority_queue<QE, std::vector<QE>, Cmp> pq;
    for (uint32_t a = 0; a < (uint32_t)n_nodes; ++a)
        for (auto& kv : local[a])
            if (kv.first > a) {
                double s = pair_score(a, kv.first);
                if (s > 0) pq.push({s, a, kv.first});
            }

    while (!pq.empty()) {
        QE e = pq.top(); pq.pop();
        uint32_t ra = uf.find(e.a), rb = uf.find(e.b);
        if (ra == rb) continue;
        auto it = local[ra].find(rb);
        if (it == local[ra].end()) continue;  // no longer locally adjacent
        double cur = pair_score(ra, rb);
        if (cur != e.c) {
            if (cur > 0) pq.push({cur, ra, rb});
            continue;
        }
        if (e.c <= 0) break;
        if (local[ra].size() + lifted[ra].size()
            < local[rb].size() + lifted[rb].size()) std::swap(ra, rb);
        uint32_t keep = uf.merge(ra, rb);
        if (keep != ra) std::swap(ra, rb);
        local[ra].erase(rb);
        lifted[ra].erase(rb);
        lifted[rb].erase(ra);
        for (auto& kv : local[rb]) {
            uint32_t rc = uf.find(kv.first);
            if (rc == ra) continue;
            auto ic = local[rc].find(rb);
            if (ic != local[rc].end()) { local[rc].erase(ic); }
            local[rc][ra] += kv.second;
            local[ra][rc] += kv.second;
            double s = pair_score(ra, rc);
            if (s > 0) pq.push({s, ra, rc});
        }
        for (auto& kv : lifted[rb]) {
            uint32_t rc = uf.find(kv.first);
            if (rc == ra) continue;
            auto ic = lifted[rc].find(rb);
            if (ic != lifted[rc].end()) lifted[rc].erase(ic);
            lifted[rc][ra] += kv.second;
            lifted[ra][rc] += kv.second;
            if (local[ra].count(rc)) {
                double s = pair_score(ra, rc);
                if (s > 0) pq.push({s, ra, rc});
            }
        }
        local[rb].clear();
        lifted[rb].clear();
    }

    std::vector<uint32_t> comp((size_t)n_nodes);
    for (int64_t v = 0; v < n_nodes; ++v) comp[v] = uf.find((uint32_t)v);
    if (do_local_search) {
        // combined objective graph (local + lifted)
        AdjD nadj = build_adj(n_nodes, n_local, uv_local, costs_local);
        for (int64_t i = 0; i < n_lifted; ++i) {
            uint32_t a = (uint32_t)uv_lifted[2 * i];
            uint32_t b = (uint32_t)uv_lifted[2 * i + 1];
            if (a == b) continue;
            nadj[a][b] += costs_lifted[i];
            nadj[b][a] += costs_lifted[i];
        }
        greedy_node_moves(nadj, comp, 3);
        if (do_local_search >= 2) {
            // pair enumeration over LOCAL edges only, so two-set joins keep
            // components locally connected (lifted feasibility)
            AdjD ladj = build_adj(n_nodes, n_local, uv_local, costs_local);
            kernighan_lin(nadj, ladj, comp, 10);
        }
    }
    return write_component_labels(comp, node_labels);
}

// ---------------------------------------------------------------------------
// Constrained MALIS edge weights (malis-lib equivalent, 'both' mode).
//
// For each nearest-neighbor affinity edge, counts the voxel pairs for which
// that edge is the maximin edge, via Kruskal in descending affinity order:
//  * positive pass on min(aff, gt): pairs with the SAME (nonzero) label
//  * negative pass on max(aff, gt): pairs with DIFFERENT nonzero labels
// Background (label 0) voxels do not contribute pairs. Output weight =
// opt_weight * pos/total_pos + (1-opt_weight) * neg/total_neg.
// affs/out: (3, D, H, W) with channel d = edge to -1 along axis d.
// ---------------------------------------------------------------------------
int64_t malis_weights(const float* affs, const uint32_t* seg,
                      int64_t dz, int64_t dy, int64_t dx,
                      double opt_weight, float* out) {
    const int64_t n = dz * dy * dx;
    const int64_t strides[3] = {dy * dx, dx, 1};
    const int64_t ddims[3] = {dz, dy, dx};

    // enumerate edges: id = d * n + p, valid when coord[d] > 0
    std::vector<uint32_t> edges;
    edges.reserve((size_t)(3 * n));
    for (int d = 0; d < 3; ++d) {
        for (int64_t p = 0; p < n; ++p) {
            int64_t rem = p;
            int64_t c0 = rem / strides[0]; rem %= strides[0];
            int64_t c1 = rem / strides[1];
            int64_t c2 = rem % strides[1];
            int64_t coord[3] = {c0, c1, c2};
            if (coord[d] - 1 < 0) continue;
            edges.push_back((uint32_t)(d * n + p));
        }
    }

    std::vector<double> pos((size_t)3 * n, 0.0), neg((size_t)3 * n, 0.0);
    double total_pos = 0.0, total_neg = 0.0;

    auto run_pass = [&](bool positive) {
        // edge weight for the pass
        auto ew = [&](uint32_t e) -> float {
            int64_t d = e / n, p = e % n;
            int64_t q = p - strides[d];
            float gt = (seg[p] && seg[p] == seg[q]) ? 1.0f : 0.0f;
            float a = affs[e];
            return positive ? std::min(a, gt) : std::max(a, gt);
        };
        std::vector<uint32_t> order = edges;
        std::stable_sort(order.begin(), order.end(),
                         [&](uint32_t a, uint32_t b) { return ew(a) > ew(b); });
        UnionFind uf((size_t)n);
        // per-root label histogram (fg only)
        std::vector<std::unordered_map<uint32_t, int64_t>> hist((size_t)n);
        std::vector<int64_t> fg_size((size_t)n, 0);
        for (int64_t p = 0; p < n; ++p) {
            if (seg[p]) { hist[p][seg[p]] = 1; fg_size[p] = 1; }
        }
        for (uint32_t e : order) {
            int64_t d = e / n, p = e % n;
            int64_t q = p - strides[d];
            uint32_t ra = uf.find((uint32_t)p), rb = uf.find((uint32_t)q);
            if (ra == rb) continue;
            // count pairs crossing (ra, rb)
            auto& ha = hist[ra];
            auto& hb = hist[rb];
            const auto& small = ha.size() <= hb.size() ? ha : hb;
            const auto& big = ha.size() <= hb.size() ? hb : ha;
            double same = 0.0;
            for (const auto& kv : small) {
                auto it = big.find(kv.first);
                if (it != big.end()) same += (double)kv.second * it->second;
            }
            double cross = (double)fg_size[ra] * fg_size[rb];
            if (positive) {
                pos[e] += same;
                total_pos += same;
            } else {
                neg[e] += cross - same;
                total_neg += cross - same;
            }
            uint32_t keep = uf.merge(ra, rb);
            uint32_t gone = keep == ra ? rb : ra;
            if (hist[gone].size() > hist[keep].size()) hist[gone].swap(hist[keep]);
            for (const auto& kv : hist[gone]) hist[keep][kv.first] += kv.second;
            hist[gone].clear();
            fg_size[keep] = fg_size[ra] + fg_size[rb];
        }
    };
    run_pass(true);
    run_pass(false);

    for (size_t i = 0; i < (size_t)3 * n; ++i) {
        double w = 0.0;
        if (total_pos > 0) w += opt_weight * pos[i] / total_pos;
        if (total_neg > 0) w += (1.0 - opt_weight) * neg[i] / total_neg;
        out[i] = (float)w;
    }
    return (int64_t)(total_pos + total_neg);
}

}  // extern "C"
