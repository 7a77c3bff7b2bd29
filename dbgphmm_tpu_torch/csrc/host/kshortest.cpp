// Yen's k shortest loopless paths — native kernel.
//
// C++ counterpart of dbgphmm_tpu/graph/k_shortest.py::k_shortest_simple_path
// (ref: dbgphmm src/graph/k_shortest.rs:119-210).  The rescue
// neighbor sweep runs two of these searches per zero-copy compact edge per
// posterior iteration (ref: neighbors.rs:239-409) — at production compact
// sizes (~2.5k residual edges, ~240 searches/sweep) the pure-Python Yen's
// cost 20-76 s per sweep; this kernel does the sweep in well under a second.
//
// The implementation mirrors the Python EXACTLY, including tie-breaking:
//   * Dijkstra heap orders (dist, node); relaxation is strictly `<` over
//     out-edges in ascending edge-id order;
//   * the candidate heap orders (cost, path) with lexicographic path
//     comparison; duplicate candidate paths are suppressed.
//
// Build: g++ -O3 -shared -fPIC kshortest.cpp -o libdbgkshort.so

#include <algorithm>
#include <cstdint>
#include <queue>
#include <set>
#include <vector>

namespace {

constexpr int64_t INF64 = INT64_MAX / 4;

struct Csr {
    std::vector<int32_t> off;   // n_nodes + 1
    std::vector<int32_t> eids;  // edge ids, ascending per node
    const int32_t* src;
    const int32_t* dst;
    const int64_t* cost;
};

// Shortest path source->target as edge list; empty optional = unreachable.
// removed_* implement Yen's spur filtering.
bool dijkstra(const Csr& g, int32_t n_nodes, int32_t source, int32_t target,
              const std::vector<uint8_t>& removed_node,
              const std::vector<uint8_t>& removed_edge,
              std::vector<int32_t>& out_path) {
    if (removed_node[source]) return false;
    std::vector<int64_t> dist(n_nodes, INF64);
    std::vector<int32_t> prev_edge(n_nodes, -1);
    using QE = std::pair<int64_t, int32_t>;
    std::priority_queue<QE, std::vector<QE>, std::greater<QE>> heap;
    dist[source] = 0;
    heap.push({0, source});
    while (!heap.empty()) {
        auto [d, v] = heap.top();
        heap.pop();
        if (v == target) {
            out_path.clear();
            int32_t u = v;
            while (u != source) {
                int32_t e = prev_edge[u];
                out_path.push_back(e);
                u = g.src[e];
            }
            std::reverse(out_path.begin(), out_path.end());
            return true;
        }
        if (d > dist[v]) continue;
        for (int32_t i = g.off[v]; i < g.off[v + 1]; ++i) {
            int32_t e = g.eids[i];
            int32_t w = g.dst[e];
            if (removed_edge[e] || removed_node[w]) continue;
            int64_t nd = d + g.cost[e];
            if (nd < dist[w]) {
                dist[w] = nd;
                prev_edge[w] = e;
                heap.push({nd, w});
            }
        }
    }
    return false;
}

}  // namespace

extern "C" int32_t dbg_k_shortest_simple_paths(
    int32_t n_nodes, int32_t n_edges, const int32_t* src, const int32_t* dst,
    const int64_t* cost, int32_t source, int32_t target, int32_t k,
    int32_t* out_edges, int32_t out_cap, int32_t* out_offsets) {
    Csr g;
    g.src = src;
    g.dst = dst;
    g.cost = cost;
    g.off.assign(n_nodes + 1, 0);
    for (int32_t e = 0; e < n_edges; ++e) g.off[src[e] + 1]++;
    for (int32_t v = 0; v < n_nodes; ++v) g.off[v + 1] += g.off[v];
    g.eids.resize(n_edges);
    {
        std::vector<int32_t> cur(g.off.begin(), g.off.end() - 1);
        for (int32_t e = 0; e < n_edges; ++e) g.eids[cur[src[e]]++] = e;
    }

    std::vector<uint8_t> no_removed_n(n_nodes, 0), no_removed_e(n_edges, 0);
    std::vector<int32_t> first;
    if (!dijkstra(g, n_nodes, source, target, no_removed_n, no_removed_e,
                  first)) {
        out_offsets[0] = 0;
        return 0;
    }
    std::vector<std::vector<int32_t>> paths{first};

    using Cand = std::pair<int64_t, std::vector<int32_t>>;
    std::priority_queue<Cand, std::vector<Cand>, std::greater<Cand>> cands;
    std::set<std::vector<int32_t>> seen;

    std::vector<uint8_t> removed_node(n_nodes, 0), removed_edge(n_edges, 0);
    std::vector<int32_t> spur;
    for (int32_t round = 1; round < k; ++round) {
        const std::vector<int32_t> a = paths.back();
        std::fill(removed_node.begin(), removed_node.end(), 0);
        for (size_t i = 0; i < a.size(); ++i) {
            int32_t spur_node = src[a[i]];
            if (removed_node[spur_node]) break;
            std::fill(removed_edge.begin(), removed_edge.end(), 0);
            for (const auto& p : paths) {
                if (p.size() > i &&
                    std::equal(p.begin(), p.begin() + i, a.begin())) {
                    removed_edge[p[i]] = 1;
                }
            }
            if (dijkstra(g, n_nodes, spur_node, target, removed_node,
                         removed_edge, spur)) {
                std::vector<int32_t> cand(a.begin(), a.begin() + i);
                cand.insert(cand.end(), spur.begin(), spur.end());
                if (seen.insert(cand).second) {
                    int64_t c = 0;
                    for (int32_t e : cand) c += cost[e];
                    cands.push({c, std::move(cand)});
                }
            }
            removed_node[spur_node] = 1;
        }
        if (cands.empty()) break;
        paths.push_back(cands.top().second);
        cands.pop();
    }

    int32_t n_out = 0, pos = 0;
    out_offsets[0] = 0;
    for (const auto& p : paths) {
        if (pos + static_cast<int32_t>(p.size()) > out_cap) break;
        for (int32_t e : p) out_edges[pos++] = e;
        out_offsets[++n_out] = pos;
    }
    return n_out;
}
