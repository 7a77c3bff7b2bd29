// Convex-cost integer min-cost circulation — native kernel.
//
// C++ counterpart of dbgphmm_tpu/flow/mincost.py (same algorithm:
// pointwise-argmin init, negative-cycle canceling, unit-push SSP repair),
// built for the graph sizes the assembler produces at production scale
// (compact DBGs with 1e4..1e6 edges), replacing the reference's Rust
// `rustflow::min_cost_flow_convex_fast` (ref: SURVEY.md section 2.8).
//
// Exposed via a C ABI for ctypes.  Cost families supported (matching
// dbgphmm_tpu/multi_dbg/draft.py error metrics):
//   0: linear        cost = coeff * f
//   1: V1            sum (f - fr)^2
//   2: V2            sum (1 - f/(fr + 1e-7))^2
//   3: V4            sum (1 - f/(fr + 0.1))^2 + (fr/(f + 0.1) - 1)^2
//
// Build: g++ -O3 -shared -fPIC flow.cpp -o libdbgflow.so

#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <limits>
#include <vector>

namespace {

constexpr double INF = std::numeric_limits<double>::infinity();

struct Edge {
    int32_t src, dst;
    int64_t demand, capacity;
    int32_t cost_type;
    double coeff;
    const double* freqs;
    int32_t n_freqs;

    double cost_at(int64_t f) const {
        switch (cost_type) {
            case 0:
                return coeff * static_cast<double>(f);
            case 1: {
                double c = 0, fd = static_cast<double>(f);
                for (int i = 0; i < n_freqs; i++) {
                    double d = fd - freqs[i];
                    c += d * d;
                }
                return c;
            }
            case 2: {
                double c = 0, fd = static_cast<double>(f);
                for (int i = 0; i < n_freqs; i++) {
                    double d = 1.0 - fd / (freqs[i] + 1e-7);
                    c += d * d;
                }
                return c;
            }
            case 3: {
                double c = 0, fd = static_cast<double>(f);
                for (int i = 0; i < n_freqs; i++) {
                    double a = 1.0 - fd / (freqs[i] + 1e-1);
                    double b = freqs[i] / (fd + 1e-1) - 1.0;
                    c += a * a + b * b;
                }
                return c;
            }
        }
        return 0.0;
    }
    double marg_up(int64_t f) const { return cost_at(f + 1) - cost_at(f); }
    double marg_down(int64_t f) const { return cost_at(f - 1) - cost_at(f); }
};

struct Solver {
    int n;
    std::vector<Edge> edges;
    std::vector<int64_t> flow;
    // adjacency: per node, (edge index, +1 forward / -1 backward)
    std::vector<std::vector<std::pair<int32_t, int8_t>>> adj;

    // argmin of convex cost on [demand, capacity] by binary search on the
    // discrete derivative
    int64_t argmin(const Edge& e) const {
        int64_t lo = e.demand, hi = e.capacity;
        if (lo >= hi) return lo;
        if (e.cost_type == 0) return e.coeff >= 0 ? lo : hi;
        while (lo < hi) {
            int64_t m = lo + (hi - lo) / 2;
            if (e.cost_at(m + 1) - e.cost_at(m) >= 0)
                hi = m;
            else
                lo = m + 1;
        }
        return lo;
    }

    // residual arcs from v: fills (to, edge, delta, cost)
    template <typename F>
    void for_arcs(int v, F&& fn) const {
        for (auto [ei, dir] : adj[v]) {
            const Edge& e = edges[ei];
            if (dir > 0) {
                if (flow[ei] < e.capacity) fn(e.dst, ei, +1, e.marg_up(flow[ei]));
            } else {
                if (flow[ei] > e.demand) fn(e.src, ei, -1, e.marg_down(flow[ei]));
            }
        }
    }

    // Bellman-Ford (SPFA) negative-cycle detection; applies one unit around
    // the found cycle.  Returns true if a cycle was canceled.
    bool cancel_one_negative_cycle() {
        std::vector<double> dist(n, 0.0);
        std::vector<int32_t> pred_edge(n, -1);
        std::vector<int32_t> pred_node(n, -1);
        std::vector<int8_t> pred_delta(n, 0);
        int32_t x = -1;
        for (int round = 0; round < n; round++) {
            x = -1;
            for (int v = 0; v < n; v++) {
                double dv = dist[v];
                for_arcs(v, [&](int to, int ei, int delta, double c) {
                    if (dv + c < dist[to] - 1e-9) {
                        dist[to] = dv + c;
                        pred_edge[to] = ei;
                        pred_node[to] = v;
                        pred_delta[to] = (int8_t)delta;
                        x = to;
                    }
                });
            }
            if (x == -1) return false;
        }
        // walk back n steps to land on the cycle
        int v = x;
        for (int i = 0; i < n; i++) v = pred_node[v];
        // apply one unit around the cycle
        int u = v;
        do {
            flow[pred_edge[u]] += pred_delta[u];
            u = pred_node[u];
        } while (u != v);
        return true;
    }

    // shortest path by marginal cost from any surplus node to any deficit
    // node (Bellman-Ford since marginals may be negative transiently).
    // Returns false if unreachable.
    bool push_one_unit(std::vector<int64_t>& excess) {
        std::vector<double> dist(n, INF);
        std::vector<int32_t> pred_edge(n, -1);
        std::vector<int32_t> pred_node(n, -1);
        std::vector<int8_t> pred_delta(n, 0);
        bool any_source = false;
        for (int v = 0; v < n; v++)
            if (excess[v] > 0) {
                dist[v] = 0.0;
                any_source = true;
            }
        if (!any_source) return false;
        for (int round = 0; round < n; round++) {
            bool changed = false;
            for (int v = 0; v < n; v++) {
                if (dist[v] == INF) continue;
                double dv = dist[v];
                for_arcs(v, [&](int to, int ei, int delta, double c) {
                    if (dv + c < dist[to] - 1e-12) {
                        dist[to] = dv + c;
                        pred_edge[to] = ei;
                        pred_node[to] = v;
                        pred_delta[to] = (int8_t)delta;
                        changed = true;
                    }
                });
            }
            if (!changed) break;
        }
        int best = -1;
        double bd = INF;
        for (int v = 0; v < n; v++)
            if (excess[v] < 0 && dist[v] < bd) {
                bd = dist[v];
                best = v;
            }
        if (best == -1) return false;
        // The pred graph of a Bellman-Ford over NEGATIVE marginal costs can
        // contain cycles: walking pred from `best` then never reaches a
        // source and spins forever — the likely k=43 production stall
        // (infinite walk at 100% CPU inside the old unit-push).  Detect by
        // bounding the walk at n steps; on a cycle, cancel one unit around
        // it (a genuine negative cycle: progress in cost, excess unchanged).
        {
            int v = best;
            int steps = 0;
            while (pred_edge[v] != -1 && steps <= n) {
                v = pred_node[v];
                steps++;
            }
            if (steps > n) {
                // land on the cycle and cancel one unit around it
                int w = best;
                for (int i = 0; i < n; i++) w = pred_node[w];
                int u = w;
                do {
                    flow[pred_edge[u]] += pred_delta[u];
                    u = pred_node[u];
                } while (u != w);
                return true;
            }
        }
        // bottleneck along the path: feasibility repair pushes as many
        // units as the path allows per Bellman-Ford instead of one —
        // a blown-up init otherwise needs one O(n*m) pass PER UNIT.
        // Marginal costs shift as flow moves, so the result may be locally
        // suboptimal; the budgeted re-cancel phase after repair restores
        // optimality where time allows.
        int v = best;
        int64_t bottleneck = -excess[best];
        while (pred_edge[v] != -1) {
            const Edge& e = edges[pred_edge[v]];
            int64_t avail = pred_delta[v] > 0 ? e.capacity - flow[pred_edge[v]]
                                              : flow[pred_edge[v]] - e.demand;
            if (avail < bottleneck) bottleneck = avail;
            v = pred_node[v];
        }
        if (excess[v] < bottleneck) bottleneck = excess[v];
        if (bottleneck < 1) bottleneck = 1;
        int u = best;
        while (pred_edge[u] != -1) {
            flow[pred_edge[u]] += pred_delta[u] * bottleneck;
            u = pred_node[u];
        }
        excess[u] -= bottleneck;  // u is the reached source
        excess[best] += bottleneck;
        return true;
    }

    // returns 0 ok, 1 infeasible, 2 repair-phase timeout (non-converging)
    int solve() {
        int m = (int)edges.size();
        flow.resize(m);
        for (int i = 0; i < m; i++) {
            if (edges[i].demand > edges[i].capacity) return 1;
            flow[i] = argmin(edges[i]);
        }
        adj.assign(n, {});
        for (int i = 0; i < m; i++) {
            adj[edges[i].src].push_back({i, +1});
            adj[edges[i].dst].push_back({i, -1});
        }
        // Optimality phases are WALL-CLOCK bounded: cycle canceling works
        // one unit per O(n*m) Bellman-Ford, and a pathological instance
        // (e.g. blown-up freqs) needs millions of cancellations — the
        // round-4 production run stalled >1h here.  Feasibility (phase 2)
        // always runs to completion; a budget-truncated result is feasible
        // and near-optimal, which is all the MSE re-init heuristic needs.
        // Budget is env-configurable so callers (and tests) control the
        // determinism/quality trade-off instead of inheriting machine load.
        double budget_s = 120.0;
        if (const char* env = std::getenv("DBGPHMM_FLOW_BUDGET_S")) {
            char* end = nullptr;
            double v = std::strtod(env, &end);
            if (end != env && v > 0) budget_s = v;
        }
        const auto t0 = std::chrono::steady_clock::now();
        auto elapsed = [&]() {
            return std::chrono::duration<double>(
                std::chrono::steady_clock::now() - t0).count();
        };
        // 1. optimality on the (possibly unbalanced) init
        while (elapsed() < budget_s * 0.5)
            if (!cancel_one_negative_cycle()) break;
        // 2. repair conservation
        std::vector<int64_t> excess(n, 0);
        for (int i = 0; i < m; i++) {
            excess[edges[i].dst] += flow[i];
            excess[edges[i].src] -= flow[i];
        }
        while (true) {
            bool surplus = false;
            for (int v = 0; v < n; v++)
                if (excess[v] > 0) surplus = true;
            if (!surplus) break;
            if (elapsed() > budget_s * 0.5 + 300.0) return 2;  // give up:
            // repair is not converging (cycle-canceling churn).  rc=2
            // (timeout) is distinct from rc=1 (infeasible) so the caller
            // can degrade (keep previous copy nums) instead of aborting
            if (!push_one_unit(excess)) return 1;  // infeasible
        }
        // 3. safety re-check
        while (elapsed() < budget_s)
            if (!cancel_one_negative_cycle()) break;
        return 0;
    }
};

}  // namespace

extern "C" {

// Returns 0 on success (out_flow filled), 1 if infeasible, 2 on
// repair-phase timeout (budget from DBGPHMM_FLOW_BUDGET_S, default 120 s).
int dbg_min_cost_flow_convex(
    int32_t n_nodes, int32_t n_edges,
    const int32_t* src, const int32_t* dst,
    const int64_t* demand, const int64_t* capacity,
    const int32_t* cost_type, const double* coeff,
    const double* freqs_flat, const int64_t* freqs_offset,  // [n_edges+1]
    int64_t* out_flow) {
    Solver s;
    s.n = n_nodes;
    s.edges.resize(n_edges);
    for (int i = 0; i < n_edges; i++) {
        Edge& e = s.edges[i];
        e.src = src[i];
        e.dst = dst[i];
        e.demand = demand[i];
        e.capacity = capacity[i];
        e.cost_type = cost_type[i];
        e.coeff = coeff[i];
        e.freqs = freqs_flat + freqs_offset[i];
        e.n_freqs = (int32_t)(freqs_offset[i + 1] - freqs_offset[i]);
    }
    int rc = s.solve();
    if (rc == 0)
        for (int i = 0; i < n_edges; i++) out_flow[i] = s.flow[i];
    return rc;
}

}  // extern "C"
