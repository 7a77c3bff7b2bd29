// Seed-anchored scored chain DP — native kernel.
//
// C++ counterpart of dbgphmm_tpu/multi_dbg/seed.py::{_scored_pass,_combine,
// seed_read}'s two directional passes + per-position union.  The Python
// version spends ~2/3 of its time in numpy small-array overhead (652k
// _combine calls of <=200 elements per 24 reads); at one seeding pass per
// production k-stage (B=98 reads x L=10k positions) that is 60-90 s of the
// per-stage wall budget.  This kernel runs the identical recurrence in
// fixed-capacity buffers.
//
// Semantics mirror seed.py exactly except width-cap tie-breaking, which
// numpy's argpartition leaves unspecified and we make deterministic
// (cost, then id ascending).
//
// Build: g++ -O3 -shared -fPIC seedchain.cpp -o libdbgseed.so

#include <algorithm>
#include <cstdint>
#include <vector>

namespace {

struct Cand {
    int64_t id;
    double cost;
};

// dedup by id keeping min cost, then cap to `width` lowest-cost (tie: lowest
// id); result sorted by id ascending (the Python un-capped combine returns
// id-sorted output)
void combine(std::vector<Cand>& c, int32_t width) {
    if (c.empty()) return;
    std::sort(c.begin(), c.end(), [](const Cand& a, const Cand& b) {
        return a.id != b.id ? a.id < b.id : a.cost < b.cost;
    });
    size_t w = 0;
    for (size_t i = 0; i < c.size(); i++)
        if (i == 0 || c[i].id != c[w - 1].id)
            c[w++] = c[i];
    c.resize(w);
    if ((int32_t)c.size() > width) {
        std::nth_element(
            c.begin(), c.begin() + width, c.end(),
            [](const Cand& a, const Cand& b) {
                return a.cost != b.cost ? a.cost < b.cost : a.id < b.id;
            });
        c.resize(width);
        std::sort(c.begin(), c.end(), [](const Cand& a, const Cand& b) {
            return a.id < b.id;
        });
    }
}

// one directional pass; fills per-position candidate lists (post-update
// state at each position, matching seed.py's `out[i] = (S, C)`)
void scored_pass(
    const int64_t* step,  // [E,4] successor (fwd) / predecessor (bwd) pad
    const uint8_t* emis, int32_t L, const uint8_t* rb,
    const int64_t* hit_ids, const int64_t* hit_off,
    bool forward, double decay, double stay, double hit_cost, double cmax,
    int32_t pass_width,
    std::vector<std::vector<Cand>>& out) {
    std::vector<Cand> state;
    std::vector<Cand> cand;
    state.reserve(pass_width);
    cand.reserve(pass_width * 5 + 64);
    for (int32_t t = 0; t < L; t++) {
        int32_t i = forward ? t : L - 1 - t;
        cand.clear();
        for (const Cand& s : state) {
            double base = s.cost * decay;
            const int64_t* row = step + s.id * 4;
            for (int d = 0; d < 4; d++) {
                int64_t f = row[d];
                if (f < 0) continue;
                double c = base + (emis[f] == rb[i] ? 0.0 : 1.0);
                if (c <= cmax) cand.push_back({f, c});
            }
            double cs = base + stay;  // stay-in-place (read insertion)
            if (cs <= cmax) cand.push_back({s.id, cs});
        }
        for (int64_t h = hit_off[i]; h < hit_off[i + 1]; h++)
            if (hit_cost <= cmax) cand.push_back({hit_ids[h], hit_cost});
        if (!cand.empty() || !state.empty()) {
            combine(cand, pass_width);
            state = cand;
        }
        out[i] = state;
    }
}

}  // namespace

extern "C" {

// Two scored chain passes + per-position min-cost union.  out_ids is
// [L * union_width] filled with edge ids (-1 pad); returns 0.
int dbg_seed_chain_union(
    int64_t n_edges, const int64_t* succ_pad, const int64_t* pred_pad,
    const uint8_t* emis, int32_t L, const uint8_t* rb,
    const int64_t* hit_ids, const int64_t* hit_off,
    double decay, double stay, double hit_cost, double cmax,
    int32_t pass_width, int32_t union_width, int64_t* out_ids) {
    (void)n_edges;
    std::vector<std::vector<Cand>> fwd(L), bwd(L);
    scored_pass(succ_pad, emis, L, rb, hit_ids, hit_off, true, decay, stay,
                hit_cost, cmax, pass_width, fwd);
    scored_pass(pred_pad, emis, L, rb, hit_ids, hit_off, false, decay, stay,
                hit_cost, cmax, pass_width, bwd);
    std::vector<Cand> u;
    for (int32_t i = 0; i < L; i++) {
        int64_t* row = out_ids + (int64_t)i * union_width;
        std::fill(row, row + union_width, (int64_t)-1);
        // seed.py: union when both passes are non-empty; otherwise the
        // non-empty side truncated to union_width (ids as-is)
        if (!fwd[i].empty() && !bwd[i].empty()) {
            u.clear();
            u.insert(u.end(), fwd[i].begin(), fwd[i].end());
            u.insert(u.end(), bwd[i].begin(), bwd[i].end());
            combine(u, union_width);
            for (size_t j = 0; j < u.size(); j++) row[j] = u[j].id;
        } else {
            const std::vector<Cand>& s = fwd[i].empty() ? bwd[i] : fwd[i];
            int32_t n = std::min<int32_t>((int32_t)s.size(), union_width);
            for (int32_t j = 0; j < n; j++) row[j] = s[j].id;
        }
    }
    return 0;
}

}  // extern "C"
