// Seed-anchored scored chain DP and candidate block — native kernel.
//
// C++ counterpart of dbgphmm_tpu_torch/multi_dbg/seed.py.  Two entries:
//
// * dbg_seed_chain_union: seed.py's {_scored_pass, _combine, seed_read}, the
//   two directional passes + per-position union.  The Python version spends
//   ~2/3 of its time in numpy small-array overhead (652k _combine calls of
//   <=200 elements per 24 reads); at one seeding pass per production k-stage
//   (B=98 reads x L=10k positions) that is 60-90 s of the per-stage wall
//   budget.  This entry runs the identical recurrence in fixed-capacity
//   buffers.  Semantics mirror seed.py exactly except width-cap
//   tie-breaking, which numpy's argpartition leaves unspecified and we make
//   deterministic (cost, then id ascending).
// * dbg_seed_backfill_rows: seed.py's _backfill over the union's rows and
//   the [L, W] int32 fill of seed_mappings_arrays, so that the read's
//   candidate block leaves the kernel finished (no per-position Python).
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

// seed.py's _backfill over one read's union rows, then the read's candidate
// block.  union_ids is [L * union_width] (-1 pad, as dbg_seed_chain_union
// writes it); out is [L * width_cap] int32, written with each row's edge
// ids then -1 pad.  An empty row after a non-empty one becomes the sorted,
// unique union of that row with its successor edges (SeedIndex.succ_edges:
// deduped, then capped at bridge_cap), capped at width_cap (forward sweep,
// rows filled earlier feed the next); then the leading empty rows the same
// way from the row after, with predecessor edges (backward sweep).  Rows
// the chain DP filled keep the union's order.  stats gets {W, non-empty
// rows, rows the sweeps filled}, W the widest row and at least 1.
int dbg_seed_backfill_rows(
    int32_t L, const int64_t* union_ids, int32_t union_width,
    const int64_t* succ_pad, const int64_t* pred_pad,
    int32_t width_cap, int32_t bridge_cap, int32_t* out, int64_t* stats) {
    std::vector<int32_t> len(L > 0 ? L : 0, 0);
    for (int32_t i = 0; i < L; i++) {
        const int64_t* src = union_ids + (int64_t)i * union_width;
        int32_t* row = out + (int64_t)i * width_cap;
        int32_t n = 0;
        for (int32_t j = 0; j < union_width && n < width_cap; j++)
            if (src[j] >= 0) row[n++] = (int32_t)src[j];
        std::fill(row + n, row + width_cap, -1);
        len[i] = n;
    }
    int64_t filled = 0;
    std::vector<int64_t> nb, u;
    nb.reserve((size_t)width_cap * 4);
    u.reserve((size_t)width_cap * 5);
    // row `to` := unique(row `from` + capped unique neighbours), capped
    auto fill = [&](int32_t to, int32_t from, const int64_t* pad) {
        const int32_t* r = out + (int64_t)from * width_cap;
        nb.clear();
        for (int32_t j = 0; j < len[from]; j++)
            for (int d = 0; d < 4; d++) {
                int64_t e = pad[(int64_t)r[j] * 4 + d];
                if (e >= 0) nb.push_back(e);
            }
        std::sort(nb.begin(), nb.end());
        nb.erase(std::unique(nb.begin(), nb.end()), nb.end());
        if ((int32_t)nb.size() > bridge_cap) nb.resize(bridge_cap);
        u.assign(r, r + len[from]);
        u.insert(u.end(), nb.begin(), nb.end());
        std::sort(u.begin(), u.end());
        u.erase(std::unique(u.begin(), u.end()), u.end());
        int32_t n = std::min<int32_t>((int32_t)u.size(), width_cap);
        int32_t* row = out + (int64_t)to * width_cap;
        for (int32_t j = 0; j < n; j++) row[j] = (int32_t)u[j];
        std::fill(row + n, row + width_cap, -1);
        len[to] = n;
        filled++;
    };
    for (int32_t i = 1; i < L; i++)
        if (len[i] == 0 && len[i - 1] > 0) fill(i, i - 1, succ_pad);
    for (int32_t i = L - 2; i >= 0; i--)
        if (len[i] == 0 && len[i + 1] > 0) fill(i, i + 1, pred_pad);
    int64_t W = 1, nonempty = 0;
    for (int32_t i = 0; i < L; i++) {
        W = std::max<int64_t>(W, len[i]);
        nonempty += len[i] > 0;
    }
    stats[0] = W;
    stats[1] = nonempty;
    stats[2] = filled;
    return 0;
}

}  // extern "C"
