// Native builder for MappedPositions (see dbgphmm_tpu/ops/sparse.py).
//
// For each (read, position) the mapped scoring kernel needs, per active
// slot, the slot index of each parent node within the previous position's
// active set (and within the current set for the deletion closure).  This is
// a pure integer hashing problem: per (b, l) build a tiny open-addressing
// map node -> slot, then probe A*D parents.  O(B * L * A * (1 + D)) total.
//
// Build: g++ -O3 -shared -fPIC positions.cpp -o libdbgpos.so

#include <cstdint>
#include <cstring>

namespace {

// open-addressing table sized for A <= ~512 active slots
struct SmallMap {
    static constexpr int CAP = 2048;  // power of two
    int32_t keys[CAP];
    int16_t vals[CAP];

    void clear() { memset(keys, 0xff, sizeof(keys)); }  // key -1 = empty

    static inline uint32_t hash(int32_t k) {
        uint32_t h = (uint32_t)k * 2654435761u;
        return h & (CAP - 1);
    }
    inline void put(int32_t key, int16_t val) {
        if (key < 0) return;
        uint32_t h = hash(key);
        while (keys[h] != -1) {
            if (keys[h] == key) return;  // first occurrence wins
            h = (h + 1) & (CAP - 1);
        }
        keys[h] = key;
        vals[h] = val;
    }
    inline int16_t get(int32_t key) const {
        if (key < 0) return -1;
        uint32_t h = hash(key);
        while (keys[h] != -1) {
            if (keys[h] == key) return vals[h];
            h = (h + 1) & (CAP - 1);
        }
        return -1;
    }
};

}  // namespace

extern "C" {

int dbg_precompute_positions(
    int32_t B, int32_t L, int32_t A, int32_t D, int32_t n_nodes,
    const int32_t* map_nodes,   // [B, L, A]
    const int32_t* parent_idx,  // [n_nodes, D]
    int16_t* prev_pos,          // [B, L, A, D]
    int16_t* cur_pos,           // [B, L, A, D]
    int16_t* self_pos) {        // [B, L, A]
    if (A > SmallMap::CAP / 2) return 1;
    SmallMap prev_map, cur_map;
    for (int b = 0; b < B; b++) {
        prev_map.clear();
        for (int l = 0; l < L; l++) {
            const int32_t* cur = map_nodes + ((int64_t)b * L + l) * A;
            cur_map.clear();
            for (int a = 0; a < A; a++) cur_map.put(cur[a], (int16_t)a);

            int64_t base2 = (((int64_t)b * L + l) * A) * D;
            int64_t base1 = ((int64_t)b * L + l) * A;
            for (int a = 0; a < A; a++) {
                int32_t node = cur[a];
                self_pos[base1 + a] = prev_map.get(node);
                if (node < 0 || node >= n_nodes) {
                    for (int d = 0; d < D; d++) {
                        prev_pos[base2 + a * D + d] = -1;
                        cur_pos[base2 + a * D + d] = -1;
                    }
                    continue;
                }
                const int32_t* par = parent_idx + (int64_t)node * D;
                for (int d = 0; d < D; d++) {
                    prev_pos[base2 + a * D + d] = prev_map.get(par[d]);
                    cur_pos[base2 + a * D + d] = cur_map.get(par[d]);
                }
            }
            // rotate: cur becomes prev
            SmallMap tmp;  // avoid rebuilding: swap via copy of struct
            prev_map = cur_map;
        }
    }
    return 0;
}

}  // extern "C"
