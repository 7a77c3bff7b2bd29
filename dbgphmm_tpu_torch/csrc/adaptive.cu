// The sparse-adaptive forward's two device scans (A1, A2) for NVIDIA Hopper
// (sm_90a).
//
// A1, dbg_adaptive_dense, replaces the dense warm-up lax.scan of
// dbgphmm_tpu/ops/adaptive.py:349 (forward_sparse_adaptive, step
// forward._f_step then _dense_to_sparse :251): for read positions 0..W-1
// the dense forward over all n nodes (M from the parents and the Begin
// entry, I, the deletion closure of 1 + n_max_gaps rounds, the
// renormalisation by the largest M and the Kahan-summed offset), then the
// table compacted to its top A cells by ladd3(m, i, d) in the stable
// descending order of torch.sort (ties and -inf to the lower node first; a
// cell at -inf stores node -1 and -inf), and the stored row.  At the end the
// compacted carry goes to a device buffer for A2.
//
// A2, dbg_adaptive_frontier, replaces the evolving-frontier lax.scan of
// dbgphmm_tpu/ops/adaptive.py:370 (step _next_active_attrs :137 then
// _s_step_attrs :173): for positions W..L-1 the next active set (the stable
// top n_top carried cells under the max_ratio cut, then their children
// where the log transition is finite, the earliest slot keeping a node
// seen twice, cut to A), then refine_common.cuh's mapped_step (R1's step)
// over it, and the stored row.
//
// The stored row of a position (both): with K < A the stable top K of the
// A cells by max(m, i, d) (a cell without a node as -inf), else the A
// cells in slot order; in the model's type or rounded to bfloat16 (to
// nearest even, from float32 as Tensor.to does).  At a padding position
// (p >= len) the carry is held and its row stored again.  The read
// log-likelihood e [B] (offset applied) is computed at the read's last
// position only.
//
// Both compute in the model's type (float32 on the card; float64 lets a
// check hold them to the plain version to 1e-9) with refine_common.cuh's
// arithmetic; everything but e (a log-sum-exp over n, summed in another
// order) equals the plain version to the bit.
//
// Design.
//   * A read's positions form one chain, so one block walks one read
//     (grid = B) through its positions.
//   * A1 (1,024 threads in float32, 512 in float64; nodes strided over
//     them): every phase of a position is one pass over the nodes between
//     block barriers.  Per read, seven arrays of n elements in a global
//     scratch (n reaches 141,404 at KIR): the state, each node's pre-M and
//     pre-I (made once per position; the plain version's lookups of them
//     are pure selections), the closure's two rounds.  The top A is a
//     block-wide radix select, 8 bits a pass, on a composite key (the
//     value's order-preserving bits, then n - 1 - node): the keys are
//     distinct, so the A largest are exactly the stable top A, and the
//     select stops at the first pass whose bucket is taken whole.  The
//     <= A selected are then ranked in shared memory.
//   * A2 (one thread per carried cell, A <= 512): the carry in registers,
//     the set's node ids and looked-up values in shared memory as in R1;
//     the stable ranks are counts over the A cells (greater values, then
//     equal values at a lower slot).
//   * What bounds it: one read's chain, not the card (one read takes as
//     long as 30 on an H100).  A1's time follows the nodes per thread and
//     the deletion rounds: each pass is a chain of accurate exp / log per
//     node; placing the arrays read at parents in shared memory did not
//     change it.  A2: R1's step at width A plus three rank counts.
//     Splitting a read's nodes over a cluster of blocks, several reads per
//     SM and a hashed slot lookup for A2 are left to a later version.
//
// Build (done by dbgphmm_tpu_torch/ops/_build.py at first use):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libadaptive.so adaptive.cu

#include "refine_common.cuh"

namespace {

// A1's threads per block: float32 fits 1,024 threads' registers (64
// each) without spilling, float64 does not
template <typename T> constexpr int a1_threads() { return sizeof(T) == 4 ? 1024 : 512; }
constexpr int NT1 = 1024;       // A1's threads per block at most
constexpr int MAX_CELLS = 512;  // A: carried cells (A2: one thread each)

// The order-preserving unsigned key of a value (larger value, larger key;
// -0 as +0, which torch.sort does not tell apart).
__device__ __forceinline__ unsigned okey(float x) {
    unsigned u = __float_as_uint(x);
    if (u == 0x80000000u) u = 0;
    return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ unsigned long long okey(double x) {
    unsigned long long u = (unsigned long long)__double_as_longlong(x);
    if (u == 0x8000000000000000ull) u = 0;
    return (u & 0x8000000000000000ull) ? ~u : (u | 0x8000000000000000ull);
}
template <typename T> struct KeyOf { using type = unsigned; };
template <> struct KeyOf<double> { using type = unsigned long long; };

// A stored value: the model's type, or bfloat16 rounded from float32.
template <typename S> struct Store {
    template <typename T> __device__ static S of(T x) { return (S)x; }
};
template <> struct Store<__nv_bfloat16> {
    template <typename T> __device__ static __nv_bfloat16 of(T x) {
        return __float2bfloat16_rn((float)x);
    }
};

// The rank of slot a's cell in the stored row (every thread calls it; a >=
// A gets K): with K < A its place in the stable top K by max(m, i, d) over
// the A slots (a slot without a node as -inf; ranks >= K are not stored),
// with K == A the slot itself.
template <typename T>
__device__ __forceinline__ int row_rank(int a, int A, int K, int node, T m, T i, T d,
                                        T* skey) {
    if (K >= A) return a < A ? a : K;
    const T key = node >= 0 ? vmax(vmax(m, i), d) : ninf<T>();
    if (a < A) skey[a] = key;
    __syncthreads();
    int rank = K;
    if (a < A) {
        rank = 0;
        for (int j = 0; j < A; ++j) {
            const T w = skey[j];
            rank += (w > key) || (w == key && j < a);
        }
    }
    __syncthreads();
    return rank;
}

template <typename T, typename S>
__device__ __forceinline__ void store_cell(size_t row, int K, int rank, int node, T m, T i,
                                           T d, int* o_nodes, S* o_m, S* o_i, S* o_d) {
    if (rank >= K) return;
    const size_t o = row * K + rank;
    o_nodes[o] = node;
    o_m[o] = Store<S>::of(m);
    o_i[o] = Store<S>::of(i);
    o_d[o] = Store<S>::of(d);
}

// The need (<= NT1) largest composite keys (okey(vals[v]), n - 1 - v) over
// v < n, i.e. the stable descending top need of vals: their nodes in that
// order in sel[0..need).  Every thread calls it.
template <typename T>
__device__ void select_top(const T* __restrict__ vals, int n, int need, int* sel,
                           typename KeyOf<T>::type* selk, int* hist, int* ctl) {
    using Key = typename KeyOf<T>::type;
    constexpr int HB = 8 * (int)sizeof(Key), HD = HB / 8;
    const int tid = threadIdx.x, lane = tid & 31, nth = blockDim.x;
    const int lo_bits = 32 - __clz(max(n - 1, 1));
    const int LD = (lo_bits + 7) / 8;  // digits of n - 1 - v
    Key hmask = 0, hpref = 0;
    unsigned lmask = 0, lpref = 0;
    int rem = need;
    bool done = need >= n;
    for (int j = 0; !done && j < HD + LD; ++j) {
        const bool hi = j < HD;
        const int sh = hi ? HB - 8 * (j + 1) : 8 * LD - 8 * (j - HD + 1);
        if (tid < 256) hist[tid] = 0;
        __syncthreads();
        for (int base = 0; base < n; base += nth) {
            const int v = base + tid;
            int dg = -1;
            if (v < n) {
                const Key h = okey(vals[v]);
                const unsigned l = (unsigned)(n - 1 - v);
                if ((h & hmask) == hpref && (l & lmask) == lpref)
                    dg = hi ? (int)((h >> sh) & 255) : (int)((l >> sh) & 255);
            }
            const unsigned peers = __match_any_sync(0xffffffffu, dg);
            if (dg >= 0 && lane == __ffs(peers) - 1) atomicAdd(&hist[dg], __popc(peers));
        }
        __syncthreads();
        if (tid < 32) {
            // lane l holds the bins 255 - 8 l down to 248 - 8 l: the bucket
            // holding the rem-th largest, counted from the top
            int c[8], s = 0;
#pragma unroll
            for (int q = 0; q < 8; ++q) {
                c[q] = hist[255 - 8 * lane - q];
                s += c[q];
            }
            int incl = s;
#pragma unroll
            for (int o = 1; o < 32; o <<= 1) {
                const int t = __shfl_up_sync(0xffffffffu, incl, o);
                if (lane >= o) incl += t;
            }
            const int excl = incl - s;
            if (excl < rem && rem <= incl) {
                int cum = excl, q = 0;
                while (cum + c[q] < rem) cum += c[q++];
                ctl[0] = 255 - 8 * lane - q;
                ctl[1] = rem - cum;
                ctl[2] = (rem - cum) == c[q];
            }
        }
        __syncthreads();
        const int dg = ctl[0];
        rem = ctl[1];
        done = ctl[2];
        if (hi) {
            hmask |= (Key)255 << sh;
            hpref |= (Key)dg << sh;
        } else {
            lmask |= 255u << sh;
            lpref |= (unsigned)dg << sh;
        }
    }
    // every key whose digits so far are above the prefix, or equal to it
    if (tid == 0) ctl[3] = 0;
    __syncthreads();
    for (int v = tid; v < n; v += nth) {
        const Key h = okey(vals[v]);
        const unsigned l = (unsigned)(n - 1 - v);
        const Key hm = h & hmask;
        if (hm > hpref || (hm == hpref && (l & lmask) >= lpref)) {
            const int slot = atomicAdd(&ctl[3], 1);
            if (slot < need) {  // exactly need keys qualify
                sel[slot] = v;
                selk[slot] = h;
            }
        }
    }
    __syncthreads();
    int v = -1, rank = 0;
    if (tid < need) {
        v = sel[tid];
        const Key h = selk[tid];
        for (int j = 0; j < need; ++j) {
            const Key hj = selk[j];
            rank += hj > h || (hj == h && sel[j] < v);
        }
    }
    __syncthreads();
    if (tid < need) sel[rank] = v;
    __syncthreads();
}

// ---------------------------------------------------------------- A1 ------

// A1's per-read arrays of n elements in the global scratch [B, 7, n]: the
// state m / i / d, pre-M and pre-I of every node (the M and I recursions'
// combination of its state, made once per position by the renormalisation
// pass), and the closure's two rounds (the merged table ladd3(m, i, d)
// after them).
constexpr int A1_ARRAYS = 7;

template <typename T, typename S>
__global__ void __launch_bounds__(a1_threads<T>(), 1) adaptive_dense(
    const int* __restrict__ emission, const T* __restrict__ init_logp,
    const int* __restrict__ parent_idx, const T* __restrict__ parent_logt,
    const T* __restrict__ lt_v, const int* __restrict__ codes,
    const int* __restrict__ lens, T* __restrict__ scratch, int* __restrict__ o_nodes,
    S* __restrict__ o_m, S* __restrict__ o_i, S* __restrict__ o_d, T* __restrict__ o_off,
    T* __restrict__ o_e, int* __restrict__ c_nodes, T* __restrict__ c_m,
    T* __restrict__ c_i, T* __restrict__ c_d, T* __restrict__ c_s, int B, int L, int n,
    int A, int K, int W, int D, int G) {
    using Key = typename KeyOf<T>::type;
    __shared__ int s_hist[256];
    __shared__ int s_ctl[4];
    __shared__ int s_sel[NT1];  // the selected nodes, then in order
    __shared__ Key s_selk[NT1];
    __shared__ T s_key[MAX_CELLS];
    __shared__ T s_red[3][NT1 / 32];

    const T NEG = ninf<T>();
    const Trans<T> lt(lt_v);
    const int b = blockIdx.x, tid = threadIdx.x, nth = blockDim.x;
    const int len = min(max(lens[b], 0), L);
    const int steps = min(len, W);
    const int need = min(A, n);
    T* const buf = scratch + (size_t)b * A1_ARRAYS * n;
    T* const sm = buf;  // the state
    T* const si = buf + n;
    T* const sd = buf + (size_t)2 * n;
    T* const pre_m = buf + (size_t)3 * n;
    T* const pre_i = buf + (size_t)4 * n;
    T* const f0 = buf + (size_t)5 * n;
    T* const f1 = buf + (size_t)6 * n;

    // F[0]: every node -inf (so are its pre-M and pre-I), Begin-match 0
    for (int v = tid; v < n; v += nth) pre_m[v] = pre_i[v] = NEG;
    T mb = 0, ib = NEG, e = NEG, off = 0, off_c = 0;
    // the compacted cell of slot tid (threads < A)
    int node = -1;
    T m = NEG, i = NEG, d = NEG;
    __syncthreads();

    for (int p = 0; p < steps; ++p) {
        const int x = codes[(size_t)b * L + p];
        const T begin = ladd(lt.MM + mb, lt.IM + ib);
        const T ib_new = lt.random + ladd(lt.MI + mb, lt.II + ib);
        const T begin_d = ladd(lt.MD + NEG, lt.ID + ib_new);  // mb_new = -inf

        // M from the parents' pre-M and the Begin entry, I from the node's
        // pre-I; pre-D into f0
        T lmax = NEG;
        for (int v = tid; v < n; v += nth) {
            T t[MAX_D];
#pragma unroll
            for (int c = 0; c < MAX_D; ++c) {
                t[c] = NEG;
                if (c < D) {
                    const T pl = parent_logt[(size_t)v * D + c];
                    if (pl != NEG) t[c] = pl + pre_m[parent_idx[(size_t)v * D + c]];
                }
            }
            const T from_begin = init_logp[v] + begin;
            const T p_emit = emission[v] == x ? lt.match : lt.mismatch;
            const T m_new = p_emit + ladd(lse(t, D), from_begin);
            const T i_new = lt.random + pre_i[v];
            sm[v] = m_new;
            si[v] = i_new;
            f0[v] = ladd(lt.MD + m_new, lt.ID + i_new);
            lmax = vmax(lmax, m_new);
        }
        __syncthreads();

        // the deletion closure: its first value, then G rounds
        for (int v = tid; v < n; v += nth) {
            T t[MAX_D];
#pragma unroll
            for (int c = 0; c < MAX_D; ++c) {
                t[c] = NEG;
                if (c < D) {
                    const T pl = parent_logt[(size_t)v * D + c];
                    if (pl != NEG) t[c] = pl + f0[parent_idx[(size_t)v * D + c]];
                }
            }
            const T fd0 = ladd(lse(t, D), init_logp[v] + begin_d);
            sd[v] = fd0;
            f1[v] = fd0;
        }
        const T* src = f1;
        T* dst = f0;
        for (int r = 0; r < G; ++r) {
            __syncthreads();
            for (int v = tid; v < n; v += nth) {
                T t[MAX_D];
#pragma unroll
                for (int c = 0; c < MAX_D; ++c) {
                    t[c] = NEG;
                    if (c < D) {
                        const T pl = parent_logt[(size_t)v * D + c];
                        if (pl != NEG)
                            t[c] = pl + lt.DD + src[parent_idx[(size_t)v * D + c]];
                    }
                }
                const T fdt = lse(t, D);
                sd[v] = ladd(sd[v], fdt);
                if (r + 1 < G) dst[v] = fdt;
            }
            const T* const tmp = dst;
            dst = const_cast<T*>(src);
            src = tmp;
        }

        // renormalise by the largest M (0 where there is none)
        const T mx = block_max(lmax, s_red[0]);
        const T shift = mx == NEG ? T(0) : mx;
        if (p == len - 1) {
            // e, needed only at the read's last position
            T lm = NEG;
            for (int v = tid; v < n; v += nth) {
                const T x3 = ladd3(sm[v], si[v], sd[v]);
                f0[v] = x3;
                lm = vmax(lm, x3);
            }
            const T emx = block_max(lm, s_red[1]);
            T tot = NEG;
            if (emx != NEG) {
                T s = 0;
                for (int v = tid; v < n; v += nth) {
                    const T x3 = f0[v];
                    s += x3 == NEG ? T(0) : Num<T>::ex(x3 - emx);
                }
                tot = emx + Num<T>::lg(block_sum(s, s_red[2]));
            }
            e = (lt.end + tot) - shift;
        }
        // the shifted state, its merged table (into f1) and the next
        // position's pre-M and pre-I
        for (int v = tid; v < n; v += nth) {
            const T ms = sm[v] - shift, is = si[v] - shift, ds = sd[v] - shift;
            sm[v] = ms;
            si[v] = is;
            sd[v] = ds;
            f1[v] = ladd3(ms, is, ds);
            pre_m[v] = ladd3(lt.MM + ms, lt.IM + is, lt.DM + ds);
            pre_i[v] = ladd3(lt.MI + ms, lt.II + is, lt.DI + ds);
        }
        mb = NEG - shift;
        ib = ib_new - shift;
        kahan(off, off_c, shift);
        __syncthreads();

        // the top A of ladd3(m, i, d), then the stored row
        select_top(f1, n, need, s_sel, s_selk, s_hist, s_ctl);
        node = -1;
        m = i = d = NEG;
        if (tid < need) {
            const int v = s_sel[tid];
            if (finite(f1[v])) {
                node = v;
                m = sm[v];
                i = si[v];
                d = sd[v];
            }
        }
        const int rank = row_rank(tid, A, K, node, m, i, d, s_key);
        store_cell((size_t)p * B + b, K, rank, node, m, i, d, o_nodes, o_m, o_i, o_d);
        if (tid == 0) o_off[(size_t)p * B + b] = off;
        __syncthreads();
    }
    // positions past the read (or the start, for an empty read) hold the
    // carry and store its row again
    const int rank = row_rank(tid, A, K, node, m, i, d, s_key);
    for (int p = steps; p < W; ++p) {
        store_cell((size_t)p * B + b, K, rank, node, m, i, d, o_nodes, o_m, o_i, o_d);
        if (tid == 0) o_off[(size_t)p * B + b] = off;
    }
    if (tid < A) {
        const size_t o = (size_t)b * A + tid;
        c_nodes[o] = node;
        c_m[o] = m;
        c_i[o] = i;
        c_d[o] = d;
    }
    if (tid == 0) {
        T* const s = c_s + (size_t)b * 5;
        s[0] = mb;
        s[1] = ib;
        s[2] = e;
        s[3] = off;
        s[4] = off_c;
        o_e[b] = e + off;
    }
}

// ---------------------------------------------------------------- A2 ------

template <typename T, typename S>
__global__ void __launch_bounds__(MAX_CELLS, 1) adaptive_frontier(
    const int* __restrict__ emission, const T* __restrict__ init_logp,
    const int* __restrict__ parent_idx, const T* __restrict__ parent_logt,
    const int* __restrict__ child_idx, const T* __restrict__ child_logt,
    const T* __restrict__ lt_v, const int* __restrict__ codes,
    const int* __restrict__ lens, const int* __restrict__ c_nodes,
    const T* __restrict__ c_m, const T* __restrict__ c_i, const T* __restrict__ c_d,
    const T* __restrict__ c_s, int* __restrict__ o_nodes, S* __restrict__ o_m,
    S* __restrict__ o_i, S* __restrict__ o_d, T* __restrict__ o_off, T* __restrict__ o_e,
    int B, int L, int A, int K, int W, int D, int G, int n_top, int has_ratio,
    T max_ratio) {
    __shared__ __align__(16) int s_prev[MAX_CELLS];
    __shared__ __align__(16) int s_cur[MAX_CELLS];
    __shared__ T s_pm[MAX_CELLS], s_pi[MAX_CELLS];
    __shared__ T s_f[2][MAX_CELLS];
    __shared__ T s_red[4][MAX_CELLS / 32];
    __shared__ T s_val[MAX_CELLS];  // the carried cells' merged values, then row keys
    __shared__ int s_cand[MAX_CELLS * (MAX_D + 1)];  // the top cells, then their children
    const StepSmem<T> sm{s_prev, s_cur, s_pm, s_pi, {s_f[0], s_f[1]},
                         {s_red[0], s_red[1], s_red[2]}};

    const T NEG = ninf<T>();
    const Trans<T> lt(lt_v);
    const int b = blockIdx.x, a = threadIdx.x;
    const bool own = a < A;
    const int n4 = (A + 3) & ~3;
    const int len = min(max(lens[b], 0), L);
    const int k = min(n_top, A);

    int node = -1;
    T m = NEG, i = NEG, d = NEG;
    if (own) {
        const size_t o = (size_t)b * A + a;
        node = c_nodes[o];
        m = c_m[o];
        i = c_i[o];
        d = c_d[o];
    }
    const T* const cs = c_s + (size_t)b * 5;
    ReadCarry<T> rc{cs[0], cs[1], cs[2], cs[3], cs[4]};

    for (int p = W; p < len; ++p) {
        // the next active set: the stable top k carried cells by
        // ladd3(m, i, d) (under the max_ratio cut), then their children
        T mg = node >= 0 ? ladd3(m, i, d) : NEG;
        if (has_ratio) {
            const T mx = block_max(mg, s_red[3]);
            if (!(mg >= mx - max_ratio)) mg = NEG;
        }
        s_val[a] = mg;
        __syncthreads();
        if (own) {
            int rank = 0;
            for (int j = 0; j < A; ++j) {
                const T w = s_val[j];
                rank += (w > mg) || (w == mg && j < a);
            }
            if (rank < k) {
                const int tn = finite(mg) ? node : -1;
                s_cand[rank] = tn;
#pragma unroll
                for (int c = 0; c < MAX_D; ++c) {
                    if (c >= D) break;
                    int ch = -1;
                    if (tn >= 0 && finite(child_logt[(size_t)tn * D + c]))
                        ch = child_idx[(size_t)tn * D + c];
                    s_cand[k + rank * D + c] = ch;
                }
            }
        }
        __syncthreads();
        // the earliest slot keeps a node; the set is cut to A slots
        int v = -1;
        if (own) {
            const int cv = s_cand[a];
            if (cv >= 0) {
                bool dup = false;
                for (int j = 0; j < a; ++j) dup |= s_cand[j] == cv;
                v = dup ? -1 : cv;
            }
        }
        mapped_step(emission, init_logp, parent_idx, parent_logt, lt, v,
                    codes[(size_t)b * L + p], p == len - 1, n4, D, G, sm, node, m, i, d,
                    rc);
        const int rank = row_rank(a, A, K, node, m, i, d, s_val);
        store_cell((size_t)p * B + b, K, rank, node, m, i, d, o_nodes, o_m, o_i, o_d);
        if (a == 0) o_off[(size_t)p * B + b] = rc.off;
    }
    // padding positions hold the carry and store its row again
    const int rank = row_rank(a, A, K, node, m, i, d, s_val);
    for (int p = max(W, len); p < L; ++p) {
        store_cell((size_t)p * B + b, K, rank, node, m, i, d, o_nodes, o_m, o_i, o_d);
        if (a == 0) o_off[(size_t)p * B + b] = rc.off;
    }
    if (a == 0) o_e[b] = rc.e + rc.off;
}

template <typename T, typename S>
int launch_dense(const void* const* p, void* scratch, int B, int L, int n, int A, int K,
                 int W, int D, int G, cudaStream_t stream) {
    adaptive_dense<T, S><<<B, a1_threads<T>(), 0, stream>>>(
        (const int*)p[0], (const T*)p[1], (const int*)p[2], (const T*)p[3],
        (const T*)p[4], (const int*)p[5], (const int*)p[6], (T*)scratch, (int*)p[7],
        (S*)p[8], (S*)p[9], (S*)p[10], (T*)p[11], (T*)p[12], (int*)p[13], (T*)p[14],
        (T*)p[15], (T*)p[16], (T*)p[17], B, L, n, A, K, W, D, G);
    return (int)cudaGetLastError();
}

template <typename T, typename S>
int launch_frontier(const void* const* p, int B, int L, int A, int K, int W, int D, int G,
                    int n_top, int has_ratio, double max_ratio, cudaStream_t stream) {
    adaptive_frontier<T, S><<<B, threads_for(A), 0, stream>>>(
        (const int*)p[0], (const T*)p[1], (const int*)p[2], (const T*)p[3],
        (const int*)p[4], (const T*)p[5], (const T*)p[6], (const int*)p[7],
        (const int*)p[8], (const int*)p[9], (const T*)p[10], (const T*)p[11],
        (const T*)p[12], (const T*)p[13], (int*)p[14], (S*)p[15], (S*)p[16], (S*)p[17],
        (T*)p[18], (T*)p[19], B, L, A, K, W, D, G, n_top, has_ratio, (T)max_ratio);
    return (int)cudaGetLastError();
}

}  // namespace

// A1: (dtype, store dtype; model: emission, init_logp, parent_idx,
// parent_logt, lt[13]; codes [B, L], lens [B]; scratch [B, 7, n]; out:
// nodes, m, i, d [L, B, K] (rows 0..W-1), off [L, B], e [B]; the carry:
// nodes, m, i, d [B, A], scalars [B, 5] (mb, ib, e, off, off_c); B, L, n, A,
// K, W, D, n_max_gaps, stream) -> cudaError_t.  dtype 0 = float32, 1 =
// float64; the store dtype is the same or 2 = bfloat16.
extern "C" int dbg_adaptive_dense(int dtype, int sdtype, const void* emission,
                                  const void* init_logp, const void* parent_idx,
                                  const void* parent_logt, const void* lt,
                                  const void* codes, const void* lens, void* scratch,
                                  void* o_nodes, void* o_m, void* o_i, void* o_d,
                                  void* o_off, void* o_e, void* c_nodes, void* c_m,
                                  void* c_i, void* c_d, void* c_s, int B, int L, int n,
                                  int A, int K, int W, int D, int n_max_gaps,
                                  void* stream) {
    if (B < 0 || L < 0 || n < 1 || A < 1 || A > MAX_CELLS || A > n || K < 1 || K > A ||
        W < 0 || W > L || D < 1 || D > MAX_D || n_max_gaps < 0 || n_max_gaps > MAX_GAPS)
        return (int)cudaErrorInvalidValue;
    if (B == 0) return 0;
    const void* p[] = {emission, init_logp, parent_idx, parent_logt, lt,  codes,
                       lens,     o_nodes,   o_m,        o_i,         o_d, o_off,
                       o_e,      c_nodes,   c_m,        c_i,         c_d, c_s};
    cudaStream_t st = (cudaStream_t)stream;
#define DBG_DENSE(T, S) return launch_dense<T, S>(p, scratch, B, L, n, A, K, W, D, n_max_gaps, st)
    if (dtype == F32 && sdtype == F32) DBG_DENSE(float, float);
    if (dtype == F32 && sdtype == BF16) DBG_DENSE(float, __nv_bfloat16);
    if (dtype == F64 && sdtype == F64) DBG_DENSE(double, double);
    if (dtype == F64 && sdtype == BF16) DBG_DENSE(double, __nv_bfloat16);
#undef DBG_DENSE
    return (int)cudaErrorInvalidValue;
}

// A2: (dtype, store dtype; model: emission, init_logp, parent_idx,
// parent_logt, child_idx, child_logt, lt[13]; codes [B, L], lens [B]; A1's
// carry: nodes, m, i, d [B, A], scalars [B, 5]; out: nodes, m, i, d
// [L, B, K] (rows W..L-1), off [L, B], e [B]; B, L, A, K, W, D, n_max_gaps,
// n_top, has_ratio, max_ratio, stream) -> cudaError_t.
extern "C" int dbg_adaptive_frontier(int dtype, int sdtype, const void* emission,
                                     const void* init_logp, const void* parent_idx,
                                     const void* parent_logt, const void* child_idx,
                                     const void* child_logt, const void* lt,
                                     const void* codes, const void* lens,
                                     const void* c_nodes, const void* c_m,
                                     const void* c_i, const void* c_d, const void* c_s,
                                     void* o_nodes, void* o_m, void* o_i, void* o_d,
                                     void* o_off, void* o_e, int B, int L, int A, int K,
                                     int W, int D, int n_max_gaps, int n_top,
                                     int has_ratio, double max_ratio, void* stream) {
    if (B < 0 || L < 0 || A < 1 || A > MAX_CELLS || K < 1 || K > A || W < 0 || W > L ||
        D < 1 || D > MAX_D || n_max_gaps < 0 || n_max_gaps > MAX_GAPS || n_top < 1)
        return (int)cudaErrorInvalidValue;
    if (B == 0) return 0;
    const void* p[] = {emission, init_logp, parent_idx, parent_logt, child_idx,
                       child_logt, lt,      codes,      lens,        c_nodes,
                       c_m,      c_i,       c_d,        c_s,         o_nodes,
                       o_m,      o_i,       o_d,        o_off,       o_e};
    cudaStream_t st = (cudaStream_t)stream;
#define DBG_FRONTIER(T, S) \
    return launch_frontier<T, S>(p, B, L, A, K, W, D, n_max_gaps, n_top, has_ratio, max_ratio, st)
    if (dtype == F32 && sdtype == F32) DBG_FRONTIER(float, float);
    if (dtype == F32 && sdtype == BF16) DBG_FRONTIER(float, __nv_bfloat16);
    if (dtype == F64 && sdtype == F64) DBG_FRONTIER(double, double);
    if (dtype == F64 && sdtype == BF16) DBG_FRONTIER(double, __nv_bfloat16);
#undef DBG_FRONTIER
    return (int)cudaErrorInvalidValue;
}

extern "C" const char* dbg_cuda_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
