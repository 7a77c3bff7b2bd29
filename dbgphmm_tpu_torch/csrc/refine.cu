// The hint-constrained refine's two device scans (R1, R2) for NVIDIA Hopper
// (sm_90a).
//
// R1, dbg_refine_forward, replaces the lax.scan of
// dbgphmm_tpu/ops/adaptive.py:631 (forward_mapped_tables, step
// _s_step_attrs :173): the mapping-constrained forward over a hint's
// per-position active sets [B, L, A] (-1 pads, A <= 256), renormalised at
// every position, storing its tables nodes / m / i / d [L, B, A], the
// Kahan-summed offset [L, B] and the read log-likelihood e [B].  At a
// padding position (p >= len) the stored row is the carry, as in the scan.
//
// R2, dbg_refine_decode, replaces the lax.scan of
// dbgphmm_tpu/ops/adaptive.py:533 (_decode_mappings_from_forward, step
// _b_step_sparse :389): the backward restricted to the stored forward's
// cells (R1's tables, or the sparse-adaptive forward's, which may be
// bfloat16 with K <= A cells), and per step t the posterior
// S = exp(fm+bm+scale) + exp(fi+bi+scale) + exp(fd+bd+scale) over the cells
// of read position i_f = len - 2 - t, its log (below the type's smallest
// normal number: -inf), its top k in the stable descending order
// (ties and -inf to the lower slot first) and the score-ratio mask:
// tops_logp / tops_nodes [L, B, k].  The last read position, the scatter
// into read order and the output buffers stay in PyTorch
// (ops/adaptive.py: _decode_finish).
//
// Both compute in the model's type (float32 on the card; float64 lets a
// check hold them to their plain versions to 1e-9) and keep what the plain
// versions keep, with refine_common.cuh's arithmetic (-inf is a true -inf,
// ladd is torch.logaddexp, a log-sum-exp over the parent (child) columns
// adds its exps in PyTorch's order).
//
// Design (what bounds it, and what each choice answers).
//   * Work: a read's positions form one chain: every step needs the
//     previous step's tables, and within a step the deletion closure is
//     n_max_gaps dependent rounds over the current set.  So one block walks
//     one read (grid = B), one thread per slot (R2: two per thread above
//     256 cells), the sequential position loop inside the block.
//   * Slot lookups ("which slot of the other set holds node u") are
//     searches of the other set's node ids in shared memory (16-byte
//     vector reads), once per step and column; every later lookup of that
//     step is one shared-memory read.  A node that appears twice in a set
//     takes the maximum over its slots, as the plain version's match does.
//   * The carried and the current set (node ids, the looked-up values)
//     live in shared memory, the slot's own state in registers; the
//     model's attributes are read through L2.  The next position's hint
//     (R1) or stored node ids (R2) are loaded one step ahead.
//   * What bounds it: with 98-160 reads a chunk has fewer blocks than the
//     card has SMs (132), and each position is a chain of ~n_max_gaps + 5
//     block barriers with a few dependent transcendentals between them.
//     The chain's latency over ~10,000 positions, not bytes (each input
//     read once, ~1 GB for a data/bench chunk) or exp/log throughput, sets
//     the time.  Several reads per block, warps per read and asynchronous
//     staging of the next positions are left to a later version.
//
// Build (done by dbgphmm_tpu_torch/ops/_build.py at first use):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o librefine.so refine.cu

#include "refine_common.cuh"

namespace {

constexpr int NT = 256;  // threads per block at most

// ---------------------------------------------------------------- R1 ------

template <typename T>
__global__ void __launch_bounds__(NT, 1) refine_forward(
    const int* __restrict__ emission, const T* __restrict__ init_logp,
    const int* __restrict__ parent_idx, const T* __restrict__ parent_logt,
    const T* __restrict__ lt_v, const int* __restrict__ codes,
    const int* __restrict__ lens, const int* __restrict__ hint,
    int* __restrict__ o_nodes, T* __restrict__ o_m, T* __restrict__ o_i,
    T* __restrict__ o_d, T* __restrict__ o_off, T* __restrict__ o_e, int B,
    int L, int A, int D, int G) {
    __shared__ __align__(16) int s_prev[NT];  // previous set's node ids
    __shared__ __align__(16) int s_cur[NT];   // current set's node ids
    __shared__ T s_pm[NT], s_pi[NT];          // pre-M / pre-I of the previous set
    __shared__ T s_f[2][NT];                  // deletion closure, double-buffered
    __shared__ T s_red[3][NT / 32];
    const StepSmem<T> sm{s_prev, s_cur, s_pm, s_pi, {s_f[0], s_f[1]},
                         {s_red[0], s_red[1], s_red[2]}};

    const T NEG = ninf<T>();
    const Trans<T> lt(lt_v);
    const int b = blockIdx.x, a = threadIdx.x;
    const bool own = a < A;
    const int n4 = (A + 3) & ~3;
    const int len = min(max(lens[b], 0), L);
    const int* hint_b = hint + (size_t)b * L * A;

    // the carry (ops/sparse.py:_s_init): no slot, Begin-match 0
    int node = -1;
    T m = NEG, i = NEG, d = NEG;
    ReadCarry<T> rc{0, NEG, NEG, 0, 0};

    int v_next = (own && len > 0) ? hint_b[a] : -1;
    for (int p = 0; p < len; ++p) {
        const int v = v_next;
        if (own && p + 1 < len) v_next = hint_b[(size_t)(p + 1) * A + a];
        mapped_step(emission, init_logp, parent_idx, parent_logt, lt, v,
                    codes[(size_t)b * L + p], p == len - 1, n4, D, G, sm, node, m, i, d,
                    rc);
        if (own) {
            const size_t o = ((size_t)p * B + b) * A + a;
            o_nodes[o] = node;
            o_m[o] = m;
            o_i[o] = i;
            o_d[o] = d;
        }
        if (a == 0) o_off[(size_t)p * B + b] = rc.off;
    }
    // padding positions store the carry
    for (int p = len; p < L; ++p) {
        if (own) {
            const size_t o = ((size_t)p * B + b) * A + a;
            o_nodes[o] = node;
            o_m[o] = m;
            o_i[o] = i;
            o_d[o] = d;
        }
        if (a == 0) o_off[(size_t)p * B + b] = rc.off;
    }
    if (a == 0) o_e[b] = rc.e + rc.off;
}

// ---------------------------------------------------------------- R2 ------

template <typename T, typename S, int SPT>
__global__ void __launch_bounds__(NT, 1) refine_decode(
    const int* __restrict__ emission, const int* __restrict__ child_idx,
    const T* __restrict__ child_logt, const T* __restrict__ lt_v,
    const int* __restrict__ codes, const int* __restrict__ lens,
    const int* __restrict__ f_nodes, const S* __restrict__ f_m,
    const S* __restrict__ f_i, const S* __restrict__ f_d,
    const T* __restrict__ f_off, const T* __restrict__ f_e,
    T* __restrict__ tops_logp, int* __restrict__ tops_nodes, int B, int L,
    int K, int k, int D, int G, int has_ratio, T max_ratio) {
    constexpr int NS = NT * SPT;
    __shared__ __align__(16) int s_bn[NS];  // the backward carry's node ids
    __shared__ __align__(16) int s_cn[NS];  // the forward's cells at i_f
    __shared__ T s_bm[NS];                  // carried backward M
    __shared__ T s_bi[NS];                  // carried backward I, then D
    __shared__ T s_f[2][NS];                // deletion closure, then log S
    __shared__ T s_red[NT / 32];

    const T NEG = ninf<T>();
    const Trans<T> lt(lt_v);
    const int b = blockIdx.x, nth = blockDim.x;
    const int n4 = (K + 3) & ~3;
    const int len = min(max(lens[b], 0), L);
    const T logp = f_e[b];
    auto cell = [&](int pos, int a) { return ((size_t)pos * B + b) * K + a; };

    // the carry: the forward's cells at the read's last position, B = p_end
    int node[SPT];
    T m[SPT], i[SPT], d[SPT];
    const int last = min(max(len - 1, 0), L - 1);
#pragma unroll
    for (int s = 0; s < SPT; ++s) {
        const int a = threadIdx.x + s * nth;
        node[s] = a < K ? f_nodes[cell(last, a)] : -1;
        m[s] = i[s] = d[s] = node[s] >= 0 ? lt.end : NEG;
    }
    T off = 0, off_c = 0;

    // steps t = 0 .. len - 2 hold read positions i_f = len - 2 - t; from
    // t = len - 1 on, scale = -inf and every row is -inf / -1
    int cur_next[SPT];
#pragma unroll
    for (int s = 0; s < SPT; ++s) {
        const int a = threadIdx.x + s * nth;
        cur_next[s] = (len >= 2 && a < K) ? f_nodes[cell(len - 2, a)] : -1;
    }
    for (int t = 0; t + 1 < len; ++t) {
        const int im = len - 1 - t;  // the merged index this step produces
        const int i_f = im - 1;
        const int x = codes[(size_t)b * L + im];
        int cur[SPT];
        T fm[SPT], fi[SPT], fd[SPT];
#pragma unroll
        for (int s = 0; s < SPT; ++s) {
            const int a = threadIdx.x + s * nth;
            cur[s] = cur_next[s];
            if (a < K && i_f >= 1) cur_next[s] = f_nodes[cell(i_f - 1, a)];
            fm[s] = fi[s] = fd[s] = NEG;
            if (a < K) {
                fm[s] = to_t<T>(f_m[cell(i_f, a)]);
                fi[s] = to_t<T>(f_i[cell(i_f, a)]);
                fd[s] = to_t<T>(f_d[cell(i_f, a)]);
            }
            s_bn[a] = node[s];
            s_bm[a] = m[s];
            s_bi[a] = i[s];
            s_cn[a] = cur[s];
        }
        const T foff = f_off[(size_t)i_f * B + b];
        __syncthreads();

        // backward D from the children: in the carry (M), by insertion (I)
        int cidx[SPT][MAX_D], cslot[SPT][MAX_D];
        T clogt[SPT][MAX_D], bm[SPT][MAX_D], pe[SPT][MAX_D];
        T bi_self[SPT], d_new[SPT];
#pragma unroll
        for (int s = 0; s < SPT; ++s) {
            const int v = cur[s];
            const int a = threadIdx.x + s * nth;
            T t0[MAX_D];
#pragma unroll
            for (int c = 0; c < MAX_D; ++c) {
                cidx[s][c] = -1;
                cslot[s][c] = -1;
                clogt[s][c] = NEG;
                bm[s][c] = NEG;
                pe[s][c] = NEG;
                t0[c] = NEG;
                if (v >= 0 && c < D) {
                    clogt[s][c] = child_logt[(size_t)v * D + c];
                    if (clogt[s][c] != NEG) {
                        const int u = child_idx[(size_t)v * D + c];
                        cidx[s][c] = u;
                        pe[s][c] = emission[u] == x ? lt.match : lt.mismatch;
                        bm[s][c] = lookup(s_bm, s_bn, n4, u, find_slot(s_bn, n4, u));
                        cslot[s][c] = find_slot(s_cn, n4, u);
                        t0[c] = ((clogt[s][c] + lt.DM) + pe[s][c]) + bm[s][c];
                    }
                }
            }
            bi_self[s] = NEG;
            d_new[s] = NEG;
            if (v >= 0) {
                bi_self[s] = lookup(s_bi, s_bn, n4, v, find_slot(s_bn, n4, v));
                d_new[s] = ladd(lse(t0, D), (lt.DI + lt.random) + bi_self[s]);
            }
            s_f[0][a] = d_new[s];
        }
        __syncthreads();
        int src = 0;
        for (int r = 0; r < G; ++r) {
            T bdt[SPT];
#pragma unroll
            for (int s = 0; s < SPT; ++s) {
                bdt[s] = NEG;
                if (cur[s] >= 0) {
                    T t1[MAX_D];
#pragma unroll
                    for (int c = 0; c < MAX_D; ++c)
                        t1[c] = cslot[s][c] < 0
                                    ? NEG
                                    : (clogt[s][c] + lt.DD) +
                                          lookup(s_f[src], s_cn, n4, cidx[s][c], cslot[s][c]);
                    bdt[s] = lse(t1, D);
                    d_new[s] = ladd(d_new[s], bdt[s]);
                }
            }
            if (r + 1 < G) {
#pragma unroll
                for (int s = 0; s < SPT; ++s) s_f[src ^ 1][threadIdx.x + s * nth] = bdt[s];
                __syncthreads();
                src ^= 1;
            }
        }
#pragma unroll
        for (int s = 0; s < SPT; ++s) s_bi[threadIdx.x + s * nth] = d_new[s];
        __syncthreads();

        // backward M and I through the children's D in the current set
        T m_new[SPT], i_new[SPT];
        T mx = NEG;
#pragma unroll
        for (int s = 0; s < SPT; ++s) {
            m_new[s] = i_new[s] = NEG;
            if (cur[s] >= 0) {
                T tm[MAX_D], ti[MAX_D];
#pragma unroll
                for (int c = 0; c < MAX_D; ++c) {
                    tm[c] = ti[c] = NEG;
                    if (clogt[s][c] != NEG) {
                        const T bdc = lookup(s_bi, s_cn, n4, cidx[s][c], cslot[s][c]);
                        tm[c] = clogt[s][c] +
                                ladd((lt.MM + pe[s][c]) + bm[s][c], lt.MD + bdc);
                        ti[c] = clogt[s][c] +
                                ladd((lt.IM + pe[s][c]) + bm[s][c], lt.ID + bdc);
                    }
                }
                m_new[s] = ladd(lse(tm, D), (lt.MI + lt.random) + bi_self[s]);
                i_new[s] = ladd(lse(ti, D), (lt.II + lt.random) + bi_self[s]);
            } else {
                d_new[s] = NEG;
            }
            mx = vmax(mx, m_new[s]);
        }
        mx = block_max(mx, s_red);
        const T shift = mx == NEG ? T(0) : mx;
        kahan(off, off_c, shift);

        // S = F * B / P on these cells, its log, then the stable top k
        const T scale = (foff + off) - logp;
        T lv[SPT];
#pragma unroll
        for (int s = 0; s < SPT; ++s) {
            const int a = threadIdx.x + s * nth;
            m[s] = m_new[s] - shift;
            i[s] = i_new[s] - shift;
            d[s] = d_new[s] - shift;
            node[s] = cur[s];
            const T sl = (Num<T>::ex((fm[s] + m[s]) + scale) +
                          Num<T>::ex((fi[s] + i[s]) + scale)) +
                         Num<T>::ex((fd[s] + d[s]) + scale);
            lv[s] = sl >= Num<T>::tiny() ? Num<T>::lg(vmax(sl, Num<T>::log_floor())) : NEG;
            s_f[0][a] = lv[s];
        }
        __syncthreads();
#pragma unroll
        for (int s = 0; s < SPT; ++s) {
            const int a = threadIdx.x + s * nth;
            if (a >= K) continue;
            const T v = lv[s];
            T top = NEG;
            int rank = 0;
            for (int j = 0; j < K; ++j) {
                const T w = s_f[0][j];
                top = vmax(top, w);
                rank += (w > v) || (w == v && j < a);
            }
            if (rank < k) {
                T out = v;
                int nid = finite(v) ? cur[s] : -1;
                if (has_ratio && !(finite(v) && v >= top - max_ratio)) {
                    out = NEG;
                    nid = -1;
                }
                const size_t o = ((size_t)t * B + b) * k + rank;
                tops_logp[o] = out;
                tops_nodes[o] = nid;
            }
        }
    }
    // rows without a read position: -inf / -1
    for (int t = max(len - 1, 0); t < L; ++t)
        for (int r = threadIdx.x; r < k; r += nth) {
            const size_t o = ((size_t)t * B + b) * k + r;
            tops_logp[o] = NEG;
            tops_nodes[o] = -1;
        }
}

template <typename T>
int launch_forward(const void* emission, const void* init_logp, const void* parent_idx,
                   const void* parent_logt, const void* lt, const void* codes,
                   const void* lens, const void* hint, void* o_nodes, void* o_m,
                   void* o_i, void* o_d, void* o_off, void* o_e, int B, int L, int A,
                   int D, int G, cudaStream_t stream) {
    refine_forward<T><<<B, threads_for(A), 0, stream>>>(
        (const int*)emission, (const T*)init_logp, (const int*)parent_idx,
        (const T*)parent_logt, (const T*)lt, (const int*)codes, (const int*)lens,
        (const int*)hint, (int*)o_nodes, (T*)o_m, (T*)o_i, (T*)o_d, (T*)o_off,
        (T*)o_e, B, L, A, D, G);
    return (int)cudaGetLastError();
}

template <typename T, typename S, int SPT>
int launch_decode_spt(const void* emission, const void* child_idx, const void* child_logt,
                      const void* lt, const void* codes, const void* lens,
                      const void* f_nodes, const void* f_m, const void* f_i,
                      const void* f_d, const void* f_off, const void* f_e, void* tops_logp,
                      void* tops_nodes, int B, int L, int K, int k, int D, int G,
                      int has_ratio, double max_ratio, cudaStream_t stream) {
    refine_decode<T, S, SPT><<<B, threads_for((K + SPT - 1) / SPT), 0, stream>>>(
        (const int*)emission, (const int*)child_idx, (const T*)child_logt, (const T*)lt,
        (const int*)codes, (const int*)lens, (const int*)f_nodes, (const S*)f_m,
        (const S*)f_i, (const S*)f_d, (const T*)f_off, (const T*)f_e, (T*)tops_logp,
        (int*)tops_nodes, B, L, K, k, D, G, has_ratio, (T)max_ratio);
    return (int)cudaGetLastError();
}

template <typename T, typename S>
int launch_decode(const void* emission, const void* child_idx, const void* child_logt,
                  const void* lt, const void* codes, const void* lens, const void* f_nodes,
                  const void* f_m, const void* f_i, const void* f_d, const void* f_off,
                  const void* f_e, void* tops_logp, void* tops_nodes, int B, int L, int K,
                  int k, int D, int G, int has_ratio, double max_ratio,
                  cudaStream_t stream) {
    if (K <= NT)
        return launch_decode_spt<T, S, 1>(emission, child_idx, child_logt, lt, codes, lens,
                                          f_nodes, f_m, f_i, f_d, f_off, f_e, tops_logp,
                                          tops_nodes, B, L, K, k, D, G, has_ratio,
                                          max_ratio, stream);
    return launch_decode_spt<T, S, 2>(emission, child_idx, child_logt, lt, codes, lens,
                                      f_nodes, f_m, f_i, f_d, f_off, f_e, tops_logp,
                                      tops_nodes, B, L, K, k, D, G, has_ratio, max_ratio,
                                      stream);
}

}  // namespace

// R1: (dtype, model: emission, init_logp, parent_idx, parent_logt, lt[13];
// codes [B, L], lens [B], hint [B, L, A]; out: nodes, m, i, d [L, B, A],
// off [L, B], e [B]; B, L, A, D, n_max_gaps, stream) -> cudaError_t.
// dtype 0 = float32, 1 = float64.
extern "C" int dbg_refine_forward(int dtype, const void* emission, const void* init_logp,
                                  const void* parent_idx, const void* parent_logt,
                                  const void* lt, const void* codes, const void* lens,
                                  const void* hint, void* o_nodes, void* o_m, void* o_i,
                                  void* o_d, void* o_off, void* o_e, int B, int L, int A,
                                  int D, int n_max_gaps, void* stream) {
    if (B < 0 || L < 0 || A < 1 || A > NT || D < 1 || D > MAX_D || n_max_gaps < 0 ||
        n_max_gaps > MAX_GAPS)
        return (int)cudaErrorInvalidValue;
    if (B == 0) return 0;
    cudaStream_t st = (cudaStream_t)stream;
    if (dtype == F32)
        return launch_forward<float>(emission, init_logp, parent_idx, parent_logt, lt, codes,
                                     lens, hint, o_nodes, o_m, o_i, o_d, o_off, o_e, B, L,
                                     A, D, n_max_gaps, st);
    if (dtype == F64)
        return launch_forward<double>(emission, init_logp, parent_idx, parent_logt, lt,
                                      codes, lens, hint, o_nodes, o_m, o_i, o_d, o_off, o_e,
                                      B, L, A, D, n_max_gaps, st);
    return (int)cudaErrorInvalidValue;
}

// R2: (dtype, store dtype, model: emission, child_idx, child_logt, lt[13];
// codes [B, L], lens [B]; the forward's nodes, m, i, d [L, B, K], off
// [L, B], e [B]; out: tops_logp, tops_nodes [L, B, k]; B, L, K, k, D,
// n_max_gaps, has_ratio, max_ratio, stream) -> cudaError_t.  dtype 0 =
// float32, 1 = float64; the store dtype is the same or 2 = bfloat16.
extern "C" int dbg_refine_decode(int dtype, int sdtype, const void* emission,
                                 const void* child_idx, const void* child_logt,
                                 const void* lt, const void* codes, const void* lens,
                                 const void* f_nodes, const void* f_m, const void* f_i,
                                 const void* f_d, const void* f_off, const void* f_e,
                                 void* tops_logp, void* tops_nodes, int B, int L, int K,
                                 int k, int D, int n_max_gaps, int has_ratio,
                                 double max_ratio, void* stream) {
    if (B < 0 || L < 0 || K < 1 || K > 2 * NT || k < 0 || k > K || D < 1 || D > MAX_D ||
        n_max_gaps < 0 || n_max_gaps > MAX_GAPS)
        return (int)cudaErrorInvalidValue;
    if (B == 0) return 0;
    cudaStream_t st = (cudaStream_t)stream;
#define DBG_DECODE(T, S)                                                                  \
    return launch_decode<T, S>(emission, child_idx, child_logt, lt, codes, lens, f_nodes, \
                               f_m, f_i, f_d, f_off, f_e, tops_logp, tops_nodes, B, L, K, \
                               k, D, n_max_gaps, has_ratio, max_ratio, st)
    if (dtype == F32 && sdtype == F32) DBG_DECODE(float, float);
    if (dtype == F32 && sdtype == BF16) DBG_DECODE(float, __nv_bfloat16);
    if (dtype == F64 && sdtype == F64) DBG_DECODE(double, double);
    if (dtype == F64 && sdtype == BF16) DBG_DECODE(double, __nv_bfloat16);
#undef DBG_DECODE
    return (int)cudaErrorInvalidValue;
}

extern "C" const char* dbg_cuda_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
