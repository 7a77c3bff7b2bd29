// Shared pieces of the mapped candidate scorers: K1 and K2
// (log_scorer<RW, RENORM> in mapped_scorer.cu) and K3 (linear_scorer<RW> in
// mapped_scorer_linear.cu).  All three have one design and one launcher:
//
//   * Grid (ceil(C / G), B): a block scores G candidate rows of one read b.
//     A row is RW = 1, 2 or 4 warps (A <= 32, 64, 128 slots); thread x of a
//     row owns slot x.  Rows exchange per-slot values through Row<RW>: a
//     __shfl_sync where the row is one warp, a shared row and a named
//     barrier of the row's own where it is more (never a block barrier).
//   * Streams: TP read positions at a time are copied into shared memory by
//     16-byte cp.async, double-buffered, and shared by the block's G rows
//     (walk_read).  The block meets once per TP positions: every row of a
//     block scores the same read, so all rows reach the barrier together.
//     A stream row carries the position's live degree columns (1..D), so a
//     kernel runs each position specialised on it.
//   * Each row's eff table is staged once per block over the first NCL
//     compact ids (the live columns, ops/mapped_scorer.py:live_columns),
//     plus one entry for copy number 0 that serves every id at or past NCL,
//     the sentinel among them.
//   * The host picks G and TP from the resident blocks per SM that the
//     runtime reports for each (scorer_blocks_per_sm).
//
// Dynamic shared memory of one block, in floats, each part 16-byte aligned
// (scorer_smem): G eff tables of NCL + 1 entries; for RW > 1 the rows'
// exchange buffers (4 x AP each) and reduction slots (3 x RW each); 32
// constants; 2 x TP stream rows.

#pragma once

#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr float NEGF = -1e30f;   // finite log(0) sentinel (TPU kernel's NEGF)
constexpr float LOW = -3.0e38f;  // below any real value, for masked maxima
constexpr int DMAX = 5;          // widest degree bucket of the PHMM template
constexpr int MAX_ROWS = 8;      // candidate rows per block, at most

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
        v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
    return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
        v += __shfl_xor_sync(FULL, v, o);
    return v;
}

struct Streams {
    const int* codes;  // [L, B]
    const int* emis;   // [L, B, A]
    const int* numce;  // [L, B, A]
    const int* selfp;  // [L, B, A]
    const int* prevp;  // [L, D, B, A]
    const int* curp;   // [L, D, B, A]
    const int* dence;  // [L, D, B, A]
};

// Exchange of per-slot values within one candidate row.  RW == 1: the row
// is one warp and a gather is a shuffle from the owning lane.  RW > 1: the
// row's warps publish into a shared row (two phases, two values each) and
// meet at the row's named barrier.  Every lane of the row calls put / get.
template <int RW>
struct Row {
    static constexpr int AP = 32 * RW;
    float* xb;   // RW > 1: 2 phases x 2 values x AP floats
    float* red;  // RW > 1: 3 x RW floats (two maxima, one sum)
    int bar;     // named barrier id of the row (1 + row index)
    int a;       // the slot this thread owns
    int phase;
    float v0, v1;

    __device__ __forceinline__ void sync() const {
        if (RW > 1)
            asm volatile("bar.sync %0, %1;" ::"r"(bar), "r"(AP) : "memory");
    }
    __device__ __forceinline__ void put(float x0, float x1) {
        if (RW == 1) {
            v0 = x0;
            v1 = x1;
        } else {
            phase ^= 1;
            float* p = xb + phase * 2 * AP;
            p[a] = x0;
            p[AP + a] = x1;
            sync();
        }
    }
    // value `which` of slot idx; `none` where idx < 0 (no such slot)
    __device__ __forceinline__ float get(int which, int idx, float none) const {
        if (RW == 1) {
            const float r = __shfl_sync(FULL, which ? v1 : v0, idx & 31);
            return idx >= 0 ? r : none;
        }
        return idx >= 0 ? xb[phase * 2 * AP + which * AP + idx] : none;
    }
    // `area` 0 and 1 are two separate maxima, so that one may follow the
    // other with no barrier in between (K1: the renormalisation, then the
    // end state)
    __device__ __forceinline__ float reduce_max(float v, int area) const {
        v = warp_max(v);
        if (RW == 1) return v;
        float* r_ = red + area * RW;
        if ((a & 31) == 0) r_[a >> 5] = v;
        sync();
        float r = r_[0];
#pragma unroll
        for (int w = 1; w < RW; ++w) r = fmaxf(r, r_[w]);
        return r;
    }
    __device__ __forceinline__ float reduce_sum(float v) const {
        v = warp_sum(v);
        if (RW == 1) return v;
        if ((a & 31) == 0) red[2 * RW + (a >> 5)] = v;
        sync();
        float r = 0.f;
#pragma unroll
        for (int w = 0; w < RW; ++w) r += red[2 * RW + w];
        return r;
    }
};

// Shared memory of one block, in floats / ints, each part 16-byte aligned.
struct ScorerSmem {
    int tab, tab_row, xb, red, consts, streams, total;
};

// Ints of one staged stream row: [emis | numce | selfp | prevp x D |
// curp x D | dence x D] each A wide, then the read base and the position's
// live degree columns; padded to 16 bytes.
__host__ __device__ __forceinline__ int stream_row(int A, int D) {
    return ((3 + 3 * D) * A + 2 + 3) & ~3;
}

__host__ __device__ __forceinline__ ScorerSmem scorer_smem(int NCL, int A,
                                                           int D, int G,
                                                           int TP, int RW) {
    ScorerSmem m;
    m.tab_row = (NCL + 1 + 3) & ~3;
    m.tab = 0;
    m.xb = m.tab + G * m.tab_row;
    m.red = m.xb + (RW > 1 ? G * 4 * 32 * RW : 0);
    m.consts = m.red + (RW > 1 ? ((G * 3 * RW + 3) & ~3) : 0);
    m.streams = m.consts + 32;
    m.total = m.streams + 2 * TP * stream_row(A, D);
    return m;
}

// Warps of one candidate row.
__host__ __device__ __forceinline__ int row_warps(int A) {
    return A <= 32 ? 1 : (A <= 64 ? 2 : 4);
}

// Row<RW> of row g, slot a, over the block's shared memory.
template <int RW>
__device__ __forceinline__ Row<RW> row_at(float* smem, const ScorerSmem& L,
                                          int g, int a) {
    Row<RW> row;
    row.xb = smem + L.xb + g * 4 * 32 * RW;
    row.red = smem + L.red + g * 3 * RW;
    row.bar = 1 + g;
    row.a = a;
    row.phase = 0;
    return row;
}

// Copy positions [t0, t0 + n) of read b into dst (n stream rows), 16 bytes
// per cp.async for the slot segments (A % 4 == 0), 4 for the two scalars.
__device__ __forceinline__ void stage_streams(int* dst, const Streams& s,
                                              const int* ncols, int t0, int n,
                                              int b, int B, int A, int D,
                                              int tid, int nthreads) {
    const int nseg = 3 + 3 * D, q = A >> 2, per_pos = nseg * q;
    const int srow = stream_row(A, D);
    for (int k = tid; k < n * per_pos; k += nthreads) {
        const int p = k / per_pos, r = k - p * per_pos;
        const int seg = r / q, j = r - seg * q;
        const size_t t = (size_t)(t0 + p);
        const int* src;
        if (seg < 3) {
            const int* base = seg == 0 ? s.emis : (seg == 1 ? s.numce : s.selfp);
            src = base + (t * B + b) * A;
        } else {
            const int kind = (seg - 3) / D, d = (seg - 3) - kind * D;
            const int* base = kind == 0 ? s.prevp : (kind == 1 ? s.curp : s.dence);
            src = base + ((t * D + d) * B + b) * A;
        }
        __pipeline_memcpy_async(dst + p * srow + seg * A + 4 * j, src + 4 * j, 16);
    }
    for (int k = tid; k < 2 * n; k += nthreads) {
        const int p = k >> 1;
        const int* src = (k & 1 ? ncols : s.codes) + (size_t)(t0 + p) * B + b;
        __pipeline_memcpy_async(dst + p * srow + nseg * A + (k & 1), src, 4);
    }
    __pipeline_commit();
}

// A count of live degree columns as a type: step<N> is compiled once per N.
template <int N>
struct Cols {
    static constexpr int value = N;
};

// Walk positions [0, len) of read b: chunk 0 must have been staged (into
// s_str) by every thread of the block before, with a block barrier after it
// and before this call or in it.  For each position, in order, calls
// step(Cols<N>{}, stream row, t) with N = 1, 2, 3 live degree columns, or
// DMAX for more (a step then reads the first D).  srow = stream_row(A, D)
// and nseg = 3 + 3 * D come from the caller, computed at the kernel's top:
// where they are computed changes ptxas's register allocation, and with it
// K1's time, measurably.
template <class Step>
__device__ __forceinline__ void walk_read(int* s_str, const Streams& s,
                                          const int* ncols, int len, int TP,
                                          int srow, int nseg, int b, int B,
                                          int A, int D, Step&& step) {
    const int tid = threadIdx.x, nthreads = blockDim.x;
    const int nch = (len + TP - 1) / TP;
    for (int ch = 0; ch < nch; ++ch) {
        __pipeline_wait_prior(0);
        __syncthreads();  // chunk ch visible; every row is done with ch - 1
        if (ch + 1 < nch)
            stage_streams(s_str + ((ch + 1) & 1) * TP * srow, s, ncols,
                          (ch + 1) * TP, min(TP, len - (ch + 1) * TP), b, B, A,
                          D, tid, nthreads);
        const int* buf = s_str + (ch & 1) * TP * srow;
        const int np = min(TP, len - ch * TP);
        for (int p = 0; p < np; ++p) {
            const int* sr = buf + p * srow;
            const int t = ch * TP + p;
            // the same for every row of the block (one read): no divergence
            switch (sr[nseg * A + 1]) {
                case 1: step(Cols<1>{}, sr, t); break;
                case 2: step(Cols<2>{}, sr, t); break;
                case 3: step(Cols<3>{}, sr, t); break;
                default: step(Cols<DMAX>{}, sr, t);
            }
        }
    }
}

// Every scorer kernel's parameters: eff [C, NC], the per-candidate inverse
// total [C] (log for K1 / K2, linear for K3), lens [B], the streams, ncols
// [L, B] (live degree columns per position), lt_lin [13] (linear probs,
// LinTrans order), out [C, B], then C, NC, NCL, B, A, D, n_max_gaps, TP.
typedef void (*ScorerKernel)(const float*, const float*, const int*, Streams,
                             const int*, const float*, float*, int, int, int,
                             int, int, int, int, int);

inline size_t scorer_smem_bytes(int NCL, int A, int D, int G, int TP) {
    return (size_t)scorer_smem(NCL, A, D, G, TP, row_warps(A)).total * 4;
}

inline bool scorer_shape_ok(int NCL, int A, int D, int G, int TP) {
    return D >= 1 && D <= DMAX && A >= 1 && A <= 128 && (A & 3) == 0 &&
           G >= 1 && G <= MAX_ROWS && TP >= 1 && NCL >= 1;
}

// Resident blocks per SM of `kernel` at one launch configuration (0 if it
// cannot run).
inline int scorer_blocks_per_sm(ScorerKernel kernel, int NCL, int A, int D,
                                int G, int TP) {
    if (!scorer_shape_ok(NCL, A, D, G, TP)) return 0;
    const size_t smem = scorer_smem_bytes(NCL, A, D, G, TP);
    if (cudaFuncSetAttribute((const void*)kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem) != cudaSuccess) {
        cudaGetLastError();
        return 0;
    }
    int n = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &n, (const void*)kernel, 32 * row_warps(A) * G, smem) != cudaSuccess) {
        cudaGetLastError();
        return 0;
    }
    return n;
}

// Launch `kernel` on `stream`: grid (ceil(C / G), B), G rows of
// 32 * row_warps(A) threads.  eff columns from NCL on (the sentinel NC - 1
// among them) must be 0.  Returns the cudaError_t of the launch (0 =
// success).
inline int scorer_launch(ScorerKernel kernel, const float* eff,
                         const float* inv, const int* lens, const Streams& s,
                         const int* ncols, const float* lt_lin, float* out,
                         int C, int NC, int NCL, int B, int A, int D,
                         int n_max_gaps, int G, int TP, void* stream) {
    if (C <= 0 || B <= 0) return 0;
    if (!scorer_shape_ok(NCL, A, D, G, TP) || NCL >= NC)
        return (int)cudaErrorInvalidValue;
    const size_t smem = scorer_smem_bytes(NCL, A, D, G, TP);
    cudaError_t err = cudaFuncSetAttribute(
        (const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<dim3((C + G - 1) / G, B), dim3(32 * row_warps(A) * G), smem,
             (cudaStream_t)stream>>>(eff, inv, lens, s, ncols, lt_lin, out, C,
                                     NC, NCL, B, A, D, n_max_gaps, TP);
    return (int)cudaGetLastError();
}

}  // namespace

// The C entry of every scorer: (eff, inv, lens, codes, emis, numce, selfp,
// prevp, curp, dence, ncols, lt_lin, out, C, NC, NCL, L, B, A, D,
// n_max_gaps, G, TP, stream) -> cudaError_t, and its occupancy entry
// <name>_blocks_per_sm(NCL, A, D, G, TP).
#define DBG_SCORER_ENTRIES(name, kernel_of)                                     \
    extern "C" int name(const float* eff, const float* inv, const int* lens,   \
                        const int* codes, const int* emis, const int* numce,   \
                        const int* selfp, const int* prevp, const int* curp,   \
                        const int* dence, const int* ncols,                    \
                        const float* lt_lin, float* out, int C, int NC,        \
                        int NCL, int L, int B, int A, int D, int n_max_gaps,   \
                        int G, int TP, void* stream) {                         \
        (void)L;                                                               \
        Streams s{codes, emis, numce, selfp, prevp, curp, dence};              \
        return scorer_launch(kernel_of(A), eff, inv, lens, s, ncols, lt_lin,   \
                             out, C, NC, NCL, B, A, D, n_max_gaps, G, TP,      \
                             stream);                                          \
    }                                                                          \
    extern "C" int name##_blocks_per_sm(int NCL, int A, int D, int G,          \
                                        int TP) {                              \
        return scorer_blocks_per_sm(kernel_of(A), NCL, A, D, G, TP);           \
    }
