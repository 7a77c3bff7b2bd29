// Shared pieces of the mapped candidate scorers (K1 and K2 in
// mapped_scorer.cu, K3 in mapped_scorer_linear.cu).  All three use the
// constants, the stream layout (Streams) and the warp reductions.  The rest
// is K3's block design (K1 and K2 have their own, see mapped_scorer.cu):
// the per-position cp.async stream copy, the block-wide row reductions, the
// block's shared-memory layout and the launcher.
//
// K3's block: blockDim.x = AP = max(32, A rounded up to whole warps)
// threads, thread x owns slot x; blockDim.y = G candidates of one read.
// Dynamic shared memory, in this order:
//   eff rows      G x NC floats
//   4 gather rows G x AP floats each (P, Q, X0, X1)
//   reduction     G x (AP / 32) floats
//   constants     16 floats
//   stream rows   2 x srow ints (double-buffered, see issue_stream_copy)

#pragma once

#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float NEGF = -1e30f;   // finite log(0) sentinel (TPU kernel's NEGF)
constexpr float LOW = -3.0e38f;  // below any real value, for masked maxima
constexpr int DMAX = 5;          // widest degree bucket of the PHMM template
// Threads a block may have (AP x G <= 1024).  The kernels declare it in
// __launch_bounds__, so ptxas keeps them to 64 registers a thread and a
// 1,024-thread block (A = 128, 8 candidates) still fits the SM's 65,536.
constexpr int MAX_THREADS = 1024;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

// Reduce v over the candidate row (AP threads = NW warps).  For NW > 1 the
// partials go through red[NW] and a block barrier; every thread of the block
// must call this (uniform control flow).
__device__ __forceinline__ float row_max(float v, float* red, int NW, int lane,
                                         int warp) {
    v = warp_max(v);
    if (NW == 1) return v;
    if (lane == 0) red[warp] = v;
    __syncthreads();
    float r = red[0];
    for (int w = 1; w < NW; ++w) r = fmaxf(r, red[w]);
    return r;
}

__device__ __forceinline__ float row_sum(float v, float* red, int NW, int lane,
                                         int warp) {
    v = warp_sum(v);
    if (NW == 1) return v;
    if (lane == 0) red[warp] = v;
    __syncthreads();
    float r = 0.f;
    for (int w = 0; w < NW; ++w) r += red[w];
    return r;
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

// Ints of one shared stream row, padded to 16 bytes.
__host__ __device__ __forceinline__ int stream_row_ints(int AP, int D) {
    return (((3 + 3 * D) * AP + 1) + 3) & ~3;
}

// Shared stream row of one position: [emis | numce | selfp | prevp x D |
// curp x D | dence x D] each AP wide, then the read base.
__device__ __forceinline__ void issue_stream_copy(int* dst, const Streams& s,
                                                  int t, int b, int B, int A,
                                                  int D, int AP, int tid,
                                                  int nthreads) {
    const int nseg = 3 + 3 * D;
    const int n = nseg * A + 1;
    for (int k = tid; k < n; k += nthreads) {
        const int* src;
        int* d_ptr;
        if (k == nseg * A) {
            src = s.codes + (size_t)t * B + b;
            d_ptr = dst + nseg * AP;
        } else {
            int seg = k / A, a = k - seg * A;
            d_ptr = dst + seg * AP + a;
            if (seg < 3) {
                const int* base = seg == 0 ? s.emis : (seg == 1 ? s.numce : s.selfp);
                src = base + ((size_t)t * B + b) * A + a;
            } else {
                int kind = (seg - 3) / D, d = (seg - 3) - kind * D;
                const int* base = kind == 0 ? s.prevp : (kind == 1 ? s.curp : s.dence);
                src = base + (((size_t)t * D + d) * B + b) * A + a;
            }
        }
        __pipeline_memcpy_async(d_ptr, src, sizeof(int));
    }
    __pipeline_commit();
}

// One slot's stream values at one position, read from the shared row.
struct Slot {
    int em, nce, sp;
    int pp[DMAX], cp[DMAX];
    float den;  // sum_d eff[dence_d]
};

__device__ __forceinline__ Slot read_slot(const int* row, const float* effg,
                                          int a, bool real, int AP, int D,
                                          int NC) {
    Slot sl;
    sl.em = 9;
    sl.nce = NC - 1;
    sl.sp = -1;
    sl.den = 0.f;
#pragma unroll
    for (int d = 0; d < DMAX; ++d) {
        sl.pp[d] = -1;
        sl.cp[d] = -1;
    }
    if (real) {
        sl.em = row[a];
        sl.nce = row[AP + a];
        sl.sp = row[2 * AP + a];
#pragma unroll
        for (int d = 0; d < DMAX; ++d) {
            if (d < D) {
                sl.pp[d] = row[(3 + d) * AP + a];
                sl.cp[d] = row[(3 + D + d) * AP + a];
                sl.den += effg[row[(3 + 2 * D + d) * AP + a]];
            }
        }
    } else {
        sl.den = (float)D * effg[NC - 1];
    }
    return sl;
}

}  // namespace

// Threads per candidate row: A rounded up to whole warps.
static inline int slots_padded(int A) { return A < 32 ? 32 : ((A + 31) / 32) * 32; }

// Dynamic shared memory (bytes) of one block.
static inline size_t mapped_smem_bytes(int NC, int A, int D, int G) {
    int AP = slots_padded(A);
    size_t floats = (size_t)G * NC + 4 * (size_t)G * AP + (size_t)G * (AP / 32) + 16;
    return floats * sizeof(float) + 2 * (size_t)stream_row_ints(AP, D) * sizeof(int);
}

// The signature every mapped scorer kernel has: (eff, inv, lens, streams,
// lt_lin, out, C, NC, B, A, D, n_max_gaps).
typedef void (*MappedKernel)(const float*, const float*, const int*, Streams,
                             const float*, float*, int, int, int, int, int,
                             int);

// Launch `kernel` on `stream` with one block per (group of G candidates,
// read): grid (ceil(C / G), B), block (AP, G).  Returns the cudaError_t of
// the launch (0 = success).
static inline int launch_mapped(MappedKernel kernel, const float* eff,
                                const float* inv, const int* lens,
                                const Streams& s, const float* lt_lin,
                                float* out, int C, int NC, int B, int A,
                                int D, int n_max_gaps, int G, void* stream) {
    if (C <= 0 || B <= 0) return 0;
    if (D < 1 || D > DMAX || A < 1 || A > 1024 || G < 1)
        return (int)cudaErrorInvalidValue;
    const int AP = slots_padded(A);
    if (AP * G > MAX_THREADS) return (int)cudaErrorInvalidValue;
    const size_t smem = mapped_smem_bytes(NC, A, D, G);
    cudaError_t err = cudaFuncSetAttribute(
        (const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<dim3((C + G - 1) / G, B), dim3(AP, G), smem,
             (cudaStream_t)stream>>>(eff, inv, lens, s, lt_lin, out, C, NC, B,
                                     A, D, n_max_gaps);
    return (int)cudaGetLastError();
}
