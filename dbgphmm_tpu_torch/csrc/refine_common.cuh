// Device functions shared by the refine's scans (refine.cu: R1, R2) and the
// sparse-adaptive forward's (adaptive.cu: A1, A2).
//
// They compute what the plain PyTorch versions compute, in the same order,
// so that a kernel equals its plain version to the bit: -inf is a true
// -inf, a log-sum-exp of an all -inf row is -inf, ladd is torch.logaddexp,
// and a log-sum-exp over the parent (child) columns adds its exps in the
// order of PyTorch's CUDA sum over the row (a -inf column adds an exact 0).
//
// mapped_step is one step of the mapping-constrained forward
// (ops/adaptive.py: _s_step_attrs, ops/sparse.py: _s_core) for one slot per
// thread: R1 runs it over a hint's sets, A2 over the evolving frontier's.

#pragma once

#include <cfloat>
#include <cmath>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_D = 5;      // parent / child columns (the model's padded degree)
constexpr int MAX_GAPS = 32;  // deletion-closure rounds
constexpr int MULTI = 1 << 30;  // slot code flag: the node has more slots

// dtype codes of the C entries
constexpr int F32 = 0, F64 = 1, BF16 = 2;

template <typename T> struct Num;
template <> struct Num<float> {
    __device__ static float ex(float x) { return expf(x); }
    __device__ static float lg(float x) { return logf(x); }
    __device__ static float lg1p(float x) { return log1pf(x); }
    __device__ static float tiny() { return FLT_MIN; }
    // the plain version's clamp(min=1e-300), which float32 rounds to 0
    __device__ static float log_floor() { return 0.f; }
};
template <> struct Num<double> {
    __device__ static double ex(double x) { return exp(x); }
    __device__ static double lg(double x) { return log(x); }
    __device__ static double lg1p(double x) { return log1p(x); }
    __device__ static double tiny() { return DBL_MIN; }
    __device__ static double log_floor() { return 1e-300; }
};

template <typename T> __device__ __forceinline__ T ninf() { return (T)(-INFINITY); }
template <typename T> __device__ __forceinline__ T pinf() { return (T)INFINITY; }

template <typename T> __device__ __forceinline__ T to_t(T x) { return x; }
template <typename T> __device__ __forceinline__ T to_t(__nv_bfloat16 x) {
    return (T)__bfloat162float(x);
}

template <typename T> __device__ __forceinline__ bool finite(T x) {
    return x > ninf<T>() && x < pinf<T>();
}

template <typename T> __device__ __forceinline__ T vmax(T a, T b) { return a > b ? a : b; }

// torch.logaddexp: equal infinities stay; else max + log1p(exp(-|a - b|)).
template <typename T> __device__ __forceinline__ T ladd(T a, T b) {
    if (a == b && !finite(a)) return a;
    const T mx = vmax(a, b);
    const T mn = a > b ? b : a;
    return mx + Num<T>::lg1p(Num<T>::ex(mn - mx));
}

template <typename T> __device__ __forceinline__ T ladd3(T a, T b, T c) {
    return ladd(ladd(a, b), c);
}

// log-sum-exp of x[0..D), -inf where every term is -inf (a -inf term adds
// an exact 0).  The exps are summed in the order of PyTorch's CUDA sum
// over a contiguous row of D <= 5 (the plain versions' _lse_deg; ATen's
// Reduce.cuh): lane j of w = 2^floor(log2 D) lanes adds its terms j, j + w,
// then a shuffle tree with decreasing offsets adds lane j + w / 2 to lane
// j, down to lane j + 1.
template <typename T> __device__ __forceinline__ T lse(const T (&x)[MAX_D], int D) {
    T mx = ninf<T>();
#pragma unroll
    for (int d = 0; d < MAX_D; ++d)
        if (d < D) mx = vmax(mx, x[d]);
    if (mx == ninf<T>()) return mx;
    T e[MAX_D];
#pragma unroll
    for (int d = 0; d < MAX_D; ++d)
        e[d] = (d < D && x[d] != ninf<T>()) ? Num<T>::ex(x[d] - mx) : T(0);
    T s;
    switch (D) {
        case 1: s = e[0]; break;
        case 2: s = e[0] + e[1]; break;
        case 3: s = (e[0] + e[2]) + e[1]; break;
        case 4: s = (e[0] + e[2]) + (e[1] + e[3]); break;
        default: s = ((e[0] + e[4]) + e[2]) + (e[1] + e[3]); break;
    }
    return mx + Num<T>::lg(s);
}

// The slot of node u among nodes[0..n4) (n4 a multiple of 4, slots past the
// set hold -1): -1 if absent, the first slot, with MULTI set if u holds
// another slot too.
__device__ __forceinline__ int find_slot(const int* __restrict__ nodes, int n4, int u) {
    const int4* q = reinterpret_cast<const int4*>(nodes);
    int first = -1, multi = 0;
    for (int j = 0; j < (n4 >> 2); ++j) {
        const int4 v = q[j];
        const int hit[4] = {v.x == u, v.y == u, v.z == u, v.w == u};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            if (hit[c]) {
                if (first < 0) first = 4 * j + c;
                else multi = MULTI;
            }
        }
    }
    return first < 0 ? -1 : (first | multi);
}

// vals at the slot(s) of node u (code from find_slot): the maximum over
// them, -inf if u has none.
template <typename T>
__device__ __forceinline__ T lookup(const T* vals, const int* nodes, int n4, int u, int code) {
    if (code < 0) return ninf<T>();
    if (!(code & MULTI)) return vals[code];
    T best = ninf<T>();
    for (int j = code & ~MULTI; j < n4; ++j)
        if (nodes[j] == u) best = vmax(best, vals[j]);
    return best;
}

// Block-wide max / sum (red: one entry per warp); every thread gets it.
template <typename T> __device__ __forceinline__ T block_max(T v, T* red) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = vmax(v, __shfl_xor_sync(0xffffffffu, v, o));
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
    __syncthreads();
    T r = red[0];
    for (int w = 1; w < (int)(blockDim.x >> 5); ++w) r = vmax(r, red[w]);
    return r;
}

template <typename T> __device__ __forceinline__ T block_sum(T v, T* red) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
    __syncthreads();
    T r = red[0];
    for (int w = 1; w < (int)(blockDim.x >> 5); ++w) r += red[w];
    return r;
}

// The 13 log transition / emission values (LogTrans order).
template <typename T> struct Trans {
    T MM, IM, DM, MI, II, DI, MD, ID, DD, match, mismatch, random, end;
    __device__ explicit Trans(const T* __restrict__ v)
        : MM(v[0]), IM(v[1]), DM(v[2]), MI(v[3]), II(v[4]), DI(v[5]), MD(v[6]),
          ID(v[7]), DD(v[8]), match(v[9]), mismatch(v[10]), random(v[11]),
          end(v[12]) {}
};

// Kahan-compensated off += shift (ops/forward.py:_kahan).
template <typename T> __device__ __forceinline__ void kahan(T& off, T& off_c, T shift) {
    const T y = shift - off_c;
    const T t = off + y;
    off_c = (t - off) - y;
    off = t;
}

// A read's scalars of the forward carry (ops/sparse.py: SState).
template <typename T> struct ReadCarry {
    T mb, ib, e, off, off_c;
};

// The shared-memory arrays of mapped_step, one entry per thread of the
// block at least (ids 16-byte aligned; red: one entry per warp).
template <typename T> struct StepSmem {
    int* prev;  // the previous set's node ids
    int* cur;   // the current set's node ids
    T* pm;      // pre-M of the previous set
    T* pi;      // pre-I of the previous set
    T* f[2];    // the deletion closure, double-buffered
    T* red[3];  // the shift's, and e's max and sum
};

// One step of the mapping-constrained forward for slot a = threadIdx.x:
// (node, m, i, d) is the slot's carried cell, v its node in the current set
// (-1: none), x the read's code at this position; every thread of the block
// calls it (n4 = the sets' width rounded up to 4, at most the block's
// threads).  On return the carry holds the renormalised cell of node v and
// the read's scalars; e is computed only where ``last`` (the read's last
// position: it feeds nothing else).
template <typename T>
__device__ __forceinline__ void mapped_step(
    const int* __restrict__ emission, const T* __restrict__ init_logp,
    const int* __restrict__ parent_idx, const T* __restrict__ parent_logt,
    const Trans<T>& lt, int v, int x, bool last, int n4, int D, int G,
    const StepSmem<T>& sm, int& node, T& m, T& i, T& d, ReadCarry<T>& rc) {
    const T NEG = ninf<T>();
    const int a = threadIdx.x;
    const bool ok = v >= 0;
    int pidx[MAX_D];
    T plogt[MAX_D];
    T init = NEG;
    int emis = -1;
#pragma unroll
    for (int c = 0; c < MAX_D; ++c) {
        pidx[c] = -1;
        plogt[c] = NEG;
        if (ok && c < D) {
            pidx[c] = parent_idx[(size_t)v * D + c];
            plogt[c] = parent_logt[(size_t)v * D + c];
        }
    }
    if (ok) {
        emis = emission[v];
        init = init_logp[v];
    }

    sm.prev[a] = node;
    sm.pm[a] = ladd3(lt.MM + m, lt.IM + i, lt.DM + d);
    sm.pi[a] = ladd3(lt.MI + m, lt.II + i, lt.DI + d);
    sm.cur[a] = v;
    __syncthreads();

    // M from the parents in the previous set and the Begin entry; I from
    // the slot's own node there
    const T begin = ladd(lt.MM + rc.mb, lt.IM + rc.ib);
    const T ib_new = lt.random + ladd(lt.MI + rc.mb, lt.II + rc.ib);
    const T begin_d = ladd(lt.MD + NEG, lt.ID + ib_new);  // mb_new = -inf
    int cslot[MAX_D];
    T m_new = NEG, i_new = NEG;
    if (ok) {
        T t[MAX_D];
#pragma unroll
        for (int c = 0; c < MAX_D; ++c) {
            t[c] = NEG;
            cslot[c] = -1;
            if (c < D && plogt[c] != NEG) {
                const int ps = find_slot(sm.prev, n4, pidx[c]);
                t[c] = plogt[c] + lookup(sm.pm, sm.prev, n4, pidx[c], ps);
                cslot[c] = find_slot(sm.cur, n4, pidx[c]);
            }
        }
        const T from_normal = lse(t, D);
        const T from_begin = init + begin;
        const T p_emit = emis == x ? lt.match : lt.mismatch;
        m_new = p_emit + ladd(from_normal, from_begin);
        i_new = lt.random + lookup(sm.pi, sm.prev, n4, v, find_slot(sm.prev, n4, v));
    }
    sm.f[0][a] = ladd(lt.MD + m_new, lt.ID + i_new);  // pre-D
    __syncthreads();

    // the deletion closure within the current set
    T d_new = NEG;
    if (ok) {
        T t[MAX_D];
#pragma unroll
        for (int c = 0; c < MAX_D; ++c)
            t[c] = cslot[c] < 0 ? NEG
                                : plogt[c] + lookup(sm.f[0], sm.cur, n4, pidx[c], cslot[c]);
        d_new = ladd(lse(t, D), init + begin_d);
    }
    sm.f[1][a] = d_new;
    __syncthreads();
    int src = 1;
    for (int r = 0; r < G; ++r) {
        T fdt = NEG;
        if (ok) {
            T t[MAX_D];
#pragma unroll
            for (int c = 0; c < MAX_D; ++c)
                t[c] = cslot[c] < 0
                           ? NEG
                           : plogt[c] + lt.DD +
                                 lookup(sm.f[src], sm.cur, n4, pidx[c], cslot[c]);
            fdt = lse(t, D);
            d_new = ladd(d_new, fdt);
        }
        if (r + 1 < G) {
            sm.f[src ^ 1][a] = fdt;
            __syncthreads();
            src ^= 1;
        }
    }

    // renormalise by the largest live M (0 where there is none)
    const T mx = block_max(m_new, sm.red[0]);
    const T shift = mx == NEG ? T(0) : mx;
    if (last) {
        const T x3 = ladd3(m_new, i_new, d_new);
        const T emx = block_max(x3, sm.red[1]);
        T tot = NEG;
        if (emx != NEG) {
            const T s = block_sum(x3 == NEG ? T(0) : Num<T>::ex(x3 - emx), sm.red[2]);
            tot = emx + Num<T>::lg(s);
        }
        rc.e = (lt.end + tot) - shift;
    }
    m = m_new - shift;
    i = i_new - shift;
    d = d_new - shift;
    rc.mb = NEG - shift;
    rc.ib = ib_new - shift;
    kahan(rc.off, rc.off_c, shift);
    node = v;
}

inline int threads_for(int slots) { return slots <= 32 ? 32 : ((slots + 31) / 32) * 32; }

}  // namespace
