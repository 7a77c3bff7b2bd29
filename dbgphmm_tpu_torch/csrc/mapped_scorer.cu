// Mapped log-space candidate scorers (K1 and K2) for NVIDIA Hopper (sm_90a).
//
// K1, dbg_mapped_scores_log, replaces the Pallas TPU kernel
// dbgphmm_tpu/ops/pallas_mapped.py:_make_kernel_log_packed (:718, launched
// by pallas_mapped_scores_packed).  K2, dbg_mapped_scores_log_single,
// replaces _make_kernel_log (:488, pallas_mapped_scores(space="log")): the
// same recursion, one candidate per grid row.  On Hopper both are one
// template, mapped_scores_log_kernel<RENORM_EVERY>: K1 runs G candidates per
// block and renormalises every 2 positions, K2 one candidate per block and
// every position.  K2 keeps the TPU kernel's per-candidate shape, but not
// its float32 Begin chain (carried as log scalars shifted by the M maximum
// every step, which loses whole nats on 10 kb reads): like K1 it uses the
// closed-form chain and the largest-live-state shift below, and computes
// the end state once from the frozen tables where the TPU kernel recomputes
// it at every valid step.
//
// The kernel computes, for every (candidate c, read b), log P(read b | copy
// numbers of candidate c): a log-space profile-HMM forward pass restricted to the read's
// A mapped slots per position, with M/I/D states, D parent columns,
// n_max_gaps rounds of deletion closure and a Begin re-entry chain kept as
// log scalars.  Candidates differ only through eff[c, :] (copy numbers over
// compact edges), so transitions are derived here from two eff lookups per
// slot: t = eff[numce] / sum_d eff[dence_d], init = eff[numce] / total.
// Values stay finite: -1e30 is the "log 0" sentinel, as in the TPU kernel.
//
// Design.
//   * Grid: one block per (group of G candidates, read b); gridDim.x runs
//     over candidate groups, so blocks resident at the same time mostly
//     share a read and its streams stay hot in L2.
//   * Block: blockDim.x = AP = max(32, A) threads, thread x owns slot x;
//     blockDim.y = G candidates.  A candidate row is 1..4 whole warps.
//   * The streams of one position (emis/numce/selfp, prevp/curp/dence for
//     each of the D columns, and the read base) are copied once per block
//     into shared memory with cp.async, one position ahead of use and
//     double-buffered, and shared by the block's G candidates.  This is the
//     counterpart of the TPU kernel's candidate blocking (CL): streams are
//     read once per candidate group, not once per candidate.
//   * The group's eff rows live in shared memory (G x NC floats).
//   * A slot's own M/I/D values stay in registers; the values other slots
//     gather (parent / self lookups through prevp, selfp, curp) go through
//     per-candidate shared rows, one barrier per gather round.
//   * Each block stops at its read's length (the TPU kernel masks every
//     step instead), and the end state is computed once from the frozen
//     tables after the last step.
//   * K2 is the G = 1 case; its per-position renormalisation adds one
//     row-max (a barrier when a row is more than one warp) to every
//     position instead of every other.
//
// What bounds it on this card.  Not HBM bytes: at the production shapes
// (L = 10k, B ~ 100, A = 32, D = 3) the int32 streams are ~1.6 GB and are
// re-read once per candidate group.  The bound is latency: every position is
// a dependent chain of ~7 block barriers (the M/I gather, the deletion
// closure's 1 + n_max_gaps rounds, the renormalisation max) with ~26
// log-add-exps in between, and nothing of position t+1 can start before
// position t ends.  The design hides it only by keeping many blocks resident
// per SM; the per-position cp.async prefetch keeps stream loads off the
// chain.
//
// Build (done by dbgphmm_tpu_torch/ops/_build.py at first use):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libmapped_scorer.so mapped_scorer.cu
// (mapped_common.cuh holds the stream copy, reductions and smem layout
// shared with K3, mapped_scorer_linear.cu.)

#include "mapped_common.cuh"

namespace {

__device__ __forceinline__ float ladd(float a, float b) {
    float mx = fmaxf(a, b);
    float mn = fminf(a, b);
    return mx + log1pf(expf(fmaxf(mn - mx, NEGF)));
}

__device__ __forceinline__ float gather_log(const float* row, int idx) {
    return idx >= 0 ? row[idx] : NEGF;
}

// ladd-combine of the per-degree gathers (gather_deg in the TPU kernel)
__device__ __forceinline__ float gather_deg(const float* row, const int* idx,
                                            int D) {
    float out = gather_log(row, idx[0]);
#pragma unroll
    for (int d = 1; d < DMAX; ++d) {
        if (d < D) out = ladd(out, gather_log(row, idx[d]));
    }
    return out;
}

// RENORM_EVERY: renormalise every 2 positions (K1) or every position (K2).
template <int RENORM_EVERY>
__global__ void __launch_bounds__(MAX_THREADS) mapped_scores_log_kernel(
    const float* __restrict__ eff,     // [C, NC]
    const float* __restrict__ linv,    // [C]  log(1 / total copy-weighted length)
    const int* __restrict__ lens,      // [B]
    Streams s,
    const float* __restrict__ lt_lin,  // [13] linear probs (LinTrans order)
    float* __restrict__ out,           // [C, B]
    int C, int NC, int B, int A, int D, int n_max_gaps) {
    extern __shared__ float smem[];
    const int AP = blockDim.x, G = blockDim.y;
    const int a = threadIdx.x, g = threadIdx.y;
    const int tid = g * AP + a, nthreads = AP * G;
    const int NW = AP / 32, lane = a & 31, warp = a >> 5;
    const int c0 = blockIdx.x * G;
    const int b = blockIdx.y;
    const int c = min(c0 + g, C - 1);  // tail rows recompute the last candidate
    const int nseg = 3 + 3 * D;
    const int srow = stream_row_ints(AP, D);

    float* s_eff = smem;                    // G * NC
    float* s_P = s_eff + (size_t)G * NC;    // G * AP: pre_m
    float* s_Q = s_P + G * AP;              // G * AP: pre_i
    float* s_X0 = s_Q + G * AP;             // G * AP: pre_d / closure rounds
    float* s_X1 = s_X0 + G * AP;            // G * AP: closure rounds
    float* s_red = s_X1 + G * AP;           // G * NW
    float* s_lt = s_red + G * NW;           // 16
    int* s_str = reinterpret_cast<int*>(s_lt + 16);  // 2 * srow

    const int len = lens[b];
    for (int k = tid; k < G * NC; k += nthreads) {
        int cc = min(c0 + k / NC, C - 1);
        s_eff[k] = eff[(size_t)cc * NC + (k % NC)];
    }
    if (tid < 13) s_lt[tid] = logf(fmaxf(lt_lin[tid], 1e-38f));
    if (len > 0) issue_stream_copy(s_str, s, 0, b, B, A, D, AP, tid, nthreads);
    __pipeline_wait_prior(0);
    __syncthreads();

    const float lMM = s_lt[0], lIM = s_lt[1], lDM = s_lt[2];
    const float lMI = s_lt[3], lII = s_lt[4], lDI = s_lt[5];
    const float lMD = s_lt[6], lID = s_lt[7], lDD = s_lt[8];
    const float l_match = s_lt[9], l_mismatch = s_lt[10];
    const float l_random = s_lt[11], l_end = s_lt[12];
    const float linv_c = linv[c];
    const float* effg = s_eff + (size_t)g * NC;
    float* P = s_P + g * AP;
    float* Q = s_Q + g * AP;
    float* X0 = s_X0 + g * AP;
    float* X1 = s_X1 + g * AP;
    float* red = s_red + g * NW;
    const bool real = a < A;

    float m = NEGF, ii = NEGF, dd = NEGF;  // this slot's tables
    float off = 0.f, offc = 0.f;          // renorm offset + Kahan term
    // The Begin chain is closed-form: the Begin match state is log 1 before
    // position 0 and empty after it, so after position t the Begin-insert
    // state is lB0 + t * lBstep (absolute).  Carrying it as a renormalised
    // state instead (the TPU kernel does) lets it decay ~8 nats per base
    // away from the live states, and a float32 value of magnitude 1e4-1e5
    // loses ~0.004 nats per step: a read that later dies on a copy-0 edge
    // and re-enters through the Begin chain inherits tens of nats of error.
    const float lB0 = l_random + lMI, lBstep = l_random + lII;

    for (int t = 0; t < len; ++t) {
        const int* row = s_str + (t & 1) * srow;
        const float base = off - offc;  // offset applied so far (compensated)
        const float mb = t == 0 ? 0.f : NEGF;
        const float ib = t == 0 ? NEGF
                                : (lB0 + __fmul_rn((float)(t - 1), lBstep)) - base;
        // fm / fi sources: combine the three tables first, gather once
        P[a] = ladd(ladd(lMM + m, lIM + ii), lDM + dd);
        Q[a] = ladd(ladd(lMI + m, lII + ii), lDI + dd);
        __syncthreads();
        if (t + 1 < len)
            issue_stream_copy(s_str + ((t + 1) & 1) * srow, s, t + 1, b, B, A,
                              D, AP, tid, nthreads);

        const int x = row[nseg * AP];
        const Slot sl = read_slot(row, effg, a, real, AP, D, NC);
        const int em = sl.em, nce = sl.nce, sp = sl.sp;
        const int* pp = sl.pp;
        const int* cp = sl.cp;
        const float den = sl.den;
        const float num = effg[nce];
        const bool ok_t = (num > 0.f) && (den > 0.f);
        const float l_num = logf(fmaxf(num, 1e-38f));
        const float l_tval = ok_t ? l_num - logf(fmaxf(den, 1e-38f)) : NEGF;
        const float l_init = num > 0.f ? l_num + linv_c : NEGF;
        float l_emit = em == x ? l_match : l_mismatch;
        l_emit = em < 4 ? l_emit : NEGF;

        const float inner = gather_deg(P, pp, D);
        const float from_begin = l_init + ladd(lMM + mb, lIM + ib);
        float m_new = l_emit + ladd(l_tval + inner, from_begin);
        float i_new = l_random + gather_log(Q, sp);
        const float mb_new = NEGF;
        const float ib_new = (lB0 + __fmul_rn((float)t, lBstep)) - base;

        // deletion closure within the current slot set
        X0[a] = ladd(lMD + m_new, lID + i_new);
        __syncthreads();
        const float acc = gather_deg(X0, cp, D);
        float d_new = ladd(l_tval + acc, l_init + ladd(lMD + mb_new, lID + ib_new));
        float fdt = d_new;
        for (int r = 0; r < n_max_gaps; ++r) {
            float* buf = (r & 1) ? X0 : X1;
            buf[a] = fdt;
            __syncthreads();
            fdt = l_tval + lDD + gather_deg(buf, cp, D);
            d_new = ladd(d_new, fdt);
        }

        if (t % RENORM_EVERY == RENORM_EVERY - 1) {
            // shift by the largest live state (M, I, D of any slot, or the
            // Begin-insert chain), not by M alone: where a copy-0 edge kills
            // every M, the read lives on in I, D or the Begin chain, and the
            // frame has to follow it to keep carried values near 0
            const float own = fmaxf(m_new, fmaxf(i_new, d_new));
            float shift = fmaxf(row_max(real ? own : LOW, red, NW, lane, warp),
                                ib_new);
            shift = shift > NEGF / 2 ? shift : 0.f;
            m_new = fmaxf(m_new - shift, NEGF);
            i_new = fmaxf(i_new - shift, NEGF);
            d_new = fmaxf(d_new - shift, NEGF);
            const float y = shift - offc;
            const float tt = off + y;
            offc = (tt - off) - y;
            off = tt;
        }
        m = m_new;
        ii = i_new;
        dd = d_new;
        __pipeline_wait_prior(0);  // next position's streams (made visible
                                   // to the block by the next barrier)
    }

    // end state from the frozen tables: log P = l_end + lse(M+I+D) + offset
    const float mid = ladd(ladd(m, ii), dd);
    __syncthreads();  // red[] may still be read by the last renorm
    const float mx = fmaxf(row_max(real ? mid : LOW, red, NW, lane, warp), NEGF);
    __syncthreads();
    const float e = real ? expf(fmaxf(mid - mx, NEGF)) : 0.f;
    const float lse = mx + logf(row_sum(e, red, NW, lane, warp));
    if (a == 0 && c0 + g < C)
        out[(size_t)(c0 + g) * B + b] =
            lse > NEGF / 2 ? l_end + lse + (off - offc) : -INFINITY;
}

}  // namespace

extern "C" {

// Dynamic shared memory (bytes) of one block.
size_t dbg_mapped_scores_log_smem(int NC, int A, int D, int G) {
    return mapped_smem_bytes(NC, A, D, G);
}

// K1: G candidates per block, renormalised every 2 positions.  Launches on
// `stream`; returns the cudaError_t of the launch (0 = success).
int dbg_mapped_scores_log(const float* eff, const float* linv, const int* lens,
                          const int* codes, const int* emis, const int* numce,
                          const int* selfp, const int* prevp, const int* curp,
                          const int* dence, const float* lt_lin, float* out,
                          int C, int NC, int L, int B, int A, int D,
                          int n_max_gaps, int G, void* stream) {
    (void)L;
    Streams s{codes, emis, numce, selfp, prevp, curp, dence};
    return launch_mapped(mapped_scores_log_kernel<2>, eff, linv, lens, s,
                         lt_lin, out, C, NC, B, A, D, n_max_gaps, G, stream);
}

// K2: one candidate per block, renormalised at every position.
int dbg_mapped_scores_log_single(const float* eff, const float* linv,
                                 const int* lens, const int* codes,
                                 const int* emis, const int* numce,
                                 const int* selfp, const int* prevp,
                                 const int* curp, const int* dence,
                                 const float* lt_lin, float* out, int C,
                                 int NC, int L, int B, int A, int D,
                                 int n_max_gaps, void* stream) {
    (void)L;
    Streams s{codes, emis, numce, selfp, prevp, curp, dence};
    return launch_mapped(mapped_scores_log_kernel<1>, eff, linv, lens, s,
                         lt_lin, out, C, NC, B, A, D, n_max_gaps, 1, stream);
}

const char* dbg_cuda_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
