// Mapped scaled-linear candidate scorer (K3) for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel dbgphmm_tpu/ops/pallas_mapped.py:
// _make_kernel (:298, pallas_mapped_scores(space="linear")), the
// scaled-linear form of ops/sparse.py:_s_step_lin.  It computes the same
// [C, B] log P(read b | copy numbers of candidate c) as K1
// (mapped_scorer.cu), with linear M/I/D tables: sums of products instead of
// log-add-exps.  At every position the tables are scaled by the M maximum
// of the row (1 where it is 0) and its log goes into a Kahan-summed offset,
// one logf per read and position.  The Begin chain is a pair of linear
// scalars scaled with the tables, as on the TPU.  Transitions come from
// the eff rows: t = eff[numce] / sum_d eff[dence_d] (0 where the sum is 0),
// init = eff[numce] * inv_total with the LINEAR 1/total.
//
// What it cannot do: a read forced across copy-0 edges lives on only in
// the Begin chain, which decays ~3.6 decades a base; float32 underflows
// after ~11 bases and the read scores -inf.  score_candidates rescores such
// candidates with K2 (the linear-to-log rescue).
//
// Design: K1's block design (see mapped_scorer.cu), with the same shared
// memory layout (mapped_common.cuh).
//   * Grid: one block per (group of G candidates, read b); block (AP, G),
//     thread x owns slot x of candidate row y.
//   * The group's eff rows in shared memory; the next position's streams
//     prefetched with cp.async into a double-buffered shared row.
//   * A slot's own M/I/D in registers; gathered values through per-row
//     shared buffers; the block stops at its read's length and computes the
//     end state once from the frozen tables.
//
// What bounds it on this card: as K1, latency, not bytes or arithmetic.  A
// position is still a chain of ~7 block barriers (the M/I gather, the
// deletion closure's 1 + n_max_gaps rounds, the per-position row max when
// a row is more than one warp), and nothing of position t+1 starts before
// position t ends.  What the design does about it: each step between
// barriers is a few multiply-adds instead of K1's log1pf/expf pairs, the
// stream loads of t+1 overlap step t, and many blocks stay resident per
// SM to cover the barrier latency.
//
// Build (done by dbgphmm_tpu_torch/ops/_build.py at first use):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libmapped_scorer_linear.so mapped_scorer_linear.cu

#include "mapped_common.cuh"

namespace {

__device__ __forceinline__ float gather_lin(const float* row, int idx) {
    return idx >= 0 ? row[idx] : 0.f;
}

// sum of the per-degree gathers
__device__ __forceinline__ float gather_sum(const float* row, const int* idx,
                                            int D) {
    float out = gather_lin(row, idx[0]);
#pragma unroll
    for (int d = 1; d < DMAX; ++d) {
        if (d < D) out = out + gather_lin(row, idx[d]);
    }
    return out;
}

__global__ void __launch_bounds__(MAX_THREADS) mapped_scores_linear_kernel(
    const float* __restrict__ eff,        // [C, NC]
    const float* __restrict__ inv_total,  // [C]  1 / total (0: empty)
    const int* __restrict__ lens,         // [B]
    Streams s,
    const float* __restrict__ lt_lin,     // [13] linear probs (LinTrans order)
    float* __restrict__ out,              // [C, B]
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
    if (tid < 13) s_lt[tid] = lt_lin[tid];
    if (len > 0) issue_stream_copy(s_str, s, 0, b, B, A, D, AP, tid, nthreads);
    __pipeline_wait_prior(0);
    __syncthreads();

    const float pMM = s_lt[0], pIM = s_lt[1], pDM = s_lt[2];
    const float pMI = s_lt[3], pII = s_lt[4], pDI = s_lt[5];
    const float pMD = s_lt[6], pID = s_lt[7], pDD = s_lt[8];
    const float p_match = s_lt[9], p_mismatch = s_lt[10];
    const float p_random = s_lt[11], p_end = s_lt[12];
    const float invt = inv_total[c];
    const float* effg = s_eff + (size_t)g * NC;
    float* P = s_P + g * AP;
    float* Q = s_Q + g * AP;
    float* X0 = s_X0 + g * AP;
    float* X1 = s_X1 + g * AP;
    float* red = s_red + g * NW;
    const bool real = a < A;

    float m = 0.f, ii = 0.f, dd = 0.f;  // this slot's tables
    float mb = 1.f, ib = 0.f;           // Begin chain (linear, scaled)
    float off = 0.f, offc = 0.f;        // log scale offset + Kahan term

    for (int t = 0; t < len; ++t) {
        const int* row = s_str + (t & 1) * srow;
        // fm / fi sources: combine the three tables first, gather once
        P[a] = pMM * m + pIM * ii + pDM * dd;
        Q[a] = pMI * m + pII * ii + pDI * dd;
        __syncthreads();
        if (t + 1 < len)
            issue_stream_copy(s_str + ((t + 1) & 1) * srow, s, t + 1, b, B, A,
                              D, AP, tid, nthreads);

        const int x = row[nseg * AP];
        const Slot sl = read_slot(row, effg, a, real, AP, D, NC);
        const float num = effg[sl.nce];
        const float t_val = sl.den > 0.f ? num / sl.den : 0.f;
        const float init_p = num * invt;
        float p_emit = sl.em == x ? p_match : p_mismatch;
        p_emit = sl.em < 4 ? p_emit : 0.f;

        const float inner = gather_sum(P, sl.pp, D);
        const float from_begin = init_p * (pMM * mb + pIM * ib);
        float m_new = p_emit * (t_val * inner + from_begin);
        float i_new = p_random * gather_lin(Q, sl.sp);
        const float mb_new = 0.f;
        float ib_new = p_random * (pMI * mb + pII * ib);

        // deletion closure within the current slot set
        X0[a] = pMD * m_new + pID * i_new;
        __syncthreads();
        const float acc = gather_sum(X0, sl.cp, D);
        float d_new = t_val * acc + init_p * (pMD * mb_new + pID * ib_new);
        float fdt = d_new;
        for (int r = 0; r < n_max_gaps; ++r) {
            float* buf = (r & 1) ? X0 : X1;
            buf[a] = fdt;
            __syncthreads();
            fdt = t_val * (pDD * gather_sum(buf, sl.cp, D));
            d_new = d_new + fdt;
        }

        // scale by the row's M maximum (1 where every M is 0)
        float scale = row_max(real ? m_new : 0.f, red, NW, lane, warp);
        scale = scale > 0.f ? scale : 1.f;
        const float inv = 1.f / scale;
        m = m_new * inv;
        ii = i_new * inv;
        dd = d_new * inv;
        mb = mb_new;
        ib = ib_new * inv;
        const float y = logf(scale) - offc;
        const float tt = off + y;
        offc = (tt - off) - y;
        off = tt;
        __pipeline_wait_prior(0);  // next position's streams (made visible
                                   // to the block by the next barrier)
    }

    // end state from the frozen tables: P = p_end * sum(M + I + D) * e^off
    __syncthreads();  // red[] may still be read by the last row max
    const float e = p_end * row_sum(real ? m + ii + dd : 0.f, red, NW, lane,
                                    warp);
    if (a == 0 && c0 + g < C)
        out[(size_t)(c0 + g) * B + b] = e > 0.f ? logf(e) + off : -INFINITY;
}

}  // namespace

extern "C" {

// Dynamic shared memory (bytes) of one block.
size_t dbg_mapped_scores_linear_smem(int NC, int A, int D, int G) {
    return mapped_smem_bytes(NC, A, D, G);
}

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
int dbg_mapped_scores_linear(const float* eff, const float* inv_total,
                             const int* lens, const int* codes,
                             const int* emis, const int* numce,
                             const int* selfp, const int* prevp,
                             const int* curp, const int* dence,
                             const float* lt_lin, float* out, int C, int NC,
                             int L, int B, int A, int D, int n_max_gaps,
                             int G, void* stream) {
    (void)L;
    Streams s{codes, emis, numce, selfp, prevp, curp, dence};
    return launch_mapped(mapped_scores_linear_kernel, eff, inv_total, lens, s,
                         lt_lin, out, C, NC, B, A, D, n_max_gaps, G, stream);
}

const char* dbg_cuda_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
