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
// init = eff[numce] * inv_total with the LINEAR 1/total.  Every step is the
// one of ops/mapped_scorer.py:mapped_scores_linear_reference.
//
// What it cannot do: a read forced across copy-0 edges lives on only in
// the Begin chain, which decays ~3.6 decades a base; float32 underflows
// after ~11 bases and the read scores -inf.  score_candidates rescores such
// candidates with K2 (the linear-to-log rescue).
//
// Design: K1's (mapped_common.cuh), in linear space.  linear_scorer<RW>
// runs G candidate rows of one read per block; a row is one warp where
// A <= 32, its gathers through prevp / selfp / curp are __shfl_sync, and
// its M maximum a warp reduction (Row<RW>: a shared row and a named barrier
// of the row's own for 64 or 128 slots).  The block meets once per TP
// read positions, where the next positions' streams, staged by 16-byte
// cp.async into a double buffer, become visible to its rows.
//
// What bounds it on this card: as K1, latency, not bytes or arithmetic: a
// position is a chain of 2 + n_max_gaps dependent exchanges and a row
// maximum, each with a few multiply-adds between.  What the design does
// about it: no block barrier inside the chain, so a row waits only on its
// own exchanges and the SM's other rows fill the gaps; positions whose
// slots use fewer degree columns (live_degree_columns, most often one) run
// a step specialised on that count, with one gather per exchange and one
// eff lookup for the denominator; each row's eff table is staged once per
// block over the live compact edges only.
//
// Build (done by dbgphmm_tpu_torch/ops/_build.py at first use):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libmapped_scorer_linear.so mapped_scorer_linear.cu

#include "mapped_common.cuh"

namespace {

// Per-launch constants: the 13 linear probabilities and 1 / total.
struct LinConsts {
    float pMM, pIM, pDM, pMI, pII, pDI, pMD, pID, pDD;
    float p_match, p_mismatch, p_random, invt;
    int n_max_gaps;
};

// One slot's carried state: the scaled M/I/D tables, the row's Begin
// chain (mb, ib) and its log scale offset with the Kahan term.
struct LinState {
    float m, ii, dd, mb, ib, off, offc;
};

// sum_d of value `which` at slots idx[d] (0 where idx < 0), in order
template <int N, int RW>
__device__ __forceinline__ float gather_sum(const Row<RW>& row, int which,
                                            const int (&idx)[N]) {
    float out = row.get(which, idx[0], 0.f);
#pragma unroll
    for (int d = 1; d < N; ++d) out = out + row.get(which, idx[d], 0.f);
    return out;
}

// One read position of one candidate row, for positions whose slots use
// only the first N degree columns (the stream's ncols); N = DMAX reads the
// first D.  Columns past N hold no parent and no live out-edge, so they
// add exact zeros in the twin.  Every thread of the row calls this.
template <int N, int RW>
__device__ __forceinline__ void linear_step(const int* sr, int a, bool real,
                                            int A, int D, int NCL,
                                            const float* tab,
                                            const LinConsts& k, Row<RW>& row,
                                            LinState& st) {
    const int nseg = 3 + 3 * D;
    const int x = sr[nseg * A];
    int em = 9, nce = NCL, sp = -1;
    int pp[N], cp[N];
    float den = 0.f;
#pragma unroll
    for (int d = 0; d < N; ++d) pp[d] = cp[d] = -1;
    if (real) {
        const int* q = sr + a;
        em = q[0];
        nce = q[A];
        sp = q[2 * A];
#pragma unroll
        for (int d = 0; d < N; ++d) {
            if (N < DMAX || d < D) {
                pp[d] = q[(3 + d) * A];
                cp[d] = q[(3 + D + d) * A];
                // ids at or past NCL (the sentinel among them) are 0, tab[NCL]
                den += tab[min((unsigned)q[(3 + 2 * D + d) * A], (unsigned)NCL)];
            }
        }
    }
    const float num = tab[min((unsigned)nce, (unsigned)NCL)];
    const float t_val = den > 0.f ? num / den : 0.f;
    const float init_p = num * k.invt;
    float p_emit = em == x ? k.p_match : k.p_mismatch;
    p_emit = em < 4 ? p_emit : 0.f;

    // fm / fi sources: combine the three tables first, gather once
    row.put(k.pMM * st.m + k.pIM * st.ii + k.pDM * st.dd,
            k.pMI * st.m + k.pII * st.ii + k.pDI * st.dd);
    const float inner = gather_sum(row, 0, pp);
    const float from_begin = init_p * (k.pMM * st.mb + k.pIM * st.ib);
    const float m_new = p_emit * (t_val * inner + from_begin);
    const float i_new = k.p_random * row.get(1, sp, 0.f);
    // the Begin match state is 1 before position 0 and 0 after it
    const float ib_new = k.p_random * (k.pMI * st.mb + k.pII * st.ib);

    // deletion closure within the current slot set
    row.put(k.pMD * m_new + k.pID * i_new, 0.f);
    float d_new = t_val * gather_sum(row, 0, cp) + init_p * (k.pID * ib_new);
    float fdt = d_new;
    for (int r = 0; r < k.n_max_gaps; ++r) {
        row.put(fdt, 0.f);
        fdt = t_val * (k.pDD * gather_sum(row, 0, cp));
        d_new = d_new + fdt;
    }

    // scale by the row's M maximum (1 where every M is 0)
    float scale = row.reduce_max(real ? m_new : 0.f, 0);
    scale = scale > 0.f ? scale : 1.f;
    const float inv = 1.f / scale;
    st.m = m_new * inv;
    st.ii = i_new * inv;
    st.dd = d_new * inv;
    st.mb = 0.f;
    st.ib = ib_new * inv;
    const float y = logf(scale) - st.offc;
    const float tt = st.off + y;
    st.offc = (tt - st.off) - y;
    st.off = tt;
}

template <int RW>
__global__ void __launch_bounds__(32 * RW * MAX_ROWS, 4 / RW) linear_scorer(
    const float* __restrict__ eff,        // [C, NC]
    const float* __restrict__ inv_total,  // [C]  1 / total (0: empty)
    const int* __restrict__ lens,         // [B]
    Streams s,
    const int* __restrict__ ncols,        // [L, B] live degree columns (1..D)
    const float* __restrict__ lt_lin,     // [13] linear probs (LinTrans order)
    float* __restrict__ out,              // [C, B]
    int C, int NC, int NCL, int B, int A, int D, int n_max_gaps, int TP) {
    constexpr int AP = 32 * RW;
    extern __shared__ __align__(16) float smem[];
    const int G = blockDim.x / AP;
    const int tid = threadIdx.x, nthreads = blockDim.x;
    const int g = tid / AP, a = tid - g * AP;
    const int c0 = blockIdx.x * G, b = blockIdx.y;
    const int c = min(c0 + g, C - 1);  // tail rows recompute the last candidate
    const ScorerSmem L = scorer_smem(NCL, A, D, G, TP, RW);
    const int srow = stream_row(A, D), nseg = 3 + 3 * D;
    int* s_str = reinterpret_cast<int*>(smem + L.streams);
    float* s_lt = smem + L.consts;

    const int len = lens[b];
    if (len > 0)
        stage_streams(s_str, s, ncols, 0, min(TP, len), b, B, A, D, tid, nthreads);
    // each row's eff table over the first NCL columns; entry NCL is 0 and
    // serves every id at or past it (the sentinel among them)
    for (int i = tid; i < G * (NCL + 1); i += nthreads) {
        const int r = i / (NCL + 1), j = i - r * (NCL + 1);
        smem[L.tab + r * L.tab_row + j] =
            j < NCL ? eff[(size_t)min(c0 + r, C - 1) * NC + j] : 0.f;
    }
    if (tid < 13) s_lt[tid] = lt_lin[tid];
    __syncthreads();

    LinConsts k;
    k.pMM = s_lt[0], k.pIM = s_lt[1], k.pDM = s_lt[2];
    k.pMI = s_lt[3], k.pII = s_lt[4], k.pDI = s_lt[5];
    k.pMD = s_lt[6], k.pID = s_lt[7], k.pDD = s_lt[8];
    k.p_match = s_lt[9], k.p_mismatch = s_lt[10], k.p_random = s_lt[11];
    k.invt = inv_total[c];
    k.n_max_gaps = n_max_gaps;
    const float p_end = s_lt[12];
    const float* tab = smem + L.tab + g * L.tab_row;
    const bool real = a < A;

    Row<RW> row = row_at<RW>(smem, L, g, a);
    LinState st{0.f, 0.f, 0.f, 1.f, 0.f, 0.f, 0.f};
    walk_read(s_str, s, ncols, len, TP, srow, nseg, b, B, A, D,
              [&](auto n, const int* sr, int) {
                  linear_step<decltype(n)::value, RW>(sr, a, real, A, D, NCL,
                                                      tab, k, row, st);
              });

    // end state from the frozen tables: P = p_end * sum(M + I + D) * e^off
    const float e = p_end * row.reduce_sum(real ? st.m + st.ii + st.dd : 0.f);
    if (a == 0 && c0 + g < C)
        out[(size_t)(c0 + g) * B + b] = e > 0.f ? logf(e) + st.off : -INFINITY;
}

ScorerKernel linear_scorer_for(int A) {
    if (A <= 32) return linear_scorer<1>;
    if (A <= 64) return linear_scorer<2>;
    return linear_scorer<4>;
}

}  // namespace

DBG_SCORER_ENTRIES(dbg_mapped_scores_linear, linear_scorer_for)

extern "C" const char* dbg_cuda_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
