// Mapped log-space candidate scorers (K1 and K2) for NVIDIA Hopper (sm_90a).
//
// K1, dbg_mapped_scores_log, replaces the Pallas TPU kernel
// dbgphmm_tpu/ops/pallas_mapped.py:_make_kernel_log_packed (:718, launched
// by pallas_mapped_scores_packed).  K2, dbg_mapped_scores_log_single,
// replaces _make_kernel_log (:488, pallas_mapped_scores(space="log")): the
// same recursion, renormalised at every position.  On Hopper both are one
// template, log_scorer<RW, RENORM>, with G candidate rows per block: K1
// renormalises every 2 positions, K2 at every position.  The TPU kernel of
// K2 scores one candidate per grid row; nothing in what it computes ties a
// row to a block, and rows come back in candidate order at every G.  K2
// keeps the TPU kernel's renormalisation, but not its float32 Begin chain
// (carried as log scalars shifted by the M maximum every step, which loses
// whole nats on 10 kb reads): like K1 it uses the closed-form chain and the
// largest-live-state shift below, and computes the end state once from the
// frozen tables where the TPU kernel recomputes it at every step.
//
// The kernel computes, for every (candidate c, read b), log P(read b | copy
// numbers of candidate c): a log-space profile-HMM forward pass restricted
// to the read's A mapped slots per position, with M/I/D states, D parent
// columns, n_max_gaps rounds of deletion closure and a Begin re-entry
// chain.  Candidates differ only through eff[c, :] (copy numbers over
// compact edges), so transitions are derived here from eff lookups per
// slot: t = eff[numce] / sum_d eff[dence_d], init = eff[numce] / total.
// Values stay finite: -1e30 is the "log 0" sentinel, as in the TPU kernel.
//
// Design (what bounds it, and what each choice answers).  The block, the
// row exchange, the staged streams and the launch are shared with K3
// (mapped_common.cuh).
//   * Work: one candidate row per (c, b) pair walks the read's positions in
//     order; a position is a chain of dependent gathers (M/I from the
//     previous position's parents, then 1 + n_max_gaps deletion-closure
//     rounds within the position).  The chain is short arithmetic between
//     exchanges, so the kernel is bound by instruction issue and latency,
//     not by bytes: the streams of one read position are ~2 KB and are read
//     once per block.
//   * One warp per candidate row where A <= 32: the gathers through prevp /
//     selfp / curp are __shfl_sync from the owning lane, and a row never
//     waits on another row (Row<RW>).
//   * Base-2 log space with the fast intrinsics (ex2.approx, lg2.approx):
//     every log-sum-exp takes one max, the exp2 of the differences and one
//     lg2, not chains of pairwise expf / log1pf.  The pre-M and pre-I sums
//     share the three exp2 of the slot's own M/I/D.  Where no lane of the
//     warp has a second term within 2^-24 of the largest, the sum is the
//     largest term and no transcendental is issued: most positions of a de
//     Bruijn graph read have one parent per slot and no live Begin re-entry.
//     Carried M/I/D stay in log space per slot (no linear frame shared by
//     the slots: that is K3's underflow).
//   * The log2 eff table of each row is staged once per block, over only
//     the live compact edges (plus one "log 0" entry for the sentinel and
//     any id past them): no log per slot-step for the numerator, none for
//     the denominator where a slot's source node has one out-edge.
//   * The closed-form Begin chain and the largest-live-state shift of the
//     first port are kept (ROADMAP "Faults found").
//
// Build (done by dbgphmm_tpu_torch/ops/_build.py at first use):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libmapped_scorer.so mapped_scorer.cu

#include "mapped_common.cuh"

namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
// A term more than 24 (log2 units) below the largest adds less than 2^-24
// to the sum's leading 1: dropping it changes the log-sum-exp by less than
// float32 rounding of the sum (at most ~8.6e-8 log2 units), not exactly 0.
constexpr float NEGLIGIBLE = -24.f;

__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

__device__ __forceinline__ float lg2(float x) {
    float y;
    asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

// log2(sum_k 2^v[k]) over N terms.  Warp-uniform shortcut: where no lane
// has a second term within NEGLIGIBLE of its largest, the largest is the
// sum.  Every lane of the warp must call this.
template <int N>
__device__ __forceinline__ float lse2_n(const float (&v)[N]) {
    if constexpr (N == 1) return v[0];
    float mx = v[0];
#pragma unroll
    for (int k = 1; k < N; ++k) mx = fmaxf(mx, v[k]);
    int near = 0;
#pragma unroll
    for (int k = 0; k < N; ++k) near += (v[k] - mx > NEGLIGIBLE) ? 1 : 0;
    if (!__any_sync(FULL, near > 1 && mx > NEGF / 2)) return mx;
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < N; ++k) s += ex2(v[k] - mx);
    return mx + lg2(s);
}

// Per-launch constants (log2 units; p* linear).
struct Consts {
    float lMM, lIM, lMI, lII, lMD, lID, lDD;
    float l_match, l_mismatch, l_random;
    float pMM, pIM, pDM, pMI, pII, pDI;
    float lB0, lBstep, linv2;
    int n_max_gaps;
};

// One slot's carried state: M/I/D (log2, relative to the row's frame) and
// the row's renormalisation offset with its Kahan term.
struct State {
    float m, ii, dd, off, offc;
};

// One read position of one candidate row, for positions whose slots use
// only the first N degree columns (the stream's ncols); N = DMAX reads the
// first D.  Every thread of the row calls this.
template <int N, int RW, int RENORM>
__device__ __forceinline__ void log_step(const int* sr, int t, int a,
                                         bool real, int A, int D, int NCL,
                                         const float* tab, const Consts& k,
                                         Row<RW>& row, State& st) {
    const int nseg = 3 + 3 * D;
    const int x = sr[nseg * A];
    int em = 9, nce = NCL, sp = -1;
    int pp[N], cp[N], dn[N];
#pragma unroll
    for (int d = 0; d < N; ++d) pp[d] = cp[d] = -1, dn[d] = NCL;
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
                dn[d] = q[(3 + 2 * D + d) * A];
            }
        }
    }
    // ids at or past NCL (the sentinel among them) are log 0, tab[NCL]
    const float l_num = tab[min((unsigned)nce, (unsigned)NCL)];
    float den_t[N];
#pragma unroll
    for (int d = 0; d < N; ++d) den_t[d] = tab[min((unsigned)dn[d], (unsigned)NCL)];
    const float l_den = lse2_n(den_t);
    const bool ok_t = l_num > NEGF / 2 && l_den > NEGF / 2;
    const float l_tval = ok_t ? l_num - l_den : NEGF;
    const float l_init = l_num > NEGF / 2 ? l_num + k.linv2 : NEGF;
    float l_emit = em == x ? k.l_match : k.l_mismatch;
    l_emit = em < 4 ? l_emit : NEGF;

    const float base = st.off - st.offc;  // offset applied so far
    // ladd(lMM + mb, lIM + ib): mb is log 1 at t = 0 (ib is log 0 then)
    // and log 0 after it
    const float fbm = t == 0 ? k.lMM
        : k.lIM + (k.lB0 + __fmul_rn((float)(t - 1), k.lBstep)) - base;
    const float ib_new = (k.lB0 + __fmul_rn((float)t, k.lBstep)) - base;

    // pre-M and pre-I sums of this slot share the exp2 of M, I, D
    {
        const float sm = fmaxf(st.m, fmaxf(st.ii, st.dd));
        const float e_m = ex2(st.m - sm), e_i = ex2(st.ii - sm), e_d = ex2(st.dd - sm);
        row.put(sm + lg2(fmaxf(k.pMM * e_m + k.pIM * e_i + k.pDM * e_d, 1.2e-38f)),
                sm + lg2(fmaxf(k.pMI * e_m + k.pII * e_i + k.pDI * e_d, 1.2e-38f)));
    }
    float terms[N + 1];
#pragma unroll
    for (int d = 0; d < N; ++d) terms[d] = l_tval + row.get(0, pp[d], NEGF);
    terms[N] = l_init + fbm;
    float m_new = l_emit + lse2_n(terms);
    float i_new = k.l_random + row.get(1, sp, NEGF);

    // deletion closure within the current slot set
    {
        const float x2[2] = {k.lMD + m_new, k.lID + i_new};
        row.put(lse2_n(x2), 0.f);
    }
#pragma unroll
    for (int d = 0; d < N; ++d) terms[d] = l_tval + row.get(0, cp[d], NEGF);
    terms[N] = l_init + k.lID + ib_new;
    float fdt = lse2_n(terms);
    float acc_mx = fdt, acc_s = 1.f;  // online log-sum of the rounds
    for (int r = 0; r < k.n_max_gaps; ++r) {
        row.put(fdt, 0.f);
        float gv[N];
#pragma unroll
        for (int d = 0; d < N; ++d) gv[d] = row.get(0, cp[d], NEGF);
        fdt = l_tval + k.lDD + lse2_n(gv);
        const float hi = fmaxf(acc_mx, fdt), lo = fminf(acc_mx, fdt);
        const bool need = lo - hi > NEGLIGIBLE && hi > NEGF / 2;
        const float e = __any_sync(FULL, need) ? ex2(lo - hi) : 0.f;
        acc_s = fdt > acc_mx ? fmaf(acc_s, e, 1.f) : acc_s + e;
        acc_mx = hi;
    }
    float d_new = __any_sync(FULL, acc_s != 1.f) ? acc_mx + lg2(acc_s) : acc_mx;

    if (t % RENORM == RENORM - 1) {
        // shift by the largest live state (M, I, D of any slot, or the
        // Begin-insert chain), not by M alone: where a copy-0 edge kills
        // every M, the read lives on in I, D or the Begin chain, and the
        // frame has to follow it
        const float own = fmaxf(m_new, fmaxf(i_new, d_new));
        float shift = fmaxf(row.reduce_max(real ? own : LOW, 0), ib_new);
        shift = shift > NEGF / 2 ? shift : 0.f;
        m_new = fmaxf(m_new - shift, NEGF);
        i_new = fmaxf(i_new - shift, NEGF);
        d_new = fmaxf(d_new - shift, NEGF);
        const float y = shift - st.offc;
        const float tt = st.off + y;
        st.offc = (tt - st.off) - y;
        st.off = tt;
    }
    st.m = m_new;
    st.ii = i_new;
    st.dd = d_new;
}

template <int RW, int RENORM>
__global__ void __launch_bounds__(32 * RW * MAX_ROWS, 4 / RW) log_scorer(
    const float* __restrict__ eff,     // [C, NC]
    const float* __restrict__ linv,    // [C]  log(1 / total copy-weighted length)
    const int* __restrict__ lens,      // [B]
    Streams s,
    const int* __restrict__ ncols,     // [L, B] live degree columns (1..D)
    const float* __restrict__ lt_lin,  // [13] linear probs (LinTrans order)
    float* __restrict__ out,           // [C, B]
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
    // each row's log2 eff table over the first NCL columns; entry NCL is
    // log 0 and serves every id at or past it (the sentinel among them)
    for (int i = tid; i < G * (NCL + 1); i += nthreads) {
        const int r = i / (NCL + 1), j = i - r * (NCL + 1);
        const float e = j < NCL ? eff[(size_t)min(c0 + r, C - 1) * NC + j] : 0.f;
        smem[L.tab + r * L.tab_row + j] = e > 0.f ? log2f(e) : NEGF;
    }
    if (tid < 13) s_lt[tid] = log2f(fmaxf(lt_lin[tid], 1e-38f));
    if (tid >= 16 && tid < 29) s_lt[tid] = lt_lin[tid - 16];
    __syncthreads();

    Consts k;
    k.lMM = s_lt[0], k.lIM = s_lt[1], k.lMI = s_lt[3], k.lII = s_lt[4];
    k.lMD = s_lt[6], k.lID = s_lt[7], k.lDD = s_lt[8];
    k.l_match = s_lt[9], k.l_mismatch = s_lt[10], k.l_random = s_lt[11];
    k.pMM = s_lt[16], k.pIM = s_lt[17], k.pDM = s_lt[18];
    k.pMI = s_lt[19], k.pII = s_lt[20], k.pDI = s_lt[21];
    // The Begin chain is closed-form: the Begin match state is log 1 before
    // position 0 and empty after it, so after position t the Begin-insert
    // state is lB0 + t * lBstep (absolute).  Carrying it as a renormalised
    // state instead (the TPU kernel does) lets it decay ~12 log2 units per
    // base away from the live states, and a float32 value of that size
    // loses whole units over a 10 kb read.
    k.lB0 = k.l_random + k.lMI;
    k.lBstep = k.l_random + k.lII;
    const float lv = linv[c];
    k.linv2 = lv > NEGF / 2 ? lv * LOG2E : NEGF;
    k.n_max_gaps = n_max_gaps;
    const float l_end = s_lt[12];
    const float* tab = smem + L.tab + g * L.tab_row;
    const bool real = a < A;

    Row<RW> row = row_at<RW>(smem, L, g, a);
    State st{NEGF, NEGF, NEGF, 0.f, 0.f};
    walk_read(s_str, s, ncols, len, TP, srow, nseg, b, B, A, D,
              [&](auto n, const int* sr, int t) {
                  log_step<decltype(n)::value, RW, RENORM>(
                      sr, t, a, real, A, D, NCL, tab, k, row, st);
              });

    // end state from the frozen tables: log P = l_end + lse(M+I+D) + offset
    float mid = fmaxf(st.m, fmaxf(st.ii, st.dd));
    mid += lg2(ex2(st.m - mid) + ex2(st.ii - mid) + ex2(st.dd - mid));
    const float mx = fmaxf(row.reduce_max(real ? mid : LOW, 1), NEGF);
    const float e = real ? ex2(fmaxf(mid - mx, NEGF)) : 0.f;
    const float lse = mx + lg2(row.reduce_sum(e));
    if (a == 0 && c0 + g < C)
        out[(size_t)(c0 + g) * B + b] =
            lse > NEGF / 2 ? (l_end + lse + (st.off - st.offc)) * LN2 : -INFINITY;
}

template <int RENORM>
ScorerKernel log_scorer_for(int A) {
    if (A <= 32) return log_scorer<1, RENORM>;
    if (A <= 64) return log_scorer<2, RENORM>;
    return log_scorer<4, RENORM>;
}

}  // namespace

// K1: renormalised every 2 positions.
DBG_SCORER_ENTRIES(dbg_mapped_scores_log, log_scorer_for<2>)
// K2: renormalised at every position.
DBG_SCORER_ENTRIES(dbg_mapped_scores_log_single, log_scorer_for<1>)

extern "C" const char* dbg_cuda_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
