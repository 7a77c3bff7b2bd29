// Mapped log-space candidate scorers (K1 and K2) for NVIDIA Hopper (sm_90a).
//
// K1, dbg_mapped_scores_log, replaces the Pallas TPU kernel
// dbgphmm_tpu/ops/pallas_mapped.py:_make_kernel_log_packed (:718, launched
// by pallas_mapped_scores_packed).  K2, dbg_mapped_scores_log_single,
// replaces _make_kernel_log (:488, pallas_mapped_scores(space="log")): the
// same recursion, one candidate per grid row.  On Hopper both are one
// template, log_scorer<RW, RENORM>: K1 runs G candidate rows per block and
// renormalises every 2 positions, K2 one row per block and every position.
// K2 keeps the TPU kernel's per-candidate shape, but not its float32 Begin
// chain (carried as log scalars shifted by the M maximum every step, which
// loses whole nats on 10 kb reads): like K1 it uses the closed-form chain
// and the largest-live-state shift below, and computes the end state once
// from the frozen tables where the TPU kernel recomputes it at every step.
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
// Design (what bounds it, and what each choice answers).
//   * Work: one candidate row per (c, b) pair walks the read's positions in
//     order; a position is a chain of dependent gathers (M/I from the
//     previous position's parents, then 1 + n_max_gaps deletion-closure
//     rounds within the position).  The chain is short arithmetic between
//     exchanges, so the kernel is bound by instruction issue and latency,
//     not by bytes: the streams of one read position are ~2 KB and are read
//     once per block.
//   * One warp per candidate row where A <= 32 (RW = 1): thread x owns slot
//     x, the gathers through prevp / selfp / curp are __shfl_sync from the
//     owning lane, and a row never waits on another row.  Rows of 64 or 128
//     slots (RW = 2, 4 warps) exchange through a shared row with a named
//     barrier of their own (bar.sync 1 + row, 32 * RW), never a block
//     barrier.
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
//     the n_live compact edges the read chunk references (plus one "log 0"
//     entry for the sentinel and any id past n_live): no log per slot-step
//     for the numerator, none for the denominator where a slot's source
//     node has one out-edge.
//   * Streams: TP positions at a time are copied into shared memory with
//     16-byte cp.async, double-buffered; one block barrier per TP positions
//     (every row of a block scores the same read, so all rows reach it
//     together).  The G rows of a block share the copy.
//   * Occupancy: the host picks G and TP from the occupancy the runtime
//     reports for each (G, TP), so that as many rows as registers and
//     shared memory allow are resident per SM (ops/mapped_scorer.py).
//   * The closed-form Begin chain and the largest-live-state shift of the
//     first port are kept (ROADMAP "Faults found").
//
// Build (done by dbgphmm_tpu_torch/ops/_build.py at first use):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libmapped_scorer.so mapped_scorer.cu

#include "mapped_common.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
// A term more than 24 (log2 units) below the largest adds less than 2^-24
// to the sum's leading 1: dropping it changes the log-sum-exp by less than
// float32 rounding of the sum (at most ~8.6e-8 log2 units), not exactly 0.
constexpr float NEGLIGIBLE = -24.f;
constexpr int K1_MAX_ROWS = 8;  // candidate rows per block, at most

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

// Exchange of per-slot values within one candidate row.  RW == 1: the row
// is one warp and a gather is a shuffle from the owning lane.  RW > 1: the
// row's warps publish into a shared row (two phases, two values each) and
// meet at the row's named barrier.  Every lane of the row calls put / get.
template <int RW>
struct Row {
    static constexpr int AP = 32 * RW;
    float* xb;   // RW > 1: 2 phases x 2 values x AP floats
    float* red;  // RW > 1: 3 x RW floats (renorm max, end max, end sum)
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
    __device__ __forceinline__ float get(int which, int idx) const {
        if (RW == 1) {
            const float r = __shfl_sync(FULL, which ? v1 : v0, idx & 31);
            return idx >= 0 ? r : NEGF;
        }
        return idx >= 0 ? xb[phase * 2 * AP + which * AP + idx] : NEGF;
    }
    // `area` 0 serves the renormalisation, 1 the end state: the end state
    // may follow a renormalisation with no barrier in between
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
struct K1Smem {
    int tab, xb, red, consts, streams, total;
};

// Ints of one staged stream row: [emis | numce | selfp | prevp x D |
// curp x D | dence x D] each A wide, then the read base and the position's
// live degree columns; padded to 16 bytes.
__host__ __device__ __forceinline__ int k1_stream_row(int A, int D) {
    return ((3 + 3 * D) * A + 2 + 3) & ~3;
}

__host__ __device__ __forceinline__ K1Smem k1_smem(int NCL, int A, int D,
                                                   int G, int TP, int RW) {
    K1Smem m;
    const int tab_row = (NCL + 1 + 3) & ~3;
    m.tab = 0;
    m.xb = m.tab + G * tab_row;
    m.red = m.xb + (RW > 1 ? G * 4 * 32 * RW : 0);
    m.consts = m.red + (RW > 1 ? ((G * 3 * RW + 3) & ~3) : 0);
    m.streams = m.consts + 32;
    m.total = m.streams + 2 * TP * k1_stream_row(A, D);
    return m;
}

// Copy positions [t0, t0 + n) of read b into dst (n stream rows), 16 bytes
// per cp.async for the slot segments (A % 4 == 0), 4 for the two scalars.
__device__ __forceinline__ void stage_streams(int* dst, const Streams& s,
                                              const int* ncols, int t0, int n,
                                              int b, int B, int A, int D,
                                              int tid, int nthreads) {
    const int nseg = 3 + 3 * D, q = A >> 2, per_pos = nseg * q;
    const int srow = k1_stream_row(A, D);
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
__device__ __forceinline__ void step(const int* sr, int t, int a, bool real,
                                     int A, int D, int NCL, const float* tab,
                                     const Consts& k, Row<RW>& row, State& st) {
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
    for (int d = 0; d < N; ++d) terms[d] = l_tval + row.get(0, pp[d]);
    terms[N] = l_init + fbm;
    float m_new = l_emit + lse2_n(terms);
    float i_new = k.l_random + row.get(1, sp);

    // deletion closure within the current slot set
    {
        const float x2[2] = {k.lMD + m_new, k.lID + i_new};
        row.put(lse2_n(x2), 0.f);
    }
#pragma unroll
    for (int d = 0; d < N; ++d) terms[d] = l_tval + row.get(0, cp[d]);
    terms[N] = l_init + k.lID + ib_new;
    float fdt = lse2_n(terms);
    float acc_mx = fdt, acc_s = 1.f;  // online log-sum of the rounds
    for (int r = 0; r < k.n_max_gaps; ++r) {
        row.put(fdt, 0.f);
        float gv[N];
#pragma unroll
        for (int d = 0; d < N; ++d) gv[d] = row.get(0, cp[d]);
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
__global__ void __launch_bounds__(32 * RW * K1_MAX_ROWS, 4 / RW) log_scorer(
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
    const K1Smem L = k1_smem(NCL, A, D, G, TP, RW);
    const int tab_row = (NCL + 1 + 3) & ~3;
    const int srow = k1_stream_row(A, D);
    const int nseg = 3 + 3 * D;
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
        smem[L.tab + r * tab_row + j] = e > 0.f ? log2f(e) : NEGF;
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
    const float* tab = smem + L.tab + g * tab_row;
    const bool real = a < A;

    Row<RW> row;
    row.xb = smem + L.xb + g * 4 * AP;
    row.red = smem + L.red + g * 3 * RW;
    row.bar = 1 + g;
    row.a = a;
    row.phase = 0;
    State st{NEGF, NEGF, NEGF, 0.f, 0.f};

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
                case 1: step<1, RW, RENORM>(sr, t, a, real, A, D, NCL, tab, k, row, st); break;
                case 2: step<2, RW, RENORM>(sr, t, a, real, A, D, NCL, tab, k, row, st); break;
                case 3: step<3, RW, RENORM>(sr, t, a, real, A, D, NCL, tab, k, row, st); break;
                default: step<DMAX, RW, RENORM>(sr, t, a, real, A, D, NCL, tab, k, row, st);
            }
        }
    }

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
void* k1_kernel_for(int A) {
    if (A <= 32) return (void*)log_scorer<1, RENORM>;
    if (A <= 64) return (void*)log_scorer<2, RENORM>;
    return (void*)log_scorer<4, RENORM>;
}

inline int row_warps(int A) { return A <= 32 ? 1 : (A <= 64 ? 2 : 4); }

inline size_t k1_smem_bytes(int NCL, int A, int D, int G, int TP) {
    return (size_t)k1_smem(NCL, A, D, G, TP, row_warps(A)).total * 4;
}

int k1_launch(int renorm, const float* eff, const float* linv, const int* lens,
              const Streams& s, const int* ncols, const float* lt_lin,
              float* out, int C, int NC, int NCL, int B, int A, int D,
              int n_max_gaps, int G, int TP, void* stream) {
    if (C <= 0 || B <= 0) return 0;
    if (D < 1 || D > DMAX || A < 1 || A > 128 || (A & 3) || G < 1 ||
        G > K1_MAX_ROWS || TP < 1 || NCL < 1 || NCL >= NC)
        return (int)cudaErrorInvalidValue;
    void* kernel = renorm == 1 ? k1_kernel_for<1>(A) : k1_kernel_for<2>(A);
    const size_t smem = k1_smem_bytes(NCL, A, D, G, TP);
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((C + G - 1) / G, B), block(32 * row_warps(A) * G);
    void* args[] = {(void*)&eff, (void*)&linv, (void*)&lens, (void*)&s,
                    (void*)&ncols, (void*)&lt_lin, (void*)&out, &C, &NC, &NCL,
                    &B, &A, &D, &n_max_gaps, &TP};
    err = cudaLaunchKernel(kernel, grid, block, args, smem,
                           (cudaStream_t)stream);
    return (int)err;
}

}  // namespace

extern "C" {

// Resident blocks per SM of one launch configuration (0 if it cannot run);
// renorm 2 is K1, 1 is K2.
int dbg_mapped_scores_log_blocks_per_sm(int NCL, int A, int D, int G, int TP,
                                        int renorm) {
    if (A < 1 || A > 128 || G < 1 || G > K1_MAX_ROWS) return 0;
    void* kernel = renorm == 1 ? k1_kernel_for<1>(A) : k1_kernel_for<2>(A);
    const size_t smem = k1_smem_bytes(NCL, A, D, G, TP);
    if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem) != cudaSuccess) {
        cudaGetLastError();
        return 0;
    }
    int n = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &n, kernel, 32 * row_warps(A) * G, smem) != cudaSuccess) {
        cudaGetLastError();
        return 0;
    }
    return n;
}

// K1: G candidates per block, renormalised every 2 positions.  eff columns
// from NCL on (and the sentinel NC - 1 >= NCL) must be 0; ncols [L, B] is
// each position's count of leading degree columns any slot uses.  Launches
// on `stream`; returns the cudaError_t of the launch (0 = success).
int dbg_mapped_scores_log(const float* eff, const float* linv, const int* lens,
                          const int* codes, const int* emis, const int* numce,
                          const int* selfp, const int* prevp, const int* curp,
                          const int* dence, const int* ncols,
                          const float* lt_lin, float* out, int C, int NC,
                          int NCL, int L, int B, int A, int D, int n_max_gaps,
                          int G, int TP, void* stream) {
    (void)L;
    Streams s{codes, emis, numce, selfp, prevp, curp, dence};
    return k1_launch(2, eff, linv, lens, s, ncols, lt_lin, out, C, NC, NCL, B,
                     A, D, n_max_gaps, G, TP, stream);
}

// K2: one candidate per block, renormalised at every position.
int dbg_mapped_scores_log_single(const float* eff, const float* linv,
                                 const int* lens, const int* codes,
                                 const int* emis, const int* numce,
                                 const int* selfp, const int* prevp,
                                 const int* curp, const int* dence,
                                 const int* ncols, const float* lt_lin,
                                 float* out, int C, int NC, int NCL, int L,
                                 int B, int A, int D, int n_max_gaps, int TP,
                                 void* stream) {
    (void)L;
    Streams s{codes, emis, numce, selfp, prevp, curp, dence};
    return k1_launch(1, eff, linv, lens, s, ncols, lt_lin, out, C, NC, NCL, B,
                     A, D, n_max_gaps, 1, TP, stream);
}

const char* dbg_cuda_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
