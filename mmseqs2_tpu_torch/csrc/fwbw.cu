// Forward-backward posterior alignment (B5) for Hopper (sm_90a): the
// partition function of both directions, the posterior match probabilities
// P and the maximum-accuracy (MAC) DP of many (query, target) pairs.
//
// Replaces the XLA program of mmseqs2_tpu/ops/fwbw.py: `_fwbw_logzm` (:46),
// `_fwbw_p` (:100) and `_mac` (:116) under the vmap of `_fwbw_batch`
// (:241). It has no Pallas form; on a TPU XLA runs the row scans. Rows are
// target positions i, columns query positions j, go and ge negative:
//
//   zm(i,j) = (zm(i-1,j-1) + ze(i-1,j-1) + zf(i-1,j-1) + 1) e^{S(i,j)/T}
//   ze(i,j) = ze(i,j-1) e^{ge/T} + zm(i,j-1) e^{go/T}
//   zf(i,j) = zf(i-1,j) e^{ge/T} + zm(i-1,j) e^{go/T}
//
// every row scaled by the reciprocal of its zm maximum (floored at 1e-37)
// with the log of the maximum added to the row offset, as the JAX package
// rescales whole rows (not Fwbw.cpp's blocks of 16); the reversed pair
// gives the backward pass, and
// P = exp(log zm_f + log zm_b - S/T - logsumexp(log zm_f)). The MAC DP
//
//   S(i,j) = max(P - mact, S(i-1,j-1) + P - mact, S(i,j-1) - mact/2,
//                S(i-1,j) - mact/2)
//
// writes one uint8 state a cell in calculate_max4's tie order (STOP, M, I,
// D; strictly greater updates) and the first strictly largest cell.
//
// What bounds it. The rows of a pair are a chain: row i needs row i - 1
// whole, and within a row ze is a linear recurrence and the scaling needs
// the row's maximum. The work is about 70 f32 operations a cell against a
// byte of states out, so the bound is the card's f32 rate (0.9 ps a cell);
// but a warp's row is a chain of dependent steps (the scans across the
// lanes, the row max, its reciprocal), so what a design has to beat is the
// latency of each row, with the cells of a lane's columns as the only
// parallel work in it.
//
// Design.
// - A warp per (pair, direction) for queries up to 512 columns: each lane
//   holds a contiguous run of K = 8, 12 or 16 columns (the least that
//   covers the query) of zm, zf and the diagonal sum zm + ze + zf in
//   registers. The diagonal's left neighbour comes by one shuffle, the
//   in-row ze recurrence is the composition of the maps x -> e^{ge/T} x +
//   e^{go/T} zm over the lane's columns and then over the 32 lanes by
//   shuffles (only the maps' b moves: a lane's a is e^{ge/T} to its
//   number of columns), the row maximum a warp reduction. A block holds
//   several pairs, a warp each; nothing ties them. The loops over a lane's
//   columns are unrolled with no branch, so that the compiler interleaves
//   the columns' independent work.
// - Longer queries take a block a pair, W warps (8 columns a lane up to
//   2,048 columns, 16 up to 4,096, 32 past it up to the wrapper's MAX_Q of
//   16,384) and one barrier a row: each warp publishes its row's map and
//   maximum before the barrier and combines the W of them after it. A
//   warp's first column needs the previous row's value at the column left
//   of it, which the warp on its left finishes after the previous barrier;
//   so that column is left out before the barrier and folded in after it
//   from values in shared memory (every warp computes the W first columns
//   itself, in the same order, so all agree bit for bit).
// - The pairs of a launch are planned on the host (ops/fwbw.py:
//   launch_plan): the block-form pairs first, then the warp-form pairs,
//   each by target length, longest first, so that the longest chains
//   start first.
// - No division or exponential a cell that a table or a row constant can
//   take: S/T and exp(S/T) are a 32 x 33 table in shared memory (the same
//   values the JAX package computes a cell; column 32 is 0 past the
//   query's end); a row's three divisions a cell by its maximum are one
//   reciprocal a row and Markstein's correction a cell (div_rn: the
//   division's bits without its branch).
// - Two launches. fwbw_logz_kernel runs the forward pass (log zm_f out, and
//   the logsumexp of log zm_f carried online in f64) beside the backward
//   pass (log zm_b out), 8 B a cell through a warp's staging buffer,
//   coalesced. fwbw_mac_kernel then computes P and the MAC DP row by row
//   from them (fetched a row ahead by cp.async; in the 32-column form
//   into the one set of stages that fits 16 warps' shared memory, as soon
//   as the row before is in registers): P never reaches device memory
//   unless asked for (p_out). The MAC evaluates `_mac`'s f32
//   expressions in its order with rounded operations (base + jc + c, the
//   running max as a max-scan, exact in any order, run - jc - c, the
//   floor), so the same P gives the same states bit for bit; a lane keeps
//   its first largest cell and the group reduces them at the end (the
//   first maximum in row-major order, as `_mac`'s row-by-row update finds
//   it). Given P (p_in) the first launch is skipped.
// Measured by `python3 ab.py fwbw` on an H100 80GB HBM3 at 700 W: 0.906 ms
// for 512 pairs of 250-350 residues (5.3% of the bound); PERF.md §6 keeps
// the rest.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAX_ALPHA = 32;
constexpr int TAB_W = MAX_ALPHA + 1;   // a table row; column 32: no letter
constexpr int NOLET = MAX_ALPHA;
constexpr int MAX_WARPS = 16;          // warps of a block
constexpr unsigned FULL = 0xffffffffu;
constexpr uint8_t ST_STOP = 0, ST_M = 1, ST_I = 2, ST_D = 3;

// A launch's widest lane: KW = 16 columns (blocks of up to 8 warps, up to
// 255 registers a thread) or 32 (the form past 4,096 query columns, blocks
// of up to 16 warps).
template <int KW>
__host__ __device__ constexpr int max_threads() { return KW == 16 ? 256 : 512; }

// a warp's staging buffer of a row: 32 KW values, a word of padding every 32
template <int KW>
__host__ __device__ constexpr int stage_floats() { return 32 * KW + KW; }

// The MAC's sets of a warp's stages (log zm_f or P, and log zm_b): two,
// rows i and i + 1, or, at KW = 32, one, refilled once row i is in
// registers (four stages of 16 warps would pass the 227 KB a block may
// have)
template <int KW>
__host__ __device__ constexpr int mac_sets() { return KW == 32 ? 1 : 2; }

struct Pairs {
    const uint8_t* q_res;
    const long long* q_off;
    const int* q_len;
    const uint8_t* t_res;
    const long long* t_off;
    const int* t_len;
    const long long* cell_off;
};

struct Params {
    Pairs p;
    const float* mat;
    int alpha;
    float ego, ege, temp, m, c;
    const int* order;
    int n_pairs, n_block, wb;
    float* lf;
    float* lb;
    float* lse;
    const float* p_in;
    float* p_out;
    uint8_t* bt;
    float* score;
    int* bi;
    int* bj;
    float* maxp;
};

// x -> a x + b
struct Affine {
    float a, b;
};

// x first, then y: the JAX package's combination (x0 y0, y0 x1 + y1)
__device__ __forceinline__ Affine then(Affine x, Affine y) {
    return Affine{__fmul_rn(x.a, y.a),
                  __fadd_rn(__fmul_rn(y.a, x.b), y.b)};
}

// ze one column on: e^{ge/T} ze + e^{go/T} zm
__device__ __forceinline__ float step(float ze, float zm, float ego,
                                      float ege) {
    return __fadd_rn(__fmul_rn(ege, ze), __fmul_rn(zm, ego));
}

// x / d rounded to nearest, as __fdiv_rn gives it, for 0 <= x and
// 1e-37 <= d, given r = RN(1/d): Markstein's correction of x r by one
// residual, without the division's branch to its slow path. x below 2^-60
// is scaled by 2^100 first so that the residual stays exact: the quotient
// is exact wherever it is a normal number; below 2^-126 (1e-38 of the
// row's maximum) it may differ by an ulp.
__device__ __forceinline__ float div_rn(float x, float d, float r) {
    const bool tiny = x < 0x1p-60f;
    const float xs = tiny ? __fmul_rn(x, 0x1p100f) : x;
    const float q = __fmul_rn(xs, r);
    const float e = __fmaf_rn(-q, d, xs);
    const float qq = __fmaf_rn(e, r, q);
    return tiny ? __fmul_rn(qq, 0x1p-100f) : qq;
}

// What the warps of a block-form pair exchange a row, by the row's parity,
// a slot a warp, and the block's tables.
struct Shared {
    float st[MAX_ALPHA * TAB_W];   // S / T
    float es[MAX_ALPHA * TAB_W];   // exp(S / T)
    float egp[33];                 // e^{ge/T} to the powers 0-32 (a lane's
                                   // columns at most), rounded product by
                                   // product
    // forward pass: a warp's composed map and max (its first column left
    // out); the diagonal sum of its last column
    float fa[2][MAX_WARPS], fb[2][MAX_WARPS], fm[2][MAX_WARPS];
    float fds[2][MAX_WARPS];
    // MAC: a warp's max of base + jc + c (first column left out), S of its
    // first column in the row above, S of its last column, P of its first
    // column
    float mrun[2][MAX_WARPS], msp[2][MAX_WARPS], medge[2][MAX_WARPS];
    float mpf[2][MAX_WARPS];
    int firstq[MAX_WARPS];         // the letter of a warp's first column
    // the group's reductions at the end
    float red[MAX_WARPS];
    double dred[MAX_WARPS];
    int ri[MAX_WARPS], rj[MAX_WARPS];
};

// The group of warps that takes one pair, and the lane's K columns
// [j0, j0 + K) of it (some past the query's end).
struct Group {
    int pair, W, gw, base, Q, T, K, cw, j0;
};

__device__ __forceinline__ int spos(int x) { return x + (x >> 5); }

__device__ __forceinline__ void group_sync(int W) {
    if (W > 1) __syncthreads();
    else __syncwarp();
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
    const unsigned sa = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(sa),
                 "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// all groups, or all but the most recent one
__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_1() {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// The pair of this warp: block-form blocks (the first n_block) take
// order[blk] with all wb warps; the others one pair a warp. K: the columns
// a lane takes, the least of 8, 12 and 16 (8 and 16 in the block form)
// that covers the query (KW = 32: 32).
template <int KW>
__device__ __forceinline__ bool group_of(Group& g, int blk,
                                         const Params& a) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    int idx;
    if (blk < a.n_block) {
        g.W = a.wb;
        g.gw = warp;
        g.base = 0;
        idx = blk;
    } else {
        g.W = 1;
        g.gw = 0;
        g.base = warp;
        idx = a.n_block + (blk - a.n_block) * a.wb + warp;
    }
    if (idx >= a.n_pairs) return false;
    g.pair = a.order[idx];
    g.Q = a.p.q_len[g.pair];
    g.T = a.p.t_len[g.pair];
    const int nk = (g.Q + 32 * g.W - 1) / (32 * g.W);
    g.K = KW == 32 ? 32 : nk > 12 || (g.W > 1 && nk > 8) ? 16 : nk > 8 ? 12 : 8;
    g.cw = g.gw * 32 * g.K;
    g.j0 = g.cw + lane * g.K;
    return true;
}

__device__ __forceinline__ void init_shared(Shared& s, const Params& a) {
    for (int x = threadIdx.x; x < MAX_ALPHA * TAB_W; x += blockDim.x) {
        const int r = x / TAB_W, q = x % TAB_W;
        float st = 0.f, es = 0.f;
        if (r < a.alpha && q < a.alpha) {
            st = __fdiv_rn(a.mat[r * a.alpha + q], a.temp);
            es = expf(st);
        }
        s.st[x] = st;
        s.es[x] = es;
    }
    if (threadIdx.x == 0) {
        float e = 1.f;
        for (int k = 0; k <= 32; ++k) {
            s.egp[k] = e;
            e = __fmul_rn(e, a.ege);
        }
    }
    for (int x = threadIdx.x; x < 2 * MAX_WARPS; x += blockDim.x) {
        (&s.fds[0][0])[x] = 0.f;
        (&s.medge[0][0])[x] = 0.f;
        (&s.mpf[0][0])[x] = 0.f;
    }
}

// the letter (table column) of the query at pass column j
__device__ __forceinline__ int letter_at(const uint8_t* qs, int Q, int j,
                                         bool rev) {
    return j < Q ? qs[rev ? Q - 1 - j : j] : NOLET;
}

// Sum, or max, over the group's lanes; the leader's value is the group's.
__device__ __forceinline__ double group_sum(double v, Shared& s,
                                            const Group& g) {
    for (int d = 16; d; d >>= 1) v += __shfl_xor_sync(FULL, v, d);
    if (g.W == 1) return v;
    if ((threadIdx.x & 31) == 0) s.dred[g.gw] = v;
    __syncthreads();
    double r = 0.0;
    for (int w = 0; w < g.W; ++w) r += s.dred[w];
    return r;
}

__device__ __forceinline__ float group_max(float v, Shared& s,
                                           const Group& g) {
    for (int d = 16; d; d >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, d));
    if (g.W == 1) return v;
    if ((threadIdx.x & 31) == 0) s.red[g.gw] = v;
    __syncthreads();
    float r = v;
    for (int w = 0; w < g.W; ++w) r = fmaxf(r, s.red[w]);
    return r;
}

// One direction of the partition function on the lane's K columns. The
// loops over the columns are unrolled without a branch, so that the
// compiler interleaves the columns' independent work; MULTI: the block form
// (a warp's first column is left out before the barrier and folded in
// after it; W may still be 1 in the form past 4,096 columns).
template <int K, bool MULTI>
struct Fw {
    float zm[K], zf[K], ds[K], zmc[K];
    float pb[K];     // b of the composed maps of the lane's columns before k
    uint32_t ql[(K + 3) / 4];
    float ad[5];     // e^{ge/T} to the powers K, 2K, 4K, 8K, 16K
    // block form: e^{ge/T} to the powers 32K - 1 (a warp's composed map
    // without its first column) and K lane - 1 (the lane's prefix from the
    // warp's second column), by squaring as ad[]
    float wa, exa;
    float off, one, ds_last, lmax, exb;

    __device__ __forceinline__ int letter(int k) const {
        return (ql[k >> 2] >> (8 * (k & 3))) & 0xff;
    }

    __device__ __forceinline__ void init(const Shared& s, const Group& g,
                                         const uint8_t* qs, bool rev) {
#pragma unroll
        for (int w = 0; w < (K + 3) / 4; ++w) ql[w] = 0;
#pragma unroll
        for (int k = 0; k < K; ++k) {
            zm[k] = zf[k] = ds[k] = zmc[k] = 0.f;
            ql[k >> 2] |= (uint32_t)letter_at(qs, g.Q, g.j0 + k, rev)
                          << (8 * (k & 3));
        }
        ad[0] = s.egp[K];
#pragma unroll
        for (int r = 1; r < 5; ++r) ad[r] = __fmul_rn(ad[r - 1], ad[r - 1]);
        if constexpr (MULTI) {
            const int n = max((threadIdx.x & 31) - 1, 0);
            wa = exa = s.egp[K - 1];
#pragma unroll
            for (int r = 0; r < 5; ++r) {
                wa = __fmul_rn(wa, ad[r]);
                if ((n >> r) & 1) exa = __fmul_rn(exa, ad[r]);
            }
        }
        off = 0.f;
        one = 1.f;
        ds_last = 0.f;
    }

    // Before the barrier: the lane's unscaled zm and the prefixes of its ze
    // maps x -> e^{ge/T} x + e^{go/T} zm, the warp's scan of them (only
    // their b moves: a lane's a is e^{ge/T} to its number of columns) and
    // its max; in the block form a warp's first column is left out and
    // lane 31 publishes the warp's map and max.
    __device__ __forceinline__ void phase1(Shared& s, int par,
                                           const float* esrow,
                                           const Group& g, float ego,
                                           float ege) {
        const int lane = threadIdx.x & 31;
        const bool defer = MULTI && lane == 0;
        // the row above's diagonal sum at column j0 - 1 (lane - 1's last;
        // 0 left of column 0)
        float dl = __shfl_up_sync(FULL, ds_last, 1);
        if (lane == 0) dl = 0.f;
        float m[K];
        float b = 0.f;
#pragma unroll
        for (int k = 0; k < K; ++k) {
            const float d = k == 0 ? dl : ds[k - 1];
            const float z = __fmul_rn(__fadd_rn(d, one), esrow[letter(k)]);
            zmc[k] = z;
            pb[k] = b;
            const bool keep = k > 0 || !defer;
            b = keep ? step(b, z, ego, ege) : b;
            m[k] = keep ? z : 0.f;
        }
        // the lane's max, as a tree
#pragma unroll
        for (int w = 1; w < K; w <<= 1)
#pragma unroll
            for (int k = 0; k + w < K; k += 2 * w) m[k] = fmaxf(m[k], m[k + w]);
        float mx = m[0];
#pragma unroll
        for (int r = 0; r < 5; ++r) {
            const int d = 1 << r;
            const float pbb = __shfl_up_sync(FULL, b, d);
            mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, d));
            // lane l >= d: its d lanes' maps after those of lanes
            // l - 2d + 1 .. l - d (none of them lane 0)
            if (lane >= d) b = __fadd_rn(__fmul_rn(ad[r], pbb), b);
        }
        exb = __shfl_up_sync(FULL, b, 1);
        if (lane == 0) exb = 0.f;
        lmax = mx;
        if (MULTI && lane == 31) {
            const int slot = g.base + g.gw;
            s.fa[par][slot] = wa;
            s.fb[par][slot] = b;
            s.fm[par][slot] = mx;
        }
    }

    // After the barrier: in the block form the warps' first columns, the
    // row max and each warp's ze start; the row scaled. Returns the row's
    // new offset; zm[] then holds the scaled row.
    __device__ __forceinline__ float phase2(Shared& s, int par,
                                            const float* esrow,
                                            const Group& g, float ego,
                                            float ege) {
        const int lane = threadIdx.x & 31;
        float mu = lmax;
        float xs = exb;       // ze at the lane's first column (its start)
        float x0 = 0.f;       // ze at a warp's first column (block form)
        if constexpr (MULTI) {
            float zu = 0.f;
            Affine gu{1.f, 0.f};
            mu = 0.f;
            if (lane < g.W) {
                const int slot = g.base + lane;
                const float de = lane == 0 ? 0.f : s.fds[par ^ 1][slot - 1];
                zu = __fmul_rn(__fadd_rn(de, one), esrow[s.firstq[slot]]);
                gu = then(Affine{ege, __fmul_rn(zu, ego)},
                          Affine{s.fa[par][slot], s.fb[par][slot]});
                mu = fmaxf(s.fm[par][slot], zu);
            }
            Affine inc = gu;
#pragma unroll
            for (int d = 1; d < 32; d <<= 1) {
                const float pa = __shfl_up_sync(FULL, inc.a, d);
                const float pbb = __shfl_up_sync(FULL, inc.b, d);
                mu = fmaxf(mu, __shfl_xor_sync(FULL, mu, d));
                if (lane >= d) inc = then(Affine{pa, pbb}, inc);
            }
            // ze at the warp's first column: the maps of the warps left of
            // it applied to 0
            const float bw = __shfl_sync(FULL, inc.b, g.gw > 0 ? g.gw - 1 : 0);
            x0 = g.gw > 0 ? bw : 0.f;
            const float zfirst = __shfl_sync(FULL, zu, g.gw);
            // ze one past the warp's first column, then the lane's prefix
            // (K l - 1 maps) applied to it
            const float x1 = step(x0, zfirst, ego, ege);
            if (lane == 0) {
                zmc[0] = zfirst;
                xs = x1;
            } else {
                xs = __fadd_rn(__fmul_rn(exa, x1), exb);
            }
        }
        const float rowmax = fmaxf(mu, 1e-37f);
        const float r = __frcp_rn(rowmax);
        const float noff = __fadd_rn(off, logf(rowmax));
        const bool defer = MULTI && lane == 0;
#pragma unroll
        for (int k = 0; k < K; ++k) {
            // ze at column k: the lane's prefix of maps applied to its
            // start (in the block form lane 0's start is column 1)
            const float a = MULTI ? s.egp[defer ? (k > 0 ? k - 1 : 0) : k]
                                  : s.egp[k];
            float x = __fadd_rn(__fmul_rn(a, xs), pb[k]);
            if (k == 0 && defer) x = x0;
            const float zms = div_rn(zmc[k], rowmax, r);
            const float zes = div_rn(x, rowmax, r);
            const float zfs = div_rn(
                __fadd_rn(__fmul_rn(zm[k], ego), __fmul_rn(zf[k], ege)),
                rowmax, r);
            zm[k] = zms;
            zf[k] = zfs;
            ds[k] = __fadd_rn(__fadd_rn(zms, zes), zfs);
        }
        ds_last = ds[K - 1];
        if (MULTI && lane == 31) s.fds[par][g.base + g.gw] = ds_last;
        off = noff;
        one = expf(-noff);
        return noff;
    }
};

// The forward (blockIdx.x even) or backward (odd) pass of one pair: log zm
// at forward coordinates into lf or lb; the forward pass also writes
// lse[pair] = logsumexp(log zm_f).
template <int K, bool MULTI, int KW>
__device__ __forceinline__ void logz_body(Shared& s, float* dyn,
                                          const Group& g, const Params& a,
                                          int dir) {
    const int lane = threadIdx.x & 31;
    const int Q = g.Q, T = g.T;
    const bool leader = g.W > 1 ? threadIdx.x == 0 : lane == 0;
    const uint8_t* ts = a.p.t_res + a.p.t_off[g.pair];
    float* out = (dir ? a.lb : a.lf) + a.p.cell_off[g.pair];
    float* stg = dyn + (threadIdx.x >> 5) * stage_floats<KW>();
    Fw<K, MULTI> fw;
    fw.init(s, g, a.p.q_res + a.p.q_off[g.pair], dir);
    // the plain version's logsumexp: its max is the largest row offset (a
    // row's largest scaled zm is 1), its sum that of exp(log zm_f - max)
    // over the cells. Here each term is exp(log zm_f - R) for a reference R
    // at most 16 below the offsets so far (moved, and the f64 sum rescaled,
    // when an offset passes it by more), a lane's terms of a row are summed
    // in f32 and the rows' sums in f64, and the sum is scaled to the max at
    // the end.
    float M = -INFINITY, R = -INFINITY;
    double acc = 0.0;
    int tl_next = ts[dir ? T - 1 : 0];
    for (int i = 0; i < T; ++i) {
        const int par = i & 1;
        const float* esrow = s.es + tl_next * TAB_W;
        tl_next = ts[dir ? max(T - 2 - i, 0) : min(i + 1, T - 1)];
        fw.phase1(s, par, esrow, g, a.ego, a.ege);
        if (MULTI) group_sync(g.W);
        const float noff = fw.phase2(s, par, esrow, g, a.ego, a.ege);
        // log zm + offset; logf(0) is -inf, as the plain version's 0
        float l[K];
#pragma unroll
        for (int k = 0; k < K; ++k) l[k] = __fadd_rn(logf(fw.zm[k]), noff);
        if (dir == 0) {
            M = fmaxf(M, noff);
            const float Rn = noff > R + 16.f ? noff : R;
            // the lane's K terms summed as a tree in f32, then in f64
            float e[K];
#pragma unroll
            for (int k = 0; k < K; ++k) e[k] = expf(__fsub_rn(l[k], Rn));
#pragma unroll
            for (int w = 1; w < K; w <<= 1)
#pragma unroll
                for (int k = 0; k + w < K; k += 2 * w)
                    e[k] = __fadd_rn(e[k], e[k + w]);
            if (Rn != R) {
                acc *= exp((double)R - (double)Rn);
                R = Rn;
            }
            acc += (double)e[0];
        }
        __syncwarp();
#pragma unroll
        for (int k = 0; k < K; ++k) stg[spos(lane * K + k)] = l[k];
        __syncwarp();
        float v[K];
#pragma unroll
        for (int t = 0; t < K; ++t) v[t] = stg[spos(lane + 32 * t)];
        float* orow = dir ? out + (long long)(T - 1 - i) * Q + (Q - 1)
                          : out + (long long)i * Q;
        const int sgn = dir ? -1 : 1;
#pragma unroll
        for (int t = 0; t < K; ++t) {
            const int j = g.cw + lane + 32 * t;
            if (j < Q) orow[sgn * j] = v[t];
        }
    }
    if (dir == 0) {
        const double S = group_sum(acc, s, g) * exp((double)R - (double)M);
        if (leader) a.lse[g.pair] = __fadd_rn(M, logf((float)S));
    }
}

template <int KW>
__global__ void __launch_bounds__(max_threads<KW>())
    fwbw_logz_kernel(const Params a) {
    __shared__ Shared s;
    extern __shared__ float dyn[];
    const int dir = blockIdx.x & 1;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    init_shared(s, a);
    Group g;
    const bool on = group_of<KW>(g, blockIdx.x >> 1, a);
    if (on && lane == 0)
        s.firstq[warp] = letter_at(a.p.q_res + a.p.q_off[g.pair], g.Q, g.cw,
                                   dir);
    __syncthreads();
    if (!on) return;
    if (g.T == 0 || g.Q == 0) {
        if (dir == 0 && (g.W > 1 ? threadIdx.x == 0 : lane == 0))
            a.lse[g.pair] = -INFINITY;
        return;
    }
    if constexpr (KW == 32) {
        logz_body<32, true, KW>(s, dyn, g, a, dir);
    } else if (g.W > 1) {
        if (g.K == 8) logz_body<8, true, KW>(s, dyn, g, a, dir);
        else logz_body<16, true, KW>(s, dyn, g, a, dir);
    } else {
        if (g.K == 8) logz_body<8, false, KW>(s, dyn, g, a, dir);
        else if (g.K == 12) logz_body<12, false, KW>(s, dyn, g, a, dir);
        else logz_body<16, false, KW>(s, dyn, g, a, dir);
    }
}

// The MAC DP on the lane's K columns; the lane's first largest cell so far
// (rows in order, its columns in order, strictly greater updates), reduced
// over the group at the end: the first maximum in row-major order, as
// `_mac`'s row-by-row update finds it.
template <int K, bool MULTI>
struct Mac {
    float sp[K];   // S(i - 1, j) of the lane's columns, then S(i, j)
    float p[K];    // P(i, j)
    float sp_last, sdl, mex, bv;
    int bi, bj;

    __device__ __forceinline__ void init() {
#pragma unroll
        for (int k = 0; k < K; ++k) sp[k] = p[k] = 0.f;
        sp_last = 0.f;
        bv = -INFINITY;
        bi = bj = 0;
    }

    // Before the barrier: the lane's max of base + jc + c, the warp's
    // exclusive max-scan; in the block form a warp's first column is left
    // out, lane 31 publishes the warp's max, lane 0 S(i - 1) and P of its
    // first column.
    __device__ __forceinline__ void phase1(Shared& s, int par,
                                           const Group& g, float m,
                                           float c) {
        const int lane = threadIdx.x & 31;
        const bool defer = MULTI && lane == 0;
        sdl = __shfl_up_sync(FULL, sp_last, 1);
        if (lane == 0) sdl = 0.f;
        float sh[K];
#pragma unroll
        for (int k = 0; k < K; ++k) {
            const float sd = k == 0 ? sdl : sp[k - 1];
            const float P = p[k];
            const float t1 = __fsub_rn(P, m);
            const float t2 = __fsub_rn(__fadd_rn(sd, P), m);
            const float t4 = __fsub_rn(sp[k], c);
            const float b = fmaxf(fmaxf(t1, t2), t4);
            const float jc = __fmul_rn((float)(g.j0 + k), c);
            sh[k] = k > 0 || !defer ? __fadd_rn(__fadd_rn(b, jc), c)
                                    : -INFINITY;
        }
#pragma unroll
        for (int w = 1; w < K; w <<= 1)
#pragma unroll
            for (int k = 0; k + w < K; k += 2 * w)
                sh[k] = fmaxf(sh[k], sh[k + w]);
        float inc = sh[0];
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const float v = __shfl_up_sync(FULL, inc, d);
            if (lane >= d) inc = fmaxf(inc, v);
        }
        mex = __shfl_up_sync(FULL, inc, 1);
        if (lane == 0) mex = -INFINITY;
        if (MULTI) {
            const int slot = g.base + g.gw;
            if (lane == 31) s.mrun[par][slot] = inc;
            if (lane == 0) {
                s.msp[par][slot] = sp[0];
                s.mpf[par][slot] = p[0];
            }
        }
    }

    // After the barrier: in the block form the warps' first columns and
    // each warp's running max from the columns left of it; row i's S, its
    // states (into bstg, the warp's columns in order) and the lane's best.
    __device__ __forceinline__ void phase2(Shared& s, int par,
                                           const Group& g, float m, float c,
                                           uint8_t* bstg, int i) {
        const int lane = threadIdx.x & 31;
        float run = mex, sd = sdl;
        if constexpr (MULTI) {
            float shu = -INFINITY, tot = -INFINITY, sdu = 0.f;
            if (lane < g.W) {
                const int slot = g.base + lane;
                const float P = s.mpf[par][slot];
                sdu = lane == 0 ? 0.f : s.medge[par ^ 1][slot - 1];
                const float t1 = __fsub_rn(P, m);
                const float t2 = __fsub_rn(__fadd_rn(sdu, P), m);
                const float t4 = __fsub_rn(s.msp[par][slot], c);
                const float b = fmaxf(fmaxf(t1, t2), t4);
                const float jc = __fmul_rn((float)(lane * 32 * K), c);
                shu = __fadd_rn(__fadd_rn(b, jc), c);
                tot = fmaxf(s.mrun[par][slot], shu);
            }
            float inc = tot;
#pragma unroll
            for (int d = 1; d < 32; d <<= 1) {
                const float v = __shfl_up_sync(FULL, inc, d);
                if (lane >= d) inc = fmaxf(inc, v);
            }
            const float v = __shfl_sync(FULL, inc, g.gw > 0 ? g.gw - 1 : 0);
            const float pre = g.gw > 0 ? v : -INFINITY;
            const float shf = __shfl_sync(FULL, shu, g.gw);
            const float sdf = __shfl_sync(FULL, sdu, g.gw);
            run = lane == 0 ? pre : fmaxf(fmaxf(pre, shf), mex);
            if (lane == 0) sd = sdf;
        }
        // S(i, j0 - 1); 0 left of column 0
        const float jcl = __fmul_rn((float)(g.j0 - 1), c);
        float left = g.j0 > 0 ? fmaxf(__fsub_rn(__fsub_rn(run, jcl), c),
                                      __fsub_rn(-jcl, c))
                              : 0.f;
#pragma unroll
        for (int k = 0; k < K; ++k) {
            const int j = g.j0 + k;
            const float P = p[k];
            const float t1 = __fsub_rn(P, m);
            const float t2 = __fsub_rn(__fadd_rn(sd, P), m);
            const float t4 = __fsub_rn(sp[k], c);
            const float b = fmaxf(fmaxf(t1, t2), t4);
            const float jc = __fmul_rn((float)j, c);
            run = fmaxf(run, __fadd_rn(__fadd_rn(b, jc), c));
            const float sc = fmaxf(__fsub_rn(__fsub_rn(run, jc), c),
                                   __fsub_rn(-jc, c));
            const float t3 = __fsub_rn(left, c);
            uint8_t st = t1 > t2 ? ST_STOP : ST_M;
            float cur = fmaxf(t1, t2);
            st = t3 > cur ? ST_I : st;
            cur = fmaxf(cur, t3);
            st = t4 > cur ? ST_D : st;
            cur = fmaxf(cur, t4);
            bstg[lane * K + k] = st;
            const bool up = j < g.Q && cur > bv;
            bv = up ? cur : bv;
            bi = up ? i + 1 : bi;
            bj = up ? j + 1 : bj;
            sd = sp[k];
            sp[k] = sc;
            left = sc;
        }
        sp_last = sp[K - 1];
        if (MULTI && lane == 31) s.medge[par][g.base + g.gw] = sp_last;
    }

    // the first largest of (v, i, j) in row-major order
    static __device__ __forceinline__ bool before(float ov, int oi, int oj,
                                                  float v, int i, int j) {
        return ov > v || (ov == v && (oi < i || (oi == i && oj < j)));
    }

    // the group's first largest cell; the leader's value is the group's
    __device__ __forceinline__ void reduce(Shared& s, const Group& g) {
#pragma unroll
        for (int d = 16; d; d >>= 1) {
            const float ov = __shfl_xor_sync(FULL, bv, d);
            const int oi = __shfl_xor_sync(FULL, bi, d);
            const int oj = __shfl_xor_sync(FULL, bj, d);
            if (before(ov, oi, oj, bv, bi, bj)) {
                bv = ov;
                bi = oi;
                bj = oj;
            }
        }
        if (g.W == 1) return;
        if ((threadIdx.x & 31) == 0) {
            s.red[g.gw] = bv;
            s.ri[g.gw] = bi;
            s.rj[g.gw] = bj;
        }
        __syncthreads();
        for (int w = 0; w < g.W; ++w) {
            if (before(s.red[w], s.ri[w], s.rj[w], bv, bi, bj)) {
                bv = s.red[w];
                bi = s.ri[w];
                bj = s.rj[w];
            }
        }
        __syncthreads();   // s.red is group_max's next
    }
};

// P and the MAC DP row by row (PIN: the MAC on p_in): states, the first
// maximum, max P and, if p_out, P. Row i + 1's log zm_f and log zm_b (or P)
// come into the warp's stages while row i runs (with one set of stages and
// p_out, after it: P goes out through them).
template <int K, bool MULTI, bool PIN, int KW>
__device__ __forceinline__ void mac_body(Shared& s, float* dyn,
                                         const Group& g, const Params& a) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int Q = g.Q, T = g.T;
    const bool leader = g.W > 1 ? threadIdx.x == 0 : lane == 0;
    const uint8_t* ts = a.p.t_res + a.p.t_off[g.pair];
    const long long base = a.p.cell_off[g.pair];
    // a warp's sets of two stages (log zm_f or P, and log zm_b), then the
    // warp's states of a row
    constexpr int SF = stage_floats<KW>(), NS = mac_sets<KW>();
    float* stg0 = dyn + warp * 2 * NS * SF;
    uint8_t* bstg = reinterpret_cast<uint8_t*>(dyn + (blockDim.x >> 5) * 2 *
                                                         NS * SF) +
                    warp * 32 * KW;
    const float* srcf = (PIN ? a.p_in : a.lf) + base;
    const float* srcb = a.lb + base;
    uint32_t ql[(K + 3) / 4];
#pragma unroll
    for (int w = 0; w < (K + 3) / 4; ++w) ql[w] = 0;
    if (!PIN) {
        const uint8_t* qs = a.p.q_res + a.p.q_off[g.pair];
#pragma unroll
        for (int k = 0; k < K; ++k)
            ql[k >> 2] |= (uint32_t)letter_at(qs, Q, g.j0 + k, false)
                          << (8 * (k & 3));
    }
    Mac<K, MULTI> mac;
    mac.init();
    const float lse = PIN ? 0.f : a.lse[g.pair];
    float pmax = 0.f;
    // row i into its set's two stages, coalesced, asynchronously
    auto fetch = [&](int i) {
        float* sf = stg0 + (i & (NS - 1)) * 2 * SF;
        const long long row = (long long)min(i, T - 1) * Q;
#pragma unroll
        for (int t = 0; t < K; ++t) {
            const int x = lane + 32 * t, j = g.cw + x;
            if (j < Q) {
                cp_async4(&sf[spos(x)], srcf + row + j);
                if (!PIN) cp_async4(&sf[SF + spos(x)], srcb + row + j);
            }
        }
        cp_async_commit();
    };
    fetch(0);
    int tl_next = ts[0];
    for (int i = 0; i < T; ++i) {
        const int par = i & 1;
        float* sf = stg0 + (i & (NS - 1)) * 2 * SF;
        const float* strow = s.st + tl_next * TAB_W;
        tl_next = ts[min(i + 1, T - 1)];
        if constexpr (NS == 2) {
            __syncwarp();          // the stages of row i - 1 were read
            fetch(i + 1);
            cp_async_wait_1();
        } else {
            cp_async_wait_all();
        }
        __syncwarp();              // row i's stages have arrived
        float vf[K], vb[K];
#pragma unroll
        for (int k = 0; k < K; ++k) {
            vf[k] = sf[spos(lane * K + k)];
            vb[k] = PIN ? 0.f : sf[SF + spos(lane * K + k)];
        }
        if (NS == 1 && !a.p_out) {
            __syncwarp();          // row i's stages were read
            fetch(i + 1);
        }
#pragma unroll
        for (int k = 0; k < K; ++k) {
            // P, or 0 past the query's end and where log P is not finite
            // (selected with a mask: a conditional expf becomes a branch a
            // column, which keeps the compiler from interleaving them)
            float P;
            bool ok = g.j0 + k < Q;
            if (PIN) {
                P = vf[k];
            } else {
                const int q = (ql[k >> 2] >> (8 * (k & 3))) & 0xff;
                const float lp = __fsub_rn(
                    __fsub_rn(__fadd_rn(vf[k], vb[k]), strow[q]), lse);
                P = expf(lp);
                ok = ok && isfinite(lp);
            }
            P = __int_as_float(__float_as_int(P) & (ok ? ~0 : 0));
            mac.p[k] = P;
            pmax = fmaxf(pmax, P);
        }
        mac.phase1(s, par, g, a.m, a.c);
        if (MULTI) group_sync(g.W);
        mac.phase2(s, par, g, a.m, a.c, bstg, i);
        if (a.p_out) {
#pragma unroll
            for (int k = 0; k < K; ++k) sf[spos(lane * K + k)] = mac.p[k];
        }
        __syncwarp();
        uint8_t sb[K];
#pragma unroll
        for (int t = 0; t < K; ++t) sb[t] = bstg[lane + 32 * t];
        uint8_t* brow = a.bt + base + (long long)i * Q;
#pragma unroll
        for (int t = 0; t < K; ++t) {
            const int j = g.cw + lane + 32 * t;
            if (j < Q) brow[j] = sb[t];
        }
        if (a.p_out) {
            float v[K];
#pragma unroll
            for (int t = 0; t < K; ++t) v[t] = sf[spos(lane + 32 * t)];
            float* prow = a.p_out + base + (long long)i * Q;
#pragma unroll
            for (int t = 0; t < K; ++t) {
                const int j = g.cw + lane + 32 * t;
                if (j < Q) prow[j] = v[t];
            }
            if (NS == 1) {
                __syncwarp();      // P was read from the stages
                fetch(i + 1);
            }
        }
    }
    cp_async_wait_all();
    mac.reduce(s, g);
    pmax = group_max(pmax, s, g);
    if (leader) {
        a.score[g.pair] = mac.bv;
        a.bi[g.pair] = mac.bi;
        a.bj[g.pair] = mac.bj;
        a.maxp[g.pair] = pmax;
    }
}

template <int K, bool MULTI, int KW>
__device__ __forceinline__ void mac_form(Shared& s, float* dyn,
                                         const Group& g, const Params& a) {
    if (a.p_in) mac_body<K, MULTI, true, KW>(s, dyn, g, a);
    else mac_body<K, MULTI, false, KW>(s, dyn, g, a);
}

template <int KW>
__global__ void __launch_bounds__(max_threads<KW>())
    fwbw_mac_kernel(const Params a) {
    __shared__ Shared s;
    extern __shared__ float dyn[];
    const int lane = threadIdx.x & 31;
    init_shared(s, a);
    Group g;
    const bool on = group_of<KW>(g, blockIdx.x, a);
    __syncthreads();
    if (!on) return;
    if (g.T == 0 || g.Q == 0) {
        if (g.W > 1 ? threadIdx.x == 0 : lane == 0) {
            a.score[g.pair] = -INFINITY;
            a.bi[g.pair] = a.bj[g.pair] = 0;
            a.maxp[g.pair] = 0.f;
        }
        return;
    }
    if constexpr (KW == 32) {
        mac_form<32, true, KW>(s, dyn, g, a);
    } else if (g.W > 1) {
        if (g.K == 8) mac_form<8, true, KW>(s, dyn, g, a);
        else mac_form<16, true, KW>(s, dyn, g, a);
    } else {
        if (g.K == 8) mac_form<8, false, KW>(s, dyn, g, a);
        else if (g.K == 12) mac_form<12, false, KW>(s, dyn, g, a);
        else mac_form<16, false, KW>(s, dyn, g, a);
    }
}

template <int KW>
int launch(const Params& a, cudaStream_t stream) {
    const int blocks = a.n_block + (a.n_pairs - a.n_block + a.wb - 1) / a.wb;
    const int threads = 32 * a.wb;
    const size_t stage = (size_t)a.wb * stage_floats<KW>() * 4;
    const size_t mac_dyn =
        2 * mac_sets<KW>() * stage + (size_t)a.wb * 32 * KW;
    cudaError_t e;
    if (!a.p_in) {
        e = cudaFuncSetAttribute(fwbw_logz_kernel<KW>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)stage);
        if (e != cudaSuccess) return (int)e;
        fwbw_logz_kernel<KW><<<2 * blocks, threads, stage, stream>>>(a);
        e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
    }
    e = cudaFuncSetAttribute(fwbw_mac_kernel<KW>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)mac_dyn);
    if (e != cudaSuccess) return (int)e;
    fwbw_mac_kernel<KW><<<blocks, threads, mac_dyn, stream>>>(a);
    return (int)cudaGetLastError();
}

}  // namespace

// B5 on n_pairs pairs in the order of the host's plan (ops/fwbw.py:
// launch_plan): order (int32, n_pairs) lists the pairs, the first n_block
// of them a block of wb warps each, the rest wb a block, one a warp; kmax
// (16 or 32) is the launch's widest lane. Without p_in: lse (n_pairs
// floats), lf and lb (n_cells floats each) are scratch; with p_in the MAC
// runs on that P. p_out (optional) receives P. Returns a CUDA error code,
// 0 on success.
extern "C" int fwbw_launch(
    const void* q_res, const void* q_off, const void* q_len,
    const void* t_res, const void* t_off, const void* t_len,
    const void* cell_off, int n_pairs, const void* order, int n_block,
    int wb, int kmax, const void* mat, int alpha, float ego, float ege,
    float temp, float m, float c, void* lf, void* lb, void* lse,
    const void* p_in,
    void* p_out, void* bt, void* score, void* bi, void* bj, void* maxp,
    void* stream) {
    if (n_pairs <= 0) return 0;
    if ((kmax != 16 && kmax != 32) || wb < 1 ||
        wb * 32 > (kmax == 16 ? max_threads<16>() : max_threads<32>()) ||
        n_block < 0 || n_block > n_pairs || alpha < 1 || alpha > MAX_ALPHA)
        return (int)cudaErrorInvalidValue;
    if (!p_in && (!lf || !lb || !lse)) return (int)cudaErrorInvalidValue;
    Params a;
    a.p.q_res = (const uint8_t*)q_res;
    a.p.q_off = (const long long*)q_off;
    a.p.q_len = (const int*)q_len;
    a.p.t_res = (const uint8_t*)t_res;
    a.p.t_off = (const long long*)t_off;
    a.p.t_len = (const int*)t_len;
    a.p.cell_off = (const long long*)cell_off;
    a.mat = (const float*)mat;
    a.alpha = alpha;
    a.ego = ego;
    a.ege = ege;
    a.temp = temp;
    a.m = m;
    a.c = c;
    a.order = (const int*)order;
    a.n_pairs = n_pairs;
    a.n_block = n_block;
    a.wb = wb;
    a.lf = (float*)lf;
    a.lb = (float*)lb;
    a.lse = (float*)lse;
    a.p_in = (const float*)p_in;
    a.p_out = (float*)p_out;
    a.bt = (uint8_t*)bt;
    a.score = (float*)score;
    a.bi = (int*)bi;
    a.bj = (int*)bj;
    a.maxp = (float*)maxp;
    cudaStream_t s = (cudaStream_t)stream;
    return kmax == 16 ? launch<16>(a, s) : launch<32>(a, s);
}
