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
// every row divided by its zm maximum (floored at 1e-37) with the log of the
// scale carried, as the JAX package rescales whole rows (not Fwbw.cpp's
// blocks of 16); the reversed pair gives the backward pass, and
// P = exp(log zm_f + log zm_b - S/T - logsumexp(log zm_f)). The MAC DP
//
//   S(i,j) = max(P - mact, S(i-1,j-1) + P - mact, S(i,j-1) - mact/2,
//                S(i-1,j) - mact/2)
//
// writes one uint8 state a cell in calculate_max4's tie order (STOP, M, I,
// D; strictly greater updates) and the first strictly largest cell.
//
// Design (a simple kernel first; the pairs are independent, the rows are a
// chain):
// - fwbw_logz_kernel: one block a (pair, direction); threads over query
//   columns, each a contiguous chunk of K = ceil(Q / threads) columns, rows
//   in sequence. A row's zm, ze, zf live in shared memory (each thread its
//   own columns; a word of padding every 32 keeps a warp's strided chunk
//   accesses on distinct banks); the diagonal's left neighbour comes from a
//   per-thread edge copy of the previous row. The ze recurrence along the
//   row is a linear recurrence: each thread composes its chunk's affine
//   map, one block scan (warp shuffles, then the warps' totals) gives each
//   chunk its start, and the chunk is walked in order. Two barriers a row.
//   S is built in the kernel from the residues and the matrix (in shared
//   memory); log zm of each direction goes to global memory at forward
//   coordinates.
// - fwbw_mac_kernel: one block a pair; the logsumexp of log zm_f (a max,
//   then a sum, over the pair's cells), then row by row P and the MAC DP:
//   S(i,j) = max(base(j), S(i,j-1) - c) is solved as `_mac` solves it, by
//   the running max of base + jc + c (a block scan of max, exact in any
//   order), the row's first maximum by a block argmax. It evaluates `_mac`'s
//   expressions in its order with rounded operations (no contraction), so
//   the same P gives the same states and maximum bit for bit. Given P
//   (p_in) it skips the partition function; with p_out it writes P.
// What bounds it on this card: operations, about 60 f32 operations a cell
// (exp, log and divisions counted as one), against 1 B a cell of states
// out: at 67 TFLOP/s a cell needs 0.9 ps, the bytes 0.3 ps. This design is
// far from that: every row costs two block barriers and a scan whatever
// its width, and a pair's rows run one after another in one block.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAX_ALPHA = 32;
constexpr int MAX_THREADS = 512;
constexpr int MAX_WARPS = MAX_THREADS / 32;
constexpr int MAX_Q = 16384;
constexpr unsigned FULL = 0xffffffffu;
constexpr uint8_t ST_STOP = 0, ST_M = 1, ST_I = 2, ST_D = 3;

__host__ __device__ __forceinline__ int sidx(int j) { return j + (j >> 5); }

struct Pairs {
    const uint8_t* q_res;
    const long long* q_off;
    const int* q_len;
    const uint8_t* t_res;
    const long long* t_off;
    const int* t_len;
    const long long* cell_off;
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

__device__ float block_max(float v, float* red) {
    for (int d = 16; d; d >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, d));
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    __syncthreads();
    if (lane == 0) red[warp] = v;
    __syncthreads();
    float r = red[0];
    for (int w = 1; w < (int)(blockDim.x >> 5); ++w) r = fmaxf(r, red[w]);
    return r;
}

__device__ float block_sum(float v, float* red) {
    for (int d = 16; d; d >>= 1) v += __shfl_xor_sync(FULL, v, d);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    __syncthreads();
    if (lane == 0) red[warp] = v;
    __syncthreads();
    float r = 0.f;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) r += red[w];
    return r;
}

__global__ void __launch_bounds__(MAX_THREADS) fwbw_logz_kernel(
    Pairs p, const float* __restrict__ mat, int alpha, float ego, float ege,
    float temp, int qcap, float* __restrict__ logz_f,
    float* __restrict__ logz_b) {
    extern __shared__ float dyn[];
    __shared__ float smat[MAX_ALPHA * MAX_ALPHA];
    __shared__ float edge[3][MAX_THREADS];
    __shared__ float wmax[MAX_WARPS], wa[MAX_WARPS], wb[MAX_WARPS];
    const int pair = blockIdx.x, dir = blockIdx.y;
    const int Q = p.q_len[pair], T = p.t_len[pair];
    const uint8_t* qs = p.q_res + p.q_off[pair];
    const uint8_t* ts = p.t_res + p.t_off[pair];
    float* out = (dir ? logz_b : logz_f) + p.cell_off[pair];
    const int nt = blockDim.x, tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;
    const int K = (Q + nt - 1) / nt;
    const int j0 = min(tid * K, Q), jn = min(j0 + K, Q);
    float* zm = dyn;
    float* ze = dyn + qcap;
    float* zf = dyn + 2 * qcap;
    for (int x = tid; x < alpha * alpha; x += nt) smat[x] = mat[x];
    for (int j = j0; j < jn; ++j) {
        zm[sidx(j)] = 0.f;
        ze[sidx(j)] = 0.f;
        zf[sidx(j)] = 0.f;
    }
    edge[0][tid] = edge[1][tid] = edge[2][tid] = 0.f;
    float off = 0.f;
    __syncthreads();
    for (int i = 0; i < T; ++i) {
        const float* mrow = smat + ts[dir ? T - 1 - i : i] * alpha;
        const float one = expf(-off);
        // the previous row's values at column j0 - 1 (0 left of column 0)
        float dm = 0.f, de = 0.f, df = 0.f;
        if (tid > 0) {
            dm = edge[0][tid - 1];
            de = edge[1][tid - 1];
            df = edge[2][tid - 1];
        }
        // pass 1: zm unscaled, zf's numerator; the chunk's max and the
        // affine map from ze(j0) to ze(j0 + K)
        float lmax = 0.f;
        Affine f{1.f, 0.f};
        for (int j = j0; j < jn; ++j) {
            const int s = sidx(j);
            const float om = zm[s], oe = ze[s], of = zf[s];
            const int qj = qs[dir ? Q - 1 - j : j];
            const float es = expf(__fdiv_rn(mrow[qj], temp));
            const float zmc = __fmul_rn(
                __fadd_rn(__fadd_rn(__fadd_rn(dm, de), df), one), es);
            zf[s] = __fadd_rn(__fmul_rn(om, ego), __fmul_rn(of, ege));
            zm[s] = zmc;
            lmax = fmaxf(lmax, zmc);
            f = then(f, Affine{ege, __fmul_rn(zmc, ego)});
            dm = om;
            de = oe;
            df = of;
        }
        float wm = lmax;
        for (int d = 16; d; d >>= 1)
            wm = fmaxf(wm, __shfl_xor_sync(FULL, wm, d));
        Affine inc = f;
        for (int d = 1; d < 32; d <<= 1) {
            const float pa = __shfl_up_sync(FULL, inc.a, d);
            const float pb = __shfl_up_sync(FULL, inc.b, d);
            if (lane >= d) inc = then(Affine{pa, pb}, inc);
        }
        Affine ex{__shfl_up_sync(FULL, inc.a, 1),
                  __shfl_up_sync(FULL, inc.b, 1)};
        if (lane == 0) ex = Affine{1.f, 0.f};
        if (lane == 31) {
            wmax[warp] = wm;
            wa[warp] = inc.a;
            wb[warp] = inc.b;
        }
        __syncthreads();
        float rowmax = 0.f;
        Affine pre{1.f, 0.f};
        for (int w = 0; w < nwarps; ++w) {
            rowmax = fmaxf(rowmax, wmax[w]);
            if (w < warp) pre = then(pre, Affine{wa[w], wb[w]});
        }
        pre = then(pre, ex);
        rowmax = fmaxf(rowmax, 1e-37f);
        // pass 2: ze from its value at j0 (the scan applied to ze(0) = 0),
        // everything scaled, log zm out
        float x = pre.b;
        const float noff = __fadd_rn(off, logf(rowmax));
        for (int j = j0; j < jn; ++j) {
            const int s = sidx(j);
            const float zmc = zm[s];
            const float zms = __fdiv_rn(zmc, rowmax);
            zm[s] = zms;
            ze[s] = __fdiv_rn(x, rowmax);
            zf[s] = __fdiv_rn(zf[s], rowmax);
            x = __fadd_rn(__fmul_rn(ege, x), __fmul_rn(zmc, ego));
            const float l = zms > 0.f ? __fadd_rn(logf(zms), noff) : -INFINITY;
            const long long cell = dir
                ? (long long)(T - 1 - i) * Q + (Q - 1 - j)
                : (long long)i * Q + j;
            out[cell] = l;
        }
        off = noff;
        if (jn > j0) {
            edge[0][tid] = zm[sidx(jn - 1)];
            edge[1][tid] = ze[sidx(jn - 1)];
            edge[2][tid] = zf[sidx(jn - 1)];
        }
        __syncthreads();
    }
}

__global__ void __launch_bounds__(MAX_THREADS) fwbw_mac_kernel(
    Pairs p, const float* __restrict__ mat, int alpha, float temp, float m,
    float c, int qcap, const float* __restrict__ logz_f,
    const float* __restrict__ logz_b, const float* __restrict__ p_in,
    float* __restrict__ p_out, uint8_t* __restrict__ bt,
    float* __restrict__ score, int* __restrict__ bi_out,
    int* __restrict__ bj_out, float* __restrict__ maxp_out) {
    extern __shared__ float dyn[];
    __shared__ float smat[MAX_ALPHA * MAX_ALPHA];
    __shared__ float red[MAX_WARPS], wrun[MAX_WARPS], wbest[MAX_WARPS];
    __shared__ int wj[MAX_WARPS];
    const int pair = blockIdx.x;
    const int Q = p.q_len[pair], T = p.t_len[pair];
    const uint8_t* qs = p.q_res + p.q_off[pair];
    const uint8_t* ts = p.t_res + p.t_off[pair];
    const long long base = p.cell_off[pair];
    const int nt = blockDim.x, tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;
    const int K = (Q + nt - 1) / nt;
    const int j0 = min(tid * K, Q), jn = min(j0 + K, Q);
    // S of the previous and the current row, as `_mac`'s s_full: index 0
    // the boundary 0, index j + 1 column j
    float* sa = dyn;
    float* sb = dyn + qcap;
    float* prow = dyn + 2 * qcap;
    for (int x = tid; x < alpha * alpha; x += nt) smat[x] = mat[x];
    for (int j = tid; j <= Q; j += nt) sa[sidx(j)] = sb[sidx(j)] = 0.f;
    const float* lf = p_in ? nullptr : logz_f + base;
    const float* lb = p_in ? nullptr : logz_b + base;
    float lse = 0.f;
    if (!p_in) {
        const long long n = (long long)T * Q;
        float mx = -INFINITY;
        for (long long x = tid; x < n; x += nt) mx = fmaxf(mx, lf[x]);
        mx = block_max(mx, red);
        float s = 0.f;
        for (long long x = tid; x < n; x += nt) s += expf(lf[x] - mx);
        s = block_sum(s, red);
        lse = __fadd_rn(mx, logf(s));
    }
    __syncthreads();
    float best = -INFINITY, pmax = 0.f;
    int bi = 0, bj = 0;
    for (int i = 0; i < T; ++i) {
        const float* so = (i & 1) ? sb : sa;
        float* sn = (i & 1) ? sa : sb;
        const float* mrow = smat + ts[i] * alpha;
        const long long row = (long long)i * Q;
        // pass 1: P and base + jc + c; the chunk's max of the latter
        float run = -INFINITY;
        for (int j = j0; j < jn; ++j) {
            float P;
            if (p_in) {
                P = p_in[base + row + j];
            } else {
                const float lp = __fsub_rn(
                    __fsub_rn(__fadd_rn(lf[row + j], lb[row + j]),
                              __fdiv_rn(mrow[qs[j]], temp)), lse);
                P = isfinite(lp) ? expf(lp) : 0.f;
            }
            if (p_out) p_out[base + row + j] = P;
            pmax = fmaxf(pmax, P);
            prow[sidx(j)] = P;
            const float t1 = __fsub_rn(P, m);
            const float t2 = __fsub_rn(__fadd_rn(so[sidx(j)], P), m);
            const float t4 = __fsub_rn(so[sidx(j + 1)], c);
            const float b = fmaxf(fmaxf(t1, t2), t4);
            const float jc = __fmul_rn((float)j, c);
            run = fmaxf(run, __fadd_rn(__fadd_rn(b, jc), c));
        }
        float inc = run;
        for (int d = 1; d < 32; d <<= 1) {
            const float v = __shfl_up_sync(FULL, inc, d);
            if (lane >= d) inc = fmaxf(inc, v);
        }
        float ex = __shfl_up_sync(FULL, inc, 1);
        if (lane == 0) ex = -INFINITY;
        if (lane == 31) wrun[warp] = inc;
        __syncthreads();
        for (int w = 0; w < warp; ++w) ex = fmaxf(ex, wrun[w]);
        // pass 2: the running max from the columns left of the chunk, S,
        // the states and the chunk's first maximum
        float left = 0.f;            // S(i, j0 - 1); 0 left of column 0
        if (j0 > 0) {
            const float jcl = __fmul_rn((float)(j0 - 1), c);
            left = fmaxf(__fsub_rn(__fsub_rn(ex, jcl), c),
                         __fsub_rn(-jcl, c));
        }
        float r = ex, lbest = -INFINITY;
        int lj = 0x7fffffff;
        for (int j = j0; j < jn; ++j) {
            const float P = prow[sidx(j)];
            const float t1 = __fsub_rn(P, m);
            const float t2 = __fsub_rn(__fadd_rn(so[sidx(j)], P), m);
            const float t4 = __fsub_rn(so[sidx(j + 1)], c);
            const float b = fmaxf(fmaxf(t1, t2), t4);
            const float jc = __fmul_rn((float)j, c);
            r = fmaxf(r, __fadd_rn(__fadd_rn(b, jc), c));
            const float scur = fmaxf(__fsub_rn(__fsub_rn(r, jc), c),
                                     __fsub_rn(-jc, c));
            const float t3 = __fsub_rn(left, c);
            uint8_t st = t1 > t2 ? ST_STOP : ST_M;
            float cur = fmaxf(t1, t2);
            if (t3 > cur) st = ST_I;
            cur = fmaxf(cur, t3);
            if (t4 > cur) st = ST_D;
            cur = fmaxf(cur, t4);
            bt[base + row + j] = st;
            if (cur > lbest) {
                lbest = cur;
                lj = j;
            }
            sn[sidx(j + 1)] = scur;
            left = scur;
        }
        for (int d = 16; d; d >>= 1) {
            const float ov = __shfl_xor_sync(FULL, lbest, d);
            const int oj = __shfl_xor_sync(FULL, lj, d);
            if (ov > lbest || (ov == lbest && oj < lj)) {
                lbest = ov;
                lj = oj;
            }
        }
        if (lane == 0) {
            wbest[warp] = lbest;
            wj[warp] = lj;
        }
        __syncthreads();
        float rmax = -INFINITY;
        int rj = 0x7fffffff;
        for (int w = 0; w < nwarps; ++w) {
            if (wbest[w] > rmax || (wbest[w] == rmax && wj[w] < rj)) {
                rmax = wbest[w];
                rj = wj[w];
            }
        }
        if (rmax > best) {
            best = rmax;
            bi = i + 1;
            bj = rj + 1;
        }
    }
    pmax = block_max(pmax, red);
    if (tid == 0) {
        score[pair] = best;
        bi_out[pair] = bi;
        bj_out[pair] = bj;
        maxp_out[pair] = pmax;
    }
}

}  // namespace

// B5 on n_pairs pairs whose queries have at most max_q residues. Without
// p_in: both directions' log zm into logz_f and logz_b (n_cells floats
// each, scratch), then P and the MAC; with p_in the MAC on that P. p_out
// (optional) receives P. Returns a CUDA error code, 0 on success.
extern "C" int fwbw_launch(
    const void* q_res, const void* q_off, const void* q_len,
    const void* t_res, const void* t_off, const void* t_len,
    const void* cell_off, int n_pairs, int max_q, const void* mat, int alpha,
    float ego, float ege, float temp, float m, float c, void* logz_f,
    void* logz_b, const void* p_in, void* p_out, void* bt, void* score,
    void* bi, void* bj, void* maxp, void* stream) {
    if (n_pairs <= 0) return 0;
    if (max_q < 1 || max_q > MAX_Q || alpha < 1 || alpha > MAX_ALPHA)
        return (int)cudaErrorInvalidValue;
    if (!p_in && (!logz_f || !logz_b)) return (int)cudaErrorInvalidValue;
    int threads = ((max_q + 1) / 2 + 31) / 32 * 32;
    if (threads > MAX_THREADS) threads = MAX_THREADS;
    const int qcap = sidx(max_q + 1) + 1;
    const size_t dyn = 3 * (size_t)qcap * sizeof(float);
    cudaError_t e = cudaFuncSetAttribute(
        fwbw_logz_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)dyn);
    if (e != cudaSuccess) return (int)e;
    e = cudaFuncSetAttribute(fwbw_mac_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)dyn);
    if (e != cudaSuccess) return (int)e;
    Pairs pr;
    pr.q_res = (const uint8_t*)q_res;
    pr.q_off = (const long long*)q_off;
    pr.q_len = (const int*)q_len;
    pr.t_res = (const uint8_t*)t_res;
    pr.t_off = (const long long*)t_off;
    pr.t_len = (const int*)t_len;
    pr.cell_off = (const long long*)cell_off;
    cudaStream_t s = (cudaStream_t)stream;
    if (!p_in) {
        fwbw_logz_kernel<<<dim3(n_pairs, 2), threads, dyn, s>>>(
            pr, (const float*)mat, alpha, ego, ege, temp, qcap,
            (float*)logz_f, (float*)logz_b);
        e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
    }
    fwbw_mac_kernel<<<n_pairs, threads, dyn, s>>>(
        pr, (const float*)mat, alpha, temp, m, c, qcap,
        (const float*)logz_f, (const float*)logz_b, (const float*)p_in,
        (float*)p_out, (uint8_t*)bt, (float*)score, (int*)bi, (int*)bj,
        (float*)maxp);
    return (int)cudaGetLastError();
}
