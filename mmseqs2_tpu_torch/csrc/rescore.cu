// Ungapped diagonal rescore of prefilter candidates, for Hopper (sm_90a).
//
// Replaces the TPU rescorer of mmseqs2_tpu/prefilter: the unfinished Pallas
// body pallas_rescore.py:_kernel and its live XLA form
// device_stages.make_rescore / make_rescore_from_letters. For each candidate
// (query qid, target id, diagonal d) it returns the exact score of the best
// ungapped segment on that diagonal (reference UngappedAlignment.cpp):
//
//   d  = the low 16 bits of diag read as signed; qs = max(d, 0), ts = max(-d, 0)
//   n  = max(min(t_len[id] - ts, q_len[qid] - qs), 0) cells
//   s_l = submat[q[qid, qs+l], t_cat[t_off[id] + ts + l]] + corr[qid, qs+l]
//   out = max(0, max_l (c_l - min(0, min_{k<l} c_k))),  c = running sum of s
//
// which is Kadane's recurrence. An invalid candidate and n = 0 give 0. All
// arithmetic is int32. The caller caps at 255 where it needs the capped
// score; nothing is rescored twice.
//
// What bounds it on this card: per cell one target byte, one query letter
// and one correction byte come in and at least three int32 operations are
// done (lookup + correction, the running sum, the running best), so at the
// lengths of real proteins the operations bind before the bytes do, and a
// candidate's 12 bytes in and 4 out are small beside its window.
//
// Design: one warp per candidate, no shape is static. The 32 lanes stride
// the window, so target bytes, query letters and corrections are read with
// coalesced byte loads and nothing past base + n is touched; the (A x A)
// matrix sits in shared memory; each tile of 32 cells is closed by one warp
// inclusive sum-scan and one inclusive min-scan (5 shuffles each), with the
// running sum and the running minimum carried from tile to tile in
// registers; one max-reduction ends the candidate. None of the TPU design is
// carried over: no row DMAs into fixed (G, LN) buffers, no one-hot matmul,
// no length ladder, no chunking to a static width, no second pass for
// saturated hits.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#define WARPS_PER_BLOCK 8
#define MAX_ALPHA 32

__global__ void __launch_bounds__(WARPS_PER_BLOCK * 32)
diag_rescore_kernel(const int* __restrict__ cqid, const int* __restrict__ cid,
                    const int* __restrict__ cdiag,
                    const uint8_t* __restrict__ cvalid, int n_cand,
                    const int8_t* __restrict__ t_cat,
                    const long long* __restrict__ t_off,
                    const int* __restrict__ t_len,
                    const uint8_t* __restrict__ q_let,
                    const int8_t* __restrict__ corr, int lq,
                    const int* __restrict__ q_len,
                    const int* __restrict__ submat, int alpha,
                    int* __restrict__ out) {
    __shared__ int sm[MAX_ALPHA * MAX_ALPHA];
    for (int i = threadIdx.x; i < alpha * alpha; i += blockDim.x)
        sm[i] = submat[i];
    __syncthreads();

    const unsigned full = 0xffffffffu;
    const int lane = threadIdx.x & 31;
    const long long c =
        (long long)blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
    if (c >= n_cand) return;              // whole warps leave together
    if (!cvalid[c]) {
        if (lane == 0) out[c] = 0;
        return;
    }
    const int qid = cqid[c];
    const int id = cid[c];
    const int d = (int)(short)(cdiag[c] & 0xFFFF);
    const int qs = d > 0 ? d : 0;
    const int ts = d < 0 ? -d : 0;
    int n = min(t_len[id] - ts, q_len[qid] - qs);
    if (n <= 0) {
        if (lane == 0) out[c] = 0;
        return;
    }
    const int8_t* tp = t_cat + t_off[id] + ts;
    const uint8_t* qp = q_let + (long long)qid * lq + qs;
    const int8_t* cp = corr + (long long)qid * lq + qs;

    int carry_sum = 0;      // sum of every cell before this tile
    int carry_min = 0;      // min(0, min of the running sums before this tile)
    int best = 0;
    for (int l0 = 0; l0 < n; l0 += 32) {
        const int l = l0 + lane;
        const bool active = l < n;
        int s = 0;
        if (active)
            s = sm[(int)qp[l] * alpha + (int)tp[l]] + (int)cp[l];
        // inclusive sum-scan over the tile
        int x = s;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            int y = __shfl_up_sync(full, x, o);
            if (lane >= o) x += y;
        }
        const int cs = carry_sum + x;       // running sum at cell l
        // inclusive min-scan of the running sums
        int m = cs;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            int y = __shfl_up_sync(full, m, o);
            if (lane >= o) m = min(m, y);
        }
        int mex = __shfl_up_sync(full, m, 1);   // min over the cells before l
        if (lane == 0) mex = INT_MAX;
        const int minpre = min(carry_min, mex);
        if (active) best = max(best, cs - minpre);
        carry_sum = __shfl_sync(full, cs, 31);
        carry_min = min(carry_min, __shfl_sync(full, m, 31));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
        best = max(best, __shfl_xor_sync(full, best, o));
    if (lane == 0) out[c] = best;
}

// Launches the kernel on `stream`; returns the CUDA error code (0 = ok).
// Every pointer is a device pointer. q_let and corr are (n_q, lq) row-major;
// submat is (alpha, alpha) row-major with alpha <= 32; letters of q_let and
// t_cat must be < alpha.
extern "C" int diag_rescore_launch(
    const void* cqid, const void* cid, const void* cdiag, const void* cvalid,
    int n_cand, const void* t_cat, const void* t_off, const void* t_len,
    const void* q_let, const void* corr, int lq, const void* q_len,
    const void* submat, int alpha, void* out, void* stream) {
    if (n_cand <= 0) return 0;
    if (alpha < 1 || alpha > MAX_ALPHA) return (int)cudaErrorInvalidValue;
    const unsigned blocks =
        (unsigned)(((long long)n_cand + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK);
    diag_rescore_kernel<<<blocks, WARPS_PER_BLOCK * 32, 0,
                          (cudaStream_t)stream>>>(
        (const int*)cqid, (const int*)cid, (const int*)cdiag,
        (const uint8_t*)cvalid, n_cand, (const int8_t*)t_cat,
        (const long long*)t_off, (const int*)t_len, (const uint8_t*)q_let,
        (const int8_t*)corr, lq, (const int*)q_len, (const int*)submat, alpha,
        (int*)out);
    return (int)cudaGetLastError();
}
