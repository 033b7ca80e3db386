// Gapless (diagonal) local alignment scores of one query profile against
// many targets in one launch, for NVIDIA Hopper (sm_90a): the exhaustive
// prefilter's scan.
//
// Replaces the TPU kernel `_kernel` of mmseqs2_tpu/ops/pallas_sw.py in its
// two gapless forms: `sw_pallas(gapless=True)` (end tracking, the cap applied
// at every step) and `gapless_pallas_score` (score only, the cap applied once
// to the result). The TPU layout (query rows on sublanes, a one-hot bf16 MXU
// lookup, f32 state, (score, column) packed into one float and its 2^24
// limit) is not carried over; state is int32 throughout.
//
// Per lane b, over query rows i and target columns j:
//   H[i][j] = min(max(H[i-1][j-1] + s(i, t_j), 0), cap)      (tracking)
//   H[i][j] =     max(H[i-1][j-1] + s(i, t_j), 0)            (score only)
// score = max H (score only: min(max H, cap), which is the same number:
// saturation commutes with the final max); tend = the first column reaching
// the score, qend = the smallest row attaining it in that column. A lane
// with no positive cell reports (0, lq - 1, -1).
//
// Design (the layout of sw.cu without E, F and the max-scan)
//   - One warp per lane. The 32 threads split the query rows into contiguous
//     strips of R rows held in registers; the warp walks the target columns
//     in order. A column costs one __shfl_up_sync (the diagonal crossing a
//     strip boundary) and one shuffle broadcasting the target letter.
//   - Profile rows are read as 16-byte vectors through the read-only cache;
//     target letters are fetched 32 columns at a time, one per thread.
//   - End tracking: each thread keeps (best, first column, smallest row in
//     that column); rows and columns are visited in ascending order, so a
//     strict > keeps the first. The warp reduces by (max score, min column,
//     min row).
//   - Long queries: a warp covers 32 * 32 = 1024 rows at a time. Longer
//     queries are strip-mined as in sw.cu: each chunk of 1024 rows walks all
//     columns and leaves, per column, the H of its last row in global scratch
//     (hb: nlanes x lt int32) as the next chunk's diagonal input.
//   - int32 safety: profile entries lie within +-(1 << 20) (the pad rows and
//     the pad letter score -(1 << 20)); the clamp at 0 after every add keeps
//     H >= 0, so H + s never underflows, and lq * (largest score) must stay
//     below 2^31 in the score-only form (it does by a factor of 10^4 for any
//     substitution matrix and query length the callers build).
//
// What bounds it: integer operations. A cell needs at least 3 int32
// instructions with tracking (add and max with 0 in one
// __viaddmax_s32_relu, the cap, the running best) and 2 without (no cap),
// against one profile word from L1/L2; the target contributes one byte per
// column and lane. chip_smoke.py's bound takes these counts over the cells a
// launch needs (real query rows times real target columns) against the
// card's int32 rate. This kernel executes about 5 (score only) to 8 (tracking)
// plain instructions per cell over every padded cell. Making it fast (DPX,
// int16x2 packing, skipping pad rows and columns, a flat target store) is
// later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kAlpha = 32;          // profile rows (ALPHA_PAD)
constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool better(int s1, int c1, int r1, int s2, int c2,
                                       int r2) {
  return s1 > s2 || (s1 == s2 && (c1 < c2 || (c1 == c2 && r1 < r2)));
}

template <int R>
__device__ __forceinline__ void load_scores(const int32_t* __restrict__ srow,
                                            int nvalid, bool vec, int (&s)[R]) {
  if constexpr (R % 4 == 0) {
    if (vec && nvalid == R) {
#pragma unroll
      for (int r = 0; r < R; r += 4) {
        const int4 v = __ldg(reinterpret_cast<const int4*>(srow + r));
        s[r] = v.x;
        s[r + 1] = v.y;
        s[r + 2] = v.z;
        s[r + 3] = v.w;
      }
      return;
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) s[r] = r < nvalid ? __ldg(srow + r) : 0;
}

template <int R, bool TRACK>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    gapless_kernel(const int32_t* __restrict__ prof, int lq,
                   const int8_t* __restrict__ targets, int lt, int nlanes,
                   int cap, bool vec, int32_t* __restrict__ out_score,
                   int32_t* __restrict__ out_qend,
                   int32_t* __restrict__ out_tend, int32_t* __restrict__ hb) {
  const int tid = threadIdx.x & 31;
  const int b = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (b >= nlanes) return;  // uniform across the warp
  constexpr int kChunk = 32 * R;
  const int nchunks = (lq + kChunk - 1) / kChunk;
  int32_t* hbl = hb + static_cast<size_t>(b) * lt;  // used iff nchunks > 1

  int best = 0, best_c = -1, best_r = lq - 1;

  for (int ck = 0; ck < nchunks; ++ck) {
    const int row0 = ck * kChunk + tid * R;
    const int nvalid = min(max(lq - row0, 0), R);
    const bool has_prev = ck > 0;
    const bool has_next = ck + 1 < nchunks;
    int H[R];
#pragma unroll
    for (int r = 0; r < R; ++r) H[r] = 0;
    int cb = 0, cc = -1, cr = lq - 1;  // this chunk's best
    int hdiag = 0;  // thread 0: H[row0 - 1][j - 1] from the chunk above

    for (int j0 = 0; j0 < lt; j0 += 32) {
      const int jn = min(32, lt - j0);
      int tch = 0;
      if (tid < jn)
        tch = targets[static_cast<size_t>(j0 + tid) * nlanes + b];
      for (int jj = 0; jj < jn; ++jj) {
        const int j = j0 + jj;
        const int c = __shfl_sync(kFull, tch, jj);
        if (c < 0 || c >= kAlpha) __trap();
        int s[R];
        load_scores<R>(prof + static_cast<size_t>(c) * lq + row0, nvalid, vec,
                       s);
        int hb_j = 0;
        if (has_prev && tid == 0) hb_j = hbl[j];
        int hprev = __shfl_up_sync(kFull, H[R - 1], 1);
        if (tid == 0) {
          hprev = hdiag;
          hdiag = hb_j;
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
          int h = 0;
          if (r < nvalid) {
            h = max(hprev + s[r], 0);
            if constexpr (TRACK) {
              h = min(h, cap);
              if (h > cb) {
                cb = h;
                cc = j;
                cr = row0 + r;
              }
            } else {
              cb = max(cb, h);
            }
          }
          hprev = H[r];
          H[r] = h;
        }
        if (has_next && tid == 31) hbl[j] = H[R - 1];
      }
    }
    if constexpr (TRACK) {
      if (better(cb, cc, cr, best, best_c, best_r)) {
        best = cb;
        best_c = cc;
        best_r = cr;
      }
    } else {
      best = max(best, cb);
    }
  }

#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    const int s2 = __shfl_xor_sync(kFull, best, d);
    if constexpr (TRACK) {
      const int c2 = __shfl_xor_sync(kFull, best_c, d);
      const int r2 = __shfl_xor_sync(kFull, best_r, d);
      if (better(s2, c2, r2, best, best_c, best_r)) {
        best = s2;
        best_c = c2;
        best_r = r2;
      }
    } else {
      best = max(best, s2);
    }
  }
  if (tid == 0) {
    if constexpr (TRACK) {
      const bool pos = best > 0;
      out_score[b] = best;
      out_qend[b] = pos ? best_r : lq - 1;
      out_tend[b] = pos ? best_c : -1;
    } else {
      out_score[b] = min(best, cap);  // the cap, once
    }
  }
}

template <int R>
void launch(bool track, dim3 grid, dim3 block, cudaStream_t stream,
            const int32_t* prof, int lq, const int8_t* targets, int lt,
            int nlanes, int cap, bool vec, int32_t* score, int32_t* qend,
            int32_t* tend, int32_t* hb) {
  if (track)
    gapless_kernel<R, true><<<grid, block, 0, stream>>>(
        prof, lq, targets, lt, nlanes, cap, vec, score, qend, tend, hb);
  else
    gapless_kernel<R, false><<<grid, block, 0, stream>>>(
        prof, lq, targets, lt, nlanes, cap, vec, score, qend, tend, hb);
}

}  // namespace

// Plain C entry point (bound with ctypes). track != 0 selects the tracking
// form (qend and tend are written), 0 the score-only form (qend and tend may
// be null). rstrip is the strip height R (1, 2, 4, 8, 16 or 32); hb must hold
// nlanes * lt int32 when lq > 32 * rstrip and may be null otherwise. Returns
// cudaGetLastError().
extern "C" int gapless_launch(const int32_t* prof, int lq,
                              const int8_t* targets, int lt, int nlanes,
                              int cap, int track, int vec, int rstrip,
                              int32_t* score, int32_t* qend, int32_t* tend,
                              int32_t* hb, void* stream) {
  const dim3 block(kWarpsPerBlock * 32);
  const dim3 grid((nlanes + kWarpsPerBlock - 1) / kWarpsPerBlock);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool t = track != 0, v = vec != 0;
#define GAPLESS_CASE(R)                                                     \
  case R:                                                                   \
    launch<R>(t, grid, block, st, prof, lq, targets, lt, nlanes, cap, v,    \
              score, qend, tend, hb);                                       \
    break;
  switch (rstrip) {
    GAPLESS_CASE(1)
    GAPLESS_CASE(2)
    GAPLESS_CASE(4)
    GAPLESS_CASE(8)
    GAPLESS_CASE(16)
    GAPLESS_CASE(32)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef GAPLESS_CASE
  return static_cast<int>(cudaGetLastError());
}
