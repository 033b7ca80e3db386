// Affine-gap Smith-Waterman scores and end positions for many (query,
// target) pairs in one launch, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel` of mmseqs2_tpu/ops/pallas_sw.py in its
// gapped forms: end-tracking, multi-query, query-offset (`_sw_call` with
// nq > 1 and qoff, entry point `sw_pallas_multi`) and the single-profile
// entry points `sw_pallas`, `sw_pallas_offset` and `sw_pallas_score`
// (instantiations below). The TPU layout (query rows
// on sublanes, targets on lanes, a one-hot bf16 MXU lookup, f32 state and
// packed (score, column) tracking) is not carried over: each of those works
// around the TPU's vector unit. This kernel follows the GPU design of the
// reference's own GPU path (libmarv / CUDASW++ 4.0) in its simplest form.
//
// Design
//   - One warp per lane (one query profile against one target). The 32
//     threads split the query rows into contiguous strips of R rows held in
//     registers; the warp walks the target columns in order.
//   - Diagonal: the first row of a strip takes the previous column's H of the
//     last row of the strip above through one __shfl_up_sync.
//   - Lazy F is closed exactly by the prefix-max identity
//       F[i] = max_{k<i}(Hng[k] + k*ge) - go - (i-1)*ge     (go >= ge)
//     as a running max over the thread's strip plus a warp inclusive
//     max-scan of the strip totals (5 shuffles per column).
//   - E reads the post-F H of the previous column, as the TPU kernel does.
//   - State is int32; NEG_INF = -(1 << 28) leaves room for profile scores of
//     magnitude up to 1 << 20 (the profile pad) without overflow.
//   - Query offset: rows below qoff[b] score NEG_INF, confining the lane to
//     the query suffix starting at qoff[b] (the reverse start-position pass).
//   - End tracking: each thread keeps (best, first column, smallest row in
//     that column) and the warp reduces by (max score, min column, min row),
//     the tie rules of the reference. A lane whose scores are all <= 0
//     reports (0, lq - 1, -1).
//   - Long queries: a strip holds at most 32 rows, so a warp covers 1024
//     query rows at a time. Longer queries are strip-mined: each chunk of
//     1024 rows walks all target columns and leaves, per column, the H of its
//     last row and the running max of Hng[k] + k*ge in global scratch for the
//     next chunk (hb, gb: nlanes x lt int32 each).
//
// Instantiations: the one kernel serves four entry points of ops/sw.py.
//   sw_multi   nq profiles, qsel and qoff per lane (`sw_pallas_multi`);
//   sw_single  one profile: nq = 1, qsel and qoff null (`sw_pallas`, gapped);
//   sw_offset  one profile and a per-lane qoff (`sw_pallas_offset`);
//   sw_score   TRACK = false: one profile, the score alone, which is the
//              max of H over all cells (`sw_pallas_score`); the end
//              tracking, its compares and two of the three reductions go.
//
// What bounds it: integer operations. A cell needs at least 6 int32
// instructions in Hopper's DPX forms: H - go (shared by E and F), E and F
// each one __viaddmax_s32, max(diag + s, E) one __viaddmax_s32,
// max(., F, 0) one __vimax_s32_relu, and the running best one max. That is
// the count chip_smoke.py's bound uses, against the card's int32 rate, over
// the cells a launch needs (real query rows >= qoff times real target
// columns; pad rows and columns cannot raise the best). This kernel issues
// about 18 plain int32 instructions per cell instead (the recurrence, the
// prefix-max F closure and full end tracking, without DPX) against a few
// bytes of profile read from L1/L2 and one target byte per column. Profile
// rows are read as 16-byte vectors through the read-only cache; target
// letters are fetched 32 columns at a time, one per thread, and broadcast by
// shuffle. Making it fast (DPX, int16x2 packing, skipping pad rows and
// columns, an inter-sequence layout) is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kAlpha = 32;          // profile rows per query (ALPHA_PAD)
constexpr int kWarpsPerBlock = 4;
constexpr int kNegInf = -(1 << 28);
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
    sw_multi_kernel(const int32_t* __restrict__ prof, int nq, int lq,
                    const int8_t* __restrict__ targets, int lt, int nlanes,
                    const int32_t* __restrict__ qsel,
                    const int32_t* __restrict__ qoff, int go, int ge, bool vec,
                    int32_t* __restrict__ out_score,
                    int32_t* __restrict__ out_qend,
                    int32_t* __restrict__ out_tend, int32_t* __restrict__ hb,
                    int32_t* __restrict__ gb) {
  const int tid = threadIdx.x & 31;
  const int b = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (b >= nlanes) return;  // uniform across the warp
  const int q = qsel ? __ldg(qsel + b) : 0;  // null: one profile
  if (q < 0 || q >= nq) __trap();
  const int off = qoff ? __ldg(qoff + b) : 0;
  const int32_t* pq = prof + static_cast<size_t>(q) * kAlpha * lq;
  constexpr int kChunk = 32 * R;
  const int nchunks = (lq + kChunk - 1) / kChunk;
  int32_t* hbl = hb + static_cast<size_t>(b) * lt;  // used iff nchunks > 1
  int32_t* gbl = gb + static_cast<size_t>(b) * lt;

  int best = 0, best_c = -1, best_r = lq - 1;

  for (int ck = 0; ck < nchunks; ++ck) {
    const int row0 = ck * kChunk + tid * R;
    const int nvalid = min(max(lq - row0, 0), R);
    const bool has_prev = ck > 0;
    const bool has_next = ck + 1 < nchunks;
    int H[R], E[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      H[r] = 0;
      E[r] = kNegInf;
    }
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
        load_scores<R>(pq + static_cast<size_t>(c) * lq + row0, nvalid, vec,
                       s);
        int hb_j = 0, gb_j = kNegInf;
        if (has_prev && tid == 0) {
          hb_j = hbl[j];
          gb_j = gbl[j];
        }
        int hprev = __shfl_up_sync(kFull, H[R - 1], 1);
        if (tid == 0) {
          hprev = hdiag;
          hdiag = hb_j;
        }
        // pass 1: E, H before F, and the strip's max of G = Hng + i*ge
        int gmax = kNegInf;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int i = row0 + r;
          int hng = 0;
          if (r < nvalid) {
            const int sc = i < off ? s[r] + kNegInf : s[r];
            const int e = max(H[r] - go, E[r] - ge);
            E[r] = e;
            hng = max(max(hprev + sc, e), 0);
            gmax = max(gmax, hng + i * ge);
          }
          hprev = H[r];
          H[r] = hng;
        }
        // warp inclusive max-scan of the strip maxima (thread 0 folds in
        // the rows of the chunks above)
        int v = tid == 0 ? max(gmax, gb_j) : gmax;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const int o = __shfl_up_sync(kFull, v, d);
          if (tid >= d) v = max(v, o);
        }
        int run = __shfl_up_sync(kFull, v, 1);
        if (tid == 0) run = gb_j;
        // pass 2: F, final H, end tracking
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (r < nvalid) {
            const int i = row0 + r;
            const int hng = H[r];
            const int h = max(hng, run - go - (i - 1) * ge);
            H[r] = h;
            run = max(run, hng + i * ge);
            if constexpr (TRACK) {
              if (h > cb) {
                cb = h;
                cc = j;
                cr = i;
              }
            } else {
              cb = max(cb, h);
            }
          }
        }
        if (has_next && tid == 31) {
          hbl[j] = H[R - 1];
          gbl[j] = v;
        }
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
    out_score[b] = best;
    if constexpr (TRACK) {
      const bool pos = best > 0;
      out_qend[b] = pos ? best_r : lq - 1;
      out_tend[b] = pos ? best_c : -1;
    }
  }
}

template <int R>
void launch(bool track, dim3 grid, dim3 block, cudaStream_t stream,
            const int32_t* prof, int nq, int lq, const int8_t* targets,
            int lt, int nlanes, const int32_t* qsel, const int32_t* qoff,
            int go, int ge, bool vec, int32_t* score, int32_t* qend,
            int32_t* tend, int32_t* hb, int32_t* gb) {
  if (track)
    sw_multi_kernel<R, true><<<grid, block, 0, stream>>>(
        prof, nq, lq, targets, lt, nlanes, qsel, qoff, go, ge, vec, score,
        qend, tend, hb, gb);
  else
    sw_multi_kernel<R, false><<<grid, block, 0, stream>>>(
        prof, nq, lq, targets, lt, nlanes, qsel, qoff, go, ge, vec, score,
        qend, tend, hb, gb);
}

}  // namespace

// Plain C entry point (bound with ctypes). qsel null means profile 0 for
// every lane, qoff null offset 0. track != 0 writes score, qend and tend;
// 0 writes the score alone (qend and tend may be null). rstrip is the strip
// height R (1, 2, 4, 8, 16 or 32); hb/gb must hold nlanes * lt int32 each
// when lq > 32 * rstrip and may be null otherwise. Returns
// cudaGetLastError().
extern "C" int sw_multi_launch(const int32_t* prof, int nq, int lq,
                               const int8_t* targets, int lt, int nlanes,
                               const int32_t* qsel, const int32_t* qoff,
                               int go, int ge, int vec, int rstrip, int track,
                               int32_t* score, int32_t* qend, int32_t* tend,
                               int32_t* hb, int32_t* gb, void* stream) {
  const dim3 block(kWarpsPerBlock * 32);
  const dim3 grid((nlanes + kWarpsPerBlock - 1) / kWarpsPerBlock);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool v = vec != 0, t = track != 0;
#define SW_CASE(R)                                                           \
  case R:                                                                    \
    launch<R>(t, grid, block, st, prof, nq, lq, targets, lt, nlanes, qsel,   \
              qoff, go, ge, v, score, qend, tend, hb, gb);                   \
    break;
  switch (rstrip) {
    SW_CASE(1)
    SW_CASE(2)
    SW_CASE(4)
    SW_CASE(8)
    SW_CASE(16)
    SW_CASE(32)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SW_CASE
  return static_cast<int>(cudaGetLastError());
}
