// Gapless (diagonal) local alignment scores of one query profile against
// many targets in one launch, for NVIDIA Hopper (sm_90a): the exhaustive
// prefilter's scan.
//
// Replaces the TPU kernel `_kernel` of mmseqs2_tpu/ops/pallas_sw.py in its
// two gapless forms: `sw_pallas(gapless=True)` (end tracking, the cap applied
// at every step) and `gapless_pallas_score` (score only, the cap applied once
// to the result). The TPU layout (query rows on sublanes, a one-hot bf16 MXU
// lookup, f32 state, (score, column) packed into one float and its 2^24
// limit) is not carried over.
//
// Per lane b, over query rows i and target columns j:
//   H[i][j] = min(max(H[i-1][j-1] + s(i, t_j), 0), cap)      (tracking)
//   H[i][j] =     max(H[i-1][j-1] + s(i, t_j), 0)            (score only)
// score = max H (score only: min(max H, cap), which is the same number:
// saturation commutes with the final max); tend = the first column reaching
// the score, qend = the smallest row attaining it in that column. A lane
// with no positive cell reports (0, lq - 1, -1), lq being the profile's
// (bucket) length.
//
// Real lengths. The caller sizes the strips from the profile's real rows
// (rows past them score at most -(1 << 20) for every letter) and may pass
// tlens[b], lane b's real columns (columns >= tlens[b] hold the pad letter
// 31, whose profile row is at most -(1 << 20) on the real rows). Under that
// contract every cell past either length has H = 0 and feeds only such
// cells, so the kernel computes neither: the strips cover the real rows
// rounded up to 32 strips, and each warp stops at its own lane's length.
// The result is the full scan's, bit for bit. tlens == null means every
// lane is lt long.
//
// Two forms, chosen by the caller from the input's range (ops/gapless.py:
// pick_form), never on failure; one kernel template, `Strip32` or `Strip16`
// holding a thread's state:
//   - int16: applies when 0 <= cap and cap + the largest profile entry <
//     32768, which holds for every call the commands make. Two query rows
//     share one 32-bit register as s16x2, so Hopper's DPX instructions do
//     two cells at once: add + clamp to [0, cap] is one
//     __viaddmin_s16x2_relu per row pair, in both kinds (a per-step cap
//     gives the score-only number too), the running best one
//     __vimax3_s16x2 per two pairs. Profile entries saturate to int16:
//     -(1 << 20) becomes -32768, and since H <= cap < 32768 a pad cell stays
//     0 and no sum leaves the 16-bit range.
//   - int32: any other input; one int32 state per cell.
//
// Design
//   - One warp per lane. The 32 threads split the query rows into contiguous
//     strips of R rows held in registers; the warp walks the target columns
//     in order. A column costs one __shfl_up_sync (the diagonal crossing a
//     strip boundary) and one shuffle broadcasting the target letter; the
//     target letters are fetched 32 columns at a time, one per thread, and
//     checked there (__trap on a letter outside 0-31).
//   - int16 layout: a thread's strip of R = 2 * NP rows row0 .. row0 + R - 1
//     is held as NP pairs (row0 + k, row0 + NP + k). The diagonal input of
//     pair k is then the old pair k - 1 as it stands (no data movement), and
//     only pair 0 needs one __byte_perm of the pair shuffled up from the
//     thread above and the thread's own last pair.
//   - The profile is packed once per call, by a small kernel launched ahead
//     of the scan on the same stream, into device memory read through L1:
//     int16 pairs or int32 rows, laid out so that the 32 threads' vectors of
//     one load are adjacent (a strip's own rows side by side would make a
//     warp's 16-byte loads stride 32-64 bytes apart and cost two to four
//     times the L1 wavefronts, enough to bound the scan).
//     Packing into shared memory per block was the other choice: at Lq
//     2,048 it takes 128 KB a block and leaves one 4-warp block per SM,
//     where L1 keeps one copy for all the blocks of an SM.
//   - End tracking without per-cell work (int16): per column the thread folds
//     its pairs into one column max (the same __vimax3_s16x2 chain as the
//     score-only running max) and compares it with its running best in one
//     __vmaxs2; only when the best rises (at most cap times per thread) does
//     it keep the column's pairs, and it searches them for the smallest row
//     once, at the end of the chunk (searching at every rise cost more: the
//     warp pays whenever one of its threads rises, which on a homologous
//     lane is most columns). Columns are visited in ascending order and the
//     search takes the smallest row, so this is the rule above: the first
//     column reaching the score, then the smallest row in it. The int32 form
//     tracks per cell with a strict >. The warp reduces by (max score, min
//     column, min row).
//   - Long queries: a warp covers 32 * R rows at a time (at most 2,048 rows in
//     the int16 form, 1,024 in the int32 form). Longer queries are
//     strip-mined as in sw.cu: each chunk walks its lane's columns and
//     leaves, per column, the H of its last row in global scratch (hb:
//     nlanes x lt int32) as the next chunk's diagonal input; hb is read and
//     written only for the columns a lane computes.
//   - int32 safety: profile entries lie within +-(1 << 20); the clamp at 0
//     after every add keeps H >= 0, so H + s never underflows, and
//     qlen * (largest score) must stay below 2^30 in the score-only form
//     (rows past lq pack as -(1 << 30)).
//
// What bounds it: integer operations. chip_smoke.py's bound takes the least
// instruction count per needed cell (real query rows times real target
// columns) of the form that runs against the card's int32 rate.

#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

#include "packed_profile.cuh"

namespace {

using packed_profile::better;
using packed_profile::group_of;
using packed_profile::kAlpha;
using packed_profile::load_strip;

constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;

// Each form walks one lane's columns the same way; `Strip` holds a thread's
// state and does one column.
template <int R, bool TRACK>
struct Strip32 {  // int32 form: R rows, one per register
  static constexpr int kWords = R;
  static constexpr int kRows = R;
  int H[R];
  int cb = 0, cc = -1, cr = 0, row0 = 0;  // tracking: this chunk's best
  __device__ void reset(int lq, int r0) {
#pragma unroll
    for (int r = 0; r < R; ++r) H[r] = 0;
    cb = 0;
    cc = -1;
    cr = lq - 1;
    row0 = r0;
  }
  __device__ unsigned last() const { return static_cast<unsigned>(H[R - 1]); }
  __device__ int last_row() const { return H[R - 1]; }
  // top: H[row0 - 1][j - 1]
  __device__ void column(const int (&s)[R], unsigned top, int cap, int j) {
    int hprev = static_cast<int>(top);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      int h = max(hprev + s[r], 0);
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
      hprev = H[r];
      H[r] = h;
    }
  }
  __device__ int chunk_best() const { return cb; }
};

template <int NP, bool TRACK>
struct Strip16 {  // int16 form: rows (row0 + k, row0 + NP + k) per register
  static constexpr int kWords = NP;
  static constexpr int kRows = 2 * NP;
  unsigned H[NP];
  // score only: the running max, s16x2; tracking: the best column max so
  // far in both halves, and the pairs of the column that set it
  unsigned best2 = 0;
  unsigned snap[TRACK ? NP : 1];
  int cc = -1, cr = 0, row0 = 0;  // tracking: this chunk's end
  __device__ void reset(int lq, int r0) {
#pragma unroll
    for (int k = 0; k < NP; ++k) H[k] = 0;
    best2 = 0;
    cc = -1;
    cr = lq - 1;
    row0 = r0;
  }
  // the high half of the last pair is the strip's last row
  __device__ unsigned last() const { return H[NP - 1]; }
  __device__ int last_row() const { return static_cast<int>(H[NP - 1] >> 16); }
  // max over both halves of all pairs, folded into m
  __device__ unsigned fold(unsigned m) const {
#pragma unroll
    for (int k = 0; k + 1 < NP; k += 2) m = __vimax3_s16x2(m, H[k], H[k + 1]);
    if constexpr (NP % 2 == 1) m = __vmaxs2(m, H[NP - 1]);
    return m;
  }
  // top's high half: H[row0 - 1][j - 1]
  __device__ void column(const unsigned (&s)[NP], unsigned top, int cap,
                         int j) {
    const unsigned cap2 = static_cast<unsigned>(cap) * 0x10001u;
    // pair 0's diagonal: (H[row0 - 1], H[row0 + NP - 1]) of column j - 1;
    // pair k's is the old pair k - 1 as it stands
    const unsigned d0 = __byte_perm(top, H[NP - 1], 0x5432);
#pragma unroll
    for (int k = NP - 1; k > 0; --k)
      H[k] = __viaddmin_s16x2_relu(H[k - 1], s[k], cap2);
    H[0] = __viaddmin_s16x2_relu(d0, s[0], cap2);
    if constexpr (TRACK) {
      const unsigned m = __vmaxs2(fold(H[0]), best2);
      if (m != best2) {  // the best rises: keep the column, find rows later
        const int cm =
            max(static_cast<int>(m & 0xffffu), static_cast<int>(m >> 16));
        best2 = static_cast<unsigned>(cm) * 0x10001u;
        cc = j;
#pragma unroll
        for (int k = 0; k < NP; ++k) snap[k] = H[k];
      }
    } else {
      best2 = fold(best2);
    }
  }
  // the chunk's best; tracking: cr becomes the smallest row holding it in
  // column cc
  __device__ int chunk_best() {
    const int cb = max(static_cast<int>(best2 & 0xffffu),
                       static_cast<int>(best2 >> 16));
    if constexpr (TRACK) {
      if (cb > 0) {
        int r = 0;
#pragma unroll
        for (int k = NP - 1; k >= 0; --k)
          if ((snap[k] >> 16) == static_cast<unsigned>(cb)) r = NP + k;
#pragma unroll
        for (int k = NP - 1; k >= 0; --k)
          if ((snap[k] & 0xffffu) == static_cast<unsigned>(cb)) r = k;
        cr = row0 + r;
      }
    }
    return cb;
  }
};

// One warp per lane. top's transfer: the int32 form shuffles H[R - 1]
// itself; the int16 form shuffles the last pair, whose high half is the
// row above the next thread's strip, and thread 0 puts the chunk above's
// row in the high half.
template <typename S, bool TRACK, bool PAIRS>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    gapless_kernel(const uint32_t* __restrict__ prof, int nwords, int lq,
                   int nchunks, const int8_t* __restrict__ targets, int lt,
                   int nlanes, const int32_t* __restrict__ tlens, int cap,
                   int32_t* __restrict__ out_score,
                   int32_t* __restrict__ out_qend,
                   int32_t* __restrict__ out_tend, int32_t* __restrict__ hb) {
  constexpr int N = S::kWords;
  constexpr int G = group_of(N);
  const int tid = threadIdx.x & 31;
  const int b = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (b >= nlanes) return;  // uniform across the warp
  const int tl = tlens == nullptr ? lt : min(max(tlens[b], 0), lt);
  int32_t* hbl = hb + static_cast<size_t>(b) * lt;  // used iff nchunks > 1

  int best = 0, best_c = -1, best_r = lq - 1;
  S st;

  for (int ck = 0; ck < nchunks; ++ck) {
    const int row0 = (ck * 32 + tid) * S::kRows;
    const uint32_t* pbase =
        prof + static_cast<size_t>(ck) * 32 * N + tid * G;
    const bool has_prev = ck > 0;
    const bool has_next = ck + 1 < nchunks;
    st.reset(lq, row0);
    unsigned hdiag = 0;  // thread 0: H[row0 - 1][j - 1] from the chunk above
    __syncwarp();        // the chunk above's hb writes are visible

    for (int j0 = 0; j0 < tl; j0 += 32) {
      const int jn = min(32, tl - j0);
      int tch = 0;
      if (tid < jn) {
        tch = targets[static_cast<size_t>(j0 + tid) * nlanes + b];
        if (static_cast<unsigned>(tch) >= kAlpha) __trap();
      }
      for (int jj = 0; jj < jn; ++jj) {
        const int j = j0 + jj;
        const int c = __shfl_sync(kFull, tch, jj);
        typename std::remove_reference<decltype(st.H[0])>::type s[N];
        load_strip<N>(pbase + static_cast<size_t>(c) * nwords, 32 * G, s);
        unsigned hb_j = 0;
        if (has_prev && tid == 0) hb_j = static_cast<unsigned>(hbl[j]);
        unsigned top = __shfl_up_sync(kFull, st.last(), 1);
        if (tid == 0) {
          top = PAIRS ? hdiag << 16 : hdiag;
          hdiag = hb_j;
        }
        st.column(s, top, cap, j);
        if (has_next && tid == 31) hbl[j] = st.last_row();
      }
    }
    const int cb = st.chunk_best();
    if constexpr (TRACK) {
      if (better(cb, st.cc, st.cr, best, best_c, best_r)) {
        best = cb;
        best_c = st.cc;
        best_r = st.cr;
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
    out_score[b] = min(best, cap);  // score-only int32: the cap, once
    if constexpr (TRACK) {
      const bool pos = best > 0;
      out_qend[b] = pos ? best_r : lq - 1;
      out_tend[b] = pos ? best_c : -1;
    }
  }
}

template <typename S, bool TRACK, bool PAIRS>
void launch(dim3 grid, dim3 block, cudaStream_t st, const uint32_t* packed,
            int nwords, int lq, int nchunks, const int8_t* targets, int lt,
            int nlanes, const int32_t* tlens, int cap, int32_t* score,
            int32_t* qend, int32_t* tend, int32_t* hb) {
  gapless_kernel<S, TRACK, PAIRS><<<grid, block, 0, st>>>(
      packed, nwords, lq, nchunks, targets, lt, nlanes, tlens, cap, score,
      qend, tend, hb);
}

}  // namespace

// Plain C entry point (bound with ctypes). int16 != 0 selects the int16
// form, 0 the int32 form; track != 0 the tracking kind (qend and tend are
// written), 0 the score-only kind (qend and tend may be null). rows is the
// strip height, a thread's rows per chunk (int32: 1, 2, 4, 8, 12, ..., 32;
// int16: 2, 4, 8, 12, ..., 64), and 32 * rows * nchunks covers the query's
// real rows. packed must hold 32 * nwords uint32, nwords = 32 * rows *
// nchunks (int32) or half of that (int16): the profile is packed there
// first. tlens may be null (every lane lt long). hb must hold nlanes * lt
// int32 when nchunks > 1 and may be null otherwise. Returns the first
// non-zero cudaGetLastError() of the two launches.
extern "C" int gapless_launch(const int32_t* prof, int lq,
                              const int8_t* targets, int lt, int nlanes,
                              const int32_t* tlens, int cap, int track,
                              int int16, int rows, int nchunks,
                              uint32_t* packed, int32_t* score, int32_t* qend,
                              int32_t* tend, int32_t* hb, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n = int16 ? rows / 2 : rows;  // words per thread and column
  const int nwords = 32 * n * nchunks;
  const int err =
      packed_profile::pack(prof, 1, lq, n, int16 != 0, 32 * nchunks, 32,
                           packed, st);
  if (err != 0) return err;
  const dim3 block(kWarpsPerBlock * 32);
  const dim3 grid((nlanes + kWarpsPerBlock - 1) / kWarpsPerBlock);
#define GAPLESS_ARGS                                                        \
  grid, block, st, packed, nwords, lq, nchunks, targets, lt, nlanes, tlens, \
      cap, score, qend, tend, hb
#define GAPLESS32(R)                                                  \
  case R:                                                             \
    if (track)                                                        \
      launch<Strip32<R, true>, true, false>(GAPLESS_ARGS);            \
    else                                                              \
      launch<Strip32<R, false>, false, false>(GAPLESS_ARGS);          \
    break;
#define GAPLESS16(R)                                                  \
  case R:                                                             \
    if (track)                                                        \
      launch<Strip16<R / 2, true>, true, true>(GAPLESS_ARGS);         \
    else                                                              \
      launch<Strip16<R / 2, false>, false, true>(GAPLESS_ARGS);       \
    break;
  if (int16) {
    switch (rows) {
      GAPLESS16(2)
      GAPLESS16(4)
      GAPLESS16(8)
      GAPLESS16(12)
      GAPLESS16(16)
      GAPLESS16(20)
      GAPLESS16(24)
      GAPLESS16(28)
      GAPLESS16(32)
      GAPLESS16(36)
      GAPLESS16(40)
      GAPLESS16(44)
      GAPLESS16(48)
      GAPLESS16(52)
      GAPLESS16(56)
      GAPLESS16(60)
      GAPLESS16(64)
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  } else {
    switch (rows) {
      GAPLESS32(1)
      GAPLESS32(2)
      GAPLESS32(4)
      GAPLESS32(8)
      GAPLESS32(12)
      GAPLESS32(16)
      GAPLESS32(20)
      GAPLESS32(24)
      GAPLESS32(28)
      GAPLESS32(32)
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  }
#undef GAPLESS16
#undef GAPLESS32
#undef GAPLESS_ARGS
  return static_cast<int>(cudaGetLastError());
}
