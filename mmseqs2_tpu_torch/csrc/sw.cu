// Affine-gap Smith-Waterman scores and end positions for many (query,
// target) pairs in one launch, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel` of mmseqs2_tpu/ops/pallas_sw.py in its
// gapped forms. The TPU layout (query rows on sublanes, targets on lanes, a
// one-hot bf16 MXU lookup, f32 state and packed (score, column) tracking) is
// not carried over: each of those works around the TPU's vector unit. Both
// kernels here follow the GPU design of the reference's own GPU path
// (libmarv / CUDASW++ 4.0): one warp per lane.
//
// Semantics (those of the TPU kernel), per lane over query rows i and target
// columns j, with a gap of length k costing go + (k - 1) * ge, go >= ge >= 0:
//   E[i][j] = max(E[i][j-1] - ge, H[i][j-1] - go)
//   Hng     = max(H[i-1][j-1] + s(i, t_j), E[i][j], 0)
//   F[i][j] = max(F[i-1][j] - ge, H[i-1][j] - go)
//   H[i][j] = max(Hng, F[i][j])
// E reads the H after F, as the TPU kernel does. (The port's dp.sw_scan
// reads the H before F; every H is the same under both rules, because a
// post-F step F[i][j] - go into E has a pre-F path of equal score ending in
// the same cell: down column j's gap from the cell that set F, then along
// its row. tests/test_torch_sw.py holds the two equal.) The score is the
// best H; the target end is the first column reaching it and the query end
// the smallest row attaining it in that column. A lane with no positive
// cell reports (0, lq - 1, -1).
//
// Two kernels:
//   sw_multi_kernel   sw_multi (`sw_pallas_multi`: nq profiles, qsel and
//                     qoff per lane) and sw_offset (`sw_pallas_offset`: one
//                     profile, qoff per lane). Every padded cell, int32.
//   sw_single_kernel  sw_single (`sw_pallas`, gapped; TRACK) and sw_score
//                     (`sw_pallas_score`: the score alone): one profile, no
//                     offset; real lengths, a packed profile, an int16 DPX
//                     form. Its design follows.
//
// sw_single_kernel
//   - Lazy F by the exact prefix-max closure. Writing F' = F + go,
//     F'[i+1] = max(F'[i] - ge, Hng[i]) (go >= ge), so F' entering a strip
//     of R rows is max(F' entering the strip above - R * ge, the F' its own
//     rows give alone). Pass 1 computes E, Hng and that strip summary; a warp
//     inclusive max-scan of summary + t * R * ge (the ramp taken from the
//     chunk's first strip t = 0, so below 32 * R * ge, in int32) gives every
//     strip its entering F'; pass 2 walks F' down the strip, H = max(Hng,
//     F' - go). F' below 0 acts as F' = 0 (F <= -go raises neither H, since
//     Hng >= 0, nor the next F'), so it is clamped there, and the state is
//     E' = E + go, F' and H, all in [0, score]; each starts at 0, which
//     gives the H of -inf. The one intermediate below 0 is E' - go or
//     F' - go, at least -go, and diag + s, at least -32768 in the int16
//     form (profile entries saturate there, and diag >= 0).
//   - Two forms, chosen by the caller from the input's range (ops/sw.py:
//     pick_form), never on failure; one kernel template over `Sw32` or
//     `Sw16`, which hold a thread's state:
//       int16: two rows per 32-bit register as s16x2, the pairs (row0 + k,
//         row0 + NP + k) of a strip of R = 2 * NP rows, so that pair k's
//         diagonal is the old pair k - 1 as it stands and pair 0's one
//         __byte_perm. Every step of the recurrence is one DPX instruction
//         for two cells (__viaddmax_s16x2 for E', F' and H,
//         __viaddmax_s16x2_relu for Hng). The F' chain of the high half
//         starts inside the strip, so its entering F' is closed in two steps:
//         max(F' entering the strip - NP * ge, the low half's own F' out).
//         Exact when score = q_len * max(profile max, 0) < 32768 and go <
//         32768: then no sum leaves the 16-bit range.
//       int32: any other input; one row per register, the same recurrence
//         in __viaddmax_s32 / __viaddmax_s32_relu.
//   - Real lengths. The strips cover q_len (the profile's real rows; rows
//     past it score at most -(1 << 20) for every letter) rounded to the
//     strip plan, and each warp stops at tlens[b] (columns past it hold
//     letter 31, whose profile row is at most -(1 << 20) on the real rows).
//     Unlike a gapless cell, a cell past a length need not be 0: a gap can
//     run into it. But every such cell is strictly below the H of a real
//     cell, or equal to one in an earlier column or a smaller row (go = 0,
//     reached by a gap), and it feeds only cells past the lengths. So
//     skipping them keeps the score and the (first column, smallest row)
//     end, bit for bit. tlens == null means every lane is lt long.
//   - The profile is packed once per call (packed_profile.cuh) so that the
//     32 threads' vectors of one load are adjacent.
//   - End tracking: the int16 form folds a column's pairs into one max
//     (__vimax3_s16x2) and compares it with its best in one __vmaxs2; on a
//     rise it keeps the column's pairs and searches them for the smallest
//     row once, at the end of the chunk. The int32 form tracks per cell with
//     a strict >. The warp reduces by (max score, min column, min row).
//   - Long queries: a warp covers 32 * R rows at a time (R <= 64 in the
//     int16 form, 32 in the int32 form). Longer queries are strip-mined:
//     each chunk walks its lane's columns and leaves, per column, the H and
//     the F' of its last row in global scratch (hb, gb: nlanes x lt int32),
//     read and written only for the columns a lane computes.
//
// What bounds it: integer operations. A cell needs at least 6 int32
// instructions in Hopper's DPX forms: H - go (shared by E and F), E and F
// each one __viaddmax_s32, max(diag + s, E) one __viaddmax_s32,
// max(., F, 0) one __vimax_s32_relu, and the running best one max; the
// int16 form does the five steps for two cells per instruction and the
// running best for four (one __vimax3_s16x2): 2.75 a cell. chip_smoke.py's
// bound takes that count of the form that runs, at the card's int32 rate,
// over the cells a launch needs (real query rows, at or past qoff, times
// real target columns). sw_multi_kernel issues about 18 plain int32
// instructions per padded cell (the recurrence, the prefix-max F closure
// and full end tracking, without DPX); its profile rows are read as 16-byte
// vectors, a strip's rows side by side.

#include <cstdint>
#include <cuda_runtime.h>

#include "packed_profile.cuh"

namespace {

using packed_profile::better;
using packed_profile::group_of;
using packed_profile::kAlpha;
using packed_profile::load_strip;

constexpr int kWarpsPerBlock = 4;
constexpr int kNegInf = -(1 << 28);
constexpr unsigned kFull = 0xffffffffu;

// -- sw_multi_kernel (sw_multi, sw_offset) ------------------------------------
//
// One warp per lane. The 32 threads split the query rows into contiguous
// strips of R rows held in registers; the warp walks the target columns in
// order. The first row of a strip takes the previous column's H of the last
// row of the strip above through one __shfl_up_sync. Lazy F is closed exactly
// by the prefix-max identity
//   F[i] = max_{k<i}(Hng[k] + k*ge) - go - (i-1)*ge     (go >= ge)
// as a running max over the thread's strip plus a warp inclusive max-scan of
// the strip totals (5 shuffles per column). State is int32; NEG_INF =
// -(1 << 28) leaves room for profile scores of magnitude up to 1 << 20 (the
// profile pad) without overflow. Rows below qoff[b] score NEG_INF, confining
// the lane to the query suffix starting at qoff[b] (the reverse start-position
// pass). Each thread keeps (best, first column, smallest row in that column).
// Long queries: a warp covers 1024 query rows at a time; each chunk of 1024
// rows walks all target columns and leaves, per column, the H of its last row
// and the running max of Hng[k] + k*ge in global scratch for the next chunk
// (hb, gb: nlanes x lt int32 each).

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

template <int R>
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
            if (h > cb) {
              cb = h;
              cc = j;
              cr = i;
            }
          }
        }
        if (has_next && tid == 31) {
          hbl[j] = H[R - 1];
          gbl[j] = v;
        }
      }
    }
    if (better(cb, cc, cr, best, best_c, best_r)) {
      best = cb;
      best_c = cc;
      best_r = cr;
    }
  }

#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    const int s2 = __shfl_xor_sync(kFull, best, d);
    const int c2 = __shfl_xor_sync(kFull, best_c, d);
    const int r2 = __shfl_xor_sync(kFull, best_r, d);
    if (better(s2, c2, r2, best, best_c, best_r)) {
      best = s2;
      best_c = c2;
      best_r = r2;
    }
  }
  if (tid == 0) {
    out_score[b] = best;
    const bool pos = best > 0;
    out_qend[b] = pos ? best_r : lq - 1;
    out_tend[b] = pos ? best_c : -1;
  }
}


// -- sw_single_kernel (sw_single, sw_score) -----------------------------------

// int32 form: R rows, one per register.
template <int R, bool TRACK>
struct Sw32 {
  using Word = int;
  static constexpr int kWords = R;
  static constexpr int kRows = R;
  int H[R], E[R];  // E holds E' = E + go
  int go = 0, ge = 0;
  int cb = 0, cc = -1, cr = 0, row0 = 0;  // tracking: this chunk's best
  __device__ void setup(int go_, int ge_) {
    go = go_;
    ge = ge_;
  }
  __device__ void reset(int lq, int r0) {
#pragma unroll
    for (int r = 0; r < R; ++r) H[r] = E[r] = 0;
    cb = 0;
    cc = -1;
    cr = lq - 1;
    row0 = r0;
  }
  __device__ unsigned last() const { return static_cast<unsigned>(H[R - 1]); }
  __device__ int last_row() const { return H[R - 1]; }
  // E', Hng (into H) and the F' leaving the strip from its own rows; top:
  // H[row0 - 1][j - 1]
  __device__ int pass1(const int (&s)[R], unsigned top) {
#pragma unroll
    for (int r = R - 1; r >= 0; --r) {
      const int diag = r > 0 ? H[r - 1] : static_cast<int>(top);
      E[r] = __viaddmax_s32(E[r], -ge, H[r]);
      H[r] = __viaddmax_s32_relu(diag, s[r], E[r] - go);
    }
    int f = 0;
#pragma unroll
    for (int r = 0; r < R; ++r) f = __viaddmax_s32(f, -ge, H[r]);
    return f;
  }
  // fin: F' entering row0
  __device__ void pass2(int fin, int j) {
    int f = fin;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int h = __viaddmax_s32(f, -go, H[r]);
      f = __viaddmax_s32(f, -ge, H[r]);
      H[r] = h;
      if constexpr (TRACK) {
        if (h > cb) {
          cb = h;
          cc = j;
          cr = row0 + r;
        }
      } else {
        cb = max(cb, h);
      }
    }
  }
  __device__ int chunk_best() const { return cb; }
};

// int16 form: rows (row0 + k, row0 + NP + k) per register, low half first.
template <int NP, bool TRACK>
struct Sw16 {
  using Word = unsigned;
  static constexpr int kWords = NP;
  static constexpr int kRows = 2 * NP;
  unsigned H[NP], E[NP];  // E holds E' = E + go
  unsigned mgo2 = 0, mge2 = 0;  // -go, -ge in both halves
  int ge = 0;
  int flo = 0;  // F' entering row0 + NP from the low half's own rows
  // score only: the running max, s16x2; tracking: the best column max so
  // far in both halves, and the pairs of the column that set it
  unsigned best2 = 0;
  unsigned snap[TRACK ? NP : 1];
  int cc = -1, cr = 0, row0 = 0;  // tracking: this chunk's end
  __device__ void setup(int go, int ge_) {
    mgo2 = (static_cast<unsigned>(-go) & 0xffffu) * 0x10001u;
    mge2 = (static_cast<unsigned>(-ge_) & 0xffffu) * 0x10001u;
    ge = ge_;
  }
  __device__ void reset(int lq, int r0) {
#pragma unroll
    for (int k = 0; k < NP; ++k) H[k] = E[k] = 0;
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
  __device__ int pass1(const unsigned (&s)[NP], unsigned top) {
    // pair 0's diagonal: (H[row0 - 1], H[row0 + NP - 1]) of column j - 1
    const unsigned d0 = __byte_perm(top, H[NP - 1], 0x5432);
#pragma unroll
    for (int k = NP - 1; k >= 0; --k) {
      const unsigned diag = k > 0 ? H[k - 1] : d0;
      E[k] = __viaddmax_s16x2(E[k], mge2, H[k]);
      H[k] = __viaddmax_s16x2_relu(diag, s[k], __vadd2(E[k], mgo2));
    }
    unsigned f = 0;
#pragma unroll
    for (int k = 0; k < NP; ++k) f = __viaddmax_s16x2(f, mge2, H[k]);
    flo = static_cast<int>(f & 0xffffu);
    return max(static_cast<int>(f >> 16), flo - NP * ge);
  }
  __device__ void pass2(int fin, int j) {
    const int fhi = max(fin - NP * ge, flo);
    unsigned f = (static_cast<unsigned>(fin) & 0xffffu) |
                 (static_cast<unsigned>(fhi) << 16);
#pragma unroll
    for (int k = 0; k < NP; ++k) {
      const unsigned h = __viaddmax_s16x2(f, mgo2, H[k]);
      f = __viaddmax_s16x2(f, mge2, H[k]);
      H[k] = h;
    }
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
// itself; the int16 form shuffles the last pair, whose high half is the row
// above the next thread's strip, and thread 0 puts the chunk above's row in
// the high half.
template <typename S, bool TRACK, bool PAIRS>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    sw_single_kernel(const uint32_t* __restrict__ prof, int nwords, int lq,
                     int nchunks, const int8_t* __restrict__ targets, int lt,
                     int nlanes, const int32_t* __restrict__ tlens, int go,
                     int ge, int32_t* __restrict__ out_score,
                     int32_t* __restrict__ out_qend,
                     int32_t* __restrict__ out_tend, int32_t* __restrict__ hb,
                     int32_t* __restrict__ gb) {
  constexpr int N = S::kWords;
  constexpr int G = group_of(N);
  const int tid = threadIdx.x & 31;
  const int b = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (b >= nlanes) return;  // uniform across the warp
  const int tl = tlens == nullptr ? lt : min(max(tlens[b], 0), lt);
  int32_t* hbl = hb + static_cast<size_t>(b) * lt;  // used iff nchunks > 1
  int32_t* gbl = gb + static_cast<size_t>(b) * lt;
  // the prefix-max ramp of this strip and of one strip, from the chunk's
  // first strip
  const int step = S::kRows * ge;
  const int ramp = tid * step;

  int best = 0, best_c = -1, best_r = lq - 1;
  S st;
  st.setup(go, ge);

  for (int ck = 0; ck < nchunks; ++ck) {
    const int row0 = (ck * 32 + tid) * S::kRows;
    const uint32_t* pbase =
        prof + static_cast<size_t>(ck) * 32 * N + tid * G;
    const bool has_prev = ck > 0;
    const bool has_next = ck + 1 < nchunks;
    st.reset(lq, row0);
    int hdiag = 0;  // thread 0: H[row0 - 1][j - 1] from the chunk above
    __syncwarp();   // the chunk above's hb/gb writes are visible

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
        typename S::Word s[N];
        load_strip<N>(pbase + static_cast<size_t>(c) * nwords, s);
        int hb_j = 0, gb_j = 0;  // gb: F' entering the chunk's first row
        if (has_prev && tid == 0) {
          hb_j = hbl[j];
          gb_j = gbl[j];
        }
        unsigned top = __shfl_up_sync(kFull, st.last(), 1);
        if (tid == 0) {
          top = PAIRS ? static_cast<unsigned>(hdiag) << 16
                      : static_cast<unsigned>(hdiag);
          hdiag = hb_j;
        }
        // warp inclusive max-scan of (strip summary + ramp); thread 0 folds
        // in the F' entering the chunk
        int v = st.pass1(s, top) + ramp;
        if (tid == 0) v = max(v, gb_j - step);
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const int o = __shfl_up_sync(kFull, v, d);
          if (tid >= d) v = max(v, o);
        }
        const int above = __shfl_up_sync(kFull, v, 1);
        st.pass2(tid == 0 ? gb_j : max(above - ramp + step, 0), j);
        if (has_next && tid == 31) {
          hbl[j] = st.last_row();
          gbl[j] = max(v - ramp, 0);
        }
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
    out_score[b] = best;
    if constexpr (TRACK) {
      const bool pos = best > 0;
      out_qend[b] = pos ? best_r : lq - 1;
      out_tend[b] = pos ? best_c : -1;
    }
  }
}

template <typename S, bool TRACK, bool PAIRS>
void launch_single(dim3 grid, dim3 block, cudaStream_t st,
                   const uint32_t* packed, int nwords, int lq, int nchunks,
                   const int8_t* targets, int lt, int nlanes,
                   const int32_t* tlens, int go, int ge, int32_t* score,
                   int32_t* qend, int32_t* tend, int32_t* hb, int32_t* gb) {
  sw_single_kernel<S, TRACK, PAIRS><<<grid, block, 0, st>>>(
      packed, nwords, lq, nchunks, targets, lt, nlanes, tlens, go, ge, score,
      qend, tend, hb, gb);
}

}  // namespace

// Plain C entry point of sw_multi_kernel (bound with ctypes). qsel null
// means profile 0 for every lane, qoff null offset 0. rstrip is the strip
// height R (1, 2, 4, 8, 16 or 32); hb/gb must hold nlanes * lt int32 each
// when lq > 32 * rstrip and may be null otherwise. Returns
// cudaGetLastError().
extern "C" int sw_multi_launch(const int32_t* prof, int nq, int lq,
                               const int8_t* targets, int lt, int nlanes,
                               const int32_t* qsel, const int32_t* qoff,
                               int go, int ge, int vec, int rstrip,
                               int32_t* score, int32_t* qend, int32_t* tend,
                               int32_t* hb, int32_t* gb, void* stream) {
  const dim3 block(kWarpsPerBlock * 32);
  const dim3 grid((nlanes + kWarpsPerBlock - 1) / kWarpsPerBlock);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SW_CASE(R)                                                        \
  case R:                                                                 \
    sw_multi_kernel<R><<<grid, block, 0, st>>>(prof, nq, lq, targets, lt, \
                                               nlanes, qsel, qoff, go, ge, \
                                               vec != 0, score, qend,     \
                                               tend, hb, gb);             \
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

// Plain C entry point of sw_single_kernel (bound with ctypes). int16 != 0
// selects the int16 form, 0 the int32 form; track != 0 writes score, qend
// and tend, 0 the score alone (qend and tend may be null). rows is the strip
// height, a thread's rows per chunk (int32: 1, 2, 4, 8, 12, ..., 32; int16:
// 2, 4, 8, 12, ..., 64), and 32 * rows * nchunks covers the query's real
// rows. packed must hold 32 * nwords uint32, nwords = 32 * rows * nchunks
// (int32) or half of that (int16): the profile is packed there first. tlens
// may be null (every lane lt long). hb and gb must hold nlanes * lt int32
// each when nchunks > 1 and may be null otherwise. Returns the first
// non-zero cudaGetLastError() of the two launches.
extern "C" int sw_single_launch(const int32_t* prof, int lq,
                                const int8_t* targets, int lt, int nlanes,
                                const int32_t* tlens, int go, int ge,
                                int track, int int16, int rows, int nchunks,
                                uint32_t* packed, int32_t* score,
                                int32_t* qend, int32_t* tend, int32_t* hb,
                                int32_t* gb, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n = int16 ? rows / 2 : rows;  // words per thread and column
  const int nwords = 32 * n * nchunks;
  const int err =
      packed_profile::pack(prof, lq, n, int16 != 0, nchunks, packed, st);
  if (err != 0) return err;
  const dim3 block(kWarpsPerBlock * 32);
  const dim3 grid((nlanes + kWarpsPerBlock - 1) / kWarpsPerBlock);
#define SW_ARGS                                                             \
  grid, block, st, packed, nwords, lq, nchunks, targets, lt, nlanes, tlens, \
      go, ge, score, qend, tend, hb, gb
#define SW32(R)                                                    \
  case R:                                                          \
    if (track)                                                     \
      launch_single<Sw32<R, true>, true, false>(SW_ARGS);          \
    else                                                           \
      launch_single<Sw32<R, false>, false, false>(SW_ARGS);        \
    break;
#define SW16(R)                                                    \
  case R:                                                          \
    if (track)                                                     \
      launch_single<Sw16<R / 2, true>, true, true>(SW_ARGS);       \
    else                                                           \
      launch_single<Sw16<R / 2, false>, false, true>(SW_ARGS);     \
    break;
  if (int16) {
    switch (rows) {
      SW16(2)
      SW16(4)
      SW16(8)
      SW16(12)
      SW16(16)
      SW16(20)
      SW16(24)
      SW16(28)
      SW16(32)
      SW16(36)
      SW16(40)
      SW16(44)
      SW16(48)
      SW16(52)
      SW16(56)
      SW16(60)
      SW16(64)
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  } else {
    switch (rows) {
      SW32(1)
      SW32(2)
      SW32(4)
      SW32(8)
      SW32(12)
      SW32(16)
      SW32(20)
      SW32(24)
      SW32(28)
      SW32(32)
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  }
#undef SW16
#undef SW32
#undef SW_ARGS
  return static_cast<int>(cudaGetLastError());
}
