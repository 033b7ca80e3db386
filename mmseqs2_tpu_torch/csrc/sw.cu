// Affine-gap Smith-Waterman scores and end positions for many (query,
// target) pairs in one launch, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel` of mmseqs2_tpu/ops/pallas_sw.py in its
// gapped forms. The TPU layout (query rows on sublanes, targets on lanes, a
// one-hot bf16 MXU lookup, f32 state and packed (score, column) tracking) is
// not carried over: each of those works around the TPU's vector unit. The
// kernel follows the GPU design of the reference's own GPU path (libmarv /
// CUDASW++ 4.0): one warp per lane.
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
// One kernel template, sw_kernel, serves every entry point of ops/sw.py:
//   sw_multi   (`sw_pallas_multi`): nq profiles, qsel and qoff per lane;
//   sw_offset  (`sw_pallas_offset`): one profile, qoff per lane;
//   sw_single  (`sw_pallas`, gapped): one profile, no offset;
//   sw_score   (`sw_pallas_score`): sw_single's score alone (TRACK false).
// Its design:
//   - The row window. Lane b runs profile q = qsel[b] (0 when qsel is
//     null) over the rows [qoff[b], end_q), end_q = qlens[q] (qlen when
//     qlens is null): rows below qoff[b] score as pad, as the plain
//     version's offset mask has them, and every entry of profile q's rows
//     at or past end_q is at most -(1 << 20) (the caller's contract). The
//     reverse pass of the aligner reads the reversed profile, whose pad rows
//     come first, so its window is [qoff, lq); the forward pass's is
//     [0, query length). The warp's strips start at the strip holding
//     qoff[b] (row qoff[b] rounded down to the strip height R), and it runs
//     the ceil((end_q - that row) / (32 * R)) chunks its window needs, a
//     count uniform across the warp. The m < R rows of the first strip below
//     qoff[b] belong to thread 0 of the first chunk: there its scores are
//     saturated (int16 -32768, int32 -(1 << 30)) behind a warp-uniform test,
//     so those rows hold H = 0, as the rows above the first strip do, and
//     can never be the best (best > 0 is required). A lane whose window is
//     empty runs no chunk.
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
//     pick_form), never on failure; the template runs over `Sw32` or
//     `Sw16`, which hold a thread's state:
//       int16: two rows per 32-bit register as s16x2, the pairs (row0 + k,
//         row0 + NP + k) of a strip of R = 2 * NP rows, so that pair k's
//         diagonal is the old pair k - 1 as it stands and pair 0's one
//         __byte_perm. Every step of the recurrence is one DPX instruction
//         for two cells (__viaddmax_s16x2 for E', F' and H,
//         __viaddmax_s16x2_relu for Hng). The F' chain of the high half
//         starts inside the strip, so its entering F' is closed in two steps:
//         max(F' entering the strip - NP * ge, the low half's own F' out).
//         Exact when score = (the launch's longest window) * max(profile
//         max, 0) < 32768 and go < 32768: then no sum leaves the 16-bit
//         range.
//       int32: any other input; one row per register, the same recurrence
//         in __viaddmax_s32 / __viaddmax_s32_relu.
//   - Real lengths. Besides the window's end, each warp stops at tlens[b]
//     (columns past it hold letter 31, whose profile row is at most
//     -(1 << 20) on the real rows). Unlike a gapless cell, a cell past a
//     length need not be 0: a gap can run into it. But every such cell is
//     strictly below the H of a real cell, or equal to one in an earlier
//     column or a smaller row (go = 0, reached by a gap), and it feeds only
//     cells past the lengths. So skipping them keeps the score and the
//     (first column, smallest row) end, bit for bit. tlens == null means
//     every lane is lt long.
//   - The profiles are packed once per call, all nq in one launch ahead of
//     the scan (packed_profile.cuh), so that the 32 threads' vectors of one
//     load are adjacent for any first strip. Strips past the last packed
//     one (cdiv(lq, R), all pad) load that one.
//   - End tracking: the int16 form folds a column's pairs into one max
//     (__vimax3_s16x2) and compares it with its best in one __vmaxs2; on a
//     rise it keeps the column's pairs and searches them for the smallest
//     row once, at the end of the chunk. The int32 form tracks per cell with
//     a strict >. The warp reduces by (max score, min column, min row); qend
//     is in full-profile coordinates.
//   - Long windows: a warp covers 32 * R rows at a time (R <= 64 in the
//     int16 form, 32 in the int32 form). Longer ones are strip-mined: each
//     chunk walks its lane's columns and leaves, per column, the H and the
//     F' of its last row in global scratch (hb, gb: nlanes x lt int32),
//     read and written only for the columns a lane computes.
//
// What bounds it: integer operations. A cell needs at least 6 int32
// instructions in Hopper's DPX forms: H - go (shared by E and F), E and F
// each one __viaddmax_s32, max(diag + s, E) one __viaddmax_s32,
// max(., F, 0) one __vimax_s32_relu, and the running best one max; the
// int16 form does the five steps for two cells per instruction and the
// running best for four (one __vimax3_s16x2): 2.75 a cell. chip_smoke.py's
// bound takes that count of the form that runs, at the card's int32 rate,
// over the cells a launch needs (each lane's window rows times its real
// target columns).

#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

#include "packed_profile.cuh"

namespace {

using packed_profile::better;
using packed_profile::group_of;
using packed_profile::kAlpha;
using packed_profile::kPastEnd;
using packed_profile::load_strip;

constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;

// -- the strip types -----------------------------------------------------------

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
  // the strip's first m rows score as pad
  __device__ static void mask(int (&s)[R], int m) {
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (r < m) s[r] = kPastEnd;
  }
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
  // the strip's first m rows score as pad: a half of row < m saturates to
  // -32768, its neighbour keeps its score
  __device__ static void mask(unsigned (&s)[NP], int m) {
#pragma unroll
    for (int k = 0; k < NP; ++k)
      s[k] = __vmins2(s[k], (k < m ? 0x8000u : 0x7fffu) |
                                (NP + k < m ? 0x80000000u : 0x7fff0000u));
  }
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
    sw_kernel(const uint32_t* __restrict__ prof, int nq, int nstrips, int lq,
              int qlen, const int32_t* __restrict__ qlens,
              const int32_t* __restrict__ qsel,
              const int32_t* __restrict__ qoff,
              const int8_t* __restrict__ targets, int lt, int nlanes,
              const int32_t* __restrict__ tlens, int go, int ge,
              int32_t* __restrict__ out_score, int32_t* __restrict__ out_qend,
              int32_t* __restrict__ out_tend, int32_t* __restrict__ hb,
              int32_t* __restrict__ gb) {
  constexpr int N = S::kWords;
  constexpr int R = S::kRows;
  constexpr int G = group_of(N);
  const int tid = threadIdx.x & 31;
  const int b = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (b >= nlanes) return;  // uniform across the warp
  const int q = qsel == nullptr ? 0 : qsel[b];
  if (q < 0 || q >= nq) __trap();
  // the window [off, end): its first strip s0, the m rows of s0 below off,
  // and the chunks that cover it
  const int end = qlens == nullptr ? qlen : min(max(qlens[q], 0), lq);
  const int off = qoff == nullptr ? 0 : max(qoff[b], 0);
  const int s0 = off / R;
  const int m = off - s0 * R;
  const int nchunks =
      end > off ? (end - s0 * R + 32 * R - 1) / (32 * R) : 0;
  const int tl = tlens == nullptr ? lt : min(max(tlens[b], 0), lt);
  const int nwords = N * nstrips;  // words of one profile row (letter)
  const uint32_t* pq = prof + static_cast<size_t>(q) * kAlpha * nwords;
  int32_t* hbl = hb + static_cast<size_t>(b) * lt;  // used iff nchunks > 1
  int32_t* gbl = gb + static_cast<size_t>(b) * lt;
  // the prefix-max ramp of this strip and of one strip, from the chunk's
  // first strip
  const int step = R * ge;
  const int ramp = tid * step;

  int best = 0, best_c = -1, best_r = lq - 1;
  S st;
  st.setup(go, ge);

  for (int ck = 0; ck < nchunks; ++ck) {
    const int strip = s0 + ck * 32 + tid;
    const uint32_t* pbase =
        pq + static_cast<size_t>(min(strip, nstrips - 1)) * G;
    const bool has_prev = ck > 0;
    const bool has_next = ck + 1 < nchunks;
    st.reset(lq, strip * R);
    int hdiag = 0;  // thread 0: H[row0 - 1][j - 1] from the chunk above
    __syncwarp();   // the chunk above's hb/gb writes are visible

    // the lane's columns; `masked` (warp-uniform) saturates thread 0's rows
    // below off, which only the first chunk holds
    auto walk = [&](auto masked) {
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
          load_strip<N>(pbase + static_cast<size_t>(c) * nwords, nstrips * G,
                        s);
          if constexpr (decltype(masked)::value) {
            if (tid == 0) S::mask(s, m);
          }
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
          // warp inclusive max-scan of (strip summary + ramp); thread 0
          // folds in the F' entering the chunk
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
    };
    if (ck == 0 && m > 0)
      walk(std::true_type());
    else
      walk(std::false_type());

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
void launch(dim3 grid, dim3 block, cudaStream_t st, const uint32_t* packed,
            int nq, int nstrips, int lq, int qlen, const int32_t* qlens,
            const int32_t* qsel, const int32_t* qoff, const int8_t* targets,
            int lt, int nlanes, const int32_t* tlens, int go, int ge,
            int32_t* score, int32_t* qend, int32_t* tend, int32_t* hb,
            int32_t* gb) {
  sw_kernel<S, TRACK, PAIRS><<<grid, block, 0, st>>>(
      packed, nq, nstrips, lq, qlen, qlens, qsel, qoff, targets, lt, nlanes,
      tlens, go, ge, score, qend, tend, hb, gb);
}

}  // namespace

// Plain C entry point of sw_kernel (bound with ctypes). prof: nq profiles,
// (nq * 32, lq) int32. qlens (nq) null means every profile's window ends at
// qlen; qsel null means profile 0 for every lane, qoff null offset 0; tlens
// null means every lane is lt long. int16 != 0 selects the int16 form, 0
// the int32 form; track != 0 writes score, qend and tend, 0 the score alone
// (qend and tend may be null). rows is the strip height R, a thread's rows
// per chunk (int32: 1, 2, 4, 8, 12, ..., 32; int16: 2, 4, 8, 12, ..., 64);
// nstrips must be at least cdiv(lq, rows) + 1, and packed must hold nq * 32
// * nstrips * rows uint32 (int32) or half of that (int16): the profiles are
// packed there first. hb and gb must hold nlanes * lt int32 each when some
// lane's window (from its first strip) is longer than 32 * rows, and may be
// null otherwise. Returns the first non-zero cudaGetLastError() of the two
// launches.
extern "C" int sw_launch(const int32_t* prof, int nq, int lq, int qlen,
                         const int32_t* qlens, const int32_t* qsel,
                         const int32_t* qoff, const int8_t* targets, int lt,
                         int nlanes, const int32_t* tlens, int go, int ge,
                         int track, int int16, int rows, int nstrips,
                         uint32_t* packed, int32_t* score, int32_t* qend,
                         int32_t* tend, int32_t* hb, int32_t* gb,
                         void* stream) {
  if (rows < 1 || nstrips < (lq + rows - 1) / rows + 1 || qlen < 0 ||
      qlen > lq)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n = int16 ? rows / 2 : rows;  // words per thread and column
  const int err =
      packed_profile::pack(prof, nq, lq, n, int16 != 0, nstrips, nstrips,
                           packed, st);
  if (err != 0) return err;
  const dim3 block(kWarpsPerBlock * 32);
  const dim3 grid((nlanes + kWarpsPerBlock - 1) / kWarpsPerBlock);
#define SW_ARGS                                                              \
  grid, block, st, packed, nq, nstrips, lq, qlen, qlens, qsel, qoff,        \
      targets, lt, nlanes, tlens, go, ge, score, qend, tend, hb, gb
#define SW32(R)                                             \
  case R:                                                   \
    if (track)                                              \
      launch<Sw32<R, true>, true, false>(SW_ARGS);          \
    else                                                    \
      launch<Sw32<R, false>, false, false>(SW_ARGS);        \
    break;
#define SW16(R)                                             \
  case R:                                                   \
    if (track)                                              \
      launch<Sw16<R / 2, true>, true, true>(SW_ARGS);       \
    else                                                    \
      launch<Sw16<R / 2, false>, false, true>(SW_ARGS);     \
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
