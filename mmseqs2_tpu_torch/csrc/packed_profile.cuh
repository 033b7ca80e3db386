// The packed query profile shared by the scans (gapless.cu, sw.cu): nq
// (32, lq) int32 profiles laid out once per call, by a small kernel launched
// ahead of the scan on the same stream, so that the 32 threads' vectors of
// one load are adjacent. A thread holds a strip of consecutive query rows
// (strip s: a thread's n words per column, rows s * R .. s * R + R - 1);
// reading the strip's rows side by side would make a warp's 16-byte loads
// stride 32-64 bytes apart and cost two to four times the L1 wavefronts.
//
// Layout, per profile q and letter c (n * nstrips words): blocks of `block`
// strips, each [group g][strip][G], G = group_of(n) words a vector, so
// element k of strip s is word (s / block) * block * n + (k / G) * block * G
// + (s % block) * G + k % G. The gapless scan packs blocks of 32 strips (a
// chunk of a warp, its group stride the constant 32 * G). The SW scan packs
// one block of all nstrips: a warp's load of group g for any 32 consecutive
// strips s0 .. s0 + 31 is then 32 adjacent vectors, whatever s0, since it
// starts each lane at the strip holding its query offset.
//
// ops/kernels.py hashes this header with each source that includes it.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace packed_profile {

constexpr int kAlpha = 32;            // profile rows (ALPHA_PAD)
constexpr int kPastEnd = -(1 << 30);  // int32 rows past lq

// Words a thread loads at once when it holds n words per column: 16-byte
// vectors where n allows, then 8-byte, then single words.
__host__ __device__ constexpr int group_of(int n) {
  return n % 4 == 0 ? 4 : (n % 2 == 0 ? 2 : 1);
}

// int32 form (pairs == 0): element k of strip s is row s * n + k (kPastEnd
// past lq). int16 form: it is the pair (row s * 2n + k, row s * 2n + n + k),
// saturated to int16 (-32768 past lq), low half first. prof holds the nq
// profiles' rows one after another, (nq * 32, lq); nstrips is a multiple of
// block.
__global__ void pack_kernel(const int32_t* __restrict__ prof, int nq, int lq,
                            int n, int pairs, int nstrips, int block,
                            uint32_t* __restrict__ out) {
  const int per = n * nstrips;  // words per profile row (letter)
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<size_t>(nq) * kAlpha * per) return;
  const int qc = static_cast<int>(i / per);  // q * 32 + letter
  int w = static_cast<int>(i - static_cast<size_t>(qc) * per);
  const int G = group_of(n);
  const int blk = w / (block * n);
  w -= blk * block * n;
  const int g = w / (block * G);
  w -= g * block * G;
  const int pos = w / G;
  const int strip = blk * block + pos;
  const int k = g * G + (w - pos * G);
  const int32_t* row = prof + static_cast<size_t>(qc) * lq;
  if (!pairs) {
    const int r = strip * n + k;
    out[i] = static_cast<uint32_t>(r < lq ? row[r] : kPastEnd);
    return;
  }
  const int r = strip * 2 * n + k;
  const int lo = r < lq ? min(max(row[r], -32768), 32767) : -32768;
  const int hi = r + n < lq ? min(max(row[r + n], -32768), 32767) : -32768;
  out[i] = (static_cast<uint32_t>(lo) & 0xffffu) |
           (static_cast<uint32_t>(hi) << 16);
}

// Packs the nq profiles into `packed` (nq * 32 * n * nstrips words) on `st`.
inline int pack(const int32_t* prof, int nq, int lq, int n, bool pairs,
                int nstrips, int block, uint32_t* packed, cudaStream_t st) {
  const size_t npack = static_cast<size_t>(nq) * kAlpha * n * nstrips;
  pack_kernel<<<static_cast<unsigned>((npack + 255) / 256), 256, 0, st>>>(
      prof, nq, lq, n, pairs ? 1 : 0, nstrips, block, packed);
  return static_cast<int>(cudaGetLastError());
}

// A thread's N words of one column; p points at its strip's first vector,
// and the groups lie gstride = block * G words apart.
template <int N, typename T>
__device__ __forceinline__ void load_strip(const uint32_t* __restrict__ p,
                                           int gstride, T (&s)[N]) {
  constexpr int G = group_of(N);
#pragma unroll
  for (int g = 0; g < N / G; ++g) {
    const uint32_t* q = p + g * gstride;
    if constexpr (G == 4) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(q));
      s[4 * g] = static_cast<T>(v.x);
      s[4 * g + 1] = static_cast<T>(v.y);
      s[4 * g + 2] = static_cast<T>(v.z);
      s[4 * g + 3] = static_cast<T>(v.w);
    } else if constexpr (G == 2) {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(q));
      s[2 * g] = static_cast<T>(v.x);
      s[2 * g + 1] = static_cast<T>(v.y);
    } else {
      s[g] = static_cast<T>(__ldg(q));
    }
  }
}

// The end rule of the reference: max score, then min column, then min row.
__device__ __forceinline__ bool better(int s1, int c1, int r1, int s2, int c2,
                                       int r2) {
  return s1 > s2 || (s1 == s2 && (c1 < c2 || (c1 == c2 && r1 < r2)));
}

}  // namespace packed_profile
