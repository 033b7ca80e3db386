// The packed query profile shared by the single-profile scans (gapless.cu,
// sw.cu): a (32, lq) int32 profile laid out once per call, by a small kernel
// launched ahead of the scan on the same stream, so that the 32 threads'
// vectors of one load are adjacent. A thread holds a strip of consecutive
// query rows; reading the strip's rows side by side would make a warp's
// 16-byte loads stride 32-64 bytes apart and cost two to four times the L1
// wavefronts.
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

// Per letter, nwords = nchunks * 32 * n words; the words of chunk ck lie at
// ck * 32 * n, grouped so that one vector load of the warp reads 32 adjacent
// vectors: element k of thread tid is word (k / G) * 32 * G + tid * G + k %
// G, G = group_of(n). int32 form (pairs == 0): element k of strip `strip` is
// row strip * n + k (kPastEnd past lq). int16 form: it is the pair (row
// strip * 2n + k, row strip * 2n + n + k), saturated to int16 (-32768 past
// lq), low half first.
__global__ void pack_kernel(const int32_t* __restrict__ prof, int lq, int n,
                            int pairs, int nwords,
                            uint32_t* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= kAlpha * nwords) return;
  const int c = i / nwords;
  int w = i - c * nwords;
  const int ck = w / (32 * n);
  w -= ck * 32 * n;
  const int G = group_of(n);
  const int g = w / (32 * G);
  w -= g * 32 * G;
  const int tid = w / G;
  const int k = g * G + (w - tid * G);
  const int strip = ck * 32 + tid;
  const int32_t* row = prof + static_cast<size_t>(c) * lq;
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

// Packs the profile into `packed` (32 * nchunks * 32 * n words) on `st`.
inline int pack(const int32_t* prof, int lq, int n, bool pairs, int nchunks,
                uint32_t* packed, cudaStream_t st) {
  const int nwords = 32 * n * nchunks;
  const int npack = kAlpha * nwords;
  pack_kernel<<<(npack + 255) / 256, 256, 0, st>>>(prof, lq, n, pairs ? 1 : 0,
                                                   nwords, packed);
  return static_cast<int>(cudaGetLastError());
}

// A thread's N words of one column; p points at its first group.
template <int N, typename T>
__device__ __forceinline__ void load_strip(const uint32_t* __restrict__ p,
                                           T (&s)[N]) {
  constexpr int G = group_of(N);
#pragma unroll
  for (int g = 0; g < N / G; ++g) {
    const uint32_t* q = p + g * 32 * G;
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
