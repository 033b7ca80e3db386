// Posting expansion of the k-mer prefilter's CSR lookups (B6), for Hopper
// (sm_90a).
//
// Replaces the expansion of the TPU prefilter's candidate stage: seg_expand
// (mmseqs2_tpu/prefilter/device_stages.py:47, over fast_cumsum :30) and the
// gathers of stage_candidates (:248-255), the XLA program that
// _device_match and _device_candidates (mmseqs2_tpu/prefilter/device.py)
// run when the posting lists are expanded on the device: past the packed
// sort key (more than 2^22 targets) and in target-split mode. For K CSR
// triples t (a posting list's first entry starts[t], its length counts[t],
// the query position qpos[t] of the k-mer and the query qid[t] of the
// flush) and their inclusive running sum cum, expansion e < total (=
// cum[K - 1]) belongs to the triple t with cum[t - 1] <= e < cum[t] and is
// its entry ent = starts[t] + e - (cum[t] - counts[t]); it writes
//
//   key[e]  = qid[t] << 32 | entries_seq[ent]            (int64)
//   diag[e] = (qpos[t] - entries_pos[ent]) & 0xFFFF       (u16 bits)
//
// in expansion order (triple-major, then position in the list), and key
// INT64_MAX, diag 0 for the pad slots e in [total, cap). Zero-count triples
// own no expansion. Every output position is its expansion's own index:
// nothing is written by atomics, since the double-diagonal rule that
// follows depends on the order of one id's entries.
//
// What bounds it on this card: bytes. Per expansion 6 B come in from the
// resident index (a u32 id, a u16 position) and 10 B go out; per triple the
// function needs 20 B in (starts int64, qpos, qid, and the list's length in
// 32 bits: a flush's total stays below 2^31). This interface reads counts
// and an int64 running sum, 12 B a triple more than that least. The
// integer work is a few operations an expansion. At 3.35 TB/s a flush of
// 2^21 expansions needs about 10 us. The posting lists are runs of consecutive entries, so
// neighbouring expansions read neighbouring entries.
//
// Design (a simple first kernel).
// - A block takes tiles of TILE = THREADS x PER_THREAD consecutive
//   expansions by a grid-stride loop; thread j of the block writes
//   expansions tile + k THREADS + j, so a warp's loads of entries and its
//   stores of keys and diagonals are coalesced.
// - Warp 0 finds the triples of the tile's first and last expansion with
//   a 32-ary search over cum (32 probes a step, about four steps for a
//   million triples); each thread then finds its expansion's triple by a
//   binary search inside that range, which lies in L1, starting each
//   search at the triple of its previous expansion.
// - The total is read on the card (a pointer, as the rescore's valid
//   count), so a flush is enqueued with no read-back.
// - starts and the entry index are int64: one split's index on an 80 GB
//   card can pass 2^31 entries (14 B a residue against three quarters of
//   the card is about 4.3 10^9 residues).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int PER_THREAD = 8;
constexpr long long TILE = (long long)THREADS * PER_THREAD;
constexpr int MAX_DEVICES = 64;
constexpr long long KEY_PAD = 0x7fffffffffffffffLL;

struct Args {
    const long long* starts;
    const int* counts;
    const int* qpos;
    const int* qid;
    const long long* cum;
    int k;
    const int* entries_seq;
    const uint16_t* entries_pos;
    const long long* total;
    long long cap;
    long long* key;
    uint16_t* diag;
};

// The first t in [lo, hi) with cum[t] > e, or hi when there is none. Every
// lane of the warp calls it with the same arguments and gets the same t.
__device__ int warp_upper_bound(const long long* __restrict__ cum, int lo,
                                int hi, long long e) {
    const int lane = threadIdx.x & 31;
    while (hi - lo > 32) {
        const int step = (hi - lo + 31) / 32;
        const int p = lo + lane * step;
        const bool past = p >= hi || cum[p] > e;
        const unsigned b = __ballot_sync(0xffffffffu, past);
        if (b == 0) {
            // every probe is at or below e: t lies past the last one
            lo += 31 * step + 1;
            continue;
        }
        const int f = __ffs(b) - 1;
        if (f == 0) return lo;
        // cum[probe f - 1] <= e < cum[probe f] (or probe f is past hi)
        const int pf = lo + f * step;
        lo += (f - 1) * step + 1;
        hi = min(pf, hi);
    }
    const int p = lo + lane;
    const bool past = p >= hi || cum[p] > e;
    const unsigned b = __ballot_sync(0xffffffffu, past);
    return b ? lo + __ffs(b) - 1 : hi;
}

// The first t in [lo, hi) with cum[t] > e, or hi: one thread.
__device__ int upper_bound(const long long* __restrict__ cum, int lo, int hi,
                           long long e) {
    while (lo < hi) {
        const int mid = lo + (hi - lo) / 2;
        if (cum[mid] > e) {
            hi = mid;
        } else {
            lo = mid + 1;
        }
    }
    return lo;
}

__global__ void __launch_bounds__(THREADS) posting_expand_kernel(Args a) {
    __shared__ int range[2];
    long long total = a.total != nullptr ? *a.total : 0;
    if (total > a.cap) total = a.cap;
    const long long stride = (long long)gridDim.x * TILE;
    for (long long tile = (long long)blockIdx.x * TILE; tile < a.cap;
         tile += stride) {
        const long long end = min(tile + TILE, a.cap);
        // the tile's last expansion (below tile when it holds none); the
        // same for every thread of the block
        const long long last = min(end, total) - 1;
        int lo = 0, hi = 0;
        if (last >= tile) {
            if (threadIdx.x < 32) {
                const int first_t = warp_upper_bound(a.cum, 0, a.k, tile);
                const int last_t = warp_upper_bound(a.cum, first_t, a.k, last);
                if (threadIdx.x == 0) {
                    range[0] = first_t;
                    range[1] = last_t;
                }
            }
            __syncthreads();
            lo = range[0];
            hi = range[1] + 1;
        }
        for (int j = 0; j < PER_THREAD; ++j) {
            const long long e = tile + (long long)j * THREADS + threadIdx.x;
            if (e >= end) break;
            if (e >= total) {
                a.key[e] = KEY_PAD;
                a.diag[e] = 0;
                continue;
            }
            const int t = upper_bound(a.cum, lo, hi, e);
            lo = t;
            const long long ent = a.starts[t] + (e - (a.cum[t] - a.counts[t]));
            const unsigned id = (unsigned)a.entries_seq[ent];
            a.key[e] = ((long long)a.qid[t] << 32) | (long long)id;
            a.diag[e] = (uint16_t)(a.qpos[t] - (int)a.entries_pos[ent]);
        }
        // range[] is written again for the next tile
        __syncthreads();
    }
}

// Blocks that fill the card: SMs x the blocks an SM holds at once, asked
// once per device.
int grid_blocks(int dev, int* out) {
    static int cache[MAX_DEVICES] = {};
    int cached = cache[dev];
    if (cached == 0) {
        int sms = 0, per_sm = 0;
        cudaError_t e =
            cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        if (e != cudaSuccess) return (int)e;
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, posting_expand_kernel, THREADS, 0);
        if (e != cudaSuccess) return (int)e;
        if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
        cached = cache[dev] = sms * per_sm;
    }
    *out = cached;
    return 0;
}

}  // namespace

// Launches the expansion on `stream`; returns the CUDA error code (0 = ok).
// Every pointer is a device pointer. starts, cum: (k,) int64; counts, qpos,
// qid: (k,) int32; entries_seq (int32) and entries_pos (u16) the resident
// index entries; total: one int64 (null: no expansion); key (cap,) int64
// and diag (cap,) u16 are written whole.
extern "C" int posting_expand_launch(
    const void* starts, const void* counts, const void* qpos,
    const void* qid, const void* cum, int k, const void* entries_seq,
    const void* entries_pos, const void* total, long long cap, void* key,
    void* diag, void* stream) {
    if (cap <= 0) return 0;
    if (k < 0) return (int)cudaErrorInvalidValue;
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
    int blocks = 0;
    const int err = grid_blocks(dev, &blocks);
    if (err != 0) return err;
    const long long tiles = (cap + TILE - 1) / TILE;
    if (tiles < blocks) blocks = (int)tiles;
    Args a;
    a.starts = (const long long*)starts;
    a.counts = (const int*)counts;
    a.qpos = (const int*)qpos;
    a.qid = (const int*)qid;
    a.cum = (const long long*)cum;
    a.k = k;
    a.entries_seq = (const int*)entries_seq;
    a.entries_pos = (const uint16_t*)entries_pos;
    a.total = (const long long*)total;
    a.cap = cap;
    a.key = (long long*)key;
    a.diag = (uint16_t*)diag;
    posting_expand_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}
