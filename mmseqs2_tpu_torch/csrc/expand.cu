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
// 32 bits: a flush's total stays below 2^31). This interface carries counts
// and an int64 running sum, 12 B a triple more than that least; the kernel
// reads the running sum and not the counts (24 B a triple). The integer
// work is a few operations an expansion. At 3.35 TB/s a flush of 2^21
// expansions needs about 15 us. The posting lists are runs of consecutive
// entries, so neighbouring expansions read neighbouring entries; but a
// list holds two entries on average, so most gathers of entries touch a
// 32-byte sector of their own for 4 or 2 bytes.
//
// What held the first design back. A block took tiles of 2,048
// expansions: warp 0 found the tile's first and last triple by two 32-ary
// searches over cum while the other seven warps waited at a barrier, and
// then each expansion found its triple by a binary search over the tile's
// triples (about ten dependent int64 loads) followed by five dependent
// gathers of its triple's fields and the two of its entry; a thread's eight
// expansions went one after another, and each stored 8 B and 2 B.
//
// The design: a load-balanced expansion of tiles of TILE = THREADS
// x ITEMS consecutive expansions, with no search an expansion.
// - A block takes its tiles by a grid-stride loop. Every AHEAD tiles its
//   warps find the ranges of the next AHEAD tiles together, two warps a
//   tile (the first and the last triple, each by a 32-ary search), so one
//   search's latency serves several tiles.
// - A tile's triples come into shared memory with coalesced loads (their
//   running sum, starts, qid and qpos; TILE_T at a time, so a run of
//   zero-count triples longer than that takes more than one batch).
// - Each triple with a count marks its first expansion in the tile with its
//   index (a list that began before the tile marks the tile's first), and
//   one block-wide max-scan over the tile gives every expansion its
//   triple, in the registers of the thread that expands it.
// - Each position's triple goes back into the tile's table, and thread tid
//   expands positions i THREADS + tid (i < ITEMS = 4): its entry is its
//   triple's starts + e - (the running sum before the triple), two gathers
//   from the index. One warp load covers 32 consecutive expansions, so a
//   list's entries come in by one request, and a warp's stores fill whole
//   lines (8-byte keys, 2-byte diagonals); so do the pad slots'.
// - The total is read on the card (a pointer, as the rescore's valid
//   count), so a flush is enqueued with no read-back; every output position
//   is its expansion's own index (no atomics).
// - starts and the entry index are int64: one split's index on an 80 GB
//   card can pass 2^31 entries (14 B a residue against three quarters of
//   the card is about 4.3 10^9 residues).
// - What bounds it now, at real size: the gathers of index entries. A
//   list of one or two entries pulls a sector of entries_seq and one of
//   entries_pos from device memory (the index, 102 MB at phase 3's size,
//   passes the L2), about six times the 12 B its expansions need. The
//   same 2^21 expansions into an index that fits the L2 run twice as fast
//   (phase 3).
// Variants timed (PERF.md, by ab.py, each in one call with the first
// design): four consecutive expansions a thread, written as 16-byte key
// and 8-byte diagonal stores (slower: a thread asked for one list's
// entries in separate loads, each sector up to twice; 0.0444 against
// 0.0347 ms with the L2-resident index); TILE = 2,048 (eight expansions a
// thread; slower); 48, 40 and 32 registers a thread for five, six and
// eight blocks an SM (no faster; 40 and 32 spill, and 32 ran slower); the
// next tile's triples asked into L2 while a tile is expanded (slower).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int ITEMS = 4;                      // expansions a thread, THREADS apart
constexpr int TILE = THREADS * ITEMS;         // expansions a tile
constexpr int TILE_T = 1024;                  // triples a batch of a tile
constexpr int AHEAD = NWARPS / 2;             // tiles whose ranges are found together
constexpr int MAX_DEVICES = 64;
constexpr long long KEY_PAD = 0x7fffffffffffffffLL;

struct Args {
    const long long* starts;
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

struct Shared {
    long long cum[TILE_T];      // the batch's triples' running sums
    long long starts[TILE_T];
    int qid[TILE_T];
    int qpos[TILE_T];
    short owner[TILE];          // a tile position's triple in the batch
    int range[AHEAD][2];        // first and last triple of the next tiles
    int warp_max[NWARPS];
    long long cum_before;       // the running sum before the batch
};

__global__ void __launch_bounds__(THREADS) posting_expand_kernel(Args a) {
    __shared__ Shared s;
    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    long long total = a.total != nullptr ? *a.total : 0;
    if (total > a.cap) total = a.cap;       // expansions past cap are dropped
    const long long stride = (long long)gridDim.x * TILE;
    int i_tile = 0;
    for (long long tile = (long long)blockIdx.x * TILE; tile < a.cap;
         tile += stride, ++i_tile) {
        // the ranges of this tile and the next AHEAD - 1 of the block: warp
        // 2 i + 1 finds tile i's last triple while warp 2 i finds its first
        if (i_tile % AHEAD == 0) {
            __syncthreads();                // the last ranges are read
            const long long lo = tile + (warp >> 1) * stride;
            const long long hi = min(min(lo + TILE, a.cap), total);
            if (lo < hi) {
                const int t = warp_upper_bound(a.cum, 0, a.k,
                                               (warp & 1) ? hi - 1 : lo);
                if (lane == 0) s.range[warp >> 1][warp & 1] = t;
            }
            __syncthreads();
        }
        const long long end = min(tile + TILE, a.cap);
        const long long real = min(end, total);   // expansions: [tile, real)
        // the pad slots [max(real, tile), end), as the expansions are
#pragma unroll
        for (int i = 0; i < ITEMS; ++i) {
            const long long e = tile + (long long)i * THREADS + tid;
            if (e >= real && e < end) {
                a.key[e] = KEY_PAD;
                a.diag[e] = 0;
            }
        }
        if (real <= tile) continue;
        int tb = s.range[i_tile % AHEAD][0];
        const int t_last = s.range[i_tile % AHEAD][1];
        long long eb = tile;
        while (eb < real) {                 // batches of at most TILE_T triples
            const int nt = min(t_last + 1 - tb, TILE_T);
            for (int i = tid; i < nt; i += THREADS) {
                s.cum[i] = a.cum[tb + i];
                s.starts[i] = a.starts[tb + i];
                s.qid[i] = a.qid[tb + i];
                s.qpos[i] = a.qpos[tb + i];
            }
            if (tid == 0) s.cum_before = tb > 0 ? a.cum[tb - 1] : 0;
#pragma unroll
            for (int i = 0; i < ITEMS; ++i) s.owner[tid * ITEMS + i] = -1;
            __syncthreads();
            // the batch's expansions: [eb, be)
            const long long be = min(real, s.cum[nt - 1]);
            for (int i = tid; i < nt; i += THREADS) {
                const long long first = i > 0 ? s.cum[i - 1] : s.cum_before;
                if (s.cum[i] > first && first < be)
                    s.owner[max(first, eb) - tile] = (short)i;
            }
            __syncthreads();
            // max-scan over the tile: every position gets the last triple
            // marked at or before it
            int own[ITEMS];
            own[0] = s.owner[tid * ITEMS];
#pragma unroll
            for (int i = 1; i < ITEMS; ++i)
                own[i] = max(own[i - 1], (int)s.owner[tid * ITEMS + i]);
            int x = own[ITEMS - 1];
#pragma unroll
            for (int d = 1; d < 32; d <<= 1) {
                const int y = __shfl_up_sync(0xffffffffu, x, d);
                if (lane >= d) x = max(x, y);
            }
            if (lane == 31) s.warp_max[warp] = x;
            int before = __shfl_up_sync(0xffffffffu, x, 1);
            if (lane == 0) before = -1;
            __syncthreads();
            for (int w = 0; w < warp; ++w) before = max(before, s.warp_max[w]);
            // each position's triple back into the tile's table, so that
            // expansion i THREADS + tid is thread tid's: a warp's gathers
            // and stores of one step cover 32 consecutive expansions
#pragma unroll
            for (int i = 0; i < ITEMS; ++i)
                s.owner[tid * ITEMS + i] = (short)max(own[i], before);
            __syncthreads();
#pragma unroll
            for (int i = 0; i < ITEMS; ++i) {
                const long long e = tile + (long long)i * THREADS + tid;
                if (e >= eb && e < be) {
                    const int t = s.owner[i * THREADS + tid];
                    const long long first = t > 0 ? s.cum[t - 1]
                                                  : s.cum_before;
                    const long long ent = s.starts[t] + (e - first);
                    const unsigned id = (unsigned)__ldg(a.entries_seq + ent);
                    a.key[e] = ((long long)s.qid[t] << 32) | (long long)id;
                    a.diag[e] = (uint16_t)(s.qpos[t]
                                           - (int)__ldg(a.entries_pos + ent));
                }
            }
            __syncthreads();                // the batch's shared data is read
            eb = be;
            tb += nt;
        }
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
// qid: (k,) int32 (counts is not read: cum carries the lengths);
// entries_seq (int32) and entries_pos (u16) the resident index entries;
// total: one int64 (null: no expansion); key (cap,) int64 and diag (cap,)
// u16 are written whole.
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
    (void)counts;
    Args a;
    a.starts = (const long long*)starts;
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
