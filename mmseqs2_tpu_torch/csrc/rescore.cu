// Ungapped diagonal rescore of prefilter candidates, for Hopper (sm_90a).
//
// Replaces the TPU rescorer of mmseqs2_tpu/prefilter: the unfinished Pallas
// body pallas_rescore.py:_kernel and its live XLA form
// device_stages.make_rescore / make_rescore_from_letters, driven by
// _chunked_rescore. For each candidate (query qid, target id, diagonal d)
// it returns the exact score of the best ungapped segment on that diagonal
// (reference UngappedAlignment.cpp):
//
//   d  = the low 16 bits of diag read as signed; qs = max(d, 0), ts = max(-d, 0)
//   n  = max(min(t_len[id] - ts, q_len[qid] - qs), 0) cells
//   s_l = submat[q[qid, qs+l], t_cat[t_off[id] + ts + l]] + corr[qid, qs+l]
//   out = max(0, max_l (c_l - min(0, min_{k<l} c_k))),  c = running sum of s
//
// which is Kadane's recurrence. An invalid candidate, a slot at or past the
// valid count and n = 0 give 0. The caller caps at 255 where it needs the
// capped score; nothing is rescored twice.
//
// The profile form (B4', diag_rescore_profile_launch) is the same kernel,
// instantiated with PROFILE = true: only a cell's score changes,
//
//   s_l = prof[qid, qs + l, t_cat[t_off[id] + ts + l]]
//
// with prof (n_q, lq, 32) int8, one 32-byte row (one sector) a query
// position. It replaces the XLA program device_stages.make_rescore under
// _chunked_rescore, which _device_match (prefilter/device.py:96) runs for
// profile queries: pallas_rescore.py:_kernel never had a profile form. Its
// bound, by the same count: each window's target bytes and its profile
// rows read once, n x (1 + 32) bytes a window of n cells, at 3.35 TB/s.
// The windows, the valid count, stale slots and the zero-fill are the
// letters form's. Each cell reads its score byte from its window's row
// (rows + l x 32 + letter); a lane's 16 rows are 512 contiguous bytes. That
// is a simple first design: staging a window's rows in shared memory is
// later work.
//
// The valid count. The prefilter's candidate stage front-compacts its
// candidates into a buffer of the flush's own slot count (2^21 on the main
// path, of which about 1% hold candidates) and knows the count only on the
// device. `n_valid` points at that count (int32; null: every slot is a
// candidate that obeys `cvalid`), as the reference's n_valid; the kernel
// reads it on the card, so the host never waits for it. The grid is sized
// to the card (SMs x the blocks the occupancy query allows, asked once), not
// to the slots: no block exists for a slot past the count, and those slots
// are zero-filled with 16-byte stores after the candidates are scored.
//
// What bounds it on this card. chip_smoke.py's bound says bytes: per cell
// one target byte, one query letter and one correction byte come in and
// three int32 operations are counted (lookup plus correction, the running
// sum, the running best), and at the prefilter's shapes the bytes the
// windows touch (most of the target store) take longer at 3.35 TB/s than
// the cells' operations at the int32 rate. Hence no 16-bit (DPX) form: it
// would not lower a bound set by bytes, and the running sum of a window of
// up to 32,767 cells can pass the int16 range. Everything is int32, and
// exact. What the kernel really waits on is the memory system's latency:
// its windows are scattered over the target store, a pass's loads must
// arrive before it is scored: its drafts ran faster at 32 resident warps
// an SM than at 24, and no faster when their work a cell was cut (two
// cells' table offsets from one word, three-way maxima; PERF.md).
//
// Design.
// - Batches. A warp takes a batch of B consecutive slots by a grid-stride
//   loop, one a lane: B = 32 / G, doubled up to 32 while every warp still
//   gets a batch. Each lane reads its slot's fields (the next batch's are
//   asked for at the start of this one) and its window (cells, first
//   target byte, first query byte). With the count every slot before it is
//   a candidate's, so the fields are read together with cvalid; without
//   it only valid slots' fields are read. The batch's valid slots are then
//   scored 32 / G at a time, one group of G lanes each, each window handed
//   to its group by shuffles. The (A x A) matrix sits in shared memory, 32
//   wide, copied once per block.
// - Runs of cells per lane. A pass of a group covers G K cells of its
//   window; lane j scores the K consecutive cells [j K, j K + K) of the pass
//   serially into a summary: the run's sum S, its largest prefix sum maxc,
//   the local Kadane state h = max(h, 0) + s (one __viaddmax_s32) and its
//   best b_loc. Cells past the window score 0, which changes none of S,
//   maxc, max(h, 0) and b_loc.
// - The group combines the summaries with one exclusive sum-scan of S, which
//   gives the running sum P before the run, and one min-scan of
//   m = P + S - max(h, 0), the lowest running sum at or before the run's
//   end (S - max(h, 0) is min(0, the run's lowest prefix sum): h at the
//   run's end is its best suffix). With M = min(0, every running sum before
//   the run), the lane's best is max(b_loc, maxc + P - M): a segment either
//   starts inside the run or reaches back before it. A window longer than
//   G K takes more passes, carrying the sum and the minimum from the last
//   lane, each pass's loads asked for while the one before is scored; one
//   max-reduction over the group ends the candidate. The groups of a warp
//   run the same number of passes (the longest of their windows), so the
//   warp never diverges around its shuffles. That is one pair of scans per
//   G K cells, where the first design closed every 32 cells with a pair of
//   5-shuffle scans. G = 8, K = 16: a median window of the main path (200
//   cells) in two passes; the fastest of the seven (G, K) pairs that a
//   draft of this kernel timed at chip_smoke.py's rescore shapes (PERF.md).
// - Wide loads. A lane's K bytes of each stream (target letters, query
//   letters, corrections: each at its own alignment) come in as K / 4 + 1
//   aligned 32-bit words joined by __funnelshift_r; a run whose words reach
//   past either end of its tensor reads them byte by byte, so no load
//   leaves the tensors.
// None of the TPU design is carried over: no row DMAs into fixed (G, LN)
// buffers, no one-hot matmul, no length ladder, no chunking to a static
// width, no second pass for saturated hits.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#define THREADS 256
// four blocks an SM: at most 64 registers a thread (ptxas spills a few
// bytes for it; the kernel ran faster at 32 warps an SM than at 24)
#define MIN_BLOCKS 4
#define MAX_ALPHA 32
#define MAX_DEVICES 16

constexpr int G = 8;     // lanes a candidate
constexpr int K = 16;    // cells a lane scores serially
constexpr int NW = K / 4;

struct Args {
    const int* cqid;
    const int* cid;
    const int* cdiag;
    const uint8_t* cvalid;
    const int* n_valid;          // may be null
    int n_cand;
    const uint8_t* t_cat;
    long long t_bytes;
    const long long* t_off;
    const int* t_len;
    const uint8_t* q_let;        // letters form: the query letters
    const uint8_t* corr;         // letters form: int8 corrections
    const int8_t* prof;          // profile form: (n_q, lq, 32) int8
    long long q_bytes;           // bytes of q_let and of corr: n_q * lq
                                 // (letters form only)
    int lq;
    const int* q_len;
    const int* submat;
    int alpha;
    int* out;
};

// NW little-endian words holding the bytes p[0, 4 NW) of the tensor
// [lo, lo + len): aligned words joined by a funnel shift; where the words
// reach past the tensor they are assembled from its bytes inside it.
__device__ __forceinline__ void load_run(const uint8_t* p, const uint8_t* lo,
                                         long long len, uint32_t (&w)[NW]) {
    const uintptr_t a = (uintptr_t)p;
    const uint8_t* w0 = (const uint8_t*)(a & ~(uintptr_t)3);
    const unsigned sh = (unsigned)(a & 3) * 8;
    const uint8_t* hi = lo + len;
    uint32_t r[NW + 1];
    if (w0 >= lo && w0 + 4 * (NW + 1) <= hi) {
#pragma unroll
        for (int i = 0; i <= NW; ++i)
            r[i] = __ldg((const uint32_t*)(w0 + 4 * i));
    } else {                              // at an end of the tensor
#pragma unroll
        for (int i = 0; i <= NW; ++i) {
            const uint8_t* wa = w0 + 4 * i;
            uint32_t v = 0;
            for (int b = 0; b < 4; ++b)
                if (wa + b >= lo && wa + b < hi)
                    v |= (uint32_t)__ldg(wa + b) << (8 * b);
            r[i] = v;
        }
    }
#pragma unroll
    for (int i = 0; i < NW; ++i) w[i] = __funnelshift_r(r[i], r[i + 1], sh);
}

struct Summary {
    int S;        // the run's sum
    int maxc;     // max(0, its largest prefix sum)
    int h;        // Kadane state at its last cell: its best suffix
    int b;        // max(0, its best segment)
};

// One pass's words of a lane: target letters, query letters, corrections.
struct Words {
    uint32_t t[NW], q[NW], c[NW];
};

// The profile form loads only the target letters: its scores are read
// from the window's profile rows while the run is scored.
template <bool PROFILE>
__device__ __forceinline__ void load_pass(const Args& a, const uint8_t* tp,
                                          const uint8_t* qp,
                                          const uint8_t* cp, int o,
                                          Words& w) {
    load_run(tp + o, a.t_cat, a.t_bytes, w.t);
    if (!PROFILE) {
        load_run(qp + o, a.q_let, a.q_bytes, w.q);
        load_run(cp + o, a.corr, a.q_bytes, w.c);
    }
}

// The summary of the first `kk` of a lane's K cells; the rest score 0,
// which leaves S, maxc, max(h, 0) and b as they were (called with kk = K
// for a full run, which leaves no test in the loop). Two cells at a time:
// their letters unpacked into the 16-bit halves of one word, so that one
// shift and one add give both byte offsets into the 32-wide matrix table
// (q * 128 + t * 4 < 4,096); the prefix max and the best take both cells'
// values in one three-way max (DPX). The profile form reads cell k's score
// from rows[k * 32 + letter], rows being the run's first profile row, for
// the cells inside the window only.
template <bool PROFILE>
__device__ __forceinline__ Summary score_run(const Words& w, int kk,
                                             const int* lut,
                                             const int8_t* rows) {
    const char* base = reinterpret_cast<const char*>(lut);
    Summary r = {0, 0, 0, 0};
#pragma unroll
    for (int k = 0; k < K; k += 2) {
        int s1, s2;
        if (PROFILE) {
            const unsigned tw = w.t[k >> 2] >> (8 * (k & 3));
            s1 = k < kk ? (int)__ldg(rows + k * 32 + (tw & 31)) : 0;
            s2 = k + 1 < kk
                     ? (int)__ldg(rows + (k + 1) * 32 + ((tw >> 8) & 31))
                     : 0;
        } else {
            const unsigned sel = (k & 2) ? 0x4342u : 0x4140u;
            const unsigned t2 = __byte_perm(w.t[k >> 2], 0, sel);
            const unsigned q2 = __byte_perm(w.q[k >> 2], 0, sel);
            const unsigned off = (q2 << 7) + (t2 << 2);
            const int sh = 8 * (k & 3);
            s1 = *reinterpret_cast<const int*>(base + (off & 0xffff))
                 + (int)(int8_t)(w.c[k >> 2] >> sh);
            s2 = *reinterpret_cast<const int*>(base + (off >> 16))
                 + (int)(int8_t)(w.c[k >> 2] >> (sh + 8));
            if (k >= kk) s1 = 0;
            if (k + 1 >= kk) s2 = 0;
        }
        const int S1 = r.S + s1;
        r.S = S1 + s2;
        r.maxc = __vimax3_s32(r.maxc, S1, r.S);
        const int h1 = __viaddmax_s32(r.h, s1, s1);   // max(h, 0) + s
        r.h = __viaddmax_s32(h1, s2, s2);
        r.b = __vimax3_s32(r.b, h1, r.h);
    }
    return r;
}

// The best segment of a group's window of n cells (n = 0: no candidate),
// every lane of the warp calling together. Passes of G K cells, the next
// pass's words asked for before this one is scored. The profile form's qp is
// the window's first profile row (cp unused).
template <bool PROFILE>
__device__ __forceinline__ int score_window(const Args& a, const int* lut,
                                            int n, const uint8_t* tp,
                                            const uint8_t* qp,
                                            const uint8_t* cp, int lane) {
    const unsigned full = 0xffffffffu;
    const int gl = lane & (G - 1);        // lane in its group
    const int n_warp = __reduce_max_sync(full, n);
    int carry_sum = 0;    // the running sum before the pass
    int carry_min = 0;    // min(0, every running sum before the pass)
    int best = 0;
    int o = gl * K;
    int kk = min(max(n - o, 0), K);
    Words w = {};
    if (kk > 0) load_pass<PROFILE>(a, tp, qp, cp, o, w);
#pragma unroll 2
    for (int base = 0; base < n_warp; base += G * K) {
        const int o_next = o + G * K;
        const int kk_next = min(max(n - o_next, 0), K);
        Words w_next = {};
        if (kk_next > 0) load_pass<PROFILE>(a, tp, qp, cp, o_next, w_next);
        Summary r = {0, 0, 0, 0};
        const int8_t* rows = reinterpret_cast<const int8_t*>(qp) + o * 32;
        if (kk > 0)
            r = kk == K ? score_run<PROFILE>(w, K, lut, rows)
                        : score_run<PROFILE>(w, kk, lut, rows);
        // exclusive sum-scan of S: the running sum P before the run
        int x = r.S;
#pragma unroll
        for (int s = 1; s < G; s <<= 1) {
            const int y = __shfl_up_sync(full, x, s, G);
            if (gl >= s) x += y;
        }
        const int P = carry_sum + x - r.S;
        // min-scan of the lowest running sum at or before each run's end
        int m = P + r.S - max(r.h, 0);
#pragma unroll
        for (int s = 1; s < G; s <<= 1) {
            const int y = __shfl_up_sync(full, m, s, G);
            if (gl >= s) m = min(m, y);
        }
        int before = __shfl_up_sync(full, m, 1, G);
        if (gl == 0) before = INT_MAX;
        const int gmin = min(carry_min, before);
        if (kk > 0) best = max(best, max(r.b, r.maxc + P - gmin));
        carry_sum = __shfl_sync(full, carry_sum + x, G - 1, G);
        carry_min = min(carry_min, __shfl_sync(full, m, G - 1, G));
        w = w_next;
        o = o_next;
        kk = kk_next;
    }
#pragma unroll
    for (int s = G / 2; s > 0; s >>= 1)
        best = max(best, __shfl_xor_sync(full, best, s, G));
    return best;
}

// Zero-fills out[from, to) with every thread of the grid, 16 bytes a store
// between the aligned ends.
__device__ __forceinline__ void zero_fill(int* out, int from, int to) {
    const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const long long nt = (long long)gridDim.x * blockDim.x;
    const int a = min((from + 3) & ~3, to);
    for (long long i = from + t; i < a; i += nt) out[i] = 0;
    int4* o4 = reinterpret_cast<int4*>(out);
    for (long long i = a / 4 + t; i < to / 4; i += nt)
        o4[i] = make_int4(0, 0, 0, 0);
    for (long long i = max(a, to & ~3) + t; i < to; i += nt) out[i] = 0;
}

// A slot's fields, read by the lane that holds the slot.
struct Fields {
    int qid, id, diag;
    bool valid;
};

// With the count every slot before it is a candidate's (the path's
// front-compacted flush): the fields are read together with cvalid.
// Without it they are read for valid slots only (a flush's buffer is
// mostly empty past its count).
__device__ __forceinline__ Fields load_fields(const Args& a, long long c,
                                              bool in, bool counted) {
    Fields f = {0, 0, 0, false};
    if (in) {
        if (counted) {
            f.qid = a.cqid[c];
            f.id = a.cid[c];
            f.diag = a.cdiag[c];
        }
        f.valid = a.cvalid[c] != 0;
        if (!counted && f.valid) {
            f.qid = a.cqid[c];
            f.id = a.cid[c];
            f.diag = a.cdiag[c];
        }
    }
    return f;
}

// A valid slot's window: its cells, and the offsets of its first target
// byte and its first query byte.
struct Window {
    int n;
    long long t, q;
};

__device__ __forceinline__ Window window_of(const Args& a, const Fields& f) {
    Window w = {0, 0, 0};
    if (f.valid) {
        const int d = (int)(short)(f.diag & 0xFFFF);
        const int qs = d > 0 ? d : 0;
        const int ts = d < 0 ? -d : 0;
        w.n = max(min(a.t_len[f.id] - ts, a.q_len[f.qid] - qs), 0);
        w.t = a.t_off[f.id] + ts;
        w.q = (long long)f.qid * a.lq + qs;
    }
    return w;
}

template <bool PROFILE>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
rescore_kernel(const Args a) {
    // the matrix 32 wide, zero outside A x A: lut[q * 32 + t] (letters
    // form only)
    __shared__ int lut[MAX_ALPHA * MAX_ALPHA];
    if (!PROFILE) {
        for (int i = threadIdx.x; i < MAX_ALPHA * MAX_ALPHA; i += THREADS) {
            const int q = i / MAX_ALPHA, t = i % MAX_ALPHA;
            lut[i] =
                q < a.alpha && t < a.alpha ? a.submat[q * a.alpha + t] : 0;
        }
    }
    const bool counted = a.n_valid != nullptr;
    const int n_eff =
        counted ? min(max(*a.n_valid, 0), a.n_cand) : a.n_cand;
    __syncthreads();

    constexpr int NPW = 32 / G;           // candidates a warp scores at once
    const unsigned full = 0xffffffffu;
    const int lane = threadIdx.x & 31;
    const int grp = lane / G;
    const long long n_warps = (long long)gridDim.x * (THREADS / 32);
    const long long warp =
        ((long long)blockIdx.x * THREADS + threadIdx.x) >> 5;
    // Slots a warp takes at once (a batch, one a lane, by a grid-stride
    // loop): from NPW up to 32 while every warp still gets a batch. Each
    // lane reads its slot's fields (the next batch's asked for at the
    // start of this one) and window; the groups then score the batch's
    // valid slots NPW at a time, each window handed over by shuffles.
    int B = NPW;
    while (B < 32 && (long long)n_eff >= 2LL * B * n_warps) B *= 2;
    const long long step = n_warps * B;
    long long c0 = warp * B;
    Fields f = load_fields(a, c0 + lane, lane < B && c0 + lane < n_eff,
                           counted);
    for (; c0 < n_eff; c0 += step) {
        const long long cn = c0 + step + lane;
        const Fields f_next =
            load_fields(a, cn, lane < B && cn < n_eff, counted);
        const Window win = window_of(a, f);
        if (lane < B && c0 + lane < n_eff && !f.valid) a.out[c0 + lane] = 0;
        unsigned vm = __ballot_sync(full, f.valid);
        while (vm) {                      // NPW valid slots a round
            const unsigned pick = __fns(vm, 0, grp + 1);
            const bool has = pick < 32;
            const int src = has ? (int)pick : 0;
            const int n = __shfl_sync(full, win.n, src);
            const long long t = __shfl_sync(full, win.t, src);
            const long long q = __shfl_sync(full, win.q, src);
#pragma unroll
            for (int i = 0; i < NPW; ++i) vm &= vm - 1;
            const uint8_t* qp =
                PROFILE ? reinterpret_cast<const uint8_t*>(a.prof) + q * 32
                        : a.q_let + q;
            const int best = score_window<PROFILE>(
                a, lut, has ? n : 0, a.t_cat + t, qp,
                PROFILE ? nullptr : a.corr + q, lane);
            if (has && (lane & (G - 1)) == 0) a.out[c0 + pick] = best;
        }
        f = f_next;
    }
    // the slots past the count, after the candidates: a warp that ends
    // early does its share while long windows are still being scored
    zero_fill(a.out, n_eff, a.n_cand);
}

// Blocks the card holds at once, asked once per device and form and kept.
static int g_blocks[2][MAX_DEVICES];

template <bool PROFILE>
static int grid_blocks(int dev, int* out) {
    int& cached = g_blocks[PROFILE][dev];
    if (cached == 0) {
        int sms = 0, per_sm = 0;
        cudaError_t e =
            cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        if (e != cudaSuccess) return (int)e;
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, rescore_kernel<PROFILE>, THREADS, 0);
        if (e != cudaSuccess) return (int)e;
        if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
        cached = sms * per_sm;
    }
    *out = cached;
    return 0;
}

// Launches one form on `stream` with the candidate and target fields of
// `a` set; returns the CUDA error code (0 = ok).
template <bool PROFILE>
static int launch(const Args& a, void* stream) {
    if (a.n_cand <= 0) return 0;
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
    int blocks = 0;
    int err = grid_blocks<PROFILE>(dev, &blocks);
    if (err != 0) return err;
    // no more blocks than the slots could use
    const long long per_block = (long long)(THREADS / 32) * (32 / G);
    const long long useful = (a.n_cand + per_block - 1) / per_block;
    if (useful < blocks) blocks = (int)useful;
    rescore_kernel<PROFILE><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}

static Args candidate_args(const void* cqid, const void* cid,
                           const void* cdiag, const void* cvalid,
                           const void* n_valid, int n_cand, const void* t_cat,
                           long long t_bytes, const void* t_off,
                           const void* t_len, int lq, const void* q_len,
                           void* out) {
    Args a = {};
    a.cqid = (const int*)cqid;
    a.cid = (const int*)cid;
    a.cdiag = (const int*)cdiag;
    a.cvalid = (const uint8_t*)cvalid;
    a.n_valid = (const int*)n_valid;
    a.n_cand = n_cand;
    a.t_cat = (const uint8_t*)t_cat;
    a.t_bytes = t_bytes;
    a.t_off = (const long long*)t_off;
    a.t_len = (const int*)t_len;
    a.lq = lq;
    a.q_len = (const int*)q_len;
    a.out = (int*)out;
    return a;
}

// Launches the letters form on `stream`; returns the CUDA error code
// (0 = ok). Every pointer is a device pointer; n_valid (one int32) may be
// null. q_let and corr are (n_q, lq) row-major; submat is (alpha, alpha)
// row-major with alpha <= 32; letters of q_let and t_cat must be < alpha.
extern "C" int diag_rescore_launch(
    const void* cqid, const void* cid, const void* cdiag, const void* cvalid,
    const void* n_valid, int n_cand, const void* t_cat, long long t_bytes,
    const void* t_off, const void* t_len, const void* q_let,
    const void* corr, int n_q, int lq, const void* q_len,
    const void* submat, int alpha, void* out, void* stream) {
    if (alpha < 1 || alpha > MAX_ALPHA) return (int)cudaErrorInvalidValue;
    Args a = candidate_args(cqid, cid, cdiag, cvalid, n_valid, n_cand, t_cat,
                            t_bytes, t_off, t_len, lq, q_len, out);
    a.q_let = (const uint8_t*)q_let;
    a.corr = (const uint8_t*)corr;
    a.q_bytes = (long long)n_q * lq;
    a.submat = (const int*)submat;
    a.alpha = alpha;
    return launch<false>(a, stream);
}

// Launches the profile form on `stream`; returns the CUDA error code
// (0 = ok). prof is (n_q, lq, 32) int8 row-major; letters of t_cat must be
// < 32 (a letter's score is its column of the row).
extern "C" int diag_rescore_profile_launch(
    const void* cqid, const void* cid, const void* cdiag, const void* cvalid,
    const void* n_valid, int n_cand, const void* t_cat, long long t_bytes,
    const void* t_off, const void* t_len, const void* prof, int n_q, int lq,
    const void* q_len, void* out, void* stream) {
    (void)n_q;
    Args a = candidate_args(cqid, cid, cdiag, cvalid, n_valid, n_cand, t_cat,
                            t_bytes, t_off, t_len, lq, q_len, out);
    a.prof = (const int8_t*)prof;
    return launch<true>(a, stream);
}
