// probes.cu — the three row-fetch probes of the design as CUDA kernels:
// dependent row waves (dma_wave), a digest over gathered rows in four
// layouts (digest_consume), and a plain row gather (row_gather).
//
// Replaces the TPU probes of benchmarks/:
//   dma_wave       benchmarks/dma_probe.py:_make (pallas_call :99): B0
//                  lanes run K dependent waves; a wave fetches row
//                  tbl[idx[0,b]] (512 B) of each lane and sets
//                  idx[0,b] = (idx[0,b] + s) mod N, s the wrapping sum of
//                  the row's first 8 words (`wave`) or the popcount work of
//                  the `compute` variant (:73-87);
//   digest_consume benchmarks/gather_pallas_probe.py: consume (:49),
//                  consume_rowmajor (:103), run_pad128's consume (:157) and
//                  run_pad128_grid's consume3 (:195): d[w, b] = sum over
//                  q < RQ of row (q, b) word w, w < 8, from rows gathered
//                  outside the kernel in one of four layouts;
//   row_gather     benchmarks/gather_bench.py: gather_vmem (:54) and
//                  gather_hbm (:101): out[i] = table[idx[i]].
// Each computes what the TPU kernel computes; none is carried over block by
// block.  probe_floor_launch, an empty kernel, replaces no TPU kernel: it
// exists to measure the launch floor, the least time a launch of a given
// grid takes, which bounds the probes whose bytes take less.
//
// What bounds them on an H100, and what each design does about it:
// - dma_wave is bound by the latency of one dependent row fetch: wave t+1's
//   row index comes out of wave t's row.  One warp serves one lane: the
//   512-byte row is 32 threads x one 16-byte load (one coalesced request),
//   a warp shuffle forms `s`, and the lane's K waves run back to back in
//   one launch.  The TPU needs a DMA round trip a wave to bring the indices
//   of all lanes into scalar memory; here a lane's chain depends only on
//   its own rows, so lanes never wait for each other and no grid-wide sync
//   is needed.  At a small B0 the time a wave is the card's dependent-row
//   latency, which is what the probe is for.  The row loads are volatile so
//   that the `wave` variant, which uses 8 of the 128 words, still moves the
//   whole row as the TPU kernel does.
// - digest_consume is bound by the bytes it reads (8 of each row's 32 or
//   128 words, one 32-byte sector) and, at the probe's sizes, by its launch.
//   Lane-major input: a thread per (w, b), b fastest, so a warp reads 128
//   contiguous bytes of one word row.  Stream-major input (32 or 128 words
//   a row): a thread per (b, w), w fastest, so 8 threads read a row's 32
//   bytes.  Blocked input [RQ, B, 128]: a block per 256 lanes, as the TPU
//   grid blocks them, a thread per lane with two 16-byte loads a row.
// - row_gather is bound by bytes: each row read once and written once.  The
//   10 MB table and the 8.4 MB output of 65 536 rows both fit the 50 MB L2,
//   so across repeated calls the rows come from L2 and the bound that
//   applies may be L2's, not HBM's; below ~16 000 rows the bytes take less
//   than a launch, and the launch floor (probe_floor_launch) is the bound.
//   What keeps a gather from its bound is the bytes in flight: at a round
//   trip of ~1 us, 3.35 TB/s needs ~25 KB in flight on each of the 132
//   SMs (Little's law); a warp's load of 4 bytes a thread holds 128 bytes
//   in flight, one of 16 bytes a thread 512.  Both
//   designs start from a persistent grid: as many blocks as the card holds
//   at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor, asked once per
//   variant and device and cached), and no more than the rows need.
//   `direct`: eight threads move a row as 8 x 16 bytes, so each load
//   instruction of a warp covers 4 rows; a warp reads the indices of its
//   tile (up to 32 rows) in one coalesced load and hands them out with
//   __shfl_sync; `UNROLL` rows each group of 8 threads keeps in flight (u1:
//   4 rows a warp a step, u8: 32).  Tiles are as small as 4 rows when the
//   rows are few, so every warp of the grid has work: 2 048 threads x 16
//   bytes = 32 KB in flight an SM at u1.  Stores are streaming (st.cs), so
//   the output does not push the table out of L2.
//   `ring`: Hopper's counterpart of the TPU's ring of row DMAs.  A warp
//   runs a ring of NBUF 128-byte slots in shared memory, one mbarrier each;
//   its lane 0 starts one bulk copy (cp.async.bulk, completion counted in
//   bytes on the slot's mbarrier) a row into slot i % NBUF, and the rows
//   leave NBUF / 2 at a time, once landed, through one bulk store of a run
//   of contiguous output rows (cp.async.bulk ... bulk_group); before a
//   slot takes its next row, the store that reads it must have read it
//   (wait_group.read).  At least half a ring is in flight: a b32 ring is
//   4 KB, b8 1 KB, and an SM runs up to 48 and 64 of them.  A ring takes a
//   run of at least NBUF rows (n >= NBUF, as the TPU kernel needs).  On the
//   card the ring is slower than `direct` (PERF.md): what bounds it is the
//   cost of one bulk copy a 128-byte row, not the bytes in flight.  The
//   launch shape (grid, tile or run, slots, shared bytes) is gather_shape,
//   which benchmarks/kernels.py:gather_shape mirrors.

// Plain C interface, bound with ctypes (benchmarks/kernels.py).  Every
// launch function runs on the stream it is given, allocates nothing, and
// returns cudaGetLastError() (0 on success) or -1 for arguments it does not
// take.

#include <cuda_runtime.h>
#include <stdint.h>

#define PR_WARP 32
#define PR_BLOCK 128         // threads a block (4 warps) unless said otherwise
#define DIGEST_W 8           // digest words a row
#define BLOCKED_LANES 256    // lanes a block of the blocked layout

// floor modulo of the int32 sum x + s (wrapping, as jnp's int32 add) by N,
// jnp's `%` on int32: the result has the sign of N
__device__ __forceinline__ int wrap_floor_mod(int x, int s, int n) {
    int v = (int)((uint32_t)x + (uint32_t)s);
    int r = v % n;
    return r < 0 ? r + n : r;
}

__device__ __forceinline__ int4 ld_row16(const int4* p) {
    int4 v;
    asm volatile("ld.global.v4.s32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                 : "l"(p) : "memory");
    return v;
}

// ------------------------------------------------------------------- K4

template <bool COMPUTE>
__global__ void dma_wave_kernel(const int32_t* __restrict__ idx0,
                                const int32_t* __restrict__ tbl,
                                int32_t* __restrict__ out, int B0, int K,
                                int N) {
    const int t = threadIdx.x & (PR_WARP - 1);
    const int b = (blockIdx.x * blockDim.x + threadIdx.x) / PR_WARP;
    if (b >= B0) return;
    int idx = idx0[b];
    for (int k = 0; k < K; k++) {
        // the lane's 512-byte row: thread t holds words 4t .. 4t+3
        const int4 v = ld_row16(
            reinterpret_cast<const int4*>(tbl + (size_t)idx * 128) + t);
        int s;
        if (!COMPUTE) {
            // wrapping sum of words 0..7 (threads 0 and 1)
            const uint32_t part = (uint32_t)v.x + (uint32_t)v.y
                                + (uint32_t)v.z + (uint32_t)v.w;
            s = (int)(__shfl_sync(0xffffffffu, part, 0)
                      + __shfl_sync(0xffffffffu, part, 1));
        } else {
            // acc[j] = sum over rep < 2, w < 4 of popcount(AND over tt < 4
            // of (bit tt of j ? x : ~x)), x = word rep*16 + 4*tt + w, which
            // thread rep*4 + tt holds as component w; thread j < 8 forms
            // acc[j], and s = acc[0] + ... + acc[7]
            int acc = 0;
#pragma unroll
            for (int rep = 0; rep < 2; rep++) {
                uint32_t x[4][4];
#pragma unroll
                for (int tt = 0; tt < 4; tt++) {
                    const int src = rep * 4 + tt;
                    x[tt][0] = (uint32_t)__shfl_sync(0xffffffffu, v.x, src);
                    x[tt][1] = (uint32_t)__shfl_sync(0xffffffffu, v.y, src);
                    x[tt][2] = (uint32_t)__shfl_sync(0xffffffffu, v.z, src);
                    x[tt][3] = (uint32_t)__shfl_sync(0xffffffffu, v.w, src);
                }
#pragma unroll
                for (int w = 0; w < 4; w++) {
                    uint32_t m = 0xffffffffu;
#pragma unroll
                    for (int tt = 0; tt < 4; tt++)
                        m &= ((t >> tt) & 1) ? x[tt][w] : ~x[tt][w];
                    acc += __popc(m);
                }
            }
            acc = t < 8 ? acc : 0;
#pragma unroll
            for (int o = 4; o > 0; o >>= 1)
                acc += __shfl_xor_sync(0xffffffffu, acc, o);
            s = __shfl_sync(0xffffffffu, acc, 0);
        }
        idx = wrap_floor_mod(idx, s, N);
    }
    // row 0 holds the final indices, rows 1..7 are idx0's
    if (t == 0) out[b] = idx;
    else if (t < 8) out[(size_t)t * B0 + b] = idx0[(size_t)t * B0 + b];
}

extern "C" int dma_wave_launch(const void* idx0, const void* tbl, void* out,
                               int B0, int K, int N, int compute,
                               void* stream) {
    if (B0 < 1 || K < 0 || N < 1) return -1;
    const int blocks = (B0 * PR_WARP + PR_BLOCK - 1) / PR_BLOCK;
    cudaStream_t st = (cudaStream_t)stream;
    if (compute)
        dma_wave_kernel<true><<<blocks, PR_BLOCK, 0, st>>>(
            (const int32_t*)idx0, (const int32_t*)tbl, (int32_t*)out, B0, K,
            N);
    else
        dma_wave_kernel<false><<<blocks, PR_BLOCK, 0, st>>>(
            (const int32_t*)idx0, (const int32_t*)tbl, (int32_t*)out, B0, K,
            N);
    return (int)cudaGetLastError();
}

// ------------------------------------------------------------------- K5

// layouts of the gathered rows (benchmarks/kernels.py LAYOUTS)
#define LAYOUT_LANE_MAJOR 0      // [RQ * 32, B]
#define LAYOUT_ROW_MAJOR 1       // [RQ * B, 32]
#define LAYOUT_ROW_MAJOR_128 2   // [RQ * B, 128]
#define LAYOUT_BLOCKED_128 3     // [RQ, B, 128], a block per 256 lanes

template <int LAYOUT>
__global__ void digest_kernel(const int32_t* __restrict__ x,
                              int32_t* __restrict__ d, int RQ, int B) {
    if (LAYOUT == LAYOUT_BLOCKED_128) {
        const int b = blockIdx.x * BLOCKED_LANES + threadIdx.x;
        if (b >= B) return;
        uint32_t acc[DIGEST_W] = {0, 0, 0, 0, 0, 0, 0, 0};
        for (int q = 0; q < RQ; q++) {
            const int4* r = reinterpret_cast<const int4*>(
                x + ((size_t)q * B + b) * 128);
            const int4 lo = r[0], hi = r[1];
            acc[0] += lo.x; acc[1] += lo.y; acc[2] += lo.z; acc[3] += lo.w;
            acc[4] += hi.x; acc[5] += hi.y; acc[6] += hi.z; acc[7] += hi.w;
        }
#pragma unroll
        for (int w = 0; w < DIGEST_W; w++) d[(size_t)w * B + b] = (int)acc[w];
        return;
    }
    const int g = blockIdx.x * blockDim.x + threadIdx.x;
    if (g >= DIGEST_W * B) return;
    int w, b;
    if (LAYOUT == LAYOUT_LANE_MAJOR) { w = g / B; b = g - w * B; }
    else { b = g / DIGEST_W; w = g - b * DIGEST_W; }
    uint32_t acc = 0;
    for (int q = 0; q < RQ; q++) {
        size_t at;
        if (LAYOUT == LAYOUT_LANE_MAJOR) at = ((size_t)q * 32 + w) * B + b;
        else if (LAYOUT == LAYOUT_ROW_MAJOR) at = ((size_t)q * B + b) * 32 + w;
        else at = ((size_t)q * B + b) * 128 + w;
        acc += (uint32_t)x[at];
    }
    d[(size_t)w * B + b] = (int)acc;
}

extern "C" int digest_consume_launch(const void* x, void* d, int RQ, int B,
                                     int layout, void* stream) {
    if (RQ < 1 || B < 1) return -1;
    cudaStream_t st = (cudaStream_t)stream;
    const int32_t* xi = (const int32_t*)x;
    int32_t* di = (int32_t*)d;
    const int blocks = (DIGEST_W * B + PR_BLOCK - 1) / PR_BLOCK;
    switch (layout) {
    case LAYOUT_LANE_MAJOR:
        digest_kernel<LAYOUT_LANE_MAJOR><<<blocks, PR_BLOCK, 0, st>>>(
            xi, di, RQ, B);
        break;
    case LAYOUT_ROW_MAJOR:
        digest_kernel<LAYOUT_ROW_MAJOR><<<blocks, PR_BLOCK, 0, st>>>(
            xi, di, RQ, B);
        break;
    case LAYOUT_ROW_MAJOR_128:
        digest_kernel<LAYOUT_ROW_MAJOR_128><<<blocks, PR_BLOCK, 0, st>>>(
            xi, di, RQ, B);
        break;
    case LAYOUT_BLOCKED_128:
        if (B % BLOCKED_LANES) return -1;
        digest_kernel<LAYOUT_BLOCKED_128>
            <<<B / BLOCKED_LANES, BLOCKED_LANES, 0, st>>>(xi, di, RQ, B);
        break;
    default:
        return -1;
    }
    return (int)cudaGetLastError();
}

// ------------------------------------------------------------------- K6

#define GATHER_WARPS (PR_BLOCK / PR_WARP)   // warps, or rings, a block
#define ROW_BYTES 128                        // a row of the gathered table
#define RING_STAGES 2                        // bulk stores a turn of a ring
#define FULL_MASK 0xffffffffu

// `direct`: warp w takes tiles w, w + W, ... (W warps in the grid) of
// `tile` rows; lane l holds the index of the tile's row l.  Group g (lanes
// 8g .. 8g+7) moves rows s + 4u + g of each step s of 4 * UNROLL rows,
// lane 8g + j the row's 16-byte word j.
template <int UNROLL>
__global__ void __launch_bounds__(PR_BLOCK)
gather_direct_kernel(const int4* __restrict__ table,
                     const int32_t* __restrict__ idx,
                     int4* __restrict__ out, int n, int tile) {
    const int lane = threadIdx.x & (PR_WARP - 1);
    const int g = lane >> 3, j = lane & 7;
    const long long warp =
        ((long long)blockIdx.x * blockDim.x + threadIdx.x) / PR_WARP;
    const long long nwarps = (long long)gridDim.x * blockDim.x / PR_WARP;
    for (long long t0 = warp * tile; t0 < n; t0 += nwarps * tile) {
        const int m = (int)(n - t0 < tile ? n - t0 : tile);
        const int mine = lane < m ? __ldg(idx + t0 + lane) : 0;
#pragma unroll 1
        for (int s = 0; s < m; s += 4 * UNROLL) {
            int4 v[UNROLL];
#pragma unroll
            for (int u = 0; u < UNROLL; u++) {
                const int r = s + 4 * u + g;
                const int row = __shfl_sync(FULL_MASK, mine,
                                            r & (PR_WARP - 1));
                if (r < m) v[u] = __ldg(table + (size_t)row * 8 + j);
            }
#pragma unroll
            for (int u = 0; u < UNROLL; u++) {
                const int r = s + 4 * u + g;
                if (r < m) __stcs(out + (size_t)(t0 + r) * 8 + j, v[u]);
            }
        }
    }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                 :: "r"(bar), "r"(count) : "memory");
}

// one arrival that also arms the barrier's phase for `bytes` of copies
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(bar), "r"(bytes) : "memory");
}

// until the barrier's phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    uint32_t done;
    do {
        asm volatile("{\n\t.reg .pred p;\n\t"
                     "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;"
                     "\n\tselp.u32 %0, 1, 0, p;\n\t}"
                     : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    } while (!done);
}

// global -> shared, `bytes` counted on `bar` when they land
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::"
                 "complete_tx::bytes [%0], [%1], %2, [%3];"
                 :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// shared -> global, in the thread's current bulk group
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src,
                                           uint32_t bytes) {
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
                 :: "l"(dst), "r"(src), "r"(bytes) : "memory");
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// until every bulk store this thread committed has read its source
__device__ __forceinline__ void bulk_wait_read() {
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// `ring`: warp w of block b runs ring b * GATHER_WARPS + w over rows
// [s0, s0 + cnt), s0 = ring * run.  Shared memory: every ring's NBUF slots
// of ROW_BYTES, then every ring's NBUF mbarriers (8 bytes each).  Ring row
// q (0 <= q < cnt) lands in slot q % NBUF in that slot's use q / NBUF, whose
// phase has parity (q / NBUF) & 1.  Rows leave in stages of NBUF /
// RING_STAGES rows, one bulk store each: a stage's rows sit in contiguous
// slots (its first row's slot is a multiple of the stage size), and go to
// contiguous output rows.  All lanes run the loop (warp-uniform); lane 0
// alone issues copies and stores and waits on the barriers.
template <int NBUF>
__global__ void __launch_bounds__(PR_BLOCK)
gather_ring_kernel(const int32_t* __restrict__ table,
                   const int32_t* __restrict__ idx,
                   int32_t* __restrict__ out, int n, int run) {
    constexpr int G = NBUF / RING_STAGES;
    extern __shared__ __align__(128) unsigned char ring_smem[];
    const int lane = threadIdx.x & (PR_WARP - 1);
    const int wib = threadIdx.x / PR_WARP;
    const long long s0 = ((long long)blockIdx.x * GATHER_WARPS + wib) * run;
    if (s0 >= n) return;
    const int cnt = (int)(n - s0 < run ? n - s0 : run);
    const uint32_t slots = smem_u32(ring_smem) + wib * NBUF * ROW_BYTES;
    const uint32_t bars = smem_u32(ring_smem)
                        + GATHER_WARPS * NBUF * ROW_BYTES + wib * NBUF * 8;
    if (lane == 0) {
        for (int k = 0; k < NBUF; k++) mbar_init(bars + 8 * k, 1);
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncwarp();
    const int32_t* ix = idx + s0;
    int base = -PR_WARP, mine = 0;   // lane l holds the index of row base + l
    // start ring row q's copy into slot q % NBUF; q rises by one each call
    auto issue = [&](int q) {
        if (q >= base + PR_WARP) {
            base = q;
            mine = base + lane < cnt ? __ldg(ix + base + lane) : 0;
        }
        const int row = __shfl_sync(FULL_MASK, mine, q - base);
        if (lane == 0) {
            const uint32_t bar = bars + 8 * (q % NBUF);
            mbar_expect_tx(bar, ROW_BYTES);
            bulk_load(slots + ROW_BYTES * (q % NBUF),
                      table + (size_t)row * (ROW_BYTES / 4), ROW_BYTES, bar);
        }
    };
    for (int q = 0; q < cnt && q < NBUF; q++) issue(q);
    for (int st = 0; st < cnt; st += G) {
        const int k = cnt - st < G ? cnt - st : G;
        if (lane == 0) {
            for (int q = st; q < st + k; q++)
                mbar_wait(bars + 8 * (q % NBUF), (q / NBUF) & 1);
            // the rows landed through the async proxy; order the store's
            // reads after them
            asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
            bulk_store(out + (size_t)(s0 + st) * (ROW_BYTES / 4),
                       slots + ROW_BYTES * (st % NBUF), k * ROW_BYTES);
            if (st + NBUF < cnt) bulk_wait_read();   // the slots are free
        }
        for (int q = st + NBUF; q < st + NBUF + k && q < cnt; q++) issue(q);
    }
    if (lane == 0) bulk_wait_read();   // before the block's shared memory goes
}

__global__ void floor_kernel() {}

// The launch shape of a row_gather launch (benchmarks/kernels.py
// gather_shape mirrors it): `sms` SMs holding `bps` blocks each.  direct:
// step = 4 * unroll rows a warp a step; tile = the least of step, 2 step,
// ... 32 rows for which every tile has its own warp (else 32); grid = the
// blocks the tiles need, at most sms * bps.  ring: step = nbuf /
// RING_STAGES rows a bulk store; tile (the run of rows a ring) = the most
// rows a ring of sms * bps * GATHER_WARPS must take, at least nbuf,
// rounded up to a whole stage; grid = the blocks those rings fill.
struct GatherShape { int grid, block, step, tile, slots, smem; };

static void gather_shape(long long n, int mode, int unroll, int nbuf,
                         int sms, int bps, GatherShape* s) {
    const long long blocks_max = (long long)sms * bps;
    const long long warps_max = blocks_max * GATHER_WARPS;
    s->block = PR_BLOCK;
    if (mode == 0) {
        s->step = 4 * unroll;
        long long tile = s->step;
        while (tile < PR_WARP && (n + tile - 1) / tile > warps_max) tile *= 2;
        const long long blocks =
            ((n + tile - 1) / tile + GATHER_WARPS - 1) / GATHER_WARPS;
        s->grid = (int)(blocks < blocks_max ? blocks : blocks_max);
        s->tile = (int)tile;
        s->slots = 0;
        s->smem = 0;
    } else {
        s->step = nbuf / RING_STAGES;
        long long run = (n + warps_max - 1) / warps_max;
        if (run < nbuf) run = nbuf;
        run = (run + s->step - 1) / s->step * s->step;
        const long long rings = (n + run - 1) / run;
        s->grid = (int)((rings + GATHER_WARPS - 1) / GATHER_WARPS);
        s->tile = (int)run;
        s->slots = nbuf;
        s->smem = GATHER_WARPS * nbuf * (ROW_BYTES + 8);
    }
}

// variants: 0 direct u1, 1 direct u8, 2 ring b8, 3 ring b32; -1 refused
static int gather_variant(int mode, int unroll, int nbuf) {
    if (mode == 0) return unroll == 1 ? 0 : unroll == 8 ? 1 : -1;
    if (mode == 1) return nbuf == 8 ? 2 : nbuf == 32 ? 3 : -1;
    return -1;
}

#define GATHER_MAX_DEVICES 64
static int g_sms[GATHER_MAX_DEVICES];
static int g_bps[4][GATHER_MAX_DEVICES];   // 0: not asked yet

// SMs of the current device and blocks of `variant` an SM holds, asked once
// and cached; asked for the first time inside a stream capture, refused
// (returns -1), since a capture must take no such query
static int gather_occupancy(int variant, cudaStream_t st, int* sms,
                            int* bps) {
    int dev;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev >= GATHER_MAX_DEVICES) return -1;
    if (!g_sms[dev] || !g_bps[variant][dev]) {
        cudaStreamCaptureStatus cs;
        e = cudaStreamIsCapturing(st, &cs);
        if (e != cudaSuccess) return (int)e;
        if (cs != cudaStreamCaptureStatusNone) return -1;
        int m = 0, b = 0;
        e = cudaDeviceGetAttribute(&m, cudaDevAttrMultiProcessorCount, dev);
        if (e != cudaSuccess) return (int)e;
        const int nbuf = variant == 2 ? 8 : 32;
        const size_t smem = GATHER_WARPS * nbuf * (ROW_BYTES + 8);
        switch (variant) {
        case 0: e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    &b, gather_direct_kernel<1>, PR_BLOCK, 0); break;
        case 1: e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    &b, gather_direct_kernel<8>, PR_BLOCK, 0); break;
        case 2: e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    &b, gather_ring_kernel<8>, PR_BLOCK, smem); break;
        default: e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    &b, gather_ring_kernel<32>, PR_BLOCK, smem); break;
        }
        if (e != cudaSuccess) return (int)e;
        if (b < 1) return -1;
        g_sms[dev] = m;
        g_bps[variant][dev] = b;
    }
    *sms = g_sms[dev];
    *bps = g_bps[variant][dev];
    return 0;
}

// The launch shape row_gather_launch takes on the current device, as
// out[0..7] = grid, block, step, tile, slots, smem, SMs, blocks an SM.
extern "C" int row_gather_shape(int n, int mode, int unroll, int nbuf,
                                int* out) {
    const int v = gather_variant(mode, unroll, nbuf);
    if (n < 1 || v < 0) return -1;
    int sms, bps;
    const int rc = gather_occupancy(v, 0, &sms, &bps);
    if (rc) return rc;
    GatherShape s;
    gather_shape(n, mode, unroll, nbuf, sms, bps, &s);
    const int o[8] = {s.grid, s.block, s.step, s.tile, s.slots, s.smem, sms,
                      bps};
    for (int k = 0; k < 8; k++) out[k] = o[k];
    return 0;
}

// mode 0 = direct (unroll 1 or 8), 1 = ring (nbuf 8 or 32); the table has
// 32 int32 words a row; n >= nbuf for the ring (the TPU kernel starts nbuf
// copies before its loop); table and out 16-byte aligned.
extern "C" int row_gather_launch(const void* table, const void* idx,
                                 void* out, int n, int mode, int unroll,
                                 int nbuf, void* stream) {
    const int v = gather_variant(mode, unroll, nbuf);
    if (n < 1 || v < 0 || (mode == 1 && n < nbuf)) return -1;
    if (((uintptr_t)table | (uintptr_t)out) & 15) return -1;
    cudaStream_t st = (cudaStream_t)stream;
    int sms, bps;
    const int rc = gather_occupancy(v, st, &sms, &bps);
    if (rc) return rc;
    GatherShape s;
    gather_shape(n, mode, unroll, nbuf, sms, bps, &s);
    const int32_t* tb = (const int32_t*)table;
    const int32_t* ix = (const int32_t*)idx;
    int32_t* o = (int32_t*)out;
    switch (v) {
    case 0:
        gather_direct_kernel<1><<<s.grid, s.block, 0, st>>>(
            (const int4*)tb, ix, (int4*)o, n, s.tile);
        break;
    case 1:
        gather_direct_kernel<8><<<s.grid, s.block, 0, st>>>(
            (const int4*)tb, ix, (int4*)o, n, s.tile);
        break;
    case 2:
        gather_ring_kernel<8><<<s.grid, s.block, s.smem, st>>>(
            tb, ix, o, n, s.tile);
        break;
    default:
        gather_ring_kernel<32><<<s.grid, s.block, s.smem, st>>>(
            tb, ix, o, n, s.tile);
        break;
    }
    return (int)cudaGetLastError();
}

// ------------------------------------------------------------ launch floor

// An empty kernel of `grid` blocks of `block` threads: the least time a
// launch of that shape takes (no TPU kernel; see the note at the top).
extern "C" int probe_floor_launch(int grid, int block, void* stream) {
    if (grid < 1 || block < 1 || block > 1024) return -1;
    floor_kernel<<<grid, block, 0, (cudaStream_t)stream>>>();
    return (int)cudaGetLastError();
}
