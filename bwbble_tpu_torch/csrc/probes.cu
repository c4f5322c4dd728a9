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
// block.
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
// - row_gather is bound by bytes: rows read once (the 10 MB table sits in
//   the 50 MB L2 after the first touch), rows written once.  `direct`: a
//   warp per row, 32 x 4 bytes coalesced, `UNROLL` rows a warp per step so
//   that UNROLL independent loads are in flight.  `ring`: each warp takes a
//   run of rows and keeps NBUF row copies in flight with cp.async into its
//   own shared-memory ring (the counterpart of the TPU's ring of NBUF row
//   DMAs), storing the oldest to `out` as it lands; a thread copies and
//   stores the same word of every row, so it waits only on its own copies.
//
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

// `direct`: warp w handles rows w*UNROLL .. w*UNROLL+UNROLL-1 of each step
// of gridDim*warps*UNROLL rows; thread t moves word t of each of them.
template <int UNROLL>
__global__ void gather_direct_kernel(const int32_t* __restrict__ table,
                                     const int32_t* __restrict__ idx,
                                     int32_t* __restrict__ out, int n) {
    const int t = threadIdx.x & (PR_WARP - 1);
    const int warp = (blockIdx.x * blockDim.x + threadIdx.x) / PR_WARP;
    const int nwarps = gridDim.x * blockDim.x / PR_WARP;
    for (int i0 = warp * UNROLL; i0 < n; i0 += nwarps * UNROLL) {
        int v[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; u++) {
            const int i = i0 + u;
            v[u] = i < n ? table[(size_t)idx[i] * 32 + t] : 0;
        }
#pragma unroll
        for (int u = 0; u < UNROLL; u++) {
            const int i = i0 + u;
            if (i < n) out[(size_t)i * 32 + t] = v[u];
        }
    }
}

__device__ __forceinline__ void cp_async4(uint32_t smem, const void* g) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
                 :: "r"(smem), "l"(g) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

// `ring`: warp w copies rows [w*run, w*run + run) with NBUF copies in
// flight: row i lands in slot i % NBUF of the warp's ring; at step i the
// thread waits for its copy of row i (one commit group a row, committed in
// order), stores it, and starts row i + NBUF in the freed slot.
template <int NBUF>
__global__ void gather_ring_kernel(const int32_t* __restrict__ table,
                                   const int32_t* __restrict__ idx,
                                   int32_t* __restrict__ out, int n,
                                   int run) {
    extern __shared__ int32_t ring_smem[];
    const int t = threadIdx.x & (PR_WARP - 1);
    const int wib = threadIdx.x / PR_WARP;
    const int warp = (blockIdx.x * blockDim.x + threadIdx.x) / PR_WARP;
    int32_t* ring = ring_smem + (size_t)wib * NBUF * 32;
    const int s = warp * run;
    if (s >= n) return;
    const int e = s + run < n ? s + run : n;
    const uint32_t base =
        (uint32_t)__cvta_generic_to_shared(ring) + 4u * (uint32_t)t;
#pragma unroll
    for (int j = 0; j < NBUF; j++) {
        if (s + j < e)
            cp_async4(base + 128u * j, table + (size_t)idx[s + j] * 32 + t);
        cp_async_commit();
    }
    for (int i = s; i < e; i++) {
        const int slot = (i - s) % NBUF;
        cp_async_wait<NBUF - 1>();
        out[(size_t)i * 32 + t] = ring[slot * 32 + t];
        if (i + NBUF < e)
            cp_async4(base + 128u * slot,
                      table + (size_t)idx[i + NBUF] * 32 + t);
        cp_async_commit();
    }
    cp_async_wait<0>();
}


// mode 0 = direct (unroll 1 or 8), 1 = ring (nbuf 8 or 32); the table has
// 32 int32 words a row; n >= nbuf for the ring (the TPU kernel starts nbuf
// copies before its loop).
extern "C" int row_gather_launch(const void* table, const void* idx,
                                 void* out, int n, int mode, int unroll,
                                 int nbuf, void* stream) {
    if (n < 1) return -1;
    cudaStream_t st = (cudaStream_t)stream;
    const int32_t* tb = (const int32_t*)table;
    const int32_t* ix = (const int32_t*)idx;
    int32_t* o = (int32_t*)out;
    const int warps_per_block = PR_BLOCK / PR_WARP;
    if (mode == 0) {
        if (unroll != 1 && unroll != 8) return -1;
        const int steps = (n + unroll - 1) / unroll;
        int blocks = (steps + warps_per_block - 1) / warps_per_block;
        if (unroll == 1)
            gather_direct_kernel<1><<<blocks, PR_BLOCK, 0, st>>>(tb, ix, o, n);
        else
            gather_direct_kernel<8><<<blocks, PR_BLOCK, 0, st>>>(tb, ix, o, n);
    } else if (mode == 1) {
        if ((nbuf != 8 && nbuf != 32) || n < nbuf) return -1;
        const int run = 4 * nbuf;      // rows a warp: four turns of its ring
        const int warps = (n + run - 1) / run;
        const int blocks = (warps + warps_per_block - 1) / warps_per_block;
        const size_t smem = (size_t)warps_per_block * nbuf * 32 * 4;
        if (nbuf == 8)
            gather_ring_kernel<8><<<blocks, PR_BLOCK, smem, st>>>(
                tb, ix, o, n, run);
        else
            gather_ring_kernel<32><<<blocks, PR_BLOCK, smem, st>>>(
                tb, ix, o, n, run);
    } else {
        return -1;
    }
    return (int)cudaGetLastError();
}
