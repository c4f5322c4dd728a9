// ring_search.cu — the inexact search as one CUDA kernel, in two launch
// modes (ring queue, fixed batch), for two alphabets (the 16-letter
// multi-genome, the 4-letter single genome of `-S`) and for two index
// layouts (int32; int64, the whole-genome layout, in fixed mode only), each
// fixed one also over a table range-sharded across the cards of a mesh row:
// ten instantiations of one template.
//
// Replaces: bwbble_tpu/engine/kernel.py:_resident_kernel, in ring mode
// (driven by run_loop_resident_queued) and in fixed-batch mode (driven by
// run_loop_resident), with its compute core _iter_math (_rank16,
// _exact_cands, _merge_compact, _merge_groups_tail, _emit) and the path walk
// the TPU ran outside the kernel (the flush-time walk of
// bwbble_tpu/engine/inexact.py:switch_step; walk_paths after a fixed batch);
// and bwbble_tpu/engine/kernel.py:_kernel_body, the per-iteration kernel
// that serves seeded searches (`-P`: NROOT > 1 root rows a read, picked by
// node id in run_loop), in both launch modes.  Seen from outside it is the
// same function: per read, the alignments the score-bucketed best-first DFS
// (inexact_match.c:256-506) reports, in discovery order, with their packed
// state paths.
//
// The search.  A lane runs its reads to completion.  In ring mode a lane
// takes the next read id from a global counter (atomicAdd keeps the
// caller's hardest-first queue order); in fixed mode lane b runs read b and
// nothing else.  For a read the lane loops
//   pop -> prune -> emit | exact-complete | expand -> link -> write frame,
// then walks the parent chains of the read's reported alignments and writes
// the per-read outputs.  A lane restarts its pop clock at every read, so the
// lane's arena column is a plain array of NFRAME frame rows and a read's
// frame budget is NFRAME of its own pops.  Ring mode flags a read that is
// not finished right after its NFRAME-th pop; fixed mode flags a read that
// attempts one more pop after NFRAME (engine/inexact.py states both rules).
// Any capacity overflow ends the read at once with its reason bit set:
// callers discard and retry such reads, so nothing after the flag is
// observable.
//
// What bounds it on an H100: not bytes and not arithmetic, but the latency
// of dependent fetches.  A pop is a chain: the popped node's slot, then the
// two rank rows its interval selects, then the frame row written from
// them; an exact completion is a chain of characters, each reading the rank
// rows of every interval of the list the previous character produced.  A
// read's pops follow one another, so a lane's time is its number of work
// units times the latency of one round of fetches (`dma_wave` in
// csrc/probes.cu measures that latency), and the card's memory rate is far
// from reached.  What this design does about it:
// - A warp per lane, all 32 threads at work, control flow uniform across
//   the warp: decisions are made once and shared with ballots, match and
//   reduce intrinsics and shuffles; no thread leaves early.
// - Both rank rows of a pop in one step, asked for as soon as the popped
//   node is known: half-warp 0 reads the row of L - 1, half-warp 1 that of
//   U, and the pop's bookkeeping, prune and allow decisions run while the
//   rows are in flight; thread j of a half then forms code j's bound, so
//   the 16 codes of both ends come out together, and the slot threads take
//   theirs with two shuffles.
// - The expansion in parallel: thread s forms slot s; the sequential LIFO
//   push becomes a match over the slots' buckets (a slot links to the
//   highest earlier valid slot of its bucket, else to the bucket's old
//   head; the last valid slot of a bucket becomes its head), a warp minimum
//   and a popcount; the slot threads write the frame row in one store.
// - Pops from registers: thread s keeps the slot it formed last; a pop of a
//   node of that frame (often the next pop) takes it with a shuffle instead
//   of a dependent read of the arena.  The counters still count the
//   algorithm's frame reads, not the cache's.
// - A read's small state in shared memory, staged once per read: its
//   codes, its D and D_seed rows, the two exact-completion lists, beside
//   the bucket heads; the lowest occupied bucket is a ballot over 32 heads.
// - The exact completion across the warp: a character's (interval, code)
//   items go to threads, 32 at a time, each ranking its two ends, so up to
//   32 independent items are in flight (an item's two rows one after the
//   other: asked for together they cost registers and spills, and ran
//   slower); the sequential merge (an item joins the previous run iff L ==
//   U_prev + 1, U_prev the previous non-empty item's U) becomes ballots and
//   a prefix count.  The duplicate check of an emit is spread over the
//   threads (the emits stay in order).
// - A read's fixed costs: the path walk takes one alignment a thread and,
//   on the int32 layout when a read has at most RS_PAR_MAX frames (short
//   reads: seeded, easy, the first fixed tier), reads each frame's parent
//   from shared memory instead of a dependent arena row a step (the walk
//   was 16 % of a short seeded lane's cycles); a ring lane asks for its
//   next read before the walk, so the atomic's latency overlaps it.
//
// The alphabet is a compile-time parameter: NC = 11 codes, NSLOT = 23 and
// 128-word frame rows for a multi-genome; NC = 4, NSLOT = 9 and 40-word rows
// (37 used) for a single genome, where every code is a pure base, so the
// IUPAC match test reduces to equality, no code counts as a SNP, and an
// exact completion keeps one interval.
//
// The int64 layout (IT = long long; fixed batches only, as in the JAX
// package).  The index table's rows are 48 words (192 bytes): the 16 plane
// words, the low and then the high 32 bits of the 16 checkpoint counts, so
// a rank is still one row read, and forms 64-bit counts.  C, the length,
// the frame's L/U, the exact-completion lists, D, D_seed, the seed
// intervals and the reported alignments are 64-bit; a frame slot is 6
// words (L and U low word first, then meta1, meta2), so frame rows are
// NSLOT * 6 + 1 words padded to a multiple of 4 (140 and 56).  Nothing else
// moves: exploration order is the contract.
//
// Sharded tables (tp > 1; fixed batches only, as a mesh runs them).
// `--mesh DP,TP` range-shards the table over the tp cards of a mesh row
// (parallel/shard.py): shard s holds blocks [s * nloc, (s + 1) * nloc), the
// last one zero-padded.  A rank row is read from the shard that owns its
// block, on the launching card or on a peer card over NVLink (peer access,
// ring_search_enable_peer); the rows are the same, so every result is the
// unsharded launch's.  Only the row's address changes (row_addr); the
// unsharded instantiations read through their own table pointer.  No padding
// row is read: positions are clamped to length - 2 before the block lookup.
//
// Seeded roots.  Given seed_L/seed_U [Q, NROOT] and seed_cnt [Q], read r's
// root s < scnt is (seed_L[r][s], seed_U[r][s]) at i = len - PK with a
// PK-long all-match path, linked to root s - 1 in bucket 0 (links are stored
// +1, so root 0 ends the chain): the roots pop last-first, as the
// reference's heap pops its seed pushes (inexact_match.c:269-282).  A root
// pop reads its row straight from the seed arrays; scnt == 0 ends the read
// with no alignment and no overflow.  Without seeds (null pointers, NROOT =
// 1) the one root is the whole SA range at i = len, formed in registers.
//
// Memory.  A block is one lane (one warp).  Its shared memory holds C, the
// read's D and D_seed rows, the two exact-completion lists (XC entries
// each), the NB bucket heads, the read's codes and, on the int32 layout
// for reads of at most RS_PAR_MAX frames, the frames' parents
// (ring_search_lane_smem gives the bytes; the launch asks for more than 48
// KB a block where it needs it, and the wrapper refuses a configuration
// past the card's 227 KB).  The frame arena is per-lane global scratch.  Reported alignments are written
// straight into the per-read output slab, which also serves the duplicate
// check.  The kernel allocates nothing and runs on the stream it is given.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>
#include <string.h>
#include <type_traits>

#define RS_WARP 32           // threads per lane: each lane owns a warp
#define RS_NMETA 9           // q_meta columns (engine/inexact.py META_*)
#define RS_SMEM_MAX 232448   // dynamic shared memory a block may have (H100)
#define RS_FULL 0xFFFFFFFFu
#define RS_PAR_MAX 2048      // frames a read whose parents shared memory keeps
#define RS_TP_MAX 8          // shards a table may have (cards of a mesh row)

#define STATE_M 0
#define STATE_I 1
#define STATE_D 2

// overflow reasons (engine/inexact.py OV_*)
#define OV_LIST 1
#define OV_ACAP 2
#define OV_PATH 4
#define OV_FRAMES 8
#define OV_WORK 16

// int32 fields, filled from a host int array in this order
struct RSParams {
    int p_mm, p_go, p_ge, p_maxdiff, p_maxgapo, p_maxgape, p_seedlen,
        p_maxdiffseed, p_maxbest, p_noindel, p_maxentries;
    int NB, NFRAME, ACAP, XC, PATHCAP, max_iters;
    int Q, Lmax, DS, LEN, lanes, PW;
    int NROOT, PK;           // root rows a read; seed length (seeded only)
    int LEN_HI;              // high 32 bits of the length (int64 layout)
};

// The index layout: IT is the type of positions, counts and intervals.
template <typename IT>
struct Layout {
    static constexpr bool X64 = sizeof(IT) == 8;
    static constexpr int TW = X64 ? 48 : 32;      // table words a row
    static constexpr int NW = X64 ? 6 : 4;        // frame words a node
    __host__ __device__ static IT length(const RSParams& P) {
        return X64 ? (IT)(((unsigned long long)(uint32_t)P.LEN_HI << 32)
                          | (uint32_t)P.LEN)
                   : (IT)P.LEN;
    }
};

// The index table as the kernel reads it: shard s holds blocks [s * nloc,
// (s + 1) * nloc) of the table (tp = 1: p[0] is the whole table).
struct Shards {
    const int32_t* p[RS_TP_MAX];
    long long nloc;
    int tp;
};

// The row of block ic >> 7 (ic a clamped position): in the one table, through
// the kernel's restrict-qualified pointer (not TP: without the qualifier
// ptxas gave the unsharded instantiations 120-122 registers instead of 96,
// and the int64 ones spills), or row k % nloc of shard k / nloc (TP; p[]
// read from the kernel's parameter space).
template <typename IT, bool TP>
__device__ __forceinline__ const int32_t* row_addr(
        const int32_t* __restrict__ table, const Shards& sh, IT ic) {
    const IT k = ic >> 7;
    if constexpr (!TP) {
        return table + (size_t)k * Layout<IT>::TW;
    } else {
        const IT nloc = (IT)sh.nloc;
        int s = 0;
#pragma unroll
        for (int u = 1; u < RS_TP_MAX; u++)
            s += (u < sh.tp) & (k >= (IT)u * nloc);
        return sh.p[s] + (size_t)(k - (IT)s * nloc) * Layout<IT>::TW;
    }
}

// A lane's shared memory, byte offsets of each array (16-byte aligned):
// C [17], D [(Lmax + 1) * 2], D_seed [DS * 2], the two exact-completion
// lists [2][XC][L, U] (IT each), the bucket heads [NB] (int32), the read's
// codes [Lmax] (int8), and, on the int32 layout when a read has at most
// RS_PAR_MAX frames, each frame's parent node [NFRAME] (int32; npar frames,
// else none: an int64 lane is twice as large, and with the parents fewer of
// its blocks would fit an SM).  engine/kernel.py:lane_smem_bytes mirrors it.
struct LaneSmem {
    size_t carr, D, Ds, xl, head, rc, par, bytes;
    int npar;
    __host__ __device__ static size_t up16(size_t x) {
        return (x + 15) & ~(size_t)15;
    }
    __host__ __device__ LaneSmem(int NB, int Lmax, int DS, int XC, int it,
                                 int NFRAME) {
        size_t o = 0;
        carr = o; o += up16(17 * (size_t)it);
        D = o;    o += up16((size_t)(Lmax + 1) * 2 * it);
        Ds = o;   o += up16((size_t)DS * 2 * it);
        xl = o;   o += up16((size_t)4 * XC * it);
        head = o; o += up16((size_t)NB * 4);
        rc = o;   o += up16((size_t)Lmax);
        npar = it == 4 && NFRAME <= RS_PAR_MAX ? NFRAME : 0;
        par = o;  o += up16((size_t)npar * 4);
        bytes = o;
    }
};

// ---- alphabet tables, derived from the Gray-code definition (constants.py)
__host__ __device__ constexpr int gray_val(int j) { return j ^ (j >> 1); }
__host__ __device__ constexpr int popc4(int m) {
    return (m & 1) + ((m >> 1) & 1) + ((m >> 2) & 1) + ((m >> 3) & 1);
}
// three-base codes get no in-block counts in the DFS rank (quirk Q1) and
// are never expanded
__host__ __device__ constexpr bool is_skipped(int j) {
    return popc4(gray_val(j)) == 3;
}
__host__ __device__ constexpr bool is_snp(int j) {
    return popc4(gray_val(j)) >= 2;
}
__host__ __device__ constexpr bool is_order_n(int j) {
    return gray_val(j) == 15;
}
// nt4 base (A=0, G=1, C=2, T=3) -> bitmask (A=8, C=4, G=2, T=1)
__host__ __device__ constexpr int base_mask(int c) {
    return c == 0 ? 8 : (c == 1 ? 2 : (c == 2 ? 4 : 1));
}
// nt4 base -> the code of the pure base (constants.py NT4_GRAY)
__host__ __device__ constexpr int pure_code(int c) {
    int r = 0;
    for (int j = 1; j < 16; j++)
        if (gray_val(j) == base_mask(c)) r = j;
    return r;
}

// The alphabet a node expands over, in slot order, and the frame row of an
// index layout with NW words a node.
template <bool MULTI, int NW = 4>
struct Alpha {
    static constexpr int NC = MULTI ? 11 : 4;     // expanded codes
    static constexpr int NSLOT = 1 + 2 * NC;      // insertion, dels, matches
    // int32 words a frame row: NSLOT * NW + 1, padded to a multiple of 4
    // (the int32 layout keeps its 128 and 40)
    static constexpr int ROWW =
        NW == 4 ? (MULTI ? 128 : 40) : (NSLOT * NW + 1 + 3) / 4 * 4;
    static constexpr int PARENT = NSLOT * NW;     // word of the parent id
    // the t-th code: the non-skipped IUPAC codes in increasing order, or
    // the pure bases A, G, C, T
    __host__ __device__ static constexpr int code(int t) {
        if (!MULTI) return pure_code(t);
        int n = 0, r = 0;
        for (int j = 1; j < 16; j++)
            if (!is_skipped(j)) { if (n == t) r = j; n++; }
        return r;
    }
    // code(t) for every t, 4 bits each
    __host__ __device__ static constexpr uint64_t codes() {
        uint64_t r = 0;
        for (int t = 0; t < NC; t++) r |= (uint64_t)code(t) << (4 * t);
        return r;
    }
    // the codes an exact-completion step over base c keeps: those that
    // contain the base (N excluded); within a single genome the pure base
    // alone, so the list keeps one interval
    __host__ __device__ static constexpr uint32_t need(int c) {
        uint32_t m = 0;
        for (int q = 1; q < 16; q++)
            if ((gray_val(q) & base_mask(c)) && !is_order_n(q)
                    && (MULTI || gray_val(q) == base_mask(c)))
                m |= 1u << q;
        return m;
    }
};

__device__ __forceinline__ uint32_t pack1(int i, int mm, int go, int ge,
                                          int st, int plen) {
    return (uint32_t)i | ((uint32_t)mm << 8) | ((uint32_t)go << 13)
         | ((uint32_t)ge << 16) | ((uint32_t)st << 20)
         | ((uint32_t)plen << 22);
}

template <typename IT>
__device__ __forceinline__ int in_table(IT i, IT LEN) {
    return (i >= 0 && i != LEN - 1) ? 1 : 0;
}

// warp-wide wrapping sum of an unsigned value
template <typename UT>
__device__ __forceinline__ UT warp_sum(UT v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(RS_FULL, v, o);
    return v;
}

// A rank's table row (engine/rank.py:_rank_all), split from the count so
// that the loads can be issued early and their latency overlapped with
// other work: `edge` 1 for i == LEN - 1, 2 for i < 0 (no row is read),
// else 0 with the 16 plane words, code j's checkpoint count and the offset
// in the block.  Every thread of a half-warp that asks for the same i reads
// the same 64 plane bytes (one request) and its own count word.
template <typename IT>
struct Row {
    int4 p0, p1, p2, p3;
    IT ck;
    int off, edge;
};

template <typename IT, bool TP>
__device__ __forceinline__ Row<IT> load_row(const int32_t* __restrict__ table,
                                            const Shards& sh, IT LEN, IT i,
                                            int j) {
    Row<IT> r;
    const IT len_m1 = LEN - 1;
    r.edge = i == len_m1 ? 1 : (i < 0 ? 2 : 0);
    if (r.edge) return r;
    const IT hi = len_m1 - 1 > 0 ? len_m1 - 1 : 0;
    const IT ic = i < hi ? i : hi;
    const int32_t* row = row_addr<IT, TP>(table, sh, ic);
    r.off = (int)(ic & 127);
    const int4* r4 = reinterpret_cast<const int4*>(row);
    r.p0 = __ldg(r4); r.p1 = __ldg(r4 + 1); r.p2 = __ldg(r4 + 2);
    r.p3 = __ldg(r4 + 3);
    if constexpr (Layout<IT>::X64)
        r.ck = ((IT)__ldg(row + 32 + j) << 32) | (uint32_t)__ldg(row + 16 + j);
    else
        r.ck = __ldg(row + 16 + j);
    return r;
}

// C[j] + O(j, off) + inc of code j from a row's 16 plane words and its
// checkpoint count.  DFS = the inexact-search variant: skipped codes take C
// + inc - first_dec without in-block counts (quirk Q1).
template <bool DFS, typename IT>
__device__ __forceinline__ IT count_code(int4 p0, int4 p1, int4 p2, int4 p3,
                                         IT ck, int off, const IT* carr,
                                         int inc, int j) {
    const int first = (p0.x & 1) | ((p1.x & 1) << 1) | ((p2.x & 1) << 2)
                    | ((p3.x & 1) << 3);
    const IT val = carr[j] + inc - (first == j ? 1 : 0);
    if (DFS && is_skipped(j)) return val;
    // plane t's word, or its complement where bit t of j is clear
    const uint32_t s0 = (j & 1) ? 0u : RS_FULL, s1 = (j & 2) ? 0u : RS_FULL,
                   s2 = (j & 4) ? 0u : RS_FULL, s3 = (j & 8) ? 0u : RS_FULL;
    auto word = [&](uint32_t a, uint32_t b, uint32_t c, uint32_t d, int w) {
        const int nbits = off + 1 - 32 * w;
        const uint32_t m = nbits >= 32 ? RS_FULL
                         : (nbits <= 0 ? 0u : ((1u << nbits) - 1u));
        return __popc(m & (a ^ s0) & (b ^ s1) & (c ^ s2) & (d ^ s3));
    };
    const int cnt = word(p0.x, p1.x, p2.x, p3.x, 0)
                  + word(p0.y, p1.y, p2.y, p3.y, 1)
                  + word(p0.z, p1.z, p2.z, p3.z, 2)
                  + word(p0.w, p1.w, p2.w, p3.w, 3);
    return val + ck + cnt;
}

// Occurrence bound C[j] + O(j, i) + inc of code j from its row (load_row);
// 0 for j == 0.
template <bool DFS, typename IT>
__device__ __forceinline__ IT count_row(const Row<IT>& r, const IT* carr,
                                        int inc, int j) {
    if (j == 0) return 0;
    if (r.edge == 1) return carr[j + 1] + inc;
    if (r.edge == 2) return carr[j] + inc;
    return count_code<DFS>(r.p0, r.p1, r.p2, r.p3, r.ck, r.off, carr, inc,
                           j);
}

// The same bound, its row read right here: an exact-completion item ranks
// its two ends one after the other, which keeps the kernel's registers
// down.
template <bool DFS, bool TP, typename IT>
__device__ __forceinline__ IT rank_one(const int32_t* __restrict__ table,
                                       const Shards& sh, const IT* carr,
                                       IT LEN, IT i, int inc, int j) {
    const IT len_m1 = LEN - 1;
    if (j == 0) return 0;
    if (i == len_m1) return carr[j + 1] + inc;
    if (i < 0) return carr[j] + inc;
    const IT hi = len_m1 - 1 > 0 ? len_m1 - 1 : 0;
    const IT ic = i < hi ? i : hi;
    const int32_t* row = row_addr<IT, TP>(table, sh, ic);
    const int4* r4 = reinterpret_cast<const int4*>(row);
    IT ck;
    if constexpr (Layout<IT>::X64)
        ck = ((IT)__ldg(row + 32 + j) << 32) | (uint32_t)__ldg(row + 16 + j);
    else
        ck = __ldg(row + 16 + j);
    return count_code<DFS>(__ldg(r4), __ldg(r4 + 1), __ldg(r4 + 2),
                           __ldg(r4 + 3), ck, (int)(ic & 127), carr, inc, j);
}

// Per-read search state that emission updates (the same in every thread).
template <typename IT>
struct ReadState {
    int n_alns, overflow, best_score, max_diff;
    IT num_best;
};

// emit_alns of engine/inexact.py (inexact_match.c:331-375 and
// add_alignment's gap dedup, align.c:271-298) for `cnt` intervals read
// through get(s, L, U), the same for every thread.  The intervals are
// emitted in order; each one's duplicate check is spread over the threads
// (thread t takes earlier alignments t, t + 32, ...), and its seven fields
// are written by threads 0-6.  Returns true when the read is finished
// (max_best stop or ACAP overflow).
template <typename IT, typename GetLU>
__device__ __forceinline__ bool emit_alns(const RSParams& P, ReadState<IT>& S,
                                          IT* oA, int node, uint32_t m1,
                                          uint32_t m2, int cnt, int extra_m,
                                          int t, GetLU get) {
    const int mm = (m1 >> 8) & 0x1F, go = (m1 >> 13) & 0x7,
              ge = (m1 >> 16) & 0xF, plen = (m1 >> 22) & 0x1FF;
    const int snp = m2 & 0xFF;
    const int score = mm * P.p_mm + go * P.p_go + ge * P.p_ge;
    if (S.n_alns == 0) {
        S.best_score = score;
        int nb = mm + go + ge + 1;
        S.max_diff = nb < P.p_maxdiff ? nb : P.p_maxdiff;
    }
    // wrapping sums in the index's type (int32 wraps as the JAX package's
    // int32 sum does)
    typedef typename std::make_unsigned<IT>::type UT;
    UT width = 0;
    for (int s = t; s < cnt; s += RS_WARP) {
        IT L, U;
        get(s, L, U);
        width += (UT)(U - L + 1);
    }
    width = warp_sum(width);
    const bool is_best = score == S.best_score;
    const IT old_nb = S.num_best;
    if (is_best) S.num_best = (IT)((UT)S.num_best + width);
    if (!is_best && old_nb > P.p_maxbest) return true;   // stop this read
    const int A = P.ACAP;
    for (int s = 0; s < cnt; s++) {
        IT L, U;
        get(s, L, U);
        if (go > 0) {
            bool dup = false;
            for (int k = t; k < S.n_alns; k += RS_WARP)
                dup |= (oA[k] == L) & (oA[A + k] == U);
            if (__any_sync(RS_FULL, dup)) continue;
        }
        if (S.n_alns >= A) { S.overflow |= OV_ACAP; return true; }
        const int k = S.n_alns++;
        if (t < 7) {
            const IT v = t == 0 ? L : t == 1 ? U : t == 2 ? (IT)score
                       : t == 3 ? (IT)(plen + extra_m) : t == 4 ? (IT)node
                       : t == 5 ? (IT)(int)m1 : (IT)snp;
            oA[t * A + k] = v;
        }
        __syncwarp();
    }
    return false;
}

template <bool MULTI, bool FIXED, typename IT, bool TP>
__global__ void __launch_bounds__(RS_WARP)
ring_search_kernel(
        RSParams P, const int32_t* __restrict__ table,
        const __grid_constant__ Shards sh,
        const IT* __restrict__ carr_g, const int8_t* __restrict__ rc,
        const int32_t* __restrict__ lens, const IT* __restrict__ D,
        const IT* __restrict__ Ds, const IT* __restrict__ seed_L,
        const IT* __restrict__ seed_U,
        const int32_t* __restrict__ seed_cnt, int32_t* __restrict__ arena,
        int32_t* counter, IT* __restrict__ q_alns,
        int32_t* __restrict__ q_meta, uint8_t* __restrict__ q_paths) {
    typedef Layout<IT> LY;
    typedef Alpha<MULTI, LY::NW> AL;
    constexpr int ROWW = AL::ROWW, NSLOT = AL::NSLOT, NC = AL::NC,
                  NW = LY::NW;
    constexpr uint64_t CODES = AL::codes();
    constexpr uint32_t NEED0 = AL::need(0), NEED1 = AL::need(1),
                       NEED2 = AL::need(2), NEED3 = AL::need(3);

    const int t = threadIdx.x;
    const int lane = blockIdx.x;

    extern __shared__ __align__(16) unsigned char smem_raw[];
    const LaneSmem SL(P.NB, P.Lmax, P.DS, P.XC, (int)sizeof(IT), P.NFRAME);
    unsigned char* const sm = smem_raw;
    IT* const carr = reinterpret_cast<IT*>(sm + SL.carr);
    IT* const sD = reinterpret_cast<IT*>(sm + SL.D);
    IT* const sDs = reinterpret_cast<IT*>(sm + SL.Ds);
    IT* const sX = reinterpret_cast<IT*>(sm + SL.xl);     // [2][XC][L,U]
    int* const head = reinterpret_cast<int*>(sm + SL.head);
    int8_t* const sRc = reinterpret_cast<int8_t*>(sm + SL.rc);
    // the parents of the read's frames, beside the arena's parent words,
    // for the path walk (null: the walk reads the arena)
    int* const sPar = SL.npar ? reinterpret_cast<int*>(sm + SL.par) : nullptr;
    if (t < 17) carr[t] = carr_g[t];

    int32_t* const A = arena + (size_t)lane * P.NFRAME * ROWW;
    const int NB = P.NB, Lmax = P.Lmax, NROOT = P.NROOT, DS = P.DS;
    const IT LEN = LY::length(P);
    const bool seeded = seed_cnt != nullptr;

    int rid = lane;
    if (!FIXED) {
        int r = 0;
        if (t == 0) r = atomicAdd(counter, 1);
        rid = __shfl_sync(RS_FULL, r, 0);
    }
    while (rid < P.Q) {
        __syncwarp();                 // the last read's shared state is done
        const int rlen = lens[rid];
        IT* oA = q_alns + (size_t)rid * 7 * P.ACAP;

        // stage the read's codes, D and D_seed rows; count its Ns
        // (inexact_match.c:259-266)
        int nN = 0;
        {
            const int8_t* rcr = rc + (size_t)rid * Lmax;
            for (int p = t; p < Lmax; p += RS_WARP) {
                const int8_t v = rcr[p];
                sRc[p] = v;
                nN += (p < rlen) & (v > 3);
            }
            const IT* Dr = D + (size_t)rid * (Lmax + 1) * 2;
            for (int p = t; p < (Lmax + 1) * 2; p += RS_WARP) sD[p] = Dr[p];
            const IT* Dsr = Ds + (size_t)rid * DS * 2;
            for (int p = t; p < DS * 2; p += RS_WARP) sDs[p] = Dsr[p];
        }
        const int n_count = __reduce_add_sync(RS_FULL, nN);

        ReadState<IT> S;
        S.n_alns = 0; S.overflow = 0; S.best_score = NB;
        S.max_diff = P.p_maxdiff; S.num_best = 0;
        int work = 0, rank_rows = 0, frame_rd = 0, frame_wr = 0, pf = 0,
            root_rd = 0;
        bool alive = n_count <= P.p_maxdiff;

        // the roots: one, or the read's seed rows chained last-first in
        // bucket 0 (a count above NROOT counts as NROOT)
        int n_open = 1, minb = 0;
        if (seeded) {
            const int scnt = seed_cnt[rid];
            n_open = scnt < 0 ? 0 : (scnt > NROOT ? NROOT : scnt);
            alive = alive && n_open > 0;       // no seed hit
        }
        if (alive)
            for (int b = t; b < NB; b += RS_WARP)
                head[b] = b == 0 ? n_open - 1 : -1;
        __syncwarp();

        // the frame whose slots the threads hold (thread s: slot s)
        int regf = -1;
        IT rL = 0, rU = 0;
        uint32_t rm1 = 0, rm2 = 0;

        while (alive) {
            if (!FIXED) {
                // ring budget: NFRAME of the read's own pops
                if (pf >= P.NFRAME) { S.overflow |= OV_FRAMES; break; }
                if (work >= P.max_iters) { S.overflow |= OV_WORK; break; }
            }
            if (n_open == 0 || n_open > P.p_maxentries) break;
            // fixed rule: the work bound binds at an attempted pop
            if (FIXED && work >= P.max_iters) {
                S.overflow |= OV_WORK;
                break;
            }
            // pop: lowest occupied bucket (32 heads a ballot), most recent
            // push (heap_pop)
            int node = -1;
            while (minb < NB) {
                const int b = minb + t;
                const int h = b < NB ? head[b] : -1;
                const unsigned occ = __ballot_sync(RS_FULL, h >= 0);
                if (occ) {
                    const int f = __ffs(occ) - 1;
                    node = __shfl_sync(RS_FULL, h, f);
                    minb += f;
                    break;
                }
                minb += RS_WARP;
            }
            if (node < 0) break;
            const int bucket = minb;
            IT eL, eU;
            uint32_t m1, m2;
            if (node < NROOT && seeded) {
                const size_t r = (size_t)rid * NROOT + node;
                eL = seed_L[r]; eU = seed_U[r];
                m1 = pack1(rlen - P.PK, 0, 0, 0, STATE_M, P.PK);
                m2 = (uint32_t)node << 8;      // link to root node - 1
                root_rd++;
            } else if (node < NROOT) {
                eL = 0; eU = LEN - 1;
                m1 = pack1(rlen, 0, 0, 0, STATE_M, 0);
                m2 = 0;
            } else {
                const int nn = node - NROOT;
                const int f = nn / NSLOT, s = nn - f * NSLOT;
                if (f == regf) {
                    // formed by thread s at the frame's expansion
                    eL = __shfl_sync(RS_FULL, rL, s);
                    eU = __shfl_sync(RS_FULL, rU, s);
                    m1 = __shfl_sync(RS_FULL, rm1, s);
                    m2 = __shfl_sync(RS_FULL, rm2, s);
                } else {
                    const int32_t* sp = A + (size_t)f * ROWW + NW * s;
                    if constexpr (LY::X64) {
                        eL = *reinterpret_cast<const long long*>(sp);
                        eU = *reinterpret_cast<const long long*>(sp + 2);
                        const int2 mm = *reinterpret_cast<const int2*>(sp + 4);
                        m1 = (uint32_t)mm.x; m2 = (uint32_t)mm.y;
                    } else {
                        const int4 v = *reinterpret_cast<const int4*>(sp);
                        eL = v.x; eU = v.y; m1 = (uint32_t)v.z;
                        m2 = (uint32_t)v.w;
                    }
                }
                frame_rd++;
            }
            // the rows an expansion of this node ranks at, asked for now so
            // that the fetch overlaps the pop's bookkeeping and its prune,
            // allow and slot decisions: half 0 the row of eL - 1, half 1
            // that of eU; thread j of a half forms code j's bound (unused
            // when the pop does not expand)
            const int half = t >> 4, jc = t & 15;
            const Row<IT> row = load_row<IT, TP>(table, sh, LEN,
                                                 half ? eU : eL - 1, jc);
            if (t == 0)
                head[bucket] = (int)((m2 >> 8) & 0xFFFFFFu) - 1;  // 24-bit link
            __syncwarp();
            n_open--;
            work++;
            if (bucket > S.best_score + P.p_mm) break;         // stop
            // fixed rule: a pop past the stop check after NFRAME pops
            if (FIXED && pf >= P.NFRAME) { S.overflow |= OV_FRAMES; break; }

            // this pop owns frame `pf` whether or not it pushes anything
            const int myf = pf;
            const int base = NROOT + pf * NSLOT;
            pf++;

            const int ei = m1 & 0xFF, emm = (m1 >> 8) & 0x1F,
                      ego = (m1 >> 13) & 0x7, ege = (m1 >> 16) & 0xF,
                      est = (m1 >> 20) & 0x3, eplen = (m1 >> 22) & 0x1FF;
            const int esnp = m2 & 0xFF;

            // prune chain (inexact_match.c:309-328)
            const int diff_left = S.max_diff - emm - ego - ege;
            auto dclip = [&](int x) { return x < 0 ? 0 : (x > Lmax ? Lmax : x); };
            auto sclip = [&](int x) {
                return x < 0 ? 0 : (x > DS - 1 ? DS - 1 : x);
            };
            const IT D1n = sD[dclip(ei - 1) * 2];
            const int dls = P.p_maxdiffseed - emm - ego - ege;
            const int seed_index = ei - (rlen - P.p_seedlen);
            const IT S1n = sDs[sclip(seed_index - 1) * 2];
            bool cont = diff_left < 0;
            cont |= (ei > 0) && (diff_left < D1n);
            cont |= (seed_index > 0) && (dls < S1n);
            if (cont) continue;

            // hit at i == 0 (inexact_match.c:332-344)
            if (ei == 0) {
                const bool fin = emit_alns(P, S, oA, node, m1, m2, 1, 0, t,
                                           [&](int, IT& L, IT& U) {
                                               L = eL; U = eU;
                                           });
                if (fin) break;
                continue;
            }

            // exact completion when the budget is exhausted (:345-375):
            // exact_match_bounded with add_sa_interval merging at list
            // capacity XC
            if (diff_left == 0) {
                // ring rule: a read still searching right after its
                // NFRAME-th pop is over budget, whatever the scan would find
                if (!FIXED && pf >= P.NFRAME) {
                    S.overflow |= OV_FRAMES;
                    break;
                }
                IT* cur = sX;
                IT* nxt = sX + 2 * P.XC;
                if (t == 0) { cur[0] = eL; cur[1] = eU; }
                __syncwarp();
                int cnt = 1;
                int over = 0;
                for (int j = ei - 1; j >= 0 && cnt > 0; j--) {
                    if (work >= P.max_iters) { over = OV_WORK; break; }
                    work++;
                    const int c = sRc[j < Lmax ? j : Lmax - 1];
                    if (c > 3) { cnt = 0; break; }
                    // rank rows of every interval of the list
                    int rr = 0;
                    for (int e = t; e < cnt; e += RS_WARP)
                        rr += in_table<IT>(cur[2 * e] - 1, LEN)
                            + in_table<IT>(cur[2 * e + 1], LEN);
                    rank_rows += __reduce_add_sync(RS_FULL, rr);
                    const uint32_t need = c == 0 ? NEED0 : c == 1 ? NEED1
                                        : c == 2 ? NEED2 : NEED3;
                    const int nq = __popc(need);
                    // items (interval e, the qi-th code of `need`) in
                    // order, 32 a round, one a thread; a run of the output
                    // list starts at an item unless it follows the previous
                    // non-empty item's U directly
                    const int items = cnt * nq;
                    int ncnt = 0;
                    bool has_tail = false;
                    IT tailU = 0;
                    for (int k0 = 0; k0 < items; k0 += RS_WARP) {
                        const int k = k0 + t;
                        IT L = 0, U = -1;
                        if (k < items) {
                            const int e = k / nq;
                            uint32_t mq = need;
                            for (int z = k - e * nq; z > 0; z--) mq &= mq - 1;
                            const int q = __ffs(mq) - 1;
                            L = rank_one<false, TP>(table, sh, carr, LEN,
                                                    cur[2 * e] - 1, 1, q);
                            U = rank_one<false, TP>(table, sh, carr, LEN,
                                                    cur[2 * e + 1], 0, q);
                        }
                        const bool ne_ = k < items && L <= U;
                        const unsigned ne = __ballot_sync(RS_FULL, ne_);
                        const unsigned lower = ne & ((1u << t) - 1u);
                        const IT pU = __shfl_sync(
                            RS_FULL, U, lower ? 31 - __clz(lower) : t);
                        const bool joins = (lower != 0 || has_tail)
                                           && L == (lower ? pU : tailU) + 1;
                        const bool start = ne_ && !joins;
                        const unsigned st = __ballot_sync(RS_FULL, start);
                        if (ncnt + __popc(st) > P.XC) { over = OV_LIST; break; }
                        // the run this item belongs to; it ends here if the
                        // next non-empty item of the round starts a run or
                        // there is none (then a later round may extend it)
                        const int ridx = ncnt + __popc(st & ((2u << t) - 1u)) - 1;
                        const unsigned higher = ne & ~((2u << t) - 1u);
                        const bool end = ne_ && (higher == 0
                            || ((st >> (__ffs(higher) - 1)) & 1u));
                        if (start) nxt[2 * ridx] = L;
                        if (end) nxt[2 * ridx + 1] = U;
                        if (ne) {
                            tailU = __shfl_sync(RS_FULL, U, 31 - __clz(ne));
                            has_tail = true;
                        }
                        ncnt += __popc(st);
                        __syncwarp();
                    }
                    if (over) break;
                    IT* tmp = cur; cur = nxt; nxt = tmp;
                    cnt = ncnt;
                }
                if (over) { S.overflow |= over; break; }
                if (cnt > 0) {
                    // the scan consumed ei chars: the path extends by ei
                    // implicit matches (inexact_match.c:365)
                    const IT* lst = cur;
                    const bool fin = emit_alns(P, S, oA, node, m1, m2, cnt, ei,
                                               t, [&](int s, IT& L, IT& U) {
                                                   L = lst[2 * s];
                                                   U = lst[2 * s + 1];
                                               });
                    if (fin) break;
                }
                continue;
            }

            // expansion (inexact_match.c:377-504)
            if (eplen + 1 >= P.PATHCAP) { S.overflow |= OV_PATH; break; }
            const int nplen = eplen + 1;
            rank_rows += in_table<IT>(eL - 1, LEN) + in_table<IT>(eU, LEN);

            const IT D2n = sD[dclip(ei - 2) * 2];
            const IT D1w = sD[dclip(ei - 1) * 2 + 1];
            const IT D2w = sD[dclip(ei - 2) * 2 + 1];
            const IT S2n = sDs[sclip(seed_index - 2) * 2];
            const IT S1w = sDs[sclip(seed_index - 1) * 2 + 1];
            const IT S2w = sDs[sclip(seed_index - 2) * 2 + 1];
            bool allow_diff = true, allow_mm = true;
            const bool pm = ei - 1 > 0;
            const bool ad1 = diff_left - 1 < D2n;
            const bool am1 = (D1n == diff_left - 1) && (D2n == diff_left - 1)
                             && (D1w == D2w);
            if (pm && ad1) allow_diff = false;
            if (pm && !ad1 && am1) allow_mm = false;
            const bool ps = seed_index - 1 > 0;
            const bool ad2 = dls - 1 < S2n;
            const bool am2 = (S1n == dls - 1) && (S2n == dls - 1)
                             && (S1w == S2w);
            if (ps && ad2) allow_diff = false;
            if (ps && !ad2 && am2) allow_mm = false;

            const int tmp = ego + ege;
            bool allow_indels = !(((ei - 1) < (P.p_noindel + tmp))
                                  || ((rlen - (ei - 1)) < (P.p_noindel + tmp)));
            allow_indels = allow_indels
                && !((ego >= P.p_maxgapo) && (ege >= P.p_maxgape));
            const bool allow_open = ego < P.p_maxgapo;
            const bool allow_extend = ege < P.p_maxgape;

            int c = sRc[(ei - 1) < Lmax ? (ei - 1) : Lmax - 1];
            c = c < 0 ? 0 : (c > 4 ? 4 : c);
            const bool is_I = est == STATE_I, is_M = est == STATE_M;
            const bool ind_ok = allow_diff && allow_indels;
            // the bounds from the rows asked for at the pop (the DFS rank
            // differs from the exact one on skipped codes only, and a
            // single genome expands none)
            const IT rk = count_row<MULTI>(row, carr, half ? 0 : 1, jc);

            // thread s forms slot s: 0 the insertion, 1..NC the deletions,
            // NC+1..2NC the match / mismatch pushes over code q = code(s -
            // 1) or code(s - 1 - NC), whose bounds threads q and 16 + q hold
            const int tc = t <= NC ? t - 1 : t - 1 - NC;
            const int q = (t >= 1 && t < NSLOT)
                        ? (int)((CODES >> (4 * tc)) & 15) : 0;
            const IT Lq = __shfl_sync(RS_FULL, rk, q);
            const IT Uq = __shfl_sync(RS_FULL, rk, 16 + q);
            bool valid = false;
            IT sL = eL, sU = eU;
            uint32_t sm1 = 0;
            int ssnp = esnp;
            if (t == 0) {
                // insertion (extend if state == I else open if M)
                valid = ind_ok && ((is_I && allow_extend)
                                   || (is_M && allow_open));
                sm1 = pack1(ei - 1, emm, ego + (is_M ? 1 : 0),
                            ege + (is_I ? 1 : 0), STATE_I, nplen);
            } else if (t <= NC) {
                // deletion: consumes a reference char, keeps i
                const bool del_any = ind_ok && !is_I
                    && ((is_M && allow_open) || (!is_M && allow_extend));
                valid = del_any && Lq <= Uq;
                sL = Lq; sU = Uq;
                sm1 = pack1(ei, emm, ego + (is_M ? 1 : 0),
                            ege + (is_M ? 0 : 1), STATE_D, nplen);
            } else if (t < NSLOT) {
                // match / mismatch (or the exact-only continuation when
                // mismatches are suppressed)
                const bool mm_branch = allow_diff && allow_mm;
                const int bm = c <= 3 ? base_mask(c) : 0;
                const bool nonempty = Lq <= Uq;
                const bool is_match = (c <= 3) && !is_order_n(q)
                                      && ((gray_val(q) & bm) != 0);
                const bool ok_mm = mm_branch && nonempty;
                const bool ok_ex = !mm_branch && (c < 4) && is_match
                                   && nonempty;
                valid = ok_mm || ok_ex;
                sL = Lq; sU = Uq;
                sm1 = pack1(ei - 1, emm + ((ok_mm && !is_match) ? 1 : 0),
                            ego, ege, STATE_M, nplen);
                ssnp = (esnp + (is_snp(q) ? 1 : 0)) & 0xFF;
            }
            const int sc = ((sm1 >> 8) & 0x1F) * P.p_mm
                         + ((sm1 >> 13) & 0x7) * P.p_go
                         + ((sm1 >> 16) & 0xF) * P.p_ge;
            const int b = sc < 0 ? 0 : (sc > NB - 1 ? NB - 1 : sc);

            // the sequential LIFO push of slots 0..NSLOT-1 into the score
            // buckets (inexact_match.c:510-610), all slots at once: a slot
            // links to the highest earlier valid slot of its bucket, else
            // to the bucket's old head; the last valid slot of a bucket
            // becomes its head
            const unsigned vmask = __ballot_sync(RS_FULL, valid);
            const unsigned grp = __match_any_sync(RS_FULL, valid ? b : -1)
                               & vmask;
            const int oldh = valid ? head[b] : 0;
            __syncwarp();
            const unsigned below = grp & ((1u << t) - 1u);
            const int prev = below ? base + (31 - __clz(below)) : oldh;
            const uint32_t sm2 = ((uint32_t)ssnp & 0xFFu)
                               | ((uint32_t)(prev + 1) << 8);
            if (valid && (grp >> t) == 1u) head[b] = base + t;
            const int bmin = (int)__reduce_min_sync(
                RS_FULL, valid ? (unsigned)b : (unsigned)INT_MAX);
            if (bmin < minb) minb = bmin;
            const int total = __popc(vmask);
            if (total > 0) {
                int32_t* frow = A + (size_t)myf * ROWW;
                if (valid) {
                    if constexpr (LY::X64) {
                        int32_t* sp = frow + NW * t;
                        *reinterpret_cast<long long*>(sp) = sL;
                        *reinterpret_cast<long long*>(sp + 2) = sU;
                        *reinterpret_cast<int2*>(sp + 4) =
                            make_int2((int)sm1, (int)sm2);
                    } else {
                        *reinterpret_cast<int4*>(frow + 4 * t) =
                            make_int4(sL, sU, (int)sm1, (int)sm2);
                    }
                }
                if (t == NSLOT) {
                    frow[AL::PARENT] = node;
                    if (sPar) sPar[myf] = node;
                }
                frame_wr++;
                n_open += total;
                regf = myf;
                rL = sL; rU = sU; rm1 = sm1; rm2 = sm2;
            }
            __syncwarp();
        }

        // ring mode: the lane's next read id, asked for now so that the
        // atomic's latency overlaps the walk
        int nrid = 0;
        if (!FIXED && t == 0) nrid = atomicAdd(counter, 1);

        // walk the parent chains of the reported alignments (the flush-time
        // walk of switch_step), one alignment a thread: entry s is the state
        // of the s-th ancestor, node first, root excluded; 2 bits per state
        int frd = 0;
        if (!S.overflow) {
            for (int k = t; k < S.n_alns; k += RS_WARP) {
                uint8_t* pp = q_paths + ((size_t)rid * P.ACAP + k) * P.PW;
                int cur = (int)oA[4 * P.ACAP + k];
                int s = 0;
                uint32_t acc = 0;
                while (s < P.PATHCAP && cur >= NROOT) {
                    const int nn = cur - NROOT;
                    const int f = nn / NSLOT, sl = nn - f * NSLOT;
                    const int st = sl == 0 ? STATE_I
                                           : (sl <= NC ? STATE_D : STATE_M);
                    acc |= (uint32_t)st << (2 * (s & 3));
                    if ((s & 3) == 3) { pp[s >> 2] = (uint8_t)acc; acc = 0; }
                    cur = sPar ? sPar[f] : A[(size_t)f * ROWW + AL::PARENT];
                    frd++;
                    s++;
                }
                if (s & 3) pp[s >> 2] = (uint8_t)acc;
            }
        }
        frame_rd += __reduce_add_sync(RS_FULL, frd);

        if (t == 0) {
            int32_t* qm = q_meta + (size_t)rid * RS_NMETA;
            qm[0] = S.n_alns; qm[1] = S.overflow; qm[2] = lane; qm[3] = work;
            qm[4] = rank_rows; qm[5] = frame_rd; qm[6] = frame_wr; qm[7] = pf;
            qm[8] = root_rd;
        }
        if (FIXED) break;
        rid = __shfl_sync(RS_FULL, nrid, 0);
    }
}

extern "C" int ring_search_num_params() {
    return (int)(sizeof(RSParams) / sizeof(int));
}

extern "C" int ring_search_num_meta() { return RS_NMETA; }

// Shared-memory bytes of one lane (engine/kernel.py:lane_smem_bytes).
extern "C" long long ring_search_lane_smem(int NB, int Lmax, int DS, int XC,
                                           int x64, int NFRAME) {
    return (long long)LaneSmem(NB, Lmax, DS, XC, x64 ? 8 : 4, NFRAME).bytes;
}

template <bool MULTI, bool FIXED, typename IT, bool TP>
static int launch(const RSParams& P, size_t smem, const Shards& sh,
                  const void* carr, const void* rc, const void* lens,
                  const void* D, const void* Ds, const void* sL,
                  const void* sU, const void* scnt, void* arena,
                  void* counter, void* q_alns, void* q_meta, void* q_paths,
                  void* stream, void* ev0, void* ev1) {
    auto kern = ring_search_kernel<MULTI, FIXED, IT, TP>;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    // the launch's own events, recorded right around it on its stream
    if (ev0) {
        cudaError_t e = cudaEventRecord((cudaEvent_t)ev0, (cudaStream_t)stream);
        if (e != cudaSuccess) return (int)e;
    }
    kern<<<P.lanes, RS_WARP, smem, (cudaStream_t)stream>>>(
        P, sh.p[0], sh, (const IT*)carr, (const int8_t*)rc,
        (const int32_t*)lens, (const IT*)D, (const IT*)Ds,
        (const IT*)sL, (const IT*)sU, (const int32_t*)scnt,
        (int32_t*)arena, (int32_t*)counter,
        (IT*)q_alns, (int32_t*)q_meta, (uint8_t*)q_paths);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess || !ev1) return (int)e;
    return (int)cudaEventRecord((cudaEvent_t)ev1, (cudaStream_t)stream);
}

// Blocks of an instantiation that an SM holds at once with `smem` bytes of
// dynamic shared memory a block (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
// or minus the CUDA error.
template <bool MULTI, bool FIXED, typename IT, bool TP = false>
static int occupancy(long long smem) {
    auto kern = ring_search_kernel<MULTI, FIXED, IT, TP>;
    cudaError_t e = cudaSuccess;
    if (smem > 48 * 1024)
        e = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    int n = 0;
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, RS_WARP,
                                                          (size_t)smem);
    return e == cudaSuccess ? n : -(int)e;
}

extern "C" int ring_search_occupancy(int multiref, int fixed, int x64,
                                     int sharded, long long smem) {
    if (sharded) {
        if (!fixed) return -1;
        if (x64)
            return multiref ? occupancy<true, true, long long, true>(smem)
                            : occupancy<false, true, long long, true>(smem);
        return multiref ? occupancy<true, true, int, true>(smem)
                        : occupancy<false, true, int, true>(smem);
    }
    if (x64)
        return multiref ? occupancy<true, true, long long>(smem)
                        : occupancy<false, true, long long>(smem);
    if (multiref)
        return fixed ? occupancy<true, true, int>(smem)
                     : occupancy<true, false, int>(smem);
    return fixed ? occupancy<false, true, int>(smem)
                 : occupancy<false, false, int>(smem);
}

// Frame-row width in int32 words for an alphabet and an index layout, for
// the wrapper's arena.
extern "C" int ring_search_row_words(int multiref, int x64) {
    if (x64)
        return multiref ? Alpha<true, 6>::ROWW : Alpha<false, 6>::ROWW;
    return multiref ? Alpha<true>::ROWW : Alpha<false>::ROWW;
}

// Launches on `stream`, one lane (one warp) a block, between the records of
// the CUDA events `ev0` and `ev1` on the same stream (either may be null: no
// record); returns the first CUDA error of the records and the launch (0 on
// success), or -1 when the parameter block does not match RSParams, a lane's
// shared memory exceeds the card's, a fixed launch has not one lane per
// read, the seeds are given in part or with NROOT < 1, the int64 layout or
// a sharded table is asked of a ring launch, or the shards are not 1 to
// RS_TP_MAX non-null tables of nloc rows that hold every block a rank reads.
// `multiref` picks the alphabet, `fixed` the launch mode (`counter` is not
// read then), `x64` the index layout (carr, D, Ds, the seed intervals and
// q_alns are int64 then, the table has 48 words a row); `shards` holds `tp`
// table pointers, each of `nloc` rows (tp = 1: the whole table; tp > 1:
// shard s holds blocks [s * nloc, (s + 1) * nloc), on the launching card or
// on a card it has peer access to); seed_L, seed_U and seed_cnt are all
// null (one unseeded root, NROOT = 1) or all given ([Q, NROOT], [Q, NROOT],
// [Q] int32).
extern "C" int ring_search_launch(
        const int* hp, int nhp, int multiref, int fixed, int x64,
        const void* const* shards, int tp, long long nloc, const void* carr,
        const void* rc, const void* lens, const void* D, const void* Ds,
        const void* seed_L, const void* seed_U, const void* seed_cnt,
        void* arena, void* counter, void* q_alns, void* q_meta,
        void* q_paths, void* stream, void* ev0, void* ev1) {
    if (nhp != (int)(sizeof(RSParams) / sizeof(int))) return -1;
    RSParams P;
    memcpy(&P, hp, sizeof(P));
    if (P.NB < 1 || P.Lmax < 1 || P.DS < 1 || P.XC < 0) return -1;
    const long long smem = ring_search_lane_smem(P.NB, P.Lmax, P.DS, P.XC,
                                                 x64, P.NFRAME);
    if (smem > RS_SMEM_MAX) return -1;
    if (fixed && P.lanes != P.Q) return -1;
    const int nseed = (seed_L != nullptr) + (seed_U != nullptr)
                    + (seed_cnt != nullptr);
    if (nseed == 1 || nseed == 2 || P.NROOT < 1 || (!nseed && P.NROOT != 1))
        return -1;
    if (!shards || tp < 1 || tp > RS_TP_MAX || nloc < 1 || (tp > 1 && !fixed)
            || (!x64 && nloc > INT_MAX / RS_TP_MAX))
        return -1;
    Shards sh = {};
    for (int s = 0; s < tp; s++) {
        if (!shards[s]) return -1;
        sh.p[s] = (const int32_t*)shards[s];
    }
    sh.nloc = nloc;
    sh.tp = tp;
    // the last block a rank reads: positions are clamped to length - 2
    const long long len = (long long)(((unsigned long long)(uint32_t)P.LEN_HI
                                       << 32) | (uint32_t)P.LEN);
    if (len >= 2 && ((len - 2) >> 7) >= nloc * tp) return -1;
#define RS_LAUNCH(M, F, T, S) launch<M, F, T, S>(                          \
        P, (size_t)smem, sh, carr, rc, lens, D, Ds, seed_L, seed_U,        \
        seed_cnt, arena, counter, q_alns, q_meta, q_paths, stream, ev0, ev1)
    if (x64) {
        if (!fixed) return -1;
        if (tp > 1)
            return multiref ? RS_LAUNCH(true, true, long long, true)
                            : RS_LAUNCH(false, true, long long, true);
        return multiref ? RS_LAUNCH(true, true, long long, false)
                        : RS_LAUNCH(false, true, long long, false);
    }
    if (tp > 1)
        return multiref ? RS_LAUNCH(true, true, int, true)
                        : RS_LAUNCH(false, true, int, true);
    if (multiref)
        return fixed ? RS_LAUNCH(true, true, int, false)
                     : RS_LAUNCH(true, false, int, false);
    return fixed ? RS_LAUNCH(false, true, int, false)
                 : RS_LAUNCH(false, false, int, false);
#undef RS_LAUNCH
}

// Lets kernels launched on card `dev` read the memory of card `peer` (a
// shard of a table), over NVLink.  Returns 0 when they may, also when the
// pair's access was already enabled (by an earlier call, or by PyTorch for
// its own copies), cudaErrorPeerAccessUnsupported when `dev` cannot reach
// `peer`, else the CUDA error of the query or the enable.  The error a call
// leaves is cleared, so that the next launch's cudaGetLastError does not
// report it, and the current device is left as it was.
extern "C" int ring_search_enable_peer(int dev, int peer) {
    int can = 0, cur = 0;
    cudaError_t e = cudaDeviceCanAccessPeer(&can, dev, peer);
    if (e == cudaSuccess && !can) e = cudaErrorPeerAccessUnsupported;
    if (e == cudaSuccess) e = cudaGetDevice(&cur);
    if (e == cudaSuccess) {
        e = cudaSetDevice(dev);
        if (e == cudaSuccess) {
            e = cudaDeviceEnablePeerAccess(peer, 0);
            if (e == cudaErrorPeerAccessAlreadyEnabled) e = cudaSuccess;
        }
        const cudaError_t back = cudaSetDevice(cur);
        if (e == cudaSuccess) e = back;
    }
    cudaGetLastError();
    return (int)e;
}

// The CUDA runtime's text for error `e`.
extern "C" const char* ring_search_error_string(int e) {
    return cudaGetErrorString((cudaError_t)e);
}
