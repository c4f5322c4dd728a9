// ring_search.cu — the inexact search as one CUDA kernel, in two launch
// modes (ring queue, fixed batch), for two alphabets (the 16-letter
// multi-genome, the 4-letter single genome of `-S`) and for two index
// layouts (int32; int64, the whole-genome layout, in fixed mode only): six
// instantiations of one template.
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
// Design: one thread per lane runs its reads to completion.  In ring mode a
// lane takes the next read id from a global counter (atomicAdd keeps the
// caller's hardest-first queue order); in fixed mode lane b runs read b and
// nothing else.  For a read the lane initialises, loops
//   pop -> prune -> emit | exact-complete | expand -> link -> write frame,
// then walks the parent chains of the read's reported alignments and writes
// the per-read outputs.  A lane restarts its pop clock at every read (it has
// already walked the finished read's chains), so the lane's arena column is
// a plain array of NFRAME frame rows and a read's frame budget is NFRAME of
// its own pops.  Ring mode flags a read that is not finished right after
// its NFRAME-th pop; fixed mode flags a read that attempts one more pop
// after NFRAME (engine/inexact.py states both rules).  Any capacity overflow
// ends the read at once with its reason bit set: callers discard and retry
// such reads, so nothing after the flag is observable.
//
// The alphabet is a compile-time parameter so that the expansion loops
// unroll and the rank vectors stay in registers: NC = 11 codes, NSLOT = 23
// and 128-word frame rows for a multi-genome; NC = 4, NSLOT = 9 and 40-word
// rows (37 used) for a single genome, where every code is a pure base, so
// the IUPAC match test reduces to equality, no code counts as a SNP, and an
// exact completion keeps one interval.
//
// What bounds it on an H100: every pop is a chain of dependent random reads
// — the popped node's 16-byte slot of a 512-byte frame row, then two
// 128-byte rank rows of the index table — followed by up to 23 16-byte slot
// writes; an exact completion reads two rank rows per list entry per
// character.  That is memory latency and bytes, not arithmetic (a rank is 64
// popcounts).  What this first design does about it: nothing beyond giving
// each lane a warp of its own (thread 0 of the warp; the other 31 exit), so
// that lanes on different control paths do not serialise each other; a
// lane's loads are not overlapped with one another.  Warp-wide lanes, coalesced row reads, shared
// memory and more lanes are left to later work.
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
// Seeded roots.  Given seed_L/seed_U [Q, NROOT] and seed_cnt [Q], read r's
// root s < scnt is (seed_L[r][s], seed_U[r][s]) at i = len - PK with a
// PK-long all-match path, linked to root s - 1 in bucket 0 (links are stored
// +1, so root 0 ends the chain): the roots pop last-first, as the
// reference's heap pops its seed pushes (inexact_match.c:269-282).  A root
// pop reads its row straight from the seed arrays; scnt == 0 ends the read
// with no alignment and no overflow.  Without seeds (null pointers, NROOT =
// 1) the one root is the whole SA range at i = len, formed in registers.
//
// Memory notes.  The bucket heads head[NB] are indexed dynamically and their
// number depends on the scoring parameters, so they live in shared memory,
// NB words for each of the block's lanes.  The two exact-completion interval
// lists (capacity XC entries each) are too large for registers and live in
// per-lane global scratch (`xlist`), as does the frame arena.  Reported
// alignments are written straight into the per-read output slab, which also
// serves the duplicate check.  The kernel allocates nothing and runs on the
// stream it is given.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>
#include <type_traits>
#include <utility>

#define RS_WARP 32           // threads per lane: each lane owns a warp
#define RS_BLOCK_LANES 4     // lanes (warps) per thread block
#define RS_NMETA 9           // q_meta columns (engine/inexact.py META_*)

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

// f(integral_constant<int, 0>) ... f(integral_constant<int, N-1>), in order:
// a loop whose index is a constant expression inside the body
template <typename F, int... T>
__device__ __forceinline__ void static_for(
        std::integer_sequence<int, T...>, F f) {
    (f(std::integral_constant<int, T>{}), ...);
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
    __host__ __device__ static constexpr uint32_t mask() {
        uint32_t m = 0;
        for (int t = 0; t < NC; t++) m |= 1u << code(t);
        return m;
    }
};

__device__ __forceinline__ uint32_t pack1(int i, int mm, int go, int ge,
                                          int st, int plen) {
    return (uint32_t)i | ((uint32_t)mm << 8) | ((uint32_t)go << 13)
         | ((uint32_t)ge << 16) | ((uint32_t)st << 20)
         | ((uint32_t)plen << 22);
}

// Occurrence bounds C[j] + O(j, i) + inc for the codes in `need`
// (engine/rank.py:_rank_all).  DFS = the inexact-search variant: skipped
// codes return C + inc - first_dec without counts.  Returns the number of
// table rows read (0 on the i < 0 and i == LEN-1 edge paths).
template <bool DFS, typename IT>
__device__ __forceinline__ int rank16(const int32_t* __restrict__ table,
                                      const IT* carr, IT LEN, IT i,
                                      int inc, uint32_t need, IT out[16]) {
    const IT len_m1 = LEN - 1;
    if (i == len_m1) {
#pragma unroll
        for (int j = 1; j < 16; j++) out[j] = carr[j + 1] + inc;
        out[0] = 0;
        return 0;
    }
    if (i < 0) {
#pragma unroll
        for (int j = 1; j < 16; j++) out[j] = carr[j] + inc;
        out[0] = 0;
        return 0;
    }
    const IT hi = len_m1 - 1 > 0 ? len_m1 - 1 : 0;
    const IT ic = i < hi ? i : hi;
    const size_t k = (size_t)(ic >> 7);
    const int off = (int)(ic & 127);
    const int4* row = reinterpret_cast<const int4*>(
        table + k * Layout<IT>::TW);
    uint32_t pl[4][4];
    IT ck[16];
#pragma unroll
    for (int t = 0; t < 4; t++) {
        int4 v = __ldg(row + t);
        pl[t][0] = (uint32_t)v.x; pl[t][1] = (uint32_t)v.y;
        pl[t][2] = (uint32_t)v.z; pl[t][3] = (uint32_t)v.w;
    }
#pragma unroll
    for (int t = 0; t < 4; t++) {
        int4 v = __ldg(row + 4 + t);
        if constexpr (Layout<IT>::X64) {
            // counts = high word << 32 | low word (uint32 bits)
            int4 h = __ldg(row + 8 + t);
            ck[4 * t] = ((IT)h.x << 32) | (uint32_t)v.x;
            ck[4 * t + 1] = ((IT)h.y << 32) | (uint32_t)v.y;
            ck[4 * t + 2] = ((IT)h.z << 32) | (uint32_t)v.z;
            ck[4 * t + 3] = ((IT)h.w << 32) | (uint32_t)v.w;
        } else {
            ck[4 * t] = v.x; ck[4 * t + 1] = v.y;
            ck[4 * t + 2] = v.z; ck[4 * t + 3] = v.w;
        }
    }
    uint32_t mask[4];
#pragma unroll
    for (int w = 0; w < 4; w++) {
        int nbits = off + 1 - 32 * w;
        mask[w] = nbits >= 32 ? 0xFFFFFFFFu
                : (nbits <= 0 ? 0u : ((1u << nbits) - 1u));
    }
    int first = (int)((pl[0][0] & 1u) | ((pl[1][0] & 1u) << 1)
                      | ((pl[2][0] & 1u) << 2) | ((pl[3][0] & 1u) << 3));
#pragma unroll
    for (int j = 1; j < 16; j++) {
        if (!((need >> j) & 1u)) continue;
        IT val = carr[j] + inc - (first == j ? 1 : 0);
        if (!(DFS && is_skipped(j))) {
            int cnt = 0;
#pragma unroll
            for (int w = 0; w < 4; w++) {
                uint32_t m = mask[w];
#pragma unroll
                for (int t = 0; t < 4; t++)
                    m &= ((j >> t) & 1) ? pl[t][w] : ~pl[t][w];
                cnt += __popc(m);
            }
            val += ck[j] + cnt;
        }
        out[j] = val;
    }
    out[0] = 0;
    return 1;
}

// Per-read search state that emission updates.
template <typename IT>
struct ReadState {
    int n_alns, overflow, best_score, max_diff;
    IT num_best;
};

// emit_alns of engine/inexact.py (inexact_match.c:331-375 and
// add_alignment's gap dedup, align.c:271-298) for `cnt` intervals read
// through getL/getU.  Returns true when the read is finished (max_best stop
// or ACAP overflow).
template <typename IT, typename GetLU>
__device__ __forceinline__ bool emit_alns(const RSParams& P, ReadState<IT>& S,
                                          IT* oA, int node, uint32_t m1,
                                          uint32_t m2, int cnt, int extra_m,
                                          GetLU get) {
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
    for (int s = 0; s < cnt; s++) {
        IT L, U;
        get(s, L, U);
        width += (UT)(U - L + 1);
    }
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
            for (int k = 0; k < S.n_alns; k++)
                dup |= (oA[k] == L) & (oA[A + k] == U);
            if (dup) continue;
        }
        if (S.n_alns >= A) { S.overflow |= OV_ACAP; return true; }
        int k = S.n_alns++;
        oA[k] = L;
        oA[A + k] = U;
        oA[2 * A + k] = score;
        oA[3 * A + k] = plen + extra_m;
        oA[4 * A + k] = node;
        oA[5 * A + k] = (int)m1;
        oA[6 * A + k] = snp;
    }
    return false;
}

template <bool MULTI, bool FIXED, typename IT>
__global__ void ring_search_kernel(
        RSParams P, const int32_t* __restrict__ table,
        const IT* __restrict__ carr_g, const int8_t* __restrict__ rc,
        const int32_t* __restrict__ lens, const IT* __restrict__ D,
        const IT* __restrict__ Ds, const IT* __restrict__ seed_L,
        const IT* __restrict__ seed_U,
        const int32_t* __restrict__ seed_cnt, int32_t* __restrict__ arena,
        IT* __restrict__ xlist, int32_t* counter,
        IT* __restrict__ q_alns, int32_t* __restrict__ q_meta,
        uint8_t* __restrict__ q_paths) {
    const int gtid = blockIdx.x * blockDim.x + threadIdx.x;
    if (gtid % RS_WARP != 0) return;
    const int lane = gtid / RS_WARP;
    if (lane >= P.lanes) return;

    IT carr[17];
#pragma unroll
    for (int j = 0; j < 17; j++) carr[j] = carr_g[j];

    extern __shared__ int head_smem[];        // [RS_BLOCK_LANES][NB]
    int* const head = head_smem + (threadIdx.x / RS_WARP) * P.NB;
    typedef Layout<IT> LY;
    typedef Alpha<MULTI, LY::NW> AL;
    constexpr int ROWW = AL::ROWW, NSLOT = AL::NSLOT, NC = AL::NC,
                  NW = LY::NW;
    int32_t* const A = arena + (size_t)lane * P.NFRAME * ROWW;
    IT* const X = xlist + (size_t)lane * 4 * P.XC;        // [2][XC][L,U]
    const int NB = P.NB, Lmax = P.Lmax, NROOT = P.NROOT;
    const IT LEN = LY::length(P);
    const bool seeded = seed_cnt != nullptr;

    for (int rid = FIXED ? lane : atomicAdd(counter, 1); rid < P.Q;
         rid = FIXED ? P.Q : atomicAdd(counter, 1)) {
        const int rlen = lens[rid];
        const int8_t* rcr = rc + (size_t)rid * Lmax;
        const IT* Dr = D + (size_t)rid * (Lmax + 1) * 2;
        const IT* Dsr = Ds + (size_t)rid * P.DS * 2;
        IT* oA = q_alns + (size_t)rid * 7 * P.ACAP;

        ReadState<IT> S;
        S.n_alns = 0; S.overflow = 0; S.best_score = NB;
        S.max_diff = P.p_maxdiff; S.num_best = 0;
        int work = 0, rank_rows = 0, frame_rd = 0, frame_wr = 0, pf = 0,
            root_rd = 0;

        // up-front N-count discard (inexact_match.c:259-266)
        int n_count = 0;
        for (int p = 0; p < Lmax && p < rlen; p++) n_count += rcr[p] > 3;
        bool alive = n_count <= P.p_maxdiff;

        // the roots: one, or the read's seed rows chained last-first in
        // bucket 0 (a count above NROOT counts as NROOT)
        int n_open = 1, minb = 0;
        if (seeded) {
            int scnt = seed_cnt[rid];
            n_open = scnt < 0 ? 0 : (scnt > NROOT ? NROOT : scnt);
            alive = alive && n_open > 0;       // no seed hit
        }
        if (alive) {
            for (int b = 0; b < NB; b++) head[b] = -1;
            head[0] = n_open - 1;
        }

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
            // pop: lowest occupied bucket, most recent push (heap_pop)
            while (minb < NB && head[minb] < 0) minb++;
            if (minb >= NB) break;
            const int bucket = minb;
            const int node = head[bucket];
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
                int nn = node - NROOT;
                int f = nn / NSLOT, s = nn - f * NSLOT;
                const int32_t* sp = A + (size_t)f * ROWW + NW * s;
                if constexpr (LY::X64) {
                    eL = *reinterpret_cast<const long long*>(sp);
                    eU = *reinterpret_cast<const long long*>(sp + 2);
                    const int2 mm = *reinterpret_cast<const int2*>(sp + 4);
                    m1 = (uint32_t)mm.x; m2 = (uint32_t)mm.y;
                } else {
                    int4 v = *reinterpret_cast<const int4*>(sp);
                    eL = v.x; eU = v.y; m1 = (uint32_t)v.z;
                    m2 = (uint32_t)v.w;
                }
                frame_rd++;
            }
            head[bucket] = (int)((m2 >> 8) & 0xFFFFFFu) - 1;   // 24-bit link
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
            auto dclip = [&](int t) { return t < 0 ? 0 : (t > Lmax ? Lmax : t); };
            auto sclip = [&](int t) {
                return t < 0 ? 0 : (t > P.DS - 1 ? P.DS - 1 : t);
            };
            const IT D1n = Dr[dclip(ei - 1) * 2];
            const int dls = P.p_maxdiffseed - emm - ego - ege;
            const int seed_index = ei - (rlen - P.p_seedlen);
            const IT S1n = Dsr[sclip(seed_index - 1) * 2];
            bool cont = diff_left < 0;
            cont |= (ei > 0) && (diff_left < D1n);
            cont |= (seed_index > 0) && (dls < S1n);
            if (cont) continue;

            // hit at i == 0 (inexact_match.c:332-344)
            if (ei == 0) {
                bool fin = emit_alns(P, S, oA, node, m1, m2, 1, 0,
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
                IT* cur = X;
                IT* nxt = X + 2 * P.XC;
                cur[0] = eL; cur[1] = eU;
                int cnt = 1;
                int over = 0;
                for (int j = ei - 1; j >= 0 && cnt > 0; j--) {
                    if (work >= P.max_iters) { over = OV_WORK; break; }
                    work++;
                    int c = rcr[j < Lmax ? j : Lmax - 1];
                    if (c > 3) { cnt = 0; break; }
                    const int bm = base_mask(c);
                    // the codes that contain the base (N excluded); within
                    // a single genome that is the pure base alone, so the
                    // list keeps one interval
                    uint32_t need = 0;
#pragma unroll
                    for (int q = 1; q < 16; q++)
                        if ((gray_val(q) & bm) && !is_order_n(q)
                                && (MULTI || gray_val(q) == bm))
                            need |= 1u << q;
                    int ncnt = 0;
                    IT tailU = -2;
                    for (int s = 0; s < cnt && !over; s++) {
                        IT occL[16], occU[16];
                        rank_rows += rank16<false>(table, carr, LEN,
                                                   cur[2 * s] - 1, 1, need,
                                                   occL);
                        rank_rows += rank16<false>(table, carr, LEN,
                                                   cur[2 * s + 1], 0, need,
                                                   occU);
#pragma unroll
                        for (int q = 1; q < 16; q++) {
                            if (!((need >> q) & 1u)) continue;
                            IT L = occL[q], U = occU[q];
                            if (L > U || over) continue;
                            if (ncnt > 0 && L == tailU + 1) {
                                nxt[2 * (ncnt - 1) + 1] = U;
                            } else if (ncnt >= P.XC) {
                                over = OV_LIST;
                            } else {
                                nxt[2 * ncnt] = L;
                                nxt[2 * ncnt + 1] = U;
                                ncnt++;
                            }
                            tailU = U;
                        }
                    }
                    if (over) break;
                    IT* t = cur; cur = nxt; nxt = t;
                    cnt = ncnt;
                }
                if (over) { S.overflow |= over; break; }
                if (cnt > 0) {
                    // the scan consumed ei chars: the path extends by ei
                    // implicit matches (inexact_match.c:365)
                    const IT* lst = cur;
                    bool fin = emit_alns(P, S, oA, node, m1, m2, cnt, ei,
                                         [&](int s, IT& L, IT& U) {
                                             L = lst[2 * s];
                                             U = lst[2 * s + 1];
                                         });
                    if (fin) break;
                }
                continue;
            }

            // expansion (inexact_match.c:377-504)
            // (the DFS rank variant differs from the exact one on skipped
            // codes only, and a single genome expands none)
            constexpr uint32_t need_dfs = AL::mask();
            IT Lv[16], Uv[16];
            rank_rows += rank16<MULTI>(table, carr, LEN, eL - 1, 1, need_dfs,
                                       Lv);
            rank_rows += rank16<MULTI>(table, carr, LEN, eU, 0, need_dfs, Uv);

            const IT D2n = Dr[dclip(ei - 2) * 2];
            const IT D1w = Dr[dclip(ei - 1) * 2 + 1];
            const IT D2w = Dr[dclip(ei - 2) * 2 + 1];
            const IT S2n = Dsr[sclip(seed_index - 2) * 2];
            const IT S1w = Dsr[sclip(seed_index - 1) * 2 + 1];
            const IT S2w = Dsr[sclip(seed_index - 2) * 2 + 1];
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

            int c = rcr[(ei - 1) < Lmax ? (ei - 1) : Lmax - 1];
            c = c < 0 ? 0 : (c > 4 ? 4 : c);
            const bool is_I = est == STATE_I, is_M = est == STATE_M;
            const bool ind_ok = allow_diff && allow_indels;
            if (eplen + 1 >= P.PATHCAP) { S.overflow |= OV_PATH; break; }
            const int nplen = eplen + 1;

            // sequential LIFO push of slots 0..NSLOT-1 into the score
            // buckets (inexact_match.c:510-610)
            int32_t* frow = A + (size_t)myf * ROWW;
            int total = 0;
            auto push = [&](int s, IT L, IT U, uint32_t cm1, int snp) {
                int sc = ((cm1 >> 8) & 0x1F) * P.p_mm
                       + ((cm1 >> 13) & 0x7) * P.p_go
                       + ((cm1 >> 16) & 0xF) * P.p_ge;
                int b = sc < 0 ? 0 : (sc > NB - 1 ? NB - 1 : sc);
                uint32_t cm2 = ((uint32_t)snp & 0xFFu)
                             | ((uint32_t)(head[b] + 1) << 8);
                if constexpr (LY::X64) {
                    int32_t* sp = frow + NW * s;
                    *reinterpret_cast<long long*>(sp) = L;
                    *reinterpret_cast<long long*>(sp + 2) = U;
                    *reinterpret_cast<int2*>(sp + 4) =
                        make_int2((int)cm1, (int)cm2);
                } else {
                    *reinterpret_cast<int4*>(frow + 4 * s) =
                        make_int4(L, U, (int)cm1, (int)cm2);
                }
                head[b] = base + s;
                if (b < minb) minb = b;
                total++;
            };

            // slot 0: insertion (extend if state == I else open if M)
            if (ind_ok && ((is_I && allow_extend) || (is_M && allow_open)))
                push(0, eL, eU,
                     pack1(ei - 1, emm, ego + (is_M ? 1 : 0),
                           ege + (is_I ? 1 : 0), STATE_I, nplen), esnp);
            // slots 1..NC: deletions (consume a reference char, keep i)
            {
                const bool del_any = ind_ok && !is_I
                    && ((is_M && allow_open) || (!is_M && allow_extend));
                const uint32_t dm1 = pack1(ei, emm, ego + (is_M ? 1 : 0),
                                           ege + (is_M ? 0 : 1), STATE_D,
                                           nplen);
                static_for(std::make_integer_sequence<int, NC>{},
                           [&](auto tc) {
                    constexpr int t = decltype(tc)::value;
                    constexpr int q = AL::code(t);
                    if (del_any && Lv[q] <= Uv[q])
                        push(1 + t, Lv[q], Uv[q], dm1, esnp);
                });
            }
            // slots NC+1..2NC: match / mismatch (or the exact-only
            // continuation when mismatches are suppressed)
            {
                const bool mm_branch = allow_diff && allow_mm;
                const int bm = c <= 3 ? base_mask(c) : 0;
                static_for(std::make_integer_sequence<int, NC>{},
                           [&](auto tc) {
                    constexpr int t = decltype(tc)::value;
                    constexpr int q = AL::code(t);
                    const bool nonempty = Lv[q] <= Uv[q];
                    const bool is_match = (c <= 3) && !is_order_n(q)
                                          && ((gray_val(q) & bm) != 0);
                    const bool ok_mm = mm_branch && nonempty;
                    const bool ok_ex = !mm_branch && (c < 4) && is_match
                                       && nonempty;
                    if (ok_mm || ok_ex) {
                        int mmn = emm + ((ok_mm && !is_match) ? 1 : 0);
                        push(1 + NC + t, Lv[q], Uv[q],
                             pack1(ei - 1, mmn, ego, ege, STATE_M, nplen),
                             (esnp + (is_snp(q) ? 1 : 0)) & 0xFF);
                    }
                });
            }
            if (total > 0) {
                frow[AL::PARENT] = node;
                frame_wr++;
                n_open += total;
            }
        }

        // walk the parent chains of the reported alignments (the flush-time
        // walk of switch_step): entry t is the state of the t-th ancestor,
        // node first, root excluded; 2 bits per state
        if (!S.overflow) {
            for (int k = 0; k < S.n_alns; k++) {
                uint8_t* pp = q_paths + ((size_t)rid * P.ACAP + k) * P.PW;
                int cur = (int)oA[4 * P.ACAP + k];
                int t = 0;
                uint32_t acc = 0;
                while (t < P.PATHCAP && cur >= NROOT) {
                    int nn = cur - NROOT;
                    int f = nn / NSLOT, s = nn - f * NSLOT;
                    int st = s == 0 ? STATE_I
                                    : (s <= NC ? STATE_D : STATE_M);
                    acc |= (uint32_t)st << (2 * (t & 3));
                    if ((t & 3) == 3) { pp[t >> 2] = (uint8_t)acc; acc = 0; }
                    cur = A[(size_t)f * ROWW + AL::PARENT];
                    frame_rd++;
                    t++;
                }
                if (t & 3) pp[t >> 2] = (uint8_t)acc;
            }
        }

        int32_t* qm = q_meta + (size_t)rid * RS_NMETA;
        qm[0] = S.n_alns; qm[1] = S.overflow; qm[2] = lane; qm[3] = work;
        qm[4] = rank_rows; qm[5] = frame_rd; qm[6] = frame_wr; qm[7] = pf;
        qm[8] = root_rd;
    }
}

extern "C" int ring_search_num_params() {
    return (int)(sizeof(RSParams) / sizeof(int));
}

extern "C" int ring_search_num_meta() { return RS_NMETA; }

template <bool MULTI, bool FIXED, typename IT>
static int launch(const RSParams& P, size_t smem, const void* table,
                  const void* carr, const void* rc, const void* lens,
                  const void* D, const void* Ds, const void* sL,
                  const void* sU, const void* scnt, void* arena, void* xlist,
                  void* counter, void* q_alns, void* q_meta, void* q_paths,
                  void* stream) {
    const int threads = RS_BLOCK_LANES * RS_WARP;
    const int blocks = (P.lanes + RS_BLOCK_LANES - 1) / RS_BLOCK_LANES;
    ring_search_kernel<MULTI, FIXED, IT>
        <<<blocks, threads, smem, (cudaStream_t)stream>>>(
        P, (const int32_t*)table, (const IT*)carr, (const int8_t*)rc,
        (const int32_t*)lens, (const IT*)D, (const IT*)Ds,
        (const IT*)sL, (const IT*)sU, (const int32_t*)scnt,
        (int32_t*)arena, (IT*)xlist, (int32_t*)counter,
        (IT*)q_alns, (int32_t*)q_meta, (uint8_t*)q_paths);
    return (int)cudaGetLastError();
}

// Frame-row width in int32 words for an alphabet and an index layout, for
// the wrapper's arena.
extern "C" int ring_search_row_words(int multiref, int x64) {
    if (x64)
        return multiref ? Alpha<true, 6>::ROWW : Alpha<false, 6>::ROWW;
    return multiref ? Alpha<true>::ROWW : Alpha<false>::ROWW;
}

// Launches on `stream`; returns cudaGetLastError() (0 on success), or -1
// when the parameter block does not match RSParams, the bucket heads do not
// fit a block's shared memory, a fixed launch has not one lane per read,
// the seeds are given in part or with NROOT < 1, or the int64 layout is
// asked of a ring launch.  `multiref` picks the alphabet, `fixed` the
// launch mode (`counter` is not read then), `x64` the index layout (carr,
// D, Ds, the seed intervals, xlist and q_alns are int64 then, the table
// has 48 words a row); seed_L, seed_U and seed_cnt are all null (one
// unseeded root, NROOT = 1) or all given ([Q, NROOT], [Q, NROOT], [Q]
// int32).
extern "C" int ring_search_launch(
        const int* hp, int nhp, int multiref, int fixed, int x64,
        const void* table,
        const void* carr, const void* rc, const void* lens, const void* D,
        const void* Ds, const void* seed_L, const void* seed_U,
        const void* seed_cnt, void* arena, void* xlist, void* counter,
        void* q_alns, void* q_meta, void* q_paths, void* stream) {
    if (nhp != (int)(sizeof(RSParams) / sizeof(int))) return -1;
    RSParams P;
    memcpy(&P, hp, sizeof(P));
    const size_t smem = (size_t)RS_BLOCK_LANES * P.NB * sizeof(int);
    if (P.NB < 1 || smem > 48 * 1024) return -1;
    if (fixed && P.lanes != P.Q) return -1;
    const int nseed = (seed_L != nullptr) + (seed_U != nullptr)
                    + (seed_cnt != nullptr);
    if (nseed == 1 || nseed == 2 || P.NROOT < 1 || (!nseed && P.NROOT != 1))
        return -1;
#define RS_LAUNCH(M, F, T) launch<M, F, T>(                                 \
        P, smem, table, carr, rc, lens, D, Ds, seed_L, seed_U, seed_cnt,   \
        arena, xlist, counter, q_alns, q_meta, q_paths, stream)
    if (x64) {
        if (!fixed) return -1;
        return multiref ? RS_LAUNCH(true, true, long long)
                        : RS_LAUNCH(false, true, long long);
    }
    if (multiref)
        return fixed ? RS_LAUNCH(true, true, int) : RS_LAUNCH(true, false, int);
    return fixed ? RS_LAUNCH(false, true, int) : RS_LAUNCH(false, false, int);
#undef RS_LAUNCH
}
