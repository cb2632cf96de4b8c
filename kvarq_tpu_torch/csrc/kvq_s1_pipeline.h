// The warp-specialised pipeline of the port's Hopper kernels (sm_90a):
// the one-hot match product of a batch of reads against every shift
// column of the template bank, screened, with a drain chosen at compile
// time (Drain): S1's sums and coverage and H1's triplets (score_step.cu),
// K1's per-read counts (cand_screen.cu).
//
// Design: one persistent block per SM walks a static schedule of stages.
// A stage is 128 reads (a row tile) times 128 shift columns of one
// residue s of a column group: the group's GC = 512 columns are R = 16 /
// SP residues of spans of 128 R columns, and stage k scores columns q0 +
// (k / R) 128 R + k % R + R c, c < 128 (SP: depth bytes per read
// position, 4 for nch 4, 8 for nch 5).  The stages of every row tile
// below the count, row tile outermost, are cut into gridDim.x equal
// ranges, so the grid does not depend on the count and a block rebuilds
// its reads' one-hot tile only when the row tile changes.
//
// - A producer warp (40 registers after setmaxnreg) stages each column
//   group into a ring of two slots with bulk copies (cp.async.bulk)
//   completed on an mbarrier: the R residue windows of the precomputed
//   one-hot bank (pallas_scan.s1_onehot: copy s is moved by s positions,
//   so every window starts on a 16-byte boundary) and the group's screen
//   terms in stage order (pallas_scan.s1_terms).  One set of windows
//   serves the group's four stages: the descriptor start moves by 16 *
//   128 bytes per span.
// - Two consumer warpgroups (232 registers) each own 64 reads of the row
//   tile: they build their rows' one-hot tile (kvq_onehot_mma.h's A
//   layout) in shared memory while the group's copies land, and per
//   stage issue its MMAs (wgmma m64n128k32 s8 -> s32, A and the residue
//   window in shared memory: one n128 MMA per k-step and residue reads
//   the A tile once) into one of two accumulator sets, then screen and
//   drain the previous stage from the other set while the tensor cores
//   work.  A warp stalls on issuing a wgmma while the tensor cores work
//   through the ones before it, so the two warpgroups take turns at
//   issuing: one issues while the other screens.
// - The screen takes two columns per DPX instruction (16-bit halves:
//   the count minus its threshold, whose terms do not depend on e).
//   S1 pushes each passing (read, column) pair into the warpgroup's list
//   in shared memory (room for every pair of a stage) only in warps that
//   have one.  Its drain takes a pair per warp: the match count again
//   from the codes and the staged window (the coverage fold walks the
//   read's positions anyway), mode_weights, seqhits and seqbasehits
//   summed over a warp's run of pairs of one template before the atomic,
//   and the coverage fold into a u32 histogram of the stage's bank
//   positions in shared memory, flushed into basecount with one int64
//   atomic per non-zero entry of the positions the pairs touched (deep
//   loci take one atomic per position, not one per read).  H1 and K1
//   keep no list and recount nothing: their drains work in the screen's
//   lanes, on the accumulators, which hold each pair's whole count.  K1's
//   (Consumer::count) keeps a count per read in registers; H1's
//   (Consumer::hits) keeps each pair's pass bit, which is mode_weights'
//   test of the count, and writes the triplets of the passing pairs with
//   hit modes into slots claimed with one atomic per warp.  Depths above
//   the A tile's room (1,024 bytes) rebuild it per chunk and stage, with
//   nothing in flight: the accumulators are whole after the last chunk.
//
// ptxas serialises the MMAs (C7514/C7515/C7520 in the -Xptxas -v report)
// if any of these breaks: warp-uniform control flow around the MMAs, no
// non-wgmma write of an accumulator while the other set is in flight, no
// MMA group outliving its step.

#ifndef KVQ_S1_PIPELINE_H
#define KVQ_S1_PIPELINE_H

#include "kvq_onehot_mma.h"

namespace {

using namespace kvq;

typedef unsigned long long u64;

constexpr int GC = 512;          // shift columns per column group
constexpr int NSTAGE = 4;        // stages per group, 128 columns each
constexpr int NSLOT = 2;         // column groups staged at a time
constexpr int NCW = 2;           // consumer warpgroups, 64 reads each
constexpr int NTHREADS = 128 * (NCW + 1);  // and the producer warpgroup
constexpr int NACC = 64;         // accumulators per thread: m64 n128
constexpr int LIST_CAP = 64 * 128;         // pairs of a warpgroup's stage
constexpr int TERM_BYTES = NSTAGE * 64 * 16;    // a group's screen terms
constexpr int SMEM_MAX = 227 * 1024;
constexpr int INT_BIG = 0x7FFFFFFF;

// the profile buffer's entries (pallas_scan.PROFILE_PHASES): consumer
// warpgroups' cycles building A and the row terms, issuing and waiting
// on MMAs, screening, draining, waiting on barriers, in all; the
// producer's cycles staging and waiting for a free slot
constexpr int PROF_BUILD = 0, PROF_MMA = 1, PROF_SCREEN = 2, PROF_DRAIN = 3,
              PROF_WAIT = 4, PROF_TOTAL = 5, PROF_STAGE = 6,
              PROF_STAGE_WAIT = 7, PROF_N = 8;

static_assert(TB == 128 && TQ == 128, "list entries hold 6 + 7 bits");

// the drains, chosen at compile time: S1's sums and coverage, H1's
// triplets, K1's counts
enum Drain { DRAIN_SCORE, DRAIN_HIT, DRAIN_COUNT };

// the dynamic shared memory of one launch: the A tile (akc K columns of
// 16 bytes), NSLOT slots (R windows of win bytes, the terms), NCW pair
// lists (S1) and NCW coverage histograms of 5 x hp positions (S1; hp 0:
// none)
struct Layout {
    int dp;         // depth bytes the MMAs read (whole k32 steps)
    int win;        // bytes of one residue window of a group
    int akc;        // K columns of A in shared memory
    int nchunks;    // A tiles per row tile
    int hp;         // positions per histogram channel, 0: no histogram
    int slot_off, slot_bytes, list_off, hist_off, bytes;
};

Layout make_layout(int SP, int Lpad, int mode)
{
    const bool hist_ok = mode == DRAIN_SCORE;
    const int list_bytes = mode == DRAIN_SCORE ? NCW * LIST_CAP * 2 : 0;
    Layout L = {};
    const int R = 16 / SP;
    L.dp = (SP * Lpad + 31) / 32 * 32;
    L.win = SP * GC + L.dp;
    L.slot_bytes = R * L.win + TERM_BYTES;
    const int kcols = L.dp / 16;
    for (int amax = 64; amax >= 16; amax /= 2) {
        for (int hist = hist_ok ? 1 : 0; hist >= 0; --hist) {
            L.akc = kcols < amax ? kcols : amax;
            L.nchunks = (kcols + L.akc - 1) / L.akc;
            L.hp = hist ? (128 * R + Lpad + 3) / 4 * 4 : 0;
            L.slot_off = (L.akc * KSTRIDE + 127) / 128 * 128;
            L.list_off = L.slot_off + NSLOT * L.slot_bytes;
            L.hist_off = L.list_off + list_bytes;
            L.bytes = L.hist_off + NCW * 5 * L.hp * 4;
            if (L.bytes <= SMEM_MAX)
                return L;
        }
    }
    L.bytes = 0;
    return L;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p)
{
    return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count)
{
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar)
{
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                 :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes)
{
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// wait until the barrier's phase is not ``parity``
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity)
{
    uint32_t done;
    do {
        asm volatile(
            "{\n"
            ".reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n"
            "}\n"
            : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
    } while (!__all_sync(0xFFFFFFFFu, done));   // the warp leaves together
}

// bytes from device memory into shared memory, completed on ``bar``
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar)
{
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n"
        :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
        : "memory");
}

// the 128 threads of consumer warpgroup wg
__device__ __forceinline__ void wg_sync(int wg)
{
    asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
}

// the two consumer warpgroups take turns at issuing MMAs (a warp stalls
// on a wgmma's issue while the tensor cores work through the ones before
// it, so one warpgroup issues while the other screens): barrier 3 + wg
// is warpgroup wg's turn, which the other passes to it
__device__ __forceinline__ void turn_wait(int wg)
{
    asm volatile("bar.sync %0, 256;\n" :: "r"(3 + wg) : "memory");
}

__device__ __forceinline__ void turn_pass(int wg)
{
    asm volatile("bar.arrive %0, 256;\n" :: "r"(4 - wg) : "memory");
}

// d = A (64 x 32) * B (32 x 128) + (acc ? d : 0), both K-major in shared
// memory, s8 -> s32
__device__ __forceinline__ void wgmma_n128(int (&d)[64], uint64_t da,
                                           uint64_t db, int acc)
{
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
        "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
        "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n"
        "}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "l"(da), "l"(db), "r"(acc));
}

// the hit modes (A, B, full: 0, 1 or 2 of them) and the overlap ov of a
// read of length rl at a column (d, seql): tensor_scan.mode_weights
// without its pass test
__device__ __forceinline__ int mode_bits(int rl, int d, int seql,
                                         int minoverlap, int& ov)
{
    const int t1 = d + rl;
    ov = min(seql, t1) - max(d, 0);
    const bool ab = rl > minoverlap && seql > minoverlap;
    const bool govmo = ov >= minoverlap;
    const int wA = ab && d < 0 && govmo && ov != seql;
    const int wB = ab && d > 0 && govmo && t1 >= seql;
    const int full = ov == min(rl, seql);
    return wA + wB + full;
}

// hit-mode weight (0/1/2) and overlap ov of a read of length rl with m
// matching bases at a column (d, seql, valid): tensor_scan.mode_weights
__device__ __forceinline__ int mode_weight(int m, int rl, int d, int seql,
                                           int valid, int maxerrors,
                                           int minoverlap, int& ov)
{
    const int w = mode_bits(rl, d, seql, minoverlap, ov);
    const bool passing = valid > 0 && rl > 0 && ov - m <= maxerrors;
    return passing ? w : 0;
}

struct Args {
    const uint32_t* codes;     // [B, Lpad/4]
    const int32_t* rl;         // [B]
    const int32_t* rows;       // [cap] or null
    const int32_t* count;      // [1] or null
    int cap;
    const uint8_t* bank;       // [nb]
    long nb;
    const uint8_t* onehot;     // [R, onb]
    long onb;
    const uint4* sterms;       // [groups * NSTAGE * 64]
    const int32_t* qmeta;      // [8, Qp]
    const int32_t* tseg;       // [Qp]
    u64* basecount;            // [5, G]
    u64* seqhits;              // [T + 1]
    u64* seqbasehits;          // [T + 1]
    int Lpad, Qp, G, maxerrors, minoverlap;
    long long* prof;           // [PROF_N] or null
    // H1: the triplet buffer [outcap, 3], its counter, the batch row ->
    // reported id map [B] or null; K1: out holds the counts [B]
    int32_t* out;
    int32_t* nout;
    int outcap;
    const int32_t* row_ids;
};

// the block's shared state besides the dynamic buffers
struct Shared {
    uint64_t full[NSLOT], empty[NSLOT];
    int row_id[2][TB], row_rl[2][TB], row_rlmo[2][TB];
    // per consumer warpgroup and stage modulo 3: the list's length and
    // the first and last column of the pairs with a weight
    int list_n[NCW][3], lo[NCW][3], hi[NCW][3];
};

// one stage of the schedule: row tile, column group, stage in the group
// (k / R: span, k % R: residue), its slot, and its position modulo 3 among
// the block's stages (the index of its list length and touched columns)
struct Stage {
    int rt, g, k, slot, i3;
    bool release;      // the last stage of its group in the block's range
};

// a consumer warpgroup's walk over the block's stages [s0, s1), with the
// drain MODE (Drain)
template <int SP, bool PROF, int MODE>
struct Consumer {
    static constexpr int R = 16 / SP;
    static constexpr int SPAN = 128 * R;

    const Args& a;
    const Layout& lay;
    Shared& sh;
    uint8_t* As;
    const uint8_t* slots;
    uint16_t* list;
    uint32_t* hist;
    int s0, s1, ngroups, n, wg, wtid, warp, lane, g8, t;

    // the next stage to issue, counted without divisions
    Stage nx = {};
    int phase = 0;
    // the row tile of the row terms in shared memory, and of A where the
    // depth is one chunk (-1: none)
    int rows_rt = -1, a_rt = -1;
    long long pt[PROF_N] = {};
    // K1: the passing columns of this thread's two reads of row tile
    // cnt_rt so far (-1: none)
    int cnt[2] = {0, 0};
    int cnt_rt = -1;

    __device__ __forceinline__ Consumer(const Args& a_, const Layout& l_,
                                        Shared& sh_, uint8_t* smem, int s0_,
                                        int s1_, int n_, int ngroups_)
        : a(a_), lay(l_), sh(sh_), As(smem), slots(smem + l_.slot_off),
          s0(s0_), s1(s1_), ngroups(ngroups_), n(n_)
    {
        const int tid = threadIdx.x;
        wg = tid >> 7;
        wtid = tid & 127;
        warp = tid >> 5;
        lane = tid & 31;
        g8 = lane >> 2;
        t = lane & 3;
        list = reinterpret_cast<uint16_t*>(smem + lay.list_off) + wg * LIST_CAP;
        hist = reinterpret_cast<uint32_t*>(smem + lay.hist_off)
            + wg * 5 * lay.hp;
        nx.rt = s0 / (ngroups * NSTAGE);
        nx.g = s0 / NSTAGE % ngroups;
        nx.k = s0 % NSTAGE;
    }

    __device__ __forceinline__ long long clk() const
    {
        return PROF ? clock64() : 0;
    }

    // the row terms of row tile rt (rows_too: when it changes; two sets,
    // rt % 2, so that the previous row tile's stage can still be finished)
    // and this warpgroup's rows of the A tile for depth chunk ch
    __device__ __forceinline__ void rebuild(int rt, int ch, bool rows_too)
    {
        const long long c0 = clk();
        const int r0 = 64 * wg, set = rt & 1;
        if (rows_too) {
            if (wtid < 64) {
                const int r = r0 + wtid;
                const long b = (long)rt * TB + r;
                const int row = b < n ? (a.rows ? a.rows[b] : (int)b) : -1;
                const int v = row >= 0 ? a.rl[row] : 0;
                sh.row_id[set][r] = row;
                sh.row_rl[set][r] = v;
                sh.row_rlmo[set][r] = v > 0 ? min(v, a.minoverlap)
                                            : BIG_RL_THRESHOLD;
            }
            wg_sync(wg);
        }
        // K column v (depth bytes d0 + 16 v ..) of block row r at
        // v * KSTRIDE + 16 r: kvq_onehot_mma.h's A layout; the code words
        // of U entries are loaded before they are expanded
        constexpr int U = 8;
        const int lw = a.Lpad / 4;
        const int d0 = ch * lay.akc * 16;
        const int kcols = min(lay.akc, lay.dp / 16 - ch * lay.akc);
        for (int i0 = wtid; i0 < 64 * kcols; i0 += 128 * U) {
            uint32_t w[U];
#pragma unroll
            for (int u = 0; u < U; ++u) {
                const int idx = i0 + 128 * u;
                const int r = r0 + idx / kcols, v = idx % kcols;
                const int p = (d0 + 16 * v) / SP;
                const int row = idx < 64 * kcols ? sh.row_id[set][r] : -1;
                w[u] = row >= 0 && p < a.Lpad
                    ? __ldg(a.codes + (size_t)row * lw + p / 4) : ~0u;
            }
#pragma unroll
            for (int u = 0; u < U; ++u) {
                const int idx = i0 + 128 * u;
                if (idx >= 64 * kcols)
                    break;
                const int r = r0 + idx / kcols, v = idx % kcols;
                const int p = (d0 + 16 * v) / SP;
                // ~0: four junk codes, which one-hot to zero
                uint4 x;
                if (SP == 4) {
                    x.x = onehot4(w[u] & 0xFFu);
                    x.y = onehot4((w[u] >> 8) & 0xFFu);
                    x.z = onehot4((w[u] >> 16) & 0xFFu);
                    x.w = onehot4(w[u] >> 24);
                } else {
                    const uint32_t c0_ = (w[u] >> (8 * (p % 4))) & 0xFFu;
                    const uint32_t c1_ = (w[u] >> (8 * (p % 4) + 8)) & 0xFFu;
                    x = make_uint4(onehot4(c0_), c0_ == 4u ? 1u : 0u,
                                   onehot4(c1_), c1_ == 4u ? 1u : 0u);
                }
                *reinterpret_cast<uint4*>(As + v * KSTRIDE + 16 * r) = x;
            }
        }
        fence_proxy_async();
        wg_sync(wg);
        if (PROF)
            pt[PROF_BUILD] += clk() - c0;
    }

    // stage st, its accumulators in acc: screened and drained, its slot
    // released after its group's last stage
    __device__ __forceinline__ void finish(const int (&acc)[NACC],
                                           const Stage& st)
    {
        if constexpr (MODE == DRAIN_COUNT)
            count(acc, st);
        else if constexpr (MODE == DRAIN_HIT)
            hits(acc, st);
        else
            finish_pairs(acc, st);
    }

    // S1's finish: the screen's passing pairs listed, then drained
    __device__ __forceinline__ void finish_pairs(const int (&acc)[NACC],
                                                 const Stage& st)
    {
        long long c0 = clk();
        const int p = st.k / R, s = st.k % R;
        const int q0 = st.g * GC + p * SPAN;
        const uint8_t* slot = slots + st.slot * lay.slot_bytes;
        // the terms of MMA columns 2 i and 2 i + 1, their 16-bit halves:
        // minus (dm, ovc, seql) clamped to +-16383 (pallas_scan.s1_terms)
        const uint4* terms = reinterpret_cast<const uint4*>(slot + R * lay.win)
            + st.k * 64;
        const int set = st.rt & 1;
        const int e_ = a.maxerrors;
        int rlv[2], rlmo[2];
        uint32_t nrl2[2], nrlmo2[2];     // minus the row terms, in both halves
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            rlv[h] = min(sh.row_rl[set][acc_read(warp, g8, h)], 16383);
            rlmo[h] = min(sh.row_rlmo[set][acc_read(warp, g8, h)], 16383);
            nrl2[h] = (uint32_t)(-rlv[h] & 0xFFFF) * 0x10001u;
            nrlmo2[h] = (uint32_t)(-rlmo[h] & 0xFFFF) * 0x10001u;
        }
        // the screen without branches, two columns a DPX instruction: the
        // largest count minus threshold, then the pushes in the warps that
        // have a passing pair (few: a read hits a template or two).  The
        // count plus e passes at the threshold max(min(rl + dm, ovc),
        // min(rlmo, seql)) (pallas_scan.s1_terms)
        uint32_t run[2] = {0x80008000u, 0x80008000u};
#pragma unroll
        for (int j = 0; j < NACC / 4; ++j) {
            const uint4 tm = terms[4 * j + t];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const uint32_t a2 = __byte_perm(acc[4 * j + 2 * h],
                                                acc[4 * j + 2 * h + 1],
                                                0x5410);
                const uint32_t nthr = __viaddmin_s16x2(
                    __viaddmax_s16x2(nrl2[h], tm.x, tm.y), 0u,
                    __viaddmax_s16x2(nrlmo2[h], 0u, tm.z));
                run[h] = __viaddmax_s16x2(a2, nthr, run[h]);
            }
        }
        const uint32_t r2 = __viaddmax_s16x2(run[0], 0u, run[1]);
        const bool any = (int)(short)(r2 & 0xFFFFu) + e_ >= 0
            || (int)(short)(r2 >> 16) + e_ >= 0;
        if (__any_sync(0xFFFFFFFFu, any)) {
            const int rbase = 16 * (warp & 3) + g8;
#pragma unroll
            for (int j = 0; j < NACC / 4; ++j) {
                const uint4 tm = terms[4 * j + t];
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int sh_ = 16 * e;
                    const int dm = -(int)(short)(tm.x >> sh_);
                    const int ovc = -(int)(short)(tm.y >> sh_);
                    const int sq = -(int)(short)(tm.z >> sh_);
                    const int c = 8 * j + 2 * t + e;
#pragma unroll
                    for (int h = 0; h < 2; ++h)
                        if (acc[4 * j + 2 * h + e] + e_
                                >= max(min(rlv[h] + dm, ovc),
                                       min(rlmo[h], sq)))
                            list[atomicAdd(&sh.list_n[wg][st.i3], 1)] =
                                (uint16_t)(c << 6 | (rbase + 8 * h));
                }
            }
        }
        long long c1 = clk();
        if (PROF) {
            pt[PROF_SCREEN] += c1 - c0;
            c0 = c1;
        }
        wg_sync(wg);     // the list is complete; the terms are read
        // warp-uniform, as the compiler can see
        const int nl = __shfl_sync(0xFFFFFFFFu, sh.list_n[wg][st.i3], 0);
        if (wtid == 0) {
            const int i = (st.i3 + 2) % 3;    // the stage after next
            sh.list_n[wg][i] = 0;
            sh.lo[wg][i] = INT_BIG;
            sh.hi[wg][i] = -1;
            if (st.release && nl == 0)
                mbar_arrive(&sh.empty[st.slot]);
        }
        if (PROF) {
            c1 = clk();
            pt[PROF_WAIT] += c1 - c0;
            c0 = c1;
        }
        if (nl == 0)
            return;
        drain(nl, slot + s * lay.win + SP * p * SPAN, q0 + s,
              q0 - (a.Lpad - 1), st.i3, set);
        if (PROF) {
            c1 = clk();
            pt[PROF_DRAIN] += c1 - c0;
            c0 = c1;
        }
        wg_sync(wg);     // the list and the window are read, the
                         // histogram is complete
        if (st.release && wtid == 0)
            mbar_arrive(&sh.empty[st.slot]);
        if (PROF) {
            c1 = clk();
            pt[PROF_WAIT] += c1 - c0;
            c0 = c1;
        }
        if (lay.hp)
            flush(q0 - (a.Lpad - 1), st.i3);
        if (PROF)
            pt[PROF_DRAIN] += clk() - c0;
    }

    // S1's listed pairs, one warp per pair; MMA column c is column qs + R c
    // and bank position qs + R c + j is one-hot at byte SP (R c + j) of the
    // staged window win; its coverage lands on histogram entry g - hbase
    __device__ __forceinline__ void drain(int nl, const uint8_t* win, int qs,
                                          int hbase, int i3, int set)
    {
        constexpr uint32_t NCH = SP == 4 ? 4u : 5u;
        const uint8_t* codes = reinterpret_cast<const uint8_t*>(a.codes);
        const int Lpad = a.Lpad, Qp = a.Qp, G = a.G;
        int run_seg = -1;
        u64 run_w = 0, run_b = 0;
        for (int x = warp & 3; x < nl; x += 4) {
            const int ent = list[x];
            const int r = 64 * wg + (ent & 63);
            const int c = ent >> 6;
            const int q = qs + R * c;
            const int row = sh.row_id[set][r];
            if (row < 0)
                continue;    // an empty row passes where seql <= e
            const int d = a.qmeta[ROW_D * Qp + q];
            const int seql = a.qmeta[ROW_SEQL * Qp + q];
            const int valid = a.qmeta[ROW_VALID * Qp + q];
            const int seg = a.tseg[q];
            const uint8_t* read = codes + (size_t)row * Lpad;
            const uint8_t* bw = win + SP * R * c;
            int m = 0;
#pragma unroll 4
            for (int j = lane; j < Lpad; j += 32) {
                const uint32_t b = read[j];
                m += b < NCH && bw[SP * j + b] != 0;
            }
#pragma unroll
            for (int o = 16; o > 0; o >>= 1)
                m += __shfl_xor_sync(0xFFFFFFFFu, m, o);
            int ov;
            const int w = mode_weight(m, sh.row_rl[set][r], d, seql, valid,
                                      a.maxerrors, a.minoverlap, ov);
            if (w == 0)
                continue;
            if (lane == 0) {
                if (seg != run_seg) {
                    if (run_seg >= 0) {
                        atomicAdd(a.seqhits + run_seg, run_w);
                        atomicAdd(a.seqbasehits + run_seg, run_b);
                    }
                    run_seg = seg;
                    run_w = run_b = 0;
                }
                run_w += (u64)w;
                run_b += (u64)(long long)(w * ov);
                if (lay.hp) {
                    atomicMin(&sh.lo[wg][i3], q);
                    atomicMax(&sh.hi[wg][i3], q);
                }
            }
            // the diagonal fold: read position j lies on bank position
            // q - (Lpad-1) + j
#pragma unroll 4
            for (int j = lane; j < Lpad; j += 32) {
                const uint32_t b = read[j];
                const int gp = q - (Lpad - 1) + j;
                if (b < 5u && gp >= 0 && gp < G) {
                    if (lay.hp)
                        atomicAdd(hist + b * lay.hp + (gp - hbase),
                                  (uint32_t)w);
                    else
                        atomicAdd(a.basecount + (size_t)b * G + gp, (u64)w);
                }
            }
        }
        if (lane == 0 && run_seg >= 0) {
            atomicAdd(a.seqhits + run_seg, run_w);
            atomicAdd(a.seqbasehits + run_seg, run_b);
        }
    }

    // H1's drain of stage st, its accumulators in acc: K1's screen
    // (pass_bits), each pair's pass bit kept in pm instead of summed.  The
    // screen is mode_weights' own test of the count: its threshold's first
    // term, min(rl + dm, ovc), is the overlap ov, so a pair passes only
    // where ov - m <= e (kvq_hit_extract checks that the clamped terms
    // compare as the true ones).  So, in the warps with a passing pair,
    // each set bit's weight is its hit modes where the column is valid and
    // the read not empty: the read's length from the row terms, and the
    // column's d, seql and valid, loaded in that lane alone (a read passes
    // a template or two: loads in the passing lanes cost less than staging
    // three more words for every column of every group).  The pairs with w
    // > 0 are written by claim; the slot is released after its group's
    // last stage.  No list, no recount, no warp per pair, and no
    // accumulator read outside the screen.
    __device__ __forceinline__ void hits(const int (&acc)[NACC],
                                         const Stage& st)
    {
        long long c0 = clk();
        const int set = st.rt & 1;
        // the pair of acc[4 j + 2 h + e] at bit 16 e + 2 (j % 8) + h of
        // word j / 8 (pair_of)
        uint32_t pm[2] = {0u, 0u};
        pass_bits(acc, st, [&](int j, int h, uint32_t p) {
            pm[j / 8] |= p << (2 * (j % 8) + h);
        });
        if (PROF) {
            const long long c1 = clk();
            pt[PROF_SCREEN] += c1 - c0;
            c0 = c1;
        }
        if (__any_sync(0xFFFFFFFFu, (pm[0] | pm[1]) != 0u)) {
            const int* qm = a.qmeta;
            const int Qp = a.Qp;
            const int qs = st.g * GC + st.k / R * SPAN + st.k % R;
            u64 hit = 0;     // the bits of pm whose pairs have w > 0
            for (u64 b = pm[0] | (u64)pm[1] << 32; b; b &= b - 1) {
                const int p = __ffsll((long long)b) - 1;
                int c, h;
                pair_of(p, c, h);
                const int q = qs + R * c;
                const int rl = sh.row_rl[set][acc_read(warp, g8, h)];
                int ov;
                if (rl > 0 && qm[ROW_VALID * Qp + q] > 0
                        && mode_bits(rl, qm[ROW_D * Qp + q],
                                     qm[ROW_SEQL * Qp + q], a.minoverlap,
                                     ov) > 0)
                    hit |= 1ull << p;
            }
            claim(hit, qs, set);
        }
        if (PROF) {
            const long long c1 = clk();
            pt[PROF_DRAIN] += c1 - c0;
            c0 = c1;
        }
        if (st.release) {
            wg_sync(wg);     // the terms are read
            if (wtid == 0)
                mbar_arrive(&sh.empty[st.slot]);
        }
        if (PROF)
            pt[PROF_WAIT] += clk() - c0;
    }

    // the pair of bit p of H1's pass bits (hits): MMA column c (acc[4 (c /
    // 8) + 2 h + c % 2]) of read acc_read(warp, g8, h)
    __device__ __forceinline__ void pair_of(int p, int& c, int& h) const
    {
        c = 8 * (8 * (p >> 5) + (p >> 1 & 7)) + 2 * t + (p >> 4 & 1);
        h = p & 1;
    }

    // H1: the triplets (row id, template, d) of this thread's pairs with
    // w > 0 (the set bits of hit, pair_of's pairs, at shift column qs +
    // R c, of row terms set) in slots of the buffer claimed with one
    // atomicAdd on the counter per warp (each lane's first slot: the
    // warp's base plus its count of triplets in the lanes before it); a
    // slot at or past outcap is counted, not written
    __device__ __forceinline__ void claim(u64 hit, int qs, int set)
    {
        const int nh = __popcll(hit);
        int pre = nh;    // the warp's inclusive prefix sum
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const int v = __shfl_up_sync(0xFFFFFFFFu, pre, o);
            if (lane >= o)
                pre += v;
        }
        const int total = __shfl_sync(0xFFFFFFFFu, pre, 31);
        if (total == 0)
            return;
        int base = 0;
        if (lane == 31)
            base = atomicAdd(a.nout, total);
        int slot = __shfl_sync(0xFFFFFFFFu, base, 31) + pre - nh;
        for (; hit && slot < a.outcap; hit &= hit - 1, ++slot) {
            int c, h;
            pair_of(__ffsll((long long)hit) - 1, c, h);
            const int q = qs + R * c;
            const int row = sh.row_id[set][acc_read(warp, g8, h)];
            int32_t* o = a.out + 3 * (size_t)slot;
            o[0] = a.row_ids ? a.row_ids[row] : row;
            o[1] = a.tseg[q];
            o[2] = a.qmeta[ROW_D * a.Qp + q];
        }
    }

    // the screen of stage st, its accumulators in acc, as K1 and H1 take
    // it: the screen of finish_pairs with k = e + 1 moved into its terms,
    // so that a pair passes where its count plus them is at least 1:
    // clamped to 0 or 1, that is its pass bit, two columns a DPX
    // instruction.  bits(j, h, p) takes the pass bits p of acc[4 j + 2 h]
    // (low half) and acc[4 j + 2 h + 1] (high half).
    template <class Bits>
    __device__ __forceinline__ void pass_bits(const int (&acc)[NACC],
                                              const Stage& st, Bits&& bits)
    {
        const uint4* terms = reinterpret_cast<const uint4*>(
            slots + st.slot * lay.slot_bytes + R * lay.win) + st.k * 64;
        const int set = st.rt & 1;
        const int k = a.maxerrors + 1;
        const uint32_t k2 = (uint32_t)k * 0x10001u;
        uint32_t nrl2[2], nrlmo2[2];     // k minus the row terms
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int r = acc_read(warp, g8, h);
            const int rl = min(sh.row_rl[set][r], 16383);
            const int rlmo = min(sh.row_rlmo[set][r], 16383);
            nrl2[h] = (uint32_t)((k - rl) & 0xFFFF) * 0x10001u;
            nrlmo2[h] = (uint32_t)((k - rlmo) & 0xFFFF) * 0x10001u;
        }
#pragma unroll
        for (int j = 0; j < NACC / 4; ++j) {
            const uint4 tm = terms[4 * j + t];
            const uint32_t ovc = __viaddmin_s16x2(tm.y, k2, 0x7FFF7FFFu);
            const uint32_t sq = __viaddmin_s16x2(tm.z, k2, 0x7FFF7FFFu);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const uint32_t a2 = __byte_perm(acc[4 * j + 2 * h],
                                                acc[4 * j + 2 * h + 1],
                                                0x5410);
                // k minus max(min(rl + dm, ovc), min(rlmo, seql))
                const uint32_t nthr = __viaddmin_s16x2(
                    __viaddmax_s16x2(nrl2[h], tm.x, ovc), 0u,
                    __viaddmax_s16x2(nrlmo2[h], 0u, sq));
                bits(j, h, __viaddmin_s16x2_relu(a2, nthr, 0x00010001u));
            }
        }
    }

    // K1's drain of stage st, its accumulators in acc: the stage's pass
    // bits (pass_bits) of each of this thread's two reads added to cnt,
    // the counts flushed first when the row tile changes, and the release
    // of the slot after its group's last stage
    __device__ __forceinline__ void count(const int (&acc)[NACC],
                                          const Stage& st)
    {
        const long long c0 = clk();
        if (st.rt != cnt_rt) {
            flush_counts();
            cnt_rt = st.rt;
        }
        uint32_t pass[2] = {0u, 0u};    // pass bits summed in both halves
        pass_bits(acc, st, [&](int, int h, uint32_t p) { pass[h] += p; });
#pragma unroll
        for (int h = 0; h < 2; ++h)
            cnt[h] += (int)(pass[h] & 0xFFFFu) + (int)(pass[h] >> 16);
        if (st.release) {
            wg_sync(wg);     // the terms are read
            if (wtid == 0)
                mbar_arrive(&sh.empty[st.slot]);
        }
        if (PROF)
            pt[PROF_SCREEN] += clk() - c0;
    }

    // K1: the counts of row tile cnt_rt into out, one atomic per read (a
    // read's columns are in the four lanes of one quad), and back to zero
    __device__ __forceinline__ void flush_counts()
    {
        if (cnt_rt < 0)
            return;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            int m = cnt[h];
            m += __shfl_xor_sync(0xFFFFFFFFu, m, 1);
            m += __shfl_xor_sync(0xFFFFFFFFu, m, 2);
            const long b = (long)cnt_rt * TB + acc_read(warp, g8, h);
            if (t == 0 && m > 0 && b < n)
                atomicAdd(a.out + b, m);
            cnt[h] = 0;
        }
    }

    // the histogram's entries of the positions the stage's pairs touched
    // into basecount, one atomic each, and back to zero
    __device__ __forceinline__ void flush(int hbase, int i3)
    {
        const int hi = sh.hi[wg][i3];
        if (hi < 0)
            return;
        const int g0 = max(0, sh.lo[wg][i3] - (a.Lpad - 1));
        const int len = min(a.G - 1, hi) - g0 + 1;
        for (int idx = wtid; idx < 5 * len; idx += 128) {
            const int c = idx / len, gp = g0 + idx % len;
            uint32_t* cell = hist + c * lay.hp + (gp - hbase);
            const uint32_t v = *cell;
            if (v) {
                *cell = 0;
                atomicAdd(a.basecount + (size_t)c * a.G + gp, (u64)v);
            }
        }
    }

    __device__ __forceinline__ void wait_full(int slot)
    {
        const long long c0 = clk();
        mbar_wait(&sh.full[slot], phase);
        if (PROF)
            pt[PROF_WAIT] += clk() - c0;
    }

    // the MMAs of depth chunk ch of a stage into cur (from zero when ch is
    // 0: nothing but the MMAs defines an accumulator while the other set's
    // MMAs run, or ptxas serialises them, C7515), and their commit
    __device__ __forceinline__ void mma(int (&cur)[NACC], const uint8_t* win,
                                        int ch)
    {
        long long c0 = clk();
        const int ks0 = ch * lay.akc / 2;
        const int nks = min(lay.akc, lay.dp / 16 - ch * lay.akc) / 2;
        turn_wait(wg);
        if (PROF) {
            const long long c1 = clk();
            pt[PROF_WAIT] += c1 - c0;
            c0 = c1;
        }
        fence_acc(cur);
        wgmma_fence();
        for (int ks = 0; ks < nks; ++ks) {
            const uint64_t da = make_desc(
                As + 2 * ks * KSTRIDE + wg * 64 * 16, KSTRIDE, 128);
            const uint64_t db = make_desc(win + 32 * (ks0 + ks), 16, 128);
            wgmma_n128(cur, da, db, ch > 0 || ks > 0);
        }
        wgmma_commit();
        turn_pass(wg);
        if (PROF)
            pt[PROF_MMA] += clk() - c0;
    }

    // stage L (the next stage, nx) into cur, after waiting for its group;
    // then the previous stage, pv in prv, is finished while cur's MMAs
    // run, and the step ends with nothing in flight.  No MMA group
    // outlives its step and every branch is warp-uniform: ptxas serialises
    // the MMAs otherwise (C7514, C7520).  Where A changes (a new row tile;
    // every stage when the depth takes chunks) it is rebuilt first, the
    // previous stage keeping its row terms (the other set) for its finish.
    __device__ __forceinline__ void step(int (&cur)[NACC], int (&prv)[NACC],
                                         int L, Stage& pv)
    {
        const bool first = L == s0;
        Stage st = nx;
        if (!first && st.k == 0 && ++st.slot == NSLOT) {
            st.slot = 0;
            phase ^= 1;
        }
        // the group's copies land while A is built
        const bool wait = first || st.k == 0;
        st.release = st.k == NSTAGE - 1 || L == s1 - 1;
        const uint8_t* win = slots + st.slot * lay.slot_bytes
            + (st.k % R) * lay.win + SP * SPAN * (st.k / R);
        if (lay.nchunks > 1 || st.rt != a_rt) {
            for (int ch = 0; ch < lay.nchunks; ++ch) {
                if (ch > 0) {
                    const long long c1 = clk();
                    wgmma_wait<0>();
                    fence_acc(cur);
                    if (PROF)
                        pt[PROF_MMA] += clk() - c1;
                }
                rebuild(st.rt, ch, ch == 0 && st.rt != rows_rt);
                if (ch == 0 && wait)
                    wait_full(st.slot);
                mma(cur, win, ch);
            }
            rows_rt = a_rt = st.rt;
        } else {
            if (wait)
                wait_full(st.slot);
            mma(cur, win, 0);
        }
        if (!first)
            finish(prv, pv);
        const long long c0 = clk();
        wgmma_wait<0>();
        fence_acc(cur);
        if (PROF)
            pt[PROF_MMA] += clk() - c0;
        pv = st;
        // the stage after L
        nx = st;
        nx.i3 = st.i3 == 2 ? 0 : st.i3 + 1;
        if (++nx.k == NSTAGE) {
            nx.k = 0;
            if (++nx.g == ngroups) {
                nx.g = 0;
                ++nx.rt;
            }
        }
    }

    __device__ __forceinline__ void run()
    {
        const long long start = clk();
        if (s0 < s1) {
            if (wg == 1)
                turn_pass(1);     // warpgroup 0 issues first
            int acc0[NACC], acc1[NACC];
            Stage pv = {};
            for (int L = s0; L < s1; L += 2) {
                step(acc0, acc1, L, pv);
                if (L + 1 < s1)
                    step(acc1, acc0, L + 1, pv);
            }
            if ((s1 - 1 - s0) % 2 == 0)
                finish(acc0, pv);
            else
                finish(acc1, pv);
            if constexpr (MODE == DRAIN_COUNT)
                flush_counts();
            if (wg == 0)
                turn_wait(0);     // warpgroup 1's last pass
        }
        if (PROF && wtid == 0) {
            pt[PROF_TOTAL] = clk() - start;
            for (int i = 0; i <= PROF_TOTAL; ++i)
                atomicAdd(reinterpret_cast<u64*>(a.prof) + i, (u64)pt[i]);
        }
    }
};

// one block's walk: the producer warp or a consumer warpgroup
template <int SP, bool PROF, int MODE>
__device__ __forceinline__ void block_run(const Args& a, const Layout& lay,
                                          uint8_t* smem, Shared& sh)
{
    constexpr int R = 16 / SP;
    const int tid = threadIdx.x;
    // ranks at or past the count are never read; the count, the range and
    // the role are warp-uniform, as the compiler can see (a branch it
    // takes for divergent serialises the MMAs)
    const int n = __shfl_sync(0xFFFFFFFFu,
                              a.count ? min(max(*a.count, 0), a.cap) : a.cap,
                              0);
    const int role = __shfl_sync(0xFFFFFFFFu, tid >> 7, 0);
    const int ngroups = (a.Qp + GC - 1) / GC;
    const long total = (long)((n + TB - 1) / TB) * ngroups * NSTAGE;
    const int s0 = (int)(total * blockIdx.x / gridDim.x);
    const int s1 = (int)(total * (blockIdx.x + 1) / gridDim.x);

    if (tid == 0) {
        for (int i = 0; i < NSLOT; ++i) {
            mbar_init(&sh.full[i], 1);
            mbar_init(&sh.empty[i], NCW);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    if (tid < NCW * 3) {
        sh.list_n[tid / 3][tid % 3] = 0;
        sh.lo[tid / 3][tid % 3] = INT_BIG;
        sh.hi[tid / 3][tid % 3] = -1;
    }
    uint32_t* hist = reinterpret_cast<uint32_t*>(smem + lay.hist_off);
    for (int i = tid; i < NCW * 5 * lay.hp; i += NTHREADS)
        hist[i] = 0;
    __syncthreads();

    if (role == NCW) {
        // the producer: one warp waits for a free slot, its first thread
        // stages each group of the block's range into it
        asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
        if (__shfl_sync(0xFFFFFFFFu, tid >> 5, 0) != 4 * NCW)
            return;      // one warp waits, its first thread copies
        const bool lead = tid == 128 * NCW;
        long long stage = 0, waited = 0;
        int slot = 0, phase = 0;
        for (int L = s0; L < s1; L = (L / NSTAGE + 1) * NSTAGE) {
            const int g = L / NSTAGE % ngroups;
            const long long c0 = PROF ? clock64() : 0;
            mbar_wait(&sh.empty[slot], phase ^ 1);
            const long long c1 = PROF ? clock64() : 0;
            if (lead) {
                uint8_t* dst = smem + lay.slot_off + slot * lay.slot_bytes;
                mbar_arrive_tx(&sh.full[slot], R * lay.win + TERM_BYTES);
                for (int s = 0; s < R; ++s)
                    bulk_copy(dst + s * lay.win,
                              a.onehot + s * a.onb + (long)SP * GC * g,
                              lay.win, &sh.full[slot]);
                bulk_copy(dst + R * lay.win,
                          a.sterms + (long)g * NSTAGE * 64, TERM_BYTES,
                          &sh.full[slot]);
            }
            __syncwarp();
            if (PROF) {
                waited += c1 - c0;
                stage += clock64() - c1;
            }
            if (++slot == NSLOT) {
                slot = 0;
                phase ^= 1;
            }
        }
        if (PROF && lead) {
            atomicAdd(reinterpret_cast<u64*>(a.prof) + PROF_STAGE,
                      (u64)stage);
            atomicAdd(reinterpret_cast<u64*>(a.prof) + PROF_STAGE_WAIT,
                      (u64)waited);
        }
    } else {
        asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
        Consumer<SP, PROF, MODE> c(a, lay, sh, smem, s0, s1, n, ngroups);
        c.run();
    }
}

typedef void (*Kernel)(Args, Layout);

// launch one of the kernels (which: its index among the source's
// instantiations, mode: its drain) on one block per SM of the current
// device, a persistent grid; the arguments' own checks are the callers'.
// Returns the CUDA error code of the launch.
int launch(Kernel kernel, int which, const Args& a, int SP, int cap,
           int mode, void* stream)
{
    const Layout lay = make_layout(SP, a.Lpad, mode);
    // the stages are counted in int
    const long stages = ((long)cap + TB - 1) / TB * ((a.Qp + GC - 1) / GC)
        * NSTAGE;
    if (lay.bytes == 0 || stages > 0x7FFFFFFFL)
        return (int)cudaErrorInvalidValue;
    // per device: its SM count, and the dynamic shared memory each
    // instantiation may use (above the 48 KB default), set once
    constexpr int MAXDEV = 64, NKERNEL = 8;
    static int sms_of[MAXDEV], smem_of[MAXDEV][NKERNEL];
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess)
        return (int)err;
    if (dev >= MAXDEV)
        return (int)cudaErrorInvalidDevice;
    if (!sms_of[dev]) {
        err = cudaDeviceGetAttribute(
            &sms_of[dev], cudaDevAttrMultiProcessorCount, dev);
        if (err != cudaSuccess)
            return (int)err;
    }
    if (smem_of[dev][which] < lay.bytes) {
        err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, lay.bytes);
        if (err != cudaSuccess)
            return (int)err;
        smem_of[dev][which] = lay.bytes;
    }
    kernel<<<sms_of[dev], NTHREADS, lay.bytes, (cudaStream_t)stream>>>(a, lay);
    return (int)cudaGetLastError();
}

}  // namespace

#endif  // KVQ_S1_PIPELINE_H
