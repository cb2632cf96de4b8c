// The one-hot match product of the exhaustive scan on Hopper tensor cores
// (sm_90a), shared by the candidate screen (cand_screen.cu, K1) and the
// exact scoring (score_step.cu, S1).
//
// For a block of TB = 128 reads and a tile of TQ = 128 shift columns it
// computes
//
//     matches[r, q] = sum_j [r[j] < nch  and  r[j] == bank[q + j]]
//
// (bank: the padded bank bytes of pallas_scan._kernel_bytes, codes >= nch
// replaced by a sentinel; read codes >= nch one-hot to the zero vector)
// as asynchronous warpgroup MMAs (wgmma, s8 x s8 -> s32; exact, counts <=
// Lpad), both operands K-major in shared memory (8-bit wgmma takes no
// other layout), no swizzle.  Neither operand exists in device memory.
// The depth is position-major, SP bytes per read position: SP = 4 for
// nch 4 (the A, C, G, T indicator bytes), SP = 8 for nch 5 (A, C, G, T, N
// and three zero bytes).
//
// - A (reads): two warpgroups of 64 reads; their codes are expanded into
//   the int8 one-hot tile, 16-byte K columns one padded row apart (the
//   building stores do not collide).  The reads are given as a row map in
//   shared memory (row_id[r] < 0: an empty row), so the same code serves
//   a contiguous block of the batch and a gathered list of rows.
// - B (bank): column q at depth byte d reads the one-hot byte of bank
//   position q + d / SP: a Toeplitz matrix, row n + 1 is row n moved by SP
//   bytes.  wgmma's core matrices want rows 16 bytes apart, so the 128
//   columns of a tile are R = 16 / SP residues: residue s is a window of
//   the one-hot bank moved by s positions, its row n' (column R n' + s)
//   starting 16 n' bytes in, all rows overlapping.  Per k32 step a
//   warpgroup issues R MMAs of m64 n(128 / R) k32 against the R windows;
//   the windows take 4 KB where a materialised tile would take 64 KB.
// - Depth longer than 512 bytes (Lpad > 128 with nch 4, > 64 with nch 5)
//   runs in slabs of 512 bytes, the A tile rebuilt per slab and column
//   tile; padding to whole k32 steps is zero, so every Lpad (a multiple
//   of 4) works.
// - The accumulators are read only once every MMA of the tile is
//   complete: reading one while any MMA is in flight makes ptxas
//   serialise them all.  acc[s][4 j + 2 h + e] is read 64 wg + 16 (warp %
//   4) + g + 8 h of the block and tile column R (8 j + 2 t + e) + s, with
//   g = lane / 4, t = lane % 4 (see acc_read / acc_col).

#ifndef KVQ_ONEHOT_MMA_H
#define KVQ_ONEHOT_MMA_H

#include <cuda_runtime.h>
#include <stdint.h>

namespace kvq {

// qmeta rows (kvarq_tpu_torch/engine/pallas_scan.py ROW_*)
constexpr int ROW_D = 0, ROW_SEQL = 1, ROW_VALID = 2, ROW_DM = 3, ROW_OVC = 4;
constexpr int BIG_RL_THRESHOLD = 1 << 20;
// column terms past Qp: a threshold no count reaches
constexpr int NEVER = 1 << 29;
// bank bytes past the bank: match nothing
constexpr uint32_t BANK_SENTINEL = 0xFE;

constexpr int TB = 128;            // reads per block: two warpgroups of m64
constexpr int TQ = 128;            // shift columns per tile
constexpr int NT = 256;
constexpr int QT = 8;              // column tiles per block
constexpr int SLAB = 512;          // depth bytes per slab: 16 k32 steps
constexpr int KSTRIDE = TB * 16 + 16;   // bytes between A's K columns
constexpr int A_BYTES = SLAB / 16 * KSTRIDE;
// one residue window: 128 / R rows 16 bytes apart, plus a slab
constexpr int WIN_BYTES_4 = 16 * (TQ / 4) + SLAB;    // SP 4: R = 4
constexpr int WIN_BYTES_8 = 16 * (TQ / 2) + SLAB;    // SP 8: R = 2
constexpr int B_BYTES = 4 * WIN_BYTES_4 > 2 * WIN_BYTES_8
    ? 4 * WIN_BYTES_4 : 2 * WIN_BYTES_8;
// the dynamic shared memory of the product: the A tile and the windows
constexpr int MMA_SMEM = A_BYTES + B_BYTES;

static_assert(NT == TQ + TB, "one set-up thread per column and per read");

// residues, MMA columns per residue and accumulators per residue and thread
template <int SP> struct Tile {
    static constexpr int R = 16 / SP;
    static constexpr int NR = TQ / R;
    static constexpr int NACC = NR / 2;
    static constexpr int WORDS = (16 * NR + SLAB) / 4;
};

// the block row of accumulator h of this thread
__device__ __forceinline__ int acc_read(int warp, int g, int h)
{
    return (warp >> 2) * 64 + (warp & 3) * 16 + g + 8 * h;
}

// the tile column of accumulator (j, e) of residue s
template <int R>
__device__ __forceinline__ int acc_col(int j, int t, int e, int s)
{
    return R * (8 * j + 2 * t + e) + s;
}

__device__ __forceinline__ uint32_t onehot4(uint32_t c)
{
    return c < 4u ? 1u << (8u * c) : 0u;
}

__device__ __forceinline__ uint32_t bank_byte(const uint8_t* __restrict__ bank,
                                              long nb, long i)
{
    return i < nb ? (uint32_t)__ldg(bank + i) : BANK_SENTINEL;
}

// shared-memory matrix descriptor, no swizzle: start, leading byte offset
// (between the two 16-byte K halves of a k32 step), stride byte offset
// (between 8-row core matrices)
__device__ __forceinline__ uint64_t make_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo)
{
    const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
    return (uint64_t)((a >> 4) & 0x3FFFu)
        | ((uint64_t)((lbo >> 4) & 0x3FFFu) << 16)
        | ((uint64_t)((sbo >> 4) & 0x3FFFu) << 32);
}

// d += A (64 x 32) * B (32 x 32), both K-major in shared memory, s8 -> s32
__device__ __forceinline__ void wgmma_n32(int (&d)[16], uint64_t da,
                                          uint64_t db)
{
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p;\n"
        "}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
        : "l"(da), "l"(db), "r"(1));
}

// d += A (64 x 32) * B (32 x 64), both K-major in shared memory, s8 -> s32
__device__ __forceinline__ void wgmma_n64(int (&d)[32], uint64_t da,
                                          uint64_t db)
{
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p;\n"
        "}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
        : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_fence()
{
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit()
{
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait()
{
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// generic-proxy stores to shared memory, made visible to the MMAs
__device__ __forceinline__ void fence_proxy_async()
{
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// keep the compiler from moving an accumulator across the async MMAs
template <int N>
__device__ __forceinline__ void fence_acc(int (&d)[N])
{
#pragma unroll
    for (int i = 0; i < N; ++i)
        asm volatile("" : "+r"(d[i]) :: "memory");
}

// the A tile of one slab: K column v (depth bytes 16 v .. of the slab) of
// block row r at v * KSTRIDE + 16 r, from the code words of batch row
// row_id[r] (zero where row_id[r] < 0)
template <int SP>
__device__ __forceinline__ void build_a(
    uint8_t* As, const uint32_t* __restrict__ codes, const int* row_id,
    int Lpad, int d0, int kcols, int tid)
{
    const int lw = Lpad / 4;
    for (int idx = tid; idx < TB * kcols; idx += NT) {
        const int r = idx / kcols, v = idx % kcols;
        const int p = (d0 + 16 * v) / SP;     // first position
        const int row = row_id[r];
        uint4 a = make_uint4(0u, 0u, 0u, 0u);
        if (row >= 0 && p < Lpad) {
            const uint32_t x = __ldg(codes + (size_t)row * lw + p / 4);
            if (SP == 4) {
                // four positions
                a.x = onehot4(x & 0xFFu);
                a.y = onehot4((x >> 8) & 0xFFu);
                a.z = onehot4((x >> 16) & 0xFFu);
                a.w = onehot4(x >> 24);
            } else {
                // two positions (p even): A C G T, N 0 0 0 each
                const uint32_t c0 = (x >> (8 * (p % 4))) & 0xFFu;
                const uint32_t c1 = (x >> (8 * (p % 4) + 8)) & 0xFFu;
                a = make_uint4(onehot4(c0), c0 == 4u ? 1u : 0u,
                               onehot4(c1), c1 == 4u ? 1u : 0u);
            }
        }
        *reinterpret_cast<uint4*>(As + v * KSTRIDE + 16 * r) = a;
    }
}

// the R residue windows of one column tile and slab: window s, word a
// (depth bytes 4 a ..) is the one-hot of bank position p0 + 4 a / SP + s
template <int SP>
__device__ __forceinline__ void build_b(
    uint32_t* Bw, const uint8_t* __restrict__ bank, long nb, long p0,
    int tid)
{
    constexpr int R = Tile<SP>::R;
    constexpr int WORDS = Tile<SP>::WORDS;
    for (int idx = tid; idx < R * WORDS; idx += NT) {
        const int s = idx / WORDS, a = idx % WORDS;
        if (SP == 4) {
            Bw[idx] = onehot4(bank_byte(bank, nb, p0 + a + s));
        } else {
            const uint32_t c = bank_byte(bank, nb, p0 + a / 2 + s);
            Bw[idx] = a % 2 == 0 ? onehot4(c) : (c == 4u ? 1u : 0u);
        }
    }
}

// acc = the match counts of the block's reads (row_id) against the column
// tile at q0, over every slab.  The A tile is kept from the previous
// column tile when the depth is one slab and keep_a is set.  Every thread
// of the block calls it; it ends with no MMA in flight and the block
// synchronised, and it synchronises the block after the builds (so
// shared terms written before the call are visible after it).
template <int SP>
__device__ __forceinline__ void tile_products(
    int (&acc)[Tile<SP>::R][Tile<SP>::NACC], uint8_t* As, uint32_t* Bw,
    const uint32_t* __restrict__ codes, const int* row_id, int Lpad,
    const uint8_t* __restrict__ bank, long nb, int q0, bool keep_a,
    int tid, int wg)
{
    constexpr int R = Tile<SP>::R;
    constexpr int NACC = Tile<SP>::NACC;
    constexpr int WORDS = Tile<SP>::WORDS;
    const int depth = SP * Lpad;
    const int nslabs = (depth + SLAB - 1) / SLAB;
#pragma unroll
    for (int s = 0; s < R; ++s)
#pragma unroll
        for (int i = 0; i < NACC; ++i)
            acc[s][i] = 0;

    for (int slab = 0; slab < nslabs; ++slab) {
        const int d0 = slab * SLAB;
        const int ksteps = (min(SLAB, depth - d0) + 31) / 32;
        if (!keep_a || nslabs > 1)
            build_a<SP>(As, codes, row_id, Lpad, d0, 2 * ksteps, tid);
        build_b<SP>(Bw, bank, nb, (long)q0 + d0 / SP, tid);
        fence_proxy_async();
        __syncthreads();

#pragma unroll
        for (int s = 0; s < R; ++s)
            fence_acc(acc[s]);
        wgmma_fence();
#pragma unroll
        for (int s = 0; s < R; ++s) {
            for (int ks = 0; ks < ksteps; ++ks) {
                const uint64_t da = make_desc(
                    As + 2 * ks * KSTRIDE + wg * 64 * 16, KSTRIDE, 128);
                const uint64_t db = make_desc(
                    Bw + s * WORDS + 8 * ks, 16, 128);
                if constexpr (SP == 4)
                    wgmma_n32(acc[s], da, db);
                else
                    wgmma_n64(acc[s], da, db);
            }
        }
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int s = 0; s < R; ++s)
            fence_acc(acc[s]);
        __syncthreads();   // the tiles are read before they change
    }
}

// per-column screen terms of the tile at q0 into shared memory (threads
// tid < TQ; the screen of cand_screen.cu, module docstring of
// kvarq_tpu/engine/pallas_scan.py)
__device__ __forceinline__ void column_terms(
    int* col_dm, int* col_ovc, int* col_seql,
    const int32_t* __restrict__ qmeta, int Qp, int q0, int maxerrors,
    int tid)
{
    if (tid >= TQ)
        return;
    const int q = q0 + tid;
    if (q < Qp) {
        col_dm[tid] = qmeta[ROW_DM * Qp + q] - maxerrors;
        col_ovc[tid] = qmeta[ROW_OVC * Qp + q] - maxerrors;
        col_seql[tid] = qmeta[ROW_VALID * Qp + q] > 0
            ? qmeta[ROW_SEQL * Qp + q] - maxerrors
            : BIG_RL_THRESHOLD;
    } else {
        col_dm[tid] = col_ovc[tid] = col_seql[tid] = NEVER;
    }
}

// per-read screen terms of block row r (threads tid >= TQ): its read
// length and min(rl, mo) - e, BIG_RL_THRESHOLD - e for an empty row
__device__ __forceinline__ void row_terms(
    int* row_rl, int* row_rlmo, int r, int v, int maxerrors, int minoverlap)
{
    row_rl[r] = v;
    row_rlmo[r] = (v > 0 ? min(v, minoverlap) : BIG_RL_THRESHOLD)
        - maxerrors;
}

// the sound candidate screen of residue s's accumulators (every pair
// with a hit-mode weight above 0 passes it): pass(h, col) for each pair
// that passes, read h of this thread (row_terms' rlv, rlmo_e) at tile
// column col (column_terms' col_*)
template <int R, int NACC, class Pass>
__device__ __forceinline__ void screen(
    const int (&acc)[NACC], int s, int t, const int (&rlv)[2],
    const int (&rlmo_e)[2], const int* col_dm, const int* col_ovc,
    const int* col_seql, Pass&& pass)
{
#pragma unroll
    for (int j = 0; j < NACC / 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            const int col = acc_col<R>(j, t, e, s);
            const int dm = col_dm[col], ovc = col_ovc[col];
            const int seql = col_seql[col];
#pragma unroll
            for (int h = 0; h < 2; ++h)
                if (acc[4 * j + 2 * h + e]
                        >= max(min(rlv[h] + dm, ovc), min(rlmo_e[h], seql)))
                    pass(h, col);
        }
}

}  // namespace kvq

#endif  // KVQ_ONEHOT_MMA_H
