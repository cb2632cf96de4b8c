// Candidate screen of the exhaustive scan, on Hopper tensor cores (sm_90a).
//
// Replaces kvarq_tpu/engine/pallas_scan.py::_cand_kernel (the one Pallas
// TPU kernel, launched by match_cand_call).  For every read b and every
// shift column q of the template bank it counts the matching bases
//
//     matches[b, q] = sum_j [r[b, j] < nch  and  r[b, j] == bank[q - (Lpad-1) + j]]
//
// -- the one-hot product read_flat @ K of the TPU kernel, since codes
// >= nch one-hot to the zero vector -- and applies the same sound screen
// in int32 (every threshold is an integer < 2^21, so this equals the TPU
// kernel's f32 compares bit for bit):
//
//     matches >= max(min(rl + dm - e, ovc - e),
//                    min((rl > 0 ? min(rl, mo) : 2^20) - e,
//                        valid ? seql - e : 2^20))
//
// Output: out[b] += number of passing columns (the caller zeroes out; a
// read is a candidate iff out[b] > 0).  The [B, Q] match tensor never
// leaves registers.
//
// What bounds it: the product is 2 * B * Lpad * nch * Qp operations
// (6.7e11 for one 16,384-read MTBC batch at Lpad 128, nch 4), against a
// few MB of inputs (uint8 codes, the padded bank bytes, the int32 column
// metadata): compute-bound by a factor above 100.  0/1 one-hots are exact
// in int8, so the least time is that product at the card's int8 tensor
// rate (1,979 TOP/s dense on an H100 SXM: 0.34 ms for that batch).
//
// Design.  The product runs on the tensor cores as asynchronous warpgroup
// MMAs (wgmma, s8 x s8 -> s32; exact, counts <= Lpad), both operands
// K-major in shared memory (8-bit wgmma takes no other layout), no
// swizzle.  Neither operand exists in device memory.  The depth is
// position-major, SP bytes per read position: SP = 4 for nch 4 (the A, C,
// G, T indicator bytes), SP = 8 for nch 5 (A, C, G, T, N and three zero
// bytes).
//
// - A (reads): a block of 256 threads (two warpgroups of 64 reads, two
//   blocks per SM) covers 128 reads; their codes are expanded once into
//   the int8 one-hot tile, 16-byte K columns one padded row apart (the
//   building stores do not collide), and the tile serves QT = 8 column
//   tiles of 128 in turn.
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
// - Epilogue: once a tile's MMAs are complete (reading an accumulator
//   while any MMA is in flight makes ptxas serialise them all), the
//   accumulators are screened in their fragment layout against
//   per-column terms in shared memory; the columns of a read live in the
//   four lanes of one quad, so one shuffle sum gives the read's count in
//   the tile, and one atomicAdd per read and tile adds it to out.  The
//   other block on the SM keeps the tensor cores busy meanwhile.
//
// On an H100 SXM at 700 W this takes about 1.1-1.2 ms for the batch
// above, 28-30% of the bound (chip_smoke.py phase [b]; PERF.md).  How that
// time splits between the MMAs and the one-hot builds and screen is not
// measured yet.  Overlapping the builds and the screen with the MMAs
// inside a block (warp specialisation, two accumulator sets), TMA and
// persistent blocks are left to later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (kvarq_tpu_torch/engine/native_cuda.py).

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef KVQ_SRC_HASH
#define KVQ_SRC_HASH "unknown"
#endif

namespace {

// qmeta rows (kvarq_tpu_torch/engine/pallas_scan.py ROW_*)
constexpr int ROW_SEQL = 1, ROW_VALID = 2, ROW_DM = 3, ROW_OVC = 4;
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
constexpr int SMEM = A_BYTES + B_BYTES;

static_assert(NT == TQ + TB, "one set-up thread per column and per read");

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
// read r at v * KSTRIDE + 16 r, from the reads' code words
template <int SP>
__device__ __forceinline__ void build_a(
    uint8_t* As, const uint32_t* __restrict__ codes, int B, int b0,
    int Lpad, int d0, int kcols, int tid)
{
    const int lw = Lpad / 4;
    for (int idx = tid; idx < TB * kcols; idx += NT) {
        const int r = idx / kcols, v = idx % kcols;
        const int p = (d0 + 16 * v) / SP;     // first position
        uint4 a = make_uint4(0u, 0u, 0u, 0u);
        if (b0 + r < B && p < Lpad) {
            const uint32_t x = __ldg(codes + (size_t)(b0 + r) * lw + p / 4);
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
    constexpr int R = 16 / SP;
    constexpr int WORDS = (16 * (TQ / R) + SLAB) / 4;
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

// the screen of residue s's accumulators: acc[4 j + 2 h + e] is read h of
// this thread, tile column R (8 j + 2 t + e) + s; passing columns are
// counted into n[h]
template <int R, int NACC>
__device__ __forceinline__ void screen(
    const int (&acc)[NACC], int s, int (&n)[2], const int (&rlv)[2],
    const int (&rlmo_e)[2], const int* col_dm, const int* col_ovc,
    const int* col_seql, int t)
{
#pragma unroll
    for (int j = 0; j < NACC / 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            const int col = R * (8 * j + 2 * t + e) + s;
            const int dm = col_dm[col], ovc = col_ovc[col];
            const int seql = col_seql[col];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int thr = max(min(rlv[h] + dm, ovc),
                                    min(rlmo_e[h], seql));
                n[h] += acc[4 * j + 2 * h + e] >= thr ? 1 : 0;
            }
        }
}

template <int SP>
__global__ void __launch_bounds__(NT, 2)
cand_screen_kernel(const uint32_t* __restrict__ codes,  // [B, Lpad/4]
                   const int32_t* __restrict__ rl,       // [B]
                   const uint8_t* __restrict__ bank,     // [nb]
                   long nb,
                   const int32_t* __restrict__ qmeta,    // [8, Qp]
                   int32_t* __restrict__ out,            // [B]
                   int B, int Lpad, int Qp,
                   int maxerrors, int minoverlap)
{
    constexpr int R = 16 / SP;           // residues
    constexpr int NR = TQ / R;           // MMA columns per residue
    constexpr int NACC = NR / 2;         // accumulators per residue
    constexpr int WORDS = (16 * NR + SLAB) / 4;
    extern __shared__ __align__(128) uint8_t smem[];
    uint8_t* As = smem;
    uint32_t* Bw = reinterpret_cast<uint32_t*>(smem + A_BYTES);
    __shared__ int col_dm[TQ], col_ovc[TQ], col_seql[TQ];
    __shared__ int row_rl[TB], row_rlmo[TB];

    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t = lane & 3;
    const int wg = warp >> 2;
    const int b0 = blockIdx.y * TB;
    const int depth = SP * Lpad;
    const int nslabs = (depth + SLAB - 1) / SLAB;
    const int ntiles = min(QT, (Qp + TQ - 1) / TQ - blockIdx.x * QT);

    if (tid >= TQ) {
        const int r = tid - TQ;
        const int v = b0 + r < B ? rl[b0 + r] : 0;
        row_rl[r] = v;
        row_rlmo[r] = (v > 0 ? min(v, minoverlap) : BIG_RL_THRESHOLD)
            - maxerrors;
    }

    // this thread's reads in the accumulator layout: 64 wg + 16 (warp % 4)
    // + g + 8 h
    const int r0 = wg * 64 + (warp & 3) * 16 + g;
    int rlv[2], rlmo_e[2];

    for (int tile = 0; tile < ntiles; ++tile) {
        const int q0 = (blockIdx.x * QT + tile) * TQ;
        if (tid < TQ) {
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

        int acc[R][NACC];
#pragma unroll
        for (int s = 0; s < R; ++s)
#pragma unroll
            for (int i = 0; i < NACC; ++i)
                acc[s][i] = 0;
        int n[2] = {0, 0};

        for (int slab = 0; slab < nslabs; ++slab) {
            const int d0 = slab * SLAB;
            const int ksteps = (min(SLAB, depth - d0) + 31) / 32;
            // one slab: the A tile is kept from the first column tile
            if (tile == 0 || nslabs > 1)
                build_a<SP>(As, codes, B, b0, Lpad, d0, 2 * ksteps, tid);
            build_b<SP>(Bw, bank, nb, (long)q0 + d0 / SP, tid);
            fence_proxy_async();
            __syncthreads();
            if (tile == 0 && slab == 0)
                for (int h = 0; h < 2; ++h) {
                    rlv[h] = row_rl[r0 + 8 * h];
                    rlmo_e[h] = row_rlmo[r0 + 8 * h];
                }

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
        // no MMA is in flight: reading the accumulators does not
        // serialise the next tile's MMAs
#pragma unroll
        for (int s = 0; s < R; ++s)
            screen<R, NACC>(acc[s], s, n, rlv, rlmo_e, col_dm, col_ovc,
                            col_seql, t);

#pragma unroll
        for (int h = 0; h < 2; ++h) {
            // a read's columns are in the four lanes 4g .. 4g + 3
            int m = n[h];
            m += __shfl_xor_sync(0xFFFFFFFFu, m, 1);
            m += __shfl_xor_sync(0xFFFFFFFFu, m, 2);
            const int r = r0 + 8 * h;
            if (t == 0 && m > 0 && b0 + r < B)
                atomicAdd(out + b0 + r, m);
        }
        __syncthreads();   // the column terms are read before they change
    }
}

}  // namespace

extern "C" {

const char* kvq_cuda_src_hash() { return KVQ_SRC_HASH; }

// codes: uint8 [B, Lpad] (Lpad % 4 == 0, 4-byte aligned), rl: int32 [B],
// bank: uint8 [4 * nbw] padded bank bytes (pallas_scan._kernel_bytes),
// qmeta: int32 [8, Qp], out: int32 [B] zeroed.  Returns the CUDA error
// code of the launch (0 on success).
int kvq_cand_screen(const void* codes, const void* rl, const void* bank,
                    int nbw, const void* qmeta, void* out,
                    int B, int Lpad, int Qp, int nch,
                    int maxerrors, int minoverlap, void* stream)
{
    if (B <= 0 || Qp <= 0)
        return 0;
    if (Lpad <= 0 || Lpad % 4 || (nch != 4 && nch != 5))
        return (int)cudaErrorInvalidValue;
    const int ntiles = (Qp + TQ - 1) / TQ;
    const dim3 grid((ntiles + QT - 1) / QT, (B + TB - 1) / TB);
    if (grid.y > 65535u)
        return (int)cudaErrorInvalidConfiguration;
    // above the 48 KB default: set for the current device at every launch
    auto kernel = nch == 4 ? cand_screen_kernel<4> : cand_screen_kernel<8>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess)
        return (int)err;
    kernel<<<grid, NT, SMEM, (cudaStream_t)stream>>>(
        (const uint32_t*)codes, (const int32_t*)rl, (const uint8_t*)bank,
        4L * nbw, (const int32_t*)qmeta, (int32_t*)out,
        B, Lpad, Qp, maxerrors, minoverlap);
    return (int)cudaGetLastError();
}

}  // extern "C"
