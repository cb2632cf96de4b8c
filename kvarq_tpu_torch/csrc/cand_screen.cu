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
// MMAs (wgmma s8 -> s32), built in shared memory from the read codes and
// the bank bytes (kvq_onehot_mma.h, shared with score_step.cu): a block
// of 256 threads (two warpgroups of 64 reads, two blocks per SM) covers
// 128 reads, whose one-hot tile serves QT = 8 column tiles of 128 in turn.
// Epilogue: once a tile's MMAs are complete (reading an accumulator
// while any MMA is in flight makes ptxas serialise them all), the
// accumulators are screened in their fragment layout against
// per-column terms in shared memory; the columns of a read live in the
// four lanes of one quad, so one shuffle sum gives the read's count in
// the tile, and one atomicAdd per read and tile adds it to out.  The
// other block on the SM keeps the tensor cores busy meanwhile.
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

#include "kvq_onehot_mma.h"

#ifndef KVQ_SRC_HASH
#define KVQ_SRC_HASH "unknown"
#endif

namespace {

using namespace kvq;

constexpr int SMEM = MMA_SMEM;

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
    constexpr int R = Tile<SP>::R;
    constexpr int NACC = Tile<SP>::NACC;
    extern __shared__ __align__(128) uint8_t smem[];
    uint8_t* As = smem;
    uint32_t* Bw = reinterpret_cast<uint32_t*>(smem + A_BYTES);
    __shared__ int col_dm[TQ], col_ovc[TQ], col_seql[TQ];
    __shared__ int row_rl[TB], row_rlmo[TB], row_id[TB];

    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t = lane & 3;
    const int wg = warp >> 2;
    const int b0 = blockIdx.y * TB;
    const int ntiles = min(QT, (Qp + TQ - 1) / TQ - blockIdx.x * QT);

    if (tid >= TQ) {
        const int r = tid - TQ;
        const bool in = b0 + r < B;
        row_id[r] = in ? b0 + r : -1;
        row_terms(row_rl, row_rlmo, r, in ? rl[b0 + r] : 0, maxerrors,
                  minoverlap);
    }
    __syncthreads();
    int rlv[2], rlmo_e[2];
    for (int h = 0; h < 2; ++h) {
        rlv[h] = row_rl[acc_read(warp, g, h)];
        rlmo_e[h] = row_rlmo[acc_read(warp, g, h)];
    }

    for (int tile = 0; tile < ntiles; ++tile) {
        const int q0 = (blockIdx.x * QT + tile) * TQ;
        column_terms(col_dm, col_ovc, col_seql, qmeta, Qp, q0, maxerrors,
                     tid);
        int acc[R][NACC];
        tile_products<SP>(acc, As, Bw, codes, row_id, Lpad, bank, nb, q0,
                          tile > 0, tid, wg);
        // no MMA is in flight: reading the accumulators does not
        // serialise the next tile's MMAs
        int n[2] = {0, 0};
#pragma unroll
        for (int s = 0; s < R; ++s)
            screen<R, NACC>(acc[s], s, t, rlv, rlmo_e, col_dm, col_ovc,
                            col_seql, [&](int h, int) { ++n[h]; });

#pragma unroll
        for (int h = 0; h < 2; ++h) {
            // a read's columns are in the four lanes 4g .. 4g + 3
            int m = n[h];
            m += __shfl_xor_sync(0xFFFFFFFFu, m, 1);
            m += __shfl_xor_sync(0xFFFFFFFFu, m, 2);
            const int r = acc_read(warp, g, h);
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
