// Exact scoring of the exhaustive scan step, on Hopper tensor cores
// (sm_90a): S1.
//
// Not a port of a TPU kernel: it is the device work that kvarq_tpu leaves
// to XLA, score_full / score_gathered of
// kvarq_tpu/engine/pallas_scan.py::scan_step_banked (the match product,
// mode_weights, the contraction read5.T @ w and its diagonal fold).  For
// a list of rows of a batch (every row, or the compacted candidate rows
// rows[r] for r < *count, the count read from device memory) and every
// shift column q < Qp of the template bank it adds
//
//     (w, ov) = mode_weights(matches[b, q], rl[b], d[q], seql[q], valid[q])
//     seqhits[tseg[q]] += w,  seqbasehits[tseg[q]] += w * ov
//     basecount[c, g] += w  for every read position j with c = codes[b, j]
//                          < 5 and 0 <= g = q - (Lpad-1) + j < G
//
// in int64 atomics.  mode_weights is tensor_scan.mode_weights in integer
// arithmetic (every quantity is an integer below 2^21, so this equals the
// f32 form bit for bit); w is 0, 1 or 2 (the mode-B/D border duplicate).
// N bases (code 4) count in the coverage whatever the bank's channels;
// junk codes (5) and rows of read length 0 score nothing.  The card never
// holds the match counts, w or ov as tensors: nothing of size [B, Qp] is
// written.
//
// What bounds it: the product, 2 * rows * Lpad * nch * Qp operations
// (6.7e11 for a dense 16,384-read MTBC batch at Lpad 128, nch 4: 0.34 ms
// at the card's 1,979 TOP/s int8 rate), against a few MB of inputs and
// the pairs * Lpad coverage atomics.
//
// Design.  The product is K1's (kvq_onehot_mma.h: wgmma s8 -> s32 on the
// one-hot read tile and the shifted bank windows, two blocks of 128 reads
// per SM, slabs above 512 depth bytes).  K1's screen is sound per (read,
// column) pair: a pair with w > 0 passes it.  So the epilogue screens the
// accumulators in their fragment layout as K1 does and pushes each passing
// pair (block row, tile column; 2 bytes) into a list in shared memory with
// room for every pair of the tile, and the block then drains the list, one
// warp per pair: the match count again from the raw codes (one position
// per lane, a shuffle sum; Lpad compares, against the tile's Lpad * 128
// MMA columns), mode_weights, and the Lpad-long coverage loop.  Passing
// pairs are sparse (a read hits one or two templates at one or two
// shifts), so the registers hold no more than K1's.
//
// Rows: a block takes row tiles blockIdx.y, blockIdx.y + gridDim.y, ...
// while the tile starts below the count, so a grid sized for gather_k rows
// scores every candidate of a step that overflows it, and the host never
// reads the count.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (kvarq_tpu_torch/engine/native_cuda.py).

#include "kvq_onehot_mma.h"

#ifndef KVQ_SRC_HASH
#define KVQ_SRC_HASH "unknown"
#endif

namespace {

using namespace kvq;

typedef unsigned long long u64;

// the passing pairs of one column tile, (tile column << 7 | block row):
// room for every pair of the tile
constexpr int LIST_CAP = TB * TQ;
constexpr int SMEM = MMA_SMEM + 2 * LIST_CAP;
constexpr int NWARPS = NT / 32;

static_assert(TB == 128 && TQ == 128, "list entries hold 7-bit indices");

// hit-mode weight (0/1/2) and overlap ov of a read of length rl with m
// matching bases at a column (d, seql, valid): tensor_scan.mode_weights
__device__ __forceinline__ int mode_weight(int m, int rl, int d, int seql,
                                           int valid, int maxerrors,
                                           int minoverlap, int& ov)
{
    const int t1 = d + rl;
    ov = min(seql, t1) - max(d, 0);
    const bool ab = rl > minoverlap && seql > minoverlap;
    const bool govmo = ov >= minoverlap;
    const int wA = ab && d < 0 && govmo && ov != seql;
    const int wB = ab && d > 0 && govmo && t1 >= seql;
    const int full = ov == min(rl, seql);
    const bool passing = valid > 0 && rl > 0 && ov - m <= maxerrors;
    return passing ? wA + wB + full : 0;
}

// score the listed pairs of the column tile at q0, one warp per pair
template <int SP>
__device__ __forceinline__ void drain(
    const uint16_t* list, int nl, const int* row_id, const int* row_rl,
    const uint8_t* __restrict__ codes, const uint8_t* __restrict__ bank,
    long nb, const int32_t* __restrict__ qmeta,
    const int32_t* __restrict__ tseg, u64* basecount, u64* seqhits,
    u64* seqbasehits, int Lpad, int Qp, int G, int q0, int maxerrors,
    int minoverlap, int warp, int lane)
{
    constexpr uint32_t NCH = SP == 4 ? 4u : 5u;
    for (int k = warp; k < nl; k += NWARPS) {
        const int ent = list[k];
        const int r = ent & 127, q = q0 + (ent >> 7);
        const int row = row_id[r];
        if (row < 0)
            continue;     // an empty row passes where seql <= maxerrors
        const uint8_t* read = codes + (size_t)row * Lpad;
        // the match count, one read position per lane
        int m = 0;
        for (int j = lane; j < Lpad; j += 32) {
            const uint32_t c = read[j];
            m += c < NCH && c == bank_byte(bank, nb, (long)q + j) ? 1 : 0;
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
            m += __shfl_xor_sync(0xFFFFFFFFu, m, o);
        int ov;
        const int w = mode_weight(
            m, row_rl[r], qmeta[ROW_D * Qp + q], qmeta[ROW_SEQL * Qp + q],
            qmeta[ROW_VALID * Qp + q], maxerrors, minoverlap, ov);
        if (w == 0)
            continue;
        if (lane == 0) {
            const int seg = tseg[q];
            atomicAdd(seqhits + seg, (u64)w);
            atomicAdd(seqbasehits + seg, (u64)(long long)(w * ov));
        }
        // the diagonal fold: read position j lies on bank position
        // q - (Lpad-1) + j
        for (int j = lane; j < Lpad; j += 32) {
            const uint32_t c = read[j];
            const int gp = q - (Lpad - 1) + j;
            if (c < 5u && gp >= 0 && gp < G)
                atomicAdd(basecount + (size_t)c * G + gp, (u64)w);
        }
    }
}

template <int SP>
__global__ void __launch_bounds__(NT, 2)
score_step_kernel(const uint32_t* __restrict__ codes,  // [B, Lpad/4]
                  const int32_t* __restrict__ rl,       // [B]
                  const int32_t* __restrict__ rows,     // [cap] or null
                  const int32_t* __restrict__ count,    // [1] or null
                  int cap,
                  const uint8_t* __restrict__ bank,     // [nb]
                  long nb,
                  const int32_t* __restrict__ qmeta,    // [8, Qp]
                  const int32_t* __restrict__ tseg,     // [Qp]
                  u64* __restrict__ basecount,          // [5, G]
                  u64* __restrict__ seqhits,            // [T + 1]
                  u64* __restrict__ seqbasehits,        // [T + 1]
                  int Lpad, int Qp, int G, int maxerrors, int minoverlap)
{
    constexpr int R = Tile<SP>::R;
    constexpr int NACC = Tile<SP>::NACC;
    extern __shared__ __align__(128) uint8_t smem[];
    uint8_t* As = smem;
    uint32_t* Bw = reinterpret_cast<uint32_t*>(smem + A_BYTES);
    uint16_t* list = reinterpret_cast<uint16_t*>(smem + MMA_SMEM);
    __shared__ int col_dm[TQ], col_ovc[TQ], col_seql[TQ];
    __shared__ int row_rl[TB], row_rlmo[TB], row_id[TB];
    __shared__ int list_n;

    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t = lane & 3;
    const int wg = warp >> 2;
    const int ntiles = min(QT, (Qp + TQ - 1) / TQ - (int)blockIdx.x * QT);
    // ranks at or past the count are never read
    const int n = count ? min(max(*count, 0), cap) : cap;
    if (tid == 0)
        list_n = 0;

    for (int b0 = blockIdx.y * TB; b0 < n; b0 += gridDim.y * TB) {
        if (tid >= TQ) {
            const int r = tid - TQ;
            const int row = b0 + r < n ? (rows ? rows[b0 + r] : b0 + r) : -1;
            row_id[r] = row;
            row_terms(row_rl, row_rlmo, r, row >= 0 ? rl[row] : 0,
                      maxerrors, minoverlap);
        }
        __syncthreads();
        int rlv[2], rlmo_e[2];
        for (int h = 0; h < 2; ++h) {
            rlv[h] = row_rl[acc_read(warp, g, h)];
            rlmo_e[h] = row_rlmo[acc_read(warp, g, h)];
        }

        for (int tile = 0; tile < ntiles; ++tile) {
            const int q0 = (blockIdx.x * QT + tile) * TQ;
            column_terms(col_dm, col_ovc, col_seql, qmeta, Qp, q0,
                         maxerrors, tid);
            int acc[R][NACC];
            tile_products<SP>(acc, As, Bw, codes, row_id, Lpad, bank, nb,
                              q0, tile > 0, tid, wg);
#pragma unroll
            for (int s = 0; s < R; ++s)
                screen<R, NACC>(
                    acc[s], s, t, rlv, rlmo_e, col_dm, col_ovc, col_seql,
                    [&](int h, int col) {
                        list[atomicAdd(&list_n, 1)] =
                            (uint16_t)(col << 7 | acc_read(warp, g, h));
                    });
            __syncthreads();   // the list is complete
            const int nl = list_n;
            if (nl > 0)
                drain<SP>(list, nl, row_id, row_rl,
                          reinterpret_cast<const uint8_t*>(codes), bank, nb,
                          qmeta, tseg, basecount, seqhits, seqbasehits,
                          Lpad, Qp, G, q0, maxerrors, minoverlap, warp,
                          lane);
            // the list, the column and the row terms are read before
            // they change
            __syncthreads();
            if (tid == 0)
                list_n = 0;
        }
    }
}

}  // namespace

extern "C" {

const char* kvq_cuda_src_hash() { return KVQ_SRC_HASH; }

// codes: uint8 [B, Lpad] (Lpad % 4 == 0, 4-byte aligned), rl: int32 [B];
// rows: int32 [cap] batch rows to score, or null (rank r is row r, cap <=
// B); count: int32 [1] in device memory, the ranks to score (clamped to
// [0, cap]), or null (all cap); grid_rows: the ranks the grid is sized
// for (blocks loop over the rest); bank: uint8 [4 * nbw] padded bank
// bytes (pallas_scan._kernel_bytes); qmeta: int32 [8, Qp]; tseg: int32
// [Qp]; basecount int64 [5, G], seqhits and seqbasehits int64 [T + 1],
// added to.  Returns the CUDA error code of the launch (0 on success).
int kvq_score_step(const void* codes, const void* rl, const void* rows,
                   const void* count, int cap, int grid_rows,
                   const void* bank, int nbw, const void* qmeta,
                   const void* tseg, void* basecount, void* seqhits,
                   void* seqbasehits, int Lpad, int Qp, int G, int nch,
                   int maxerrors, int minoverlap, void* stream)
{
    if (cap <= 0 || grid_rows <= 0 || Qp <= 0)
        return 0;
    if (Lpad <= 0 || Lpad % 4 || (nch != 4 && nch != 5))
        return (int)cudaErrorInvalidValue;
    const int ntiles = (Qp + TQ - 1) / TQ;
    const int tiles_y = (grid_rows + TB - 1) / TB;
    const dim3 grid((ntiles + QT - 1) / QT,
                    tiles_y < 65535 ? tiles_y : 65535);
    // above the 48 KB default: set for the current device at every launch
    auto kernel = nch == 4 ? score_step_kernel<4> : score_step_kernel<8>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess)
        return (int)err;
    kernel<<<grid, NT, SMEM, (cudaStream_t)stream>>>(
        (const uint32_t*)codes, (const int32_t*)rl, (const int32_t*)rows,
        (const int32_t*)count, cap, (const uint8_t*)bank, 4L * nbw,
        (const int32_t*)qmeta, (const int32_t*)tseg, (u64*)basecount,
        (u64*)seqhits, (u64*)seqbasehits, Lpad, Qp, G, maxerrors,
        minoverlap);
    return (int)cudaGetLastError();
}

}  // extern "C"
