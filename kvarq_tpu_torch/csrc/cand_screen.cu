// Candidate screen of the exhaustive scan, hand-written for Hopper (sm_90a).
//
// Replaces kvarq_tpu/engine/pallas_scan.py::_cand_kernel (the one Pallas
// TPU kernel, launched by match_cand_call).  For every read b and every
// shift column q of the template bank it counts the matching bases
//
//     matches[b, q] = sum_j [r[b, j] < nch  and  r[b, j] == bank[q - (Lpad-1) + j]]
//
// -- exactly the one-hot product read_flat @ K of the TPU kernel, since
// codes >= nch one-hot to the zero vector -- and applies the same sound
// screen in int32 (every threshold is an integer < 2^21, so this equals
// the TPU kernel's f32 compares bit for bit):
//
//     matches >= max(min(rl + dm - e, ovc - e),
//                    min((rl > 0 ? min(rl, mo) : 2^20) - e,
//                        valid ? seql - e : 2^20))
//
// Output: out[b] += number of passing columns (the caller zeroes out; a
// read is a candidate iff out[b] > 0).  The [B, Q] match tensor never
// leaves registers.
//
// What bounds it: B * Qp * Lpad byte compares -- 16384 x 40064 x 128 =
// 8.4e10 per MTBC batch, about 1.1e13 for a 2M-read unsieved scan.  The
// design packs 4 bases per 32-bit word and compares them with one SIMD
// byte compare (__vcmpeq4), so the inner loop does Lpad/4 word compares
// per (read, column) pair; each thread keeps a RB x 8 tile of counters in
// registers and reuses every read word 8 times and every bank word 4
// times (the 4 byte shifts of a bank word come from one funnel shift of
// two aligned words).  Codes are staged through shared memory in chunks
// of JC bases, so any Lpad (a multiple of 4) fits.  Tensor cores (wgmma),
// TMA and 2-bit packing are left to later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (kvarq_tpu_torch/engine/native_cuda.py).

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef KVQ_SRC_HASH
#define KVQ_SRC_HASH "unknown"
#endif

namespace {

// qmeta rows (kvarq_tpu/engine/pallas_scan.py ROW_*)
constexpr int ROW_SEQL = 1, ROW_VALID = 2, ROW_DM = 3, ROW_OVC = 4;
constexpr int BIG_RL_THRESHOLD = 1 << 20;

constexpr int TB = 64;            // reads per block
constexpr int TQ = 128;           // shift columns per block
constexpr int RB = 4;             // reads per thread
constexpr int QG = 2;             // 4-column groups per thread
constexpr int NX = TQ / (4 * QG); // 16 column-group threads
constexpr int NY = TB / RB;       // 16 read-group threads
constexpr int NT = NX * NY;       // 256 threads
constexpr int JC = 128;           // bases staged per chunk
constexpr int JW = JC / 4;        // words per chunk
constexpr int RS = JW + 1;        // padded smem row stride (words)
constexpr int BW = TQ / 4 + JW + 1;  // bank words a chunk touches

static_assert(NX == 16, "the per-read reduction shuffles over 16 lanes");

__global__ void __launch_bounds__(NT)
cand_screen_kernel(const uint32_t* __restrict__ codes,  // [B, Lpad/4]
                   const int32_t* __restrict__ rl,       // [B]
                   const uint32_t* __restrict__ bank,    // [nbw]
                   int nbw,
                   const int32_t* __restrict__ qmeta,    // [8, Qp]
                   int32_t* __restrict__ out,            // [B]
                   int B, int Lpad, int Qp, int nch,
                   int maxerrors, int minoverlap)
{
    __shared__ uint32_t rs[TB * RS];
    __shared__ uint32_t bs[BW];

    const int tid = threadIdx.x;
    const int tx = tid % NX;
    const int ty = tid / NX;
    const int q0 = blockIdx.x * TQ;
    const int b0 = blockIdx.y * TB;
    const int lw = Lpad / 4;
    // bytes >= nch become 0xFF in reads; the host put 0xFE at every bank
    // byte >= nch, so such bytes never compare equal
    const uint32_t nch4 = 0x01010101u * (uint32_t)nch;

    int acc[RB][4 * QG];
#pragma unroll
    for (int i = 0; i < RB; ++i)
#pragma unroll
        for (int k = 0; k < 4 * QG; ++k)
            acc[i][k] = 0;

    for (int j0 = 0; j0 < Lpad; j0 += JC) {
        const int nw = min(JW, (Lpad - j0) / 4);
        for (int idx = tid; idx < TB * JW; idx += NT) {
            const int row = idx / JW, w = idx % JW;
            uint32_t x = 0xFFFFFFFFu;
            if (w < nw && b0 + row < B) {
                x = codes[(size_t)(b0 + row) * lw + j0 / 4 + w];
                x |= ~__vcmpltu4(x, nch4);
            }
            rs[row * RS + w] = x;
        }
        const int wbase = (q0 + j0) / 4;
        for (int idx = tid; idx < BW; idx += NT) {
            const int g = wbase + idx;
            bs[idx] = g < nbw ? bank[g] : 0xFEFEFEFEu;
        }
        __syncthreads();

        for (int w = 0; w < nw; ++w) {
            uint32_t r[RB];
#pragma unroll
            for (int i = 0; i < RB; ++i)
                r[i] = rs[(ty * RB + i) * RS + w];
#pragma unroll
            for (int k = 0; k < QG; ++k) {
                const int m = tx + NX * k;
                const uint32_t lo = bs[m + w], hi = bs[m + w + 1];
#pragma unroll
                for (int s = 0; s < 4; ++s) {
                    const uint32_t bw = __funnelshift_r(lo, hi, 8 * s);
#pragma unroll
                    for (int i = 0; i < RB; ++i)
                        acc[i][4 * k + s] += __popc(__vcmpeq4(r[i], bw));
                }
            }
        }
        __syncthreads();
    }

    // screen: column pieces [1, 8] per thread, row pieces [RB, 1]
    int dm_e[4 * QG], ovc_e[4 * QG], seql_e[4 * QG];
    bool inq[4 * QG];
#pragma unroll
    for (int k = 0; k < QG; ++k)
#pragma unroll
        for (int s = 0; s < 4; ++s) {
            const int c = 4 * k + s;
            const int q = q0 + 4 * (tx + NX * k) + s;
            inq[c] = q < Qp;
            const int qq = inq[c] ? q : 0;
            dm_e[c] = qmeta[ROW_DM * Qp + qq] - maxerrors;
            ovc_e[c] = qmeta[ROW_OVC * Qp + qq] - maxerrors;
            seql_e[c] = qmeta[ROW_VALID * Qp + qq] > 0
                ? qmeta[ROW_SEQL * Qp + qq] - maxerrors : BIG_RL_THRESHOLD;
        }

#pragma unroll
    for (int i = 0; i < RB; ++i) {
        const int b = b0 + ty * RB + i;
        const int rlv = b < B ? rl[b] : 0;
        const int rlmo_e = (rlv > 0 ? min(rlv, minoverlap)
                                    : BIG_RL_THRESHOLD) - maxerrors;
        int n = 0;
#pragma unroll
        for (int c = 0; c < 4 * QG; ++c) {
            const int matches = acc[i][c] >> 3;   // 8 bits set per equal byte
            const int ov_e = min(rlv + dm_e[c], ovc_e[c]);
            const int tau_e = min(rlmo_e, seql_e[c]);
            n += (inq[c] && matches >= max(ov_e, tau_e)) ? 1 : 0;
        }
        // the 16 column-group threads of a read are 16 consecutive lanes
#pragma unroll
        for (int off = NX / 2; off > 0; off /= 2)
            n += __shfl_xor_sync(0xFFFFFFFFu, n, off);
        if (tx == 0 && b < B && n > 0)
            atomicAdd(out + b, n);
    }
}

}  // namespace

extern "C" {

const char* kvq_cuda_src_hash() { return KVQ_SRC_HASH; }

// codes: uint8 [B, Lpad] (Lpad % 4 == 0, 4-byte aligned), rl: int32 [B],
// bank: uint8 [4 * nbw] padded bank bytes (see pallas_scan.bank_bytes),
// qmeta: int32 [8, Qp], out: int32 [B] zeroed.  Returns the CUDA error
// code of the launch (0 on success).
int kvq_cand_screen(const void* codes, const void* rl, const void* bank,
                    int nbw, const void* qmeta, void* out,
                    int B, int Lpad, int Qp, int nch,
                    int maxerrors, int minoverlap, void* stream)
{
    if (B <= 0 || Qp <= 0)
        return 0;
    const dim3 grid((Qp + TQ - 1) / TQ, (B + TB - 1) / TB);
    cand_screen_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)codes, (const int32_t*)rl, (const uint32_t*)bank,
        nbw, (const int32_t*)qmeta, (int32_t*)out,
        B, Lpad, Qp, nch, maxerrors, minoverlap);
    return (int)cudaGetLastError();
}

}  // extern "C"
