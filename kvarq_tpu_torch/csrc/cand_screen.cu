// Candidate screen of the exhaustive scan, on Hopper tensor cores (sm_90a):
// K1.
//
// Replaces kvarq_tpu/engine/pallas_scan.py::_cand_kernel (the one Pallas
// TPU kernel, launched by match_cand_call).  For every read b and every
// shift column q of the template bank it counts the matching bases
//
//     matches[b, q] = sum_j [r[b, j] < nch  and  r[b, j] == bank[q - (Lpad-1) + j]]
//
// -- the one-hot product read_flat @ K of the TPU kernel, since codes
// >= nch one-hot to the zero vector -- and applies the same sound screen
// in integers (every threshold is an integer < 2^21, so this equals the
// TPU kernel's f32 compares bit for bit):
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
// few MB of inputs (uint8 codes, the staged one-hot bank, the screen
// terms): compute-bound by a factor above 100.  0/1 one-hots are exact in
// int8, so the least time is that product at the card's int8 tensor rate
// (1,979 TOP/s dense on an H100 SXM: 0.34 ms for that batch).
//
// Design: S1's pipeline (kvq_s1_pipeline.h) with a third drain.  One
// persistent block per SM walks the 128-read x 128-column stages of every
// row tile of the batch; a producer warp bulk-copies each 512-column
// group's residue windows of the one-hot bank and its screen terms
// (BankState.onehot and .sterms, pallas_scan.s1_onehot / s1_terms) into a
// ring of two slots; two consumer warpgroups build their reads' one-hot
// tile while the copies land and take turns at issuing wgmma m64n128k32
// into one of two accumulator sets, each screening the previous stage
// from the other set while the tensor cores work.  The screen is S1's
// (two columns a DPX instruction, the same clamped terms) and its drain
// is a count: each passing column adds 1 to its read's count, held in
// registers across the block's stages of one row tile and added to out
// with one atomic per read when the row tile changes and at the block's
// end.  No pair list, no histogram, no recount: their shared memory is
// not laid out.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (kvarq_tpu_torch/engine/native_cuda.py).

#include "kvq_s1_pipeline.h"

#ifndef KVQ_SRC_HASH
#define KVQ_SRC_HASH "unknown"
#endif

namespace {

// K1
template <int SP>
__global__ void __launch_bounds__(NTHREADS, 1)
cand_screen_kernel(const __grid_constant__ Args a,
                   const __grid_constant__ Layout lay)
{
    extern __shared__ __align__(128) uint8_t smem[];
    __shared__ Shared sh;
    block_run<SP, false, DRAIN_COUNT>(a, lay, smem, sh);
}

}  // namespace

extern "C" {

const char* kvq_cuda_src_hash() { return KVQ_SRC_HASH; }

// codes: uint8 [B, Lpad] (Lpad % 4 == 0, 4-byte aligned), rl: int32 [B],
// onehot: uint8 [16 / SP, onb] (pallas_scan.s1_onehot), sterms: int32
// [groups * 256, 4] (pallas_scan.s1_terms), out: int32 [B] zeroed, the
// counts added to it.  One block per SM of the current device.  Returns
// the CUDA error code of the launch (0 on success; cudaErrorInvalidValue
// where the read padding leaves no layout within the shared memory).
int kvq_cand_screen(const void* codes, const void* rl, const void* onehot,
                    long onb, const void* sterms, void* out, int B, int Lpad,
                    int Qp, int nch, int maxerrors, int minoverlap,
                    void* stream)
{
    if (B <= 0 || Qp <= 0)
        return 0;
    if (Lpad <= 0 || Lpad % 4 || (nch != 4 && nch != 5))
        return (int)cudaErrorInvalidValue;
    const int SP = nch == 4 ? 4 : 8;
    const Args a = {(const uint32_t*)codes, (const int32_t*)rl, nullptr,
                    nullptr, B, nullptr, 0, (const uint8_t*)onehot, onb,
                    (const uint4*)sterms, nullptr, nullptr, nullptr, nullptr,
                    nullptr, Lpad, Qp, 0, maxerrors, minoverlap, nullptr,
                    (int32_t*)out, nullptr, 0, nullptr};
    return launch(SP == 4 ? cand_screen_kernel<4> : cand_screen_kernel<8>,
                  SP == 4 ? 0 : 1, a, SP, B, DRAIN_COUNT, stream);
}

}  // extern "C"
