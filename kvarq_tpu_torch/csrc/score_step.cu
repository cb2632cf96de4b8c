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
// the pairs * Lpad coverage adds.
//
// Design: the pipeline of kvq_s1_pipeline.h (persistent blocks, a
// producer warp bulk-copying each column group's bank windows and screen
// terms, two consumer warpgroups taking turns at issuing wgmma into two
// accumulator sets), with S1's drain: the passing pairs listed per
// stage, their counts recomputed, mode_weights, the sums and the
// coverage histogram.
//
// H1, the exact hit extraction (kvq_hit_extract): the same kernel with a
// drain chosen at compile time.  It is the device work of kvarq_tpu's hit
// matcher, match_xla._jit_step (kvarq_tpu/engine/match_xla.py:122-188:
// the GEMM, mode_weights, the packed windows) and _jit_rows, which XLA
// runs there.  Its drain (Consumer::hits) works in the screen's lanes, as
// K1's does: K1's screen over the accumulators (the one-hot product of the
// same operands over the whole depth: each pair's whole count) keeps each
// pair's pass bit, and a pass is mode_weights' own test of that count (the
// screen's threshold holds the overlap ov, so a passing pair has ov - m <=
// e), so the lane of a passing pair takes its hit modes from the read's
// length and the column's d, seql and valid; the pairs with w > 0 take
// slots of the triplet buffer, one atomicAdd on a device counter per warp
// (each lane's count of them and a prefix sum over the lanes), and each
// writes (row_ids[row], tseg[q], qmeta[ROW_D, q]) there while its slot is
// below the capacity; the counter always ends at the number of triplets.
// No pair list, no recount, no histogram, no seqhits, no coverage: the
// shared memory of the lists and histograms is not laid out.  Nothing of
// size [B, Qp] is written here either: the buffer holds the triplets
// alone.  What bounds it is S1's product of the rows it extracts; its
// drain adds a few loads and stores per triplet.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (kvarq_tpu_torch/engine/native_cuda.py).

#include "kvq_s1_pipeline.h"

#ifndef KVQ_SRC_HASH
#define KVQ_SRC_HASH "unknown"
#endif

namespace {

// S1
template <int SP, bool PROF>
__global__ void __launch_bounds__(NTHREADS, 1)
score_step_kernel(const __grid_constant__ Args a,
                  const __grid_constant__ Layout lay)
{
    extern __shared__ __align__(128) uint8_t smem[];
    __shared__ Shared sh;
    block_run<SP, PROF, DRAIN_SCORE>(a, lay, smem, sh);
}

// H1
template <int SP, bool PROF>
__global__ void __launch_bounds__(NTHREADS, 1)
hit_extract_kernel(const __grid_constant__ Args a,
                   const __grid_constant__ Layout lay)
{
    extern __shared__ __align__(128) uint8_t smem[];
    __shared__ Shared sh;
    block_run<SP, PROF, DRAIN_HIT>(a, lay, smem, sh);
}

}  // namespace

extern "C" {

const char* kvq_cuda_src_hash() { return KVQ_SRC_HASH; }

// codes: uint8 [B, Lpad] (Lpad % 4 == 0, 4-byte aligned), rl: int32 [B];
// rows: int32 [cap] batch rows to score, or null (rank r is row r, cap <=
// B); count: int32 [1] in device memory, the ranks to score (clamped to
// [0, cap]), or null (all cap); bank: uint8 [4 * nbw] padded bank bytes
// (pallas_scan._kernel_bytes); onehot: uint8 [16 / SP, onb]
// (pallas_scan.s1_onehot); sterms: int32 [groups * 256, 4]
// (pallas_scan.s1_terms); qmeta: int32 [8, Qp]; tseg: int32 [Qp];
// basecount int64 [5, G], seqhits and seqbasehits int64 [T + 1], added
// to; prof: int64 [8] or null, cycles per phase added to it (PROF_*).
// One block per SM of the current device.  Returns the CUDA error code of
// the launch (0 on success; cudaErrorInvalidValue where the read padding
// leaves no layout within the shared memory).
int kvq_score_step(const void* codes, const void* rl, const void* rows,
                   const void* count, int cap, const void* bank, int nbw,
                   const void* onehot, long onb, const void* sterms,
                   const void* qmeta, const void* tseg, void* basecount,
                   void* seqhits, void* seqbasehits, int Lpad, int Qp, int G,
                   int nch, int maxerrors, int minoverlap, void* prof,
                   void* stream)
{
    if (cap <= 0 || Qp <= 0)
        return 0;
    if (Lpad <= 0 || Lpad % 4 || (nch != 4 && nch != 5))
        return (int)cudaErrorInvalidValue;
    const int SP = nch == 4 ? 4 : 8;
    const int which = (SP == 4 ? 0 : 2) + (prof ? 1 : 0);
    const Kernel kernel = SP == 4
        ? (prof ? score_step_kernel<4, true> : score_step_kernel<4, false>)
        : (prof ? score_step_kernel<8, true> : score_step_kernel<8, false>);
    const Args a = {(const uint32_t*)codes, (const int32_t*)rl,
                    (const int32_t*)rows, (const int32_t*)count, cap,
                    (const uint8_t*)bank, 4L * nbw, (const uint8_t*)onehot,
                    onb, (const uint4*)sterms, (const int32_t*)qmeta,
                    (const int32_t*)tseg, (u64*)basecount, (u64*)seqhits,
                    (u64*)seqbasehits, Lpad, Qp, G, maxerrors, minoverlap,
                    (long long*)prof, nullptr, nullptr, 0, nullptr};
    return launch(kernel, which, a, SP, cap, DRAIN_SCORE, stream);
}

// H1.  codes, rl, rows, count, cap, bank, nbw, onehot, onb, sterms, qmeta,
// tseg, Lpad, Qp, nch, maxerrors, minoverlap as kvq_score_step; row_ids:
// int32 [B], the id a triplet reports for batch row b, or null (b itself);
// out: int32 [outcap, 3], the triplets (row id, template, shift d) in no
// particular order; nout: int32 [1], zero on entry, the number of
// triplets on exit (also where it exceeds outcap: only the first outcap
// slots are written); prof as kvq_score_step's.  Returns the CUDA error
// code of the launch.
int kvq_hit_extract(const void* codes, const void* rl, const void* rows,
                    const void* count, int cap, const void* bank, int nbw,
                    const void* onehot, long onb, const void* sterms,
                    const void* qmeta, const void* tseg, const void* row_ids,
                    void* out, void* nout, int outcap, int Lpad, int Qp,
                    int nch, int maxerrors, int minoverlap, void* prof,
                    void* stream)
{
    if (cap <= 0 || Qp <= 0)
        return 0;
    if (Lpad <= 0 || Lpad % 4 || (nch != 4 && nch != 5) || outcap < 0)
        return (int)cudaErrorInvalidValue;
    // the drain takes a pass of the screen as mode_weights' test of the
    // count, which holds while twice Lpad plus e stays below the screen
    // terms' clamp (pallas_scan.S1_TERM_CLAMP, 16383): there the clamped
    // terms compare with a count plus e as the true ones.  No layout
    // holds such depths anyway.
    if (maxerrors < 0 || 2 * Lpad + maxerrors >= 16383)
        return (int)cudaErrorInvalidValue;
    const int SP = nch == 4 ? 4 : 8;
    const int which = 4 + (SP == 4 ? 0 : 2) + (prof ? 1 : 0);
    const Kernel kernel = SP == 4
        ? (prof ? hit_extract_kernel<4, true> : hit_extract_kernel<4, false>)
        : (prof ? hit_extract_kernel<8, true> : hit_extract_kernel<8, false>);
    const Args a = {(const uint32_t*)codes, (const int32_t*)rl,
                    (const int32_t*)rows, (const int32_t*)count, cap,
                    (const uint8_t*)bank, 4L * nbw, (const uint8_t*)onehot,
                    onb, (const uint4*)sterms, (const int32_t*)qmeta,
                    (const int32_t*)tseg, nullptr, nullptr, nullptr, Lpad,
                    Qp, 0, maxerrors, minoverlap, (long long*)prof,
                    (int32_t*)out, (int32_t*)nout, outcap,
                    (const int32_t*)row_ids};
    return launch(kernel, which, a, SP, cap, DRAIN_HIT, stream);
}

}  // extern "C"
