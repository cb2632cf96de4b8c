// The one-hot match product of the exhaustive scan on Hopper tensor cores
// (sm_90a): the operand layout and the wgmma helpers of the pipeline
// (kvq_s1_pipeline.h) that K1, S1 and H1 share.
//
// For 128 reads (a row tile) and 128 shift columns it computes
//
//     matches[r, q] = sum_j [r[j] < nch  and  r[j] == bank[q + j]]
//
// (read codes >= nch one-hot to the zero vector) as asynchronous
// warpgroup MMAs (wgmma, s8 x s8 -> s32; exact, counts <= Lpad), both
// operands K-major in shared memory (8-bit wgmma takes no other layout),
// no swizzle.  The depth is position-major, SP bytes per read position:
// SP = 4 for nch 4 (the A, C, G, T indicator bytes), SP = 8 for nch 5
// (A, C, G, T, N and three zero bytes).
//
// - A (reads): two warpgroups of 64 reads; their codes are expanded into
//   the int8 one-hot tile, K column v (depth bytes 16 v ..) of row r at
//   v * KSTRIDE + 16 r: 16-byte K columns one padded row apart, so the
//   building stores do not collide.
// - B (bank): column q at depth byte d reads the one-hot byte of bank
//   position q + d / SP: a Toeplitz matrix, row n + 1 is row n moved by SP
//   bytes.  wgmma's core matrices want rows 16 bytes apart, so the
//   columns are cut into R = 16 / SP residues: residue s is a window of
//   the one-hot bank moved by s positions, its row n' (column R n' + s)
//   starting 16 n' bytes in, all rows overlapping.
// - acc[4 j + 2 h + e] of an m64 MMA is row 64 wg + 16 (warp % 4) + g +
//   8 h of the tile and MMA column 8 j + 2 t + e, with g = lane / 4, t =
//   lane % 4 (acc_read).

#ifndef KVQ_ONEHOT_MMA_H
#define KVQ_ONEHOT_MMA_H

#include <cuda_runtime.h>
#include <stdint.h>

namespace kvq {

// qmeta rows (kvarq_tpu_torch/engine/pallas_scan.py ROW_*)
constexpr int ROW_D = 0, ROW_SEQL = 1, ROW_VALID = 2, ROW_DM = 3, ROW_OVC = 4;
constexpr int BIG_RL_THRESHOLD = 1 << 20;

constexpr int TB = 128;            // reads per row tile: two warpgroups of m64
constexpr int TQ = 128;            // shift columns per stage
constexpr int KSTRIDE = TB * 16 + 16;   // bytes between A's K columns

// the tile row of accumulator h of this thread
__device__ __forceinline__ int acc_read(int warp, int g, int h)
{
    return (warp >> 2) * 64 + (warp & 3) * 16 + g + 8 * h;
}

__device__ __forceinline__ uint32_t onehot4(uint32_t c)
{
    return c < 4u ? 1u << (8u * c) : 0u;
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

}  // namespace kvq

#endif  // KVQ_ONEHOT_MMA_H
