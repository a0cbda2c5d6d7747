// Dense full-pel motion-estimation sweep for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel turingcodec_tpu/ops/pallas_kernels.py
// dense_me_argmin. For each 16x16 source block and its 32x32 reference
// window (the window's top-left sits at offset (-8, -8) from the seed), find
// the offset (ox, oy) in [-8, 8]^2 minimising
//     cost = (SAD << 2) + |ox| + |oy|,
// ties going to the first offset in (oy, ox) scan order, and write
// [ox, oy, SAD] of the winner.
//
// Design: one thread block per ME block. The block stages its 16x16 source
// and 32x32 window in shared memory (5 KB), thread t < 289 computes the SAD
// of offset k = t = oy * 17 + ox, and a warp-shuffle plus shared-memory
// reduction takes the min of the packed key (cost << 9) | k. The key orders
// by cost first and by scan position second, so the min reproduces the
// scan's strict-improvement tie-break exactly, whatever order the reduction
// runs in. cost < 2^23 for samples of at most 12 bits (256 * 4095 * 4 + 16),
// so the key fits in 32 unsigned bits.
//
// Bound on the card: at 1080p one call covers B = 8160 blocks, about 604 M
// absolute differences and 42 MB of int32 input (the caller materialises the
// windows). Measured on an H100 SXM at a 700 W limit, a call takes 0.22 ms:
// 189 GB/s of input, far below HBM bandwidth. The bound is the inner loop's
// two shared-memory loads per absolute difference (about 4.8 GB of shared
// traffic); keeping the source row and a sliding window row in registers,
// and reading the padded reference plane directly instead of materialised
// windows, is later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kOffsets = 17 * 17;
constexpr int kThreads = 320;  // 10 warps; threads >= 289 only reduce
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ unsigned warp_min(unsigned v) {
#pragma unroll
    for (int s = 16; s > 0; s >>= 1)
        v = min(v, __shfl_down_sync(0xffffffffu, v, s));
    return v;
}

__global__ void __launch_bounds__(kThreads)
dense_me_argmin_kernel(const int32_t* __restrict__ cur,
                       const int32_t* __restrict__ pat,
                       int32_t* __restrict__ out) {
    __shared__ int32_t s_cur[16 * 16];
    __shared__ int32_t s_pat[32 * 32];
    __shared__ unsigned s_key[kWarps];

    const int t = threadIdx.x;
    const size_t b = blockIdx.x;
    const int32_t* c = cur + b * 256;
    const int32_t* p = pat + b * 1024;
    for (int i = t; i < 256; i += kThreads) s_cur[i] = c[i];
    for (int i = t; i < 1024; i += kThreads) s_pat[i] = p[i];
    __syncthreads();

    unsigned key = 0xffffffffu;
    if (t < kOffsets) {
        const int oy = t / 17;
        const int ox = t - oy * 17;
        int sad = 0;
#pragma unroll 4
        for (int y = 0; y < 16; ++y) {
            const int32_t* cr = s_cur + y * 16;
            const int32_t* pr = s_pat + (oy + y) * 32 + ox;
#pragma unroll
            for (int x = 0; x < 16; ++x) sad += abs(cr[x] - pr[x]);
        }
        const unsigned cost =
            ((unsigned)sad << 2) + (unsigned)(abs(ox - 8) + abs(oy - 8));
        key = (cost << 9) | (unsigned)t;
    }
    key = warp_min(key);
    if ((t & 31) == 0) s_key[t >> 5] = key;
    __syncthreads();
    if (t < 32) {
        key = t < kWarps ? s_key[t] : 0xffffffffu;
        key = warp_min(key);
        if (t == 0) {
            const int k = (int)(key & 511u);
            const int oy = k / 17 - 8;
            const int ox = k % 17 - 8;
            const unsigned cost = key >> 9;
            out[b * 3 + 0] = ox;
            out[b * 3 + 1] = oy;
            out[b * 3 + 2] = (int32_t)((cost - (unsigned)(abs(ox) + abs(oy))) >> 2);
        }
    }
}

}  // namespace

// cur: (B, 16, 16) int32, pat: (B, 32, 32) int32, out: (B, 3) int32, all
// contiguous on the device. Launches on `stream` and returns
// cudaGetLastError() (0 on success); never synchronises.
extern "C" int dense_me_argmin_launch(const void* cur, const void* pat,
                                      void* out, int B, void* stream) {
    if (B > 0)
        dense_me_argmin_kernel<<<B, kThreads, 0, (cudaStream_t)stream>>>(
            (const int32_t*)cur, (const int32_t*)pat, (int32_t*)out);
    return (int)cudaGetLastError();
}
