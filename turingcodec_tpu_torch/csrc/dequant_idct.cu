// Dequantization + inverse transform of a batch of TUs for Hopper (sm_90a).
//
// Replaces the XLA programs turingcodec_tpu/ops/quant.py dequant_batch and
// turingcodec_tpu/ops/transform.py inverse_transform_batch (its two int32
// einsums), and the transform-skip arm of
// turingcodec_tpu/decode/device_pipeline.py _residuals_device. For each TU
// b of one size N = 1 << log2 (N in 4..32):
//   d = clip16(((level * LEVEL_SCALE[qp % 6] * 16 + rnd) >> sh_pos) << sh_neg)
//       with shift = bit_depth + log2 - 5 - qp / 6 split into its positive
//       and negative parts (rnd = 1 << (shift - 1) when shift > 0),
//   mode 0: g = clip16((M^T d + 64) >> 7), r = clip16((g M + rnd2) >> (20 - bd)),
//   mode 1: r = clip16(((d << 7) + rnd2) >> (20 - bd))   (transform skip).
// Every product and sum stays below 2^27 in int32 (|d| <= 32768, |M| <= 90,
// N <= 32), so the result is exact; float32 would not be. The DCT matrix M
// and LEVEL_SCALE come in from the wrapper (hevc/tables.py), so each table
// lives in one place.
//
// Design: one thread block of 256 threads takes 1024 coefficients: 64 TUs of
// 4x4, 16 of 8x8, 4 of 16x16 or one 32x32. It reads its contiguous slice of
// levels coalesced, dequantizes into shared memory, and runs the two matrix
// stages out of shared memory (N multiply-adds per coefficient per stage),
// each thread owning four coefficients.
//
// Bound on the card: a 1080p picture has at most 3.1 M coefficients, 25 MB
// of int32 in and out (7.5 us at 3.35 TB/s) and at most 2 * 32 multiply-adds
// per coefficient. A decoded picture codes far fewer TUs, split over up to
// a dozen (component, size, mode) buckets, so one launch is a few
// microseconds of work and the launches' fixed cost dominates; batching all
// buckets into one launch is later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 1024;  // coefficients per thread block

__device__ __forceinline__ int clip16(int v) {
    return min(max(v, -32768), 32767);
}

template <int LOG2>
__global__ void __launch_bounds__(kThreads)
dequant_idct_kernel(const int32_t* __restrict__ levels,
                    const int32_t* __restrict__ qp,
                    const int32_t* __restrict__ mat,
                    const int32_t* __restrict__ level_scale,
                    int32_t* __restrict__ out, int B, int bit_depth,
                    int mode) {
    constexpr int N = 1 << LOG2;
    constexpr int NN = N * N;
    __shared__ int32_t s_d[kChunk];
    __shared__ int32_t s_g[kChunk];
    __shared__ int32_t s_m[NN];

    const int t = threadIdx.x;
    const size_t base = (size_t)blockIdx.x * kChunk;
    const size_t total = (size_t)B * NN;
    const int bd_shift = bit_depth + LOG2 - 5;
    const int out_shift = 20 - bit_depth;
    const int out_rnd = 1 << (out_shift - 1);

    for (int i = t; i < kChunk; i += kThreads) {
        const size_t gi = base + i;
        int d = 0;
        if (gi < total) {
            const int q = qp[gi / NN];
            const int qd = q >= 0 ? q / 6 : -((5 - q) / 6);  // floor
            const int ls16 = level_scale[q - 6 * qd] * 16;
            const int shift = bd_shift - qd;
            const int sh_pos = max(shift, 0);
            const int sh_neg = max(-shift, 0);
            const int rnd = shift > 0 ? 1 << (shift - 1) : 0;
            const int p = levels[gi] * ls16;
            d = clip16((int)((unsigned)((p + rnd) >> sh_pos) << sh_neg));
        }
        if (mode == 1) {
            if (gi < total)
                out[gi] = clip16(((d * 128) + out_rnd) >> out_shift);
        } else {
            s_d[i] = d;
        }
    }
    if (mode == 1) return;
    for (int i = t; i < NN; i += kThreads) s_m[i] = mat[i];
    __syncthreads();

    // stage 1 (columns): e[y][x] = sum_k M[k][y] * d[k][x]
    for (int i = t; i < kChunk; i += kThreads) {
        const int tu = i / NN * NN;
        const int y = (i % NN) / N;
        const int x = i % N;
        int e = 0;
#pragma unroll
        for (int k = 0; k < N; ++k) e += s_m[k * N + y] * s_d[tu + k * N + x];
        s_g[i] = clip16((e + 64) >> 7);
    }
    __syncthreads();

    // stage 2 (rows): r[y][x] = sum_k g[y][k] * M[k][x]
    for (int i = t; i < kChunk; i += kThreads) {
        const size_t gi = base + i;
        if (gi >= total) continue;
        const int tu = i / NN * NN;
        const int y = (i % NN) / N;
        const int x = i % N;
        int r = 0;
#pragma unroll
        for (int k = 0; k < N; ++k) r += s_g[tu + y * N + k] * s_m[k * N + x];
        out[gi] = clip16((r + out_rnd) >> out_shift);
    }
}

template <int LOG2>
void launch(const int32_t* levels, const int32_t* qp, const int32_t* mat,
            const int32_t* ls, int32_t* out, int B, int bit_depth, int mode,
            cudaStream_t stream) {
    const size_t total = (size_t)B << (2 * LOG2);
    const unsigned grid = (unsigned)((total + kChunk - 1) / kChunk);
    dequant_idct_kernel<LOG2><<<grid, kThreads, 0, stream>>>(
        levels, qp, mat, ls, out, B, bit_depth, mode);
}

}  // namespace

// levels: (B, N, N) int32, qp: (B,) int32, mat: (N, N) int32 DCT matrix,
// level_scale: (6,) int32, out: (B, N, N) int32, all contiguous on the
// device; N = 1 << log2_size, log2_size in 2..5, mode 0 (inverse DCT) or 1
// (transform skip). Launches on `stream` and returns cudaGetLastError() (0
// on success, cudaErrorInvalidValue for an unsupported size or mode); never
// synchronises.
extern "C" int dequant_idct_launch(const void* levels, const void* qp,
                                   const void* mat, const void* level_scale,
                                   void* out, int B, int log2_size,
                                   int bit_depth, int mode, void* stream) {
    if (mode != 0 && mode != 1) return (int)cudaErrorInvalidValue;
    if (B > 0) {
        const int32_t* l = (const int32_t*)levels;
        const int32_t* q = (const int32_t*)qp;
        const int32_t* m = (const int32_t*)mat;
        const int32_t* s = (const int32_t*)level_scale;
        int32_t* o = (int32_t*)out;
        cudaStream_t st = (cudaStream_t)stream;
        switch (log2_size) {
            case 2: launch<2>(l, q, m, s, o, B, bit_depth, mode, st); break;
            case 3: launch<3>(l, q, m, s, o, B, bit_depth, mode, st); break;
            case 4: launch<4>(l, q, m, s, o, B, bit_depth, mode, st); break;
            case 5: launch<5>(l, q, m, s, o, B, bit_depth, mode, st); break;
            default: return (int)cudaErrorInvalidValue;
        }
    }
    return (int)cudaGetLastError();
}
