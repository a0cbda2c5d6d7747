// Forward HEVC transform of a batch of residual blocks, for Hopper (sm_90a).
//
// Replaces the XLA program turingcodec_tpu/ops/transform.py
// forward_transform_batch (its two int32 einsums, :64 and :67). For each
// (N, N) residual block r (N in 4..32, DCT; or N = 4, DST) at bit depth bd:
//   t[y][i] = (sum_x M[i][x] r[y][x] + (1 << (s1 - 1))) >> s1,  s1 = log2 N + bd - 9
//   c[j][i] = (sum_y M[j][y] t[y][i] + (1 << (s2 - 1))) >> s2,  s2 = log2 N + 6
// with no clip between the stages (unlike the inverse). In the HM range of
// residuals (|r| < 2^bd) every sum is exact in int32; beyond it int32 wraps
// as the JAX program's int32 einsum does, and the butterfly's sums equal the
// matrix product's modulo 2^32, so the integers are the same. The DCT
// coefficients come from hevc/tables.py as compile-time immediates through
// the header ops/kernel_build.py generates (as in dequant_idct.cu, where
// coefficients read from memory cost a constant-cache miss each).
//
// What bounds it. One picture's blocks of one size (129,600 4x4 down to
// 2,040 32x32 at 1080p) are read once and written once as int32: 8 bytes
// per sample, 16.6 MB or 5.0 us at 3.35 TB/s. With the even-odd (partial
// butterfly) decomposition an N-point transform takes (N/2)^2 + N + the
// N/2-point's operations (404 at N = 32), per row and per column: 12.6
// operations per sample and stage at N = 32, 3.2 us at 16.7 T INT32 op/s
// for the 32x32 batch. So bytes bound it at every size.
//
// Design. A thread block of 128 threads takes 128 / N blocks of one size.
// It loads them with coalesced 16-byte accesses into shared memory (rows
// padded to N + 1 words, so that neither pass has bank conflicts), then
// each thread transforms one row of one block in registers and writes it
// back in place, and after a barrier one column the same way, and the
// blocks go out with 16-byte stores. The butterfly is unrolled at compile
// time, so every coefficient is an immediate.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>
#include <utility>

#ifndef TC_DCT32_HALF
#error "TC_DCT32_HALF undefined: build with ops/kernel_build.py, which pre-includes hevc/tables.py's DCT"
#endif
#ifndef TC_DST4
#error "TC_DST4 undefined: build with ops/kernel_build.py, which pre-includes hevc/tables.py's DST"
#endif

namespace {

// columns 0..15 of the 32-point DCT matrix and the 4-point DST matrix,
// row-major, compiled in from hevc/tables.py by ops/kernel_build.py
constexpr int kDct[32][16] = {TC_DCT32_HALF};
constexpr int kDst[4][4] = {TC_DST4};

constexpr int kThreads = 128;

template <typename F, int... I>
__device__ __forceinline__ void static_for_(F& f,
                                            std::integer_sequence<int, I...>) {
    (f(std::integral_constant<int, I>{}), ...);
}

// f(std::integral_constant<int, i>) for i = 0 .. N - 1, unrolled: every
// table index is a constant expression, so device code reads the host
// tables only as immediates
template <int N, typename F>
__device__ __forceinline__ void static_for(F&& f) {
    static_for_(f, std::make_integer_sequence<int, N>{});
}

// y[i] = sum_k M_N[i][k] x[k], M_N[i][k] = M_32[i * 32 / N][k]. The even
// outputs are the N/2-point transform of e[k] = x[k] + x[N-1-k], the odd
// ones the products of o[k] = x[k] - x[N-1-k] with the odd rows (k < N/2,
// so only the matrix's first 16 columns are read).
template <int N>
__device__ __forceinline__ void fdct(const int (&x)[N], int (&y)[N]) {
    if constexpr (N == 1) {
        constexpr int c00 = kDct[0][0];
        y[0] = c00 * x[0];
    } else {
        int e[N / 2], o[N / 2], ye[N / 2];
#pragma unroll
        for (int k = 0; k < N / 2; ++k) {
            e[k] = x[k] + x[N - 1 - k];
            o[k] = x[k] - x[N - 1 - k];
        }
        fdct<N / 2>(e, ye);
        static_for<N / 2>([&](auto I) {
            constexpr int i = decltype(I)::value;
            y[2 * i] = ye[i];
            int acc = 0;
            static_for<N / 2>([&](auto K) {
                constexpr int k = decltype(K)::value;
                constexpr int coef = kDct[(2 * i + 1) * (32 / N)][k];
                acc += coef * o[k];
            });
            y[2 * i + 1] = acc;
        });
    }
}

template <int N, bool DST>
__device__ __forceinline__ void transform(const int (&x)[N], int (&y)[N]) {
    if constexpr (DST) {
        static_for<4>([&](auto I) {
            constexpr int i = decltype(I)::value;
            int acc = 0;
            static_for<4>([&](auto K) {
                constexpr int k = decltype(K)::value;
                constexpr int coef = kDst[i][k];
                acc += coef * x[k];
            });
            y[i] = acc;
        });
    } else {
        fdct<N>(x, y);
    }
}

template <int LOG2, bool DST>
__global__ void __launch_bounds__(kThreads)
fwd_transform_kernel(const int32_t* __restrict__ in,
                     int32_t* __restrict__ out, int B, int shift1) {
    constexpr int N = 1 << LOG2;
    constexpr int NN = N * N;
    constexpr int S = N + 1;             // padded row stride
    constexpr int TPB = kThreads / N;    // blocks per thread block
    constexpr int ITER = TPB * NN / (4 * kThreads);
    constexpr int shift2 = LOG2 + 6;
    __shared__ int s[TPB * N * S];

    const int t = threadIdx.x;
    const int b0 = blockIdx.x * TPB;
    const int count = min(TPB, B - b0);
    const int32_t* src = in + (size_t)b0 * NN;
    int32_t* dst = out + (size_t)b0 * NN;

#pragma unroll
    for (int it = 0; it < ITER; ++it) {
        const int i = (t + it * kThreads) * 4;
        if (i / NN < count) {
            const int4 v = *reinterpret_cast<const int4*>(src + i);
            int* d = s + i / NN * N * S + i / N % N * S + i % N;
            d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;
        }
    }
    __syncthreads();

    const int u = t / N;                 // this thread's block
    const int r = t % N;                 // and its row, then its column
    int* blk = s + u * N * S;
    if (u < count) {                     // rows: t = (M r^T)^T >> shift1
        int x[N], y[N];
#pragma unroll
        for (int k = 0; k < N; ++k) x[k] = blk[r * S + k];
        transform<N, DST>(x, y);
        const int rnd = 1 << (shift1 - 1);
#pragma unroll
        for (int k = 0; k < N; ++k) blk[r * S + k] = (y[k] + rnd) >> shift1;
    }
    __syncthreads();
    if (u < count) {                     // columns: c = M t >> shift2
        int x[N], y[N];
#pragma unroll
        for (int k = 0; k < N; ++k) x[k] = blk[k * S + r];
        transform<N, DST>(x, y);
        constexpr int rnd = 1 << (shift2 - 1);
#pragma unroll
        for (int k = 0; k < N; ++k) blk[k * S + r] = (y[k] + rnd) >> shift2;
    }
    __syncthreads();

#pragma unroll
    for (int it = 0; it < ITER; ++it) {
        const int i = (t + it * kThreads) * 4;
        if (i / NN < count) {
            const int* d = s + i / NN * N * S + i / N % N * S + i % N;
            *reinterpret_cast<int4*>(dst + i) = make_int4(d[0], d[1], d[2],
                                                          d[3]);
        }
    }
}

template <int LOG2, bool DST>
void launch(const int32_t* in, int32_t* out, int B, int shift1,
            cudaStream_t stream) {
    constexpr int TPB = kThreads >> LOG2;
    const unsigned grid = (unsigned)((B + TPB - 1) / TPB);
    fwd_transform_kernel<LOG2, DST><<<grid, kThreads, 0, stream>>>(
        in, out, B, shift1);
}

}  // namespace

// in, out: (B, N, N) int32, contiguous and 16-byte aligned on the device,
// N = 1 << log2 in 4..32; use_dst (N = 4 only) takes the DST; bit_depth in
// 8..12. Launches on `stream` and returns cudaGetLastError() (0 on success,
// cudaErrorInvalidValue for another size, bit depth or a DST not 4x4);
// never synchronises.
extern "C" int fwd_transform_launch(const void* in, void* out, int B,
                                    int log2, int use_dst, int bit_depth,
                                    void* stream) {
    if (bit_depth < 8 || bit_depth > 12 || (use_dst && log2 != 2))
        return (int)cudaErrorInvalidValue;
    if (B > 0) {
        const int32_t* i = (const int32_t*)in;
        int32_t* o = (int32_t*)out;
        const int shift1 = log2 + bit_depth - 9;
        cudaStream_t st = (cudaStream_t)stream;
        switch (log2) {
            case 2:
                if (use_dst) launch<2, true>(i, o, B, shift1, st);
                else launch<2, false>(i, o, B, shift1, st);
                break;
            case 3: launch<3, false>(i, o, B, shift1, st); break;
            case 4: launch<4, false>(i, o, B, shift1, st); break;
            case 5: launch<5, false>(i, o, B, shift1, st); break;
            default: return (int)cudaErrorInvalidValue;
        }
    }
    return (int)cudaGetLastError();
}
