// Residuals of a picture's coded inter TUs, added to its predicted planes,
// in one launch, for Hopper (sm_90a).
//
// Replaces the XLA programs turingcodec_tpu/ops/quant.py dequant_batch and
// turingcodec_tpu/ops/transform.py inverse_transform_batch (its two int32
// einsums), with the transform-skip arm and the add/clip of
// turingcodec_tpu/decode/device_pipeline.py _residuals_device. Each row of
// the TU table is (x, y, qp, kind), kind = mode | log2 << 2 | comp << 5
// (ops/transform.py tu_kind). For a TU of N = 1 << log2 samples (N in
// 4..32) of component comp at bit depth bd:
//   d = clip16(((level * LEVEL_SCALE[qp % 6] * 16 + rnd) >> sh_pos) << sh_neg)
//       with shift = bd + log2 - 5 - qp / 6 split into its positive and
//       negative parts (rnd = 1 << (shift - 1) when shift > 0),
//   mode 0: g = clip16((M^T d + 64) >> 7), r = clip16((g M + rnd2) >> (20 - bd)),
//   mode 1: r = clip16(((d << 7) + rnd2) >> (20 - bd))   (transform skip),
//   mode 2: r = level                                    (transquant bypass),
//   plane = clip(plane + r, 0, (1 << bd) - 1), in place.
// A second instance (CLIP false) adds with the int16 clip instead of the
// sample range's: over zero planes it leaves the residuals themselves,
// which the batched GOP stage (parallel/gop_decode.py) returns.
// Every sum stays below 2^27 in int32 (|d| <= 32768, |M| <= 90, N <= 32),
// so the result is exact. Float32 would not be, and the tensor cores' int8
// path does not take 16-bit operands, so this is integer work on the CUDA
// cores. LEVEL_SCALE comes in from the wrapper and the DCT coefficients
// are compiled in by ops/kernel_build.py, both from hevc/tables.py, so each
// table lives in one place.
//
// What bounds it. A picture's work is a few hundred to a few thousand TUs
// over three components and four sizes. Per coded sample the kernel must
// read 2 bytes of level and 2 of predicted sample and write 2: about 2.4
// MB, 0.7 us at 3.35 TB/s, for a 1080p P picture of 400,000 coded samples.
// The operations are one dequantizing multiply per sample and, with the
// even-odd (partial butterfly) decomposition, 2 * idct_ops(N) / N (12.6 at
// N = 32) integer multiply-adds per sample and stage; at 16.7 T INT32 op/s
// that is a little less. So bytes bound it, and at these sizes a launch is
// one wave whose time is the latency of one thread block's chain: its TU
// rows, then its levels, then two butterfly passes, then the stores. The
// design therefore adds nothing to that chain: no launch per (component,
// size, mode) bucket, no int32 copies of the levels or residuals in device
// memory, and no full matrix product (N multiply-adds and two shared loads
// per coefficient and stage).
//
// Design. One launch per picture: the host sorts the table by size,
// largest first, and a thread block of 128 threads takes one size and 1024
// coefficients (one 32x32, four 16x16, sixteen 8x8) or 512 (thirty-two
// 4x4). It stages its TU rows in shared memory, then requests all its
// levels and predicted samples at once, 4 samples of a row (8 bytes) per
// thread and access, straight from the int16 planes; it dequantizes the
// levels into shared memory (modes 1 and 2 finish there) and keeps the
// predicted samples in registers. It runs the column pass and the row pass
// as partial butterflies out of shared memory (rows padded to N + 1 words,
// so neither pass has bank conflicts) with the 16-bit clip between them,
// and adds and clips into the planes with the same 8-byte accesses. A 32x32
// column is split over four threads and a 16x16 column over two, each
// thread computing the outputs whose butterfly halves it owns, so a 32x32
// TU keeps 128 threads busy. The split is warp-uniform, so every
// coefficient is a compile-time immediate: read from the kernel's
// parameters instead, each costs a constant-cache miss, which nearly
// doubled the time. TUs are disjoint within a component, so the in-place
// writes do not race.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>
#include <utility>

#ifndef TC_DCT32_HALF
#error "TC_DCT32_HALF undefined: build with ops/kernel_build.py, which pre-includes hevc/tables.py's DCT"
#endif

namespace {

// columns 0..15 of the 32-point DCT matrix, row-major, compiled in from
// hevc/tables.py dct2_matrix(32) by ops/kernel_build.py
constexpr int kDct[32][16] = {TC_DCT32_HALF};

constexpr int kThreads = 128;
constexpr int kSizes = 4;            // log2 5, 4, 3, 2: the table's order
constexpr int kTileWords = 1152;     // the largest TUs x N x (N + 1): 8x8
constexpr int kVec = 4;              // samples per 8-byte global access

struct Params {
    const int16_t* coeff[3];         // level planes, Y Cb Cr
    int16_t* plane[3];               // predicted planes, updated in place
    int width[3];                    // row stride of both, in samples
    int bit_depth[3];
    int level_scale[6];
    int rows[kSizes];                // table rows of each size
    int row0[kSizes];                // the size's first row
    int cta0[kSizes + 1];            // the size's first thread block
};

// the thread block's share of each size: TUs, and parts per column
__host__ __device__ constexpr int parts(int n) {
    return n == 32 ? 4 : n == 16 ? 2 : 1;
}
__host__ __device__ constexpr int tus_per_block(int n) {
    return kThreads / 32 / parts(n) * (32 / n);
}

__device__ __forceinline__ int clip16(int v) {
    return min(max(v, -32768), 32767);
}

template <typename F, int... I>
__device__ __forceinline__ void static_for_(F& f,
                                            std::integer_sequence<int, I...>) {
    (f(std::integral_constant<int, I>{}), ...);
}

// f(std::integral_constant<int, i>) for i = 0 .. N - 1, unrolled
template <int N, typename F>
__device__ __forceinline__ void static_for(F&& f) {
    static_for_(f, std::make_integer_sequence<int, N>{});
}

// The n-point inverse DCT pairs its outputs k and n - 1 - k (k < n / 2):
// both are E[k] +- O[k], E the n/2-point transform of the even inputs and
// O the odd inputs' products. A column split over P parts gives part J the
// pair J at level 2P; at each level above, a part owns the pairs whose
// even half reads one of its own outputs; below 2P every part computes
// every pair (a few multiply-adds).
__host__ __device__ constexpr bool owns(int n, int k, int P, int J) {
    if (n < 2 * P) return true;
    while (n > 2 * P) {
        const int h = n / 2;
        if (k >= h / 2) k = h - 1 - k;
        n = h;
    }
    return k == J;
}

// Part J of P of the N-point inverse DCT of v: e[k] = sum_i M_N[i][k] v[i]
// for the outputs k of the pairs it owns (the same integers as the matrix
// product: every partial sum is exact), then store(k, e[k]) for each.
// M_N[i][k] = M_32[i * 32 / N][k], and only k < 16 is read.
template <int LOG2, int P, int J, typename Store>
__device__ __forceinline__ void idct_part(const int (&v)[1 << LOG2],
                                          Store&& store) {
    constexpr int N = 1 << LOG2;
    constexpr int c00 = kDct[0][0];  // a constant expression: device code
    int e[N];                         // reads kDct only in one
    e[0] = c00 * v[0];
    static_for<LOG2>([&](auto L) {
        constexpr int n = 2 << decltype(L)::value;
        static_for<n / 2>([&](auto K) {
            constexpr int k = decltype(K)::value;
            if constexpr (owns(n, k, P, J)) {
                int o = 0;
                static_for<n / 2>([&](auto M) {
                    constexpr int m = 2 * decltype(M)::value + 1;
                    constexpr int coef = kDct[m * (32 / n)][k];
                    o += coef * v[m * (N / n)];
                });
                const int t = e[k];
                e[k] = t + o;
                e[n - 1 - k] = t - o;
            }
        });
    });
    static_for<N>([&](auto K) {
        constexpr int k = decltype(K)::value;
        if constexpr (owns(N, k < N / 2 ? k : N - 1 - k, P, J)) store(k, e[k]);
    });
}

// idct_part for the warp-uniform part j
template <int LOG2, typename Store>
__device__ __forceinline__ void idct_column(int j, const int (&v)[1 << LOG2],
                                            Store&& store) {
    constexpr int P = parts(1 << LOG2);
    static_for<P>([&](auto J) {
        if (j == decltype(J)::value)
            idct_part<LOG2, P, decltype(J)::value>(v, store);
    });
}

template <typename T>
__device__ __forceinline__ T pick(const T (&a)[3], int c) {
    return c == 0 ? a[0] : c == 1 ? a[1] : a[2];
}

__device__ __forceinline__ int dequant(int level, int qp, int bd, int log2,
                                       const Params& p) {
    const int q6 = qp / 6;           // qp >= 0: the wrapper checks it
    const int r6 = qp - 6 * q6;
    int ls = p.level_scale[0];
    static_for<6>([&](auto I) {
        if (r6 == decltype(I)::value) ls = p.level_scale[decltype(I)::value];
    });
    const int shift = bd + log2 - 5 - q6;
    const int prod = level * ls * 16;
    if (shift > 0) return clip16((prod + (1 << (shift - 1))) >> shift);
    return clip16((int)((unsigned)prod << -shift));
}

// One thread block's TUs of one size: rows first .. first + count - 1.
template <int LOG2, bool CLIP>
__device__ __forceinline__ void tu_block(const Params& p,
                                         const int4* __restrict__ table,
                                         int first, int count, int* s_a,
                                         int* s_g, int4* s_tu) {
    constexpr int N = 1 << LOG2;
    constexpr int NN = N * N;
    constexpr int S = N + 1;         // padded row stride in shared memory
    constexpr int TS = N * S;
    constexpr int P = parts(N);
    constexpr int TPB = tus_per_block(N);
    constexpr int ITER = TPB * NN / (kVec * kThreads);
    static_assert(TPB * TS <= kTileWords, "tile exceeds shared memory");
    static_assert(ITER * kVec * kThreads == TPB * NN, "uneven tile");
    const int t = threadIdx.x;
    if (t < count) s_tu[t] = table[first + t];
    __syncthreads();

    // each thread's kVec samples of a row, ITER times: the levels and the
    // predicted samples are all requested before any is used, and the
    // predicted ones wait in registers for the add
    short4 lv[ITER], pred[ITER];
#pragma unroll
    for (int it = 0; it < ITER; ++it) {
        const int i = (t + it * kThreads) * kVec;
        const int u = i / NN;
        if (u < count) {
            const int4 r = s_tu[u];
            const int comp = r.w >> 5;
            const size_t off = (size_t)(r.y + i / N % N) * pick(p.width, comp)
                               + r.x + i % N;
            lv[it] = *reinterpret_cast<const short4*>(pick(p.coeff, comp)
                                                      + off);
            pred[it] = *reinterpret_cast<const short4*>(pick(p.plane, comp)
                                                        + off);
        }
    }
    // the dequantized coefficients (mode 0) or the residual itself
#pragma unroll
    for (int it = 0; it < ITER; ++it) {
        const int i = (t + it * kThreads) * kVec;
        const int u = i / NN;
        if (u < count) {
            const int4 r = s_tu[u];
            const int comp = r.w >> 5;
            const int mode = r.w & 3;
            const int bd = pick(p.bit_depth, comp);
            const int sh = 20 - bd;
            const int level[kVec] = {lv[it].x, lv[it].y, lv[it].z, lv[it].w};
            int* dst = s_a + u * TS + i / N % N * S + i % N;
#pragma unroll
            for (int q = 0; q < kVec; ++q) {
                int v = level[q];
                if (mode != 2) {
                    v = dequant(v, r.z, bd, LOG2, p);
                    if (mode == 1)
                        v = clip16((v * 128 + (1 << (sh - 1))) >> sh);
                }
                dst[q] = v;
            }
        }
    }
    __syncthreads();

    // the warp's part and the thread's TU and column (or row)
    const int w = t / 32;
    const int lane = t % 32;
    const int j = w % P;
    const int u = w / P * (32 / N) + lane / N;
    const int c = lane % N;
    const bool active = u < count && (s_tu[u].w & 3) == 0;
    int* ga = s_a + u * TS;
    int* gg = s_g + u * TS;
    if (active) {                    // columns: g = clip16((M^T d + 64) >> 7)
        int v[N];
#pragma unroll
        for (int k = 0; k < N; ++k) v[k] = ga[k * S + c];
        idct_column<LOG2>(j, v, [&](int k, int e) {
            gg[k * S + c] = clip16((e + 64) >> 7);
        });
    }
    __syncthreads();
    if (active) {                    // rows: r = clip16((g M + rnd) >> sh)
        const int sh = 20 - pick(p.bit_depth, s_tu[u].w >> 5);
        const int rnd = 1 << (sh - 1);
        int v[N];
#pragma unroll
        for (int k = 0; k < N; ++k) v[k] = gg[c * S + k];
        idct_column<LOG2>(j, v, [&](int k, int e) {
            ga[c * S + k] = clip16((e + rnd) >> sh);
        });
    }
    __syncthreads();

    // the residual onto the predicted samples, clipped, kVec at a time
#pragma unroll
    for (int it = 0; it < ITER; ++it) {
        const int i = (t + it * kThreads) * kVec;
        const int u2 = i / NN;
        if (u2 < count) {
            const int4 r = s_tu[u2];
            const int comp = r.w >> 5;
            const int max_v = (1 << pick(p.bit_depth, comp)) - 1;
            const int* res = s_a + u2 * TS + i / N % N * S + i % N;
            const int pr[kVec] = {pred[it].x, pred[it].y, pred[it].z,
                                  pred[it].w};
            int o[kVec];
#pragma unroll
            for (int q = 0; q < kVec; ++q)
                o[q] = CLIP ? min(max(pr[q] + res[q], 0), max_v)
                            : clip16(pr[q] + res[q]);
            const size_t off = (size_t)(r.y + i / N % N) * pick(p.width, comp)
                               + r.x + i % N;
            *reinterpret_cast<short4*>(pick(p.plane, comp) + off) =
                make_short4(o[0], o[1], o[2], o[3]);
        }
    }
}

template <int S, bool CLIP>
__device__ __forceinline__ void size_class(const Params& p,
                                           const int4* __restrict__ table,
                                           int* s_a, int* s_g, int4* s_tu) {
    constexpr int LOG2 = 5 - S;
    constexpr int TPB = tus_per_block(1 << LOG2);
    const int b = blockIdx.x - p.cta0[S];
    tu_block<LOG2, CLIP>(p, table, p.row0[S] + b * TPB,
                   min(TPB, p.rows[S] - b * TPB), s_a, s_g, s_tu);
}

template <bool CLIP>
__global__ void __launch_bounds__(kThreads)
dequant_idct_add_kernel(const Params p, const int4* __restrict__ table) {
    __shared__ int s_a[kTileWords];
    __shared__ int s_g[kTileWords];
    __shared__ int4 s_tu[32];
    // the size whose blocks hold this one (an empty size's range is empty)
    int cls = 0;
    static_for<kSizes - 1>([&](auto I) {
        constexpr int s = decltype(I)::value + 1;
        if ((int)blockIdx.x >= p.cta0[s]) cls = s;
    });
    switch (cls) {
        case 0: size_class<0, CLIP>(p, table, s_a, s_g, s_tu); break;
        case 1: size_class<1, CLIP>(p, table, s_a, s_g, s_tu); break;
        case 2: size_class<2, CLIP>(p, table, s_a, s_g, s_tu); break;
        default: size_class<3, CLIP>(p, table, s_a, s_g, s_tu); break;
    }
}

}  // namespace

// planes: 6 device pointers to contiguous int16 planes, the level planes
// of Y, Cb, Cr then the predicted planes of Y, Cb, Cr (updated in place);
// hw: (H, W) of each component; bit_depths: 3; table: (T, 4) int32 rows on
// the device, sorted by size, largest first; counts: the rows of log2 5, 4,
// 3 and 2; level_scale: 6; clip: nonzero clips each sum to the sample
// range, 0 to the int16 range. Every array but the planes and the table is
// on the host. The wrapper (ops/transform.py) has checked that every TU lies in
// its plane and its QP in 0..51 + 6 * (bd - 8). Launches on `stream` and
// returns cudaGetLastError() (0 on success, cudaErrorInvalidValue for a
// negative count or a bit depth outside 8..12); never synchronises.
extern "C" int dequant_idct_add_launch(const void* const* planes,
                                       const int* hw, const int* bit_depths,
                                       const void* table, const int* counts,
                                       const int* level_scale, int clip,
                                       void* stream) {
    Params p = {};
    for (int c = 0; c < 3; ++c) {
        if (bit_depths[c] < 8 || bit_depths[c] > 12)
            return (int)cudaErrorInvalidValue;
        p.coeff[c] = (const int16_t*)planes[c];
        p.plane[c] = (int16_t*)planes[3 + c];
        p.width[c] = hw[2 * c + 1];
        p.bit_depth[c] = bit_depths[c];
    }
    for (int i = 0; i < 6; ++i) p.level_scale[i] = level_scale[i];
    int row = 0, cta = 0;
    for (int s = 0; s < kSizes; ++s) {
        if (counts[s] < 0) return (int)cudaErrorInvalidValue;
        const int tpb = tus_per_block(32 >> s);
        p.rows[s] = counts[s];
        p.row0[s] = row;
        p.cta0[s] = cta;
        row += counts[s];
        cta += (counts[s] + tpb - 1) / tpb;
    }
    p.cta0[kSizes] = cta;
    cudaStream_t st = (cudaStream_t)stream;
    if (cta > 0 && clip)
        dequant_idct_add_kernel<true><<<cta, kThreads, 0, st>>>(
            p, (const int4*)table);
    else if (cta > 0)
        dequant_idct_add_kernel<false><<<cta, kThreads, 0, st>>>(
            p, (const int4*)table);
    return (int)cudaGetLastError();
}
