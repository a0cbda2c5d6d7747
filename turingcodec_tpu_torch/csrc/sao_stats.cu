// The encoder's SAO statistics, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package estimates SAO on the host
// (turingcodec_tpu/encode/sao_search.py, its native twin tc_sao_estimate).
// Added because the estimate's gather, one thread and one CTB at a time
// with four branchy passes over each CTB, took about a third of every
// random-access picture's encode while the card idled. The gather reads
// only the source and the deblocked planes and checks only the picture's
// edges, so every (CTB, component) block of statistics is independent;
// only the raster-order decision over them (native tc_sao_decide) reads
// the left and upper CTBs' chosen parameters, and it stays on the host.
//
// Computes, per CTB of each component, the 96 int32 of native/enc_core.cpp
// SaoStats (ops/sao_stats.py sao_stats_plane is the plain version, and a
// CPU test holds that to the native gather): per edge class eo (0..3) and
// category k (1..4, the sign remap of the two neighbours along eo) the
// count and the error sum (source minus deblocked) of the samples whose
// two neighbours lie in the picture, then per band (sample >> (bd - 5))
// the count and the error sum. Integer sums, so any order gives the same
// values; exact for CTBs up to 64x64 and samples of 16 bits.
//
// What bounds it. A 1080p 4:2:0 picture's source and deblocked planes
// are 12.4 MB of int16, each read once: 3.7 us at 3.35 TB/s. Per sample
// and edge class the two differences, their signs, their sum, the
// category and the two sums, and for the band its index, the error and
// the two sums: 36 INT32 operations, 112 M a picture, 6.7 us at 16.7 T
// op/s. Operations bound it, and the bytes come close.
//
// Design: one CTA of 128 threads per (CTB, component), blockIdx.x the
// CTB in raster order, blockIdx.y the component (a 64x64 luma or 32x32
// chroma tile at 1080p).
//   1. The deblocked tile with a one-sample halo goes into shared memory,
//      16-byte loads where 8 samples lie inside the row at a 16-byte
//      address (the halo columns and a ragged edge sample at a time; rows
//      and columns past the picture clamped to its edge: such samples are
//      never counted and never a counted sample's neighbour). The source
//      is read straight from device memory, 16 bytes at a time.
//   2. A thread takes 8 consecutive samples of a row at a time: its three
//      rows of 10 deblocked samples from shared memory, the classes' signs
//      without branches, the 16 (count, error sum) pairs of the edge
//      classes summed in registers; the band's (count, error sum) summed
//      over each run of equal bands along the 8 samples, then added to
//      its warp's histogram in shared memory by shared atomics (smooth
//      content gives one pair of atomics for 8 samples, and fewer lanes
//      of a warp on one bin at once). The picture's edges mask samples
//      per class (a ragged bottom or right CTB likewise).
//   3. The pairs are summed across the warp with __shfl_xor_sync and
//      across the 4 warps in shared memory, the histograms across the
//      warps, and 96 threads write the CTB's 96 int32.
// A CTB of a chroma grid that lies wholly past its plane (a width or
// height of the luma grid that halves to fewer CTBs) writes zeros, as the
// native gather does.
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxS = 64;              // tile side, at most
constexpr int kPad = 8;                // staged column of the tile's x0
constexpr int kPitch = kMaxS + 2 * kPad;
constexpr int kRows = kMaxS + 2;
constexpr int kStats = 96;
constexpr int kMaxComp = 3;

struct Plane {
    const int16_t* org;
    const int16_t* rec;
    int h, w, log2s, bd;
};

struct Params {
    Plane pl[kMaxComp];
    int wc;
    int32_t* out;
};

__device__ __forceinline__ int sgn(int d) { return (d > 0) - (d < 0); }

__device__ __forceinline__ bool aligned16(const void* p) {
    return ((uintptr_t)p & 15) == 0;
}

// the 8 int16 of a 16-byte load, sign-extended
__device__ __forceinline__ void unpack8(const int4 v, int* out) {
    const int words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        out[2 * i] = (int)(int16_t)(words[i] & 0xffff);
        out[2 * i + 1] = words[i] >> 16;
    }
}

__global__ void __launch_bounds__(kThreads)
sao_stats_kernel(const Params P) {
    __shared__ __align__(16) int16_t tile[kRows][kPitch];
    __shared__ int hist_n[kWarps][32];
    __shared__ int hist_e[kWarps][32];
    __shared__ int red[kWarps][32];

    const int c = blockIdx.y;
    // selected, not indexed: a parameter indexed by a run-time value
    // would be copied to the stack
    const Plane pl = c == 0 ? P.pl[0] : c == 1 ? P.pl[1] : P.pl[2];
    const int S = 1 << pl.log2s;
    const int cy = blockIdx.x / P.wc, cx = blockIdx.x % P.wc;
    const int y0 = cy << pl.log2s, x0 = cx << pl.log2s;
    const int h = pl.h, w = pl.w;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    int32_t* out = P.out + ((size_t)blockIdx.x * gridDim.y + c) * kStats;
    if (y0 >= h || x0 >= w) {
        if (tid < kStats)
            out[tid] = 0;
        return;
    }

    // 1. stage the deblocked tile and its halo
    hist_n[warp][lane] = 0;
    hist_e[warp][lane] = 0;
    const int chunks = S >> 3;
    for (int i = tid; i < (S + 2) * (chunks + 2); i += kThreads) {
        const int row = i / (chunks + 2), j = i % (chunks + 2);
        const int gy = min(max(y0 - 1 + row, 0), h - 1);
        const int16_t* src = pl.rec + (size_t)gy * w;
        if (j < chunks) {
            const int gx = x0 + 8 * j;
            int16_t* dst = &tile[row][kPad + 8 * j];
            if (gx + 8 <= w && aligned16(src + gx)) {
                *(int4*)dst = *(const int4*)(src + gx);
            } else {
                for (int k = 0; k < 8; ++k)
                    dst[k] = src[min(gx + k, w - 1)];
            }
        } else {
            // the halo columns x0 - 1 and x0 + S
            const int gx = j == chunks ? x0 - 1 : x0 + S;
            tile[row][j == chunks ? kPad - 1 : kPad + S] =
                src[min(max(gx, 0), w - 1)];
        }
    }
    __syncthreads();

    // 2. classify 8 samples of a row at a time
    int cnt[16], esum[16];
#pragma unroll
    for (int i = 0; i < 16; ++i)
        cnt[i] = esum[i] = 0;
    const int shift = pl.bd - 5;
    for (int i = tid; i < S * chunks; i += kThreads) {
        const int row = i / chunks, j = i % chunks;
        const int gy = y0 + row;
        if (gy >= h)
            continue;
        const int gx = x0 + 8 * j;
        int r[3][10];   // rows above, at and below; columns gx - 1 .. gx + 8
#pragma unroll
        for (int d = 0; d < 3; ++d) {
            const int16_t* t = &tile[row + d][kPad + 8 * j];
            r[d][0] = t[-1];
            unpack8(*(const int4*)t, &r[d][1]);
            r[d][9] = t[8];
        }
        int o[8];
        const int16_t* org = pl.org + (size_t)gy * w + gx;
        if (gx + 8 <= w && aligned16(org)) {
            unpack8(*(const int4*)org, o);
        } else {
#pragma unroll
            for (int k = 0; k < 8; ++k)
                o[k] = gx + k < w ? org[k] : 0;
        }
        const bool vert = gy >= 1 && gy + 1 < h;
        int run_b = -1, run_n = 0, run_e = 0;   // the band's current run
#pragma unroll
        for (int k = 0; k < 8; ++k) {
            const int x = gx + k;
            const bool inside = x < w;
            const bool horiz = x >= 1 && x + 1 < w;
            const int rv = r[1][1 + k];
            const int e = o[k] - rv;
            // eo 0: left, right; 1: up, down; 2: up-left, down-right;
            // 3: up-right, down-left
            const int sg[4] = {
                sgn(rv - r[1][k]) + sgn(rv - r[1][2 + k]),
                sgn(rv - r[0][1 + k]) + sgn(rv - r[2][1 + k]),
                sgn(rv - r[0][k]) + sgn(rv - r[2][2 + k]),
                sgn(rv - r[0][2 + k]) + sgn(rv - r[2][k])};
            const bool ok[4] = {inside && horiz, inside && vert,
                                inside && horiz && vert,
                                inside && horiz && vert};
#pragma unroll
            for (int eo = 0; eo < 4; ++eo) {
                // sign sums -2, -1, 1, 2 are categories 1, 2, 3, 4
                const int s = ok[eo] ? sg[eo] : 0;
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                    const bool m = s == (q < 2 ? q - 2 : q - 1);
                    cnt[eo * 4 + q] += m;
                    esum[eo * 4 + q] += m ? e : 0;
                }
            }
            if (inside) {
                const int b = (rv >> shift) & 31;
                if (b != run_b) {
                    if (run_n) {
                        atomicAdd(&hist_n[warp][run_b], run_n);
                        atomicAdd(&hist_e[warp][run_b], run_e);
                    }
                    run_b = b;
                    run_n = run_e = 0;
                }
                ++run_n;
                run_e += e;
            }
        }
        if (run_n) {
            atomicAdd(&hist_n[warp][run_b], run_n);
            atomicAdd(&hist_e[warp][run_b], run_e);
        }
    }

    // 3. sum across the warp, the warps, and write
#pragma unroll
    for (int i = 0; i < 16; ++i) {
#pragma unroll
        for (int m = 16; m >= 1; m >>= 1) {
            cnt[i] += __shfl_xor_sync(0xffffffffu, cnt[i], m);
            esum[i] += __shfl_xor_sync(0xffffffffu, esum[i], m);
        }
    }
    if (lane == 0) {
#pragma unroll
        for (int i = 0; i < 16; ++i) {
            red[warp][i] = cnt[i];
            red[warp][16 + i] = esum[i];
        }
    }
    __syncthreads();
    if (tid < kStats) {
        int v = 0;
        for (int q = 0; q < kWarps; ++q)
            v += tid < 32 ? red[q][tid]
                 : tid < 64 ? hist_n[q][tid - 32] : hist_e[q][tid - 64];
        out[tid] = v;
    }
}

}  // namespace

// org, rec: n_comp plane pointers (int16, rows of w samples); dims per
// component: h, w, log2 of the CTB side, bit depth; the CTB grid hc x wc
// is component 0's, each other component's no larger; out: (hc * wc,
// n_comp, 96) int32. Returns cudaGetLastError() after the launch.
extern "C" int sao_stats_launch(const void* const* org,
                                const void* const* rec, const int* dims,
                                int n_comp, int hc, int wc, void* out,
                                void* stream) {
    if (n_comp < 1 || n_comp > kMaxComp || hc < 1 || wc < 1
        || (long long)hc * wc > 0x7fffffff || out == nullptr)
        return (int)cudaErrorInvalidValue;
    Params P{};
    for (int c = 0; c < n_comp; ++c) {
        const int h = dims[4 * c], w = dims[4 * c + 1];
        const int l = dims[4 * c + 2], bd = dims[4 * c + 3];
        if (h < 1 || w < 1 || l < 3 || l > 6 || bd < 8 || bd > 16
            || org[c] == nullptr || rec[c] == nullptr
            || ((h - 1) >> l) + 1 > hc || ((w - 1) >> l) + 1 > wc
            || (c == 0 && (((h - 1) >> l) + 1 != hc
                           || ((w - 1) >> l) + 1 != wc)))
            return (int)cudaErrorInvalidValue;
        P.pl[c] = Plane{(const int16_t*)org[c], (const int16_t*)rec[c], h, w,
                        l, bd};
    }
    P.wc = wc;
    P.out = (int32_t*)out;
    sao_stats_kernel<<<dim3(hc * wc, n_comp), kThreads, 0,
                       (cudaStream_t)stream>>>(P);
    return (int)cudaGetLastError();
}

// the kernel's resources as the runtime reports them: registers, local
// bytes a thread, shared bytes a CTA, CTAs an SM, threads a CTA, CTAs at
// 1080p (510 CTBs of 64, three components)
extern "C" int sao_stats_occupancy(int* out) {
    cudaFuncAttributes a;
    cudaError_t e = cudaFuncGetAttributes(&a, sao_stats_kernel);
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &out[3], sao_stats_kernel, kThreads, 0);
    if (e != cudaSuccess) return (int)e;
    out[0] = a.numRegs;
    out[1] = (int)a.localSizeBytes;
    out[2] = (int)a.sharedSizeBytes;
    out[4] = kThreads;
    out[5] = ((1920 + kMaxS - 1) / kMaxS) * ((1080 + kMaxS - 1) / kMaxS) * 3;
    return 0;
}
