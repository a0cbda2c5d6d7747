// The encoder's 15 subpel planes of one reference plane, for Hopper
// (sm_90a).
//
// Replaces the XLA program turingcodec_tpu/encode/device_analysis.py
// _subpel_planes_program (:338, jax.jit :383). From an (h, w) luma plane it
// gives the (15, h + 56, w + 56) int16 planes of enc_core sp_build_plane:
// every fractional position (yf, xf) != (0, 0), yf-major, over the plane
// padded by 28 samples of edge replication. With X, Y the output sample's
// position in the plane (28 less than its position in the padded grid) and
// every plane read clamped to the picture (the same edge replication):
//   H_xf(r, X)   = sum_k f[xf][k] ref[r][X + k - 3] >> (bd - 8)
//   (0, xf > 0)  = H_xf(Y, X)
//   (yf > 0, 0)  = sum_k f[yf][k] ref[Y + k - 3][X] >> (bd - 8)
//   (yf, xf > 0) = sum_k f[yf][k] H_xf(Y + k - 3, X) >> 6,
// each truncated to int16 as torch's .to(torch.int16) does. Every sum is
// exact in int32 for any int16 sample (|H| <= 112 * 2^15). The filter taps
// are compiled in as immediates from hevc/tables.py LUMA_FILTER by
// ops/kernel_build.py.
//
// What bounds it. At 1080p the output is 15 x 1136 x 1976 int16, 67.3 MB,
// against a 4.1 MB plane read: 21.3 us at 3.35 TB/s. The multiply-adds (3 x
// 8 per sample of the horizontal pass, 12 x 8 per output sample) take about
// 16 us at the INT32 issue rate. Writing the output bounds it.
//
// Design. One launch per plane. A CTA owns a tile of 32 output rows by 64
// output columns of every plane. It
//   1. reads the 39 x 71 plane samples the tile's taps reach, clamped to the
//      picture (no padded copy), into shared memory as int32;
//   2. computes the three horizontal phases once per sample of the tile's
//      39 rows, into shared memory (int32: exact whatever the samples);
//   3. gives each thread 8 consecutive output columns of one row: per
//      horizontal phase it reads the 8 x 8 sources of its vertical taps as
//      two 16-byte shared loads per row, forms the three vertical phases,
//      and writes each plane's 8 samples with one 16-byte streaming store
//      (st.global.cs); a warp's store covers 4 rows of 128 contiguous bytes.
// Where the padded width is not a multiple of 8 (16-byte stores would be
// misaligned), or at a ragged tile edge, the samples are stored one by one.
#include <cuda_runtime.h>
#include <stdint.h>

#ifndef TC_LUMA_FILTER
#error "TC_LUMA_FILTER undefined: build with ops/kernel_build.py, which pre-includes hevc/tables.py's luma filter"
#endif

namespace {

constexpr int kPad = 28;        // enc_core SP_P
constexpr int kTileX = 64;      // output columns of a tile
constexpr int kTileY = 32;      // output rows of a tile
constexpr int kThreads = kTileY * kTileX / 8;
constexpr int kRows = kTileY + 7;
constexpr int kCols = kTileX + 7;
constexpr int kInStride = kTileX + 8;

__device__ inline uint32_t pack2(int a, int b) {
    return (uint32_t)(uint16_t)(int16_t)a
           | ((uint32_t)(uint16_t)(int16_t)b << 16);
}

__global__ void __launch_bounds__(kThreads)
subpel_planes_kernel(const int16_t* __restrict__ ref, int w, int h, int pw,
                     int ph, int shift1, int vec,
                     int16_t* __restrict__ out) {
    // the (4 phases, 8 taps) luma filter; folded into the arithmetic
    constexpr int f[4][8] = {TC_LUMA_FILTER};
    __shared__ __align__(16) int32_t s_in[kRows][kInStride];
    __shared__ __align__(16) int32_t s_h[3][kRows][kTileX];
    const int tid = threadIdx.x;
    const int ox0 = blockIdx.x * kTileX, oy0 = blockIdx.y * kTileY;
    // plane position of the tile's first source sample
    const int x0 = ox0 - kPad - 3, y0 = oy0 - kPad - 3;

    // 1. the sources, clamped to the picture
    for (int i = tid; i < kRows * kCols; i += kThreads) {
        const int r = i / kCols, c = i - r * kCols;
        const int y = min(max(y0 + r, 0), h - 1);
        const int x = min(max(x0 + c, 0), w - 1);
        s_in[r][c] = __ldg(ref + (size_t)y * w + x);
    }
    __syncthreads();

    // 2. the horizontal phases 1..3 of every source row
    for (int i = tid; i < kRows * kTileX; i += kThreads) {
        const int r = i / kTileX, c = i - r * kTileX;
        int v[8];
#pragma unroll
        for (int t = 0; t < 8; ++t) v[t] = s_in[r][c + t];
#pragma unroll
        for (int p = 1; p < 4; ++p) {
            int acc = 0;
#pragma unroll
            for (int t = 0; t < 8; ++t) acc += f[p][t] * v[t];
            s_h[p - 1][r][c] = acc >> shift1;
        }
    }
    __syncthreads();

    // 3. 8 columns of one output row, all 15 planes
    const int cx = (tid & 7) * 8, r = tid >> 3;
    const int oy = oy0 + r, ox = ox0 + cx;
    if (oy >= ph || ox >= pw) return;
    const size_t plane = (size_t)ph * pw;
    int16_t* o = out + (size_t)oy * pw + ox;
    const bool full = vec && ox + 8 <= pw;
    const int n = min(8, pw - ox);
    auto store = [&](int p, const int (&val)[8]) {
        int16_t* d = o + p * plane;
        if (full) {
            int4 q = make_int4(pack2(val[0], val[1]), pack2(val[2], val[3]),
                               pack2(val[4], val[5]), pack2(val[6], val[7]));
            __stcs(reinterpret_cast<int4*>(d), q);
        } else {
            for (int e = 0; e < n; ++e) d[e] = (int16_t)val[e];
        }
    };
#pragma unroll
    for (int xf = 0; xf < 4; ++xf) {
        // rows r .. r + 7 of the source: the plane itself for xf = 0
        int v[8][8];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
            if (xf == 0) {
#pragma unroll
                for (int e = 0; e < 8; ++e) v[k][e] = s_in[r + k][cx + 3 + e];
            } else {
                const int4* s = reinterpret_cast<const int4*>(
                    &s_h[xf - 1][r + k][cx]);
                const int4 a = s[0], b = s[1];
                v[k][0] = a.x; v[k][1] = a.y; v[k][2] = a.z; v[k][3] = a.w;
                v[k][4] = b.x; v[k][5] = b.y; v[k][6] = b.z; v[k][7] = b.w;
            }
        }
        if (xf) store(xf - 1, v[3]);
#pragma unroll
        for (int yf = 1; yf < 4; ++yf) {
            int val[8];
#pragma unroll
            for (int e = 0; e < 8; ++e) {
                int acc = 0;
#pragma unroll
                for (int k = 0; k < 8; ++k) acc += f[yf][k] * v[k][e];
                val[e] = acc >> (xf ? 6 : shift1);
            }
            store(yf * 4 + xf - 1, val);
        }
    }
}

}  // namespace

// ref: (h, w) int16; out: (15, h + 56, w + 56) int16; both contiguous on
// the device; bit_depth in 8..16. Launches on `stream` and returns
// cudaGetLastError() (0 on success, cudaErrorInvalidValue for a bit depth
// outside 8..16 or an empty plane); never synchronises.
extern "C" int subpel_planes_launch(const void* ref, int w, int h,
                                    int bit_depth, void* out, void* stream) {
    if (bit_depth < 8 || bit_depth > 16 || w < 1 || h < 1)
        return (int)cudaErrorInvalidValue;
    const int pw = w + 2 * kPad, ph = h + 2 * kPad;
    const int vec = pw % 8 == 0
                    && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
    const dim3 grid((pw + kTileX - 1) / kTileX, (ph + kTileY - 1) / kTileY);
    subpel_planes_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const int16_t*)ref, w, h, pw, ph, bit_depth - 8, vec,
        (int16_t*)out);
    return (int)cudaGetLastError();
}
