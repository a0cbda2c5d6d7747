// Per-block fractional motion compensation for Hopper (sm_90a).
//
// Replaces the XLA program turingcodec_tpu/ops/inter.py mc_block_grid (its
// int32 einsums). Every 4x4 luma (2x2 chroma) min-block b of a picture
// carries its PU's motion: a reference index sel[b], the integer top-left
// sample (xi[b], yi[b]) and the fractional phase (xf[b], yf[b]). The kernel
// gathers the (bs + taps - 1)^2 window of refs[sel[b]] around it with every
// coordinate clamped into the plane (the spec's edge extension), then runs
// the separable 8-tap luma or 4-tap chroma filter and writes the 14-bit
// intermediate prediction with the spec's four phase cases:
//   full-pel:  ref << (14 - bd)
//   H only:    sum_k win * fh >> (bd - 8)
//   V only:    sum_k win * fv >> (bd - 8)
//   2-D:       sum_k (H pass >> (bd - 8)) * fv >> 6.
// All sums are exact in int32. The filter table comes in from the wrapper
// (hevc/tables.py LUMA_FILTER / CHROMA_FILTER).
//
// Design: one thread block of 256 threads covers 16 luma (64 chroma) blocks,
// one thread per output sample. The block stages its windows in shared
// memory as int32 (7.7 KB luma, 6.4 KB chroma), runs the horizontal pass of
// every window row once into shared memory, and each thread then takes its
// sample's vertical pass, so no product is computed twice.
//
// Bound on the card: at 1080p one call covers up to 129,600 blocks. The
// windows read 121 int16 samples per 4x4 luma block from refs (31 MB of
// gathers, about 7.6 times the 4 MB plane, so mostly cache hits) and write
// 8.3 MB of int32; the arithmetic is about 62 M multiply-adds (352 for the
// horizontal pass and 128 for the vertical one per block). Both are
// microseconds of the card's peak, so the gathers' latency and the launch
// decide the time; reading each reference row once for a whole PU instead
// of once per min-block is later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <int BS, int TAPS>
__global__ void __launch_bounds__(kThreads)
mc_block_grid_kernel(const int16_t* __restrict__ refs, int R, int H, int W,
                     const int32_t* __restrict__ sel,
                     const int32_t* __restrict__ xi,
                     const int32_t* __restrict__ yi,
                     const int32_t* __restrict__ xf,
                     const int32_t* __restrict__ yf,
                     const int32_t* __restrict__ filt, int B, int shift1,
                     int shift3, int32_t* __restrict__ out) {
    constexpr int SPAN = BS + TAPS - 1;
    constexpr int OFF = TAPS / 2 - 1;
    constexpr int NS = BS * BS;          // outputs per MC block
    constexpr int PER = kThreads / NS;   // MC blocks per thread block
    constexpr int PHASES = TAPS == 8 ? 4 : 8;
    __shared__ int32_t s_win[PER][SPAN][SPAN];
    __shared__ int32_t s_h[PER][SPAN][BS];
    __shared__ int32_t s_f[PHASES * TAPS];

    const int t = threadIdx.x;
    const int b0 = blockIdx.x * PER;
    if (t < PHASES * TAPS) s_f[t] = filt[t];
    for (int i = t; i < PER * SPAN * SPAN; i += kThreads) {
        const int j = i / (SPAN * SPAN);
        const int r = i / SPAN % SPAN;
        const int c = i % SPAN;
        const int b = b0 + j;
        int v = 0;
        if (b < B) {
            const int s = min(max(sel[b], 0), R - 1);
            const int y = min(max(yi[b] - OFF + r, 0), H - 1);
            const int x = min(max(xi[b] - OFF + c, 0), W - 1);
            v = refs[((size_t)s * H + y) * W + x];
        }
        s_win[j][r][c] = v;
    }
    __syncthreads();

    // horizontal pass of every window row
    for (int i = t; i < PER * SPAN * BS; i += kThreads) {
        const int j = i / (SPAN * BS);
        const int r = i / BS % SPAN;
        const int c = i % BS;
        const int b = b0 + j;
        int acc = 0;
        if (b < B) {
            const int32_t* f = s_f + min(max(xf[b], 0), PHASES - 1) * TAPS;
#pragma unroll
            for (int k = 0; k < TAPS; ++k) acc += s_win[j][r][c + k] * f[k];
        }
        s_h[j][r][c] = acc >> shift1;
    }
    __syncthreads();

    const int j = t / NS;
    const int y = t / BS % BS;
    const int x = t % BS;
    const int b = b0 + j;
    if (b >= B) return;
    const int fx = min(max(xf[b], 0), PHASES - 1);
    const int fy = min(max(yf[b], 0), PHASES - 1);
    const int32_t* fv = s_f + fy * TAPS;
    int v;
    if (fx == 0 && fy == 0) {
        v = s_win[j][OFF + y][OFF + x] << shift3;
    } else if (fy == 0) {
        v = s_h[j][OFF + y][x];
    } else if (fx == 0) {
        int acc = 0;
#pragma unroll
        for (int k = 0; k < TAPS; ++k) acc += s_win[j][y + k][OFF + x] * fv[k];
        v = acc >> shift1;
    } else {
        int acc = 0;
#pragma unroll
        for (int k = 0; k < TAPS; ++k) acc += s_h[j][y + k][x] * fv[k];
        v = acc >> 6;
    }
    out[(size_t)b * NS + y * BS + x] = v;
}

template <int BS, int TAPS>
void launch(const int16_t* refs, int R, int H, int W, const int32_t* sel,
            const int32_t* xi, const int32_t* yi, const int32_t* xf,
            const int32_t* yf, const int32_t* filt, int B, int bit_depth,
            int32_t* out, cudaStream_t stream) {
    constexpr int PER = kThreads / (BS * BS);
    const unsigned grid = (unsigned)((B + PER - 1) / PER);
    mc_block_grid_kernel<BS, TAPS><<<grid, kThreads, 0, stream>>>(
        refs, R, H, W, sel, xi, yi, xf, yf, filt, B, bit_depth - 8,
        14 - bit_depth, out);
}

}  // namespace

// refs: (R, H, W) int16; sel, xi, yi, xf, yf: (B,) int32; filt: (4, 8)
// int32 for bs 4 (luma) or (8, 4) int32 for bs 2 (chroma); out: (B, bs, bs)
// int32; all contiguous on the device. Launches on `stream` and returns
// cudaGetLastError() (0 on success, cudaErrorInvalidValue for another bs);
// never synchronises.
extern "C" int mc_block_grid_launch(const void* refs, int R, int H, int W,
                                    const void* sel, const void* xi,
                                    const void* yi, const void* xf,
                                    const void* yf, const void* filt, int B,
                                    int bs, int bit_depth, void* out,
                                    void* stream) {
    if (B > 0) {
        const int16_t* r = (const int16_t*)refs;
        const int32_t* s = (const int32_t*)sel;
        const int32_t* x = (const int32_t*)xi;
        const int32_t* y = (const int32_t*)yi;
        const int32_t* fx = (const int32_t*)xf;
        const int32_t* fy = (const int32_t*)yf;
        const int32_t* f = (const int32_t*)filt;
        int32_t* o = (int32_t*)out;
        cudaStream_t st = (cudaStream_t)stream;
        if (bs == 4)
            launch<4, 8>(r, R, H, W, s, x, y, fx, fy, f, B, bit_depth, o, st);
        else if (bs == 2)
            launch<2, 4>(r, R, H, W, s, x, y, fx, fy, f, B, bit_depth, o, st);
        else
            return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
