// Luma interpolation at all 16 quarter-sample phases of a batch of
// windows, for Hopper (sm_90a).
//
// Replaces the XLA program turingcodec_tpu/ops/inter.py
// interp_luma_all_phases (its int32 einsums, :38, :47 and :57). Each
// (h + 7, w + 7) window gives the (4, 4, h, w) 14-bit intermediate
// predictions of the block at its (3, 3) for every phase (yf, xf), with the
// spec's four cases (decode/inter_pred.py interp_luma):
//   (0, 0):          win << (14 - bd)
//   (0, xf > 0):     H = sum_k fh[k] win[y + 3][x + k] >> (bd - 8)
//   (yf > 0, 0):     sum_k fv[k] win[y + k][x + 3] >> (bd - 8)
//   (yf > 0, xf > 0): sum_k fv[k] H(y + k) >> 6, H over the window's rows.
// All sums are exact in int32. The filter taps come in from the wrapper
// (hevc/tables.py LUMA_FILTER).
//
// What bounds it. The output is 16 times the block: at the 1080p batch of
// 8,160 16x16 windows, 134 MB of int32 written against 8.6 MB of int16
// windows read, 42.7 us at 3.35 TB/s. The multiply-adds (3 H phases per
// window sample, 15 x 8 per output sample of a row) take about 17 us of
// INT32 issue. Writing the output bounds it.
//
// Design. One thread per output column x of one window, as mc_block_grid.cu
// keeps one block in registers: it walks the window a row at a time, reads
// the 8 samples of the row it needs into registers, computes the row's three
// horizontal phases, and shifts them, with the raw centre sample, into an
// 8-row register history. From the eighth row on, each row completes one
// output row, and the thread writes its 16 phases there. Neighbouring
// threads take neighbouring columns, so every store of a warp covers whole
// 32-byte sectors of one phase plane (w of 8 or more), and the window reads
// overlap in L1. Nothing is staged and there is no barrier.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
interp_all_phases_kernel(const int16_t* __restrict__ win,
                         const int32_t* __restrict__ filt, int B, int w,
                         int h, int shift1, int shift3,
                         int32_t* __restrict__ out) {
    const int idx = blockIdx.x * kThreads + threadIdx.x;
    if (idx >= B * w) return;
    const int b = idx / w;
    const int x = idx - b * w;
    const int ww = w + 7;
    const int16_t* __restrict__ src = win + (size_t)b * (h + 7) * ww + x;
    const size_t plane = (size_t)h * w;
    int32_t* __restrict__ dst = out + (size_t)b * 16 * plane + x;

    int f[4][8];
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int k = 0; k < 8; ++k) f[p][k] = __ldg(filt + p * 8 + k);

    // hist[0]: the raw centre sample win[r][x + 3]; hist[p], p = 1..3: the
    // row's horizontal phase p, >> shift1; the last 8 rows, oldest first
    int hist[4][8];
#pragma unroll 1
    for (int r = 0; r < h + 7; ++r) {
        const int16_t* row = src + (size_t)r * ww;
        int s[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) s[k] = row[k];
#pragma unroll
        for (int p = 0; p < 4; ++p)
#pragma unroll
            for (int k = 0; k < 7; ++k) hist[p][k] = hist[p][k + 1];
        hist[0][7] = s[3];
#pragma unroll
        for (int p = 1; p < 4; ++p) {
            int acc = 0;
#pragma unroll
            for (int k = 0; k < 8; ++k) acc += f[p][k] * s[k];
            hist[p][7] = acc >> shift1;
        }
        if (r < 7) continue;
        // output row y = r - 7 reads rows y .. y + 7 = hist[.][0 .. 7]
        int32_t* o = dst + (size_t)(r - 7) * w;
        o[0] = hist[0][3] << shift3;                          // (0, 0)
#pragma unroll
        for (int xf = 1; xf < 4; ++xf) o[xf * plane] = hist[xf][3];
#pragma unroll
        for (int yf = 1; yf < 4; ++yf) {
#pragma unroll
            for (int xf = 0; xf < 4; ++xf) {
                int acc = 0;
#pragma unroll
                for (int k = 0; k < 8; ++k) acc += f[yf][k] * hist[xf][k];
                o[(yf * 4 + xf) * plane] = acc >> (xf ? 6 : shift1);
            }
        }
    }
}

}  // namespace

// win: (B, h + 7, w + 7) int16; filt: (4, 8) int32; out: (B, 4, 4, h, w)
// int32; all contiguous on the device; bit_depth in 8..12. Launches on
// `stream` and returns cudaGetLastError() (0 on success,
// cudaErrorInvalidValue for a bit depth outside 8..12 or a size below 1);
// never synchronises.
extern "C" int interp_all_phases_launch(const void* win, const void* filt,
                                        int B, int w, int h, int bit_depth,
                                        void* out, void* stream) {
    if (bit_depth < 8 || bit_depth > 12 || w < 1 || h < 1)
        return (int)cudaErrorInvalidValue;
    const long long threads = (long long)B * w;
    if (threads > 0) {
        const unsigned grid = (unsigned)((threads + kThreads - 1) / kThreads);
        interp_all_phases_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
            (const int16_t*)win, (const int32_t*)filt, B, w, h,
            bit_depth - 8, 14 - bit_depth, (int32_t*)out);
    }
    return (int)cudaGetLastError();
}
