// The decoder's SAO filter of one component, for Hopper (sm_90a).
//
// Replaces the XLA program turingcodec_tpu/ops/sao.py _sao_plane (:33-96),
// bit-exact for any int16 samples and bit depth 8..16: per sample, the
// band offset (band (p >> (bd - 5)) - class, mod 32, below 4 takes that
// offset) or the edge offset of the CTB's class (the sign remap of the two
// neighbours along the class's direction, used only where both lie in the
// picture and, in both directions, in the same slice or the slice allows
// filtering across, and in the same tile or the picture allows it), each
// clipped to [0, 2^bd - 1]; unchanged where the CTB's type is 0, its slice
// (per-slice enables, a negative index: disabled) does not enable SAO for
// the component, or the 4x4 skip map (PCM with the loop filter off,
// transquant bypass) holds the sample. The direction offsets and the remap
// are compiled in as immediates from ops/sao.py by ops/kernel_build.py.
//
// The XLA program upsamples every per-CTB map to sample resolution and
// rolls whole planes; this kernel reads the per-CTB maps (type, class,
// offsets, slice, tile) at (y >> ctb_log2, x >> ctb_log2) and the 4x4 skip
// map at (y >> skip_log2, x >> skip_log2), and the deblocked plane at the
// sample and its two neighbours. It reads the source plane and writes a
// new one: the neighbours must see samples before SAO.
//
// What bounds it. One thread per sample, a warp on 32 neighbouring samples
// of one row: each output sample is one int16 read (the neighbours' reads
// hit L1) and one written, so bytes bound it: 2 x 4.1 MB for the luma of a
// 1080p picture, about 2.5 us. One launch takes F pictures of one
// component.
#include <cuda_runtime.h>
#include <stdint.h>

#if !defined(TC_SAO_EO_A) || !defined(TC_SAO_REMAP)
#error "SAO tables undefined: build with ops/kernel_build.py, which pre-includes them from ops/sao.py"
#endif

namespace {

constexpr int kTileX = 32, kTileY = 8;

struct CtbMaps {
    // per CTB, (F, hc, wc); offsets (F, hc, wc, n_off)
    const int32_t* type;
    const int32_t* cls;
    const int32_t* off;
    const int32_t* slice;
    const int32_t* tile;
    // per slice, (F, n_sl)
    const uint8_t* enable;
    const uint8_t* across;
    // per picture, (F,); null: across_all for every picture
    const uint8_t* across_tiles;
    // per 4x4 luma block, (F, hs, ws)
    const uint8_t* skip;
};

struct Dims {
    int h, w, hc, wc, n_off, n_sl, hs, ws, ctb_log2, skip_log2, bd,
        across_all;
};

__global__ void __launch_bounds__(kTileX * kTileY)
sao_kernel(const int16_t* __restrict__ src, int16_t* __restrict__ dst,
           CtbMaps m, Dims d) {
    // eoClass -> neighbour a's (dy, dx); b is its negation
    constexpr int eo_a[4][2] = {TC_SAO_EO_A};
    constexpr int remap[5] = {TC_SAO_REMAP};
    const int x = blockIdx.x * kTileX + threadIdx.x;
    const int y = blockIdx.y * kTileY + threadIdx.y;
    if (x >= d.w || y >= d.h) return;
    const int f = blockIdx.z;
    const size_t fp = (size_t)f * d.h * d.w;
    const int16_t* s = src + fp;
    const int p = s[(size_t)y * d.w + x];
    int out = p;

    const size_t fc = (size_t)f * d.hc * d.wc;
    const int ci = (y >> d.ctb_log2) * d.wc + (x >> d.ctb_log2);
    const int type = m.type[fc + ci];
    const int slice = m.slice[fc + ci];
    const int sl = f * d.n_sl + min(max(slice, 0), d.n_sl - 1);
    const bool enabled = slice >= 0 && m.enable[sl];
    const bool skip = m.skip[(size_t)f * d.hs * d.ws
                             + (size_t)(y >> d.skip_log2) * d.ws
                             + (x >> d.skip_log2)] != 0;
    if (enabled && type > 0 && !skip) {
        const int max_val = (1 << d.bd) - 1;
        const int cls = m.cls[fc + ci];
        const int32_t* off = m.off + (fc + ci) * d.n_off;
        if (type == 1) {
            const int idx = ((p >> (d.bd - 5)) - cls) & 31;
            out = min(max(idx < 4 ? p + off[idx] : p, 0), max_val);
        } else if (type == 2 && cls >= 0 && cls < 4) {
            const int dy = eo_a[cls][0], dx = eo_a[cls][1];
            const int ya = y + dy, xa = x + dx, yb = y - dy, xb = x - dx;
            bool valid = ya >= 0 && ya < d.h && xa >= 0 && xa < d.w
                         && yb >= 0 && yb < d.h && xb >= 0 && xb < d.w;
            if (valid) {
                const int ca = (ya >> d.ctb_log2) * d.wc + (xa >> d.ctb_log2);
                const int cb = (yb >> d.ctb_log2) * d.wc + (xb >> d.ctb_log2);
                const bool allowed = slice < 0 || m.across[sl];
                valid = allowed || (m.slice[fc + ca] == slice
                                    && m.slice[fc + cb] == slice);
                const bool across_tiles = m.across_tiles
                                          ? m.across_tiles[f] != 0
                                          : d.across_all != 0;
                if (!across_tiles) {
                    const int tile = m.tile[fc + ci];
                    valid = valid && m.tile[fc + ca] == tile
                            && m.tile[fc + cb] == tile;
                }
            }
            if (valid) {
                const int a = s[(size_t)ya * d.w + xa];
                const int b = s[(size_t)yb * d.w + xb];
                const int e = remap[2 + (p > a) - (p < a) + (p > b) - (p < b)];
                out = min(max(p + (e ? off[e - 1] : 0), 0), max_val);
            }
        }
    }
    dst[fp + (size_t)y * d.w + x] = (int16_t)out;
}

}  // namespace

// src and dst (F, h, w) int16, contiguous on the device and distinct. The
// per-CTB maps (F, hc, wc) int32 with hc = ceil(h / 2^ctb_log2), wc
// likewise, the offsets (F, hc, wc, n_off >= 4) int32; the per-slice
// enable and across flags (F, n_sl) bool, n_sl >= 1; across_tiles (F,)
// bool or null for across_all; the skip map (F, hs, ws) bool with hs =
// ceil(h / 2^skip_log2), ws likewise. Launches on `stream` and returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for a bit
// depth outside 8..16 or bad sizes; never synchronises.
extern "C" int sao_launch(const void* src, void* dst, int frames, int h,
                          int w, const void* type, const void* cls,
                          const void* off, int n_off, const void* slice,
                          const void* tile, int ctb_log2, const void* enable,
                          const void* across, int n_sl,
                          const void* across_tiles, int across_all,
                          const void* skip, int skip_log2, int bd,
                          void* stream) {
    if (bd < 8 || bd > 16 || h < 1 || w < 1 || frames < 1 || n_sl < 1
        || n_off < 4 || ctb_log2 < 0 || ctb_log2 > 7 || skip_log2 < 0
        || skip_log2 > 2)
        return (int)cudaErrorInvalidValue;
    const int hc = ((h - 1) >> ctb_log2) + 1, wc = ((w - 1) >> ctb_log2) + 1;
    const int hs = ((h - 1) >> skip_log2) + 1, ws = ((w - 1) >> skip_log2) + 1;
    CtbMaps m{(const int32_t*)type, (const int32_t*)cls,
              (const int32_t*)off, (const int32_t*)slice,
              (const int32_t*)tile, (const uint8_t*)enable,
              (const uint8_t*)across, (const uint8_t*)across_tiles,
              (const uint8_t*)skip};
    Dims d{h, w, hc, wc, n_off, n_sl, hs, ws, ctb_log2, skip_log2, bd,
           across_all};
    const dim3 grid((w + kTileX - 1) / kTileX, (h + kTileY - 1) / kTileY,
                    frames);
    sao_kernel<<<grid, dim3(kTileX, kTileY), 0, (cudaStream_t)stream>>>(
        (const int16_t*)src, (int16_t*)dst, m, d);
    return (int)cudaGetLastError();
}
