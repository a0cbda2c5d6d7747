// The encoder's lowres pre-ME seed field, for Hopper (sm_90a).
//
// Replaces the XLA program turingcodec_tpu/encode/device_analysis.py
// _seed_field_program (:66-129), which the JAX package runs fused with the
// dense sweep in one dispatch. For N (orig, ref) pairs of (h, w) int16
// planes it gives the (N, hb, wb, 2) int32 seeds (bsx, bsy) of every 16x16
// block, (wb, hb) = block_dims(w, h) = (ceil(ceil(w/4)/4), ceil(ceil(h/4)/4)):
// 1. both planes decimated by the rounded mean of 4x4 samples,
//      Q(ly, lx) = (sum of P[min(4cy + a, h-1)][min(4cx + b, w-1)] + 8) >> 4,
//      cy = clamp(ly, 0, lh4 - 1), cx = clamp(lx, 0, lw4 - 1),
//    lh4 = ceil(h/4), lw4 = ceil(w/4): two clamps, the full-resolution one
//    inside the last lowres row and column, then the decimated plane's own
//    out to the grid and the reference's border (enc_core lowres_plane);
// 2. per 4x4 quarter-res block the offset (dx, dy) in [-8, 8]^2 minimising
//    (SAD << 2) + |dx| + |dy|, the first in (dy, dx) raster order winning
//    ties (the JAX lax.scan's strict improvement);
// 3. both planes decimated by 2x2 the same way (>> 2, lh2 = ceil(h/2));
// 4. per 8x8 half-res block, around the centre (chx, chy) = (2 dx, 2 dy),
//    the offset (dx', dy') in [-2, 2]^2 minimising (SAD << 2) + |sx| + |sy|,
//    sx = 2 (chx + dx'), sy = 2 (chy + dy'), ties as above; the output is
//    (sx, sy) of the winner.
// The shifts are arithmetic, so they floor as the JAX and torch `//` do: at
// 16 bits the int16 samples may be negative, where C's `/` would truncate.
//
// What bounds it. At 1080p a pair has 8160 blocks, each 289 x 16 + 25 x 64
// = 6224 absolute differences, 50.8 M in all. The least a difference costs
// is two FP32 adds, |w - c| folded into the second as an operand modifier,
// on the FP32 pipe at twice the INT32 rate (exact: int16 SADs stay below
// 64 x 65535 < 2^24), so one INT32-rate operation each, as csrc/dense_me.cu
// counts; with the decimation's 7.0 M adds (half as much again each) that
// is 54.3 M, 3.25 us at 16.7 T op/s (132 SMs x 64 lanes x 1.98 GHz). The
// two int16 planes are 8.3 MB, 2.5 us at 3.35 TB/s, so the operations bound
// it. This first design spends three INT32 operations on each difference
// (difference, absolute value, sum). The torch chain it replaces
// built all 289 quarter-res windows at once, a (17, 17, 272, 480) int32
// tensor of 151 MB written and read several times, and gathered the
// half-res windows through a (5, 5, 68, 120, 8, 8) int64 index tensor.
//
// Design: one launch for all N pairs, a CTA per tile of kTX x kTY = 8 x 4
// blocks of one pair (the pair is blockIdx.z), 8 warps.
//   1. The CTA decimates, straight from the full-resolution planes (through
//      L1, each sample's clamps applied as it is read), the tile's cur
//      quarter-res samples (16 x 32), the reference's quarter-res window
//      that the tile's +-8 search reads (32 x 48), the tile's cur half-res
//      samples (32 x 64) and the reference's half-res window that the
//      refinement can reach (+-18: a centre of +-16 and a step of +-2;
//      68 x 100), as int32 into 44 KB of shared memory.
//   2. Each warp takes a block at a time. Its lanes hold the block's 16
//      quarter-res cur samples in registers and walk the 289 offsets
//      k = (dy + 8) * 17 + (dx + 8), a lane every 32nd; the window rows are
//      49 words apart (17 mod 32), so the 32 lanes' loads of consecutive k
//      fall in 32 distinct banks. The warp takes the min of the key
//      (cost << 9) | k by shuffles.
//   3. Lanes 0..24 then take the 25 half-res offsets around the winner, the
//      cur rows a broadcast and the window rows 101 words apart (5 mod 32:
//      again distinct banks), and the warp takes the min of (cost << 5) | k.
// The keys order by cost first and scan position second, so their min is
// the scan's first minimum, in any reduction order. They are 64-bit: a
// 16-bit quarter-res cost reaches 2^22 and a half-res one 2^24, so a key in
// 32 bits would have no room to spare.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTX = 8, kTY = 4;          // blocks per CTA tile
constexpr int kWarps = kTX * kTY / 4;    // 8 warps, 4 blocks each
constexpr int kThreads = 32 * kWarps;
constexpr int kC4W = 4 * kTX, kC4H = 4 * kTY;            // cur, quarter-res
constexpr int kR4W = kC4W + 16, kR4H = kC4H + 16;        // ref window +-8
constexpr int kR4S = 49;                                 // its row stride
constexpr int kC8W = 8 * kTX, kC8H = 8 * kTY;            // cur, half-res
constexpr int kR8W = kC8W + 36, kR8H = kC8H + 36;        // ref window +-18
constexpr int kR8S = 101;                                // its row stride
static_assert(kR4S >= kR4W && kR4S % 32 == 17, "quarter-res stride");
static_assert(kR8S >= kR8W && kR8S % 32 == 5, "half-res stride");
static_assert((kC4H * kC4W + kR4H * kR4S + kC8H * kC8W + kR8H * kR8S) * 4
              <= 48 * 1024, "static shared memory");
// the largest costs of int16 samples (decimated samples stay in int16)
static_assert(((16ull * 65535) << 2) + 16 < (1ull << 54), "quarter key");
static_assert(((64ull * 65535) << 2) + 72 < (1ull << 58), "half key");

using Key = unsigned long long;

// the rounded F x F mean at decimated position (ly, lx), both clamps
template <int F, int SHIFT>
__device__ __forceinline__ int decimate(const int16_t* __restrict__ p,
                                        int w, int h, int lw, int lh,
                                        int ly, int lx) {
    const int cy = min(max(ly, 0), lh - 1);
    const int cx = min(max(lx, 0), lw - 1);
    int sum = 0;
#pragma unroll
    for (int a = 0; a < F; ++a) {
        const int16_t* row = p + (size_t)min(F * cy + a, h - 1) * w;
#pragma unroll
        for (int b = 0; b < F; ++b) sum += row[min(F * cx + b, w - 1)];
    }
    return (sum + F * F / 2) >> SHIFT;
}

__device__ __forceinline__ Key warp_min(Key v) {
#pragma unroll
    for (int s = 16; s; s >>= 1) {
        const Key o = __shfl_xor_sync(0xffffffffu, v, s);
        v = o < v ? o : v;
    }
    return v;
}

__global__ void __launch_bounds__(kThreads)
seed_field_kernel(const int16_t* __restrict__ orig,
                  const int16_t* __restrict__ ref, int w, int h, int wb,
                  int hb, int32_t* __restrict__ out) {
    __shared__ int s_cur4[kC4H * kC4W];
    __shared__ int s_ref4[kR4H * kR4S];
    __shared__ int s_cur8[kC8H * kC8W];
    __shared__ int s_ref8[kR8H * kR8S];

    const int t = threadIdx.x;
    const int bx0 = blockIdx.x * kTX, by0 = blockIdx.y * kTY;
    const size_t plane = (size_t)blockIdx.z * h * w;
    const int16_t* o = orig + plane;
    const int16_t* r = ref + plane;
    const int lw4 = (w + 3) / 4, lh4 = (h + 3) / 4;
    const int lw2 = (w + 1) / 2, lh2 = (h + 1) / 2;

    // 1. decimation into shared memory; a warp's threads take neighbouring
    // columns of one row
    for (int i = t; i < kC4H * kC4W; i += kThreads) {
        const int y = i / kC4W, x = i - y * kC4W;
        s_cur4[i] = decimate<4, 4>(o, w, h, lw4, lh4, 4 * by0 + y,
                                   4 * bx0 + x);
    }
    for (int i = t; i < kR4H * kR4W; i += kThreads) {
        const int y = i / kR4W, x = i - y * kR4W;
        s_ref4[y * kR4S + x] = decimate<4, 4>(r, w, h, lw4, lh4,
                                              4 * by0 - 8 + y,
                                              4 * bx0 - 8 + x);
    }
    for (int i = t; i < kC8H * kC8W; i += kThreads) {
        const int y = i / kC8W, x = i - y * kC8W;
        s_cur8[i] = decimate<2, 2>(o, w, h, lw2, lh2, 8 * by0 + y,
                                   8 * bx0 + x);
    }
    for (int i = t; i < kR8H * kR8W; i += kThreads) {
        const int y = i / kR8W, x = i - y * kR8W;
        s_ref8[y * kR8S + x] = decimate<2, 2>(r, w, h, lw2, lh2,
                                              8 * by0 - 18 + y,
                                              8 * bx0 - 18 + x);
    }
    __syncthreads();

    const int warp = t >> 5, lane = t & 31;
    for (int j = warp; j < kTX * kTY; j += kWarps) {
        const int jy = j / kTX, jx = j - jy * kTX;
        const int by = by0 + jy, bx = bx0 + jx;
        if (by >= hb || bx >= wb) continue;          // uniform in the warp

        // 2. quarter-res +-8
        int c[16];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int b = 0; b < 4; ++b)
                c[4 * a + b] = s_cur4[(4 * jy + a) * kC4W + 4 * jx + b];
        Key key = ~Key(0);
#pragma unroll 1
        for (int k = lane; k < 289; k += 32) {
            const int dy = k / 17, dx = k - 17 * dy;   // offset + 8
            const int* w0 = s_ref4 + (4 * jy + dy) * kR4S + 4 * jx + dx;
            int sad = 0;
#pragma unroll
            for (int a = 0; a < 4; ++a)
#pragma unroll
                for (int b = 0; b < 4; ++b)
                    sad += abs(c[4 * a + b] - w0[a * kR4S + b]);
            const int cost = (sad << 2) + abs(dx - 8) + abs(dy - 8);
            const Key kk = ((Key)cost << 9) | (Key)k;
            key = kk < key ? kk : key;
        }
        key = warp_min(key);
        const int kq = (int)(key & 511u);
        const int chy = 2 * (kq / 17 - 8), chx = 2 * (kq % 17 - 8);

        // 3. half-res +-2 around (chx, chy)
        Key hkey = ~Key(0);
        if (lane < 25) {
            const int dy = lane / 5 - 2, dx = lane % 5 - 2;
            const int* w0 = s_ref8 + (8 * jy + 18 + chy + dy) * kR8S
                            + 8 * jx + 18 + chx + dx;
            const int* c0 = s_cur8 + 8 * jy * kC8W + 8 * jx;
            int sad = 0;
#pragma unroll 2
            for (int a = 0; a < 8; ++a)
#pragma unroll
                for (int b = 0; b < 8; ++b)
                    sad += abs(c0[a * kC8W + b] - w0[a * kR8S + b]);
            const int sx = 2 * (chx + dx), sy = 2 * (chy + dy);
            const int cost = (sad << 2) + abs(sx) + abs(sy);
            hkey = ((Key)cost << 5) | (Key)lane;
        }
        hkey = warp_min(hkey);
        if (lane == 0) {
            const int kh = (int)(hkey & 31u);
            int32_t* dst = out + ((size_t)blockIdx.z * hb * wb
                                  + (size_t)by * wb + bx) * 2;
            dst[0] = 2 * (chx + kh % 5 - 2);
            dst[1] = 2 * (chy + kh / 5 - 2);
        }
    }
}

}  // namespace

// orig, ref: n contiguous (h, w) int16 planes each, on the device; out:
// (n, hb, wb, 2) int32 on the device, (wb, hb) as above. Launches one grid
// on `stream` and returns cudaGetLastError() (0 on success,
// cudaErrorInvalidValue for an empty plane or n outside 1..65535); never
// synchronises.
extern "C" int seed_field_launch(const void* orig, const void* ref, int n,
                                 int w, int h, void* out, void* stream) {
    if (n < 1 || n > 65535 || w < 1 || h < 1)
        return (int)cudaErrorInvalidValue;
    const int wb = ((w + 3) / 4 + 3) / 4, hb = ((h + 3) / 4 + 3) / 4;
    const dim3 grid((wb + kTX - 1) / kTX, (hb + kTY - 1) / kTY, n);
    seed_field_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const int16_t*)orig, (const int16_t*)ref, w, h, wb, hb,
        (int32_t*)out);
    return (int)cudaGetLastError();
}
