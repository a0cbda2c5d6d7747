// The encoder's lowres pre-ME seed field, for Hopper (sm_90a).
//
// Replaces the XLA program turingcodec_tpu/encode/device_analysis.py
// _seed_field_program (:66-129, with _lowres_plane_j at :51-63), which the
// JAX package runs fused with the dense sweep in one dispatch. For N
// (orig, ref) pairs of (h, w) int16 planes it gives the (N, hb, wb, 2)
// int32 seeds (bsx, bsy) of every 16x16 block, (wb, hb) = block_dims(w, h)
// = (ceil(ceil(w/4)/4), ceil(ceil(h/4)/4)):
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
// on the FP32 pipe at twice the INT32 rate, so one INT32-rate operation
// each; with the decimation's 7.0 M adds (half as much again each) that is
// 54.3 M, 3.25 us at 16.7 T op/s (132 SMs x 64 lanes x 1.98 GHz). The two
// int16 planes are 8.3 MB, 2.5 us at 3.35 TB/s, so the operations bound it,
// and the reads come close.
//
// Design: one launch for all N pairs, a CTA per tile of kTX x kTY = 8 x 4
// blocks of one pair (the pair is blockIdx.z), 544 threads, two CTAs an SM.
//   1. Decimation, each 2x2 sum once. A thread takes a quarter-res position
//      (cy, cx) of the reference window that both searches reach (+-9
//      quarter-res samples: the half-res window's +-18 in pairs), then of
//      the tile (cur), clamps it to the quarter-res grid and reads the 4x4
//      full-resolution samples under it, a row at a time in one 8-byte load
//      where w % 4 == 0 (neighbouring threads on neighbouring columns:
//      coalesced; rows clamped to h - 1), each pair of samples summed by
//      one dp2a. From them come the four raw 2x2 sums S2 (full-resolution
//      clamps only), the quarter-res sample from all four (the raw sums: a
//      row or column of them may lie one past the half-res grid, where h or
//      w = 2 mod 4, and clamping it first would change the sample), and the
//      2x2 half-res samples at (2cy + a, 2cx + b): clamped to the half-res
//      grid, each lands on one of its own two sum rows and columns (inside
//      the grid, the sums themselves). Every sample goes to shared memory
//      as a float (exact for int16). The window's halo makes these reads
//      2.2 times the two planes, through L2.
//   2. Quarter-res +-8, a thread per (block, dy): it owns the 17 dx of one
//      window row offset. Per block row it reads the 4 cur samples and the
//      20-sample window row with 16-byte shared loads and makes the 68
//      differences from registers, each two FP32 adds (exact: the SADs of
//      int16 samples stay below 16 x 65535 < 2^24). Its first minimum over
//      dx goes into the key (cost << 9) | k, k = (dy + 8) * 17 + dx + 8,
//      and a shared 32-bit atomicMin takes the block's minimum.
//   3. Half-res +-2 around the winner, a thread per (block, dy', half of
//      the rows), 10 of the 17 warps: per row 8 cur samples (16-byte loads)
//      and a 12-sample window row (8-byte loads) give the 5 dx' x 8
//      differences; a shuffle adds the two halves, and the key
//      (cost << 5) | k' goes the same way.
// The keys order by cost first and scan position second, so their minimum
// is the scan's first minimum in any reduction order. They fit 32 bits: a
// quarter-res cost stays below 2^22 and a half-res one below 2^24.
// The window rows' strides are odd in 16-byte (quarter-res) and 8-byte
// (half-res) units, so the threads of a block, on consecutive rows, load
// from distinct banks.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTX = 8, kTY = 4;          // blocks per CTA tile
constexpr int kBlocks = kTX * kTY;
constexpr int kThreads = 17 * kBlocks;   // a thread per (block, dy)
constexpr int kHalfThreads = 10 * kBlocks;   // per (block, dy', half)
constexpr int kCQW = 4 * kTX, kCQH = 4 * kTY;            // cur, quarter-res
constexpr int kQW = kCQW + 16, kQH = kCQH + 16;          // ref window +-8
constexpr int kQS = 52;                                  // its row stride
constexpr int kCHW = 8 * kTX, kCHH = 8 * kTY;            // cur, half-res
constexpr int kCHS = 68;                                 // its row stride
constexpr int kHW = kCHW + 36, kHH = kCHH + 36;          // ref window +-18
constexpr int kHS = 102;                                 // its row stride
// quarter-res positions a CTA decimates: the reference's, +-9 around the
// tile, then the tile's own
constexpr int kPW = kCQW + 18, kPH = kCQH + 18;
constexpr int kRefPos = kPW * kPH;
static_assert(kQS >= kQW && kQS % 8 == 4, "quarter-res stride");
static_assert(kHS >= kHW && kHS % 4 == 2, "half-res stride");
static_assert(kCHS >= kCHW && kCHS % 8 == 4, "cur half-res stride");
static_assert(kHalfThreads % 32 == 0 && kHalfThreads <= kThreads,
              "half-res threads fill whole warps");
static_assert((kQH * kQS + kHH * kHS + kCQH * kCQW + kCHH * kCHS) * 4
              + 2 * kBlocks * 4 <= 48 * 1024, "static shared memory");
// the largest costs of int16 samples (decimated samples stay in int16),
// exact in a float and packed in 32 bits
static_assert(((16ull * 65535) << 2) + 16 < (1ull << 22), "quarter key");
static_assert(((64ull * 65535) << 2) + 72 < (1ull << 24), "half key");

// the sum of the two int16 halves of a word: one instruction
__device__ __forceinline__ int pair_sum(unsigned v, int acc) {
    return __dp2a_lo((int)v, 0x0101, acc);
}

// The four raw 2x2 sums under quarter-res position (qy, qx) of a plane,
// full-resolution rows clamped to h - 1: s[0] = S2(2qy, 2qx), s[1] =
// S2(2qy, 2qx + 1), s[2] = S2(2qy + 1, 2qx), s[3] = S2(2qy + 1, 2qx + 1).
// VEC: w % 4 == 0 and the plane 8-byte aligned, so the 4 samples of a row
// are one aligned 8-byte load (4qx + 3 < w); else the columns are clamped
// to w - 1 sample by sample.
template <bool VEC>
__device__ __forceinline__ void sums2x2(const int16_t* __restrict__ p,
                                        int w, int h, int qy, int qx,
                                        int s[4]) {
    s[0] = s[1] = s[2] = s[3] = 0;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
        const int16_t* row = p + (size_t)min(4 * qy + a, h - 1) * w;
        if (VEC) {
            const uint2 u = __ldg(reinterpret_cast<const uint2*>(row + 4 * qx));
            s[a & 2] = pair_sum(u.x, s[a & 2]);
            s[(a & 2) + 1] = pair_sum(u.y, s[(a & 2) + 1]);
        } else {
#pragma unroll
            for (int b = 0; b < 4; ++b)
                s[(a & 2) + (b >> 1)] += __ldg(row + min(4 * qx + b, w - 1));
        }
    }
}

// one of the four sums by its index, 2 * row + column
__device__ __forceinline__ int pick(const int s[4], int i) {
    return i & 2 ? (i & 1 ? s[3] : s[2]) : (i & 1 ? s[1] : s[0]);
}

// From the sums of quarter-res position (cy, cx), clamped to (qy, qx): the
// quarter-res sample, and the 2x2 half-res samples at (2cy + a, 2cx + b),
// each clamped to the half-res grid, where it lands on one of the rows
// 2qy, 2qy + 1 and columns 2qx, 2qx + 1. Stored as floats: q at *qd (if
// not null), the half-res rows at hd and hd + hstride.
__device__ __forceinline__ void decimated(const int s[4], int cy, int cx,
                                          int qy, int qx, int lh2, int lw2,
                                          float* qd, float* hd,
                                          int hstride) {
    if (qd) *qd = (float)((s[0] + s[1] + s[2] + s[3] + 8) >> 4);
    float2 top, bot;
    if (cy == qy && cx == qx && 2 * cy + 1 < lh2 && 2 * cx + 1 < lw2) {
        top = make_float2((float)((s[0] + 2) >> 2), (float)((s[1] + 2) >> 2));
        bot = make_float2((float)((s[2] + 2) >> 2), (float)((s[3] + 2) >> 2));
    } else {
        const int y0 = 2 * (min(max(2 * cy, 0), lh2 - 1) - 2 * qy);
        const int y1 = 2 * (min(max(2 * cy + 1, 0), lh2 - 1) - 2 * qy);
        const int x0 = min(max(2 * cx, 0), lw2 - 1) - 2 * qx;
        const int x1 = min(max(2 * cx + 1, 0), lw2 - 1) - 2 * qx;
        top = make_float2((float)((pick(s, y0 + x0) + 2) >> 2),
                          (float)((pick(s, y0 + x1) + 2) >> 2));
        bot = make_float2((float)((pick(s, y1 + x0) + 2) >> 2),
                          (float)((pick(s, y1 + x1) + 2) >> 2));
    }
    *reinterpret_cast<float2*>(hd) = top;
    *reinterpret_cast<float2*>(hd + hstride) = bot;
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads, 2)
seed_field_kernel(const int16_t* __restrict__ orig,
                  const int16_t* __restrict__ ref, int w, int h, int wb,
                  int hb, int32_t* __restrict__ out) {
    __shared__ __align__(16) float s_qref[kQH * kQS];
    __shared__ __align__(16) float s_href[kHH * kHS];
    __shared__ __align__(16) float s_qcur[kCQH * kCQW];
    __shared__ __align__(16) float s_hcur[kCHH * kCHS];
    __shared__ unsigned s_qkey[kBlocks], s_hkey[kBlocks];

    const int t = threadIdx.x;
    const int bx0 = blockIdx.x * kTX, by0 = blockIdx.y * kTY;
    const size_t plane = (size_t)blockIdx.z * h * w;
    const int lw4 = (w + 3) >> 2, lh4 = (h + 3) >> 2;
    const int lw2 = (w + 1) >> 1, lh2 = (h + 1) >> 1;
    if (t < kBlocks) s_qkey[t] = s_hkey[t] = ~0u;

    // 1. decimation: a quarter-res position at a time, the reference's
    // window (origin (4 by0 - 9, 4 bx0 - 9)), then the tile
    const int16_t* r = ref + plane;
    const int16_t* o = orig + plane;
    for (int i = t; i < kRefPos; i += kThreads) {
        const int py = i / kPW, px = i - py * kPW;
        const int cy = 4 * by0 - 9 + py, cx = 4 * bx0 - 9 + px;
        const int qy = min(max(cy, 0), lh4 - 1);
        const int qx = min(max(cx, 0), lw4 - 1);
        int s[4];
        sums2x2<VEC>(r, w, h, qy, qx, s);
        const bool in_q = py >= 1 && py <= kQH && px >= 1 && px <= kQW;
        decimated(s, cy, cx, qy, qx, lh2, lw2,
                  in_q ? s_qref + (py - 1) * kQS + px - 1 : nullptr,
                  s_href + 2 * py * kHS + 2 * px, kHS);
    }
    for (int i = t; i < kCQH * kCQW; i += kThreads) {
        const int py = i / kCQW, px = i - py * kCQW;
        const int cy = 4 * by0 + py, cx = 4 * bx0 + px;
        const int qy = min(cy, lh4 - 1), qx = min(cx, lw4 - 1);
        int s[4];
        sums2x2<VEC>(o, w, h, qy, qx, s);
        decimated(s, cy, cx, qy, qx, lh2, lw2, s_qcur + i,
                  s_hcur + 2 * py * kCHS + 2 * px, kCHS);
    }
    __syncthreads();

    // 2. quarter-res +-8: thread (j, dy), window rows 4 jy + dy + a
    {
        const int j = t / 17, dy = t - 17 * j;       // dy: offset + 8
        const int jy = j / kTX, jx = j - jy * kTX;
        float sad[17];
#pragma unroll
        for (int dx = 0; dx < 17; ++dx) sad[dx] = 0.f;
#pragma unroll
        for (int a = 0; a < 4; ++a) {
            const float4 c = *reinterpret_cast<const float4*>(
                s_qcur + (4 * jy + a) * kCQW + 4 * jx);
            const float4* wr = reinterpret_cast<const float4*>(
                s_qref + (4 * jy + dy + a) * kQS + 4 * jx);
            float wv[20];
#pragma unroll
            for (int u = 0; u < 5; ++u) {
                const float4 x = wr[u];
                wv[4 * u] = x.x; wv[4 * u + 1] = x.y;
                wv[4 * u + 2] = x.z; wv[4 * u + 3] = x.w;
            }
#pragma unroll
            for (int dx = 0; dx < 17; ++dx) {
                sad[dx] += fabsf(c.x - wv[dx]);
                sad[dx] += fabsf(c.y - wv[dx + 1]);
                sad[dx] += fabsf(c.z - wv[dx + 2]);
                sad[dx] += fabsf(c.w - wv[dx + 3]);
            }
        }
        const float py = fabsf((float)(dy - 8));
        float best = sad[0] * 4.f + (py + 8.f);
        int bk = 0;
#pragma unroll
        for (int dx = 1; dx < 17; ++dx) {
            const float cost = sad[dx] * 4.f + (py + fabsf((float)(dx - 8)));
            if (cost < best) { best = cost; bk = dx; }
        }
        atomicMin(&s_qkey[j], ((unsigned)best << 9) | (unsigned)(17 * dy + bk));
    }
    __syncthreads();

    // 3. half-res +-2 around the winner: thread (j, dy', half r), rows
    // 4r..4r+3 of the block; whole warps, so the shuffle has every lane
    if (t < kHalfThreads) {
        const int j = t / 10, u = t - 10 * j, dyh = u >> 1, r = u & 1;
        const int jy = j / kTX, jx = j - jy * kTX;
        const int kq = (int)(s_qkey[j] & 511u);
        const int chy = 2 * (kq / 17 - 8), chx = 2 * (kq % 17 - 8);
        float sad[5];
#pragma unroll
        for (int dx = 0; dx < 5; ++dx) sad[dx] = 0.f;
#pragma unroll
        for (int a = 0; a < 4; ++a) {
            const int row = 4 * r + a;
            const float4* cr = reinterpret_cast<const float4*>(
                s_hcur + (8 * jy + row) * kCHS + 8 * jx);
            const float4 c0 = cr[0], c1 = cr[1];
            const float c[8] = {c0.x, c0.y, c0.z, c0.w,
                                c1.x, c1.y, c1.z, c1.w};
            // window origin (8 by0 - 18, 8 bx0 - 18); the block's rows
            // 8 jy + chy + dy' + row, columns 8 jx + chx + dx' + b, with
            // dy', dx' in -2..2
            const float2* wr = reinterpret_cast<const float2*>(
                s_href + (8 * jy + 16 + chy + dyh + row) * kHS + 8 * jx + 16
                + chx);
            float wv[12];
#pragma unroll
            for (int e = 0; e < 6; ++e) {
                const float2 x = wr[e];
                wv[2 * e] = x.x; wv[2 * e + 1] = x.y;
            }
#pragma unroll
            for (int dx = 0; dx < 5; ++dx)
#pragma unroll
                for (int b = 0; b < 8; ++b)
                    sad[dx] += fabsf(c[b] - wv[dx + b]);
        }
#pragma unroll
        for (int dx = 0; dx < 5; ++dx)
            sad[dx] += __shfl_xor_sync(0xffffffffu, sad[dx], 1);
        if (r == 0) {
            const float py = fabsf((float)(2 * (chy + dyh - 2)));
            float best = sad[0] * 4.f + (py + fabsf((float)(2 * (chx - 2))));
            int bk = 0;
#pragma unroll
            for (int dx = 1; dx < 5; ++dx) {
                const float cost = sad[dx] * 4.f
                                   + (py + fabsf((float)(2 * (chx + dx - 2))));
                if (cost < best) { best = cost; bk = dx; }
            }
            atomicMin(&s_hkey[j], ((unsigned)best << 5) | (unsigned)(5 * dyh + bk));
        }
    }
    __syncthreads();

    if (t < kBlocks) {
        const int by = by0 + t / kTX, bx = bx0 + t % kTX;
        if (by < hb && bx < wb) {
            const int kq = (int)(s_qkey[t] & 511u);
            const int kh = (int)(s_hkey[t] & 31u);
            const int chy = 2 * (kq / 17 - 8), chx = 2 * (kq % 17 - 8);
            *reinterpret_cast<int2*>(out + ((size_t)blockIdx.z * hb * wb
                                            + (size_t)by * wb + bx) * 2) =
                make_int2(2 * (chx + kh % 5 - 2), 2 * (chy + kh / 5 - 2));
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
    const bool vec = w % 4 == 0
                     && ((uintptr_t)orig | (uintptr_t)ref) % 8 == 0;
    if (vec)
        seed_field_kernel<true><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
            (const int16_t*)orig, (const int16_t*)ref, w, h, wb, hb,
            (int32_t*)out);
    else
        seed_field_kernel<false><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
            (const int16_t*)orig, (const int16_t*)ref, w, h, wb, hb,
            (int32_t*)out);
    return (int)cudaGetLastError();
}

// The 8-byte-load instance's resources as the runtime reports them, into
// out[6]: registers and spilled bytes a thread, shared bytes a CTA, CTAs
// an SM, threads a CTA, and CTAs launched for one 1080p pair. Returns a
// CUDA error code (0 on success).
extern "C" int seed_field_occupancy(int* out) {
    cudaFuncAttributes a;
    cudaError_t e = cudaFuncGetAttributes(&a, seed_field_kernel<true>);
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &out[3], seed_field_kernel<true>, kThreads, 0);
    if (e != cudaSuccess) return (int)e;
    out[0] = a.numRegs;
    out[1] = (int)a.localSizeBytes;
    out[2] = (int)a.sharedSizeBytes;
    out[4] = kThreads;
    out[5] = ((120 + kTX - 1) / kTX) * ((68 + kTY - 1) / kTY);
    return 0;
}
