// Dense full-pel motion-estimation sweep for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel turingcodec_tpu/ops/pallas_kernels.py
// dense_me_argmin (pl.pallas_call at :71). For each 16x16 source block and
// its 32x32 reference window (the window's top-left sits at offset (-8, -8)
// from the seed), find the offset (ox, oy) in [-8, 8]^2 minimising
//     cost = (SAD << 2) + |ox| + |oy|,
// ties going to the first offset in (oy, ox) scan order, and write
// [ox, oy, SAD] of the winner.
//
// Addressing. The kernel reads two sample planes (int16 or int32) by base
// pointer, row stride and size, and clamps every coordinate into the plane,
// which is exactly the edge replication of enc_core dense_pad_plane (the
// source padded to hb*16 x wb*16, the reference by 48 on every side):
// - seeded (the encoder's sweep): block b = (by, bx) of a wb-wide grid reads
//   its source at (16 by, 16 bx) and its window at (16 by + sy - 8,
//   16 bx + sx - 8), (sx, sy) = seeds[b], straight from the planes;
// - patches (dense_me_argmin's interface): (B, 16, 16) blocks and (B, 32, 32)
//   windows seen as (16 B, 16) and (32 B, 32) planes, origins (16 b, 0) and
//   (32 b, 0).
//
// What bounds it on this card. At 1080p one call covers B = 8160 blocks:
// 289 * 256 * B = 604 M absolute differences. At one INT32 operation each
// that is 36 us on an H100 SXM (132 SMs x 64 lanes x 1.98 GHz = 16.7 T op/s);
// the seeded form moves only the two int16 planes (8.3 MB, 2.5 us at
// 3.35 TB/s), so the operations bound it. The first design (one thread per
// offset) paid two shared-memory loads per difference, 4.8 GB of shared
// traffic per call, with 2-way bank conflicts, and read 42 MB of windows
// that the caller had gathered.
//
// Design. Each sample becomes a float (exact: samples of at most 12 bits,
// partial SADs below 256 * 4095 < 2^24), so every difference costs two FP32
// adds, |w - c| folded into the second as an operand modifier, on the FP32
// pipe, which issues twice the INT32 rate: 2 x 604 M adds at 33.5 T/s is the
// same 36 us. A CTA of 128 threads holds kPer = 7 ME blocks; thread
// (j, oy) owns one window row offset oy and all 17 ox of block j. Per source
// row y it loads the 16 source samples and the 32-sample window row oy + y
// into registers (12 128-bit shared loads) and makes 17 x 16 differences from
// them: one load per 45 adds instead of two per difference. The window rows
// are 36 floats apart and the blocks 1156, so the 8 threads of a quarter-warp
// reading 16 bytes each hit 8 distinct 4-bank groups. Staging the windows
// with coalesced row loads, all in flight at once, took the kernel from 77
// to 53 us (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py). The reduction takes
// the min of the packed key (cost << 9) | k, k = oy * 17 + ox, per thread
// and then across a block's 17 threads with a shared atomicMin: the key
// orders by cost first and scan position second, so the min reproduces the
// scan's strict-improvement tie-break in any order.
//
// Bit depth. The packed key needs cost < 2^23 in 32 bits, which holds for
// samples of at most 12 bits. Above that (the encoder admits up to 16 bits,
// and sends its planes as int16, so |w - c| < 2^16 at any depth) a 32-bit
// key overflows where the JAX kernel keeps cost in int32, and the min would
// pick another offset. A second instance (WIDE) packs the same key into 64
// bits and reduces it with a 64-bit shared atomicMin; the float SADs stay
// exact up to 16 bits (256 x 65535 < 2^24). The <= 12-bit instance that the
// encoder's 8- and 10-bit pictures run is unchanged.
//
// The surface. With an output pointer for it, the kernel also writes every
// block's 289 SADs, k = oy * 17 + ox (the layout of the JAX package's
// want_surf program, turingcodec_tpu/encode/device_analysis.py:166-188, and
// of enc_core dense_search_rows): the encoder's full-pel search then reads
// its aligned probes from the table instead of computing them on the host.
// A thread's 17 sums are one row of its block's surface; they go through
// shared memory (the staged windows, read for the last time) so that the
// CTA writes its kPer consecutive surfaces as one contiguous run with
// coalesced stores: 8160 x 289 x 4 = 9.4 MB at 1080p, 2.8 us at 3.35 TB/s,
// which the operations' 36 us still bound. A null pointer skips both steps
// (a branch uniform over the grid).
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kPer = 7;                   // ME blocks per CTA (119 threads)
constexpr int kWinStride = 36;            // floats per staged window row
constexpr int kWinBlock = 32 * kWinStride + 4;
constexpr int kSrcBlock = 16 * 16 + 4;
constexpr int kSurf = 17 * 17;            // SADs per block's surface
static_assert(kPer * kSurf <= kPer * kWinBlock, "surface exceeds s_win");

// cost < 2^23 keeps the packed key (cost << 9) | k in 32 bits, and SADs
// below 2^24 keep the float sums exact: both hold for 12-bit samples; the
// 64-bit key of the WIDE instance and the float sums hold for 16 bits
static_assert(((256 * 4095) << 2) + 16 < (1 << 23), "key overflow");
static_assert(256 * 4095 < (1 << 24), "float SAD not exact");
static_assert(((256ull * 65535) << 2) + 16 < (1ull << 55), "wide key overflow");
static_assert(256 * 65535 < (1 << 24), "float SAD not exact at 16 bits");

template <typename T, bool SEEDED, bool WIDE>
__global__ void __launch_bounds__(kThreads)
dense_me_kernel(const T* __restrict__ src, int src_stride, int src_h,
                int src_w, const T* __restrict__ ref, int ref_stride,
                int ref_h, int ref_w, const int32_t* __restrict__ seeds,
                int wb, int B, int32_t* __restrict__ out,
                int32_t* __restrict__ surf) {
    using Key = typename std::conditional<WIDE, unsigned long long,
                                          unsigned>::type;
    __shared__ __align__(16) float s_win[kPer * kWinBlock];
    __shared__ __align__(16) float s_src[kPer * kSrcBlock];
    __shared__ int s_org[kPer][4];        // source y, x; window y, x
    __shared__ Key s_key[kPer];

    const int t = threadIdx.x;
    const int b0 = blockIdx.x * kPer;
    if (t < kPer) {
        const int b = min(b0 + t, B - 1);
        if (SEEDED) {
            const int by = b / wb;
            const int bx = b - by * wb;
            s_org[t][0] = 16 * by;
            s_org[t][1] = 16 * bx;
            s_org[t][2] = 16 * by + seeds[2 * b + 1] - 8;
            s_org[t][3] = 16 * bx + seeds[2 * b] - 8;
        } else {
            s_org[t][0] = 16 * b;
            s_org[t][1] = 0;
            s_org[t][2] = 32 * b;
            s_org[t][3] = 0;
        }
        s_key[t] = ~Key(0);
    }
    __syncthreads();

    // staging: a warp reads one 32-sample window row (two 16-sample source
    // rows) per load, each thread clamps its column once per block, and
    // the unrolled loops put all of a thread's 70 loads in flight together
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
        const int c = t & 31;
        const T* col = ref + min(max(s_org[j][3] + c, 0), ref_w - 1);
        float* dst = s_win + j * kWinBlock + c;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
            const int r = (t >> 5) + 4 * q;
            const int y = min(max(s_org[j][2] + r, 0), ref_h - 1);
            dst[r * kWinStride] = (float)col[(size_t)y * ref_stride];
        }
        const int cs = t & 15;
        const T* scol = src + min(s_org[j][1] + cs, src_w - 1);
#pragma unroll
        for (int q = 0; q < 2; ++q) {
            const int r = (t >> 4) + 8 * q;
            const int y = min(s_org[j][0] + r, src_h - 1);
            s_src[j * kSrcBlock + r * 16 + cs] =
                (float)scol[(size_t)y * src_stride];
        }
    }
    __syncthreads();

    const int j = t / 17;
    const int oy = t - j * 17;
    const int b = b0 + j;
    const bool active = j < kPer && b < B;
    float acc[17];
    if (active) {
        const float* wrow = s_win + j * kWinBlock + oy * kWinStride;
        const float* srow = s_src + j * kSrcBlock;
#pragma unroll
        for (int ox = 0; ox < 17; ++ox) acc[ox] = 0.f;
#pragma unroll 1
        for (int y = 0; y < 16; ++y) {
            float c[16], w[32];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const float4 v =
                    *reinterpret_cast<const float4*>(srow + y * 16 + 4 * q);
                c[4 * q] = v.x; c[4 * q + 1] = v.y;
                c[4 * q + 2] = v.z; c[4 * q + 3] = v.w;
            }
#pragma unroll
            for (int q = 0; q < 8; ++q) {
                const float4 v = *reinterpret_cast<const float4*>(
                    wrow + y * kWinStride + 4 * q);
                w[4 * q] = v.x; w[4 * q + 1] = v.y;
                w[4 * q + 2] = v.z; w[4 * q + 3] = v.w;
            }
#pragma unroll
            for (int ox = 0; ox < 17; ++ox)
#pragma unroll
                for (int x = 0; x < 16; ++x)
                    acc[ox] += fabsf(w[ox + x] - c[x]);
        }
        Key key = ~Key(0);
        const Key pen_y = (Key)abs(oy - 8);
#pragma unroll
        for (int ox = 0; ox < 17; ++ox) {
            const Key cost = ((Key)acc[ox] << 2) + pen_y + (Key)abs(ox - 8);
            key = min(key, (cost << 9) | (Key)(oy * 17 + ox));
        }
        atomicMin(&s_key[j], key);
    }
    int* s_surf = reinterpret_cast<int*>(s_win);
    if (surf) {
        __syncthreads();             // every window read is done
        if (active) {
#pragma unroll
            for (int ox = 0; ox < 17; ++ox)
                s_surf[j * kSurf + oy * 17 + ox] = (int)acc[ox];
        }
    }
    __syncthreads();

    if (surf) {                      // the CTA's surfaces are one run
        const int n = min(kPer, B - b0) * kSurf;
        int32_t* dst = surf + (size_t)b0 * kSurf;
        for (int i = t; i < n; i += kThreads) dst[i] = s_surf[i];
    }
    if (active && oy == 0) {
        const Key key = s_key[j];
        const int k = (int)(key & 511u);
        const int my = k / 17 - 8;
        const int mx = k % 17 - 8;
        const Key cost = key >> 9;
        out[(size_t)b * 3 + 0] = mx;
        out[(size_t)b * 3 + 1] = my;
        out[(size_t)b * 3 + 2] =
            (int32_t)((cost - (Key)(abs(mx) + abs(my))) >> 2);
    }
}

template <typename T, bool WIDE>
void launch(const void* src, int src_stride, int src_h, int src_w,
            const void* ref, int ref_stride, int ref_h, int ref_w,
            const int32_t* seeds, int wb, int B, int32_t* out,
            int32_t* surf, cudaStream_t stream) {
    const unsigned grid = (unsigned)((B + kPer - 1) / kPer);
    if (seeds)
        dense_me_kernel<T, true, WIDE><<<grid, kThreads, 0, stream>>>(
            (const T*)src, src_stride, src_h, src_w, (const T*)ref,
            ref_stride, ref_h, ref_w, seeds, wb, B, out, surf);
    else
        dense_me_kernel<T, false, WIDE><<<grid, kThreads, 0, stream>>>(
            (const T*)src, src_stride, src_h, src_w, (const T*)ref,
            ref_stride, ref_h, ref_w, seeds, wb, B, out, surf);
}

template <typename T>
void launch_key(bool wide, const void* src, int src_stride, int src_h,
                int src_w, const void* ref, int ref_stride, int ref_h,
                int ref_w, const int32_t* seeds, int wb, int B, int32_t* out,
                int32_t* surf, cudaStream_t stream) {
    if (wide)
        launch<T, true>(src, src_stride, src_h, src_w, ref, ref_stride,
                        ref_h, ref_w, seeds, wb, B, out, surf, stream);
    else
        launch<T, false>(src, src_stride, src_h, src_w, ref, ref_stride,
                         ref_h, ref_w, seeds, wb, B, out, surf, stream);
}

}  // namespace

// src: (src_h, src_w) plane, row stride src_stride; ref: (ref_h, ref_w),
// row stride ref_stride; samples int16 (elem_bytes 2) or int32 (4) whose
// differences stay below 2^12 (wide == 0: the 32-bit key) or 2^16 (wide != 0:
// the 64-bit key). seeds: (B, 2) int32 [sx, sy] of a grid wb blocks wide, or
// NULL for the patches layout (see above). out: (B, 3) int32 [ox, oy, sad];
// surf: (B, 289) int32 SADs at k = oy * 17 + ox, or NULL for none. All on
// the device. Launches on `stream` and returns cudaGetLastError() (0 on
// success, cudaErrorInvalidValue for another elem_bytes); never
// synchronises.
extern "C" int dense_me_launch(const void* src, int src_stride, int src_h,
                               int src_w, const void* ref, int ref_stride,
                               int ref_h, int ref_w, const void* seeds,
                               int wb, int B, int elem_bytes, int wide,
                               void* out, void* surf, void* stream) {
    if (B > 0) {
        const int32_t* s = (const int32_t*)seeds;
        int32_t* o = (int32_t*)out;
        int32_t* sf = (int32_t*)surf;
        cudaStream_t st = (cudaStream_t)stream;
        if (elem_bytes == 2)
            launch_key<int16_t>(wide != 0, src, src_stride, src_h, src_w, ref,
                                ref_stride, ref_h, ref_w, s, wb, B, o, sf,
                                st);
        else if (elem_bytes == 4)
            launch_key<int32_t>(wide != 0, src, src_stride, src_h, src_w, ref,
                                ref_stride, ref_h, ref_w, s, wb, B, o, sf,
                                st);
        else
            return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
