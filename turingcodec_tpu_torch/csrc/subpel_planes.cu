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
// against a 4.1 MB plane read: 21.3 us at 3.35 TB/s. What the card takes
// for the stores alone depends on the tile's shape (on an H100 SXM at
// 700 W, PERF.md section 6): 16-byte register stores of all 15 planes by
// tiles of 64x32 samples take 35 us, of 128x16 29 us, of 256x8 26 us; TMA
// stores of the same tiles 38, 33 and 30 us; torch's zero_() of the
// output 23 us. This kernel takes 35 us: copies of it without the
// multiply-adds take 33 us, without the stores 25 us, without both 16 us
// (the loads, shared traffic and barriers), so the stores bound it, with
// the rest of a tile's work only partly hidden behind them.
//
// Design. One launch per plane, of persistent CTAs: as many as fit on the
// card at once (three an SM: 256 threads each, 54 KB of shared memory),
// each walking the tiles of 8 output rows by 256 output columns of every
// plane with a stride of the grid. All arithmetic is int32, exact for any
// int16 sample. For each tile a CTA
//   1. waits for the tile's source window (15 rows by 264 samples, clamped
//      to the picture), loaded during the last tile, widens it to int32
//      and, once every thread has, issues the next tile's loads into the
//      freed buffer: cp.async of 16 bytes where 8 samples lie inside the
//      picture's row (a row index is clamped, so whole rows replicate for
//      free), a sample at a time where the window crosses the left or
//      right edge;
//   then, for each horizontal phase xf = 0..3 (0: the samples themselves):
//   2. computes phase xf of the window's 15 rows, four columns a thread,
//      into shared memory;
//   3. gives each thread 4 consecutive output columns of 2 rows: it reads
//      the 9 x 4 sources of its vertical taps, one 16-byte shared load a
//      row (a warp's 512 contiguous bytes), forms the vertical phases and
//      writes the phase's 3 or 4 planes into the staging tile (4 x 8 x 256
//      int16, 16 KB), once the TMA has read the last phase's
//      (cp.async.bulk.wait_group.read, by the thread that issued them);
//   4. hands the staging tile to the TMA: one thread issues a
//      cp.async.bulk.tensor store of a (256, 8, 1) box per plane into the
//      output, whose tensor map (built on the host with
//      cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint, so
//      nothing links libcuda) is a __grid_constant__ parameter, one bulk
//      group per phase. The TMA clips the boxes at the output's ragged
//      edges, and where the output is narrower than a box.
// So a phase's stores drain while the CTA computes the next phase's
// horizontal pass, and the other CTAs of its SM fill the gaps. Why these
// sizes (PERF.md section 6): TMA stores of 512-byte tile rows are the
// fastest measured (30 us for the output against 33 us for 256-byte rows
// and 38 for 128), and 8 x 256 tiles ran 4% faster than 16 x 128 ones,
// though their windows' 7 extra rows add 88% to the horizontal pass, not
// 44%; one phase at a time in shared memory keeps three CTAs an SM (2%
// faster than all three phases and all 15 planes at once, two CTAs an
// SM); 4 x 2 outputs a thread read each source 4.5 times less often from
// shared memory than 8 x 1 did, without bank conflicts; one store per
// phase instead of one per tile saved 4%; a second staging tile, letting
// a phase's stores stay in flight while the next phase is staged, read
// the same. Sums in floats where exact, on the FP32 pipes, ran 12% slower
// than this int32 kernel with its single staging tile.
// The TMA needs a row stride of a multiple of 16 bytes: where the padded
// width is not a multiple of 8, or the output is not 16-byte aligned, the
// CTA's threads copy the staging tile out themselves, a sample each,
// clipped to the output (the same kernel, another store path).
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#ifndef TC_LUMA_FILTER
#error "TC_LUMA_FILTER undefined: build with ops/kernel_build.py, which pre-includes hevc/tables.py's luma filter"
#endif

namespace {

constexpr int kPad = 28;        // enc_core SP_P
constexpr int kTileX = 256;     // output columns of a tile
constexpr int kTileY = 8;       // output rows of a tile
constexpr int kPlanes = 15;
constexpr int kThreads = kTileY * kTileX / 8;   // 4 columns by 2 rows each
constexpr int kRows = kTileY + 7;   // source rows of a tile
constexpr int kInCols = kTileX + 8; // source samples of a row, from x0 - 32
constexpr int kChunks = kInCols / 8;

constexpr int kGroup = 4;           // planes of one horizontal phase

struct __align__(128) Smem {
    int16_t stage[kGroup][kTileY][kTileX];   // the TMA's source, one phase
    int win[kRows][kInCols];          // the tile's source window
    int hor[kRows][kTileX];           // one horizontal phase
    int16_t in[kRows][kInCols];       // the next tile's source window
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ uint32_t pack2(int a, int b) {
    return (uint32_t)(uint16_t)(int16_t)a
           | ((uint32_t)(uint16_t)(int16_t)b << 16);
}

__device__ __forceinline__ int lo16(uint32_t u) { return (int16_t)(u & 0xffff); }
__device__ __forceinline__ int hi16(uint32_t u) { return (int16_t)(u >> 16); }

// Issue the loads of the source window of the tile at output (ox0, oy0):
// column c of `buf` holds the plane's sample x0 - 32 + c of row y0 - 31 + r
// (clamped); one cp.async group.
__device__ __forceinline__ void load_window(
        int16_t (*buf)[kInCols], const int16_t* __restrict__ ref, int w,
        int h, int ox0, int oy0, bool vec_in, int tid) {
    const int xs = ox0 - kPad - 4, ys = oy0 - kPad - 3;
    for (int i = tid; i < kRows * kChunks; i += kThreads) {
        const int r = i / kChunks, c = (i - r * kChunks) * 8;
        const int16_t* row = ref + (size_t)min(max(ys + r, 0), h - 1) * w;
        const int x = xs + c;
        if (vec_in && x >= 0 && x + 8 <= w) {
            asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                         :: "r"(smem_addr(&buf[r][c])), "l"(row + x)
                         : "memory");
        } else {
            int v[8];
#pragma unroll
            for (int e = 0; e < 8; ++e)
                v[e] = __ldg(row + min(max(x + e, 0), w - 1));
            *reinterpret_cast<uint4*>(&buf[r][c]) = make_uint4(
                pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]),
                pack2(v[6], v[7]));
        }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__global__ void __launch_bounds__(kThreads, 3)
subpel_planes_kernel(const __grid_constant__ CUtensorMap tmap,
                     const int16_t* __restrict__ ref, int w, int h, int pw,
                     int ph, int shift1, int vec_in, int tma,
                     int16_t* __restrict__ out) {
    // the (4 phases, 8 taps) luma filter; folded into the arithmetic
    constexpr int f[4][8] = {TC_LUMA_FILTER};
    extern __shared__ __align__(128) unsigned char smem_raw[];
    Smem& s = *reinterpret_cast<Smem*>(smem_raw);
    const int tid = threadIdx.x;
    const int ntx = (pw + kTileX - 1) / kTileX;
    const int n_tiles = ntx * ((ph + kTileY - 1) / kTileY);
    int tile = blockIdx.x;
    if (tile >= n_tiles) return;
    load_window(s.in, ref, w, h, (tile % ntx) * kTileX,
                (tile / ntx) * kTileY, vec_in, tid);
    // this thread's 4 output columns of 2 rows: a warp's 16-byte shared
    // loads of a source row are 512 contiguous bytes
    const int cx = (tid % (kTileX / 4)) * 4;
    const int r0 = (tid / (kTileX / 4)) * 2;

    for (; tile < n_tiles; tile += gridDim.x) {
        const int ox0 = (tile % ntx) * kTileX, oy0 = (tile / ntx) * kTileY;
        // 1. the tile's window in, as int32
        asm volatile("cp.async.wait_group 0;\n" ::: "memory");
        __syncthreads();
        for (int j = tid; j < kRows * (kInCols / 4); j += kThreads) {
            const int r = j / (kInCols / 4), c = (j % (kInCols / 4)) * 4;
            const uint2 a = *reinterpret_cast<const uint2*>(&s.in[r][c]);
            *reinterpret_cast<int4*>(&s.win[r][c]) = make_int4(
                lo16(a.x), hi16(a.x), lo16(a.y), hi16(a.y));
        }
        const int next = tile + gridDim.x;

#pragma unroll
        for (int xf = 0; xf < 4; ++xf) {
            if (xf) {
                // 2. horizontal phase xf, four output columns a thread:
                // output column c reads window columns c + 1 .. c + 8
                for (int j = tid; j < kRows * (kTileX / 4); j += kThreads) {
                    const int r = j / (kTileX / 4), c = (j % (kTileX / 4)) * 4;
                    const int4* q = reinterpret_cast<const int4*>(&s.win[r][c]);
                    const int4 a = q[0], b = q[1], d = q[2];
                    const int x[12] = {a.x, a.y, a.z, a.w, b.x, b.y,
                                       b.z, b.w, d.x, d.y, d.z, d.w};
                    int hp[4];
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        int acc = 0;
#pragma unroll
                        for (int t = 0; t < 8; ++t)
                            acc += f[xf][t] * x[e + 1 + t];
                        hp[e] = acc >> shift1;
                    }
                    *reinterpret_cast<int4*>(&s.hor[r][c]) =
                        make_int4(hp[0], hp[1], hp[2], hp[3]);
                }
            }
            // the staging tile free: the TMA has read the last phase's
            if (tma && tid == 0)
                asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
            __syncthreads();
            // the window read: the next tile's loads out
            if (xf == 0 && next < n_tiles)
                load_window(s.in, ref, w, h, (next % ntx) * kTileX,
                            (next / ntx) * kTileY, vec_in, tid);

            // 3. the vertical phases of 4 columns of 2 rows into the
            // staging tile; source rows r0 .. r0 + 8: the samples (window
            // columns cx + 4 .. cx + 7) for xf = 0, else phase xf
            auto stage = [&](int yf, int rr, const int (&val)[4]) {
                *reinterpret_cast<uint2*>(&s.stage[yf][r0 + rr][cx]) =
                    make_uint2(pack2(val[0], val[1]), pack2(val[2], val[3]));
            };
            int v[9][4];
#pragma unroll
            for (int k = 0; k < 9; ++k) {
                const int4 a = *reinterpret_cast<const int4*>(
                    xf ? &s.hor[r0 + k][cx] : &s.win[r0 + k][cx + 4]);
                v[k][0] = a.x; v[k][1] = a.y; v[k][2] = a.z; v[k][3] = a.w;
            }
            if (xf) {
#pragma unroll
                for (int rr = 0; rr < 2; ++rr) stage(0, rr, v[rr + 3]);
            }
            const int shift = xf ? 6 : shift1;
#pragma unroll
            for (int yf = 1; yf < 4; ++yf) {
#pragma unroll
                for (int rr = 0; rr < 2; ++rr) {
                    int val[4];
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        int acc = 0;
#pragma unroll
                        for (int k = 0; k < 8; ++k)
                            acc += f[yf][k] * v[rr + k][e];
                        val[e] = acc >> shift;
                    }
                    stage(yf, rr, val);
                }
            }

            // 4. this phase's planes out: the generic proxy's writes made
            // visible to the TMA's, then one store a plane
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
            __syncthreads();
            if (tma) {
                if (tid == 0) {
#pragma unroll
                    for (int yf = xf ? 0 : 1; yf < 4; ++yf)
                        asm volatile(
                            "cp.async.bulk.tensor.3d.global.shared::cta"
                            ".bulk_group [%0, {%2, %3, %4}], [%1];\n"
                            :: "l"(reinterpret_cast<uint64_t>(&tmap)),
                               "r"(smem_addr(&s.stage[yf][0][0])),
                               "r"(ox0), "r"(oy0), "r"(yf * 4 + xf - 1)
                            : "memory");
                    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
                }
            } else {
                const size_t plane = (size_t)ph * pw;
                const int nx = min(kTileX, pw - ox0);
                const int ny = min(kTileY, ph - oy0);
                for (int j = tid; j < kGroup * kTileY * kTileX;
                     j += kThreads) {
                    const int yf = j / (kTileY * kTileX);
                    const int rr = (j / kTileX) % kTileY, c = j % kTileX;
                    if ((xf || yf) && rr < ny && c < nx)
                        out[(yf * 4 + xf - 1) * plane
                            + (size_t)(oy0 + rr) * pw + ox0 + c] =
                            s.stage[yf][rr][c];
                }
            }
        }
    }
    // the shared memory stays until the TMA has read the last tile
    if (tma && tid == 0)
        asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

typedef CUresult (*EncodeTiled)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, through the runtime (no -lcuda)
EncodeTiled encode_tiled() {
    static EncodeTiled fn = nullptr;
    if (!fn) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
        cudaError_t e = cudaGetDriverEntryPointByVersion(
            "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
        cudaError_t e = cudaGetDriverEntryPoint(
            "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
        if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
            fn = reinterpret_cast<EncodeTiled>(p);
    }
    return fn;
}

constexpr int kSmem = (int)sizeof(Smem);

// The error behind a failed occupancy query: the runtime's, or
// cudaErrorInvalidValue where it recorded none (a device index past the
// cache, or no CTA fitting an SM), so that no caller takes a launch that
// never happened for one that did.
int occupancy_error() {
    const cudaError_t e = cudaGetLastError();
    return (int)(e != cudaSuccess ? e : cudaErrorInvalidValue);
}

// CTAs an SM holds, per device (the kernel's shared memory opted in first)
int ctas_per_sm(int* sms) {
    static int cached[64][2];
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64)
        return 0;
    if (!cached[dev][0]) {
        if (cudaFuncSetAttribute(subpel_planes_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kSmem) != cudaSuccess)
            return 0;
        int n = 0, m = 0;
        if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &n, subpel_planes_kernel, kThreads, kSmem) != cudaSuccess
            || cudaDeviceGetAttribute(&m, cudaDevAttrMultiProcessorCount, dev)
                   != cudaSuccess)
            return 0;
        cached[dev][0] = n;
        cached[dev][1] = m;
    }
    *sms = cached[dev][1];
    return cached[dev][0];
}

}  // namespace

// ref: (h, w) int16; out: (15, h + 56, w + 56) int16; both contiguous on
// the device; bit_depth in 8..16. Launches on `stream` and returns
// cudaGetLastError() (0 on success, cudaErrorInvalidValue for a bit depth
// outside 8..16 or an empty plane, or where the driver cannot encode the
// output's tensor map); never synchronises.
extern "C" int subpel_planes_launch(const void* ref, int w, int h,
                                    int bit_depth, void* out, void* stream) {
    if (bit_depth < 8 || bit_depth > 16 || w < 1 || h < 1)
        return (int)cudaErrorInvalidValue;
    const int pw = w + 2 * kPad, ph = h + 2 * kPad;
    const int vec_in = w % 8 == 0
                       && (reinterpret_cast<uintptr_t>(ref) & 15) == 0;
    const int tma = pw % 8 == 0
                    && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
    CUtensorMap tmap;
    memset(&tmap, 0, sizeof tmap);
    if (tma) {
        // the samples' bits, stored as they are (the map has no int16)
        EncodeTiled enc = encode_tiled();
        const cuuint64_t dims[3] = {(cuuint64_t)pw, (cuuint64_t)ph,
                                    (cuuint64_t)kPlanes};
        const cuuint64_t strides[2] = {(cuuint64_t)pw * 2,
                                       (cuuint64_t)ph * pw * 2};
        const cuuint32_t box[3] = {kTileX, kTileY, 1};
        const cuuint32_t one[3] = {1, 1, 1};
        if (!enc || enc(&tmap, CU_TENSOR_MAP_DATA_TYPE_UINT16, 3, out, dims,
                        strides, box, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_NONE,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
            return (int)cudaErrorInvalidValue;
    }
    int sms = 0;
    const int per_sm = ctas_per_sm(&sms);
    if (per_sm < 1) return occupancy_error();
    const int tiles = ((pw + kTileX - 1) / kTileX)
                      * ((ph + kTileY - 1) / kTileY);
    const int grid = tiles < per_sm * sms ? tiles : per_sm * sms;
    subpel_planes_kernel<<<grid, kThreads, kSmem, (cudaStream_t)stream>>>(
        tmap, (const int16_t*)ref, w, h, pw, ph,
        bit_depth - 8, vec_in, tma,
        (int16_t*)out);
    return (int)cudaGetLastError();
}

// The kernel's resources on the current device: out[0] registers a
// thread, [1] local (spilled) bytes a thread, [2] shared bytes a CTA,
// [3] CTAs an SM, [4] threads a CTA, [5] CTAs a 1920x1080 plane launches.
// Returns a CUDA error code (0 on success).
extern "C" int subpel_planes_occupancy(int* out) {
    cudaFuncAttributes a;
    cudaError_t e = cudaFuncGetAttributes(&a, subpel_planes_kernel);
    if (e != cudaSuccess) return (int)e;
    int sms = 0;
    const int per_sm = ctas_per_sm(&sms);
    if (per_sm < 1) return occupancy_error();
    const int tiles = ((1920 + 2 * kPad + kTileX - 1) / kTileX)
                      * ((1080 + 2 * kPad + kTileY - 1) / kTileY);
    out[0] = a.numRegs;
    out[1] = (int)a.localSizeBytes;
    out[2] = kSmem;
    out[3] = per_sm;
    out[4] = kThreads;
    out[5] = tiles < per_sm * sms ? tiles : per_sm * sms;
    return 0;
}
