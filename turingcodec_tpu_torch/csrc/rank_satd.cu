// The encoder's source-referenced 35-mode rank-SATD tables, for Hopper
// (sm_90a).
//
// Replaces the XLA program turingcodec_tpu/encode/device_analysis.py
// _rank_tables_program (:628, jax.jit :786). For every aligned n x n block
// of an (h, w) luma plane, n in {4, 8, 16, 32}, it gives the Hadamard SATD
// of the block against its planar, DC and 33 angular intra predictions from
// the plane's own samples (intra_search._mode_satds with source references):
// (hn, wn, 35) int32 per size, with
//   - the 4n + 1 reference samples in scan order (left column bottom-up,
//     corner, top row), available when inside the picture and not later in
//     z-scan order than the block (the zscan table, as _rank_static's `ok`);
//     sample 0 takes the first available one, every other unavailable one
//     the one before it, and a block with none takes 1 << (bd - 1);
//   - for n > 4 their [1 2 1] filtered copy, at n = 32 with strong
//     smoothing the bilinear one where both flatness tests pass at
//     1 << (bd - 5); each mode takes the filtered copy or not as
//     decode/reconstruct.py _HVD_THRES says (DC never does);
//   - the angular modes' positions and fractions derived here from the
//     spec's intraPredAngle and invAngle (hevc/tables.py, compiled in by
//     ops/kernel_build.py with _HVD_THRES): a horizontal mode is the
//     vertical one on the transposed block, whose SATD is the same;
//   - per 4x4 sub-block (n = 4) (sum |H d H| + 1) >> 1, per 8x8 sub-block
//     (sum |H d H| + 2) >> 2, H the Sylvester Hadamard matrix (add/sub
//     butterflies in registers), summed over the block in int32.
// Samples arrive as int16 and are sign-extended, as the reference's int16
// upload does at 16 bits; the arithmetic is the reference's int32.
//
// What bounds it. At 1080p the four sizes hold 172,020 blocks: 35 modes x
// 2.07 M samples per size, each sample's prediction, difference and share of
// the two butterfly passes about 12 INT32 instructions (a multiply-add is
// one IMAD), 3.30 G in all (chip_smoke.py rank_ops): 0.198 ms at the INT32
// issue rate. The bytes (the plane read once per size, 24 MB of tables
// written) take 10 us. Operations bound it.
//
// Design. One launch per size. A CTA of 7 warps owns K consecutive blocks
// of one size, K n^2 = 32 sub-blocks' worth (K = 32, 32, 8, 2 for n = 4, 8,
// 16, 32). It
//   1. reads the blocks' reference samples with their availability and the
//      blocks themselves into shared memory;
//   2. substitutes unavailable samples, one warp per block, by ballots over
//      32 samples at a time, and sums the DC value;
//   3. filters the references (n > 4);
//   4. hands each warp whole modes (7 warps, 35 modes: 5 each): lane l takes
//      block l / s, sub-block l % s (s = sub-blocks per block), forms the
//      prediction and the difference in registers, runs the butterflies and
//      sums; the s lanes of a block add their SATDs by shuffles. Every warp
//      runs one mode, so no lane diverges;
//   5. writes the K x 35 table entries, one contiguous range.
// Nothing but the tables is written to device memory.
#include <cuda_runtime.h>
#include <stdint.h>

#if !defined(TC_INTRA_PRED_ANGLE) || !defined(TC_INTRA_INV_ANGLE) || !defined(TC_HVD_THRES)
#error "intra tables undefined: build with ops/kernel_build.py, which pre-includes hevc/tables.py's angle tables"
#endif

namespace {

constexpr int kWarps = 7;
constexpr int kThreads = 32 * kWarps;
constexpr int kModes = 35;

template <int N>
struct Size {
    static constexpr int SB = N == 4 ? 4 : 8;       // SATD sub-block
    static constexpr int NSUB = (N / SB) * (N / SB);
    static constexpr int K = 32 / NSUB;             // blocks per CTA
    static constexpr int M = 4 * N + 1;             // reference samples
    static constexpr int LOG2 = N == 4 ? 2 : N == 8 ? 3 : N == 16 ? 4 : 5;
};

template <int SB>
__device__ inline void wht(int* x) {
#pragma unroll
    for (int s = 1; s < SB; s <<= 1)
#pragma unroll
        for (int i = 0; i < SB; ++i)
            if (!(i & s)) {
                const int a = x[i], b = x[i + s];
                x[i] = a + b;
                x[i + s] = a - b;
            }
}

template <int SB>
__device__ inline int satd(int (&d)[SB][SB]) {
#pragma unroll
    for (int i = 0; i < SB; ++i) wht<SB>(d[i]);
#pragma unroll
    for (int j = 0; j < SB; ++j) {
        int c[SB];
#pragma unroll
        for (int i = 0; i < SB; ++i) c[i] = d[i][j];
        wht<SB>(c);
#pragma unroll
        for (int i = 0; i < SB; ++i) d[i][j] = c[i];
    }
    int s = 0;
#pragma unroll
    for (int i = 0; i < SB; ++i)
#pragma unroll
        for (int j = 0; j < SB; ++j) s += abs(d[i][j]);
    return SB == 8 ? (s + 2) >> 2 : (s + 1) >> 1;
}

template <int N>
__global__ void __launch_bounds__(kThreads)
rank_satd_kernel(const int16_t* __restrict__ plane, int w, int h,
                 const int32_t* __restrict__ zscan, int zw, int bd,
                 int strong, int wn, int nblocks,
                 int32_t* __restrict__ out) {
    using S = Size<N>;
    constexpr int SB = S::SB, NSUB = S::NSUB, K = S::K, M = S::M;
    constexpr int angle[33] = {TC_INTRA_PRED_ANGLE};   // modes 2..34
    constexpr int inv_angle[15] = {TC_INTRA_INV_ANGLE};  // modes 11..25
    constexpr int hvd_thres[3] = {TC_HVD_THRES};       // n = 8, 16, 32
    __shared__ int32_t s_u[K][M];                 // references, scan order
    __shared__ int32_t s_f[N > 4 ? K : 1][M];     // their filtered copy
    // the blocks, pixel-major: s_o[i * SB + j][k * NSUB + sub] is sample
    // (i, j) of sub-block sub of block k, so that the 32 lanes of a warp,
    // one per (block, sub-block), read 32 banks
    __shared__ int32_t s_o[SB * SB][32];
    __shared__ int32_t s_acc[K][kModes];
    __shared__ int32_t s_dc[K];
    __shared__ uint8_t s_ok[K][M];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int b0 = blockIdx.x * K;

    // 1. references with their availability, and the blocks
    for (int i = tid; i < K * M; i += kThreads) {
        const int k = i / M, t = i - k * M, b = b0 + k;
        int v = 0;
        bool ok = false;
        if (b < nblocks) {
            const int by = b / wn * N, bx = b % wn * N;
            const int x = t < 2 * N ? bx - 1 : t == 2 * N ? bx - 1
                                                          : bx + t - 2 * N - 1;
            const int y = t < 2 * N ? by + 2 * N - 1 - t : by - 1;
            if (x >= 0 && y >= 0 && x < w && y < h) {
                ok = __ldg(zscan + (y >> 2) * zw + (x >> 2))
                     <= __ldg(zscan + (by >> 2) * zw + (bx >> 2));
                v = __ldg(plane + (size_t)y * w + x);
            }
        }
        s_u[k][t] = v;
        s_ok[k][t] = ok;
    }
    for (int i = tid; i < K * N * N; i += kThreads) {
        const int k = i / (N * N), p = i - k * (N * N), b = b0 + k;
        const int y = p / N, x = p % N;
        int v = 0;
        if (b < nblocks) {
            const int by = b / wn * N, bx = b % wn * N;
            v = __ldg(plane + (size_t)(by + y) * w + bx + x);
        }
        s_o[y % SB * SB + x % SB][k * NSUB + y / SB * (N / SB) + x / SB] = v;
    }
    __syncthreads();

    // 2. substitution and the DC value, one warp per block
    for (int k = warp; k < K; k += kWarps) {
        int first = -1;
        for (int c = 0; c < M; c += 32) {
            const int t = c + lane;
            const unsigned m = __ballot_sync(~0u, t < M && s_ok[k][t]);
            if (m) {
                first = c + __ffs(m) - 1;
                break;
            }
        }
        if (first < 0) {
            for (int t = lane; t < M; t += 32) s_u[k][t] = 1 << (bd - 1);
        } else {
            // sample 0 is available from here on, with the first value
            const int v0 = s_u[k][first];
            int carry = v0;
            for (int c = 0; c < M; c += 32) {
                const int t = c + lane;
                const bool ok = t < M && (t == 0 || s_ok[k][t]);
                const int v = !ok ? 0 : t == 0 ? v0 : s_u[k][t];
                const unsigned m = __ballot_sync(~0u, ok);
                const unsigned upto = m & (~0u >> (31 - lane));
                const int src = upto ? 31 - __clz(upto) : 0;
                const int got = __shfl_sync(~0u, v, src);
                const int top = m ? 31 - __clz(m) : 0;
                const int last = __shfl_sync(~0u, v, top);
                if (t < M) s_u[k][t] = upto ? got : carry;
                if (m) carry = last;
            }
        }
        __syncwarp();
        int s = 0;
        for (int i = lane; i < N; i += 32)
            s += s_u[k][2 * N + 1 + i] + s_u[k][2 * N - 1 - i];
#pragma unroll
        for (int o = 16; o; o >>= 1) s += __shfl_xor_sync(~0u, s, o);
        if (lane == 0) s_dc[k] = (s + N) >> (S::LOG2 + 1);
    }
    __syncthreads();

    // 3. the filtered references
    if constexpr (N > 4) {
        for (int i = tid; i < K * M; i += kThreads) {
            const int k = i / M, t = i - k * M;
            const int32_t* u = s_u[k];
            int v = t == 0 || t == 4 * N
                        ? u[t] : (u[t - 1] + 2 * u[t] + u[t + 1] + 2) >> 2;
            if constexpr (N == 32) {
                // corner u[64]; top T[i] = u[65 + i], left L[i] = u[63 - i]
                const int co = u[64];
                const int t1 = abs(co + u[128] - 2 * u[96]);
                const int t2 = abs(co + u[0] - 2 * u[32]);
                const int lim = 1 << (bd - 5);
                if (strong && t1 < lim && t2 < lim) {
                    if (t == 64)
                        v = co;
                    else if (t > 64 && t < 128)  // T[i], i = t - 65 < 63
                        v = ((128 - t) * co + (t - 64) * u[128] + 32) >> 6;
                    else if (t > 0 && t < 64)    // L[i], i = 63 - t < 63
                        v = (t * co + (64 - t) * u[0] + 32) >> 6;
                }
            }
            s_f[k][t] = v;
        }
        __syncthreads();
    }

    // 4. per warp whole modes; lane = (block, sub-block)
    constexpr int NS = N / SB;                          // sub-blocks a row
    const int k = lane / NSUB, sub = lane % NSUB;
    const int a0 = sub / NS * SB, c0 = sub % NS * SB;
    // the transposed sub-block's lane, for the horizontal modes
    const int lane_t = k * NSUB + sub % NS * NS + sub / NS;
    const int32_t* uc = s_u[k] + 2 * N;                 // the corner
    const int32_t* fc = N > 4 ? s_f[N > 4 ? k : 0] + 2 * N : uc;
    for (int mode = warp; mode < kModes; mode += kWarps) {
        int d[SB][SB];
        if (mode == 0) {
            // planar, from the filtered references for n > 4:
            // top T[i] = r[1 + i], left L[i] = r[-1 - i]
            const int32_t* r = fc;
#pragma unroll
            for (int i = 0; i < SB; ++i) {
                const int a = a0 + i;
#pragma unroll
                for (int j = 0; j < SB; ++j) {
                    const int b = c0 + j;
                    const int p = ((N - 1 - b) * r[-1 - a] + (b + 1) * r[1 + N]
                                   + (N - 1 - a) * r[1 + b]
                                   + (a + 1) * r[-1 - N] + N) >> (S::LOG2 + 1);
                    d[i][j] = s_o[i * SB + j][lane] - p;
                }
            }
        } else if (mode == 1) {
            const int dc = s_dc[k];
#pragma unroll
            for (int i = 0; i < SB; ++i)
#pragma unroll
                for (int j = 0; j < SB; ++j)
                    d[i][j] = s_o[i * SB + j][lane] - dc;
        } else {
            const int ang = angle[mode - 2];
            const int inv = mode >= 11 && mode <= 25 ? inv_angle[mode - 11] : 0;
            const bool vert = mode >= 18;
            const int dist = min(abs(mode - 26), abs(mode - 10));
            const bool filt = N > 4 && dist > hvd_thres[N > 4 ? S::LOG2 - 3 : 0];
            // ref[r] of the spec, r in -N .. 2N + 1, at c[sign * idx]: the
            // main side at idx > 0, the other side's projection at idx < 0
            const int32_t* c = filt ? fc : uc;
            const int sign = vert ? 1 : -1;
            // sample (a, b) of the prediction is the block's (a, b) for a
            // vertical mode, its (b, a) for a horizontal one
            const int lo = vert ? lane : lane_t;
            const int sa = vert ? SB : 1, sb = vert ? 1 : SB;
#pragma unroll
            for (int i = 0; i < SB; ++i) {
                const int a = a0 + i;
                const int pa = (a + 1) * ang;
                const int fr = pa & 31, r0 = c0 + (pa >> 5) + 1;
                int v[SB + 1];
#pragma unroll
                for (int j = 0; j <= SB; ++j) {
                    const int r = r0 + j;
                    const int idx = r >= 0 ? min(r, 2 * N)
                                           : -min((r * inv + 128) >> 8, 2 * N);
                    v[j] = c[sign * idx];
                }
#pragma unroll
                for (int j = 0; j < SB; ++j) {
                    const int p = ((32 - fr) * v[j] + fr * v[j + 1] + 16) >> 5;
                    d[i][j] = s_o[i * sa + j * sb][lo] - p;
                }
            }
        }
        unsigned s = (unsigned)satd<SB>(d);
#pragma unroll
        for (int o = 1; o < NSUB; o <<= 1) s += __shfl_xor_sync(~0u, s, o);
        if (sub == 0) s_acc[k][mode] = (int)s;
    }
    __syncthreads();

    // 5. the K blocks' tables, one contiguous range
    const int n = min(K, nblocks - b0) * kModes;
    int32_t* g = out + (size_t)b0 * kModes;
    for (int i = tid; i < n; i += kThreads) g[i] = (&s_acc[0][0])[i];
}

template <int N>
int launch(const int16_t* plane, int w, int h, const int32_t* zscan, int zw,
           int bd, int strong, int32_t* out, cudaStream_t stream) {
    const int hn = h / N, wn = w / N, nblocks = hn * wn;
    if (nblocks == 0) return 0;
    const int grid = (nblocks + Size<N>::K - 1) / Size<N>::K;
    rank_satd_kernel<N><<<grid, kThreads, 0, stream>>>(
        plane, w, h, zscan, zw, bd, strong, wn, nblocks, out);
    return (int)cudaGetLastError();
}

}  // namespace

// plane: (h, w) int16; zscan: (ceil(h / 4) or more rows, zw) int32 z-scan
// order of every 4x4 block; out: int32, the tables of the sizes in
// size_mask (bit 0: n = 4, 1: 8, 2: 16, 3: 32) one after another in
// ascending n, each (h / n, w / n, 35) row-major (a size with no whole
// block takes no room); all contiguous on the device; bit_depth in 8..16.
// Launches one kernel per size on `stream` and returns cudaGetLastError()
// (0 on success, cudaErrorInvalidValue for a bit depth outside 8..16, an
// empty plane or a zscan narrower than the plane); never synchronises.
extern "C" int rank_satd_launch(const void* plane, int w, int h,
                                const void* zscan, int zw, int bit_depth,
                                int strong, int size_mask, void* out,
                                void* stream) {
    if (bit_depth < 8 || bit_depth > 16 || w < 1 || h < 1 || zw * 4 < w)
        return (int)cudaErrorInvalidValue;
    const int16_t* p = (const int16_t*)plane;
    const int32_t* z = (const int32_t*)zscan;
    int32_t* o = (int32_t*)out;
    cudaStream_t s = (cudaStream_t)stream;
    int rc = 0;
    if (size_mask & 1) {
        rc = launch<4>(p, w, h, z, zw, bit_depth, strong, o, s);
        o += (size_t)(h / 4) * (w / 4) * kModes;
    }
    if (!rc && (size_mask & 2)) {
        rc = launch<8>(p, w, h, z, zw, bit_depth, strong, o, s);
        o += (size_t)(h / 8) * (w / 8) * kModes;
    }
    if (!rc && (size_mask & 4)) {
        rc = launch<16>(p, w, h, z, zw, bit_depth, strong, o, s);
        o += (size_t)(h / 16) * (w / 16) * kModes;
    }
    if (!rc && (size_mask & 8))
        rc = launch<32>(p, w, h, z, zw, bit_depth, strong, o, s);
    return rc ? rc : (int)cudaGetLastError();
}
