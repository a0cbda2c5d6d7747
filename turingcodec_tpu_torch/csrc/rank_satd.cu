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
//     ops/kernel_build.py with _HVD_THRES);
//   - per 4x4 sub-block (n = 4) (sum |H d H| + 1) >> 1, per 8x8 sub-block
//     (sum |H d H| + 2) >> 2, H the Sylvester Hadamard matrix (add/sub
//     butterflies in registers), summed over the block in int32.
// Samples arrive as int16 and are sign-extended, as the reference's int16
// upload does at 16 bits; the arithmetic is the reference's int32.
//
// What bounds it. At 1080p the four sizes hold 172,020 blocks: 35 modes x
// 2.07 M samples per size. Per sample and mode the prediction (two
// multiply-adds and a shift for an angular mode), the difference, the
// butterflies (6 adds a sample for 8x8, 4 for 4x4) and the absolute value
// and sum: 3.30 G INT32 operations at 12 bits, 2.51 G at 8 where two
// modes share their butterflies (below; chip_smoke.py rank_ops counts
// them): 0.150 ms at 8 bits at the INT32 issue rate. The bytes (the plane
// read once per size, 24 MB of tables written) take 10 us. Operations
// bound it.
//
// Design. One launch per size. A CTA of 2 warps owns K consecutive blocks
// of one size, K n^2 = 32 sub-blocks' worth (K = 32, 32, 8, 2 for n = 4, 8,
// 16, 32); lane l of each warp takes block l / s, sub-block l % s (s =
// sub-blocks per block). The CTA
//   1. reads the blocks' reference samples with their availability, and
//      the blocks themselves SB samples of a row per load, into shared
//      memory;
//   2. substitutes unavailable samples: the availability as bit masks (a
//      ballot per 32 samples), then a thread per sample finds the last
//      available one at or before it; a thread per block sums the DC
//      value;
//   3. filters the references (n > 4);
//   4. gives each warp 9 of 18 units of two modes of one orientation (8
//      horizontal pairs, 8 vertical pairs, mode 34 with DC, planar). A
//      row of an angular prediction reads the spec's ref[r0 + j], r0
//      computed once a row: two multiply-adds and a shift a sample. A mode
//      of positive angle reads its main side where the scan order holds
//      it (backwards for the left column); for one of negative angle
//      (11..25) the warp first writes each block's ref[1 - n .. n + 1]
//      into its own shared memory, the other side's inverse-angle
//      projection below 0. A horizontal mode is predicted transposed, the
//      fraction fixed along a column, against the lane's sub-block read
//      transposed: the SATD of a transposed difference is the same. Where
//      every sample of the CTA's blocks and references lies in 0 .. 511
//      (0 .. 2047 for 4x4 sub-blocks), and so every Hadamard output of a
//      difference fits in int16 (a prediction lies between its
//      references), the two modes of a unit share their butterflies:
//      their differences packed as lo + hi * 65536 in one 32-bit word add
//      and subtract exactly, and are unpacked before the absolute values.
//      Every 8-bit picture takes that path; others run the modes one
//      after the other. The s lanes of a block add their SATDs by
//      shuffles;
//   5. writes the K x 35 table entries, one contiguous range.
// Nothing but the tables is written to device memory.
//
// What holds it (PERF.md section 6): latency, not
// issue. A sub-block's 64 difference words and a row's references loaded
// ahead take 168 registers a thread at the 8x8 sizes, so an SM holds 12
// warps, and the card could issue several times the operations that
// chip_smoke.py rank_ops counts in the time taken. Small CTAs (2 warps,
// 6 an SM) beat 6-warp ones at the same occupancy; holding the sub-block
// in registers, or forcing 3 CTAs of 6 warps an SM, ran slower.
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

#if !defined(TC_INTRA_PRED_ANGLE) || !defined(TC_INTRA_INV_ANGLE) || !defined(TC_HVD_THRES)
#error "intra tables undefined: build with ops/kernel_build.py, which pre-includes hevc/tables.py's angle tables"
#endif

namespace {

constexpr int kWarps = 2;
constexpr int kThreads = 32 * kWarps;
constexpr int kModes = 35;
constexpr int kUnits = 18;

__constant__ int c_angle[33] = {TC_INTRA_PRED_ANGLE};    // modes 2..34
__constant__ int c_inv_angle[15] = {TC_INTRA_INV_ANGLE};  // modes 11..25
__constant__ int c_hvd_thres[3] = {TC_HVD_THRES};         // n = 8, 16, 32

template <int N>
struct Size {
    static constexpr int SB = N == 4 ? 4 : 8;       // SATD sub-block
    static constexpr int NSUB = (N / SB) * (N / SB);
    static constexpr int K = 32 / NSUB;             // blocks per CTA
    static constexpr int M = 4 * N + 1;             // reference samples
    static constexpr int RW = 2 * N + 1;  // a negative mode's ref[1-N..N+1]
    static constexpr int LOG2 = N == 4 ? 2 : N == 8 ? 3 : N == 16 ? 4 : 5;
    // the largest sample for which the packed butterflies are exact:
    // SB^2 * LIM fits in int16
    static constexpr int LIM = SB == 8 ? 511 : 2047;
    using Vec = std::conditional_t<SB == 8, uint4, uint2>;  // SB samples
};

template <int SB, typename T>
__device__ __forceinline__ void wht(T* x) {
#pragma unroll
    for (int s = 1; s < SB; s <<= 1)
#pragma unroll
        for (int i = 0; i < SB; ++i)
            if (!(i & s)) {
                const T a = x[i], b = x[i + s];
                x[i] = a + b;
                x[i + s] = a - b;
            }
}

// H d H in place: the rows, then the columns
template <int SB, typename T>
__device__ __forceinline__ void wht2(T (&d)[SB][SB]) {
#pragma unroll
    for (int i = 0; i < SB; ++i) wht<SB>(d[i]);
#pragma unroll
    for (int j = 0; j < SB; ++j) {
        T c[SB];
#pragma unroll
        for (int i = 0; i < SB; ++i) c[i] = d[i][j];
        wht<SB>(c);
#pragma unroll
        for (int i = 0; i < SB; ++i) d[i][j] = c[i];
    }
}

template <int SB>
__device__ __forceinline__ int round_satd(unsigned s) {
    return (int)(SB == 8 ? (s + 2) >> 2 : (s + 1) >> 1);
}

// one difference per word; the absolute values summed a row at a time
// into SB partial sums, so that no chain of SB * SB adds waits on itself
template <int SB>
__device__ __forceinline__ int satd(int (&d)[SB][SB]) {
    wht2<SB>(d);
    unsigned s[SB];
#pragma unroll
    for (int j = 0; j < SB; ++j) s[j] = abs(d[0][j]);
#pragma unroll
    for (int i = 1; i < SB; ++i)
#pragma unroll
        for (int j = 0; j < SB; ++j) s[j] += abs(d[i][j]);
#pragma unroll
    for (int j = 1; j < SB; ++j) s[0] += s[j];
    return round_satd<SB>(s[0]);
}

// two differences per word, lo + hi * 65536: the butterflies are linear,
// so each output is LO + HI * 65536 mod 2^32, and both halves come back
// exactly while |LO| and |HI| fit in int16
template <int SB>
__device__ __forceinline__ void satd_packed(unsigned (&d)[SB][SB], int& s_lo,
                                            int& s_hi) {
    wht2<SB>(d);
    unsigned a[SB] = {}, b[SB] = {};
#pragma unroll
    for (int i = 0; i < SB; ++i)
#pragma unroll
        for (int j = 0; j < SB; ++j) {
            const int lo = (int16_t)(d[i][j] & 0xffffu);
            const int hi = (int)(d[i][j] - (unsigned)lo) >> 16;
            a[j] += abs(lo);
            b[j] += abs(hi);
        }
#pragma unroll
    for (int j = 1; j < SB; ++j) {
        a[0] += a[j];
        b[0] += b[j];
    }
    s_lo = round_satd<SB>(a[0]);
    s_hi = round_satd<SB>(b[0]);
}

// What one lane predicts from: its block's references (corner at 0,
// top T[i] = r[1 + i], left L[i] = r[-1 - i]), its sub-block's place, and
// its warp's reference rows.
struct Lane {
    const int32_t* uc;       // the references
    const int32_t* fc;       // their filtered copy (uc for n = 4)
    int32_t* row;            // the warp's row of this block (RW entries)
    int dc;
    int a0, c0;              // the sub-block's row and column in the block
};

// The warp's reference rows for a mode of negative angle (11..25): for
// each of the K blocks ref[r], r = 1 - N .. N + 1 (all such a mode reads),
// at rows[k * RW + r + N - 1] for a vertical mode and at
// rows[k * RW + N + 1 - r] for a horizontal one (as the scan order holds
// its main side): the main side (the top row for a vertical mode, the left
// column for a horizontal one; filtered or not) at r >= 0, and below 0 the
// other side at the inverse-angle projection. The other modes read their
// main side where the scan order holds it.
template <int N, bool TRANS>
__device__ __forceinline__ void build_rows(int32_t* rows,
                                           const int32_t* base, int inv,
                                           int lane) {
    using S = Size<N>;
    constexpr int M = S::M, RW = S::RW, K = S::K;
    constexpr int sign = TRANS ? -1 : 1;
    __syncwarp();
#pragma unroll
    for (int it = 0; it < (K * RW + 31) / 32; ++it) {
        const int e = lane + 32 * it;
        if (e < K * RW) {
            const int k = e / RW, q = e - k * RW;
            const int r = TRANS ? N + 1 - q : q - (N - 1);
            const int idx = r >= 0 ? r : -min((r * inv + 128) >> 8, 2 * N);
            rows[e] = base[k * M + sign * idx];
        }
    }
    __syncwarp();
}

// Mode `mode`'s prediction of the lane's sub-block, each sample handed to
// acc(i, j, p): sample (a0 + i, c0 + j) of the block, or for a horizontal
// mode (TRANS) sample (a0 + j, c0 + i). The warp calls it together.
template <int N, bool TRANS, typename Acc>
__device__ __forceinline__ void predict(int mode, const Lane& ln,
                                        int32_t* rows, const int32_t* s_u,
                                        const int32_t* s_f, int lane,
                                        Acc&& acc) {
    constexpr int SB = Size<N>::SB, LOG2 = Size<N>::LOG2;
    if (!TRANS && mode == 0) {
        // planar, from the filtered references for n > 4
        const int32_t* r = ln.fc;
        const int tr = r[1 + N], bl = r[-1 - N];
        int top[SB];
#pragma unroll
        for (int j = 0; j < SB; ++j) top[j] = r[1 + ln.c0 + j];
#pragma unroll
        for (int i = 0; i < SB; ++i) {
            const int a = ln.a0 + i;
            const int left = r[-1 - a];
#pragma unroll
            for (int j = 0; j < SB; ++j) {
                const int b = ln.c0 + j;
                acc(i, j, ((N - 1 - b) * left + (b + 1) * tr
                           + (N - 1 - a) * top[j] + (a + 1) * bl + N)
                              >> (LOG2 + 1));
            }
        }
    } else if (!TRANS && mode == 1) {
#pragma unroll
        for (int i = 0; i < SB; ++i)
#pragma unroll
            for (int j = 0; j < SB; ++j) acc(i, j, ln.dc);
    } else {
        // ref[r] at ref0[S * r]: the scan order holds the left column
        // bottom-up, so a horizontal mode reads it backwards
        constexpr int S = TRANS ? -1 : 1;
        const int ang = c_angle[mode - 2];
        const int dist = min(abs(mode - 26), abs(mode - 10));
        const bool filt = N > 4
                          && dist > c_hvd_thres[N > 4 ? LOG2 - 3 : 0];
        const int32_t* ref0;
        if (ang < 0) {
            build_rows<N, TRANS>(rows, (filt ? s_f : s_u) + 2 * N,
                                 c_inv_angle[mode - 11], lane);
            ref0 = ln.row + (TRANS ? N + 1 : N - 1);
        } else {
            ref0 = filt ? ln.fc : ln.uc;
        }
#pragma unroll
        for (int i = 0; i < SB; ++i) {
            const int pa = ((TRANS ? ln.c0 : ln.a0) + i + 1) * ang;
            const int fr = pa & 31;
            const int r0 = (TRANS ? ln.a0 : ln.c0) + (pa >> 5) + 1;
            const int32_t* v = ref0 + S * r0;
            int x[SB + 1];
#pragma unroll
            for (int j = 0; j < SB; ++j) x[j] = v[S * j];
            // ref[2N + 1] comes in only with weight 0 (fr = 0 at angle 32)
            x[SB] = ref0[S * min(r0 + SB, 2 * N)];
#pragma unroll
            for (int j = 0; j < SB; ++j)
                acc(i, j, ((32 - fr) * x[j] + fr * x[j + 1] + 16) >> 5);
        }
    }
}

// One unit: modes ma and mb (mb < 0: none) of one orientation; the lane's
// SATDs of its sub-block in sa, sb. o(i, j) is sample (a0 + i, c0 + j) of
// the sub-block.
template <int N, bool PACK, bool TRANS, typename Orig>
__device__ __forceinline__ void unit(int ma, int mb, const Lane& ln,
                                     int32_t* rows, const int32_t* s_u,
                                     const int32_t* s_f, int lane,
                                     Orig&& o, int& sa, int& sb) {
    constexpr int SB = Size<N>::SB;
    auto at = [&](int i, int j) { return TRANS ? o(j, i) : o(i, j); };
    if constexpr (PACK) {
        unsigned d[SB][SB];
        predict<N, TRANS>(ma, ln, rows, s_u, s_f, lane, [&](int i, int j,
                                                            int p) {
            d[i][j] = (unsigned)at(i, j) * 65537u - (unsigned)p;
        });
        if (mb >= 0)
            predict<N, TRANS>(mb, ln, rows, s_u, s_f, lane, [&](int i, int j,
                                                                int p) {
                d[i][j] -= (unsigned)p << 16;
            });
        satd_packed<SB>(d, sa, sb);
    } else {
        int d[SB][SB];
        predict<N, TRANS>(ma, ln, rows, s_u, s_f, lane, [&](int i, int j,
                                                            int p) {
            d[i][j] = at(i, j) - p;
        });
        sa = satd<SB>(d);
        sb = 0;
        if (mb >= 0) {
            predict<N, TRANS>(mb, ln, rows, s_u, s_f, lane, [&](int i, int j,
                                                                int p) {
                d[i][j] = at(i, j) - p;
            });
            sb = satd<SB>(d);
        }
    }
}

// Step 4 for one warp: its units, the lanes' SATDs summed per block into
// s_acc.
template <int N, bool PACK>
__device__ __forceinline__ void modes(const Lane& ln, int32_t* rows,
                                      const int32_t* s_u, const int32_t* s_f,
                                      const int32_t (*s_o)[32],
                                      int32_t (*s_acc)[kModes], int warp,
                                      int lane) {
    using S = Size<N>;
    constexpr int SB = S::SB, NSUB = S::NSUB;
    // the lane's sub-block, read from shared memory in every unit: held in
    // registers it takes 60-90 more a thread, and runs slower
    auto o = [&](int i, int j) { return s_o[i * SB + j][lane]; };
    const int k = lane / NSUB, sub = lane % NSUB;
    for (int u = warp; u < kUnits; u += kWarps) {
        // units 0..7: horizontal pairs 2..17; 8..15: vertical pairs
        // 18..33; 16: 34 and DC; 17: planar
        const int ma = u < 16 ? 2 + 2 * u : u == 16 ? 34 : 0;
        const int mb = u < 16 ? ma + 1 : u == 16 ? 1 : -1;
        int sa, sb;
        if (u < 8)
            unit<N, PACK, true>(ma, mb, ln, rows, s_u, s_f, lane, o, sa, sb);
        else
            unit<N, PACK, false>(ma, mb, ln, rows, s_u, s_f, lane, o, sa, sb);
        unsigned ua = (unsigned)sa, ub = (unsigned)sb;
#pragma unroll
        for (int m = 1; m < NSUB; m <<= 1) {
            ua += __shfl_xor_sync(~0u, ua, m);
            ub += __shfl_xor_sync(~0u, ub, m);
        }
        if (sub == 0) {
            s_acc[k][ma] = (int)ua;
            if (mb >= 0) s_acc[k][mb] = (int)ub;
        }
    }
}

// at least 16 CTAs an SM for n = 4 (64 registers a thread), 6 for the
// 8x8 sizes (168): left alone, ptxas takes up to 254 and the SM holds
// fewer warps; bounds that allow fewer registers spill and run slower
template <int N>
__global__ void __launch_bounds__(kThreads, N == 4 ? 16 : 6)
rank_satd_kernel(const int16_t* __restrict__ plane, int w, int h,
                 const int32_t* __restrict__ zscan, int zw, int bd,
                 int strong, int wn, int nblocks,
                 int32_t* __restrict__ out) {
    using S = Size<N>;
    constexpr int SB = S::SB, NSUB = S::NSUB, K = S::K, M = S::M;
    constexpr int RW = S::RW;
    __shared__ int32_t s_u[K][M];                 // references, scan order
    __shared__ int32_t s_f[N > 4 ? K : 1][M];     // their filtered copy
    // the blocks, pixel-major: s_o[i * SB + j][k * NSUB + sub] is sample
    // (i, j) of sub-block sub of block k, so that the 32 lanes of a warp,
    // one per (block, sub-block), read 32 banks
    __shared__ int32_t s_o[SB * SB][32];
    __shared__ int32_t s_rows[kWarps][K * RW];    // each warp's ref rows
    __shared__ int32_t s_acc[K][kModes];
    __shared__ int32_t s_dc[K];
    __shared__ uint8_t s_ok[K][M];
    __shared__ unsigned s_mask[K][(M + 31) / 32];  // s_ok as bits
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int b0 = blockIdx.x * K;

    // 1. references with their availability, and the blocks; whether
    // every sample lies in 0 .. LIM
    bool small = true;
#pragma unroll 4
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
        small = small && (unsigned)v <= (unsigned)S::LIM;
    }
    // the blocks SB samples of a row at a time (16 or 8 bytes) where the
    // rows are aligned so, else one at a time
    if (w % SB == 0 && (uintptr_t)plane % (2 * SB) == 0) {
        using Vec = typename S::Vec;
        constexpr int R = N * N / SB;                   // loads a block
#pragma unroll 4
        for (int i = tid; i < K * R; i += kThreads) {
            const int k = i / R, p = (i - k * R) * SB, b = b0 + k;
            const int y = p / N, x = p % N;
            Vec vec = {};
            if (b < nblocks) {
                const int by = b / wn * N, bx = b % wn * N;
                vec = __ldg(reinterpret_cast<const Vec*>(
                    plane + (size_t)(by + y) * w + bx + x));
            }
            int16_t v[SB];
            memcpy(v, &vec, sizeof(v));
            const int col = k * NSUB + y / SB * (N / SB) + x / SB;
#pragma unroll
            for (int j = 0; j < SB; ++j) {
                s_o[y % SB * SB + j][col] = v[j];
                small = small && (unsigned)v[j] <= (unsigned)S::LIM;
            }
        }
    } else {
        for (int i = tid; i < K * N * N; i += kThreads) {
            const int k = i / (N * N), p = i - k * (N * N), b = b0 + k;
            const int y = p / N, x = p % N;
            int v = 0;
            if (b < nblocks) {
                const int by = b / wn * N, bx = b % wn * N;
                v = __ldg(plane + (size_t)(by + y) * w + bx + x);
            }
            s_o[y % SB * SB + x % SB][k * NSUB + y / SB * (N / SB) + x / SB]
                = v;
            small = small && (unsigned)v <= (unsigned)S::LIM;
        }
    }
    // a block with no reference takes 1 << (bd - 1)
    const bool pack = __syncthreads_and(small)
                      && (1 << (bd - 1)) <= S::LIM;

    // 2. substitution: the availability as bit masks, one ballot per 32
    // samples; then every sample takes the last available one at or
    // before it, one thread per sample (sample 0, and those before the
    // first available one, take the first available one; a block with
    // none takes 1 << (bd - 1))
    constexpr int W = (M + 31) / 32;
    for (int q = warp; q < K * W; q += kWarps) {
        const int k = q / W, c = (q - k * W) * 32 + lane;
        const unsigned m = __ballot_sync(~0u, c < M && s_ok[k][c]);
        if (lane == 0) s_mask[k][q - k * W] = m;
    }
    __syncthreads();
    constexpr int PER = (K * M + kThreads - 1) / kThreads;
    int sub_v[PER];
#pragma unroll
    for (int it = 0; it < PER; ++it) {
        const int i = tid + it * kThreads;
        if (i < K * M) {
            const int k = i / M, t = i - k * M;
            int src = -1;
            unsigned m = s_mask[k][t >> 5] & (~0u >> (31 - (t & 31)));
            for (int wd = t >> 5;;) {
                if (m) {
                    src = wd * 32 + 31 - __clz(m);
                    break;
                }
                if (--wd < 0) break;
                m = s_mask[k][wd];
            }
            for (int wd = 0; src < 0 && wd < W; ++wd)
                if (s_mask[k][wd]) src = wd * 32 + __ffs(s_mask[k][wd]) - 1;
            sub_v[it] = src < 0 ? 1 << (bd - 1) : s_u[k][src];
        }
    }
    __syncthreads();
#pragma unroll
    for (int it = 0; it < PER; ++it) {
        const int i = tid + it * kThreads;
        if (i < K * M) (&s_u[0][0])[i] = sub_v[it];
    }
    __syncthreads();

    // the DC values, a thread per block
    for (int k = tid; k < K; k += kThreads) {
        int sum = N;
#pragma unroll 8
        for (int i = 0; i < N; ++i)
            sum += s_u[k][2 * N + 1 + i] + s_u[k][2 * N - 1 - i];
        s_dc[k] = sum >> (S::LOG2 + 1);
    }
    if constexpr (N == 4) __syncthreads();

    // 3. the filtered references
    if constexpr (N > 4) {
#pragma unroll 4
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

    // 4. per warp its units; lane = (block, sub-block)
    {
        constexpr int NS = N / SB;                      // sub-blocks a row
        const int k = lane / NSUB, sub = lane % NSUB;
        int32_t* rows = s_rows[warp];
        const Lane ln = {s_u[k] + 2 * N, (N > 4 ? s_f[N > 4 ? k : 0] : s_u[k])
                         + 2 * N, rows + k * RW, s_dc[k],
                         sub / NS * SB, sub % NS * SB};
        const int32_t* su = &s_u[0][0];
        const int32_t* sf = N > 4 ? &s_f[0][0] : su;
        if (pack)
            modes<N, true>(ln, rows, su, sf, s_o, s_acc, warp, lane);
        else
            modes<N, false>(ln, rows, su, sf, s_o, s_acc, warp, lane);
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
