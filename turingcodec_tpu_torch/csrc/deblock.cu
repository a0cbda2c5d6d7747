// The decoder's deblocking filter, for Hopper (sm_90a).
//
// Replaces the XLA program turingcodec_tpu/ops/deblock.py deblock_device
// (:272-288, _dir_pass :81): bS from the 4x4 maps, the luma dE decisions
// with the strong and weak filters, and the chroma filter on every second
// luma edge where bS is 2, bit-exact for any int16 samples and bit depth
// 8..16: the vertical edges, then the horizontal edges on the vertical
// pass's output. The XLA program gets the horizontal pass by transposing
// planes and maps; this kernel indexes rows and columns directly.
//
// Edges lie at E = 8, 16, .. below the picture's side; a 4-line segment
// at A (4 lines from A, along the edge) of the edge at E (across it) has
// x = E, y = A for a vertical edge and y = E, x = A for a horizontal one.
// Its edge flag and bS come from the maps (tu/pu/cu ids; the per-slice
// disabled flag at the q side's slice index clamped to [0, n_slices - 1];
// the across-slices and across-tiles rules); the luma filter reads
// E-4 .. E+3 of its 4 lines and writes E-3 .. E+2, and where E is a
// multiple of 16 and bS is 2, the chroma filter reads E/2-2 .. E/2+1 of 2
// chroma lines in Cb and Cr and writes E/2-1 .. E/2. Every intermediate
// value is int32. The beta, tc and 4:2:0 chroma QP tables are compiled in
// as immediates from decode/deblock.py and hevc/tables.py by
// ops/kernel_build.py.
//
// What bounds it. At 1080p a picture's three planes are 6.2 MB of int16,
// read once and written once, and the maps another 4 MB read once:
// about 5 us at 3.35 TB/s. Bytes bound it.
//
// Design: one launch for F pictures (blockIdx.z), out of place. A CTA owns
// the luma window [x0-4, x0+60) x [y0-4, y0+60) for x0, y0 multiples of
// 64, and the chroma windows [x0/2-2, x0/2+30) x [y0/2-2, y0/2+30), all
// clipped to the picture. Inside such a window the vertical pass's output
// depends only on the window's samples (an edge E in [x0, x0+64) reads
// E-4 .. E+3, and no edge outside writes into the window), the horizontal
// pass reads only the vertical pass's output inside the window, and the
// windows' 4-line segments start on multiples of 4, so no segment's
// decision straddles two windows; chroma likewise, shifted by 2. Windows
// are disjoint and cover the picture, so a CTA
//   1. copies its luma window (8 bytes a copy) and both chroma windows
//      (4 bytes) into shared memory with cp.async, all in flight at once,
//      and stages the 4x4 maps of the window's 16 x 16 blocks beside them,
//      a block a thread (21 KB in all); meanwhile each thread reads its
//      segment's slice and tile rules from the CTB maps;
//   2. derives, one thread a segment, the flag, bS and thresholds of its
//      128 vertical and 128 horizontal segments from the staged maps (the
//      p side of the window's first edge is its first block);
//   3. filters the vertical edges in shared memory, then, after a barrier,
//      the horizontal ones;
//   4. writes the whole window, filtered or not, to the output.
// The copy of the planes is the kernel's own read and write, and each
// sample and map is read from and written to device memory once. At 1080p
// the 527 CTAs (256 threads, 4 an SM) run in one wave, so the time is
// about one round trip to device memory for the windows and maps, one more
// for the slice rules, the filters, and the stores draining.
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#if !defined(TC_BETA_TABLE) || !defined(TC_TC_TABLE) || !defined(TC_CHROMA_QP_TABLE)
#error "deblock tables undefined: build with ops/kernel_build.py, which pre-includes them from decode/deblock.py and hevc/tables.py"
#endif

namespace {

constexpr int kT = 64;                       // a CTA's luma window side
constexpr int kTw = kT / 2;                  // its chroma windows' side
constexpr int kSegs = (kT / 8) * (kT / 4);   // 4-line segments a direction
constexpr int kThreads = 2 * kSegs;          // one a segment of either

__constant__ int kBeta[] = {TC_BETA_TABLE};
__constant__ int kTc[] = {TC_TC_TABLE};
__constant__ int kChromaQp[] = {TC_CHROMA_QP_TABLE};

struct Maps {
    // per 4x4 block, (F, h4, w4); ref_idx and ref_poc (F, 2, h4, w4); mv
    // (F, 2, h4, w4, 2) as (x, y)
    const int32_t* tu_id;
    const int32_t* pu_id;
    const int32_t* cu_id;
    const uint8_t* pred_mode;
    const uint8_t* cbf_y;
    const int8_t* ref_idx;
    const int32_t* ref_poc;
    const int16_t* mv;
    const int8_t* qp_y;
    // per CTB, (F, hc, wc)
    const int32_t* slice_idx;
    const int32_t* tile_id;
    // per slice, (F, n_sl)
    const uint8_t* disabled;
    const uint8_t* across;
    const int32_t* beta_off;
    const int32_t* tc_off;
    const int32_t* cb_off;
    const int32_t* cr_off;
    // per picture, (F,); null: across_all for every picture
    const uint8_t* across_tiles;
};

struct Dims {
    int h, w, h4, w4, hc, wc, n_sl, ctb_log2, bd_y, bd_c, across_all;
};

__device__ inline int clip3(int lo, int hi, int v) {
    return min(max(v, lo), hi);
}

__device__ inline bool dge4(int ax, int ay, int bx, int by) {
    return abs(ax - bx) >= 4 || abs(ay - by) >= 4;
}

constexpr int kB = kT / 4;   // 4x4 blocks a window side

// the 4x4 maps of a window's kB x kB blocks, staged in shared memory: the
// block at (r, c) is the picture's (yw / 4 + r, xw / 4 + c)
struct Blocks {
    int32_t tu[kB][kB], pu[kB][kB], cu[kB][kB];
    int32_t poc[2][kB][kB];
    int16_t mv[2][kB][kB][2];   // (x, y)
    int8_t ri[2][kB][kB];
    uint8_t pred[kB][kB], cbf[kB][kB];
    int8_t qp[kB][kB];
};

// the motion bS of blocks p and q (ops/deblock.py _motion_bs)
__device__ int motion_bs(const Blocks& b, int py, int px, int qy, int qx) {
    const int r0p = b.ri[0][py][px], r1p = b.ri[1][py][px];
    const int r0q = b.ri[0][qy][qx], r1q = b.ri[1][qy][qx];
    const int np = (r0p >= 0) + (r1p >= 0), nq = (r0q >= 0) + (r1q >= 0);
    if (np != nq) return 1;
    if (np == 0) return 0;
    const int poc0p = b.poc[0][py][px], poc1p = b.poc[1][py][px];
    const int poc0q = b.poc[0][qy][qx], poc1q = b.poc[1][qy][qx];
    const int m0px = b.mv[0][py][px][0], m0py = b.mv[0][py][px][1];
    const int m1px = b.mv[1][py][px][0], m1py = b.mv[1][py][px][1];
    const int m0qx = b.mv[0][qy][qx][0], m0qy = b.mv[0][qy][qx][1];
    const int m1qx = b.mv[1][qy][qx][0], m1qy = b.mv[1][qy][qx][1];
    if (np == 1) {
        const bool p0 = r0p >= 0, q0 = r0q >= 0;
        const int pp = p0 ? poc0p : poc1p, pq = q0 ? poc0q : poc1q;
        return pp != pq
               || dge4(p0 ? m0px : m1px, p0 ? m0py : m1py,
                       q0 ? m0qx : m1qx, q0 ? m0qy : m1qy);
    }
    if (!((poc0p == poc0q && poc1p == poc1q)
          || (poc0p == poc1q && poc1p == poc0q)))
        return 1;
    const bool direct_ok = !(dge4(m0px, m0py, m0qx, m0qy)
                             || dge4(m1px, m1py, m1qx, m1qy));
    const bool crossed_ok = !(dge4(m0px, m0py, m1qx, m1qy)
                              || dge4(m1px, m1py, m0qx, m0qy));
    if (poc0p == poc1p) return !(direct_ok || crossed_ok);
    return poc0p == poc0q ? !direct_ok : !crossed_ok;
}

// What a segment reads outside the window's blocks: its slice's and
// tile's rules and offsets, from the CTBs of its p and q sides.
struct SliceRules {
    bool crosses_off;   // filtering across this slice or tile edge is off
    bool disabled;
    int beta_off, tc_off, cb_off, cr_off;
};

__device__ SliceRules slice_rules(const Maps& m, const Dims& d, int f, int E,
                                  int A, bool horiz) {
    const size_t fc = (size_t)f * d.hc * d.wc;
    const int ca = A >> d.ctb_log2;
    const int cq = horiz ? (E >> d.ctb_log2) * d.wc + ca
                         : ca * d.wc + (E >> d.ctb_log2);
    const int cp = horiz ? ((E - 1) >> d.ctb_log2) * d.wc + ca
                         : ca * d.wc + ((E - 1) >> d.ctb_log2);
    const int slice_q = m.slice_idx[fc + cq], slice_p = m.slice_idx[fc + cp];
    const int tile_q = m.tile_id[fc + cq], tile_p = m.tile_id[fc + cp];
    const int sl = f * d.n_sl + clip3(0, d.n_sl - 1, slice_q);
    const bool across_tiles = m.across_tiles ? m.across_tiles[f] != 0
                                             : d.across_all != 0;
    SliceRules r;
    r.crosses_off = (slice_p != slice_q && !m.across[sl])
                    || (!across_tiles && tile_p != tile_q);
    r.disabled = m.disabled[sl];
    r.beta_off = m.beta_off[sl];
    r.tc_off = m.tc_off[sl];
    r.cb_off = m.cb_off[sl];
    r.cr_off = m.cr_off[sl];
    return r;
}

// Whether the segment between blocks p and q of the edge at E is
// filtered; if so its luma beta and tc, and the Cb and Cr tc (0 where the
// chroma filter does not run).
__device__ bool segment(const Blocks& b, const Dims& d, const SliceRules& r,
                        int E, int py, int px, int qy, int qx, int& beta,
                        int& tc, int (&tc_c)[2]) {
    const bool tu_edge = b.tu[py][px] != b.tu[qy][qx];
    const bool edge = tu_edge || b.pu[py][px] != b.pu[qy][qx]
                      || b.cu[py][px] != b.cu[qy][qx];
    if (!edge || r.disabled || r.crosses_off) return false;
    int bs;
    if (b.pred[py][px] == 1 || b.pred[qy][qx] == 1)
        bs = 2;
    else if (tu_edge && (b.cbf[py][px] > 0 || b.cbf[qy][qx] > 0))
        bs = 1;
    else
        bs = motion_bs(b, py, px, qy, qx);
    if (bs == 0) return false;

    const int qpl = (b.qp[py][px] + b.qp[qy][qx] + 1) >> 1;
    beta = kBeta[clip3(0, 51, qpl + r.beta_off)] << (d.bd_y - 8);
    tc = kTc[clip3(0, 53, qpl + 2 * (bs - 1) + r.tc_off)] << (d.bd_y - 8);
    tc_c[0] = tc_c[1] = 0;
    // chroma: every second luma edge, bS 2
    if (E % 16 || bs != 2) return true;
    const int qp_bd_off_c = 6 * (d.bd_c - 8);
    for (int c = 0; c < 2; ++c) {
        const int qpi = clip3(-qp_bd_off_c, 57,
                              qpl + (c ? r.cr_off : r.cb_off));
        const int qpc = qpi < 0 ? qpi : kChromaQp[clip3(0, 57, qpi)];
        tc_c[c] = max(kTc[clip3(0, 53, qpc + 2 + r.tc_off)] << (d.bd_c - 8),
                      0);
    }
    return true;
}

// The luma filter of one segment in shared memory: q0 is line 0's q0
// sample, `line` the step to the next line, `step` the step across the
// edge (p_k at q0 - (k + 1) step, q_k at q0 + k step).
__device__ void filter_luma(int16_t* q0, int line, int step, int beta,
                            int tc, int max_val) {
    int px[4][4], qx[4][4];   // [line][distance from the edge]
#pragma unroll
    for (int l = 0; l < 4; ++l) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            px[l][k] = q0[l * line - (k + 1) * step];
            qx[l][k] = q0[l * line + k * step];
        }
    }
    const int dp0 = abs(px[0][2] - 2 * px[0][1] + px[0][0]);
    const int dp3 = abs(px[3][2] - 2 * px[3][1] + px[3][0]);
    const int dq0 = abs(qx[0][2] - 2 * qx[0][1] + qx[0][0]);
    const int dq3 = abs(qx[3][2] - 2 * qx[3][1] + qx[3][0]);
    if (dp0 + dp3 + dq0 + dq3 >= beta) return;
    auto dsam = [&](int l, int dpq) {
        return 2 * dpq < (beta >> 2)
               && abs(px[l][3] - px[l][0]) + abs(qx[l][0] - qx[l][3])
                      < (beta >> 3)
               && abs(px[l][0] - qx[l][0]) < ((5 * tc + 1) >> 1);
    };
    const bool strong = dsam(0, dp0 + dq0) && dsam(3, dp3 + dq3);
    const int side = (beta + (beta >> 1)) >> 3;
    const bool d_ep = dp0 + dp3 < side, d_eq = dq0 + dq3 < side;
    const int t2 = 2 * tc, tch = tc >> 1;
#pragma unroll
    for (int l = 0; l < 4; ++l) {
        const int p0 = px[l][0], p1 = px[l][1], p2 = px[l][2], p3 = px[l][3];
        const int q0v = qx[l][0], q1 = qx[l][1], q2 = qx[l][2],
                  q3 = qx[l][3];
        int16_t* at = q0 + l * line;
        if (strong) {
            at[-step] = (int16_t)clip3(0, max_val, clip3(p0 - t2, p0 + t2,
                (p2 + 2 * p1 + 2 * p0 + 2 * q0v + q1 + 4) >> 3));
            at[-2 * step] = (int16_t)clip3(0, max_val, clip3(
                p1 - t2, p1 + t2, (p2 + p1 + p0 + q0v + 2) >> 2));
            at[-3 * step] = (int16_t)clip3(0, max_val, clip3(
                p2 - t2, p2 + t2, (2 * p3 + 3 * p2 + p1 + p0 + q0v + 4) >> 3));
            at[0] = (int16_t)clip3(0, max_val, clip3(q0v - t2, q0v + t2,
                (p1 + 2 * p0 + 2 * q0v + 2 * q1 + q2 + 4) >> 3));
            at[step] = (int16_t)clip3(0, max_val, clip3(
                q1 - t2, q1 + t2, (p0 + q0v + q1 + q2 + 2) >> 2));
            at[2 * step] = (int16_t)clip3(0, max_val, clip3(
                q2 - t2, q2 + t2, (p0 + q0v + q1 + 3 * q2 + 2 * q3 + 4) >> 3));
        } else {
            const int delta = (9 * (q0v - p0) - 3 * (q1 - p1) + 8) >> 4;
            if (abs(delta) < tc * 10) {
                const int dlt = clip3(-tc, tc, delta);
                at[-step] = (int16_t)clip3(0, max_val, p0 + dlt);
                at[0] = (int16_t)clip3(0, max_val, q0v - dlt);
                if (d_ep)
                    at[-2 * step] = (int16_t)clip3(0, max_val, p1 + clip3(
                        -tch, tch, (((p2 + p0 + 1) >> 1) - p1 + dlt) >> 1));
                if (d_eq)
                    at[step] = (int16_t)clip3(0, max_val, q1 + clip3(
                        -tch, tch, (((q2 + q0v + 1) >> 1) - q1 - dlt) >> 1));
            }
        }
    }
}

// The chroma filter of 2 lines in shared memory, laid out as filter_luma's.
__device__ void filter_chroma(int16_t* q0, int line, int step, int tc_c,
                              int max_c) {
#pragma unroll
    for (int l = 0; l < 2; ++l) {
        int16_t* at = q0 + l * line;
        const int p1 = at[-2 * step], p0 = at[-step];
        const int q0v = at[0], q1 = at[step];
        const int dl = clip3(-tc_c, tc_c, ((q0v - p0) * 4 + p1 - q1 + 4) >> 3);
        at[-step] = (int16_t)clip3(0, max_c, p0 + dl);
        at[0] = (int16_t)clip3(0, max_c, q0v - dl);
    }
}

// F pictures, one CTA a window (blockIdx.x, blockIdx.y) of picture
// blockIdx.z: the filtered window from `in` written to `out`.
__global__ void __launch_bounds__(kThreads)
deblock_kernel(const int16_t* __restrict__ y_in,
               const int16_t* __restrict__ cb_in,
               const int16_t* __restrict__ cr_in, int16_t* __restrict__ y_out,
               int16_t* __restrict__ cb_out, int16_t* __restrict__ cr_out,
               Maps m, Dims d) {
    __shared__ __align__(16) int16_t sy[kT][kT];
    __shared__ __align__(16) int16_t sc[2][kTw][kTw];
    __shared__ __align__(16) Blocks blk;
    const int tid = threadIdx.x, f = blockIdx.z;
    const int x0 = blockIdx.x * kT, y0 = blockIdx.y * kT;
    // the windows' origins: sy[r][c] is luma (yw + r, xw + c), sc[p][r][c]
    // chroma (ycw + r, xcw + c)
    const int xw = x0 - 4, yw = y0 - 4, xcw = x0 / 2 - 2, ycw = y0 / 2 - 2;
    const int wc2 = d.w / 2, hc2 = d.h / 2;
    const size_t fy = (size_t)f * d.h * d.w, fc = (size_t)f * hc2 * wc2;

    // 1. the windows in: the parts inside the picture, 4 luma samples (x a
    // multiple of 4) or 2 chroma samples (x even) a copy, all in flight at
    // once (cp.async)
    for (int i = tid; i < kT * (kT / 4); i += kThreads) {
        const int r = i / (kT / 4), c = (i % (kT / 4)) * 4;
        const int y = yw + r, x = xw + c;
        if (y >= 0 && y < d.h && x >= 0 && x < d.w)
            asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
                         :: "r"((uint32_t)__cvta_generic_to_shared(&sy[r][c])),
                            "l"(y_in + fy + (size_t)y * d.w + x)
                         : "memory");
    }
    for (int i = tid; i < 2 * kTw * (kTw / 2); i += kThreads) {
        const int p = i / (kTw * (kTw / 2)), j = i % (kTw * (kTw / 2));
        const int r = j / (kTw / 2), c = (j % (kTw / 2)) * 2;
        const int y = ycw + r, x = xcw + c;
        if (y >= 0 && y < hc2 && x >= 0 && x < wc2)
            asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                         :: "r"((uint32_t)__cvta_generic_to_shared(
                                &sc[p][r][c])),
                            "l"((p ? cr_in : cb_in) + fc + (size_t)y * wc2
                                + x)
                         : "memory");
    }

    // the window's 4x4 maps, a block a thread
    {
        const int r = tid / kB, c = tid % kB;
        const int gy = yw / 4 + r, gx = xw / 4 + c;
        if (gy >= 0 && gy < d.h4 && gx >= 0 && gx < d.w4) {
            const size_t plane4 = (size_t)d.h4 * d.w4;
            const size_t i = f * plane4 + (size_t)gy * d.w4 + gx;
            const size_t i1 = i + f * plane4, i2 = i1 + plane4;
            blk.tu[r][c] = m.tu_id[i];
            blk.pu[r][c] = m.pu_id[i];
            blk.cu[r][c] = m.cu_id[i];
            blk.pred[r][c] = m.pred_mode[i];
            blk.cbf[r][c] = m.cbf_y[i];
            blk.qp[r][c] = m.qp_y[i];
            blk.ri[0][r][c] = m.ref_idx[i1];
            blk.ri[1][r][c] = m.ref_idx[i2];
            blk.poc[0][r][c] = m.ref_poc[i1];
            blk.poc[1][r][c] = m.ref_poc[i2];
            *reinterpret_cast<uint32_t*>(blk.mv[0][r][c]) =
                reinterpret_cast<const uint32_t*>(m.mv)[i1];
            *reinterpret_cast<uint32_t*>(blk.mv[1][r][c]) =
                reinterpret_cast<const uint32_t*>(m.mv)[i2];
        }
    }

    // 2. this thread's segment: the vertical edges' segments for the first
    // kSegs threads (8 edges of 16 segments), the horizontal ones' after;
    // its slice rules read while the window and its maps arrive
    const bool horiz = tid >= kSegs;
    const int u = horiz ? tid - kSegs : tid;
    int E, A;
    bool valid;
    if (!horiz) {
        E = x0 + 8 * (u % (kT / 8));
        A = yw + 4 * (u / (kT / 8));
        valid = E >= 8 && E <= d.w - 8 && A >= 0 && A < d.h;
    } else {
        E = y0 + 8 * (u / (kT / 4));
        A = xw + 4 * (u % (kT / 4));
        valid = E >= 8 && E <= d.h - 8 && A >= 0 && A < d.w;
    }
    SliceRules rules{};
    if (valid) rules = slice_rules(m, d, f, E, A, horiz);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    // the p and q blocks in the window's grid
    const int ea = (E - (horiz ? yw : xw)) / 4, aa = (A - (horiz ? xw : yw)) / 4;
    const int py = horiz ? ea - 1 : aa, px = horiz ? aa : ea - 1;
    const int qy = horiz ? ea : aa, qx = horiz ? aa : ea;
    int beta = 0, tc = 0, tc_c[2] = {0, 0};
    const bool on = valid && segment(blk, d, rules, E, py, px, qy, qx, beta,
                                     tc, tc_c);
    const int max_y = (1 << d.bd_y) - 1, max_c = (1 << d.bd_c) - 1;

    // 3. the vertical edges, then the horizontal edges
    if (on && !horiz) {
        filter_luma(&sy[A - yw][E - xw], kT, 1, beta, tc, max_y);
        for (int c = 0; c < 2; ++c)
            if (tc_c[c])
                filter_chroma(&sc[c][A / 2 - ycw][E / 2 - xcw], kTw, 1,
                              tc_c[c], max_c);
    }
    __syncthreads();
    if (on && horiz) {
        filter_luma(&sy[E - yw][A - xw], 1, kT, beta, tc, max_y);
        for (int c = 0; c < 2; ++c)
            if (tc_c[c])
                filter_chroma(&sc[c][E / 2 - ycw][A / 2 - xcw], 1, kTw,
                              tc_c[c], max_c);
    }
    __syncthreads();

    // 4. the windows out, filtered or not
    for (int i = tid; i < kT * (kT / 4); i += kThreads) {
        const int r = i / (kT / 4), c = (i % (kT / 4)) * 4;
        const int y = yw + r, x = xw + c;
        if (y >= 0 && y < d.h && x >= 0 && x < d.w)
            *reinterpret_cast<uint2*>(y_out + fy + (size_t)y * d.w + x) =
                *reinterpret_cast<const uint2*>(&sy[r][c]);
    }
    for (int i = tid; i < 2 * kTw * (kTw / 2); i += kThreads) {
        const int p = i / (kTw * (kTw / 2)), j = i % (kTw * (kTw / 2));
        const int r = j / (kTw / 2), c = (j % (kTw / 2)) * 2;
        const int y = ycw + r, x = xcw + c;
        if (y >= 0 && y < hc2 && x >= 0 && x < wc2)
            *reinterpret_cast<uint32_t*>((p ? cr_out : cb_out) + fc
                                         + (size_t)y * wc2 + x) =
                *reinterpret_cast<const uint32_t*>(&sc[p][r][c]);
    }
}

}  // namespace

// y (F, h, w), cb and cr (F, h / 2, w / 2) int16, contiguous on the device,
// y 8-byte and cb, cr 4-byte aligned, filtered into y_out, cb_out and
// cr_out of the same shapes and alignment (every sample written); h and w
// multiples of 8. The maps as struct Maps says, contiguous; n_sl >= 1
// slices per picture. across_tiles: (F,) bool, or null for across_all.
// Launches once on `stream` and returns cudaGetLastError() (0 on
// success), or cudaErrorInvalidValue for a bit depth outside 8..16, bad
// sizes or misaligned planes; never synchronises.
extern "C" int deblock_launch(
    const void* y, const void* cb, const void* cr, void* y_out, void* cb_out,
    void* cr_out, int frames, int h, int w,
    const void* tu_id, const void* pu_id, const void* cu_id,
    const void* pred_mode, const void* cbf_y, const void* ref_idx,
    const void* ref_poc, const void* mv, const void* qp_y,
    const void* slice_idx, const void* tile_id, int hc, int wc,
    const void* disabled, const void* across, const void* beta_off,
    const void* tc_off, const void* cb_off, const void* cr_off, int n_sl,
    const void* across_tiles, int across_all, int ctb_log2, int bd_y,
    int bd_c, void* stream) {
    auto misaligned = [](const void* p, uintptr_t a) {
        return (reinterpret_cast<uintptr_t>(p) & (a - 1)) != 0;
    };
    if (bd_y < 8 || bd_y > 16 || bd_c < 8 || bd_c > 16 || h % 8 || w % 8
        || h < 8 || w < 8 || frames < 1 || frames > 65535 || n_sl < 1
        || hc < 1 || wc < 1 || ctb_log2 < 3 || ctb_log2 > 6
        || misaligned(y, 8) || misaligned(y_out, 8) || misaligned(cb, 4)
        || misaligned(cr, 4) || misaligned(cb_out, 4)
        || misaligned(cr_out, 4))
        return (int)cudaErrorInvalidValue;
    Maps m{(const int32_t*)tu_id, (const int32_t*)pu_id,
           (const int32_t*)cu_id, (const uint8_t*)pred_mode,
           (const uint8_t*)cbf_y, (const int8_t*)ref_idx,
           (const int32_t*)ref_poc, (const int16_t*)mv, (const int8_t*)qp_y,
           (const int32_t*)slice_idx, (const int32_t*)tile_id,
           (const uint8_t*)disabled, (const uint8_t*)across,
           (const int32_t*)beta_off, (const int32_t*)tc_off,
           (const int32_t*)cb_off, (const int32_t*)cr_off,
           (const uint8_t*)across_tiles};
    Dims d{h, w, h / 4, w / 4, hc, wc, n_sl, ctb_log2, bd_y, bd_c,
           across_all};
    // windows from x0 = 0 while x0 - 4 < w
    const dim3 grid((w + 4 + kT - 1) / kT, (h + 4 + kT - 1) / kT, frames);
    deblock_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const int16_t*)y, (const int16_t*)cb, (const int16_t*)cr,
        (int16_t*)y_out, (int16_t*)cb_out, (int16_t*)cr_out, m, d);
    return (int)cudaGetLastError();
}

// The kernel's resources on the current device: out[0] registers a
// thread, [1] local (spilled) bytes a thread, [2] shared bytes a CTA,
// [3] CTAs an SM, [4] threads a CTA, [5] CTAs a 1920x1080 picture
// launches. Returns a CUDA error code (0 on success).
extern "C" int deblock_occupancy(int* out) {
    cudaFuncAttributes a;
    cudaError_t e = cudaFuncGetAttributes(&a, deblock_kernel);
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &out[3], deblock_kernel, kThreads, 0);
    if (e != cudaSuccess) return (int)e;
    out[0] = a.numRegs;
    out[1] = (int)a.localSizeBytes;
    out[2] = (int)a.sharedSizeBytes;
    out[4] = kThreads;
    out[5] = ((1920 + 4 + kT - 1) / kT) * ((1080 + 4 + kT - 1) / kT);
    return 0;
}
