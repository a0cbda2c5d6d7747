// The decoder's deblocking filter, for Hopper (sm_90a).
//
// Replaces the XLA program turingcodec_tpu/ops/deblock.py deblock_device
// (:272-288, _dir_pass :81): bS from the 4x4 maps, the luma dE decisions
// with the strong and weak filters, and the chroma filter on every second
// luma edge where bS is 2, bit-exact for any int16 samples and bit depth
// 8..16. One launch per direction for F pictures: the vertical edges, then
// the horizontal edges on the vertical pass's output (stream order). The
// XLA program gets the horizontal pass by transposing planes and maps; this
// kernel indexes rows and columns directly.
//
// One thread per 4-line edge segment: the segment at A (4 lines from A,
// along the edge) of the edge at E = 8 (e + 1) (across it), for
// e < side / 8 - 1, so no edge lies at 0 or at the picture's side. Vertical
// edges have x = E, y = A; horizontal ones y = E, x = A. The thread derives
// the edge flag and bS of its segment from the maps (tu/pu/cu ids; the
// per-slice disabled flag at the q side's slice index clamped to
// [0, n_slices - 1]; the across-slices and across-tiles rules), then
// filters the luma window E-4 .. E+3 of its 4 lines and, where e is odd,
// the chroma window E/2-2 .. E/2+1 of 2 chroma lines in Cb and Cr. Within
// one direction the windows of all segments are disjoint (edges are 8
// luma samples apart, a luma window writes E-3 .. E+2 and a chroma window
// E/2-1 .. E/2), so filtering in place is safe; no read or write leaves the
// plane (the XLA program pads the last chroma window past the plane's edge
// by replication but writes only p0 and q0, which lie inside). Every
// intermediate value is int32. The beta, tc and 4:2:0 chroma QP tables are
// compiled in as immediates from decode/deblock.py and hevc/tables.py by
// ops/kernel_build.py.
//
// What bounds it. At 1080p each pass reads the luma and chroma planes
// (6.2 MB of int16) and, per segment, its two 4x4 blocks of maps (4 MB
// per picture in all) and writes the windows it filters: bytes bound it,
// about 10 us for both passes. The design is the simple one: a thread's
// luma line is two 8-byte loads (vertical edges) or its 4 lines one
// 8-byte load per row (horizontal edges); a warp covers 32 neighbouring
// segments of one line band, so its loads are contiguous.
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#if !defined(TC_BETA_TABLE) || !defined(TC_TC_TABLE) || !defined(TC_CHROMA_QP_TABLE)
#error "deblock tables undefined: build with ops/kernel_build.py, which pre-includes them from decode/deblock.py and hevc/tables.py"
#endif

namespace {

constexpr int kThreads = 128;

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

// the motion bS of blocks p and q (ops/deblock.py _motion_bs): indices
// into one picture's (h4, w4) grid
__device__ int motion_bs(const Maps& m, size_t f4, size_t plane4, int ip,
                         int iq) {
    const int8_t* ri = m.ref_idx + 2 * f4;
    const int32_t* rp = m.ref_poc + 2 * f4;
    const int16_t* mv = m.mv + 4 * f4;
    const int r0p = ri[ip], r1p = ri[plane4 + ip];
    const int r0q = ri[iq], r1q = ri[plane4 + iq];
    const int np = (r0p >= 0) + (r1p >= 0), nq = (r0q >= 0) + (r1q >= 0);
    if (np != nq) return 1;
    if (np == 0) return 0;
    const int poc0p = rp[ip], poc1p = rp[plane4 + ip];
    const int poc0q = rp[iq], poc1q = rp[plane4 + iq];
    const int m0px = mv[2 * ip], m0py = mv[2 * ip + 1];
    const int m1px = mv[2 * (plane4 + ip)], m1py = mv[2 * (plane4 + ip) + 1];
    const int m0qx = mv[2 * iq], m0qy = mv[2 * iq + 1];
    const int m1qx = mv[2 * (plane4 + iq)], m1qy = mv[2 * (plane4 + iq) + 1];
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

// 4 int16 samples at p (8-byte aligned) as int32, and back
__device__ inline void load4(const int16_t* p, int (&v)[4]) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    v[0] = (int16_t)(u.x & 0xffff); v[1] = (int16_t)(u.x >> 16);
    v[2] = (int16_t)(u.y & 0xffff); v[3] = (int16_t)(u.y >> 16);
}

__device__ inline void store4(int16_t* p, const int (&v)[4]) {
    uint2 u;
    u.x = (uint32_t)(uint16_t)v[0] | ((uint32_t)(uint16_t)v[1] << 16);
    u.y = (uint32_t)(uint16_t)v[2] | ((uint32_t)(uint16_t)v[3] << 16);
    *reinterpret_cast<uint2*>(p) = u;
}

// one direction over F pictures: vertical (horiz = 0) or horizontal edges
__global__ void __launch_bounds__(kThreads)
deblock_kernel(int16_t* __restrict__ y_planes, int16_t* __restrict__ cb_planes,
               int16_t* __restrict__ cr_planes, Maps m, Dims d, int horiz) {
    const int along = horiz ? d.w : d.h;       // the segments' axis
    const int across = horiz ? d.h : d.w;      // the edges' axis
    const int n_e = across / 8 - 1, n_s = along / 4;
    const int t = blockIdx.x * kThreads + threadIdx.x;
    if (t >= n_e * n_s) return;
    // neighbouring threads take neighbouring segments in memory: along
    // the row of a horizontal edge, down the edges of a row band otherwise
    const int s = horiz ? t % n_s : t / n_e;
    const int e = horiz ? t / n_s : t % n_e;
    const int E = 8 * (e + 1), A = 4 * s;
    const int f = blockIdx.y;

    const size_t plane4 = (size_t)d.h4 * d.w4;
    const size_t f4 = f * plane4;
    const size_t fc = (size_t)f * d.hc * d.wc;
    // the p and q 4x4 blocks, and the CTBs of the q and p sides
    const int ip = horiz ? ((E - 1) >> 2) * d.w4 + (A >> 2)
                         : (A >> 2) * d.w4 + ((E - 1) >> 2);
    const int iq = horiz ? (E >> 2) * d.w4 + (A >> 2)
                         : (A >> 2) * d.w4 + (E >> 2);
    const int ca = A >> d.ctb_log2;
    const int cq = horiz ? (E >> d.ctb_log2) * d.wc + ca
                         : ca * d.wc + (E >> d.ctb_log2);
    const int cp = horiz ? ((E - 1) >> d.ctb_log2) * d.wc + ca
                         : ca * d.wc + ((E - 1) >> d.ctb_log2);

    const bool tu_edge = m.tu_id[f4 + ip] != m.tu_id[f4 + iq];
    bool edge = tu_edge || m.pu_id[f4 + ip] != m.pu_id[f4 + iq]
                || m.cu_id[f4 + ip] != m.cu_id[f4 + iq];
    if (!edge) return;
    const int slice_q = m.slice_idx[fc + cq];
    const int sl = f * d.n_sl + clip3(0, d.n_sl - 1, slice_q);
    if (m.disabled[sl]) return;
    if (m.slice_idx[fc + cp] != slice_q && !m.across[sl]) return;
    const bool across_tiles = m.across_tiles ? m.across_tiles[f] != 0
                                             : d.across_all != 0;
    if (!across_tiles && m.tile_id[fc + cp] != m.tile_id[fc + cq]) return;

    int bs;
    if (m.pred_mode[f4 + ip] == 1 || m.pred_mode[f4 + iq] == 1)
        bs = 2;
    else if (tu_edge && (m.cbf_y[f4 + ip] > 0 || m.cbf_y[f4 + iq] > 0))
        bs = 1;
    else
        bs = motion_bs(m, f4, plane4, ip, iq);
    if (bs == 0) return;

    const int qp_p = m.qp_y[f4 + ip], qp_q = m.qp_y[f4 + iq];
    const int tc_off = m.tc_off[sl];

    // ---- luma: 4 lines of p3 p2 p1 p0 | q0 q1 q2 q3 ----------------------
    {
        const int max_val = (1 << d.bd_y) - 1;
        const int qpl = (qp_p + qp_q + 1) >> 1;
        const int beta = kBeta[clip3(0, 51, qpl + m.beta_off[sl])]
                         << (d.bd_y - 8);
        const int tc = kTc[clip3(0, 53, qpl + 2 * (bs - 1) + tc_off)]
                       << (d.bd_y - 8);
        int16_t* plane = y_planes + (size_t)f * d.h * d.w;
        int px[4][4], qx[4][4];   // [line][distance from the edge]
        if (horiz) {
            // row E - 1 - k holds p_k, row E + k holds q_k, of 4 columns
            for (int k = 0; k < 4; ++k) {
                int a[4], b[4];
                load4(plane + (size_t)(E - 1 - k) * d.w + A, a);
                load4(plane + (size_t)(E + k) * d.w + A, b);
                for (int l = 0; l < 4; ++l) { px[l][k] = a[l]; qx[l][k] = b[l]; }
            }
        } else {
            for (int l = 0; l < 4; ++l) {
                int a[4], b[4];
                const int16_t* row = plane + (size_t)(A + l) * d.w + E;
                load4(row - 4, a);
                load4(row, b);
                for (int k = 0; k < 4; ++k) { px[l][k] = a[3 - k]; qx[l][k] = b[k]; }
            }
        }
        const int dp0 = abs(px[0][2] - 2 * px[0][1] + px[0][0]);
        const int dp3 = abs(px[3][2] - 2 * px[3][1] + px[3][0]);
        const int dq0 = abs(qx[0][2] - 2 * qx[0][1] + qx[0][0]);
        const int dq3 = abs(qx[3][2] - 2 * qx[3][1] + qx[3][0]);
        if (dp0 + dp3 + dq0 + dq3 < beta) {
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
            for (int l = 0; l < 4; ++l) {
                const int p0 = px[l][0], p1 = px[l][1], p2 = px[l][2],
                          p3 = px[l][3];
                const int q0 = qx[l][0], q1 = qx[l][1], q2 = qx[l][2],
                          q3 = qx[l][3];
                if (strong) {
                    px[l][0] = clip3(0, max_val, clip3(p0 - t2, p0 + t2,
                        (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3));
                    px[l][1] = clip3(0, max_val, clip3(p1 - t2, p1 + t2,
                        (p2 + p1 + p0 + q0 + 2) >> 2));
                    px[l][2] = clip3(0, max_val, clip3(p2 - t2, p2 + t2,
                        (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3));
                    qx[l][0] = clip3(0, max_val, clip3(q0 - t2, q0 + t2,
                        (p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3));
                    qx[l][1] = clip3(0, max_val, clip3(q1 - t2, q1 + t2,
                        (p0 + q0 + q1 + q2 + 2) >> 2));
                    qx[l][2] = clip3(0, max_val, clip3(q2 - t2, q2 + t2,
                        (p0 + q0 + q1 + 3 * q2 + 2 * q3 + 4) >> 3));
                } else {
                    const int delta = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4;
                    if (abs(delta) < tc * 10) {
                        const int dlt = clip3(-tc, tc, delta);
                        px[l][0] = clip3(0, max_val, p0 + dlt);
                        qx[l][0] = clip3(0, max_val, q0 - dlt);
                        if (d_ep)
                            px[l][1] = clip3(0, max_val, p1 + clip3(-tch, tch,
                                (((p2 + p0 + 1) >> 1) - p1 + dlt) >> 1));
                        if (d_eq)
                            qx[l][1] = clip3(0, max_val, q1 + clip3(-tch, tch,
                                (((q2 + q0 + 1) >> 1) - q1 - dlt) >> 1));
                    }
                }
            }
            if (horiz) {
                for (int k = 0; k < 3; ++k) {
                    int a[4], b[4];
                    for (int l = 0; l < 4; ++l) { a[l] = px[l][k]; b[l] = qx[l][k]; }
                    store4(plane + (size_t)(E - 1 - k) * d.w + A, a);
                    store4(plane + (size_t)(E + k) * d.w + A, b);
                }
            } else {
                for (int l = 0; l < 4; ++l) {
                    int16_t* row = plane + (size_t)(A + l) * d.w + E;
                    const int a[4] = {px[l][3], px[l][2], px[l][1], px[l][0]};
                    store4(row - 4, a);
                    store4(row, qx[l]);
                }
            }
        }
    }

    // ---- chroma: every second luma edge, bS 2, lines A/2 and A/2 + 1 ----
    if (!(e & 1) || bs != 2) return;
    const int max_c = (1 << d.bd_c) - 1;
    const int qp_bd_off_c = 6 * (d.bd_c - 8);
    const int wc2 = d.w / 2;
    const int Ec = E / 2, Ac = A / 2;
    const size_t fplane = (size_t)f * (d.h / 2) * wc2;
    for (int c = 0; c < 2; ++c) {
        const int off = c ? m.cr_off[sl] : m.cb_off[sl];
        const int qpi = clip3(-qp_bd_off_c, 57, ((qp_p + qp_q + 1) >> 1) + off);
        const int qpc = qpi < 0 ? qpi : kChromaQp[clip3(0, 57, qpi)];
        const int tc_c = kTc[clip3(0, 53, qpc + 2 + tc_off)] << (d.bd_c - 8);
        if (tc_c <= 0) continue;
        int16_t* plane = (c ? cr_planes : cb_planes) + fplane;
        for (int l = 0; l < 2; ++l) {
            // p1 p0 | q0 q1 of line l, and the stride between them
            int16_t* q0p;
            size_t step;
            if (horiz) {
                q0p = plane + (size_t)Ec * wc2 + Ac + l;
                step = wc2;
            } else {
                q0p = plane + (size_t)(Ac + l) * wc2 + Ec;
                step = 1;
            }
            const int p1 = q0p[-2 * (ptrdiff_t)step], p0 = q0p[-(ptrdiff_t)step];
            const int q0 = q0p[0], q1 = q0p[step];
            const int dl = clip3(-tc_c, tc_c,
                                 ((q0 - p0) * 4 + p1 - q1 + 4) >> 3);
            q0p[-(ptrdiff_t)step] = (int16_t)clip3(0, max_c, p0 + dl);
            q0p[0] = (int16_t)clip3(0, max_c, q0 - dl);
        }
    }
}

}  // namespace

// y (F, h, w), cb and cr (F, h / 2, w / 2) int16, contiguous on the device,
// filtered in place; h and w multiples of 8. The maps as struct Maps says,
// contiguous; n_sl >= 1 slices per picture. across_tiles: (F,) bool, or
// null for across_all. Launches the vertical pass (horizontal = 0) or the
// horizontal pass on `stream` and returns cudaGetLastError() (0 on
// success; nothing launches where the pictures have no edge), or
// cudaErrorInvalidValue for a bit depth outside 8..16 or bad sizes; never
// synchronises.
extern "C" int deblock_launch(
    void* y, void* cb, void* cr, int frames, int h, int w,
    const void* tu_id, const void* pu_id, const void* cu_id,
    const void* pred_mode, const void* cbf_y, const void* ref_idx,
    const void* ref_poc, const void* mv, const void* qp_y,
    const void* slice_idx, const void* tile_id, int hc, int wc,
    const void* disabled, const void* across, const void* beta_off,
    const void* tc_off, const void* cb_off, const void* cr_off, int n_sl,
    const void* across_tiles, int across_all, int ctb_log2, int bd_y,
    int bd_c, int horizontal, void* stream) {
    if (bd_y < 8 || bd_y > 16 || bd_c < 8 || bd_c > 16 || h % 8 || w % 8
        || h < 8 || w < 8 || frames < 1 || n_sl < 1 || hc < 1 || wc < 1
        || ctb_log2 < 3 || ctb_log2 > 6)
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
    const int along = horizontal ? w : h, across_side = horizontal ? h : w;
    const int work = (across_side / 8 - 1) * (along / 4);
    if (work <= 0) return (int)cudaGetLastError();
    const dim3 grid((work + kThreads - 1) / kThreads, frames);
    deblock_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (int16_t*)y, (int16_t*)cb, (int16_t*)cr, m, d, horizontal);
    return (int)cudaGetLastError();
}
