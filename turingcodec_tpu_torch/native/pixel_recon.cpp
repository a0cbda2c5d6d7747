// Native inter reconstruction: motion compensation (8-tap luma / 4-tap
// chroma fractional interpolation, uni + bi with exact spec rounding) and
// inter residual add (dequant + two-stage IDCT / transform-skip) for every
// inter CU of a picture.
//
// C++ twin of decode/recon_vec.py (which stays as the numpy oracle; parity
// asserted by the stream-corpus md5 suite). Reference analogue:
// havoc/pred_inter.cpp interpolation + turing inverse-transform-add path.
//
// Spec: 8.5.3.3.3 (fractional interpolation), 8.5.3.3.4 (weighted sample
// prediction, default mode only — explicit WP stays on the Python path),
// 8.6.3 (scaling), 8.6.4 (transformation).
#include <cstdint>
#include <cstring>
#include <ctime>

#include "core.h"

namespace {

struct RC {
    int16_t *ry, *rcb, *rcr;
    const int16_t *coeff_y, *coeff_cb, *coeff_cr;
    const uint8_t *ts_y, *ts_cb, *ts_cr;
    const int8_t* qp_y;
    const int16_t* mv;       // (2, h4, w4, 2)
    const int8_t* ref_idx;   // (2, h4, w4)
    const int32_t* slice_idx;
    const int16_t* refs[2][16][3];
    int pic_w, pic_h, w4, h4, wc, hc, ctb_log2;
    int bd_y, bd_c, qp_bd_y, qp_bd_c;
    int32_t lf[4][8];   // luma filter per 1/4 phase
    int32_t cf[8][4];   // chroma filter per 1/8 phase
    const int32_t* mats[6];  // [log2] -> DCT matrix (2..5 used)
    int32_t mat_store[16 + 64 + 256 + 1024];
    int32_t level_scale[6];
    const int32_t* cqt;      // qPi + qp_bd_c -> QpC
    int cqt_len;
    const int32_t* cb_off;   // per slice
    const int32_t* cr_off;
    int n_sl;
};

RC rc;

inline int iclip(int lo, int hi, int v) {
    return v < lo ? lo : (v > hi ? hi : v);
}

// Fractional-sample interpolation for one PU and one reference plane.
// Writes (h, w) 14-bit intermediate predictions into out.
// xi/yi: integer position (already offset by mv integer part), xf/yf:
// fractional phase, taps: 8 (luma, filt=rc.lf[xf]) or 4 (chroma).
}  // namespace

// Fractional-sample MC interpolation (shared with the encoder core).
// Templated on the tap count so the inner MAC loops have constant bounds
// (gcc unrolls + vectorizes them).
template <int taps>
static void mc_interp_t(const int16_t* ref, int rw, int rh, int xi, int yi,
                        int xf, int yf, int w, int h, int bd,
                        const int32_t (*filt)[8], int filt_stride,
                        int32_t* out) {
    const int shift1 = bd - 8;
    const int shift3 = 14 - bd;
    const int off = taps / 2 - 1;
    const int32_t* fh = (const int32_t*)filt + (int64_t)xf * filt_stride;
    const int32_t* fv = (const int32_t*)filt + (int64_t)yf * filt_stride;

    if (xf == 0 && yf == 0) {
        for (int y = 0; y < h; y++) {
            int yc = iclip(0, rh - 1, yi + y);
            const int16_t* row = ref + (int64_t)yc * rw;
            for (int x = 0; x < w; x++)
                out[y * w + x] = (int32_t)row[iclip(0, rw - 1, xi + x)]
                                 << shift3;
        }
        return;
    }
    // interior test: every tap read stays in bounds -> clamp-free loops
    const bool in_x = xi - off >= 0 && xi + w - 1 - off + taps - 1 < rw;
    const bool in_y = yi - off >= 0 && yi + h - 1 - off + taps - 1 < rh;
    if (yf == 0) {  // horizontal only
        if (in_x && yi >= 0 && yi + h <= rh) {
            for (int y = 0; y < h; y++) {
                const int16_t* row = ref + (int64_t)(yi + y) * rw + xi - off;
                for (int x = 0; x < w; x++) {
                    int acc = 0;
                    for (int k = 0; k < taps; k++)
                        acc += fh[k] * row[x + k];
                    out[y * w + x] = acc >> shift1;
                }
            }
            return;
        }
        for (int y = 0; y < h; y++) {
            int yc = iclip(0, rh - 1, yi + y);
            const int16_t* row = ref + (int64_t)yc * rw;
            for (int x = 0; x < w; x++) {
                int acc = 0;
                for (int k = 0; k < taps; k++)
                    acc += fh[k] * row[iclip(0, rw - 1, xi + x - off + k)];
                out[y * w + x] = acc >> shift1;
            }
        }
        return;
    }
    if (xf == 0) {  // vertical only
        if (in_y && xi >= 0 && xi + w <= rw) {
            for (int y = 0; y < h; y++) {
                const int16_t* col0 = ref + (int64_t)(yi + y - off) * rw + xi;
                for (int x = 0; x < w; x++) {
                    int acc = 0;
                    for (int k = 0; k < taps; k++)
                        acc += fv[k] * col0[(int64_t)k * rw + x];
                    out[y * w + x] = acc >> shift1;
                }
            }
            return;
        }
        for (int y = 0; y < h; y++) {
            for (int x = 0; x < w; x++) {
                int xc = iclip(0, rw - 1, xi + x);
                int acc = 0;
                for (int k = 0; k < taps; k++)
                    acc += fv[k]
                         * ref[(int64_t)iclip(0, rh - 1, yi + y - off + k)
                               * rw + xc];
                out[y * w + x] = acc >> shift1;
            }
        }
        return;
    }
    // full 2D: horizontal into tmp rows, then vertical
    static thread_local int32_t tmp[(64 + 8) * 64];
    if (in_x && in_y) {
        for (int y = 0; y < h + taps - 1; y++) {
            const int16_t* row =
                ref + (int64_t)(yi + y - off) * rw + xi - off;
            for (int x = 0; x < w; x++) {
                int acc = 0;
                for (int k = 0; k < taps; k++)
                    acc += fh[k] * row[x + k];
                tmp[y * w + x] = acc >> shift1;
            }
        }
    } else {
        for (int y = 0; y < h + taps - 1; y++) {
            int yc = iclip(0, rh - 1, yi + y - off);
            const int16_t* row = ref + (int64_t)yc * rw;
            for (int x = 0; x < w; x++) {
                int acc = 0;
                for (int k = 0; k < taps; k++)
                    acc += fh[k] * row[iclip(0, rw - 1, xi + x - off + k)];
                tmp[y * w + x] = acc >> shift1;
            }
        }
    }
    for (int y = 0; y < h; y++)
        for (int x = 0; x < w; x++) {
            int acc = 0;
            for (int k = 0; k < taps; k++)
                acc += fv[k] * tmp[(y + k) * w + x];
            out[y * w + x] = acc >> 6;
        }
}

void mc_interp(const int16_t* ref, int rw, int rh, int xi, int yi, int xf,
               int yf, int w, int h, int bd, int taps,
               const int32_t (*filt)[8], int filt_stride, int32_t* out) {
    if (taps == 8)
        mc_interp_t<8>(ref, rw, rh, xi, yi, xf, yf, w, h, bd, filt,
                       filt_stride, out);
    else
        mc_interp_t<4>(ref, rw, rh, xi, yi, xf, yf, w, h, bd, filt,
                       filt_stride, out);
}

namespace {

// Combine uni/bi 14-bit predictions into a strided int16 plane region.
void combine(const int32_t* p0, const int32_t* p1, int w, int h, int bd,
             int16_t* dst, int dstride) {
    int max_v = (1 << bd) - 1;
    if (p0 && p1) {
        int shift = 15 - bd, rnd = 1 << (14 - bd);
        for (int y = 0; y < h; y++)
            for (int x = 0; x < w; x++)
                dst[(int64_t)y * dstride + x] = (int16_t)iclip(
                    0, max_v, (p0[y * w + x] + p1[y * w + x] + rnd) >> shift);
    } else {
        const int32_t* p = p0 ? p0 : p1;
        int shift = 14 - bd, rnd = 1 << (13 - bd);
        for (int y = 0; y < h; y++)
            for (int x = 0; x < w; x++)
                dst[(int64_t)y * dstride + x] = (int16_t)iclip(
                    0, max_v, (p[y * w + x] + rnd) >> shift);
    }
}

// Residual add for one TB (dequant + IDCT / transform-skip / bypass).
void residual_add(const int16_t* coeff, int cstride, int x0, int y0, int n,
                  int log2, int qp, int bd, int tskip, int bypass,
                  int16_t* plane, int pstride) {
    static thread_local int32_t d[32 * 32];
    static thread_local int32_t gg[32 * 32];
    int max_v = (1 << bd) - 1;
    const int16_t* c0 = coeff + (int64_t)y0 * cstride + x0;
    if (bypass) {
        for (int y = 0; y < n; y++)
            for (int x = 0; x < n; x++) {
                int64_t i = (int64_t)(y0 + y) * pstride + (x0 + x);
                plane[i] = (int16_t)iclip(0, max_v,
                                          plane[i] + c0[(int64_t)y * cstride
                                                        + x]);
            }
        return;
    }
    int bd_shift = bd + log2 - 5;
    int64_t ls = ((int64_t)rc.level_scale[qp % 6] << (qp / 6)) * 16;
    int64_t rnd = 1LL << (bd_shift - 1);
    for (int y = 0; y < n; y++)
        for (int x = 0; x < n; x++)
            d[y * n + x] = iclip(-32768, 32767,
                                 (int)((c0[(int64_t)y * cstride + x] * ls
                                        + rnd) >> bd_shift));
    int sh2 = 20 - bd;
    int rnd2 = 1 << (sh2 - 1);
    if (tskip) {
        for (int y = 0; y < n; y++)
            for (int x = 0; x < n; x++) {
                int r = iclip(-32768, 32767,
                              ((d[y * n + x] << 7) + rnd2) >> sh2);
                int64_t i = (int64_t)(y0 + y) * pstride + (x0 + x);
                plane[i] = (int16_t)iclip(0, max_v, plane[i] + r);
            }
        return;
    }
    const int32_t* m = rc.mats[log2];
    // Two-stage IDCT with the cosine even/odd fold (m[k][n-1-j] ==
    // +/- m[k][j]): half-length sums, int32 accumulators (|acc| <=
    // 16*90*32767 per half < 2^26), contiguous inner dims. Exact integer
    // regrouping — bit-identical to the plain product.
    const int hn = n >> 1;
    static thread_local int32_t accE[32], accO[32];
    // stage 1: gg[y][x] = clip((sum_k m[k][y] d[k][x] + 64) >> 7)
    for (int y = 0; y < hn; y++) {
        for (int x = 0; x < n; x++) {
            accE[x] = 0;
            accO[x] = 0;
        }
        for (int k = 0; k < n; k += 2) {
            const int32_t ce = m[k * n + y];
            const int32_t co = m[(k + 1) * n + y];
            const int32_t* de = d + k * n;
            const int32_t* dd = d + (k + 1) * n;
            for (int x = 0; x < n; x++) {
                accE[x] += ce * de[x];
                accO[x] += co * dd[x];
            }
        }
        int32_t* gy = gg + y * n;
        int32_t* gm = gg + (n - 1 - y) * n;
        for (int x = 0; x < n; x++) {
            gy[x] = iclip(-32768, 32767, (accE[x] + accO[x] + 64) >> 7);
            gm[x] = iclip(-32768, 32767, (accE[x] - accO[x] + 64) >> 7);
        }
    }
    // stage 2 (folded over x), fused with the strided plane add+clip
    for (int y = 0; y < n; y++) {
        const int32_t* gy = gg + y * n;
        for (int x = 0; x < hn; x++) {
            accE[x] = 0;
            accO[x] = 0;
        }
        for (int k = 0; k < n; k += 2) {
            const int32_t ge = gy[k];
            const int32_t go = gy[k + 1];
            const int32_t* me = m + k * n;
            const int32_t* mo = m + (k + 1) * n;
            for (int x = 0; x < hn; x++) {
                accE[x] += ge * me[x];
                accO[x] += go * mo[x];
            }
        }
        int16_t* prow = plane + (int64_t)(y0 + y) * pstride + x0;
        for (int x = 0; x < hn; x++) {
            int r1 = iclip(-32768, 32767, (accE[x] + accO[x] + rnd2) >> sh2);
            int r2 = iclip(-32768, 32767, (accE[x] - accO[x] + rnd2) >> sh2);
            prow[x] = (int16_t)iclip(0, max_v, prow[x] + r1);
            prow[n - 1 - x] =
                (int16_t)iclip(0, max_v, prow[n - 1 - x] + r2);
        }
    }
}

// PU geometry per part mode (spec 6.4.1 partition table)
int pu_geometry(int x0, int y0, int log2, int part_mode, int geo[4][4]) {
    int s = 1 << log2, h = s >> 1, q = s >> 2;
    switch (part_mode) {
    case 0:
        geo[0][0] = x0; geo[0][1] = y0; geo[0][2] = s; geo[0][3] = s;
        return 1;
    case 1:
        geo[0][0] = x0; geo[0][1] = y0; geo[0][2] = s; geo[0][3] = h;
        geo[1][0] = x0; geo[1][1] = y0 + h; geo[1][2] = s; geo[1][3] = h;
        return 2;
    case 2:
        geo[0][0] = x0; geo[0][1] = y0; geo[0][2] = h; geo[0][3] = s;
        geo[1][0] = x0 + h; geo[1][1] = y0; geo[1][2] = h; geo[1][3] = s;
        return 2;
    case 3:
        geo[0][0] = x0; geo[0][1] = y0; geo[0][2] = h; geo[0][3] = h;
        geo[1][0] = x0 + h; geo[1][1] = y0; geo[1][2] = h; geo[1][3] = h;
        geo[2][0] = x0; geo[2][1] = y0 + h; geo[2][2] = h; geo[2][3] = h;
        geo[3][0] = x0 + h; geo[3][1] = y0 + h; geo[3][2] = h; geo[3][3] = h;
        return 4;
    case 4:
        geo[0][0] = x0; geo[0][1] = y0; geo[0][2] = s; geo[0][3] = q;
        geo[1][0] = x0; geo[1][1] = y0 + q; geo[1][2] = s; geo[1][3] = s - q;
        return 2;
    case 5:
        geo[0][0] = x0; geo[0][1] = y0; geo[0][2] = s; geo[0][3] = s - q;
        geo[1][0] = x0; geo[1][1] = y0 + s - q; geo[1][2] = s; geo[1][3] = q;
        return 2;
    case 6:
        geo[0][0] = x0; geo[0][1] = y0; geo[0][2] = q; geo[0][3] = s;
        geo[1][0] = x0 + q; geo[1][1] = y0; geo[1][2] = s - q; geo[1][3] = s;
        return 2;
    default:
        geo[0][0] = x0; geo[0][1] = y0; geo[0][2] = s - q; geo[0][3] = s;
        geo[1][0] = x0 + s - q; geo[1][1] = y0; geo[1][2] = q; geo[1][3] = s;
        return 2;
    }
}

// ---- deblocking filter (spec 8.7.2; decode/deblock.py oracle) --------------

struct DB {
    int16_t *ry, *rcb, *rcr;
    const int32_t *tu_id, *pu_id, *cu_id;
    const uint8_t *cu_pred_mode, *cbf_y;
    const int8_t* ref_idx;
    const int32_t* ref_poc;
    const int16_t* mv;
    const int8_t* qp_y;
    const int32_t *slice_idx, *tile_id;
    int pic_w, pic_h, w4, h4, wc, hc, ctb_log2, bd_y, bd_c, qp_bd_c;
    const int32_t *beta_tab, *tc_tab, *cqt;
    const int32_t *sl_disabled, *sl_beta, *sl_tc, *sl_across, *cb_off,
        *cr_off;
    int across_tiles;
    int n_sl;
};

// thread_local: the encoder's frame-parallel workers and the overlap
// filter follower deblock different pictures concurrently
thread_local DB db;

// bS from motion difference (spec 8.7.2.4 cond 3; deblock._motion_bs)
int motion_bs(int64_t bp, int64_t bq) {
    const int64_t plane4 = (int64_t)db.h4 * db.w4;
    int rp0 = db.ref_idx[bp], rp1 = db.ref_idx[plane4 + bp];
    int rq0 = db.ref_idx[bq], rq1 = db.ref_idx[plane4 + bq];
    int np_cnt = (rp0 >= 0) + (rp1 >= 0);
    int nq_cnt = (rq0 >= 0) + (rq1 >= 0);
    if (np_cnt != nq_cnt)
        return 1;
    if (np_cnt == 0)
        return 0;
    int pocp[2] = {db.ref_poc[bp], db.ref_poc[plane4 + bp]};
    int pocq[2] = {db.ref_poc[bq], db.ref_poc[plane4 + bq]};
    int mvpx[2] = {db.mv[bp * 2], db.mv[(plane4 + bp) * 2]};
    int mvpy[2] = {db.mv[bp * 2 + 1], db.mv[(plane4 + bp) * 2 + 1]};
    int mvqx[2] = {db.mv[bq * 2], db.mv[(plane4 + bq) * 2]};
    int mvqy[2] = {db.mv[bq * 2 + 1], db.mv[(plane4 + bq) * 2 + 1]};
    auto ge4 = [&](int lp, int lq) {
        int dx = mvpx[lp] - mvqx[lq], dy = mvpy[lp] - mvqy[lq];
        return (dx < 0 ? -dx : dx) >= 4 || (dy < 0 ? -dy : dy) >= 4;
    };
    if (np_cnt == 1) {
        int lp = rp0 >= 0 ? 0 : 1;
        int lq = rq0 >= 0 ? 0 : 1;
        if (pocp[lp] != pocq[lq])
            return 1;
        return ge4(lp, lq) ? 1 : 0;
    }
    // both bi-predicted
    int sp0 = pocp[0] < pocp[1] ? pocp[0] : pocp[1];
    int sp1 = pocp[0] < pocp[1] ? pocp[1] : pocp[0];
    int sq0 = pocq[0] < pocq[1] ? pocq[0] : pocq[1];
    int sq1 = pocq[0] < pocq[1] ? pocq[1] : pocq[0];
    if (sp0 != sq0 || sp1 != sq1)
        return 1;
    if (pocp[0] == pocp[1]) {
        bool direct = !(ge4(0, 0) || ge4(1, 1));
        bool crossed = !(ge4(0, 1) || ge4(1, 0));
        return (direct || crossed) ? 0 : 1;
    }
    if (pocp[0] == pocq[0])
        return (ge4(0, 0) || ge4(1, 1)) ? 1 : 0;
    return (ge4(0, 1) || ge4(1, 0)) ? 1 : 0;
}

// one 4-line luma edge segment (spec 8.7.2.5.3/4/7)
void filter_luma_seg(int16_t* r, int w, int h, int x, int y, bool vertical,
                     int beta, int tc, int max_val) {
    if (vertical ? (y + 3 >= h) : (x + 3 >= w))
        return;
    // sample accessor: i along edge, k across (-4..3 = p3..q3)
    auto at = [&](int i, int k) -> int16_t& {
        return vertical ? r[(int64_t)(y + i) * w + (x + k)]
                        : r[(int64_t)(y + k) * w + (x + i)];
    };
    int dp0 = at(0, -3) - 2 * at(0, -2) + at(0, -1);
    if (dp0 < 0) dp0 = -dp0;
    int dp3 = at(3, -3) - 2 * at(3, -2) + at(3, -1);
    if (dp3 < 0) dp3 = -dp3;
    int dq0 = at(0, 2) - 2 * at(0, 1) + at(0, 0);
    if (dq0 < 0) dq0 = -dq0;
    int dq3 = at(3, 2) - 2 * at(3, 1) + at(3, 0);
    if (dq3 < 0) dq3 = -dq3;
    int d = dp0 + dp3 + dq0 + dq3;
    if (d >= beta)
        return;
    auto dsam = [&](int i, int dpq) {
        int a = at(i, -4) - at(i, -1);
        if (a < 0) a = -a;
        int b = at(i, 0) - at(i, 3);
        if (b < 0) b = -b;
        int c = at(i, -1) - at(i, 0);
        if (c < 0) c = -c;
        return 2 * dpq < (beta >> 2) && a + b < (beta >> 3)
            && c < ((5 * tc + 1) >> 1);
    };
    bool strong = dsam(0, dp0 + dq0) && dsam(3, dp3 + dq3);
    if (strong) {
        int t2 = 2 * tc;
        for (int i = 0; i < 4; i++) {
            int p3 = at(i, -4), p2 = at(i, -3), p1 = at(i, -2),
                p0 = at(i, -1);
            int q0 = at(i, 0), q1 = at(i, 1), q2 = at(i, 2), q3 = at(i, 3);
            at(i, -1) = (int16_t)iclip(p0 - t2, p0 + t2,
                (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3);
            at(i, -2) = (int16_t)iclip(p1 - t2, p1 + t2,
                (p2 + p1 + p0 + q0 + 2) >> 2);
            at(i, -3) = (int16_t)iclip(p2 - t2, p2 + t2,
                (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3);
            at(i, 0) = (int16_t)iclip(q0 - t2, q0 + t2,
                (p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3);
            at(i, 1) = (int16_t)iclip(q1 - t2, q1 + t2,
                (p0 + q0 + q1 + q2 + 2) >> 2);
            at(i, 2) = (int16_t)iclip(q2 - t2, q2 + t2,
                (p0 + q0 + q1 + 3 * q2 + 2 * q3 + 4) >> 3);
        }
    } else {
        bool d_ep = dp0 + dp3 < ((beta + (beta >> 1)) >> 3);
        bool d_eq = dq0 + dq3 < ((beta + (beta >> 1)) >> 3);
        for (int i = 0; i < 4; i++) {
            int p2 = at(i, -3), p1 = at(i, -2), p0 = at(i, -1);
            int q0 = at(i, 0), q1 = at(i, 1), q2 = at(i, 2);
            int delta = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4;
            int ad = delta < 0 ? -delta : delta;
            if (ad >= tc * 10)
                continue;
            delta = iclip(-tc, tc, delta);
            at(i, -1) = (int16_t)iclip(0, max_val, p0 + delta);
            at(i, 0) = (int16_t)iclip(0, max_val, q0 - delta);
            if (d_ep) {
                int dp = iclip(-(tc >> 1), tc >> 1,
                               ((((p2 + p0 + 1) >> 1) - p1 + delta) >> 1));
                at(i, -2) = (int16_t)iclip(0, max_val, p1 + dp);
            }
            if (d_eq) {
                int dq = iclip(-(tc >> 1), tc >> 1,
                               ((((q2 + q0 + 1) >> 1) - q1 - delta) >> 1));
                at(i, 1) = (int16_t)iclip(0, max_val, q1 + dq);
            }
        }
    }
}

// n-line chroma edge segment (spec 8.7.2.5.5)
void filter_chroma_seg(int16_t* r, int w, int h, int x, int y, bool vertical,
                       int tc, int max_val, int n) {
    if (vertical && y + n > h)
        n = h - y;
    if (!vertical && x + n > w)
        n = w - x;
    auto at = [&](int i, int k) -> int16_t& {
        return vertical ? r[(int64_t)(y + i) * w + (x + k)]
                        : r[(int64_t)(y + k) * w + (x + i)];
    };
    for (int i = 0; i < n; i++) {
        int p1 = at(i, -2), p0 = at(i, -1), q0 = at(i, 0), q1 = at(i, 1);
        int delta = iclip(-tc, tc, (((q0 - p0) << 2) + p1 - q1 + 4) >> 3);
        at(i, -1) = (int16_t)iclip(0, max_val, p0 + delta);
        at(i, 0) = (int16_t)iclip(0, max_val, q0 - delta);
    }
}

// Deblock one direction over a luma-row band: for vertical edges the
// band [y_lo, y_hi) restricts the 4-sample segment positions s; for
// horizontal edges it restricts the edge positions e. A sequence of
// band calls (vertical rows first, horizontal edges lagging 8 rows — the
// edge filter reads 4 vertically-filtered rows each side) reproduces the
// whole-picture vertical-then-horizontal pass sample-exactly, which is
// what lets the encoder publish loop-filtered rows while the CTU search
// below them is still running (inter-picture wavefront; the reference
// overlaps dependent pictures the same way, TaskEncodeSubstream.cpp:71-93).
void deblock_dir(bool vertical, int y_lo, int y_hi) {
    const int w = db.pic_w, h = db.pic_h;
    const int max_y = (1 << db.bd_y) - 1;
    const int max_c = (1 << db.bd_c) - 1;
    const int cl2 = db.ctb_log2;
    const int cw = w >> 1, chh = h >> 1;
    if (y_hi > (vertical ? h : h))
        y_hi = h;
    if (y_lo < 0)
        y_lo = 0;
    // horizontal edges are consumed exactly once across band calls:
    // round the continuation bound UP to the 8-row edge grid
    const int e_beg0 = vertical ? 8 : ((y_lo + 7) & ~7);
    const int e_beg = e_beg0 < 8 ? 8 : e_beg0;
    const int e_end = vertical ? w : y_hi;
    const int s_beg = vertical ? ((y_lo + 3) & ~3) : 0;
    const int s_end = vertical ? y_hi : w;
    for (int e = e_beg; e < e_end; e += 8) {
        for (int s = s_beg; s < s_end; s += 4) {
            int x = vertical ? e : s, y = vertical ? s : e;
            int64_t bp, bq;
            if (vertical) {
                bp = (int64_t)(y >> 2) * db.w4 + ((x - 1) >> 2);
                bq = (int64_t)(y >> 2) * db.w4 + (x >> 2);
            } else {
                bp = (int64_t)((y - 1) >> 2) * db.w4 + (x >> 2);
                bq = (int64_t)(y >> 2) * db.w4 + (x >> 2);
            }
            if (db.tu_id[bp] == db.tu_id[bq] && db.pu_id[bp] == db.pu_id[bq]
                && db.cu_id[bp] == db.cu_id[bq])
                continue;
            int64_t cq = (int64_t)(y >> cl2) * db.wc + (x >> cl2);
            // headers may be fewer than slice numbers (encoder deblocks
            // before appending segment headers); all share one param set
            // then — mirror the numpy path's clip
            int sl = iclip(0, db.n_sl - 1, db.slice_idx[cq]);
            if (db.sl_disabled[sl])
                continue;
            int64_t cp = vertical
                ? (int64_t)(y >> cl2) * db.wc + ((x - 1) >> cl2)
                : (int64_t)((y - 1) >> cl2) * db.wc + (x >> cl2);
            if (cp != cq) {
                if (db.slice_idx[cp] != db.slice_idx[cq]
                    && !db.sl_across[sl])
                    continue;
                if (db.tile_id[cp] != db.tile_id[cq] && !db.across_tiles)
                    continue;
            }
            int bs;
            if (db.cu_pred_mode[bp] == 1 || db.cu_pred_mode[bq] == 1) {
                bs = 2;
            } else {
                bs = 0;
                if (db.tu_id[bp] != db.tu_id[bq]
                    && (db.cbf_y[bp] || db.cbf_y[bq]))
                    bs = 1;
                if (bs == 0)
                    bs = motion_bs(bp, bq);
            }
            if (bs == 0)
                continue;
            int qp_p = db.qp_y[bp], qp_q = db.qp_y[bq];
            int qpl = (qp_p + qp_q + 1) >> 1;
            int qb = iclip(0, 51, qpl + (db.sl_beta[sl] << 1));
            int beta = db.beta_tab[qb] << (db.bd_y - 8);
            int qt = iclip(0, 53, qpl + 2 * (bs - 1) + (db.sl_tc[sl] << 1));
            int tc = db.tc_tab[qt] << (db.bd_y - 8);
            if (tc || beta)
                filter_luma_seg(db.ry, w, h, x, y, vertical, beta, tc,
                                max_y);
            if (bs == 2 && (e % 16 == 0)) {
                const int offs[2] = {db.cb_off[sl], db.cr_off[sl]};
                int16_t* planes[2] = {db.rcb, db.rcr};
                for (int c = 0; c < 2; c++) {
                    int qpi = ((qp_p + qp_q + 1) >> 1) + offs[c];
                    int qpc = db.cqt[iclip(-db.qp_bd_c, 57, qpi)
                                     + db.qp_bd_c];
                    int qtc = iclip(0, 53, qpc + 2 + (db.sl_tc[sl] << 1));
                    int tcc = db.tc_tab[qtc] << (db.bd_c - 8);
                    if (tcc)
                        filter_chroma_seg(planes[c], cw, chh, x >> 1, y >> 1,
                                          vertical, tcc, max_c, 2);
                }
            }
        }
    }
}

}  // namespace

extern "C" {

// Deblock the three planes in place (vertical then horizontal edges),
// restricted to a luma-row band: vertical-edge segments with y in
// [vy0, vy1), horizontal edges at y in [ey0, ey1). Whole-picture deblock
// is the single band (0, pic_h, 0, pic_h); a lagged band sequence is
// sample-exact with it (the overlap follower's publisher).
// ptrs: [ry, rcb, rcr, tu_id, pu_id, cu_id, cu_pred_mode, cbf_y, ref_idx,
//        ref_poc, mv, qp_y, slice_idx, tile_id]
// ip: same layout as tc_inter_recon. Per-slice arrays indexed by slice_idx.
int tc_deblock(const int64_t* ptrs, const int32_t* ip,
               const int32_t* beta_tab, const int32_t* tc_tab,
               const int32_t* cqt, int32_t cqt_len,
               const int32_t* sl_disabled, const int32_t* sl_beta,
               const int32_t* sl_tc, const int32_t* sl_across,
               const int32_t* cb_off, const int32_t* cr_off,
               int32_t across_tiles, int32_t n_sl,
               int32_t vy0, int32_t vy1, int32_t ey0, int32_t ey1) {
    db.n_sl = n_sl;
    int k = 0;
    db.ry = (int16_t*)ptrs[k++];
    db.rcb = (int16_t*)ptrs[k++];
    db.rcr = (int16_t*)ptrs[k++];
    db.tu_id = (const int32_t*)ptrs[k++];
    db.pu_id = (const int32_t*)ptrs[k++];
    db.cu_id = (const int32_t*)ptrs[k++];
    db.cu_pred_mode = (const uint8_t*)ptrs[k++];
    db.cbf_y = (const uint8_t*)ptrs[k++];
    db.ref_idx = (const int8_t*)ptrs[k++];
    db.ref_poc = (const int32_t*)ptrs[k++];
    db.mv = (const int16_t*)ptrs[k++];
    db.qp_y = (const int8_t*)ptrs[k++];
    db.slice_idx = (const int32_t*)ptrs[k++];
    db.tile_id = (const int32_t*)ptrs[k++];
    int j = 0;
    db.pic_w = ip[j++];
    db.pic_h = ip[j++];
    db.w4 = ip[j++];
    db.h4 = ip[j++];
    db.wc = ip[j++];
    db.hc = ip[j++];
    db.ctb_log2 = ip[j++];
    db.bd_y = ip[j++];
    db.bd_c = ip[j++];
    j++;  // qp_bd_y unused
    db.qp_bd_c = ip[j++];
    db.beta_tab = beta_tab;
    db.tc_tab = tc_tab;
    db.cqt = cqt;
    (void)cqt_len;
    db.sl_disabled = sl_disabled;
    db.sl_beta = sl_beta;
    db.sl_tc = sl_tc;
    db.sl_across = sl_across;
    db.cb_off = cb_off;
    db.cr_off = cr_off;
    db.across_tiles = across_tiles;
    // timed into the encoder's phase slot 27 while the trace records
    extern int32_t tc_enc_trace_on();
    extern void tc_enc_add_ns(int32_t, int64_t);
    const bool timed = tc_enc_trace_on();
    struct timespec t0, t1;
    if (timed)
        clock_gettime(CLOCK_MONOTONIC, &t0);
    deblock_dir(true, vy0, vy1);
    deblock_dir(false, ey0, ey1);
    if (timed) {
        clock_gettime(CLOCK_MONOTONIC, &t1);
        tc_enc_add_ns(27, (t1.tv_sec - t0.tv_sec) * 1000000000LL
                          + (t1.tv_nsec - t0.tv_nsec));
    }
    return 0;
}

// Reconstruct all inter CUs of a picture: MC + residual add.
// ptrs: [ry, rcb, rcr, coeff_y, coeff_cb, coeff_cr, ts_y, ts_cb, ts_cr,
//        qp_y, mv, ref_idx, slice_idx, then 2*16*3 reference plane ptrs]
// ip:   [pic_w, pic_h, w4, h4, wc, hc, ctb_log2, bd_y, bd_c, qp_bd_y,
//        qp_bd_c]
// cu_rec: (n_cu, 8) int32 [x0, y0, log2, part_mode, skip, tqb, n_tus, pad];
// tu_rec: consecutive (n_tus per cu, 9) int32 rows as in slice_parse.cpp.
// Returns 0 on success.
int tc_inter_recon(const int64_t* ptrs, const int32_t* ip,
                   const int32_t* luma_filt, const int32_t* chroma_filt,
                   const int32_t* mats, const int32_t* level_scale,
                   const int32_t* cqt, int32_t cqt_len,
                   const int32_t* cb_off, const int32_t* cr_off,
                   const int32_t* cu_rec, int32_t n_cu,
                   const int32_t* tu_rec, int32_t n_sl) {
    rc.n_sl = n_sl;
    int k = 0;
    rc.ry = (int16_t*)ptrs[k++];
    rc.rcb = (int16_t*)ptrs[k++];
    rc.rcr = (int16_t*)ptrs[k++];
    rc.coeff_y = (const int16_t*)ptrs[k++];
    rc.coeff_cb = (const int16_t*)ptrs[k++];
    rc.coeff_cr = (const int16_t*)ptrs[k++];
    rc.ts_y = (const uint8_t*)ptrs[k++];
    rc.ts_cb = (const uint8_t*)ptrs[k++];
    rc.ts_cr = (const uint8_t*)ptrs[k++];
    rc.qp_y = (const int8_t*)ptrs[k++];
    rc.mv = (const int16_t*)ptrs[k++];
    rc.ref_idx = (const int8_t*)ptrs[k++];
    rc.slice_idx = (const int32_t*)ptrs[k++];
    for (int l = 0; l < 2; l++)
        for (int r = 0; r < 16; r++)
            for (int c = 0; c < 3; c++)
                rc.refs[l][r][c] = (const int16_t*)ptrs[k++];
    int j = 0;
    rc.pic_w = ip[j++];
    rc.pic_h = ip[j++];
    rc.w4 = ip[j++];
    rc.h4 = ip[j++];
    rc.wc = ip[j++];
    rc.hc = ip[j++];
    rc.ctb_log2 = ip[j++];
    rc.bd_y = ip[j++];
    rc.bd_c = ip[j++];
    rc.qp_bd_y = ip[j++];
    rc.qp_bd_c = ip[j++];
    std::memcpy(rc.lf, luma_filt, sizeof(rc.lf));
    std::memcpy(rc.cf, chroma_filt, sizeof(rc.cf));
    {
        int32_t* p = rc.mat_store;
        const int sizes[4] = {16, 64, 256, 1024};
        for (int i = 0; i < 4; i++) {
            std::memcpy(p, mats, sizes[i] * 4);
            rc.mats[2 + i] = p;
            mats += sizes[i];
            p += sizes[i];
        }
    }
    std::memcpy(rc.level_scale, level_scale, sizeof(rc.level_scale));
    rc.cqt = cqt;
    rc.cqt_len = cqt_len;
    rc.cb_off = cb_off;
    rc.cr_off = cr_off;

    const int cw = rc.pic_w >> 1;
    const int ch = rc.pic_h >> 1;
    static thread_local int32_t pred[2][64 * 64];
    static thread_local int32_t predc[2][2][32 * 32];
    const int64_t plane4 = (int64_t)rc.h4 * rc.w4;

    int64_t tu_base = 0;
    for (int ci = 0; ci < n_cu; ci++) {
        const int32_t* cr = cu_rec + (int64_t)ci * 8;
        int x0 = cr[0], y0 = cr[1], log2 = cr[2], part = cr[3];
        int skip = cr[4], tqb = cr[5], ntus = cr[6];
        int geo[4][4];
        int n_pu = pu_geometry(x0, y0, log2, part, geo);
        for (int p = 0; p < n_pu; p++) {
            int px = geo[p][0], py = geo[p][1], pw = geo[p][2],
                phh = geo[p][3];
            int64_t b = (int64_t)(py >> 2) * rc.w4 + (px >> 2);
            bool has[2] = {false, false};
            for (int l = 0; l < 2; l++) {
                int r = rc.ref_idx[l * plane4 + b];
                if (r < 0)
                    continue;
                has[l] = true;
                int mvx = rc.mv[(l * plane4 + b) * 2];
                int mvy = rc.mv[(l * plane4 + b) * 2 + 1];
                if (!rc.refs[l][r][0])
                    return 1;  // missing reference plane
                mc_interp(rc.refs[l][r][0], rc.pic_w, rc.pic_h,
                       px + (mvx >> 2), py + (mvy >> 2), mvx & 3, mvy & 3,
                       pw, phh, rc.bd_y, 8, rc.lf, 8, pred[l]);
                mc_interp(rc.refs[l][r][1], cw, ch,
                       (px >> 1) + (mvx >> 3), (py >> 1) + (mvy >> 3),
                       mvx & 7, mvy & 7, pw >> 1, phh >> 1, rc.bd_c, 4,
                       (const int32_t(*)[8])rc.cf, 4, predc[l][0]);
                mc_interp(rc.refs[l][r][2], cw, ch,
                       (px >> 1) + (mvx >> 3), (py >> 1) + (mvy >> 3),
                       mvx & 7, mvy & 7, pw >> 1, phh >> 1, rc.bd_c, 4,
                       (const int32_t(*)[8])rc.cf, 4, predc[l][1]);
            }
            if (!has[0] && !has[1])
                return 2;  // inter PU without motion
            combine(has[0] ? pred[0] : nullptr, has[1] ? pred[1] : nullptr,
                    pw, phh, rc.bd_y, rc.ry + (int64_t)py * rc.pic_w + px,
                    rc.pic_w);
            combine(has[0] ? predc[0][0] : nullptr,
                    has[1] ? predc[1][0] : nullptr, pw >> 1, phh >> 1,
                    rc.bd_c, rc.rcb + (int64_t)(py >> 1) * cw + (px >> 1),
                    cw);
            combine(has[0] ? predc[0][1] : nullptr,
                    has[1] ? predc[1][1] : nullptr, pw >> 1, phh >> 1,
                    rc.bd_c, rc.rcr + (int64_t)(py >> 1) * cw + (px >> 1),
                    cw);
        }

        // residuals
        if (!skip && ntus > 0) {
            int64_t b0 = (int64_t)(y0 >> 2) * rc.w4 + (x0 >> 2);
            int qp_raw = rc.qp_y[b0];
            int qp_full = qp_raw + rc.qp_bd_y;
            int sl = iclip(0, rc.n_sl - 1,
                           rc.slice_idx[(int64_t)(y0 >> rc.ctb_log2) * rc.wc
                                        + (x0 >> rc.ctb_log2)]);
            int qpi_cb = iclip(-rc.qp_bd_c, 57, qp_raw + rc.cb_off[sl]);
            int qpi_cr = iclip(-rc.qp_bd_c, 57, qp_raw + rc.cr_off[sl]);
            int qp_cb = rc.cqt[qpi_cb + rc.qp_bd_c] + rc.qp_bd_c;
            int qp_cr = rc.cqt[qpi_cr + rc.qp_bd_c] + rc.qp_bd_c;
            for (int t = 0; t < ntus; t++) {
                const int32_t* tr = tu_rec + (tu_base + t) * 9;
                int tx = tr[0], ty = tr[1], tl = tr[2], blk = tr[3];
                int xb = tr[4], yb = tr[5];
                int cbf_y = tr[6], cbf_cb = tr[7], cbf_cr = tr[8];
                if (cbf_y) {
                    int ts = rc.ts_y[(int64_t)(ty >> 2) * rc.w4 + (tx >> 2)];
                    residual_add(rc.coeff_y, rc.pic_w, tx, ty, 1 << tl, tl,
                                 qp_full, rc.bd_y, ts, tqb, rc.ry, rc.pic_w);
                }
                int cx, cy, cl;
                if (tl > 2) {
                    cx = tx >> 1;
                    cy = ty >> 1;
                    cl = tl - 1;
                } else if (blk == 3) {
                    cx = xb >> 1;
                    cy = yb >> 1;
                    cl = 2;
                } else {
                    continue;
                }
                if (cbf_cb) {
                    int ts = rc.ts_cb[(int64_t)(cy >> 1) * rc.w4 + (cx >> 1)];
                    residual_add(rc.coeff_cb, cw, cx, cy, 1 << cl, cl, qp_cb,
                                 rc.bd_c, ts, tqb, rc.rcb, cw);
                }
                if (cbf_cr) {
                    int ts = rc.ts_cr[(int64_t)(cy >> 1) * rc.w4 + (cx >> 1)];
                    residual_add(rc.coeff_cr, cw, cx, cy, 1 << cl, cl, qp_cr,
                                 rc.bd_c, ts, tqb, rc.rcr, cw);
                }
            }
        }
        tu_base += ntus;
    }
    return 0;
}

// Apply SAO to the three deblocked planes (spec 8.7.3; decode/sao.py
// oracle). dst planes must be copies of src; filtered CTBs are
// overwritten. Per-slice flag arrays are indexed by slice_idx.
// skip_mask: (h4, w4) uint8 (pcm/tq-bypass samples keep src) or null.
int tc_sao_apply(const int64_t* src_ptrs, const int64_t* dst_ptrs,
                 int64_t sao_type_p, int64_t sao_class_p,
                 int64_t sao_offsets_p, int64_t slice_idx_p,
                 int64_t tile_id_p, int32_t wc, int32_t hc, int32_t ctb_y,
                 int32_t pic_w, int32_t pic_h, int32_t bd_y, int32_t bd_c,
                 const int32_t* sl_sao_luma, const int32_t* sl_sao_chroma,
                 const int32_t* sl_across, int32_t n_sl,
                 int32_t across_tiles, int64_t skip_p, int32_t w4,
                 int32_t cy0, int32_t cy1) {
    const uint8_t* sao_type = (const uint8_t*)sao_type_p;
    const uint8_t* sao_class = (const uint8_t*)sao_class_p;
    const int8_t* sao_offsets = (const int8_t*)sao_offsets_p;
    const int32_t* slice_idx = (const int32_t*)slice_idx_p;
    const int32_t* tile_id = (const int32_t*)tile_id_p;
    const uint8_t* skip = (const uint8_t*)skip_p;
    static const int eo_n[4][2][2] = {{{0, -1}, {0, 1}},
                                      {{-1, 0}, {1, 0}},
                                      {{-1, -1}, {1, 1}},
                                      {{-1, 1}, {1, -1}}};
    static const int remap[5] = {1, 2, 0, 3, 4};
    int cl2 = 0;
    while ((1 << cl2) < ctb_y)
        cl2++;

    if (cy1 > hc)
        cy1 = hc;
    for (int cy = cy0; cy < cy1; cy++)
        for (int cx = 0; cx < wc; cx++) {
            int64_t cur = (int64_t)cy * wc + cx;
            int sidx = slice_idx[cur];
            if (sidx < 0)
                continue;
            int scl = iclip(0, n_sl - 1, sidx);
            for (int c_idx = 0; c_idx < 3; c_idx++) {
                int t = sao_type[cur * 3 + c_idx];
                if (t == 0)
                    continue;
                if (c_idx == 0 && !sl_sao_luma[scl])
                    continue;
                if (c_idx > 0 && !sl_sao_chroma[scl])
                    continue;
                const int sub = c_idx == 0 ? 1 : 2;
                const int bd = c_idx == 0 ? bd_y : bd_c;
                const int max_v = (1 << bd) - 1;
                const int ctb = ctb_y / sub;
                const int w = pic_w / sub, h = pic_h / sub;
                const int16_t* src = (const int16_t*)src_ptrs[c_idx];
                int16_t* dst = (int16_t*)dst_ptrs[c_idx];
                int x0 = cx * ctb, y0 = cy * ctb;
                int x1 = x0 + ctb < w ? x0 + ctb : w;
                int y1 = y0 + ctb < h ? y0 + ctb : h;
                const int8_t* offs = sao_offsets + cur * 12 + c_idx * 4;
                if (t == 1) {  // band
                    int shift = bd - 5;
                    int band_pos = sao_class[cur * 3 + c_idx];
                    int lut[32] = {};
                    for (int k = 0; k < 4; k++)
                        lut[(band_pos + k) & 31] = offs[k];
                    for (int y = y0; y < y1; y++)
                        for (int x = x0; x < x1; x++) {
                            int v = src[(int64_t)y * w + x];
                            int r = iclip(0, max_v, v + lut[v >> shift]);
                            if (skip && skip[(int64_t)((y * sub) >> 2) * w4
                                             + ((x * sub) >> 2)])
                                r = v;
                            dst[(int64_t)y * w + x] = (int16_t)r;
                        }
                } else {  // edge
                    int eo = sao_class[cur * 3 + c_idx];
                    int ady = eo_n[eo][0][0], adx = eo_n[eo][0][1];
                    int bdy = eo_n[eo][1][0], bdx = eo_n[eo][1][1];
                    int lut[5] = {0, offs[0], offs[1], offs[2], offs[3]};
                    int cur_tile = tile_id[cur];
                    for (int y = y0; y < y1; y++)
                        for (int x = x0; x < x1; x++) {
                            int v = src[(int64_t)y * w + x];
                            int r = v;
                            int ay = y + ady, ax = x + adx;
                            int by = y + bdy, bx = x + bdx;
                            bool valid = ay >= 0 && ay < h && ax >= 0
                                      && ax < w && by >= 0 && by < h
                                      && bx >= 0 && bx < w;
                            if (valid) {
                                // slice/tile boundary rule (mirrors
                                // decode/sao._neighbour_ok)
                                for (int nb = 0; nb < 2 && valid; nb++) {
                                    int yn = nb ? by : ay;
                                    int xn = nb ? bx : ax;
                                    int ynl = iclip(0, pic_h - 1, yn * sub);
                                    int xnl = iclip(0, pic_w - 1, xn * sub);
                                    int64_t nc = (int64_t)(ynl >> cl2) * wc
                                               + (xnl >> cl2);
                                    bool ok = true;
                                    if (!across_tiles
                                        && tile_id[nc] != cur_tile)
                                        ok = false;
                                    if (slice_idx[nc] != sidx
                                        && !sl_across[scl])
                                        ok = false;
                                    valid = ok;
                                }
                            }
                            if (valid) {
                                int av = src[(int64_t)ay * w + ax];
                                int bv = src[(int64_t)by * w + bx];
                                int sa = (v > av) - (v < av);
                                int sb = (v > bv) - (v < bv);
                                int e = remap[2 + sa + sb];
                                r = iclip(0, max_v, v + lut[e]);
                            }
                            if (skip && skip[(int64_t)((y * sub) >> 2) * w4
                                             + ((x * sub) >> 2)])
                                r = v;
                            dst[(int64_t)y * w + x] = (int16_t)r;
                        }
                }
            }
        }
    return 0;
}

// Reconstruct intra CUs [start_cu, n_cu) in decode order via tc_intra_tu.
// Same ptrs/ip/table layout as tc_inter_recon, plus zscan32 (int32, w4
// stride at min-block granularity) and the strong-smoothing flag.
// Stops at the first CU it cannot handle natively (transquant bypass or a
// transform-skip TU) and returns that CU's index; returns n_cu when done.
// The caller reruns the returned CU with the Python oracle (safe: TU recon
// is a pure function of already-final neighbour samples) and resumes at
// index+1. tu_base must be the record offset of cu start_cu.
int tc_intra_recon(const int64_t* ptrs, const int32_t* ip,
                   const int32_t* mats, const int32_t* level_scale,
                   const int32_t* cqt, int32_t cqt_len,
                   const int32_t* cb_off, const int32_t* cr_off,
                   const int32_t* zscan32, int32_t strong,
                   const int32_t* cu_rec, int32_t n_cu,
                   const int32_t* tu_rec, int32_t start_cu,
                   int64_t tu_base, int32_t n_sl) {
    rc.n_sl = n_sl;
    int k = 0;
    rc.ry = (int16_t*)ptrs[k++];
    rc.rcb = (int16_t*)ptrs[k++];
    rc.rcr = (int16_t*)ptrs[k++];
    rc.coeff_y = (const int16_t*)ptrs[k++];
    rc.coeff_cb = (const int16_t*)ptrs[k++];
    rc.coeff_cr = (const int16_t*)ptrs[k++];
    rc.ts_y = (const uint8_t*)ptrs[k++];
    rc.ts_cb = (const uint8_t*)ptrs[k++];
    rc.ts_cr = (const uint8_t*)ptrs[k++];
    rc.qp_y = (const int8_t*)ptrs[k++];
    rc.mv = (const int16_t*)ptrs[k++];
    rc.ref_idx = (const int8_t*)ptrs[k++];
    rc.slice_idx = (const int32_t*)ptrs[k++];
    int j = 0;
    rc.pic_w = ip[j++];
    rc.pic_h = ip[j++];
    rc.w4 = ip[j++];
    rc.h4 = ip[j++];
    rc.wc = ip[j++];
    rc.hc = ip[j++];
    rc.ctb_log2 = ip[j++];
    rc.bd_y = ip[j++];
    rc.bd_c = ip[j++];
    rc.qp_bd_y = ip[j++];
    rc.qp_bd_c = ip[j++];
    rc.cqt = cqt;
    rc.cqt_len = cqt_len;
    rc.cb_off = cb_off;
    rc.cr_off = cr_off;
    (void)mats;
    (void)level_scale;  // intra TU dequant tables live in cabac_core

    // intra plane maps (defined against the plan's min-block granularity)
    const uint8_t* mode_y = (const uint8_t*)ptrs[k++];
    const uint8_t* mode_c = (const uint8_t*)ptrs[k++];
    const int cw = rc.pic_w >> 1;
    const int ch = rc.pic_h >> 1;

    for (int ci = start_cu; ci < n_cu; ci++) {
        const int32_t* cr = cu_rec + (int64_t)ci * 8;
        int x0 = cr[0], y0 = cr[1], log2 = cr[2];
        int tqb = cr[5], ntus = cr[6];
        if (tqb)
            return ci;
        // per-CU QPs
        int64_t b0 = (int64_t)(y0 >> 2) * rc.w4 + (x0 >> 2);
        int qp_raw = rc.qp_y[b0];
        int qp_full = qp_raw + rc.qp_bd_y;
        int sl = iclip(0, rc.n_sl - 1,
                       rc.slice_idx[(int64_t)(y0 >> rc.ctb_log2) * rc.wc
                                    + (x0 >> rc.ctb_log2)]);
        int qpi_cb = iclip(-rc.qp_bd_c, 57, qp_raw + rc.cb_off[sl]);
        int qpi_cr = iclip(-rc.qp_bd_c, 57, qp_raw + rc.cr_off[sl]);
        int qp_cb = rc.cqt[qpi_cb + rc.qp_bd_c] + rc.qp_bd_c;
        int qp_cr = rc.cqt[qpi_cr + rc.qp_bd_c] + rc.qp_bd_c;

        int32_t synth[9];
        const int32_t* tus = tu_rec + tu_base * 9;
        int nt = ntus;
        if (nt == 0) {  // whole-CU TU with no residual
            synth[0] = x0; synth[1] = y0; synth[2] = log2; synth[3] = 0;
            synth[4] = x0; synth[5] = y0;
            synth[6] = 0; synth[7] = 0; synth[8] = 0;
            tus = synth;
            nt = 1;
        }
        // pre-scan for transform-skip TUs: bail before touching pixels
        for (int t = 0; t < nt; t++) {
            const int32_t* tr = tus + (int64_t)t * 9;
            int tx = tr[0], ty = tr[1], tl = tr[2], blk = tr[3];
            if (tl == 2
                && rc.ts_y[(int64_t)(ty >> 2) * rc.w4 + (tx >> 2)])
                return ci;
            int cx, cy;
            if (tl > 2) {
                cx = tx >> 1;
                cy = ty >> 1;
            } else if (blk == 3) {
                cx = tr[4] >> 1;
                cy = tr[5] >> 1;
            } else {
                continue;
            }
            if (rc.ts_cb[(int64_t)(cy >> 1) * rc.w4 + (cx >> 1)]
                || rc.ts_cr[(int64_t)(cy >> 1) * rc.w4 + (cx >> 1)])
                return ci;
        }
        for (int t = 0; t < nt; t++) {
            const int32_t* tr = tus + (int64_t)t * 9;
            int tx = tr[0], ty = tr[1], tl = tr[2], blk = tr[3];
            int xb = tr[4], yb = tr[5];
            int cbf_y = tr[6], cbf_cb = tr[7], cbf_cr = tr[8];
            int n = 1 << tl;
            int m = mode_y[(int64_t)(ty >> 2) * rc.w4 + (tx >> 2)];
            tc_intra_tu(rc.ry, rc.pic_w, rc.pic_h, zscan32, rc.w4, tx, ty,
                        n, 0, 1, rc.bd_y, m, strong, rc.coeff_y, cbf_y,
                        qp_full, tl == 2 ? 1 : 0);
            int cx, cy, cn;
            if (tl > 2) {
                cx = tx >> 1;
                cy = ty >> 1;
                cn = n >> 1;
            } else if (blk == 3) {
                cx = xb >> 1;
                cy = yb >> 1;
                cn = 4;
            } else {
                continue;
            }
            int mc = mode_c[(int64_t)((cy << 1) >> 2) * rc.w4
                            + ((cx << 1) >> 2)];
            tc_intra_tu(rc.rcb, cw, ch, zscan32, rc.w4, cx, cy, cn, 1, 2,
                        rc.bd_c, mc, strong, rc.coeff_cb, cbf_cb, qp_cb, 0);
            tc_intra_tu(rc.rcr, cw, ch, zscan32, rc.w4, cx, cy, cn, 1, 2,
                        rc.bd_c, mc, strong, rc.coeff_cr, cbf_cr, qp_cr, 0);
        }
        tu_base += ntus;
    }
    return n_cu;
}

}  // extern "C"
