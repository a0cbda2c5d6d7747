// Native CABAC write path: arithmetic encoder engine + the full CTU-level
// syntax writing walk from the PicturePlan tensors — the exact inverse of
// slice_parse.cpp and the C++ twin of encode/ctu_write.py (which stays as
// the oracle; substream bytes are asserted identical in the A/B tests).
//
// Reference analogue: the Write verb re-walk (turing/Write.h:510-676) with
// the CabacWriter engine (turing/CabacWriter.h:100-190).
//
// Spec: arithmetic encoder 9.3.4.4 (PutBit/bitsOutstanding form),
// binarizations 9.3.3, syntax 7.3.8.
#include <cstdint>
#include <cstring>

#include "core.h"

// CABAC tables installed by tc_init_tables (cabac_core.cpp)
extern uint8_t g_range_lps[64][4];
extern uint8_t g_next_mps[128];
extern uint8_t g_next_lps[128];
extern uint8_t g_sig4x4[16];
extern int32_t g_off_sig, g_off_csbf, g_off_lastx, g_off_lasty, g_off_gt1,
    g_off_gt2;
extern int8_t g_scan[4][3][2 * 64];

namespace {

// ---- arithmetic encoder (cabac/engine.CabacEncoder oracle) -----------------
struct BinEnc {
    uint8_t* buf;
    int64_t cap_bits;
    int64_t bitpos;
    uint32_t low, range;
    int bits_outstanding;
    int first_bit;
    uint8_t* ctx;
    int err;

    inline void raw_bit(int b) {
        if (bitpos >= cap_bits) {
            err = 1;
            return;
        }
        if (b)
            buf[bitpos >> 3] |= (uint8_t)(1u << (7 - (bitpos & 7)));
        bitpos++;
    }

    inline void raw_bits(uint32_t v, int n) {
        for (int i = n - 1; i >= 0; i--)
            raw_bit((v >> i) & 1);
    }

    inline void put_bit(int b) {
        if (first_bit)
            first_bit = 0;
        else
            raw_bit(b);
        while (bits_outstanding > 0) {
            raw_bit(1 - b);
            bits_outstanding--;
        }
    }

    inline void renorm() {
        while (range < 256) {
            if (low >= 0x200) {
                put_bit(1);
                low -= 0x200;
            } else if (low < 0x100) {
                put_bit(0);
            } else {
                low -= 0x100;
                bits_outstanding++;
            }
            range <<= 1;
            low <<= 1;
        }
    }

    inline void decision(int idx, int bin) {
        uint32_t s = ctx[idx];
        uint32_t lps = g_range_lps[s >> 1][(range >> 6) & 3];
        range -= lps;
        if ((uint32_t)bin != (s & 1)) {
            low += range;
            range = lps;
            ctx[idx] = g_next_lps[s];
        } else {
            ctx[idx] = g_next_mps[s];
        }
        if (range < 256)
            renorm();
    }

    inline void bypass(int bin) {
        low <<= 1;
        if (bin)
            low += range;
        if (low >= 0x400) {
            put_bit(1);
            low -= 0x400;
        } else if (low < 0x200) {
            put_bit(0);
        } else {
            low -= 0x200;
            bits_outstanding++;
        }
    }

    inline void bypass_bits(uint32_t v, int n) {
        for (int i = n - 1; i >= 0; i--)
            bypass((v >> i) & 1);
    }

    inline void terminate(int bin) {
        range -= 2;
        if (bin) {
            low += range;
            range = 2;
            renorm();
            put_bit((low >> 9) & 1);
            raw_bits(((low >> 7) & 3) | 1, 2);
        } else {
            renorm();
        }
    }

    inline void egk(uint32_t value, int k) {
        while (value >= (1u << k)) {
            bypass(1);
            value -= 1u << k;
            k++;
        }
        bypass(0);
        if (k)
            bypass_bits(value, k);
    }
};

// write-side state (SliceWriteContext analogue); engine + QP chain
struct WS {
    BinEnc e;
    int qp_y_pred, last_cu_qp, qp_coded, qp_delta;
    // transient per-CU
    int cu_x0, cu_y0, cu_log2, cu_depth, cu_pred_mode, cu_part_mode,
        cu_tqb, cu_intra_split, cu_max_td;
};

inline int dec_w(WS& ws, int elem, int inc, int bin) {
    ws.e.decision(g_sp.off[elem] + inc, bin);
    return bin;
}

// QpY predictor (spec 8.6.1; ctu_parse._derive_qp / slice_parse.derive_qp)
int w_derive_qp(WS& ws, int x0, int y0) {
    if (!g_sp.cu_qp_delta_enabled)
        return g_sp.slice_qp_y;
    int log2_min_qg = g_sp.ctb_log2 - g_sp.diff_cu_qp_delta_depth;
    int mask = ~((1 << log2_min_qg) - 1);
    int x_qg = x0 & mask, y_qg = y0 & mask;
    int ctb_mask = ~((1 << g_sp.ctb_log2) - 1);
    int prev = ws.qp_y_pred;
    int a = prev, b = prev;
    if (sp_available(x_qg, y_qg, x_qg - 1, y_qg)
        && ((x_qg - 1) & ctb_mask) == (x_qg & ctb_mask))
        a = g_sp.qp_y[idx4(x_qg - 1, y_qg)];
    if (sp_available(x_qg, y_qg, x_qg, y_qg - 1)
        && ((y_qg - 1) & ctb_mask) == (y_qg & ctb_mask))
        b = g_sp.qp_y[idx4(x_qg, y_qg - 1)];
    int qp_pred = (a + b + 1) >> 1;
    int m = 52 + g_sp.qp_bd_offset_y;
    int qp = ((qp_pred + ws.qp_delta + 52 + 2 * g_sp.qp_bd_offset_y) % m)
           - g_sp.qp_bd_offset_y;
    return qp;
}

// any nonzero in an (n, n) region of a strided int16 plane
inline int region_any(const int16_t* plane, int stride, int x0, int y0,
                      int n) {
    for (int y = 0; y < n; y++) {
        const int16_t* row = plane + (int64_t)(y0 + y) * stride + x0;
        for (int x = 0; x < n; x++)
            if (row[x])
                return 1;
    }
    return 0;
}

// ---- SAO writing (ctu_write.write_sao) --------------------------------------
void write_sao(WS& ws, int rx, int ry) {
    int64_t cur = (int64_t)ry * g_sp.wc + rx;
    const int merge = g_sp.sao_merge ? g_sp.sao_merge[cur] : 0;
    if (rx > 0 && g_sp.slice_idx[cur - 1] == g_sp.slice_number
        && g_sp.tile_id[cur] == g_sp.tile_id[cur - 1]) {
        dec_w(ws, E_SAO_MERGE, 0, merge == 1 ? 1 : 0);
        if (merge == 1)
            return;
    }
    if (ry > 0 && g_sp.slice_idx[cur - g_sp.wc] == g_sp.slice_number
        && g_sp.tile_id[cur] == g_sp.tile_id[cur - g_sp.wc]) {
        dec_w(ws, E_SAO_MERGE, 0, merge == 2 ? 1 : 0);
        if (merge == 2)
            return;
    }
    for (int c_idx = 0; c_idx < 3; c_idx++) {
        if (c_idx == 0 && !g_sp.sao_luma)
            continue;
        if (c_idx > 0 && !g_sp.sao_chroma)
            continue;
        int t = g_sp.sao_type[cur * 3 + c_idx];
        if (c_idx <= 1) {
            dec_w(ws, E_SAO_TYPE, 0, t ? 1 : 0);
            if (t)
                ws.e.bypass(t == 2 ? 1 : 0);
        }
        if (t == 0)
            continue;
        int bd = c_idx == 0 ? g_sp.bit_depth_y : g_sp.bit_depth_c;
        int c_max = (1 << ((bd < 10 ? bd : 10) - 5)) - 1;
        const int8_t* offs = g_sp.sao_offsets + cur * 12 + c_idx * 4;
        for (int k = 0; k < 4; k++) {
            int v = offs[k] < 0 ? -offs[k] : offs[k];
            int m = v < c_max ? v : c_max;
            for (int i = 0; i < m; i++)
                ws.e.bypass(1);
            if (v < c_max)
                ws.e.bypass(0);
        }
        if (t == 1) {
            for (int k = 0; k < 4; k++)
                if (offs[k])
                    ws.e.bypass(offs[k] < 0 ? 1 : 0);
            ws.e.bypass_bits(g_sp.sao_class[cur * 3 + c_idx], 5);
        } else if (c_idx <= 1) {
            ws.e.bypass_bits(g_sp.sao_class[cur * 3 + c_idx], 2);
        }
    }
}

// ---- residual writing (ctu_write.residual_core) -----------------------------
void write_remaining(WS& ws, int value, int rice) {
    if ((value >> rice) <= 3) {
        int prefix = value >> rice;
        for (int i = 0; i < prefix; i++)
            ws.e.bypass(1);
        ws.e.bypass(0);
        if (rice)
            ws.e.bypass_bits(value & ((1 << rice) - 1), rice);
    } else {
        int prefix = 4;
        while (true) {
            int base = ((1 << (prefix - 3)) + 2) << rice;
            int nbits = prefix - 3 + rice;
            if (value < base + (1 << nbits))
                break;
            prefix++;
        }
        for (int i = 0; i < prefix; i++)
            ws.e.bypass(1);
        ws.e.bypass(0);
        int base = ((1 << (prefix - 3)) + 2) << rice;
        ws.e.bypass_bits(value - base, prefix - 3 + rice);
    }
}

// residual_coding() writing for a block at (x0, y0) in plane coords
int write_residual_core(WS& ws, const int16_t* plane, int stride, int x0,
                        int y0, int log2_size, int c_idx, int scan_idx,
                        int sdh) {
    const int nsb = 1 << (log2_size - 2);
    const int n_sub = nsb * nsb;
    const int8_t* sub_scan = g_scan[log2_size - 2][scan_idx];
    const int8_t* pos_scan = g_scan[2][scan_idx];
    const int16_t* blk = plane + (int64_t)y0 * stride + x0;

    auto coef = [&](int xs, int ys, int nn) -> int {
        int xc = (xs << 2) + pos_scan[2 * nn];
        int yc = (ys << 2) + pos_scan[2 * nn + 1];
        return blk[(int64_t)yc * stride + xc];
    };

    // last significant coefficient
    int last_i = -1, last_n = -1;
    for (int i = n_sub - 1; i >= 0 && last_i < 0; i--) {
        int xs = sub_scan[2 * i], ys = sub_scan[2 * i + 1];
        for (int nn = 15; nn >= 0; nn--)
            if (coef(xs, ys, nn)) {
                last_i = i;
                last_n = nn;
                break;
            }
    }
    if (last_i < 0)
        return 1;  // all-zero block must not be written
    int lxs = sub_scan[2 * last_i], lys = sub_scan[2 * last_i + 1];
    int last_x = (lxs << 2) + pos_scan[2 * last_n];
    int last_y = (lys << 2) + pos_scan[2 * last_n + 1];
    int wx = last_x, wy = last_y;
    if (scan_idx == 2) {
        wx = last_y;
        wy = last_x;
    }

    int c_max = (log2_size << 1) - 1;
    int ctx_off, ctx_shift;
    if (c_idx == 0) {
        ctx_off = 3 * (log2_size - 2) + ((log2_size - 1) >> 2);
        ctx_shift = (log2_size + 1) >> 2;
    } else {
        ctx_off = 15;
        ctx_shift = log2_size - 2;
    }
    auto last_prefix = [&](int base_off, int v) -> int {
        int prefix = v;
        if (v > 3) {
            int p = 0;
            while (p < c_max) {
                int lo, hi;
                if (p <= 3) {
                    lo = hi = p;
                } else {
                    int k = (p >> 1) - 1;
                    lo = (2 + (p & 1)) << k;
                    hi = lo + (1 << k) - 1;
                }
                if (lo <= v && v <= hi)
                    break;
                p++;
            }
            prefix = p;
        }
        for (int k = 0; k < prefix; k++)
            ws.e.decision(base_off + (k >> ctx_shift) + ctx_off, 1);
        if (prefix < c_max)
            ws.e.decision(base_off + (prefix >> ctx_shift) + ctx_off, 0);
        return prefix;
    };
    int px = last_prefix(g_off_lastx, wx);
    int py = last_prefix(g_off_lasty, wy);
    if (px > 3) {
        int nb = (px >> 1) - 1;
        ws.e.bypass_bits(wx - ((2 + (px & 1)) << nb), nb);
    }
    if (py > 3) {
        int nb = (py >> 1) - 1;
        ws.e.bypass_bits(wy - ((2 + (py & 1)) << nb), nb);
    }

    uint8_t csbf[8][8];
    for (int ys = 0; ys < nsb; ys++)
        for (int xs = 0; xs < nsb; xs++) {
            uint8_t any = 0;
            for (int nn = 0; nn < 16 && !any; nn++)
                any = coef(xs, ys, nn) != 0;
            csbf[ys][xs] = any;
        }

    int c1_chain_gt1 = 0;
    for (int i = last_i; i >= 0; i--) {
        int xs = sub_scan[2 * i], ys = sub_scan[2 * i + 1];
        int sb_coded = csbf[ys][xs];
        int infer_sb_dc = 0;
        if (i < last_i && i > 0) {
            int inc = ((xs + 1 < nsb && csbf[ys][xs + 1]) ||
                       (ys + 1 < nsb && csbf[ys + 1][xs])) ? 1 : 0;
            ws.e.decision(g_off_csbf + inc + (c_idx ? 2 : 0), sb_coded);
            infer_sb_dc = 1;
        } else {
            sb_coded = 1;
            csbf[ys][xs] = 1;
        }
        if (!sb_coded)
            continue;

        int levels[16];
        uint8_t sig[16];
        for (int nn = 0; nn < 16; nn++) {
            levels[nn] = coef(xs, ys, nn);
            sig[nn] = levels[nn] != 0;
        }
        int start_n = (i == last_i) ? last_n - 1 : 15;
        int prev_csbf = 0;
        if (xs + 1 < nsb && csbf[ys][xs + 1]) prev_csbf += 1;
        if (ys + 1 < nsb && csbf[ys + 1][xs]) prev_csbf += 2;
        for (int nn = start_n; nn >= 0; nn--) {
            if (nn > 0 || !infer_sb_dc) {
                int xp = pos_scan[2 * nn], yp = pos_scan[2 * nn + 1];
                int sc = sig_ctx(log2_size, c_idx, scan_idx,
                                 (xs << 2) + xp, (ys << 2) + yp, xp, yp,
                                 xs, ys, prev_csbf);
                ws.e.decision(g_off_sig + sc, sig[nn]);
                if (sig[nn])
                    infer_sb_dc = 0;
            } else if (!sig[nn]) {
                return 2;  // infer constraint violated
            }
        }

        int sig_pos[16], n_sig = 0;
        for (int nn = 15; nn >= 0; nn--)
            if (sig[nn])
                sig_pos[n_sig++] = nn;
        if (!n_sig)
            continue;

        int ctx_set = ((i == 0 || c_idx > 0) ? 0 : 2)
                    + (c1_chain_gt1 ? 1 : 0);
        int c1 = 1;
        c1_chain_gt1 = 0;
        uint8_t gt1[16];
        std::memset(gt1, 0, 16);
        int first_gt1_pos = -1;
        int n_g1 = n_sig < 8 ? n_sig : 8;
        for (int k = 0; k < n_g1; k++) {
            int nn = sig_pos[k];
            int a = levels[nn] < 0 ? -levels[nn] : levels[nn];
            int g = a > 1;
            ws.e.decision(g_off_gt1 + ctx_set * 4 + c1 + (c_idx ? 16 : 0),
                          g);
            gt1[nn] = (uint8_t)g;
            if (g) {
                c1 = 0;
                c1_chain_gt1 = 1;
                if (first_gt1_pos < 0)
                    first_gt1_pos = nn;
            } else if (c1 > 0 && c1 < 3) {
                c1++;
            }
        }
        int gt2_val = 0;
        if (first_gt1_pos >= 0) {
            int a = levels[first_gt1_pos] < 0 ? -levels[first_gt1_pos]
                                              : levels[first_gt1_pos];
            gt2_val = a > 2;
            ws.e.decision(g_off_gt2 + ctx_set + (c_idx ? 4 : 0), gt2_val);
        }

        int first_sig_scan = sig_pos[n_sig - 1];
        int last_sig_scan = sig_pos[0];
        int sign_hidden = sdh && (last_sig_scan - first_sig_scan > 3);
        if (sign_hidden) {
            int total = 0;
            for (int k = 0; k < n_sig; k++) {
                int a = levels[sig_pos[k]];
                total += a < 0 ? -a : a;
            }
            if ((total & 1) != (levels[first_sig_scan] < 0 ? 1 : 0))
                return 3;  // SDH parity not enforced by the quantizer
        }
        for (int k = 0; k < n_sig; k++) {
            int nn = sig_pos[k];
            if (sign_hidden && nn == first_sig_scan)
                continue;
            ws.e.bypass(levels[nn] < 0 ? 1 : 0);
        }

        int rice = 0;
        for (int k = 0; k < n_sig; k++) {
            int nn = sig_pos[k];
            int a = levels[nn] < 0 ? -levels[nn] : levels[nn];
            int base = 1;
            bool need_rem;
            if (k < 8) {
                base += gt1[nn];
                if (nn == first_gt1_pos)
                    base += gt2_val;
                need_rem = (nn == first_gt1_pos && gt2_val)
                         || (gt1[nn] && nn != first_gt1_pos);
            } else {
                need_rem = true;
            }
            if (need_rem) {
                write_remaining(ws, a - base, rice);
                if (a > (3 << rice) && rice < 4)
                    rice++;
            } else if (a != base) {
                return 4;
            }
        }
    }
    return 0;
}

// ---- transform tree / unit writing -----------------------------------------
int write_residual(WS& ws, int x0, int y0, int log2_size, int c_idx) {
    if (g_sp.transform_skip_enabled && !ws.cu_tqb && log2_size == 2) {
        int ts;
        if (c_idx == 0)
            ts = g_sp.ts_y[(int64_t)(y0 >> 2) * g_sp.w4 + (x0 >> 2)];
        else if (c_idx == 1)
            ts = g_sp.ts_cb[(int64_t)(y0 >> 1) * g_sp.w4 + (x0 >> 1)];
        else
            ts = g_sp.ts_cr[(int64_t)(y0 >> 1) * g_sp.w4 + (x0 >> 1)];
        dec_w(ws, c_idx == 0 ? E_TS_LUMA : E_TS_CHROMA, 0, ts);
    }
    int scan_idx = 0;
    if (ws.cu_pred_mode == 1
        && (log2_size == 2 || (log2_size == 3 && c_idx == 0))) {
        int mode;
        if (c_idx == 0)
            mode = g_sp.intra_mode_y[(int64_t)(y0 >> 2) * g_sp.w4
                                     + (x0 >> 2)];
        else
            mode = g_sp.intra_mode_c[(int64_t)(((y0 << 1) >> 2)) * g_sp.w4
                                     + ((x0 << 1) >> 2)];
        if (6 <= mode && mode <= 14)
            scan_idx = 2;
        else if (22 <= mode && mode <= 30)
            scan_idx = 1;
    }
    const int16_t* plane;
    int stride;
    if (c_idx == 0) {
        plane = g_sp.coeff_y;
        stride = g_sp.pic_w;
    } else {
        plane = c_idx == 1 ? g_sp.coeff_cb : g_sp.coeff_cr;
        stride = g_sp.pic_w >> 1;
    }
    int sdh = g_sp.sdh_enabled && !ws.cu_tqb;
    return write_residual_core(ws, plane, stride, x0, y0, log2_size, c_idx,
                               scan_idx, sdh);
}

int write_transform_tree(WS& ws, int x0, int y0, int x_base, int y_base,
                         int log2_size, int trafo_depth, int blk_idx,
                         int parent_cb, int parent_cr) {
    const int size = 1 << log2_size;
    int split = g_sp.tu_log2[idx4(x0, y0)] < log2_size;
    if (log2_size <= g_sp.max_tb_log2 && log2_size > g_sp.min_tb_log2
        && trafo_depth < ws.cu_max_td
        && !(ws.cu_intra_split && trafo_depth == 0)) {
        dec_w(ws, E_SPLIT_TT, 5 - log2_size, split);
    } else {
        int forced = log2_size > g_sp.max_tb_log2
                  || (ws.cu_intra_split && trafo_depth == 0);
        split = forced || split;
    }

    int chroma_here = log2_size > 2;
    int my_cb = parent_cb, my_cr = parent_cr;
    if (chroma_here) {
        int cx0 = x0 >> 1, cy0 = y0 >> 1, cs = size >> 1;
        my_cb = region_any(g_sp.coeff_cb, g_sp.pic_w >> 1, cx0, cy0, cs);
        my_cr = region_any(g_sp.coeff_cr, g_sp.pic_w >> 1, cx0, cy0, cs);
        if (trafo_depth == 0 || parent_cb)
            dec_w(ws, E_CBF_CHROMA, trafo_depth, my_cb);
        else if (my_cb)
            return 5;
        if (trafo_depth == 0 || parent_cr)
            dec_w(ws, E_CBF_CHROMA, trafo_depth, my_cr);
        else if (my_cr)
            return 5;
    }

    if (split) {
        int half = 1 << (log2_size - 1);
        static const int q[4][2] = {{0, 0}, {1, 0}, {0, 1}, {1, 1}};
        for (int i = 0; i < 4; i++) {
            int rc = write_transform_tree(ws, x0 + q[i][0] * half,
                                          y0 + q[i][1] * half, x0, y0,
                                          log2_size - 1, trafo_depth + 1, i,
                                          my_cb, my_cr);
            if (rc)
                return rc;
        }
        return 0;
    }

    int cbf_luma = region_any(g_sp.coeff_y, g_sp.pic_w, x0, y0, size);
    if (ws.cu_pred_mode == 1 || trafo_depth != 0 || my_cb || my_cr)
        dec_w(ws, E_CBF_LUMA, trafo_depth == 0 ? 1 : 0, cbf_luma);
    else if (!cbf_luma)
        return 6;

    int chroma_last = log2_size == 2 && blk_idx == 3;
    int any_chroma = (my_cb || my_cr) && (log2_size > 2 || chroma_last);
    // spec 7.3.8.10: cu_qp_delta belongs to the FIRST TU where any of
    // cbf_luma/cbf_cb/cbf_cr is set — at 4x4 TUs the chroma cbfs are
    // the parent's, so the delta can land on blkIdx 0 of a chroma-only
    // group (the reference writes it there; cross-verified)
    if (cbf_luma || my_cb || my_cr) {
        if (g_sp.cu_qp_delta_enabled && !ws.qp_coded) {
            ws.qp_delta = 0;
            int pred = w_derive_qp(ws, ws.cu_x0, ws.cu_y0);
            int val = g_sp.qp_y[idx4(ws.cu_x0, ws.cu_y0)] - pred;
            ws.qp_delta = val;
            ws.qp_coded = 1;
            int a = val < 0 ? -val : val;
            int m = a < 5 ? a : 5;
            for (int k = 0; k < m; k++)
                dec_w(ws, E_QP_DELTA, k == 0 ? 0 : 1, 1);
            if (a < 5)
                dec_w(ws, E_QP_DELTA, a == 0 ? 0 : 1, 0);
            else
                ws.e.egk(a - 5, 0);
            if (a)
                ws.e.bypass(val < 0 ? 1 : 0);
        }
        int rc = 0;
        if (cbf_luma)
            rc = write_residual(ws, x0, y0, log2_size, 0);
        if (rc)
            return rc;
        if (any_chroma) {
            if (log2_size > 2) {
                if (my_cb)
                    rc = write_residual(ws, x0 >> 1, y0 >> 1,
                                        log2_size - 1, 1);
                if (!rc && my_cr)
                    rc = write_residual(ws, x0 >> 1, y0 >> 1,
                                        log2_size - 1, 2);
            } else {
                if (my_cb)
                    rc = write_residual(ws, x_base >> 1, y_base >> 1, 2, 1);
                if (!rc && my_cr)
                    rc = write_residual(ws, x_base >> 1, y_base >> 1, 2, 2);
            }
        }
        return rc;
    }
    return 0;
}

// ---- CU writing --------------------------------------------------------------
void write_merge_idx(WS& ws, int x0, int y0) {
    int idx = g_sp.merge_idx[idx4(x0, y0)];
    int c_max = g_sp.max_merge - 1;
    dec_w(ws, E_MERGE_IDX, 0, idx ? 1 : 0);
    if (idx) {
        for (int i = 0; i < idx - 1; i++)
            ws.e.bypass(1);
        if (idx < c_max)
            ws.e.bypass(0);
    }
}

void write_inter_part_mode(WS& ws, int part, int log2_size) {
    if (part == 0) {
        dec_w(ws, E_PART_MODE, 0, 1);
        return;
    }
    dec_w(ws, E_PART_MODE, 0, 0);
    int at_min = log2_size == g_sp.min_cb_log2;
    int amp = g_sp.amp_enabled && !at_min;
    int horizontal = part == 1 || part == 4 || part == 5;
    dec_w(ws, E_PART_MODE, 1, horizontal);
    if (at_min) {
        if (part == 1)
            return;
        if (log2_size == 3)
            return;
        dec_w(ws, E_PART_MODE, 2, part == 2 ? 1 : 0);
        return;
    }
    if (!amp)
        return;
    int sym = part == 1 || part == 2;
    dec_w(ws, E_PART_MODE, 3, sym);
    if (!sym)
        ws.e.bypass((part == 5 || part == 7) ? 1 : 0);
}

void write_mvd(WS& ws, int mx, int my) {
    int ax = mx < 0 ? -mx : mx, ay = my < 0 ? -my : my;
    dec_w(ws, E_MVD_G0, 0, ax > 0);
    dec_w(ws, E_MVD_G0, 0, ay > 0);
    if (ax > 0)
        dec_w(ws, E_MVD_G1, 0, ax > 1);
    if (ay > 0)
        dec_w(ws, E_MVD_G1, 0, ay > 1);
    const int vs[2] = {mx, my}, as[2] = {ax, ay};
    for (int i = 0; i < 2; i++)
        if (as[i] > 0) {
            if (as[i] > 1)
                ws.e.egk(as[i] - 2, 1);
            ws.e.bypass(vs[i] < 0 ? 1 : 0);
        }
}

void write_prediction_unit(WS& ws, int px, int py, int pw, int ph) {
    int64_t b = idx4(px, py);
    const int64_t plane4 = (int64_t)g_sp.h4 * g_sp.w4;
    int merge = g_sp.merge_flag[b];
    dec_w(ws, E_MERGE_FLAG, 0, merge);
    if (merge) {
        if (g_sp.max_merge > 1)
            write_merge_idx(ws, px, py);
        return;
    }
    int ipi;
    if (g_sp.is_b) {
        int r0 = g_sp.ref_idx[b];
        int r1 = g_sp.ref_idx[plane4 + b];
        ipi = (r0 >= 0 ? 1 : 0) | (r1 >= 0 ? 2 : 0);
        if (pw + ph != 12)
            dec_w(ws, E_INTER_DIR, ws.cu_depth, ipi == 3 ? 1 : 0);
        if (ipi != 3)
            dec_w(ws, E_INTER_DIR, 4, ipi == 2 ? 1 : 0);
    } else {
        ipi = 1;
    }
    for (int lx = 0; lx < 2; lx++) {
        if (!(ipi & (1 << lx)))
            continue;
        int nref = g_sp.n_ref[lx] - 1;
        int r = g_sp.ref_idx[lx * plane4 + b];
        if (nref > 0) {
            for (int k = 0; k < r; k++) {
                if (k < 2)
                    dec_w(ws, E_REF_IDX, k, 1);
                else
                    ws.e.bypass(1);
            }
            if (r < nref) {
                if (r < 2)
                    dec_w(ws, E_REF_IDX, r, 0);
                else
                    ws.e.bypass(0);
            }
        }
        if (!(lx == 1 && g_sp.mvd_l1_zero && ipi == 3))
            write_mvd(ws, g_sp.mvd[(lx * plane4 + b) * 2],
                      g_sp.mvd[(lx * plane4 + b) * 2 + 1]);
        dec_w(ws, E_MVP_FLAG, 0, g_sp.mvp_flag[lx * plane4 + b]);
    }
}

void write_intra_modes(WS& ws) {
    int n = ws.cu_part_mode == 3 ? 4 : 1;
    int pb = 1 << (ws.cu_log2 - (n == 4 ? 1 : 0));
    int modes[4], cands[4][3];
    for (int i = 0; i < n; i++) {
        int xb = ws.cu_x0 + (i & 1) * pb;
        int yb = ws.cu_y0 + (i >> 1) * pb;
        modes[i] = g_sp.intra_mode_y[idx4(xb, yb)];
        sp_intra_mpm(xb, yb, cands[i]);
    }
    for (int i = 0; i < n; i++) {
        int in = modes[i] == cands[i][0] || modes[i] == cands[i][1]
              || modes[i] == cands[i][2];
        dec_w(ws, E_PREV_INTRA, 0, in);
    }
    for (int i = 0; i < n; i++) {
        int mode = modes[i];
        const int* c = cands[i];
        int idx = mode == c[0] ? 0 : (mode == c[1] ? 1 : (mode == c[2] ? 2
                                                                       : -1));
        if (idx >= 0) {
            ws.e.bypass(idx ? 1 : 0);
            if (idx)
                ws.e.bypass(idx - 1);
        } else {
            int rem = mode;
            // subtract 1 for each candidate below mode (descending order)
            int s0 = c[0], s1 = c[1], s2 = c[2], t;
            if (s0 < s1) { t = s0; s0 = s1; s1 = t; }
            if (s1 < s2) { t = s1; s1 = s2; s2 = t; }
            if (s0 < s1) { t = s0; s0 = s1; s1 = t; }
            if (rem > s0) rem--;
            if (rem > s1) rem--;
            if (rem > s2) rem--;
            ws.e.bypass_bits(rem, 5);
        }
    }
    int mode_c = g_sp.intra_mode_c[idx4(ws.cu_x0, ws.cu_y0)];
    if (mode_c == modes[0]) {
        dec_w(ws, E_CHROMA_MODE, 0, 0);
    } else {
        static const int cand_c[4] = {0, 26, 10, 1};
        int idx = -1;
        for (int i = 0; i < 4; i++) {
            int eff = cand_c[i] == modes[0] ? 34 : cand_c[i];
            if (eff == mode_c && idx < 0)
                idx = i;
        }
        dec_w(ws, E_CHROMA_MODE, 0, 1);
        ws.e.bypass_bits(idx, 2);
    }
}

int write_coding_unit(WS& ws, int x0, int y0, int log2_size, int depth) {
    int64_t b = idx4(x0, y0);
    ws.cu_x0 = x0;
    ws.cu_y0 = y0;
    ws.cu_log2 = log2_size;
    ws.cu_depth = depth;
    ws.cu_pred_mode = g_sp.cu_pred_mode[b];
    ws.cu_tqb = g_sp.tq_bypass[b];
    ws.cu_intra_split = 0;

    if (g_sp.tq_bypass_enabled)
        dec_w(ws, E_TQ_BYPASS, 0, ws.cu_tqb);

    if (!g_sp.is_i) {
        int skip = g_sp.skip_flag[b];
        int inc = 0;
        if (sp_available(x0, y0, x0 - 1, y0))
            inc += g_sp.skip_flag[idx4(x0 - 1, y0)] ? 1 : 0;
        if (sp_available(x0, y0, x0, y0 - 1))
            inc += g_sp.skip_flag[idx4(x0, y0 - 1)] ? 1 : 0;
        dec_w(ws, E_SKIP, inc, skip);
        if (skip) {
            ws.cu_pred_mode = 0;
            if (g_sp.max_merge > 1)
                write_merge_idx(ws, x0, y0);
            return 0;
        }
        dec_w(ws, E_PRED_MODE, 0, ws.cu_pred_mode);
    }

    if (ws.cu_pred_mode == 0) {
        // inter CU
        int part = g_sp.part_mode[b];
        ws.cu_part_mode = part;
        write_inter_part_mode(ws, part, log2_size);
        int size = 1 << log2_size;
        int s = size, h2 = s >> 1, q = s >> 2;
        int geo[4][4];
        int n_pu = 1;
        switch (part) {
        case 0:
            geo[0][0] = x0; geo[0][1] = y0; geo[0][2] = s; geo[0][3] = s;
            break;
        case 1:
            geo[0][0] = x0; geo[0][1] = y0; geo[0][2] = s; geo[0][3] = h2;
            geo[1][0] = x0; geo[1][1] = y0 + h2; geo[1][2] = s;
            geo[1][3] = h2;
            n_pu = 2;
            break;
        case 2:
            geo[0][0] = x0; geo[0][1] = y0; geo[0][2] = h2; geo[0][3] = s;
            geo[1][0] = x0 + h2; geo[1][1] = y0; geo[1][2] = h2;
            geo[1][3] = s;
            n_pu = 2;
            break;
        case 3:
            geo[0][0] = x0; geo[0][1] = y0; geo[0][2] = h2; geo[0][3] = h2;
            geo[1][0] = x0 + h2; geo[1][1] = y0; geo[1][2] = h2;
            geo[1][3] = h2;
            geo[2][0] = x0; geo[2][1] = y0 + h2; geo[2][2] = h2;
            geo[2][3] = h2;
            geo[3][0] = x0 + h2; geo[3][1] = y0 + h2; geo[3][2] = h2;
            geo[3][3] = h2;
            n_pu = 4;
            break;
        case 4:
            geo[0][0] = x0; geo[0][1] = y0; geo[0][2] = s; geo[0][3] = q;
            geo[1][0] = x0; geo[1][1] = y0 + q; geo[1][2] = s;
            geo[1][3] = s - q;
            n_pu = 2;
            break;
        case 5:
            geo[0][0] = x0; geo[0][1] = y0; geo[0][2] = s; geo[0][3] = s - q;
            geo[1][0] = x0; geo[1][1] = y0 + s - q; geo[1][2] = s;
            geo[1][3] = q;
            n_pu = 2;
            break;
        case 6:
            geo[0][0] = x0; geo[0][1] = y0; geo[0][2] = q; geo[0][3] = s;
            geo[1][0] = x0 + q; geo[1][1] = y0; geo[1][2] = s - q;
            geo[1][3] = s;
            n_pu = 2;
            break;
        default:
            geo[0][0] = x0; geo[0][1] = y0; geo[0][2] = s - q; geo[0][3] = s;
            geo[1][0] = x0 + s - q; geo[1][1] = y0; geo[1][2] = q;
            geo[1][3] = s;
            n_pu = 2;
            break;
        }
        for (int p = 0; p < n_pu; p++)
            write_prediction_unit(ws, geo[p][0], geo[p][1], geo[p][2],
                                  geo[p][3]);
        int merge = g_sp.merge_flag[b];
        int has_coeff =
            region_any(g_sp.coeff_y, g_sp.pic_w, x0, y0, size)
            || region_any(g_sp.coeff_cb, g_sp.pic_w >> 1, x0 >> 1, y0 >> 1,
                          size >> 1)
            || region_any(g_sp.coeff_cr, g_sp.pic_w >> 1, x0 >> 1, y0 >> 1,
                          size >> 1);
        if (!(part == 0 && merge))
            dec_w(ws, E_RQT_ROOT, 0, has_coeff);
        else if (!has_coeff)
            return 7;  // merge 2Nx2N without residual must be skip
        if (has_coeff) {
            ws.cu_intra_split = 0;
            ws.cu_max_td = g_sp.mtd_inter;
            return write_transform_tree(ws, x0, y0, x0, y0, log2_size, 0, 0,
                                        1, 1);
        }
        return 0;
    }

    // intra CU
    int part = g_sp.part_mode[b];
    ws.cu_part_mode = part;
    int part_nxn = part == 3;
    ws.cu_intra_split = part_nxn ? 1 : 0;
    if (log2_size == g_sp.min_cb_log2)
        dec_w(ws, E_PART_MODE, 0, part_nxn ? 0 : 1);
    else if (part_nxn)
        return 8;
    write_intra_modes(ws);
    ws.cu_max_td = g_sp.mtd_intra + ws.cu_intra_split;
    return write_transform_tree(ws, x0, y0, x0, y0, log2_size, 0, 0, 1, 1);
}

int write_coding_quadtree(WS& ws, int x0, int y0, int log2_size, int depth) {
    const int w = g_sp.pic_w, h = g_sp.pic_h;
    bool in_pic = x0 + (1 << log2_size) <= w && y0 + (1 << log2_size) <= h;
    if (g_sp.cu_qp_delta_enabled
        && log2_size >= g_sp.ctb_log2 - g_sp.diff_cu_qp_delta_depth) {
        ws.qp_coded = 0;
        ws.qp_delta = 0;
        ws.qp_y_pred = ws.last_cu_qp;
    }
    int split = g_sp.ct_depth[idx4(x0, y0)] > depth;
    if (in_pic && log2_size > g_sp.min_cb_log2) {
        int inc = 0;
        if (sp_available(x0, y0, x0 - 1, y0))
            inc += g_sp.ct_depth[idx4(x0 - 1, y0)] > depth ? 1 : 0;
        if (sp_available(x0, y0, x0, y0 - 1))
            inc += g_sp.ct_depth[idx4(x0, y0 - 1)] > depth ? 1 : 0;
        dec_w(ws, E_SPLIT_CU, inc, split);
    } else if (log2_size > g_sp.min_cb_log2) {
        split = 1;  // forced split at picture boundary
    }
    if (split) {
        int half = 1 << (log2_size - 1);
        int x1 = x0 + half, y1 = y0 + half;
        int rc = write_coding_quadtree(ws, x0, y0, log2_size - 1, depth + 1);
        if (!rc && x1 < w)
            rc = write_coding_quadtree(ws, x1, y0, log2_size - 1, depth + 1);
        if (!rc && y1 < h)
            rc = write_coding_quadtree(ws, x0, y1, log2_size - 1, depth + 1);
        if (!rc && x1 < w && y1 < h)
            rc = write_coding_quadtree(ws, x1, y1, log2_size - 1, depth + 1);
        return rc;
    }
    int rc = write_coding_unit(ws, x0, y0, log2_size, depth);
    ws.last_cu_qp = g_sp.qp_y[idx4(x0, y0)];
    return rc;
}

}  // namespace

extern "C" {

// Write one CTU's bins. Engine io: [low, range, bits_outstanding,
// first_bit]; io_qp: [qp_y_pred, last_cu_qp, is_coded, delta]. Returns 0 on
// success; >0 = plan inconsistency; <0 = buffer overflow.
int tc_write_ctu(uint8_t* buf, int64_t cap_bits, int64_t* io_bitpos,
                 int32_t* io_eng, uint8_t* ctx, int32_t ctb_addr_rs,
                 int32_t* io_qp) {
    WS ws;
    ws.e.buf = buf;
    ws.e.cap_bits = cap_bits;
    ws.e.bitpos = *io_bitpos;
    ws.e.low = (uint32_t)io_eng[0];
    ws.e.range = (uint32_t)io_eng[1];
    ws.e.bits_outstanding = io_eng[2];
    ws.e.first_bit = io_eng[3];
    ws.e.ctx = ctx;
    ws.e.err = 0;
    ws.qp_y_pred = io_qp[0];
    ws.last_cu_qp = io_qp[1];
    ws.qp_coded = io_qp[2];
    ws.qp_delta = io_qp[3];

    int rx = ctb_addr_rs % g_sp.wc, ry = ctb_addr_rs / g_sp.wc;
    if (g_sp.slice_idx[(int64_t)ry * g_sp.wc + rx] != g_sp.slice_number)
        return 9;
    if (g_sp.sao_luma || g_sp.sao_chroma)
        write_sao(ws, rx, ry);
    int rc = write_coding_quadtree(ws, rx << g_sp.ctb_log2,
                                   ry << g_sp.ctb_log2, g_sp.ctb_log2, 0);
    if (ws.e.err)
        return -1;
    *io_bitpos = ws.e.bitpos;
    io_eng[0] = (int32_t)ws.e.low;
    io_eng[1] = (int32_t)ws.e.range;
    io_eng[2] = ws.e.bits_outstanding;
    io_eng[3] = ws.e.first_bit;
    io_qp[0] = ws.qp_y_pred;
    io_qp[1] = ws.last_cu_qp;
    io_qp[2] = ws.qp_coded;
    io_qp[3] = ws.qp_delta;
    return rc;
}

// Terminate bin; bit=1 also flushes the engine (end of slice / substream).
int tc_write_terminate(uint8_t* buf, int64_t cap_bits, int64_t* io_bitpos,
                       int32_t* io_eng, int32_t bit) {
    WS ws;
    ws.e.buf = buf;
    ws.e.cap_bits = cap_bits;
    ws.e.bitpos = *io_bitpos;
    ws.e.low = (uint32_t)io_eng[0];
    ws.e.range = (uint32_t)io_eng[1];
    ws.e.bits_outstanding = io_eng[2];
    ws.e.first_bit = io_eng[3];
    ws.e.ctx = nullptr;
    ws.e.err = 0;
    ws.e.terminate(bit);
    if (ws.e.err)
        return -1;
    *io_bitpos = ws.e.bitpos;
    io_eng[0] = (int32_t)ws.e.low;
    io_eng[1] = (int32_t)ws.e.range;
    io_eng[2] = ws.e.bits_outstanding;
    io_eng[3] = ws.e.first_bit;
    return 0;
}

}  // extern "C"
