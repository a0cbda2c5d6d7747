// Native full-CTU CABAC parse: the complete coding_tree_unit() walk (SAO,
// coding_quadtree, coding_unit, intra MPM, inter PUs with merge/AMVP/TMVP
// derivation, transform tree, residual_coding) writing directly into the
// PicturePlan tensors.
//
// This is the C++ twin of decode/ctu_parse.py + decode/mvp.py (which stay as
// the pure-Python oracle; parity asserted by tests/test_native.py and the
// stream-corpus md5 suite). The reference's analogue is the Read-verb syntax
// walk (turing/SyntaxCtu.hpp + turing/Read.h) with Snake neighbour storage —
// here neighbour state is read from the dense plan tensors instead.
//
// Spec clauses: 7.3.8 (syntax), 9.3.3 (binarization), 9.3.4 (contexts),
// 8.5.3 (motion derivation), 8.6.1 (QP derivation).
//
// Gated features (Python fallback, arranged by the loader): PCM
// (pcm_enabled_flag), non-4:2:0 chroma.
#include <cstdint>
#include <cstring>
#include <initializer_list>

#include "core.h"

SP g_sp_default;
thread_local SP* g_sp_ptr = &g_sp_default;

namespace {

// partition modes (hevc/types.py:108-115)
enum {
    P_2Nx2N = 0, P_2NxN = 1, P_Nx2N = 2, P_NxN = 3,
    P_2NxnU = 4, P_2NxnD = 5, P_nLx2N = 6, P_nRx2N = 7
};

// SP / Cand / motion helpers shared via core.h

// transient per-CU info
struct CU {
    int x0, y0, log2, depth;
    int pred_mode;   // 0 inter, 1 intra
    int part_mode;
    int skip, tqb;
    int intra_mode0;     // first luma mode (chroma DM)
    int max_trafo_depth;
    int rec_idx;         // index into cu_rec (to fill n_tus)
};

struct PS {
    Engine e;
    uint8_t* ctx;
    // QP chain (io)
    int qp_y_pred, last_cu_qp, qp_coded, qp_delta;
    // id counters (io): [cu, pu, tu]
    int32_t* ids;
    // records
    int32_t *cu_rec, *tu_rec, *counts;  // counts: [n_cu, n_tu]
    CU cu;
    int last_pu_merge;
    int err;
};

inline int dec_d(PS& ps, int elem, int inc) {
    return ps.e.decode_decision(ps.ctx, g_sp.off[elem] + inc);
}

// ---- plan fills -----------------------------------------------------------
template <typename T>
inline void fill4(T* base, int x0, int y0, int size, T v) {
    int bx = x0 >> 2, by = y0 >> 2, n = size >> 2;
    for (int y = 0; y < n; y++) {
        T* row = base + (int64_t)(by + y) * g_sp.w4 + bx;
        for (int x = 0; x < n; x++)
            row[x] = v;
    }
}

template <typename T>
inline void fill4wh(T* base, int x0, int y0, int w, int h, T v) {
    int bx = x0 >> 2, by = y0 >> 2, nw = w >> 2, nh = h >> 2;
    for (int y = 0; y < nh; y++) {
        T* row = base + (int64_t)(by + y) * g_sp.w4 + bx;
        for (int x = 0; x < nw; x++)
            row[x] = v;
    }
}

}  // namespace

// ---- availability (spec 6.4.1; geometry.py:80-106) ------------------------
bool sp_available(int x_cur, int y_cur, int x_nb, int y_nb) {
    if (x_nb < 0 || y_nb < 0 || x_nb >= g_sp.pic_w || y_nb >= g_sp.pic_h)
        return false;
    if (g_sp.zscan[(int64_t)(y_nb >> 2) * g_sp.w4 + (x_nb >> 2)] >
        g_sp.zscan[(int64_t)(y_cur >> 2) * g_sp.w4 + (x_cur >> 2)])
        return false;
    int cc = (y_cur >> g_sp.ctb_log2) * g_sp.wc + (x_cur >> g_sp.ctb_log2);
    int nc = (y_nb >> g_sp.ctb_log2) * g_sp.wc + (x_nb >> g_sp.ctb_log2);
    if (g_sp.slice_idx[cc] != g_sp.slice_idx[nc])
        return false;
    if (g_sp.tile_id[cc] != g_sp.tile_id[nc])
        return false;
    return true;
}

namespace {

// ---- SAO (spec 7.3.8.3; ctu_parse.parse_sao) -------------------------------
void parse_sao(PS& ps, int rx, int ry) {
    int merge_left = 0, merge_up = 0;
    int64_t cur = (int64_t)ry * g_sp.wc + rx;
    if (rx > 0) {
        bool same_tile = g_sp.tile_id[cur] == g_sp.tile_id[cur - 1];
        if (g_sp.slice_idx[cur - 1] == g_sp.slice_number && same_tile)
            merge_left = dec_d(ps, E_SAO_MERGE, 0);
    }
    if (!merge_left && ry > 0) {
        bool same_tile = g_sp.tile_id[cur] == g_sp.tile_id[cur - g_sp.wc];
        if (g_sp.slice_idx[cur - g_sp.wc] == g_sp.slice_number && same_tile)
            merge_up = dec_d(ps, E_SAO_MERGE, 0);
    }
    if (merge_left || merge_up) {
        int64_t src = merge_left ? cur - 1 : cur - g_sp.wc;
        std::memcpy(g_sp.sao_type + cur * 3, g_sp.sao_type + src * 3, 3);
        std::memcpy(g_sp.sao_class + cur * 3, g_sp.sao_class + src * 3, 3);
        std::memcpy(g_sp.sao_offsets + cur * 12, g_sp.sao_offsets + src * 12, 12);
        return;
    }
    for (int c_idx = 0; c_idx < 3; c_idx++) {
        if (c_idx == 0 && !g_sp.sao_luma)
            continue;
        if (c_idx > 0 && !g_sp.sao_chroma)
            continue;
        if (c_idx <= 1) {
            int t = 0;
            if (dec_d(ps, E_SAO_TYPE, 0))
                t = ps.e.decode_bypass() ? 2 : 1;
            g_sp.sao_type[cur * 3 + c_idx] = (uint8_t)t;
            if (c_idx == 1)
                g_sp.sao_type[cur * 3 + 2] = (uint8_t)t;
        }
        int t = g_sp.sao_type[cur * 3 + c_idx];
        if (t == 0)
            continue;
        int bd = c_idx == 0 ? g_sp.bit_depth_y : g_sp.bit_depth_c;
        int c_max = (1 << ((bd < 10 ? bd : 10) - 5)) - 1;
        int offs[4];
        for (int i = 0; i < 4; i++) {
            int v = 0;
            while (v < c_max && ps.e.decode_bypass())
                v++;
            offs[i] = v;
        }
        if (t == 1) {  // band
            for (int i = 0; i < 4; i++)
                if (offs[i] && ps.e.decode_bypass())
                    offs[i] = -offs[i];
            g_sp.sao_class[cur * 3 + c_idx] =
                (uint8_t)ps.e.decode_bypass_bits(5);
        } else {  // edge
            offs[2] = -offs[2];
            offs[3] = -offs[3];
            if (c_idx <= 1) {
                int eo = (int)ps.e.decode_bypass_bits(2);
                g_sp.sao_class[cur * 3 + c_idx] = (uint8_t)eo;
                if (c_idx == 1)
                    g_sp.sao_class[cur * 3 + 2] = (uint8_t)eo;
            }
        }
        for (int i = 0; i < 4; i++)
            g_sp.sao_offsets[cur * 12 + c_idx * 4 + i] = (int8_t)offs[i];
    }
}

// ---- QP derivation (spec 8.6.1; ctu_parse._derive_qp) ----------------------
int derive_qp(PS& ps, int x0, int y0) {
    if (!g_sp.cu_qp_delta_enabled)
        return g_sp.slice_qp_y;
    int log2_min_qg = g_sp.ctb_log2 - g_sp.diff_cu_qp_delta_depth;
    int mask = ~((1 << log2_min_qg) - 1);
    int x_qg = x0 & mask, y_qg = y0 & mask;
    int ctb_mask = ~((1 << g_sp.ctb_log2) - 1);
    int prev = ps.qp_y_pred;
    int a = prev, b = prev;
    // left neighbour
    if (sp_available(x_qg, y_qg, x_qg - 1, y_qg)
        && ((x_qg - 1) & ctb_mask) == (x_qg & ctb_mask)
        && (y_qg & ctb_mask) == (y_qg & ctb_mask))
        a = g_sp.qp_y[idx4(x_qg - 1, y_qg)];
    if (sp_available(x_qg, y_qg, x_qg, y_qg - 1)
        && (x_qg & ctb_mask) == (x_qg & ctb_mask)
        && ((y_qg - 1) & ctb_mask) == (y_qg & ctb_mask))
        b = g_sp.qp_y[idx4(x_qg, y_qg - 1)];
    int qp_pred = (a + b + 1) >> 1;
    int m = 52 + g_sp.qp_bd_offset_y;
    int qp = ((qp_pred + ps.qp_delta + 52 + 2 * g_sp.qp_bd_offset_y) % m)
             - g_sp.qp_bd_offset_y;
    return qp;
}

}  // namespace

// ---- motion candidates (spec 8.5.3; decode/mvp.py) -------------------------

// spec 8.5.3.1.8 MV scaling
void mv_scale(int mx, int my, int tb, int td, int* ox, int* oy) {
    tb = clip3i(-128, 127, tb);
    td = clip3i(-128, 127, td);
    int atd = td < 0 ? -td : td;
    int tx = td >= 0 ? (16384 + (atd >> 1)) / td
                     : -((16384 + (atd >> 1)) / atd);
    int ds = clip3i(-4096, 4095, (tb * tx + 32) >> 6);
    int c[2] = {mx, my}, o[2];
    for (int i = 0; i < 2; i++) {
        int64_t v = (int64_t)ds * c[i];
        int64_t av = v < 0 ? -v : v;
        int64_t r = (av + 127) >> 8;
        o[i] = (int)clip3i(-32768, 32767, (int)(v >= 0 ? r : -r));
    }
    *ox = o[0];
    *oy = o[1];
}

// neighbour motion per prediction-block availability (mvp._nb_motion).
// cb = {x_cb, y_cb, n_cbs, n_pbw, n_pbh, part_idx} or null.
bool sp_nb_motion(int x_cur, int y_cur, int x_nb, int y_nb, const int* cb,
               Cand* out) {
    bool same_cb = false;
    if (cb) {
        same_cb = cb[0] <= x_nb && x_nb < cb[0] + cb[2]
               && cb[1] <= y_nb && y_nb < cb[1] + cb[2];
    }
    if (same_cb) {
        if ((cb[3] << 1) == cb[2] && (cb[4] << 1) == cb[2] && cb[5] == 1
            && (cb[1] + cb[4] <= y_nb || cb[0] + cb[3] <= x_nb))
            return false;
    } else if (!sp_available(x_cur, y_cur, x_nb, y_nb)) {
        return false;
    }
    int64_t b = idx4(x_nb, y_nb);
    if (g_sp.cu_pred_mode[b] == 1)
        return false;
    int r0 = g_sp.ref_idx[b];
    int r1 = g_sp.ref_idx[(int64_t)g_sp.h4 * g_sp.w4 + b];
    out->pf0 = r0 >= 0;
    out->pf1 = r1 >= 0;
    out->mv00 = g_sp.mv[b * 2];
    out->mv01 = g_sp.mv[b * 2 + 1];
    out->mv10 = g_sp.mv[((int64_t)g_sp.h4 * g_sp.w4 + b) * 2];
    out->mv11 = g_sp.mv[((int64_t)g_sp.h4 * g_sp.w4 + b) * 2 + 1];
    out->r0 = r0;
    out->r1 = r1;
    return true;
}

// spec 8.5.3.1.8 collocated MV (mvp._col_mv). Returns found flag.
bool col_mv(int x_col, int y_col, int tl, int tref, int* ox, int* oy) {
    if (!g_sp.has_col)
        return false;
    // 16x16-aligned collocated block, in 4x4-block units
    int bx = (x_col >> 4) << 2, by = (y_col >> 4) << 2;
    if (by >= g_sp.h4 || bx >= g_sp.w4)
        return false;
    int64_t b = (int64_t)by * g_sp.w4 + bx;
    if (g_sp.col_pm[b] == 1)
        return false;
    int64_t plane = (int64_t)g_sp.h4 * g_sp.w4;
    bool f0 = g_sp.col_ref_idx[b] >= 0;
    bool f1 = g_sp.col_ref_idx[plane + b] >= 0;
    if (!f0 && !f1)
        return false;
    int n;
    if (!f0)
        n = 1;
    else if (!f1)
        n = 0;
    else if (g_sp.no_backward)
        n = tl;
    else
        n = g_sp.col_from_l0;
    int mx = g_sp.col_mv[(n * plane + b) * 2];
    int my = g_sp.col_mv[(n * plane + b) * 2 + 1];
    int col_ref_poc = g_sp.col_ref_poc[n * plane + b];
    bool col_lt = g_sp.col_ref_lt[n * plane + b] != 0;
    bool target_lt = g_sp.ref_lt[tl][tref] != 0;
    if (col_lt != target_lt)
        return false;
    int curr_diff = g_sp.cur_poc - g_sp.ref_pocs[tl][tref];
    int col_diff = g_sp.col_poc - col_ref_poc;
    if (target_lt || col_diff == curr_diff || col_diff == 0) {
        *ox = mx;
        *oy = my;
        return true;
    }
    mv_scale(mx, my, curr_diff, col_diff, ox, oy);
    return true;
}

// spec 8.5.3.1.7 temporal candidate (mvp._tmvp)
bool tmvp(int x_pb, int y_pb, int w, int h, int tl, int tref,
          int* ox, int* oy) {
    if (!g_sp.tmvp_enabled || !g_sp.has_col)
        return false;
    int x_br = x_pb + w, y_br = y_pb + h;
    if ((y_pb >> g_sp.ctb_log2) == (y_br >> g_sp.ctb_log2)
        && y_br < g_sp.pic_h && x_br < g_sp.pic_w) {
        if (col_mv(x_br, y_br, tl, tref, ox, oy))
            return true;
    }
    return col_mv(x_pb + (w >> 1), y_pb + (h >> 1), tl, tref, ox, oy);
}

// merge candidate list (spec 8.5.3.1.2; mvp.merge_candidates). Fills cands
// up to `need` entries, returns count (always == need).
int sp_merge_candidates(int x_cb, int y_cb, int cb_size, int x_pb, int y_pb,
                     int w, int h, int part_idx, int part_mode, int need,
                     Cand* cands) {
    if (g_sp.log2_pml > 2 && cb_size == 8) {
        x_pb = x_cb;
        y_pb = y_cb;
        w = h = cb_size;
        part_idx = 0;
    }
    int n = 0;
    int cb[6] = {x_cb, y_cb, cb_size, w, h, part_idx};

    auto region_excl = [&](int xn, int yn) {
        return ((x_pb >> g_sp.log2_pml) == (xn >> g_sp.log2_pml))
            && ((y_pb >> g_sp.log2_pml) == (yn >> g_sp.log2_pml));
    };

    Cand a1, b1, b0, a0, b2;
    bool has_a1 = false, has_b1 = false;

    // A1
    bool excl = part_idx == 1 && (part_mode == P_Nx2N || part_mode == P_nLx2N
                                  || part_mode == P_nRx2N);
    if (!excl && !region_excl(x_pb - 1, y_pb + h - 1))
        has_a1 = sp_nb_motion(x_pb, y_pb, x_pb - 1, y_pb + h - 1, cb, &a1);
    if (has_a1) {
        cands[n++] = a1;
        if (n >= need)
            return n;
    }
    // B1
    excl = part_idx == 1 && (part_mode == P_2NxN || part_mode == P_2NxnU
                             || part_mode == P_2NxnD);
    if (!excl && !region_excl(x_pb + w - 1, y_pb - 1))
        has_b1 = sp_nb_motion(x_pb, y_pb, x_pb + w - 1, y_pb - 1, cb, &b1);
    if (has_b1 && !(has_a1 && b1.equal(a1))) {
        cands[n++] = b1;
        if (n >= need)
            return n;
    }
    // B0
    if (!region_excl(x_pb + w, y_pb - 1)
        && sp_nb_motion(x_pb, y_pb, x_pb + w, y_pb - 1, cb, &b0)
        && !(has_b1 && b0.equal(b1))) {
        cands[n++] = b0;
        if (n >= need)
            return n;
    }
    // A0
    if (!region_excl(x_pb - 1, y_pb + h)
        && sp_nb_motion(x_pb, y_pb, x_pb - 1, y_pb + h, cb, &a0)
        && !(has_a1 && a0.equal(a1))) {
        cands[n++] = a0;
        if (n >= need)
            return n;
    }
    // B2 (only if fewer than 4 spatial so far)
    if (n < 4) {
        if (!region_excl(x_pb - 1, y_pb - 1)
            && sp_nb_motion(x_pb, y_pb, x_pb - 1, y_pb - 1, cb, &b2)
            && !(has_a1 && b2.equal(a1)) && !(has_b1 && b2.equal(b1))) {
            cands[n++] = b2;
            if (n >= need)
                return n;
        }
    }
    // temporal
    if (n < need) {
        int m0x, m0y, m1x, m1y;
        bool f0 = tmvp(x_pb, y_pb, w, h, 0, 0, &m0x, &m0y);
        bool f1 = g_sp.is_b ? tmvp(x_pb, y_pb, w, h, 1, 0, &m1x, &m1y) : false;
        if (f0 || f1) {
            Cand t;
            t.pf0 = f0;
            t.pf1 = f1;
            t.mv00 = f0 ? m0x : 0;
            t.mv01 = f0 ? m0y : 0;
            t.mv10 = f1 ? m1x : 0;
            t.mv11 = f1 ? m1y : 0;
            t.r0 = f0 ? 0 : -1;
            t.r1 = f1 ? 0 : -1;
            cands[n++] = t;
        }
    }
    // combined bi-predictive
    if (g_sp.is_b && n > 1 && n < need) {
        static const int comb[12][2] = {
            {0, 1}, {1, 0}, {0, 2}, {2, 0}, {1, 2}, {2, 1},
            {0, 3}, {3, 0}, {1, 3}, {3, 1}, {2, 3}, {3, 2}};
        int n_orig = n;
        for (int i = 0; i < 12; i++) {
            if (n >= need)
                break;
            int k = comb[i][0], l = comb[i][1];
            if (k >= n_orig || l >= n_orig)
                break;
            const Cand &c0 = cands[k], &c1 = cands[l];
            if (!(c0.pf0 && c1.pf1))
                continue;
            int poc0 = g_sp.ref_pocs[0][c0.r0];
            int poc1 = g_sp.ref_pocs[1][c1.r1];
            if (poc0 == poc1 && c0.mv00 == c1.mv10 && c0.mv01 == c1.mv11)
                continue;
            Cand t;
            t.pf0 = 1;
            t.pf1 = 1;
            t.mv00 = c0.mv00;
            t.mv01 = c0.mv01;
            t.mv10 = c1.mv10;
            t.mv11 = c1.mv11;
            t.r0 = c0.r0;
            t.r1 = c1.r1;
            cands[n++] = t;
        }
    }
    // zero candidates
    int num_ref = g_sp.is_b ? (g_sp.n_ref[0] < g_sp.n_ref[1] ? g_sp.n_ref[0] : g_sp.n_ref[1])
                         : g_sp.n_ref[0];
    int zero_idx = 0;
    while (n < need) {
        int r = zero_idx < num_ref ? zero_idx : 0;
        Cand t;
        t.mv00 = t.mv01 = t.mv10 = t.mv11 = 0;
        if (g_sp.is_b) {
            t.pf0 = t.pf1 = 1;
            t.r0 = t.r1 = r;
        } else {
            t.pf0 = 1;
            t.pf1 = 0;
            t.r0 = r;
            t.r1 = -1;
        }
        cands[n++] = t;
        zero_idx++;
    }
    return n;
}

// AMVP (spec 8.5.3.1.5/6; mvp.amvp): two predictors for (lx, ref_idx)
void sp_amvp(int x_pb, int y_pb, int w, int h, int lx, int ref_idx,
          const int* cb, int out[2][2]) {
    int target_poc = g_sp.ref_pocs[lx][ref_idx];
    bool target_lt = g_sp.ref_lt[lx][ref_idx] != 0;

    // pass 1: same reference picture
    auto try_same = [&](const Cand* m, int* ox, int* oy) -> bool {
        if (!m)
            return false;
        for (int i = 0; i < 2; i++) {
            int l = i == 0 ? lx : 1 - lx;
            if (m->pf(l)) {
                int r = m->ref(l);
                if (r < g_sp.n_ref[l] && g_sp.ref_pocs[l][r] == target_poc
                    && (g_sp.ref_lt[l][r] != 0) == target_lt) {
                    *ox = m->mvx(l);
                    *oy = m->mvy(l);
                    return true;
                }
            }
        }
        return false;
    };
    // pass 2: any reference, scaled (short-term only)
    auto try_scaled = [&](const Cand* m, int* ox, int* oy) -> bool {
        if (!m)
            return false;
        for (int i = 0; i < 2; i++) {
            int l = i == 0 ? lx : 1 - lx;
            if (m->pf(l)) {
                int r = m->ref(l);
                if (r >= g_sp.n_ref[l])
                    continue;
                bool nb_lt = g_sp.ref_lt[l][r] != 0;
                if (nb_lt != target_lt)
                    continue;
                int nb_poc = g_sp.ref_pocs[l][r];
                if (target_lt) {
                    *ox = m->mvx(l);
                    *oy = m->mvy(l);
                    return true;
                }
                int tb = g_sp.cur_poc - target_poc;
                int td = g_sp.cur_poc - nb_poc;
                if (td == tb || td == 0) {
                    *ox = m->mvx(l);
                    *oy = m->mvy(l);
                    return true;
                }
                mv_scale(m->mvx(l), m->mvy(l), tb, td, ox, oy);
                return true;
            }
        }
        return false;
    };

    Cand a0c, a1c, b0c, b1c, b2c;
    const Cand* a0 =
        sp_nb_motion(x_pb, y_pb, x_pb - 1, y_pb + h, cb, &a0c) ? &a0c : nullptr;
    const Cand* a1 = sp_nb_motion(x_pb, y_pb, x_pb - 1, y_pb + h - 1, cb, &a1c)
                         ? &a1c : nullptr;
    bool avail_a_any = a0 || a1;
    int ax = 0, ay = 0;
    bool has_a = false;
    for (const Cand* m : {a0, a1}) {
        if (try_same(m, &ax, &ay)) {
            has_a = true;
            break;
        }
    }
    if (!has_a) {
        for (const Cand* m : {a0, a1}) {
            if (try_scaled(m, &ax, &ay)) {
                has_a = true;
                break;
            }
        }
    }

    const Cand* b0 =
        sp_nb_motion(x_pb, y_pb, x_pb + w, y_pb - 1, cb, &b0c) ? &b0c : nullptr;
    const Cand* b1 = sp_nb_motion(x_pb, y_pb, x_pb + w - 1, y_pb - 1, cb, &b1c)
                         ? &b1c : nullptr;
    const Cand* b2 =
        sp_nb_motion(x_pb, y_pb, x_pb - 1, y_pb - 1, cb, &b2c) ? &b2c : nullptr;
    int bx = 0, by = 0;
    bool has_b = false;
    for (const Cand* m : {b0, b1, b2}) {
        if (try_same(m, &bx, &by)) {
            has_b = true;
            break;
        }
    }
    if (!avail_a_any) {
        // scaled B pass only when no A neighbour exists at all
        if (has_b) {
            ax = bx;
            ay = by;
            has_a = true;
            has_b = false;
        }
        for (const Cand* m : {b0, b1, b2}) {
            int nx, ny;
            if (try_scaled(m, &nx, &ny)) {
                if (!has_a) {
                    ax = nx;
                    ay = ny;
                    has_a = true;
                } else if ((nx != ax || ny != ay) && !has_b) {
                    bx = nx;
                    by = ny;
                    has_b = true;
                }
                break;
            }
        }
    }

    int n = 0;
    if (has_a) {
        out[n][0] = ax;
        out[n][1] = ay;
        n++;
    }
    if (has_b && (n == 0 || bx != out[0][0] || by != out[0][1])) {
        out[n][0] = bx;
        out[n][1] = by;
        n++;
    }
    if (n < 2) {
        int tx, ty;
        if (tmvp(x_pb, y_pb, w, h, lx, ref_idx, &tx, &ty)) {
            out[n][0] = tx;
            out[n][1] = ty;
            n++;
        }
    }
    while (n < 2) {
        out[n][0] = 0;
        out[n][1] = 0;
        n++;
    }
}

namespace {

// ---- prediction unit (spec 7.3.8.6; ctu_parse.prediction_unit) ------------
void prediction_unit(PS& ps, int x0, int y0, int w, int h, int part_idx,
                     bool merge_only) {
    CU& cu = ps.cu;
    bool merge = false;
    int merge_idx = 0, ipi = 1;
    int ref[2] = {0, 0};
    int mvd[2][2] = {{0, 0}, {0, 0}};
    int mvp_fl[2] = {0, 0};

    auto parse_merge_idx = [&]() -> int {
        int c_max = g_sp.max_merge - 1;
        if (!dec_d(ps, E_MERGE_IDX, 0))
            return 0;
        int v = 1;
        while (v < c_max && ps.e.decode_bypass())
            v++;
        return v;
    };
    auto parse_mvd = [&](int out[2]) {
        int gx0 = dec_d(ps, E_MVD_G0, 0);
        int gy0 = dec_d(ps, E_MVD_G0, 0);
        int gx1 = gx0 ? dec_d(ps, E_MVD_G1, 0) : 0;
        int gy1 = gy0 ? dec_d(ps, E_MVD_G1, 0) : 0;
        const int gs[2][2] = {{gx0, gx1}, {gy0, gy1}};
        for (int i = 0; i < 2; i++) {
            int v = 0;
            if (gs[i][0]) {
                v = 1;
                if (gs[i][1]) {
                    int64_t eg = ps.e.decode_egk(1);
                    if (eg < 0) {
                        ps.err = 2;
                        return;
                    }
                    v = 2 + (int)eg;
                }
                if (ps.e.decode_bypass())
                    v = -v;
            }
            out[i] = v;
        }
    };

    if (merge_only) {
        merge = true;
        if (g_sp.max_merge > 1)
            merge_idx = parse_merge_idx();
        ps.last_pu_merge = 1;
    } else {
        merge = dec_d(ps, E_MERGE_FLAG, 0) != 0;
        ps.last_pu_merge = merge;
        if (merge) {
            if (g_sp.max_merge > 1)
                merge_idx = parse_merge_idx();
        } else {
            ipi = 1;
            if (g_sp.is_b) {
                // inter_pred_idc (Table 9-36)
                ipi = 0;
                if (w + h != 12 && dec_d(ps, E_INTER_DIR, cu.depth))
                    ipi = 3;
                if (ipi != 3)
                    ipi = dec_d(ps, E_INTER_DIR, 4) ? 2 : 1;
            }
            for (int lx = 0; lx < 2; lx++) {
                if (!(ipi & (1 << lx)))
                    continue;
                int nref = g_sp.n_ref[lx] - 1;
                if (nref > 0) {
                    // TR: 2 ctx bins (inc 0 then 1), rest bypass
                    int v = 0;
                    while (v < nref) {
                        int b;
                        if (v < 2)
                            b = dec_d(ps, E_REF_IDX, v < 1 ? 0 : 1);
                        else
                            b = ps.e.decode_bypass();
                        if (!b)
                            break;
                        v++;
                    }
                    ref[lx] = v;
                }
                if (lx == 1 && g_sp.mvd_l1_zero && ipi == 3) {
                    mvd[1][0] = mvd[1][1] = 0;
                } else {
                    parse_mvd(mvd[lx]);
                    if (ps.err)
                        return;
                }
                mvp_fl[lx] = dec_d(ps, E_MVP_FLAG, 0);
            }
        }
    }

    int pu_id = ps.ids[1]++;
    fill4wh(g_sp.pu_id, x0, y0, w, h, pu_id);
    fill4wh(g_sp.merge_flag, x0, y0, w, h, (uint8_t)(merge ? 1 : 0));
    fill4wh(g_sp.merge_idx, x0, y0, w, h, (uint8_t)merge_idx);
    int64_t plane4 = (int64_t)g_sp.h4 * g_sp.w4;
    for (int lx = 0; lx < 2; lx++) {
        int bx = x0 >> 2, by = y0 >> 2, nw = w >> 2, nh = h >> 2;
        for (int y = 0; y < nh; y++) {
            int64_t row = lx * plane4 + (int64_t)(by + y) * g_sp.w4 + bx;
            for (int x = 0; x < nw; x++) {
                g_sp.mvd[(row + x) * 2] = (int16_t)mvd[lx][0];
                g_sp.mvd[(row + x) * 2 + 1] = (int16_t)mvd[lx][1];
                g_sp.mvp_flag[row + x] = (uint8_t)mvp_fl[lx];
            }
        }
    }

    // ---- motion derivation (the InterDeriver hook) ----
    int pf[2], mv_out[2][2], ridx[2];
    if (merge) {
        Cand cands[5];
        int need = merge_idx + 1;
        if (need > g_sp.max_merge)
            need = g_sp.max_merge;
        sp_merge_candidates(cu.x0, cu.y0, 1 << cu.log2, x0, y0, w, h, part_idx,
                         cu.part_mode, need, cands);
        const Cand& c = cands[merge_idx];
        pf[0] = c.pf0;
        pf[1] = c.pf1;
        mv_out[0][0] = c.mv00;
        mv_out[0][1] = c.mv01;
        mv_out[1][0] = c.mv10;
        mv_out[1][1] = c.mv11;
        ridx[0] = c.r0;
        ridx[1] = c.r1;
        if (w + h == 12 && pf[0] && pf[1]) {
            pf[1] = 0;
            ridx[1] = -1;
        }
    } else {
        pf[0] = ipi & 1;
        pf[1] = (ipi >> 1) & 1;
        mv_out[0][0] = mv_out[0][1] = mv_out[1][0] = mv_out[1][1] = 0;
        ridx[0] = ridx[1] = -1;
        int cb[6] = {cu.x0, cu.y0, 1 << cu.log2, w, h, part_idx};
        for (int l = 0; l < 2; l++) {
            if (!pf[l])
                continue;
            ridx[l] = ref[l];
            int mvps[2][2];
            sp_amvp(x0, y0, w, h, l, ref[l], cb, mvps);
            int* p = mvps[mvp_fl[l]];
            mv_out[l][0] = clip3i(-32768, 32767, p[0] + mvd[l][0]);
            mv_out[l][1] = clip3i(-32768, 32767, p[1] + mvd[l][1]);
        }
    }
    // write into plan
    for (int l = 0; l < 2; l++) {
        int bx = x0 >> 2, by = y0 >> 2, nw = w >> 2, nh = h >> 2;
        bool on = pf[l] && ridx[l] >= 0;
        int16_t wx = on ? (int16_t)mv_out[l][0] : 0;
        int16_t wy = on ? (int16_t)mv_out[l][1] : 0;
        int8_t wr = on ? (int8_t)ridx[l] : -1;
        int32_t wpoc = on ? g_sp.ref_pocs[l][ridx[l]] : 0;
        uint8_t wlt = on ? g_sp.ref_lt[l][ridx[l]] : 0;
        for (int y = 0; y < nh; y++) {
            int64_t row = l * plane4 + (int64_t)(by + y) * g_sp.w4 + bx;
            for (int x = 0; x < nw; x++) {
                g_sp.ref_idx[row + x] = wr;
                g_sp.mv[(row + x) * 2] = on ? wx : (int16_t)0;
                g_sp.mv[(row + x) * 2 + 1] = on ? wy : (int16_t)0;
                if (on) {
                    g_sp.ref_poc[row + x] = wpoc;
                    g_sp.ref_is_lt[row + x] = wlt;
                }
            }
        }
    }
}

// ---- intra modes (spec 8.4.2/8.4.3; ctu_parse._parse_intra_modes) ----------
}  // namespace

// candModeList derivation (spec 8.4.2; ctu_parse._intra_mpm) — shared
// with the encoder core
void sp_intra_mpm(int xb, int yb, int cands[3]) {
    sp_intra_mpm_n(xb, yb, cands);
}

// candModeList + neighbourModes (CandModeList.h:59-95: 1 when the two
// neighbour modes agree, else 2)
int sp_intra_mpm_n(int xb, int yb, int cands[3]) {
    auto cand = [&](int x_nb, int y_nb, bool is_above) -> int {
        if (!sp_available(xb, yb, x_nb, y_nb))
            return 1;
        int64_t b = idx4(x_nb, y_nb);
        if (g_sp.cu_pred_mode[b] != 1)
            return 1;
        if (g_sp.pcm_flag[b])
            return 1;
        if (is_above && (y_nb >> g_sp.ctb_log2) != (yb >> g_sp.ctb_log2))
            return 1;
        return g_sp.intra_mode_y[b];
    };
    int a = cand(xb - 1, yb, false);
    int b = cand(xb, yb - 1, true);
    if (a == b) {
        if (a < 2) {
            cands[0] = 0;
            cands[1] = 1;
            cands[2] = 26;
        } else {
            cands[0] = a;
            cands[1] = 2 + ((a + 29) % 32);
            cands[2] = 2 + ((a - 2 + 1) % 32);
        }
        return 1;
    }
    cands[0] = a;
    cands[1] = b;
    cands[2] = (a != 0 && b != 0) ? 0 : ((a != 1 && b != 1) ? 1 : 26);
    return 2;
}

namespace {

void parse_intra_modes(PS& ps) {
    CU& cu = ps.cu;
    int n = cu.part_mode == P_2Nx2N ? 1 : 4;
    int pb = 1 << (cu.log2 - (n == 1 ? 0 : 1));
    int prev_flags[4];
    for (int i = 0; i < n; i++)
        prev_flags[i] = dec_d(ps, E_PREV_INTRA, 0);
    int modes[4];
    for (int i = 0; i < n; i++) {
        int xb = cu.x0 + (i & 1) * pb;
        int yb = cu.y0 + (i >> 1) * pb;
        int cands[3];
        sp_intra_mpm(xb, yb, cands);
        int mode;
        if (prev_flags[i]) {
            int idx = 0;
            if (ps.e.decode_bypass())
                idx = ps.e.decode_bypass() ? 2 : 1;
            mode = cands[idx];
        } else {
            int rem = (int)ps.e.decode_bypass_bits(5);
            // add 1 for each candidate <= rem, in ascending order
            int s0 = cands[0], s1 = cands[1], s2 = cands[2], t;
            if (s0 > s1) { t = s0; s0 = s1; s1 = t; }
            if (s1 > s2) { t = s1; s1 = s2; s2 = t; }
            if (s0 > s1) { t = s0; s0 = s1; s1 = t; }
            if (rem >= s0) rem++;
            if (rem >= s1) rem++;
            if (rem >= s2) rem++;
            mode = rem;
        }
        modes[i] = mode;
        fill4(g_sp.intra_mode_y, xb, yb, pb, (uint8_t)mode);
    }
    cu.intra_mode0 = modes[0];
    // chroma (4:2:0)
    int mode_c;
    if (dec_d(ps, E_CHROMA_MODE, 0)) {
        static const int cand_c[4] = {0, 26, 10, 1};
        int idx = (int)ps.e.decode_bypass_bits(2);
        mode_c = cand_c[idx];
        if (mode_c == modes[0])
            mode_c = 34;
    } else {
        mode_c = modes[0];
    }
    fill4(g_sp.intra_mode_c, cu.x0, cu.y0, 1 << cu.log2, (uint8_t)mode_c);
}

// ---- residual coding (spec 7.3.8.11; ctu_parse.parse_residual_coding) ------
void parse_residual(PS& ps, int x0, int y0, int log2_size, int c_idx) {
    CU& cu = ps.cu;
    if (g_sp.transform_skip_enabled && !cu.tqb && log2_size == 2) {
        int ts = dec_d(ps, c_idx == 0 ? E_TS_LUMA : E_TS_CHROMA, 0);
        if (c_idx == 0)
            g_sp.ts_y[(int64_t)(y0 >> 2) * g_sp.w4 + (x0 >> 2)] = (uint8_t)ts;
        else if (c_idx == 1)
            g_sp.ts_cb[(int64_t)(y0 >> 1) * g_sp.w4 + (x0 >> 1)] = (uint8_t)ts;
        else
            g_sp.ts_cr[(int64_t)(y0 >> 1) * g_sp.w4 + (x0 >> 1)] = (uint8_t)ts;
    }
    // scan selection (spec 7.4.9.11)
    int scan_idx = 0;
    if (cu.pred_mode == 1
        && (log2_size == 2 || (log2_size == 3 && c_idx == 0))) {
        int mode;
        if (c_idx == 0)
            mode = g_sp.intra_mode_y[(int64_t)(y0 >> 2) * g_sp.w4 + (x0 >> 2)];
        else
            mode = g_sp.intra_mode_c[(int64_t)(((y0 << 1) >> 2)) * g_sp.w4
                                  + ((x0 << 1) >> 2)];
        if (6 <= mode && mode <= 14)
            scan_idx = 2;
        else if (22 <= mode && mode <= 30)
            scan_idx = 1;
    }
    int16_t* plane;
    int stride;
    if (c_idx == 0) {
        plane = g_sp.coeff_y;
        stride = g_sp.pic_w;
    } else {
        plane = c_idx == 1 ? g_sp.coeff_cb : g_sp.coeff_cr;
        stride = g_sp.pic_w >> 1;
    }
    int sdh = g_sp.sdh_enabled && !cu.tqb;
    int rc = residual_decode_core(ps.e, ps.ctx, log2_size, c_idx, scan_idx,
                                  sdh, plane + (int64_t)y0 * stride + x0,
                                  stride);
    if (rc != 0)
        ps.err = 1;
}

// ---- transform tree / unit (spec 7.3.8.8/10) -------------------------------
void parse_transform_unit(PS& ps, int x0, int y0, int x_base, int y_base,
                          int log2_size, int blk_idx, int cbf_luma,
                          int cbf_cb, int cbf_cr) {
    CU& cu = ps.cu;
    // 4x4 TUs receive the PARENT's chroma cbfs: the spec's transform_unit
    // condition (7.3.8.10) includes them at every blkIdx — cu_qp_delta
    // can appear at blkIdx 0 of a chroma-only group — while the chroma
    // residual itself only rides blkIdx 3
    bool chroma_last = log2_size > 2 || blk_idx == 3;
    bool any_chroma = (cbf_cb || cbf_cr) && chroma_last;
    if (cbf_luma || cbf_cb || cbf_cr) {
        if (g_sp.cu_qp_delta_enabled && !ps.qp_coded) {
            // cu_qp_delta_abs: TR prefix (cMax 5, ctx [0,1,1,1,1]), EG0 suffix
            int prefix = 0;
            while (prefix < 5) {
                int b = dec_d(ps, E_QP_DELTA, prefix < 1 ? 0 : 1);
                if (!b)
                    break;
                prefix++;
            }
            int val = prefix;
            if (prefix == 5) {
                int64_t eg = ps.e.decode_egk(0);
                if (eg < 0) {
                    ps.err = 2;
                    return;
                }
                val = 5 + (int)eg;
            }
            if (val && ps.e.decode_bypass())
                val = -val;
            ps.qp_coded = 1;
            ps.qp_delta = val;
        }
        if (cbf_luma)
            parse_residual(ps, x0, y0, log2_size, 0);
        if (ps.err)
            return;
        if (any_chroma) {
            if (log2_size > 2) {
                if (cbf_cb)
                    parse_residual(ps, x0 >> 1, y0 >> 1, log2_size - 1, 1);
                if (!ps.err && cbf_cr)
                    parse_residual(ps, x0 >> 1, y0 >> 1, log2_size - 1, 2);
            } else {
                if (cbf_cb)
                    parse_residual(ps, x_base >> 1, y_base >> 1,
                                   log2_size, 1);
                if (!ps.err && cbf_cr)
                    parse_residual(ps, x_base >> 1, y_base >> 1,
                                   log2_size, 2);
            }
        }
    }
}

void parse_transform_tree(PS& ps, int x0, int y0, int x_base, int y_base,
                          int log2_size, int trafo_depth, int blk_idx,
                          int cbf_cb, int cbf_cr) {
    CU& cu = ps.cu;
    bool intra_split = cu.pred_mode == 1 && cu.part_mode == P_NxN;
    int split;
    if (log2_size <= g_sp.max_tb_log2 && log2_size > g_sp.min_tb_log2
        && trafo_depth < cu.max_trafo_depth
        && !(intra_split && trafo_depth == 0)) {
        split = dec_d(ps, E_SPLIT_TT, 5 - log2_size);
    } else {
        bool inter_split = g_sp.mtd_inter == 0 && cu.pred_mode == 0
                        && cu.part_mode != P_2Nx2N && trafo_depth == 0;
        split = log2_size > g_sp.max_tb_log2
             || (intra_split && trafo_depth == 0) || inter_split;
    }

    bool chroma_here = log2_size > 2;
    int parent_cb = cbf_cb, parent_cr = cbf_cr;
    int my_cb = parent_cb, my_cr = parent_cr;
    if (chroma_here) {  // 4:2:0 only (gated)
        if (trafo_depth == 0 || parent_cb)
            my_cb = dec_d(ps, E_CBF_CHROMA, trafo_depth);
        else
            my_cb = 0;
        if (trafo_depth == 0 || parent_cr)
            my_cr = dec_d(ps, E_CBF_CHROMA, trafo_depth);
        else
            my_cr = 0;
    }

    if (split) {
        int half = 1 << (log2_size - 1);
        parse_transform_tree(ps, x0, y0, x0, y0, log2_size - 1,
                             trafo_depth + 1, 0, my_cb, my_cr);
        if (ps.err) return;
        parse_transform_tree(ps, x0 + half, y0, x0, y0, log2_size - 1,
                             trafo_depth + 1, 1, my_cb, my_cr);
        if (ps.err) return;
        parse_transform_tree(ps, x0, y0 + half, x0, y0, log2_size - 1,
                             trafo_depth + 1, 2, my_cb, my_cr);
        if (ps.err) return;
        parse_transform_tree(ps, x0 + half, y0 + half, x0, y0, log2_size - 1,
                             trafo_depth + 1, 3, my_cb, my_cr);
        return;
    }

    // leaf
    int cbf_luma = 1;
    if (cu.pred_mode == 1 || trafo_depth != 0 || my_cb || my_cr)
        cbf_luma = dec_d(ps, E_CBF_LUMA, trafo_depth == 0 ? 1 : 0);
    int size = 1 << log2_size;
    fill4(g_sp.tu_log2, x0, y0, size, (uint8_t)log2_size);
    int tu_id = ps.ids[2]++;
    fill4(g_sp.tu_id, x0, y0, size, tu_id);
    fill4(g_sp.cbf_y, x0, y0, size, (uint8_t)cbf_luma);
    if (chroma_here) {
        fill4(g_sp.cbf_cb, x0, y0, size, (uint8_t)my_cb);
        fill4(g_sp.cbf_cr, x0, y0, size, (uint8_t)my_cr);
    } else if (blk_idx == 3) {
        // 4x4 luma: chroma carried at parent 8x8
        fill4(g_sp.cbf_cb, x_base, y_base, 2 * size, (uint8_t)parent_cb);
        fill4(g_sp.cbf_cr, x_base, y_base, 2 * size, (uint8_t)parent_cr);
    }
    // TU record: (x0, y0, log2, blk_idx, x_base, y_base, cbf_y, cbf_cb, cbf_cr)
    int32_t* tr = ps.tu_rec + (int64_t)ps.counts[1] * 9;
    tr[0] = x0;
    tr[1] = y0;
    tr[2] = log2_size;
    tr[3] = blk_idx;
    tr[4] = x_base;
    tr[5] = y_base;
    tr[6] = cbf_luma;
    tr[7] = my_cb;
    tr[8] = my_cr;
    ps.counts[1]++;
    ps.cu_rec[(int64_t)cu.rec_idx * 8 + 7]++;  // n_tus

    parse_transform_unit(ps, x0, y0, x_base, y_base, log2_size, blk_idx,
                         cbf_luma, my_cb, my_cr);
}

// ---- coding unit (spec 7.3.8.5; ctu_parse.parse_coding_unit) ---------------
int parse_inter_part_mode(PS& ps, int log2_size) {
    if (dec_d(ps, E_PART_MODE, 0))
        return P_2Nx2N;
    bool at_min = log2_size == g_sp.min_cb_log2;
    bool amp = g_sp.amp_enabled && !at_min;
    int b1 = dec_d(ps, E_PART_MODE, 1);
    if (at_min) {
        if (b1)
            return P_2NxN;
        if (log2_size == 3)
            return P_Nx2N;
        if (dec_d(ps, E_PART_MODE, 2))
            return P_Nx2N;
        return P_NxN;
    }
    if (!amp)
        return b1 ? P_2NxN : P_Nx2N;
    int b2 = dec_d(ps, E_PART_MODE, 3);
    if (b1) {
        if (b2)
            return P_2NxN;
        return ps.e.decode_bypass() ? P_2NxnD : P_2NxnU;
    }
    if (b2)
        return P_Nx2N;
    return ps.e.decode_bypass() ? P_nRx2N : P_nLx2N;
}

void parse_coding_unit(PS& ps, int x0, int y0, int log2_size, int depth) {
    int size = 1 << log2_size;
    CU& cu = ps.cu;
    cu.x0 = x0;
    cu.y0 = y0;
    cu.log2 = log2_size;
    cu.depth = depth;
    cu.pred_mode = 0;
    cu.part_mode = 0;
    cu.skip = 0;
    cu.tqb = 0;
    cu.intra_mode0 = 1;
    int cu_id = ps.ids[0]++;
    cu.rec_idx = ps.counts[0];
    // CU record: (x0, y0, log2, pred_mode, part_mode, skip, tqb, n_tus)
    int32_t* cr = ps.cu_rec + (int64_t)ps.counts[0] * 8;
    ps.counts[0]++;
    cr[0] = x0;
    cr[1] = y0;
    cr[2] = log2_size;
    cr[7] = 0;

    fill4(g_sp.ct_depth, x0, y0, size, (uint8_t)depth);
    fill4(g_sp.cu_size_log2, x0, y0, size, (uint8_t)log2_size);
    fill4(g_sp.cu_id, x0, y0, size, cu_id);

    if (g_sp.tq_bypass_enabled) {
        cu.tqb = dec_d(ps, E_TQ_BYPASS, 0);
        fill4(g_sp.tq_bypass, x0, y0, size, (uint8_t)cu.tqb);
    }

    int skip = 0;
    if (!g_sp.is_i) {
        int inc = 0;
        if (sp_available(x0, y0, x0 - 1, y0))
            inc += g_sp.skip_flag[idx4(x0 - 1, y0)] ? 1 : 0;
        if (sp_available(x0, y0, x0, y0 - 1))
            inc += g_sp.skip_flag[idx4(x0, y0 - 1)] ? 1 : 0;
        skip = dec_d(ps, E_SKIP, inc);
    }
    cu.skip = skip;
    fill4(g_sp.skip_flag, x0, y0, size, (uint8_t)skip);

    if (skip) {
        cu.pred_mode = 0;
        fill4(g_sp.cu_pred_mode, x0, y0, size, (uint8_t)0);
        fill4(g_sp.qp_y, x0, y0, size, (int8_t)derive_qp(ps, x0, y0));
        prediction_unit(ps, x0, y0, size, size, 0, true);
        int tl = log2_size < g_sp.max_tb_log2 ? log2_size : g_sp.max_tb_log2;
        fill4(g_sp.tu_log2, x0, y0, size, (uint8_t)tl);
        cr[3] = 0;
        cr[4] = 0;
        cr[5] = 1;
        cr[6] = cu.tqb;
        return;
    }

    int pred_intra = 1;
    if (!g_sp.is_i)
        pred_intra = dec_d(ps, E_PRED_MODE, 0);
    cu.pred_mode = pred_intra;
    fill4(g_sp.cu_pred_mode, x0, y0, size, (uint8_t)pred_intra);

    int part_mode = P_2Nx2N;
    if (pred_intra) {
        if (log2_size == g_sp.min_cb_log2 && !dec_d(ps, E_PART_MODE, 0))
            part_mode = P_NxN;
    } else {
        part_mode = parse_inter_part_mode(ps, log2_size);
    }
    cu.part_mode = part_mode;
    fill4(g_sp.part_mode, x0, y0, size, (uint8_t)part_mode);

    if (pred_intra) {
        // PCM gated off (pcm_enabled_flag forces the Python path)
        parse_intra_modes(ps);
    } else {
        int h = size >> 1, q = size >> 2;
        switch (part_mode) {
        case P_2Nx2N:
            prediction_unit(ps, x0, y0, size, size, 0, false);
            break;
        case P_2NxN:
            prediction_unit(ps, x0, y0, size, h, 0, false);
            if (!ps.err)
                prediction_unit(ps, x0, y0 + h, size, h, 1, false);
            break;
        case P_Nx2N:
            prediction_unit(ps, x0, y0, h, size, 0, false);
            if (!ps.err)
                prediction_unit(ps, x0 + h, y0, h, size, 1, false);
            break;
        case P_NxN:
            prediction_unit(ps, x0, y0, h, h, 0, false);
            if (!ps.err)
                prediction_unit(ps, x0 + h, y0, h, h, 1, false);
            if (!ps.err)
                prediction_unit(ps, x0, y0 + h, h, h, 2, false);
            if (!ps.err)
                prediction_unit(ps, x0 + h, y0 + h, h, h, 3, false);
            break;
        case P_2NxnU:
            prediction_unit(ps, x0, y0, size, q, 0, false);
            if (!ps.err)
                prediction_unit(ps, x0, y0 + q, size, size - q, 1, false);
            break;
        case P_2NxnD:
            prediction_unit(ps, x0, y0, size, size - q, 0, false);
            if (!ps.err)
                prediction_unit(ps, x0, y0 + size - q, size, q, 1, false);
            break;
        case P_nLx2N:
            prediction_unit(ps, x0, y0, q, size, 0, false);
            if (!ps.err)
                prediction_unit(ps, x0 + q, y0, size - q, size, 1, false);
            break;
        case P_nRx2N:
            prediction_unit(ps, x0, y0, size - q, size, 0, false);
            if (!ps.err)
                prediction_unit(ps, x0 + size - q, y0, q, size, 1, false);
            break;
        }
    }
    if (ps.err)
        return;

    cr[3] = pred_intra;
    cr[4] = part_mode;
    cr[5] = 0;
    cr[6] = cu.tqb;

    // transform tree
    int rqt_root = 1;
    if (!pred_intra && !(part_mode == P_2Nx2N && ps.last_pu_merge))
        rqt_root = dec_d(ps, E_RQT_ROOT, 0);
    fill4(g_sp.qp_y, x0, y0, size, (int8_t)derive_qp(ps, x0, y0));
    if (rqt_root) {
        int intra_split = (pred_intra && part_mode == P_NxN) ? 1 : 0;
        cu.max_trafo_depth =
            pred_intra ? g_sp.mtd_intra + intra_split : g_sp.mtd_inter;
        parse_transform_tree(ps, x0, y0, x0, y0, log2_size, 0, 0, 1, 1);
    } else {
        int tl = log2_size < g_sp.max_tb_log2 ? log2_size : g_sp.max_tb_log2;
        fill4(g_sp.tu_log2, x0, y0, size, (uint8_t)tl);
    }
}

// ---- coding quadtree (spec 7.3.8.4) ----------------------------------------
void parse_coding_quadtree(PS& ps, int x0, int y0, int log2_size, int depth) {
    bool in_pic = x0 + (1 << log2_size) <= g_sp.pic_w
               && y0 + (1 << log2_size) <= g_sp.pic_h;
    int split = log2_size > g_sp.min_cb_log2;
    if (in_pic && log2_size > g_sp.min_cb_log2) {
        int inc = 0;
        if (sp_available(x0, y0, x0 - 1, y0))
            inc += g_sp.ct_depth[idx4(x0 - 1, y0)] > depth ? 1 : 0;
        if (sp_available(x0, y0, x0, y0 - 1))
            inc += g_sp.ct_depth[idx4(x0, y0 - 1)] > depth ? 1 : 0;
        split = dec_d(ps, E_SPLIT_CU, inc);
    }
    if (g_sp.cu_qp_delta_enabled
        && log2_size >= g_sp.ctb_log2 - g_sp.diff_cu_qp_delta_depth) {
        ps.qp_coded = 0;
        ps.qp_delta = 0;
        ps.qp_y_pred = ps.last_cu_qp;
    }
    if (split) {
        int half = 1 << (log2_size - 1);
        int x1 = x0 + half, y1 = y0 + half;
        parse_coding_quadtree(ps, x0, y0, log2_size - 1, depth + 1);
        if (ps.err) return;
        if (x1 < g_sp.pic_w) {
            parse_coding_quadtree(ps, x1, y0, log2_size - 1, depth + 1);
            if (ps.err) return;
        }
        if (y1 < g_sp.pic_h) {
            parse_coding_quadtree(ps, x0, y1, log2_size - 1, depth + 1);
            if (ps.err) return;
        }
        if (x1 < g_sp.pic_w && y1 < g_sp.pic_h) {
            parse_coding_quadtree(ps, x1, y1, log2_size - 1, depth + 1);
            if (ps.err) return;
        }
    } else {
        parse_coding_unit(ps, x0, y0, log2_size, depth);
        // per-CU QpY (reference QpState::setQpValue semantics): derived
        // at THIS CU's parse with the CuQpDeltaVal state as of now — a
        // CU of the group parsed before the delta appeared keeps
        // pred + 0, NOT the later delta (cross-verified against the
        // reference decoder on its own --aq streams)
        int qp = derive_qp(ps, x0, y0);
        fill4(g_sp.qp_y, x0, y0, 1 << log2_size, (int8_t)qp);
        ps.last_cu_qp = qp;
    }
}

}  // namespace

// ---- ctypes interface ------------------------------------------------------
extern "C" {

// ptrs order mirrored by native/__init__.py _SLICE_PTR_ORDER
void tc_slice_setup(const int64_t* ptrs, const int32_t* ip,
                    const int32_t* ctx_offs, const int32_t* ref_pocs,
                    const uint8_t* ref_lt) {
    int k = 0;
    g_sp.zscan = (const int64_t*)ptrs[k++];
    g_sp.tile_id = (const int32_t*)ptrs[k++];
    g_sp.slice_idx = (int32_t*)ptrs[k++];
    g_sp.ct_depth = (uint8_t*)ptrs[k++];
    g_sp.cu_pred_mode = (uint8_t*)ptrs[k++];
    g_sp.part_mode = (uint8_t*)ptrs[k++];
    g_sp.skip_flag = (uint8_t*)ptrs[k++];
    g_sp.tq_bypass = (uint8_t*)ptrs[k++];
    g_sp.pcm_flag = (uint8_t*)ptrs[k++];
    g_sp.intra_mode_y = (uint8_t*)ptrs[k++];
    g_sp.intra_mode_c = (uint8_t*)ptrs[k++];
    g_sp.mv = (int16_t*)ptrs[k++];
    g_sp.ref_idx = (int8_t*)ptrs[k++];
    g_sp.merge_flag = (uint8_t*)ptrs[k++];
    g_sp.merge_idx = (uint8_t*)ptrs[k++];
    g_sp.mvd = (int16_t*)ptrs[k++];
    g_sp.mvp_flag = (uint8_t*)ptrs[k++];
    g_sp.ref_poc = (int32_t*)ptrs[k++];
    g_sp.ref_is_lt = (uint8_t*)ptrs[k++];
    g_sp.qp_y = (int8_t*)ptrs[k++];
    g_sp.cu_size_log2 = (uint8_t*)ptrs[k++];
    g_sp.pu_id = (int32_t*)ptrs[k++];
    g_sp.cu_id = (int32_t*)ptrs[k++];
    g_sp.tu_log2 = (uint8_t*)ptrs[k++];
    g_sp.tu_id = (int32_t*)ptrs[k++];
    g_sp.cbf_y = (uint8_t*)ptrs[k++];
    g_sp.cbf_cb = (uint8_t*)ptrs[k++];
    g_sp.cbf_cr = (uint8_t*)ptrs[k++];
    g_sp.ts_y = (uint8_t*)ptrs[k++];
    g_sp.ts_cb = (uint8_t*)ptrs[k++];
    g_sp.ts_cr = (uint8_t*)ptrs[k++];
    g_sp.coeff_y = (int16_t*)ptrs[k++];
    g_sp.coeff_cb = (int16_t*)ptrs[k++];
    g_sp.coeff_cr = (int16_t*)ptrs[k++];
    g_sp.sao_type = (uint8_t*)ptrs[k++];
    g_sp.sao_class = (uint8_t*)ptrs[k++];
    g_sp.sao_offsets = (int8_t*)ptrs[k++];
    g_sp.sao_merge = (uint8_t*)ptrs[k++];
    g_sp.col_pm = (const uint8_t*)ptrs[k++];
    g_sp.col_ref_idx = (const int8_t*)ptrs[k++];
    g_sp.col_mv = (const int16_t*)ptrs[k++];
    g_sp.col_ref_poc = (const int32_t*)ptrs[k++];
    g_sp.col_ref_lt = (const uint8_t*)ptrs[k++];

    int j = 0;
    g_sp.pic_w = ip[j++];
    g_sp.pic_h = ip[j++];
    g_sp.w4 = ip[j++];
    g_sp.h4 = ip[j++];
    g_sp.wc = ip[j++];
    g_sp.hc = ip[j++];
    g_sp.ctb_log2 = ip[j++];
    g_sp.min_cb_log2 = ip[j++];
    g_sp.max_tb_log2 = ip[j++];
    g_sp.min_tb_log2 = ip[j++];
    g_sp.mtd_intra = ip[j++];
    g_sp.mtd_inter = ip[j++];
    g_sp.amp_enabled = ip[j++];
    g_sp.bit_depth_y = ip[j++];
    g_sp.bit_depth_c = ip[j++];
    g_sp.qp_bd_offset_y = ip[j++];
    g_sp.cu_qp_delta_enabled = ip[j++];
    g_sp.diff_cu_qp_delta_depth = ip[j++];
    g_sp.tq_bypass_enabled = ip[j++];
    g_sp.transform_skip_enabled = ip[j++];
    g_sp.sdh_enabled = ip[j++];
    g_sp.log2_pml = ip[j++];
    g_sp.slice_qp_y = ip[j++];
    g_sp.slice_number = ip[j++];
    g_sp.is_i = ip[j++];
    g_sp.is_b = ip[j++];
    g_sp.max_merge = ip[j++];
    g_sp.n_ref[0] = ip[j++];
    g_sp.n_ref[1] = ip[j++];
    g_sp.mvd_l1_zero = ip[j++];
    g_sp.tmvp_enabled = ip[j++];
    g_sp.col_from_l0 = ip[j++];
    g_sp.sao_luma = ip[j++];
    g_sp.sao_chroma = ip[j++];
    g_sp.cur_poc = ip[j++];
    g_sp.col_poc = ip[j++];
    g_sp.no_backward = ip[j++];
    g_sp.has_col = ip[j++];

    std::memcpy(g_sp.off, ctx_offs, sizeof(g_sp.off));
    std::memcpy(g_sp.ref_pocs, ref_pocs, sizeof(g_sp.ref_pocs));
    std::memcpy(g_sp.ref_lt, ref_lt, sizeof(g_sp.ref_lt));
}

// Parse one CTU (sao + coding_quadtree). Returns 0 on success.
// io_qp: [qp_y_pred, last_cu_qp, is_cu_qp_delta_coded, cu_qp_delta_val]
// io_ids: [cu, pu, tu] picture-wide id counters
// counts: [n_cu, n_tu] running record counts for this slice
int tc_parse_ctu(const uint8_t* data, int64_t nbits, int64_t* io_pos,
                 int32_t* io_range, int32_t* io_offset, uint8_t* ctx,
                 int32_t ctb_addr_rs, int32_t* io_qp, int32_t* io_ids,
                 int32_t* cu_rec, int32_t* tu_rec, int32_t* counts) {
    PS ps{{data, nbits, *io_pos, (uint32_t)*io_range, (uint32_t)*io_offset},
          ctx};
    ps.qp_y_pred = io_qp[0];
    ps.last_cu_qp = io_qp[1];
    ps.qp_coded = io_qp[2];
    ps.qp_delta = io_qp[3];
    ps.ids = io_ids;
    ps.cu_rec = cu_rec;
    ps.tu_rec = tu_rec;
    ps.counts = counts;
    ps.last_pu_merge = 0;
    ps.err = 0;

    int rx = ctb_addr_rs % g_sp.wc, ry = ctb_addr_rs / g_sp.wc;
    g_sp.slice_idx[(int64_t)ry * g_sp.wc + rx] = g_sp.slice_number;
    if (g_sp.sao_luma || g_sp.sao_chroma)
        parse_sao(ps, rx, ry);
    parse_coding_quadtree(ps, rx << g_sp.ctb_log2, ry << g_sp.ctb_log2,
                          g_sp.ctb_log2, 0);

    io_qp[0] = ps.qp_y_pred;
    io_qp[1] = ps.last_cu_qp;
    io_qp[2] = ps.qp_coded;
    io_qp[3] = ps.qp_delta;
    *io_pos = ps.e.pos;
    *io_range = (int32_t)ps.e.range;
    *io_offset = (int32_t)ps.e.offset;
    return ps.err;
}

// Drive the whole slice_segment_data() CTU loop natively — the C++ twin of
// decode/slice_data.parse_slice_segment_data (spec 7.3.8.1, 9.3.1): WPP
// row context inheritance + snapshot, tile re-init, end_of_slice /
// end_of_subset terminate bins and the byte-aligned substream restart.
// init_states: fresh context pool (init_type, slice qp) for re-inits.
// tile_scan_ctus: ts -> rs map (geom.tile_scan_ctus). Returns 0 on
// success; out_end_ts gets the ts AFTER the last parsed CTU.
int tc_parse_slice(const uint8_t* data, int64_t nbits, int64_t* io_pos,
                   int32_t* io_range, int32_t* io_offset, uint8_t* ctx,
                   int32_t start_ts, int32_t wpp, int32_t num_ctx,
                   const uint8_t* init_states, const int32_t* tile_scan_ctus,
                   int32_t* io_qp, int32_t* io_ids, int32_t* cu_rec,
                   int32_t* tu_rec, int32_t* counts, int32_t* out_end_ts) {
    PS ps{{data, nbits, *io_pos, (uint32_t)*io_range, (uint32_t)*io_offset},
          ctx};
    ps.qp_y_pred = io_qp[0];
    ps.last_cu_qp = io_qp[1];
    ps.qp_coded = io_qp[2];
    ps.qp_delta = io_qp[3];
    ps.ids = io_ids;
    ps.cu_rec = cu_rec;
    ps.tu_rec = tu_rec;
    ps.counts = counts;
    ps.err = 0;

    const int wc = g_sp.wc, hc = g_sp.hc;
    const int snap_rx = wc > 1 ? 1 : 0;
    const int tiles = g_sp.tile_id != nullptr;
    static thread_local uint8_t wpp_saved[512];
    bool have_saved = false;
    int64_t ts = start_ts;

    while (true) {
        const int rs = tile_scan_ctus[ts];
        const int rx = rs % wc, ry = rs / wc;

        if (wpp && rx == 0 && ry > 0 && ts > 0) {
            // WPP row start: inherit from the above-right CTU's snapshot
            // when that CTU is in the same slice and tile
            int nx = wc > 1 ? 1 : 0;
            bool ok = have_saved
                && g_sp.slice_idx[(int64_t)(ry - 1) * wc + nx]
                       == g_sp.slice_number
                && (!tiles
                    || g_sp.tile_id[(int64_t)(ry - 1) * wc + nx]
                           == g_sp.tile_id[(int64_t)ry * wc + rx]);
            std::memcpy(ctx, ok ? wpp_saved : init_states, num_ctx);
            ps.qp_y_pred = g_sp.slice_qp_y;
            ps.last_cu_qp = g_sp.slice_qp_y;
        } else if (tiles && ts > 0 && !(wpp && rx == 0)) {
            const int prs = tile_scan_ctus[ts - 1];
            if (g_sp.tile_id[(int64_t)(prs / wc) * wc + prs % wc]
                    != g_sp.tile_id[(int64_t)ry * wc + rx]) {
                std::memcpy(ctx, init_states, num_ctx);
                ps.qp_y_pred = g_sp.slice_qp_y;
                ps.last_cu_qp = g_sp.slice_qp_y;
            }
        }

        ps.last_pu_merge = 0;
        g_sp.slice_idx[(int64_t)ry * wc + rx] = g_sp.slice_number;
        if (g_sp.sao_luma || g_sp.sao_chroma)
            parse_sao(ps, rx, ry);
        parse_coding_quadtree(ps, rx << g_sp.ctb_log2, ry << g_sp.ctb_log2,
                              g_sp.ctb_log2, 0);
        if (ps.err)
            break;

        if (wpp && rx == snap_rx) {
            std::memcpy(wpp_saved, ctx, num_ctx);
            have_saved = true;
        }

        int end_of_slice = ps.e.decode_terminate();
        ts++;
        if (end_of_slice)
            break;
        if (ts >= (int64_t)wc * hc) {
            ps.err = 2;  // slice data overruns picture
            break;
        }
        const int nrs = tile_scan_ctus[ts];
        bool new_tile = tiles
            && g_sp.tile_id[(int64_t)(nrs / wc) * wc + nrs % wc]
                   != g_sp.tile_id[(int64_t)ry * wc + rx];
        bool new_row = wpp && (nrs % wc == 0);
        if (new_tile || new_row) {
            // end_of_subset_one_bit (must be 1), then restart the engine
            // at the next byte boundary (alignment-bit semantics of
            // BitReader.byte_alignment at pos-1)
            if (ps.e.decode_terminate() != 1) {
                ps.err = 3;
                break;
            }
            ps.e.restart_at((ps.e.pos + 7) & ~(int64_t)7);
        }
    }

    io_qp[0] = ps.qp_y_pred;
    io_qp[1] = ps.last_cu_qp;
    io_qp[2] = ps.qp_coded;
    io_qp[3] = ps.qp_delta;
    *io_pos = ps.e.pos;
    *io_range = (int32_t)ps.e.range;
    *io_offset = (int32_t)ps.e.offset;
    *out_end_ts = (int32_t)ts;
    return ps.err;
}

}  // extern "C"
