// Shared native-core definitions: CABAC tables, arithmetic engine, and the
// sig_coeff_flag context derivation — used by cabac_core.cpp (residual
// decode / rate estimation / intra TU) and slice_parse.cpp (full CTU parse).
//
// Spec references: decode engine 9.3.4.3; context derivation 9.3.4.2.5.
#ifndef TC_NATIVE_CORE_H
#define TC_NATIVE_CORE_H

#include <cstdint>
#include <cstring>

// Tables installed once by tc_init_tables (defined in cabac_core.cpp).
extern uint8_t g_range_lps[64][4];
extern uint8_t g_next_mps[128];
extern uint8_t g_next_lps[128];
extern uint8_t g_sig4x4[16];
extern int32_t g_off_sig, g_off_csbf, g_off_lastx, g_off_lasty, g_off_gt1,
    g_off_gt2;
extern int32_t g_rate_bits[128][2];  // fractional bits (1/256) per state+bin
// scan tables: g_scan[s][idx] for grid log2 s in 0..3, scan idx 0..2;
// entries are (x, y) pairs in scan order, (1 << 2s) of them.
extern int8_t g_scan[4][3][2 * 64];

// Arithmetic decoding engine (spec 9.3.4.3) with a 64-bit bit cache.
// `pos` stays the semantic bit position (cache refills change nothing
// visible), matching cabac/engine.py exactly — including reading past the
// end of the buffer as zero bits (decoder robustness).
struct Engine {
    const uint8_t* data;
    int64_t nbits;
    int64_t pos;
    uint32_t range;
    uint32_t offset;
    uint64_t cache = 0;
    int cache_bits = 0;

    inline void set_pos(int64_t p) {
        pos = p;
        cache = 0;
        cache_bits = 0;
    }

    inline uint32_t read_bits(int n) {
        while (cache_bits < n) {
            int64_t bitpos = pos + cache_bits;
            int64_t bytepos = bitpos >> 3;
            int shift = (int)(bitpos & 7);
            uint32_t byte = (bytepos < (nbits >> 3)) ? data[bytepos] : 0;
            int avail = 8 - shift;
            cache = (cache << avail) | (byte & ((1u << avail) - 1));
            cache_bits += avail;
        }
        uint32_t out = (uint32_t)((cache >> (cache_bits - n)) &
                                  ((1ull << n) - 1));
        cache_bits -= n;
        cache &= (1ull << cache_bits) - 1;
        pos += n;
        return out;
    }

    // Re-init the arithmetic state at a (byte-aligned) bit position — used
    // after PCM payloads and at WPP/tile substream boundaries.
    inline void restart_at(int64_t p) {
        set_pos(p);
        range = 510;
        offset = read_bits(9);
    }

    inline int decode_decision(uint8_t* ctx, int idx) {
        uint32_t s = ctx[idx];
        uint32_t lps = g_range_lps[s >> 1][(range >> 6) & 3];
        range -= lps;
        int bin;
        if (offset >= range) {
            bin = 1 - (s & 1);
            offset -= range;
            range = lps;
            ctx[idx] = g_next_lps[s];
        } else {
            bin = s & 1;
            ctx[idx] = g_next_mps[s];
        }
        if (range < 256) {
            int n = __builtin_clz(range) - 23;  // 9 - bit_length(range)
            range <<= n;
            offset = (offset << n) | read_bits(n);
        }
        return bin;
    }

    inline int decode_bypass() {
        offset = (offset << 1) | read_bits(1);
        if (offset >= range) {
            offset -= range;
            return 1;
        }
        return 0;
    }

    inline uint32_t decode_bypass_bits(int n) {
        uint32_t v = 0;
        for (int i = 0; i < n; i++)
            v = (v << 1) | decode_bypass();
        return v;
    }

    // spec 9.3.4.3.5; on a 1 the range is NOT renormalized (PCM / slice end)
    inline int decode_terminate() {
        uint32_t r = range - 2;
        if (offset >= r) {
            range = r;
            return 1;
        }
        if (r < 256) {
            int n = __builtin_clz(r) - 23;
            r <<= n;
            offset = (offset << n) | read_bits(n);
        }
        range = r;
        return 0;
    }

    // k-th order Exp-Golomb, bypass bins (spec 9.3.3.3). Returns -1 when the
    // prefix run is implausibly long (corrupt stream guard).
    inline int64_t decode_egk(int k) {
        int64_t value = 0;
        while (decode_bypass()) {
            value += 1ll << k;
            k++;
            if (k > 32)
                return -1;
        }
        if (k)
            value += decode_bypass_bits(k);
        return value;
    }

    inline int decode_remaining(int rice) {
        int prefix = 0;
        while (prefix < 32 && decode_bypass())
            prefix++;
        if (prefix <= 3)
            return (prefix << rice) + (rice ? decode_bypass_bits(rice) : 0);
        int n = prefix - 3 + rice;
        return decode_bypass_bits(n) + (((1 << (prefix - 3)) + 2) << rice);
    }
};

// sig_coeff_flag ctxInc (spec 9.3.4.2.5) — mirrors ctu_parse._sig_ctx
inline int sig_ctx(int log2_size, int c_idx, int scan_idx, int xc, int yc,
                   int xp, int yp, int xs, int ys, int prev_csbf) {
    int sig;
    if (log2_size == 2) {
        sig = g_sig4x4[(yp << 2) + xp];
    } else if (xc == 0 && yc == 0) {
        sig = 0;
    } else {
        if (prev_csbf == 0) {
            int s = xp + yp;
            sig = s == 0 ? 2 : (s < 3 ? 1 : 0);
        } else if (prev_csbf == 1) {
            sig = yp == 0 ? 2 : (yp == 1 ? 1 : 0);
        } else if (prev_csbf == 2) {
            sig = xp == 0 ? 2 : (xp == 1 ? 1 : 0);
        } else {
            sig = 2;
        }
        if (c_idx == 0) {
            if (xs || ys)
                sig += 3;
            sig += (log2_size == 3 && scan_idx == 0) ? 9
                 : (log2_size == 3 ? 15 : 21);
        } else {
            sig += log2_size == 3 ? 9 : 12;
        }
    }
    return sig + (c_idx ? 27 : 0);
}

// residual_coding() body from the last-position syntax down (spec 7.3.8.11),
// writing into a strided int16 plane. Returns 0 on success.
int residual_decode_core(Engine& e, uint8_t* ctx, int log2_size, int c_idx,
                         int scan_idx, int sdh, int16_t* out,
                         int out_stride);

// One intra TB: reference build + filter + predict + dequant/IDCT + add
// (cabac_core.cpp). Reused by the per-picture intra driver in
// pixel_recon.cpp.
extern "C" int tc_intra_tu(int16_t* plane, int pw, int ph,
                           const int32_t* zscan, int zw, int x0, int y0,
                           int n, int c_idx, int sub, int bit_depth, int mode,
                           int strong_smoothing, const int16_t* coeff_plane,
                           int cbf, int qp, int use_dst);

// Intra building blocks (cabac_core.cpp), shared with the encoder core.
// rt/rl are 2n refs; corner is p[-1][-1]. All spec 8.4.4.2.2-6.
void build_intra_refs(const int16_t* plane, int pw, int ph,
                      const int32_t* zscan, int zw, int x0, int y0, int n,
                      int sub, int bit_depth, int32_t* rt, int32_t* rl,
                      int32_t* corner);
// In-place [1 2 1] / strong smoothing with the per-mode gating of
// spec 8.4.4.2.3 (luma only; caller gates on c_idx).
void filter_intra_refs(int32_t* rt, int32_t* rl, int32_t* corner, int n,
                       int mode, int strong_smoothing, int bit_depth);
// Prediction into pred[n*n]; disable_edge skips the DC/H/V edge filters
// (used by the encoder's SATD ranking sweep).
void intra_predict_core(int mode, const int32_t* rt, const int32_t* rl,
                        int32_t corner, int n, int c_idx, int bit_depth,
                        int disable_edge, int32_t* pred);
// Angular prediction tables (spec 8.4.4.2.6; installed by tc_init_intra).
extern int8_t g_angle[35];
extern int16_t g_inv_angle[35];

// Exact CABAC fractional-bit rate of residual_coding (cabac_core.cpp),
// mutating ctx like the writer. -1 on an all-zero block.
extern "C" int64_t tc_residual_bits(uint8_t* ctx, int log2_size, int c_idx,
                                    int scan_idx, int sdh,
                                    const int16_t* blk);

// Dequant + two-stage inverse transform, added into pred in place
// (cabac_core.cpp; spec 8.6.3/8.6.4). coeff points at the TB's top-left in
// a strided int16 plane; qp includes the bit-depth offset.
void dequant_idct_add(const int16_t* coeff, int cstride, int n, int log2,
                      int qp, int bit_depth, int use_dst, int32_t* pred);
// The shared DCT/DST matrix store (row-major (n, n); installed by
// tc_init_intra).
const int32_t* dct_matrix_for(int log2, int use_dst);

// ---- shared picture context: motion derivation + plan tensors -------------
// Filled by tc_slice_setup (decode parse) or the encoder core; the motion
// functions below (slice_parse.cpp) read neighbour motion straight from the
// plan tensors (spec 8.5.3; decode/mvp.py oracle).

// context-offset table order (mirrored in native/__init__.py _PARSE_ELEMS)
enum {
    E_SAO_MERGE, E_SAO_TYPE, E_SPLIT_CU, E_TQ_BYPASS, E_SKIP, E_PRED_MODE,
    E_PART_MODE, E_PREV_INTRA, E_CHROMA_MODE, E_RQT_ROOT, E_MERGE_FLAG,
    E_MERGE_IDX, E_INTER_DIR, E_REF_IDX, E_MVP_FLAG, E_MVD_G0, E_MVD_G1,
    E_SPLIT_TT, E_CBF_LUMA, E_CBF_CHROMA, E_QP_DELTA, E_TS_LUMA, E_TS_CHROMA,
    N_ELEMS
};

struct SP {
    // geometry / SPS / PPS
    int pic_w, pic_h, w4, h4, wc, hc;
    int ctb_log2, min_cb_log2, max_tb_log2, min_tb_log2;
    int mtd_intra, mtd_inter;
    int amp_enabled;
    int bit_depth_y, bit_depth_c, qp_bd_offset_y;
    int cu_qp_delta_enabled, diff_cu_qp_delta_depth;
    int tq_bypass_enabled, transform_skip_enabled, sdh_enabled;
    int log2_pml;   // log2 parallel merge level
    // slice header
    int slice_qp_y, slice_number, is_i, is_b, max_merge;
    int n_ref[2];
    int mvd_l1_zero, tmvp_enabled, col_from_l0;
    int sao_luma, sao_chroma;
    int cur_poc, col_poc, no_backward, has_col;
    // geometry tables
    const int64_t* zscan;       // (h4, w4)
    const int32_t* tile_id;     // (hc, wc)
    int32_t* slice_idx;         // (hc, wc)
    // plan tensors (all (h4, w4) unless noted)
    uint8_t *ct_depth, *cu_pred_mode, *part_mode, *skip_flag, *tq_bypass,
            *pcm_flag, *intra_mode_y, *intra_mode_c, *merge_flag, *merge_idx,
            *mvp_flag, *ref_is_lt, *cu_size_log2, *tu_log2,
            *cbf_y, *cbf_cb, *cbf_cr, *ts_y, *ts_cb, *ts_cr;
    int8_t *qp_y;                // (h4, w4)
    int8_t *ref_idx;             // (2, h4, w4)
    int16_t *mv, *mvd;           // (2, h4, w4, 2)
    int32_t *ref_poc;            // (2, h4, w4)
    int32_t *pu_id, *cu_id, *tu_id;  // (h4, w4)
    int16_t *coeff_y;            // (pic_h, pic_w)
    int16_t *coeff_cb, *coeff_cr;    // (pic_h/2, pic_w/2)
    uint8_t *sao_type, *sao_class;   // (hc, wc, 3)
    int8_t *sao_offsets;             // (hc, wc, 3, 4)
    uint8_t *sao_merge;              // (hc, wc) 0=new 1=left 2=up (encode)
    // collocated picture plan (TMVP); null when unavailable
    const uint8_t* col_pm;       // cu_pred_mode
    const int8_t* col_ref_idx;   // (2, h4, w4)
    const int16_t* col_mv;       // (2, h4, w4, 2)
    const int32_t* col_ref_poc;  // (2, h4, w4)
    const uint8_t* col_ref_lt;   // (2, h4, w4)
    // reference lists
    int32_t ref_pocs[2][16];
    uint8_t ref_lt[2][16];
    // context offsets
    int32_t off[N_ELEMS];
};

// One parse/encode picture context per concurrently-processed picture.
// Worker threads bind a context with tc_ctx_bind (ctypes calls run on the
// calling OS thread); native helper threads inherit the spawner's pointer
// by capture. The default context preserves the historical
// single-picture behavior.
extern SP g_sp_default;
extern thread_local SP* g_sp_ptr;
#define g_sp (*g_sp_ptr)

inline int clip3i(int lo, int hi, int v) {
    return v < lo ? lo : (v > hi ? hi : v);
}

inline int64_t idx4(int x0, int y0) {
    return (int64_t)(y0 >> 2) * g_sp.w4 + (x0 >> 2);
}

inline int64_t idx4l(int l, int x0, int y0) {
    return (int64_t)l * g_sp.h4 * g_sp.w4 + (int64_t)(y0 >> 2) * g_sp.w4
         + (x0 >> 2);
}

struct Cand {
    int pf0, pf1;
    int mv00, mv01, mv10, mv11;  // mv[list][comp]
    int r0, r1;

    bool equal(const Cand& o) const {
        return pf0 == o.pf0 && pf1 == o.pf1 && mv00 == o.mv00
            && mv01 == o.mv01 && mv10 == o.mv10 && mv11 == o.mv11
            && r0 == o.r0 && r1 == o.r1;
    }
    int mvx(int l) const { return l ? mv10 : mv00; }
    int mvy(int l) const { return l ? mv11 : mv01; }
    int ref(int l) const { return l ? r1 : r0; }
    int pf(int l) const { return l ? pf1 : pf0; }
};

// z-scan / slice / tile availability (spec 6.4.1)
bool sp_available(int x_cur, int y_cur, int x_nb, int y_nb);
// neighbour motion with the same-CB rule; cb = {x_cb, y_cb, n_cbs, n_pbw,
// n_pbh, part_idx} or null
bool sp_nb_motion(int x_cur, int y_cur, int x_nb, int y_nb, const int* cb,
                  Cand* out);
// merge candidate list up to `need` entries (spec 8.5.3.1.2)
int sp_merge_candidates(int x_cb, int y_cb, int cb_size, int x_pb, int y_pb,
                        int w, int h, int part_idx, int part_mode, int need,
                        Cand* cands);
// two AMVP predictors for (lx, ref_idx) (spec 8.5.3.1.5/6)
void sp_amvp(int x_pb, int y_pb, int w, int h, int lx, int ref_idx,
             const int* cb, int out[2][2]);
// candModeList derivation (spec 8.4.2)
void sp_intra_mpm(int xb, int yb, int cands[3]);
int sp_intra_mpm_n(int xb, int yb, int cands[3]);  // returns neighbourModes

// Fractional-sample MC interpolation into a 14-bit (h, w) block
// (pixel_recon.cpp; spec 8.5.3.3.3). taps 8 (luma) / 4 (chroma);
// filt_stride = taps.
void mc_interp(const int16_t* ref, int rw, int rh, int xi, int yi, int xf,
               int yf, int w, int h, int bd, int taps,
               const int32_t (*filt)[8], int filt_stride, int32_t* out);

#endif  // TC_NATIVE_CORE_H
