// Native encoder search core: the complete per-CTU RDO mode decision —
// recursive CU split, intra SATD ranking + exact-rate RD refinement,
// inter merge/AMVP motion estimation (full-pel pattern search + sub-pel
// SATD refinement), SMP/AMP partitions — committing decisions into the
// PicturePlan tensors and the working reconstruction.
//
// This is the C++ twin of encode/intra_search.py + encode/inter_search.py,
// porting their decision arithmetic EXACTLY (same float cost ordering, same
// tie-breaks, same context transitions), so the produced plan and bitstream
// are byte-identical with the Python oracle (asserted by A/B tests).
// Reference analogue: turing/Search.hpp searchIntraCu (374) /
// fullPelMotionEstimation (2064) / subPelRefinement (2340) /
// searchMerge2Nx2N (925).
//
// Reuses from the shared native core: g_sp plan context + merge/AMVP
// derivation (slice_parse.cpp), intra refs/filter/predict + dequant/IDCT +
// exact residual rate (cabac_core.cpp), MC interpolation (pixel_recon.cpp).
#include <algorithm>
#include <cmath>
#include <limits>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <ctime>

#include <array>
#include <atomic>
#include <mutex>
#include <thread>
#include <vector>

#ifdef __AVX2__
#include <immintrin.h>
#elif defined(__SSE2__) || defined(_M_X64) || defined(__x86_64__)
#include <emmintrin.h>
#endif

#include "core.h"

// coarse phase timers (ns): [inter_cu, smp, intra_cu, snap, full_pel,
// subpel, fwd_xform, quantize, rate_est, pred_full, pred_luma, satd,
// spare, spare, spare, spare]
// [0..15] phase ns, [16..23] event counts, [24..31] extra phase ns
// (24 = dense full-pel ME field prepass — the device-offloadable stage)
// atomic (relaxed): pictures encode concurrently in separate contexts
// (TURING_TPU_FRAME_THREADS>1) and WPP rows in helper threads, so the
// accumulations would otherwise race and drop counts
static std::atomic<int64_t> g_enc_ns[32];
#ifdef TC_ENC_PROF
#define PROF_COUNT(i, n) \
    (g_enc_ns[i].fetch_add((n), std::memory_order_relaxed))
#else
#define PROF_COUNT(i, n) ((void)0)
#endif
static inline int64_t now_ns() {
    timespec t;
    clock_gettime(CLOCK_MONOTONIC, &t);
    return (int64_t)t.tv_sec * 1000000000 + t.tv_nsec;
}
struct PhaseTimer {
    int i;
    int64_t t0;
    PhaseTimer(int idx) : i(idx), t0(now_ns()) {}
    ~PhaseTimer() {
        g_enc_ns[i].fetch_add(now_ns() - t0, std::memory_order_relaxed);
    }
};
// leaf-kernel timers: clock_gettime in the per-block kernels costs ~5-8% of
// the whole encode, so they compile to nothing unless TC_ENC_PROF is set
// (g++ -DTC_ENC_PROF via TURING_TPU_NATIVE_PROF=1 at build time)
#ifdef TC_ENC_PROF
using LeafTimer = PhaseTimer;
#else
struct LeafTimer {
    LeafTimer(int) {}
};
#endif
extern "C" void tc_enc_counters(int64_t* out) {  // out: int64[32]
    for (int i = 0; i < 32; i++)
        out[i] = g_enc_ns[i].exchange(0, std::memory_order_relaxed);
}
// cross-TU phase accumulator (pixel_recon.cpp's deblock times itself
// into slot 27: the encoder's loop filter, device-twin-covered via
// TURING_TPU_DEVICE_DEBLOCK)
extern "C" void tc_enc_add_ns(int32_t slot, int64_t ns) {
    if (slot >= 0 && slot < 32)
        g_enc_ns[slot].fetch_add(ns, std::memory_order_relaxed);
}

namespace {

struct EN {
    const int16_t* orig[3];
    int16_t* rec[3];
    const int32_t* zscan32;
    const int16_t* refs[2][16][3];
    const uint8_t* ref8[2][16];  // u8 luma shadows (8-bit ME fast path)
    int32_t ref_poc_of[2][16];
    int32_t quant_scales[6];
    int32_t luma_filt[4][8];
    int32_t chroma_filt[8][4];
    int rd_candidates, max_cu_log2, max_cu_inter, search_range, strong;
    int num_ctx, rcudepth, rdoq;
    int met, fdam, rqt, esd, aps;
    // lowres pre-ME (x264-lookahead style; no reference analogue — the
    // reference relies on its raster fallback, Search.hpp:2240-2260):
    // quarter-res exhaustive +/-8 search per 16x16 luma block seeds the
    // full-pel star search, which then runs with a tight window
    std::vector<int16_t> lr_cur;      // (hb*4, wb*4) padded quarter-res orig
    std::vector<int16_t> lr_ref[2];   // bordered quarter-res ref-0 per list
    std::vector<int16_t> seed_mv[2];  // (hb*wb, 2) full-pel seeds per list
    int seed_wb = 0, seed_hb = 0;
    int have_seed[2] = {0, 0};
    // seed fields supplied externally for this picture (device pre-ME,
    // encode/device_analysis.py) — lowres_prepass honors and consumes
    int seeds_external = 0;
    // per-picture CTU frac-bits output buffer (raster, wc*hc)
    int64_t* frac_out = nullptr;
    // dense full-res ME field (encoder hot-loop device stage): per 16x16
    // block, the exhaustive +/-8 full-pel SAD winner around the lowres
    // seed. Replaces the star search's wide scanning (raster fallback,
    // big windows) with one whole-picture batched sweep — the same
    // restructuring that puts the ME hot loop (Search.hpp:1464-1483's
    // job) on the TPU when TURING_TPU_DEVICE_ENC=1.
    std::vector<int16_t> dense_mv[2];  // (hb*wb, 2) full-pel winners
    int have_dense[2] = {0, 0};
    int dense_external = 0;
    // full SAD surfaces of the dense sweep: (hb*wb, 17*17) int32, the
    // exact SAD at every window offset. The full-pel search serves
    // aligned 16x16-multiple probes from these instead of recomputing
    // (identical integers: the padded-plane reads equal the clamped
    // per-probe reads), which is what makes the ME candidate search a
    // device-served stage when the fields come from the TPU.
    std::vector<int32_t> dense_surf[2];
    int have_surf[2] = {0, 0};
    // ---- subpel plane cache (whole-plane 14-bit interpolation) ----
    // The subpel search's interpolation (sub_pel_refine probes, merge
    // SATD, bi refinement — Search.hpp:2340-2358's interpolate-and-SATD
    // job) restructured as a batched per-reference-plane stage: each
    // fractional position is filtered ONCE over a padded plane and
    // candidates read blocks out of it. Bit-equal to per-candidate
    // mc_interp (coordinate clamping == edge-replicated padding; same
    // >>shift1 / >>6 integer arithmetic), so bitstreams are unchanged.
    // Lifetime: one picture (flags cleared in tc_enc_setup; buffers
    // reused). An XLA twin (encode/device_analysis.py subpel_planes)
    // can install externally computed planes — integer-exact, so the
    // device path stays byte-identical.
    struct SubpelSet {
        std::vector<int16_t> ext;       // edge-replicated integer plane,
                                        // pad SP_EXT
        std::vector<int16_t> hplane[4]; // H-filtered (xf=1..3), pad SP_EXT
        std::vector<int16_t> plane[16]; // finished planes, pad SP_P
        // rows built per position (plane coords, exclusive): complete
        // references build whole planes in one step; in-flight overlap
        // references build in bands bounded by the producer's published
        // final rows (src_prog)
        std::atomic<int> rows_built[16];
        int ext_rows = 0, h_rows[4] = {0, 0, 0, 0};
        const volatile int64_t* src_prog = nullptr;
        std::mutex mtx;                 // guards lazy builds (WPP rows)
        SubpelSet() {
            for (auto& b : rows_built)
                b.store(0, std::memory_order_relaxed);
        }
        void reset(const volatile int64_t* prog) {
            ext_rows = 0;
            for (int i = 0; i < 4; i++)
                h_rows[i] = 0;
            for (auto& b : rows_built)
                b.store(0, std::memory_order_relaxed);
            src_prog = prog;
        }
    };
    // device-computed source-referenced rank-SATD tables
    // (encode/device_analysis.py rank_satd_tables_*): per size log2 2..5,
    // (hn, wn, 35) int32 — the exact integers rank_modes' sweep produces
    // with source refs at aligned positions
    std::vector<int32_t> ranksatd[6];
    int ranksatd_wn[6] = {0, 0, 0, 0, 0, 0};
    int have_ranksatd = 0;
    static const int N_SPSETS = 6;
    SubpelSet spsets[N_SPSETS];
    int8_t sp_of[2][16];  // (list, ref) -> set index or -1
    // ---- inter-picture overlap (concurrent dependent pictures) ----
    // The reference overlaps dependent pictures with a CTU-granular
    // wavefront: a CTU encodes once each reference picture's loop-filter
    // has passed (rx+4, ry+3) (TaskEncodeSubstream.cpp:71-93,
    // Global.h:1561-1562), with LimitFullPelMv bounding how far down the
    // search may reach (Search.hpp:1366-1408, howCloseDoYouDare=15).
    // This is the row-granular equivalent: waits are per CTU row (which
    // removes the reference's x-clamp entirely — whole rows are final),
    // the publisher is the Python follower running the banded native
    // deblock behind the search, and the MV clamp is y-only. All bounds
    // are static functions of the CTU position, so bitstreams are
    // byte-identical at any thread count / realized concurrency.
    // per-CU adaptive quantization (diff_cu_qp_delta_depth > 0): each
    // CU trial quantizes at layer min(depth, aq_depth)'s QP for its
    // position — the reference's pyramid query (Search.hpp:1145,
    // AdaptiveQuantisation.h:101). Plan qp_y is filled by the facade
    // after the search from the committed ct_depth (the qp of a CU is a
    // pure function of position+depth), so trials need no qp snapshots.
    int aq_depth = -1;                 // -1 = off
    std::vector<int32_t> aq_qp[4][3];  // [layer][y/cb/cr] (hn*wn) FULL qp
    int aq_wn[4] = {0, 0, 0, 0};
    struct Overlap {
        int active = 0;  // waits on refs + external-only analysis
        int clamp = 0;   // deterministic MV y-clamp (overlap mode on)
        volatile int64_t* self_rows = nullptr;        // search rows out
        const volatile int64_t* ref_rows[2][16] = {};  // refs' FINAL rows
    } ovl;
    EN() { std::memset(sp_of, -1, sizeof(sp_of)); }
};

EN g_en_default;
thread_local EN* g_en_ptr = &g_en_default;
#define en (*g_en_ptr)

// monotonic max-publish of a picture's completed-row count (the follower
// and multiple WPP row threads may race; the count must never regress)
static void ovl_publish(volatile int64_t* p, int64_t v) {
    int64_t curv = __atomic_load_n(p, __ATOMIC_RELAXED);
    while (curv < v
           && !__atomic_compare_exchange_n((int64_t*)p, &curv, v, true,
                                           __ATOMIC_RELEASE,
                                           __ATOMIC_RELAXED)) {
    }
}

static inline int ovl_hc() {
    return (g_sp.pic_h + (1 << g_sp.ctb_log2) - 1) >> g_sp.ctb_log2;
}

// Block until every reference picture has published enough FINAL
// (loop-filtered) CTU rows for this picture's row ry: the y-clamp lets
// row ry's search/merge reach at most into the refs' first ry+4 rows.
static void ovl_wait_row(int ry) {
    if (!en.ovl.active)
        return;
    const int64_t need = std::min(ry + 4, ovl_hc());
    for (int l = 0; l < 2; l++)
        for (int r = 0; r < 16; r++) {
            const volatile int64_t* p = en.ovl.ref_rows[l][r];
            if (!p)
                continue;
            int spins = 0;
            while (__atomic_load_n(p, __ATOMIC_ACQUIRE) < need) {
                if (++spins < 64) {
                    std::this_thread::yield();
                } else {
                    struct timespec ts = {0, 200000};  // 0.2 ms
                    nanosleep(&ts, nullptr);
                }
            }
        }
}

// set when both bit depths are 8: every satd_region input is then in
// [0, 255] and the int16 AVX-512BW SATD kernel is exact
static bool g_satd_i16 = false;

// factor-F decimation of an int16 plane: each lowres sample is the rounded
// mean of a (clamped) FxF block; output covers (hbl, wbl) = (hb, wb) blocks
// of B samples each, padded by edge replication to
// (hb*B + 2*border, wb*B + 2*border)
template <int F, int B>
static void lowres_plane(const int16_t* src, int w, int h, int wb, int hb,
                         int border, int16_t* dst) {
    const int lw = (w + F - 1) / F, lh = (h + F - 1) / F;
    const int dw = wb * B + 2 * border;
    for (int ly = 0; ly < hb * B; ly++) {
        int16_t* drow = dst + (int64_t)(ly + border) * dw + border;
        const int sy = ly < lh ? ly : lh - 1;
        for (int lx = 0; lx < wb * B; lx++) {
            const int sx = lx < lw ? lx : lw - 1;
            int sum = 0;
            for (int dy = 0; dy < F; dy++) {
                const int yy = F * sy + dy < h ? F * sy + dy : h - 1;
                const int16_t* row = src + (int64_t)yy * w;
                for (int dx = 0; dx < F; dx++) {
                    const int xx = F * sx + dx < w ? F * sx + dx : w - 1;
                    sum += row[xx];
                }
            }
            drow[lx] = (int16_t)((sum + F * F / 2) / (F * F));
        }
    }
    // replicate borders
    for (int y = 0; y < hb * B; y++) {
        int16_t* row = dst + (int64_t)(y + border) * dw;
        for (int x = 0; x < border; x++) {
            row[x] = row[border];
            row[border + wb * B + x] = row[border + wb * B - 1];
        }
    }
    for (int y = 0; y < border; y++) {
        std::memcpy(dst + (int64_t)y * dw, dst + (int64_t)border * dw,
                    dw * sizeof(int16_t));
        std::memcpy(dst + (int64_t)(border + hb * B + y) * dw,
                    dst + (int64_t)(border + hb * B - 1) * dw,
                    dw * sizeof(int16_t));
    }
}

// half-res +/-2 refinement of the quarter-res winners: sharpens each block
// seed from 4-pel to 2-pel granularity (8x8 half-res block per 16x16
// full-res block). cur: (hb*8, wb*8) tight; ref: bordered (border B2).
static void halfres_refine_rows(const int16_t* cur, const int16_t* ref,
                                int wb, int hb, int border, int by0,
                                int by1, int16_t* seeds) {
    const int cw = wb * 8;
    const int rw = wb * 8 + 2 * border;
    for (int by = by0; by < by1; by++)
        for (int bx = 0; bx < wb; bx++) {
            int16_t* sp = seeds + ((int64_t)by * wb + bx) * 2;
            const int chx = sp[0] >> 1, chy = sp[1] >> 1;  // half-res pels
            const int16_t* c0 = cur + (int64_t)(by * 8) * cw + bx * 8;
            int best = INT32_MAX, bsx = sp[0], bsy = sp[1];
            for (int dy = -2; dy <= 2; dy++) {
                const int16_t* r0 = ref
                    + (int64_t)(by * 8 + chy + dy + border) * rw
                    + (bx * 8 + chx + border);
                for (int dx = -2; dx <= 2; dx++) {
                    int sad = 0;
                    for (int y = 0; y < 8; y++) {
                        const int16_t* cr = c0 + (int64_t)y * cw;
                        const int16_t* rr = r0 + (int64_t)y * rw + dx;
                        for (int x = 0; x < 8; x++) {
                            int d = cr[x] - rr[x];
                            sad += d < 0 ? -d : d;
                        }
                    }
                    const int sx = 2 * (chx + dx), sy = 2 * (chy + dy);
                    const int cost = (sad << 2) + (sx < 0 ? -sx : sx)
                                   + (sy < 0 ? -sy : sy);
                    if (cost < best) {
                        best = cost;
                        bsx = sx;
                        bsy = sy;
                    }
                }
            }
            sp[0] = (int16_t)bsx;
            sp[1] = (int16_t)bsy;
        }
}

// exhaustive +/-8 quarter-res search for every 4x4 lowres (16x16 full-res)
// block; cost = (SAD << 2) + |dx| + |dy|, scan-order tie break (dy, dx
// ascending, strict improvement) — the Python mirror replicates this
// exactly (inter_search._lowres_seeds)
static void lowres_search_rows(const int16_t* cur, const int16_t* ref,
                               int wb, int hb, int border, int by0, int by1,
                               int16_t* seeds) {
    const int cw = wb * 4;
    const int rw = wb * 4 + 2 * border;
#ifdef __AVX2__
    // vectorized across dx: lanes = dx in [-8, 8) as uint16 costs
    // (max cost = (16*1023)<<2 + 16 = 65488, fits uint16); identical
    // integer costs and scan-order tie-break as the scalar loop below
    alignas(32) static const uint16_t PEN_ROW[16] = {
        8, 7, 6, 5, 4, 3, 2, 1, 0, 1, 2, 3, 4, 5, 6, 7};
    const __m256i pen_dx = _mm256_load_si256((const __m256i*)PEN_ROW);
    for (int by = by0; by < by1; by++)
        for (int bx = 0; bx < wb; bx++) {
            const int16_t* c0 = cur + (int64_t)(by * 4) * cw + bx * 4;
            uint32_t best = UINT32_MAX;
            int bdx = 0, bdy = 0;
            alignas(32) uint16_t lane[16];
            for (int dy = -8; dy <= 8; dy++) {
                const int16_t* r0 = ref
                    + (int64_t)(by * 4 + dy + border) * rw
                    + (bx * 4 + border) - 8;  // lane 0 = dx -8
                __m256i acc = _mm256_setzero_si256();
                int sad8 = 0;
                for (int y = 0; y < 4; y++) {
                    const int16_t* cr = c0 + (int64_t)y * cw;
                    const int16_t* rr = r0 + (int64_t)y * rw;
                    for (int x = 0; x < 4; x++) {
                        const __m256i cv = _mm256_set1_epi16(cr[x]);
                        const __m256i rv = _mm256_loadu_si256(
                            (const __m256i*)(rr + x));
                        acc = _mm256_add_epi16(
                            acc, _mm256_abs_epi16(_mm256_sub_epi16(rv, cv)));
                        int d = cr[x] - rr[x + 16];
                        sad8 += d < 0 ? -d : d;
                    }
                }
                const int ady = dy < 0 ? -dy : dy;
                __m256i cost = _mm256_add_epi16(
                    _mm256_slli_epi16(acc, 2),
                    _mm256_add_epi16(pen_dx, _mm256_set1_epi16(ady)));
                // min across lanes; scalar lane scan only on improvement
                __m256i m = _mm256_min_epu16(
                    cost, _mm256_permute2x128_si256(cost, cost, 1));
                m = _mm256_min_epu16(m, _mm256_bsrli_epi128(m, 8));
                m = _mm256_min_epu16(m, _mm256_bsrli_epi128(m, 4));
                m = _mm256_min_epu16(m, _mm256_bsrli_epi128(m, 2));
                const uint32_t dymin =
                    (uint16_t)_mm256_extract_epi16(m, 0);
                if (dymin < best) {
                    _mm256_store_si256((__m256i*)lane, cost);
                    for (int i = 0; i < 16; i++)
                        if (lane[i] < best) {
                            best = lane[i];
                            bdx = i - 8;
                            bdy = dy;
                        }
                }
                const uint32_t c8 = ((uint32_t)sad8 << 2) + 8 + ady;
                if (c8 < best) {
                    best = c8;
                    bdx = 8;
                    bdy = dy;
                }
            }
            seeds[((int64_t)by * wb + bx) * 2] = (int16_t)(4 * bdx);
            seeds[((int64_t)by * wb + bx) * 2 + 1] = (int16_t)(4 * bdy);
        }
#else
    for (int by = by0; by < by1; by++)
        for (int bx = 0; bx < wb; bx++) {
            const int16_t* c0 = cur + (int64_t)(by * 4) * cw + bx * 4;
            int64_t best = INT64_MAX;
            int bdx = 0, bdy = 0;
            for (int dy = -8; dy <= 8; dy++) {
                const int16_t* r0 = ref
                    + (int64_t)(by * 4 + dy + border) * rw
                    + (bx * 4 + border);
                for (int dx = -8; dx <= 8; dx++) {
                    int sad = 0;
                    for (int y = 0; y < 4; y++) {
                        const int16_t* cr = c0 + (int64_t)y * cw;
                        const int16_t* rr = r0 + (int64_t)y * rw + dx;
                        for (int x = 0; x < 4; x++) {
                            int d = cr[x] - rr[x];
                            sad += d < 0 ? -d : d;
                        }
                    }
                    const int64_t cost = ((int64_t)sad << 2)
                        + (dx < 0 ? -dx : dx) + (dy < 0 ? -dy : dy);
                    if (cost < best) {
                        best = cost;
                        bdx = dx;
                        bdy = dy;
                    }
                }
            }
            seeds[((int64_t)by * wb + bx) * 2] = (int16_t)(4 * bdx);
            seeds[((int64_t)by * wb + bx) * 2 + 1] = (int16_t)(4 * bdy);
        }
#endif
}

// ------------------------------------------------------- dense ME field
// Exhaustive +/-8 full-pel SAD sweep per 16x16 block around the lowres
// pre-ME seed, over edge-replicated padded planes (so every SAD is a full
// 16x16 block read and the arithmetic is identical across the Python /
// native / XLA twins). cost = (SAD << 2) + |ox| + |oy|, scan-order (oy,
// ox ascending) strict-improvement tie-break. Python oracle:
// inter_search._dense_field; device twin: device_analysis.dense_field_*.
static const int DENSE_R = 8;       // +/- full-pel window around the seed
static const int DENSE_P = 48;      // ref pad border (max |seed|=36 +8+ext)

static const int DENSE_W = 2 * DENSE_R + 1;  // 17: window side / surface

template <typename S>
static void dense_search_rows(const S* cur, const S* ref, int wb, int hb,
                              const int16_t* seeds, int by0, int by1,
                              int16_t* out, int32_t* out_sad,
                              int32_t* out_surf) {
    const int cw = wb * 16;
    const int rw = wb * 16 + 2 * DENSE_P;
    for (int by = by0; by < by1; by++)
        for (int bx = 0; bx < wb; bx++) {
            const S* c0 = cur + (int64_t)(by * 16) * cw + bx * 16;
            const int sx = seeds[((int64_t)by * wb + bx) * 2];
            const int sy = seeds[((int64_t)by * wb + bx) * 2 + 1];
            const S* r00 = ref
                + (int64_t)(by * 16 + sy - DENSE_R + DENSE_P) * rw
                + (bx * 16 + sx - DENSE_R + DENSE_P);
            int32_t* surf = out_surf
                ? out_surf + ((int64_t)by * wb + bx) * DENSE_W * DENSE_W
                : nullptr;
            uint32_t best = UINT32_MAX, bsad = 0;
            int box = 0, boy = 0;
#if defined(__SSE2__) || defined(_M_X64) || defined(__x86_64__)
            if (sizeof(S) == 1) {
                for (int oy = 0; oy < DENSE_W; oy++) {
                    const uint8_t* r0 = (const uint8_t*)(r00
                        + (int64_t)oy * rw);
                    for (int ox = 0; ox < DENSE_W; ox++) {
                        __m128i acc = _mm_setzero_si128();
                        for (int y = 0; y < 16; y++) {
                            const __m128i cv = _mm_loadu_si128(
                                (const __m128i*)((const uint8_t*)c0
                                                 + (int64_t)y * cw));
                            const __m128i rv = _mm_loadu_si128(
                                (const __m128i*)(r0 + (int64_t)y * rw
                                                 + ox));
                            acc = _mm_add_epi64(acc,
                                                _mm_sad_epu8(cv, rv));
                        }
                        const uint32_t sad =
                            (uint32_t)(_mm_cvtsi128_si64(acc)
                                       + _mm_extract_epi16(acc, 4));
                        if (surf)
                            surf[oy * DENSE_W + ox] = (int32_t)sad;
                        const uint32_t cost = (sad << 2)
                            + (ox < DENSE_R ? DENSE_R - ox : ox - DENSE_R)
                            + (oy < DENSE_R ? DENSE_R - oy : oy - DENSE_R);
                        if (cost < best) {
                            best = cost;
                            bsad = sad;
                            box = ox;
                            boy = oy;
                        }
                    }
                }
            } else
#endif
            {
                for (int oy = 0; oy < DENSE_W; oy++)
                    for (int ox = 0; ox < DENSE_W; ox++) {
                        const S* r0 = r00 + (int64_t)oy * rw + ox;
                        uint32_t sad = 0;
                        for (int y = 0; y < 16; y++) {
                            const S* cr = c0 + (int64_t)y * cw;
                            const S* rr = r0 + (int64_t)y * rw;
                            for (int x = 0; x < 16; x++) {
                                const int d = (int)cr[x] - (int)rr[x];
                                sad += d < 0 ? -d : d;
                            }
                        }
                        if (surf)
                            surf[oy * DENSE_W + ox] = (int32_t)sad;
                        const uint32_t cost = (sad << 2)
                            + (ox < DENSE_R ? DENSE_R - ox : ox - DENSE_R)
                            + (oy < DENSE_R ? DENSE_R - oy : oy - DENSE_R);
                        if (cost < best) {
                            best = cost;
                            bsad = sad;
                            box = ox;
                            boy = oy;
                        }
                    }
            }
            out[((int64_t)by * wb + bx) * 2] = (int16_t)(sx + box - DENSE_R);
            out[((int64_t)by * wb + bx) * 2 + 1] =
                (int16_t)(sy + boy - DENSE_R);
            if (out_sad)
                out_sad[(int64_t)by * wb + bx] = (int32_t)bsad;
        }
}

// pad src (h, w) to (hb*16 + 2*border, wb*16 + 2*border) by edge
// replication (grid extension first, then the border)
template <typename S>
static void dense_pad_plane(const int16_t* src, int w, int h, int wb,
                            int hb, int border, S* dst) {
    const int dw = wb * 16 + 2 * border;
    const int dh = hb * 16 + 2 * border;
    for (int y = 0; y < dh; y++) {
        int sy = y - border;
        sy = sy < 0 ? 0 : (sy >= h ? h - 1 : sy);
        const int16_t* row = src + (int64_t)sy * w;
        S* drow = dst + (int64_t)y * dw;
        for (int x = 0; x < dw; x++) {
            int sx = x - border;
            sx = sx < 0 ? 0 : (sx >= w ? w - 1 : sx);
            drow[x] = (S)row[sx];
        }
    }
}

static void dense_prepass(int nthreads) {
    PhaseTimer pt(24);
    int ext[2] = {0, 0};
    if (en.dense_external) {
        // device stage installed fields — possibly only for some lists
        // (a B picture's distinct list-1 ref-0 plane may be missing when
        // the facade only analysed list 0); keep what was installed and
        // compute the rest in-picture so native matches the lazy
        // per-plane Python twin
        en.dense_external = 0;
        ext[0] = en.have_dense[0];
        ext[1] = en.have_dense[1];
        if (ext[0] && ext[1])
            return;
    }
    en.have_dense[0] = ext[0];
    en.have_dense[1] = ext[1];
    // installed surfaces survive only with their installed dense field
    if (!ext[0])
        en.have_surf[0] = 0;
    if (!ext[1])
        en.have_surf[1] = 0;
    static const bool off = getenv("TC_NO_DENSEME") != nullptr;
    if (off || g_sp.is_i || en.search_range < 16)
        return;
    if (en.ovl.active)
        return;  // overlap: refs are still encoding — external fields
                 // (source-referenced) only, never an in-picture sweep
    const int w = g_sp.pic_w, h = g_sp.pic_h;
    const int wb = en.seed_wb, hb = en.seed_hb;
    const bool u8 = g_sp.bit_depth_y == 8;
    static thread_local std::vector<uint8_t> cur8_pad, ref8_pad;
    static thread_local std::vector<int16_t> cur16_pad, ref16_pad;
    bool have_cur = false;
    for (int l = 0; l < 2; l++) {
        if (ext[l])
            continue;  // externally installed for this list
        if (!en.have_seed[l] || !en.refs[l][0][0])
            continue;
        if (l == 1 && en.refs[0][0][0] == en.refs[1][0][0]
            && en.have_dense[0] && en.seed_mv[0] == en.seed_mv[1]) {
            // GPB: same plane + same seeds -> same dense field
            en.dense_mv[1] = en.dense_mv[0];
            en.have_dense[1] = 1;
            if (en.have_surf[0]) {
                en.dense_surf[1] = en.dense_surf[0];
                en.have_surf[1] = 1;
            }
            continue;
        }
        if (!have_cur) {
            if (u8) {
                cur8_pad.resize((size_t)hb * 16 * (wb * 16));
                dense_pad_plane<uint8_t>(en.orig[0], w, h, wb, hb, 0,
                                         cur8_pad.data());
            } else {
                cur16_pad.resize((size_t)hb * 16 * (wb * 16));
                dense_pad_plane<int16_t>(en.orig[0], w, h, wb, hb, 0,
                                         cur16_pad.data());
            }
            have_cur = true;
        }
        const size_t rsz = (size_t)(hb * 16 + 2 * DENSE_P)
            * (wb * 16 + 2 * DENSE_P);
        if (u8) {
            ref8_pad.resize(rsz);
            dense_pad_plane<uint8_t>(en.refs[l][0][0], w, h, wb, hb,
                                     DENSE_P, ref8_pad.data());
        } else {
            ref16_pad.resize(rsz);
            dense_pad_plane<int16_t>(en.refs[l][0][0], w, h, wb, hb,
                                     DENSE_P, ref16_pad.data());
        }
        en.dense_mv[l].resize((size_t)hb * wb * 2);
        static const bool surf_off = getenv("TC_NO_ME_SURF") != nullptr;
        int32_t* surf = nullptr;
        if (!surf_off) {
            en.dense_surf[l].resize((size_t)hb * wb * DENSE_W * DENSE_W);
            surf = en.dense_surf[l].data();
        }
        const int16_t* seeds = en.seed_mv[l].data();
        int16_t* out = en.dense_mv[l].data();
        const int T = std::max(1, std::min(nthreads, hb));
        // raw pointers: the scratch vectors are thread_local, so helper
        // threads must receive the spawner's storage, not their own
        const uint8_t* c8p = u8 ? cur8_pad.data() : nullptr;
        const uint8_t* r8p = u8 ? ref8_pad.data() : nullptr;
        const int16_t* c16p = u8 ? nullptr : cur16_pad.data();
        const int16_t* r16p = u8 ? nullptr : ref16_pad.data();
        auto rows = [=](int by0, int by1) {
            if (u8)
                dense_search_rows<uint8_t>(c8p, r8p, wb, hb, seeds,
                                           by0, by1, out, nullptr, surf);
            else
                dense_search_rows<int16_t>(c16p, r16p, wb, hb, seeds,
                                           by0, by1, out, nullptr, surf);
        };
        if (T > 1) {
            // helper threads inherit the spawner's picture context
            SP* sp_ = g_sp_ptr;
            EN* en_ = g_en_ptr;
            auto trows = [&rows, sp_, en_](int a, int b) {
                g_sp_ptr = sp_;
                g_en_ptr = en_;
                rows(a, b);
            };
            std::vector<std::thread> ts;
            for (int t = 0; t < T; t++)
                ts.emplace_back(trows, hb * t / T, hb * (t + 1) / T);
            for (auto& th : ts)
                th.join();
        } else {
            rows(0, hb);
        }
        en.have_dense[l] = 1;
        en.have_surf[l] = surf != nullptr;
    }
}

static void lowres_prepass_seeds(int nthreads) {
    PhaseTimer pt_lr(15);
    int ext[2] = {0, 0};
    if (en.seeds_external) {
        // device pre-ME installed seed fields — possibly only for some
        // lists (partial install on B pictures with a distinct list-1
        // ref-0 plane); compute the missing lists in-picture
        en.seeds_external = 0;
        ext[0] = en.have_seed[0];
        ext[1] = en.have_seed[1];
        if (ext[0] && ext[1])
            return;
    }
    en.have_seed[0] = ext[0];
    en.have_seed[1] = ext[1];
    static const bool off = getenv("TC_NO_LOWRES") != nullptr;
    if (off || g_sp.is_i || en.search_range < 16)
        return;
    if (en.ovl.active)
        return;  // overlap: external (source-referenced) seeds only
    const int w = g_sp.pic_w, h = g_sp.pic_h;
    const int lw = (w + 3) >> 2, lh = (h + 3) >> 2;
    const int wb = (lw + 3) >> 2, hb = (lh + 3) >> 2;
    const int B = 8;
    en.seed_wb = wb;
    en.seed_hb = hb;
    en.lr_cur.resize((size_t)(hb * 4 + 2 * B) * (wb * 4 + 2 * B));
    lowres_plane<4, 4>(en.orig[0], w, h, wb, hb, B, en.lr_cur.data());
    // skip the unpadded interior offset: search reads cur without border
    const int cw = wb * 4, dw = wb * 4 + 2 * B;
    static thread_local std::vector<int16_t> cur_tight;
    cur_tight.resize((size_t)hb * 4 * cw);
    for (int y = 0; y < hb * 4; y++)
        std::memcpy(cur_tight.data() + (int64_t)y * cw,
                    en.lr_cur.data() + (int64_t)(y + B) * dw + B,
                    cw * sizeof(int16_t));
    // half-res planes for the +/-2 refinement stage (border 24 covers the
    // +/-16 half-res reach of a +/-8 quarter-res winner plus the +/-2
    // refine and the 8-sample block extent)
    const int B2 = 24;
    const int cw2 = wb * 8, dw2 = wb * 8 + 2 * B2;
    static thread_local std::vector<int16_t> cur_half, cur_half_t;
    cur_half.resize((size_t)(hb * 8 + 2 * B2) * dw2);
    lowres_plane<2, 8>(en.orig[0], w, h, wb, hb, B2, cur_half.data());
    cur_half_t.resize((size_t)hb * 8 * cw2);
    for (int y = 0; y < hb * 8; y++)
        std::memcpy(cur_half_t.data() + (int64_t)y * cw2,
                    cur_half.data() + (int64_t)(y + B2) * dw2 + B2,
                    cw2 * sizeof(int16_t));
    static thread_local std::vector<int16_t> ref_half;
    for (int l = 0; l < 2; l++) {
        if (ext[l])
            continue;  // externally installed for this list
        const int16_t* ref = en.refs[l][0][0];
        if (!ref)
            continue;
        if (l == 1 && en.refs[0][0][0] == ref && en.have_seed[0]) {
            en.seed_mv[1] = en.seed_mv[0];  // GPB shares the plane
            en.have_seed[1] = 1;
            continue;
        }
        en.lr_ref[l].resize((size_t)(hb * 4 + 2 * B) * dw);
        lowres_plane<4, 4>(ref, w, h, wb, hb, B, en.lr_ref[l].data());
        ref_half.resize((size_t)(hb * 8 + 2 * B2) * dw2);
        lowres_plane<2, 8>(ref, w, h, wb, hb, B2, ref_half.data());
        en.seed_mv[l].resize((size_t)hb * wb * 2);
        const int T = std::max(1, std::min(nthreads, hb));
        // raw pointers: the scratch vectors are thread_local, so helper
        // threads must receive the spawner's storage, not their own
        const int16_t* ctp = cur_tight.data();
        const int16_t* lrp = en.lr_ref[l].data();
        const int16_t* chp = cur_half_t.data();
        const int16_t* rhp = ref_half.data();
        int16_t* smp = en.seed_mv[l].data();
        auto rows = [=](int by0, int by1) {
            lowres_search_rows(ctp, lrp, wb, hb, B, by0, by1, smp);
            halfres_refine_rows(chp, rhp, wb, hb, B2, by0, by1, smp);
        };
        if (T > 1) {
            // helper threads inherit the spawner's picture context
            SP* sp_ = g_sp_ptr;
            EN* en_ = g_en_ptr;
            auto trows = [&rows, sp_, en_](int a, int b) {
                g_sp_ptr = sp_;
                g_en_ptr = en_;
                rows(a, b);
            };
            std::vector<std::thread> ts;
            for (int t = 0; t < T; t++)
                ts.emplace_back(trows, hb * t / T, hb * (t + 1) / T);
            for (auto& th : ts)
                th.join();
        } else {
            rows(0, hb);
        }
        en.have_seed[l] = 1;
    }
}

static void lowres_prepass(int nthreads) {
    lowres_prepass_seeds(nthreads);
    dense_prepass(nthreads);
}

// Per-CTU mutable state. thread_local so WPP rows can run on independent
// threads (tc_enc_picture nthreads>1): each row thread owns its own CABAC
// rate contexts, id counters, and lambda/QP operating point — the analogue
// of the reference's one-TaskEncodeSubstream-per-row state
// (TaskEncodeSubstream.cpp:151).
struct EnCur {
    uint8_t* ctx;
    int32_t* ids;   // [cu, pu, tu]
    int qp_full, qp_cb_full, qp_cr_full;
    double lam, lam_bits, lam_me;
    int err;
    // committed fractional bits (1/256) of the current CTU's chosen path —
    // equals the writer's estimate re-walk exactly (checkRate invariant)
    int64_t ctu_frac;
    // last 2Nx2N integer-search best (quarter-pel), per list — ME seed
    // (Search.hpp mvPreviousInteger2Nx2N); reset per CTU row so results
    // are identical at any WPP thread count
    int prev_int_mv[2][2];
    int prev_int_valid[2];
};

thread_local EnCur cur;

// per-CU AQ query (reference getAqOffset at min(depth, aqDepth),
// Search.hpp:1145): every CU trial quantizes at its layer's FULL QPs
static inline void aq_set_cu_qp(int x0, int y0, int depth) {
    const int l = depth < en.aq_depth ? depth : en.aq_depth;
    const int sh = g_sp.ctb_log2 - l;
    const size_t i = (size_t)(y0 >> sh) * en.aq_wn[l] + (x0 >> sh);
    cur.qp_full = en.aq_qp[l][0][i];
    cur.qp_cb_full = en.aq_qp[l][1][i];
    cur.qp_cr_full = en.aq_qp[l][2][i];
}

inline int cw_() { return g_sp.pic_w >> 1; }
inline int chh_() { return g_sp.pic_h >> 1; }

// ---------------------------------------------------------------- math

// Hadamard SATD of an int32 block pair (encode/sweep.satd_many oracle).
// Vector-friendly form: column-direction butterflies are whole-row ops, so
// apply them, transpose, apply again — sum|H d^T H| == sum|H d H|.
template <int BS>
static int64_t satd_block_t(const int32_t* a, const int32_t* b, int stride_a,
                            int stride_b) {
    int32_t d[BS][BS], t[BS][BS];
    for (int y = 0; y < BS; y++)
        for (int x = 0; x < BS; x++)
            d[y][x] = a[y * stride_a + x] - b[y * stride_b + x];
    for (int len = 1; len < BS; len <<= 1)
        for (int i = 0; i < BS; i += len << 1)
            for (int j = i; j < i + len; j++)
                for (int x = 0; x < BS; x++) {
                    int32_t u = d[j][x], v = d[j + len][x];
                    d[j][x] = u + v;
                    d[j + len][x] = u - v;
                }
    for (int y = 0; y < BS; y++)
        for (int x = 0; x < BS; x++)
            t[y][x] = d[x][y];
    for (int len = 1; len < BS; len <<= 1)
        for (int i = 0; i < BS; i += len << 1)
            for (int j = i; j < i + len; j++)
                for (int x = 0; x < BS; x++) {
                    int32_t u = t[j][x], v = t[j + len][x];
                    t[j][x] = u + v;
                    t[j + len][x] = u - v;
                }
    int64_t s = 0;
    for (int y = 0; y < BS; y++) {
        int acc = 0;
        for (int x = 0; x < BS; x++)
            acc += t[y][x] < 0 ? -t[y][x] : t[y][x];
        s += acc;
    }
    return BS == 8 ? (s + 2) >> 2 : (s + 1) >> 1;
}

#ifdef __AVX2__
// 8x8 Hadamard SATD with whole rows as 8-lane int32 vectors: the butterfly
// levels become register add/sub pairs and only the transpose shuffles.
// Same exact integer arithmetic as satd_block_t<8> (bit-identical result).
static int64_t satd8_avx2(const int32_t* a, const int32_t* b, int stride_a,
                          int stride_b) {
    __m256i r[8];
    for (int y = 0; y < 8; y++)
        r[y] = _mm256_sub_epi32(
            _mm256_loadu_si256((const __m256i*)(a + y * stride_a)),
            _mm256_loadu_si256((const __m256i*)(b + y * stride_b)));
    auto butterfly = [&r]() {
        for (int len = 1; len < 8; len <<= 1)
            for (int i = 0; i < 8; i += len << 1)
                for (int j = i; j < i + len; j++) {
                    __m256i u = r[j], v = r[j + len];
                    r[j] = _mm256_add_epi32(u, v);
                    r[j + len] = _mm256_sub_epi32(u, v);
                }
    };
    butterfly();
    // 8x8 int32 transpose
    __m256i t0 = _mm256_unpacklo_epi32(r[0], r[1]);
    __m256i t1 = _mm256_unpackhi_epi32(r[0], r[1]);
    __m256i t2 = _mm256_unpacklo_epi32(r[2], r[3]);
    __m256i t3 = _mm256_unpackhi_epi32(r[2], r[3]);
    __m256i t4 = _mm256_unpacklo_epi32(r[4], r[5]);
    __m256i t5 = _mm256_unpackhi_epi32(r[4], r[5]);
    __m256i t6 = _mm256_unpacklo_epi32(r[6], r[7]);
    __m256i t7 = _mm256_unpackhi_epi32(r[6], r[7]);
    __m256i u0 = _mm256_unpacklo_epi64(t0, t2);
    __m256i u1 = _mm256_unpackhi_epi64(t0, t2);
    __m256i u2 = _mm256_unpacklo_epi64(t1, t3);
    __m256i u3 = _mm256_unpackhi_epi64(t1, t3);
    __m256i u4 = _mm256_unpacklo_epi64(t4, t6);
    __m256i u5 = _mm256_unpackhi_epi64(t4, t6);
    __m256i u6 = _mm256_unpacklo_epi64(t5, t7);
    __m256i u7 = _mm256_unpackhi_epi64(t5, t7);
    r[0] = _mm256_permute2x128_si256(u0, u4, 0x20);
    r[1] = _mm256_permute2x128_si256(u1, u5, 0x20);
    r[2] = _mm256_permute2x128_si256(u2, u6, 0x20);
    r[3] = _mm256_permute2x128_si256(u3, u7, 0x20);
    r[4] = _mm256_permute2x128_si256(u0, u4, 0x31);
    r[5] = _mm256_permute2x128_si256(u1, u5, 0x31);
    r[6] = _mm256_permute2x128_si256(u2, u6, 0x31);
    r[7] = _mm256_permute2x128_si256(u3, u7, 0x31);
    butterfly();
    __m256i acc = _mm256_abs_epi32(r[0]);
    for (int y = 1; y < 8; y++)
        acc = _mm256_add_epi32(acc, _mm256_abs_epi32(r[y]));
    __m128i lo = _mm256_castsi256_si128(acc);
    __m128i hi = _mm256_extracti128_si256(acc, 1);
    __m128i s4 = _mm_add_epi32(lo, hi);
    __m128i s2 = _mm_add_epi32(s4, _mm_srli_si128(s4, 8));
    __m128i s1 = _mm_add_epi32(s2, _mm_srli_si128(s2, 4));
    int64_t s = (int64_t)_mm_cvtsi128_si32(s1);
    return (s + 2) >> 2;
}

#ifdef __AVX512F__
// AVX-512 8x8 SATD: two rows per zmm, and the second (horizontal) hadamard
// runs via in-register lane shuffles instead of a transpose — the abs-sum
// is order-invariant, so the values match the transpose-based kernel.
static inline __m512i satd8_load2(const int32_t* p, int stride) {
    __m256i lo = _mm256_loadu_si256((const __m256i*)p);
    __m256i hi = _mm256_loadu_si256((const __m256i*)(p + stride));
    return _mm512_inserti64x4(_mm512_castsi256_si512(lo), hi, 1);
}

static int64_t satd8_avx512(const int32_t* a, const int32_t* b,
                            int stride_a, int stride_b) {
    __m512i r[4];
    for (int i = 0; i < 4; i++)
        r[i] = _mm512_sub_epi32(satd8_load2(a + 2 * i * stride_a, stride_a),
                                satd8_load2(b + 2 * i * stride_b, stride_b));
    // vertical stage 1: the distance-1 row pair lives in the two 256-bit
    // halves of each register
    for (int i = 0; i < 4; i++) {
        __m512i t = _mm512_shuffle_i64x2(r[i], r[i],
                                         _MM_SHUFFLE(1, 0, 3, 2));
        r[i] = _mm512_mask_sub_epi32(_mm512_add_epi32(r[i], t),
                                     (__mmask16)0xFF00, t, r[i]);
    }
    // vertical stages 2 and 3 across registers
    __m512i u;
    u = _mm512_add_epi32(r[0], r[1]);
    r[1] = _mm512_sub_epi32(r[0], r[1]);
    r[0] = u;
    u = _mm512_add_epi32(r[2], r[3]);
    r[3] = _mm512_sub_epi32(r[2], r[3]);
    r[2] = u;
    u = _mm512_add_epi32(r[0], r[2]);
    r[2] = _mm512_sub_epi32(r[0], r[2]);
    r[0] = u;
    u = _mm512_add_epi32(r[1], r[3]);
    r[3] = _mm512_sub_epi32(r[1], r[3]);
    r[1] = u;
    // horizontal stages within each 8-lane row
    for (int i = 0; i < 4; i++) {
        __m512i x = r[i], t;
        t = _mm512_shuffle_epi32(x, (_MM_PERM_ENUM)0xB1);  // distance 1
        x = _mm512_mask_sub_epi32(_mm512_add_epi32(x, t), (__mmask16)0xAAAA,
                                  t, x);
        t = _mm512_shuffle_epi32(x, (_MM_PERM_ENUM)0x4E);  // distance 2
        x = _mm512_mask_sub_epi32(_mm512_add_epi32(x, t), (__mmask16)0xCCCC,
                                  t, x);
        t = _mm512_shuffle_i64x2(x, x, _MM_SHUFFLE(2, 3, 0, 1));  // dist 4
        x = _mm512_mask_sub_epi32(_mm512_add_epi32(x, t), (__mmask16)0xF0F0,
                                  t, x);
        r[i] = _mm512_abs_epi32(x);
    }
    __m512i acc = _mm512_add_epi32(_mm512_add_epi32(r[0], r[1]),
                                   _mm512_add_epi32(r[2], r[3]));
    int64_t s = (int64_t)_mm512_reduce_add_epi32(acc);
    return (s + 2) >> 2;
}
#endif

#if defined(__AVX512BW__)
// 8-bit-content 8x8 SATD with int16 lanes: 4 rows per zmm (two registers
// for the whole block). Valid when |diff| <= 255 (8-bit pixels): the
// hadamard magnitudes stay <= 64*255 = 16320 < 2^15, so the int16
// butterflies are overflow-free and the result is bit-identical to the
// int32 kernels. ~1.5-2x fewer ops than the int32 zmm path.
static int64_t satd8_avx512_i16(const int32_t* a, const int32_t* b,
                                int stride_a, int stride_b) {
    // load 4 rows of a and b as int32, narrow the difference to int16
    __m512i r[2];
    for (int i = 0; i < 2; i++) {
        __m512i a0 = _mm512_sub_epi32(
            satd8_load2(a + 4 * i * stride_a, stride_a),
            satd8_load2(b + 4 * i * stride_b, stride_b));
        __m512i a1 = _mm512_sub_epi32(
            satd8_load2(a + (4 * i + 2) * stride_a, stride_a),
            satd8_load2(b + (4 * i + 2) * stride_b, stride_b));
        // rows {4i, 4i+1} in a0 halves, {4i+2, 4i+3} in a1 halves
        __m256i lo = _mm512_cvtepi32_epi16(a0);
        __m256i hi = _mm512_cvtepi32_epi16(a1);
        r[i] = _mm512_inserti64x4(_mm512_castsi256_si512(lo), hi, 1);
        // layout of r[i]: 128-bit lanes = rows 4i, 4i+1, 4i+2, 4i+3
    }
    // vertical stage 1 (row distance 1): adjacent 128-bit lanes
    for (int i = 0; i < 2; i++) {
        __m512i t = _mm512_shuffle_i64x2(r[i], r[i],
                                         _MM_SHUFFLE(2, 3, 0, 1));
        r[i] = _mm512_mask_sub_epi16(_mm512_add_epi16(r[i], t),
                                     (__mmask32)0xFF00FF00, t, r[i]);
    }
    // vertical stage 2 (distance 2): lane pairs within each register
    for (int i = 0; i < 2; i++) {
        __m512i t = _mm512_shuffle_i64x2(r[i], r[i],
                                         _MM_SHUFFLE(1, 0, 3, 2));
        r[i] = _mm512_mask_sub_epi16(_mm512_add_epi16(r[i], t),
                                     (__mmask32)0xFFFF0000, t, r[i]);
    }
    // vertical stage 3 (distance 4): across the two registers
    __m512i u = _mm512_add_epi16(r[0], r[1]);
    r[1] = _mm512_sub_epi16(r[0], r[1]);
    r[0] = u;
    // horizontal stages within each 8-lane row
    const __m512i swap16 = _mm512_set_epi8(
        61, 60, 63, 62, 57, 56, 59, 58, 53, 52, 55, 54, 49, 48, 51, 50,
        45, 44, 47, 46, 41, 40, 43, 42, 37, 36, 39, 38, 33, 32, 35, 34,
        29, 28, 31, 30, 25, 24, 27, 26, 21, 20, 23, 22, 17, 16, 19, 18,
        13, 12, 15, 14, 9, 8, 11, 10, 5, 4, 7, 6, 1, 0, 3, 2);
    __m512i acc = _mm512_setzero_si512();
    const __m512i ones = _mm512_set1_epi16(1);
    for (int i = 0; i < 2; i++) {
        __m512i x = r[i], t;
        t = _mm512_shuffle_epi8(x, swap16);  // distance 1
        x = _mm512_mask_sub_epi16(_mm512_add_epi16(x, t),
                                  (__mmask32)0xAAAAAAAA, t, x);
        t = _mm512_shuffle_epi32(x, (_MM_PERM_ENUM)0xB1);  // distance 2
        x = _mm512_mask_sub_epi16(_mm512_add_epi16(x, t),
                                  (__mmask32)0xCCCCCCCC, t, x);
        t = _mm512_shuffle_epi32(x, (_MM_PERM_ENUM)0x4E);  // distance 4
        x = _mm512_mask_sub_epi16(_mm512_add_epi16(x, t),
                                  (__mmask32)0xF0F0F0F0, t, x);
        acc = _mm512_add_epi32(acc,
                               _mm512_madd_epi16(_mm512_abs_epi16(x),
                                                 ones));
    }
    int64_t s = (int64_t)_mm512_reduce_add_epi32(acc);
    return (s + 2) >> 2;
}
#endif

// 4x4 hadamard core on difference rows already in registers
static inline int64_t satd4_rows(__m128i r0, __m128i r1, __m128i r2,
                                 __m128i r3) {
    __m128i r[4] = {r0, r1, r2, r3};
    auto butterfly = [&r]() {
        __m128i u0 = _mm_add_epi32(r[0], r[1]);
        __m128i u1 = _mm_sub_epi32(r[0], r[1]);
        __m128i u2 = _mm_add_epi32(r[2], r[3]);
        __m128i u3 = _mm_sub_epi32(r[2], r[3]);
        r[0] = _mm_add_epi32(u0, u2);
        r[2] = _mm_sub_epi32(u0, u2);
        r[1] = _mm_add_epi32(u1, u3);
        r[3] = _mm_sub_epi32(u1, u3);
    };
    butterfly();
    __m128i t0 = _mm_unpacklo_epi32(r[0], r[1]);
    __m128i t1 = _mm_unpackhi_epi32(r[0], r[1]);
    __m128i t2 = _mm_unpacklo_epi32(r[2], r[3]);
    __m128i t3 = _mm_unpackhi_epi32(r[2], r[3]);
    r[0] = _mm_unpacklo_epi64(t0, t2);
    r[1] = _mm_unpackhi_epi64(t0, t2);
    r[2] = _mm_unpacklo_epi64(t1, t3);
    r[3] = _mm_unpackhi_epi64(t1, t3);
    butterfly();
    __m128i acc = _mm_abs_epi32(r[0]);
    for (int y = 1; y < 4; y++)
        acc = _mm_add_epi32(acc, _mm_abs_epi32(r[y]));
    __m128i s2 = _mm_add_epi32(acc, _mm_srli_si128(acc, 8));
    __m128i s1 = _mm_add_epi32(s2, _mm_srli_si128(s2, 4));
    int64_t s = (int64_t)_mm_cvtsi128_si32(s1);
    return (s + 1) >> 1;
}

// 4x4 variant: rows as 4-lane int32 vectors
static int64_t satd4_avx2(const int32_t* a, const int32_t* b, int stride_a,
                          int stride_b) {
    __m128i r[4];
    for (int y = 0; y < 4; y++)
        r[y] = _mm_sub_epi32(
            _mm_loadu_si128((const __m128i*)(a + y * stride_a)),
            _mm_loadu_si128((const __m128i*)(b + y * stride_b)));
    return satd4_rows(r[0], r[1], r[2], r[3]);
}
#endif

inline int64_t satd_block(const int32_t* a, const int32_t* b, int stride_a,
                          int stride_b, int bs) {
#if defined(__AVX512BW__)
    if (bs == 8 && g_satd_i16)
        return satd8_avx512_i16(a, b, stride_a, stride_b);
#endif
#if defined(__AVX512F__)
    return bs == 8 ? satd8_avx512(a, b, stride_a, stride_b)
                   : satd4_avx2(a, b, stride_a, stride_b);
#elif defined(__AVX2__)
    return bs == 8 ? satd8_avx2(a, b, stride_a, stride_b)
                   : satd4_avx2(a, b, stride_a, stride_b);
#else
    return bs == 8 ? satd_block_t<8>(a, b, stride_a, stride_b)
                   : satd_block_t<4>(a, b, stride_a, stride_b);
#endif
}

// exact int64 sum of squared differences over contiguous int32 buffers
// (widening products keep vectorization; integer sums are order-exact)
inline int64_t ssd_i32(const int32_t* a, const int32_t* b, int len) {
    int64_t s = 0;
    int i = 0;
#ifdef __AVX2__
    __m256i acc = _mm256_setzero_si256();  // 4 int64 lanes
    for (; i + 8 <= len; i += 8) {
        __m256i d = _mm256_sub_epi32(
            _mm256_loadu_si256((const __m256i*)(a + i)),
            _mm256_loadu_si256((const __m256i*)(b + i)));
        acc = _mm256_add_epi64(acc, _mm256_mul_epi32(d, d));
        __m256i o = _mm256_srli_epi64(d, 32);
        acc = _mm256_add_epi64(acc, _mm256_mul_epi32(o, o));
    }
    alignas(32) int64_t buf[4];
    _mm256_store_si256((__m256i*)buf, acc);
    s = buf[0] + buf[1] + buf[2] + buf[3];
#endif
    for (; i < len; i++) {
        int64_t e = a[i] - b[i];
        s += e * e;
    }
    return s;
}

// SATD over an (h, w) region partitioned into bs x bs blocks
int64_t satd_region(const int32_t* a, const int32_t* b, int w, int h,
                    int bs) {
    LeafTimer pt(11);
    int64_t total = 0;
    for (int y = 0; y < h; y += bs)
        for (int x = 0; x < w; x += bs)
            total += satd_block(a + y * w + x, b + y * w + x, w, w, bs);
    return total;
}

// int16-vs-int16 SAD over an interior (no clamping) window: the original
// block is packed to int16 once per motion search, halving loads and
// doubling lane width vs the int32 path. Sums are exact (|d| <= 2^bd).
static int64_t sad16_interior(const int16_t* o, int bw, int bh,
                              const int16_t* ref, int rw, int x0, int y0) {
    int64_t s = 0;
#if defined(__AVX512BW__)
    const __m512i one16 = _mm512_set1_epi16(1);
    __m512i acc = _mm512_setzero_si512();
    __m256i acc2 = _mm256_setzero_si256();
    for (int y = 0; y < bh; y++) {
        const int16_t* r = ref + (int64_t)(y0 + y) * rw + x0;
        const int16_t* a = o + y * bw;
        int x = 0;
        for (; x + 32 <= bw; x += 32) {
            __m512i d = _mm512_sub_epi16(
                _mm512_loadu_si512((const void*)(a + x)),
                _mm512_loadu_si512((const void*)(r + x)));
            acc = _mm512_add_epi32(
                acc, _mm512_madd_epi16(_mm512_abs_epi16(d), one16));
        }
        for (; x + 16 <= bw; x += 16) {
            __m256i d = _mm256_sub_epi16(
                _mm256_loadu_si256((const __m256i*)(a + x)),
                _mm256_loadu_si256((const __m256i*)(r + x)));
            acc2 = _mm256_add_epi32(
                acc2, _mm256_madd_epi16(_mm256_abs_epi16(d),
                                        _mm256_set1_epi16(1)));
        }
        for (; x < bw; x++) {
            int d = a[x] - r[x];
            s += d < 0 ? -d : d;
        }
    }
    s += _mm512_reduce_add_epi32(acc);
    alignas(32) int32_t b8[8];
    _mm256_store_si256((__m256i*)b8, acc2);
    for (int i = 0; i < 8; i++)
        s += b8[i];
#elif defined(__AVX2__)
    const __m256i one16 = _mm256_set1_epi16(1);
    __m256i acc = _mm256_setzero_si256();
    for (int y = 0; y < bh; y++) {
        const int16_t* r = ref + (int64_t)(y0 + y) * rw + x0;
        const int16_t* a = o + y * bw;
        int x = 0;
        for (; x + 16 <= bw; x += 16) {
            __m256i d = _mm256_sub_epi16(
                _mm256_loadu_si256((const __m256i*)(a + x)),
                _mm256_loadu_si256((const __m256i*)(r + x)));
            acc = _mm256_add_epi32(
                acc, _mm256_madd_epi16(_mm256_abs_epi16(d), one16));
        }
        for (; x < bw; x++) {
            int d = a[x] - r[x];
            s += d < 0 ? -d : d;
        }
    }
    alignas(32) int32_t b8[8];
    _mm256_store_si256((__m256i*)b8, acc);
    for (int i = 0; i < 8; i++)
        s += b8[i];
#else
    for (int y = 0; y < bh; y++)
        for (int x = 0; x < bw; x++) {
            int d = o[y * bw + x] - ref[(int64_t)(y0 + y) * rw + x0 + x];
            s += d < 0 ? -d : d;
        }
#endif
    return s;
}

// 4 interior SADs sharing the original block's loads (the reference's
// havoc_sad_multiref / functionSad4 analogue). Per-position arithmetic is
// identical to sad16_interior, so results are bit-equal.
static void sad16_interior_x4(const int16_t* o, int bw, int bh,
                              const int16_t* ref, int rw, const int* px,
                              const int* py, int64_t out[4]) {
    int64_t s[4] = {0, 0, 0, 0};
#if defined(__AVX512BW__)
    const __m512i one16 = _mm512_set1_epi16(1);
    __m512i acc[4] = {_mm512_setzero_si512(), _mm512_setzero_si512(),
                      _mm512_setzero_si512(), _mm512_setzero_si512()};
    __m256i acc2[4] = {_mm256_setzero_si256(), _mm256_setzero_si256(),
                       _mm256_setzero_si256(), _mm256_setzero_si256()};
    for (int yy = 0; yy < bh; yy++) {
        const int16_t* a = o + yy * bw;
        const int16_t* r[4];
        for (int j = 0; j < 4; j++)
            r[j] = ref + (int64_t)(py[j] + yy) * rw + px[j];
        int xx = 0;
        for (; xx + 32 <= bw; xx += 32) {
            const __m512i av =
                _mm512_loadu_si512((const void*)(a + xx));
            for (int j = 0; j < 4; j++) {
                __m512i d = _mm512_sub_epi16(
                    av, _mm512_loadu_si512((const void*)(r[j] + xx)));
                acc[j] = _mm512_add_epi32(
                    acc[j], _mm512_madd_epi16(_mm512_abs_epi16(d), one16));
            }
        }
        for (; xx + 16 <= bw; xx += 16) {
            const __m256i av =
                _mm256_loadu_si256((const __m256i*)(a + xx));
            for (int j = 0; j < 4; j++) {
                __m256i d = _mm256_sub_epi16(
                    av, _mm256_loadu_si256((const __m256i*)(r[j] + xx)));
                acc2[j] = _mm256_add_epi32(
                    acc2[j], _mm256_madd_epi16(_mm256_abs_epi16(d),
                                               _mm256_set1_epi16(1)));
            }
        }
        for (; xx < bw; xx++)
            for (int j = 0; j < 4; j++) {
                int d = a[xx] - r[j][xx];
                s[j] += d < 0 ? -d : d;
            }
    }
    for (int j = 0; j < 4; j++) {
        s[j] += _mm512_reduce_add_epi32(acc[j]);
        alignas(32) int32_t b8[8];
        _mm256_store_si256((__m256i*)b8, acc2[j]);
        for (int i = 0; i < 8; i++)
            s[j] += b8[i];
        out[j] = s[j];
    }
#else
    for (int j = 0; j < 4; j++)
        out[j] = sad16_interior(o, bw, bh, ref, rw, px[j], py[j]);
#endif
}

// ---------------------------------------------------------------- u8 SAD
// 8-bit fast path: psadbw on uint8 shadows of the reference planes — the
// analogue of the reference's uint8 havoc_sad kernels (havoc/sad.cpp),
// which also run on 8-bit sample buffers. Values are bit-equal to the
// int16 kernels because all 8-bit samples fit in a byte.

static inline int64_t hsum_sad128(__m128i v) {
    return _mm_cvtsi128_si64(v) + _mm_extract_epi64(v, 1);
}

static int64_t sad8_interior(const uint8_t* o, int bw, int bh,
                             const uint8_t* ref, int rw, int x0, int y0) {
    const uint8_t* rb = ref + (int64_t)y0 * rw + x0;
    if (bw == 8) {
        __m128i acc = _mm_setzero_si128();
        for (int y = 0; y + 2 <= bh; y += 2) {
            __m128i a = _mm_unpacklo_epi64(
                _mm_loadl_epi64((const __m128i*)(o + y * 8)),
                _mm_loadl_epi64((const __m128i*)(o + (y + 1) * 8)));
            __m128i r = _mm_unpacklo_epi64(
                _mm_loadl_epi64((const __m128i*)(rb + (int64_t)y * rw)),
                _mm_loadl_epi64((const __m128i*)(rb + (int64_t)(y + 1) * rw)));
            acc = _mm_add_epi64(acc, _mm_sad_epu8(a, r));
        }
        return hsum_sad128(acc);
    }
    if (bw == 16) {
        __m128i acc = _mm_setzero_si128();
        for (int y = 0; y < bh; y++)
            acc = _mm_add_epi64(
                acc, _mm_sad_epu8(
                         _mm_loadu_si128((const __m128i*)(o + y * 16)),
                         _mm_loadu_si128(
                             (const __m128i*)(rb + (int64_t)y * rw))));
        return hsum_sad128(acc);
    }
    if ((bw & 31) == 0) {
        __m256i acc = _mm256_setzero_si256();
        for (int y = 0; y < bh; y++) {
            const uint8_t* a = o + y * bw;
            const uint8_t* r = rb + (int64_t)y * rw;
            for (int x = 0; x < bw; x += 32)
                acc = _mm256_add_epi64(
                    acc, _mm256_sad_epu8(
                             _mm256_loadu_si256((const __m256i*)(a + x)),
                             _mm256_loadu_si256((const __m256i*)(r + x))));
        }
        alignas(32) int64_t b4[4];
        _mm256_store_si256((__m256i*)b4, acc);
        return b4[0] + b4[1] + b4[2] + b4[3];
    }
    int64_t s = 0;  // odd widths (4/12/24/48): scalar
    for (int y = 0; y < bh; y++) {
        const uint8_t* a = o + y * bw;
        const uint8_t* r = rb + (int64_t)y * rw;
        for (int x = 0; x < bw; x++) {
            int d = (int)a[x] - (int)r[x];
            s += d < 0 ? -d : d;
        }
    }
    return s;
}

static void sad8_interior_x4(const uint8_t* o, int bw, int bh,
                             const uint8_t* ref, int rw, const int* px,
                             const int* py, int64_t out[4]) {
    const uint8_t* rb[4];
    for (int j = 0; j < 4; j++)
        rb[j] = ref + (int64_t)py[j] * rw + px[j];
    if (bw == 8) {
        __m128i acc[4] = {_mm_setzero_si128(), _mm_setzero_si128(),
                          _mm_setzero_si128(), _mm_setzero_si128()};
        for (int y = 0; y + 2 <= bh; y += 2) {
            __m128i a = _mm_unpacklo_epi64(
                _mm_loadl_epi64((const __m128i*)(o + y * 8)),
                _mm_loadl_epi64((const __m128i*)(o + (y + 1) * 8)));
            for (int j = 0; j < 4; j++) {
                __m128i r = _mm_unpacklo_epi64(
                    _mm_loadl_epi64(
                        (const __m128i*)(rb[j] + (int64_t)y * rw)),
                    _mm_loadl_epi64(
                        (const __m128i*)(rb[j] + (int64_t)(y + 1) * rw)));
                acc[j] = _mm_add_epi64(acc[j], _mm_sad_epu8(a, r));
            }
        }
        for (int j = 0; j < 4; j++)
            out[j] = hsum_sad128(acc[j]);
        return;
    }
    if (bw == 16) {
        __m128i acc[4] = {_mm_setzero_si128(), _mm_setzero_si128(),
                          _mm_setzero_si128(), _mm_setzero_si128()};
        for (int y = 0; y < bh; y++) {
            __m128i a = _mm_loadu_si128((const __m128i*)(o + y * 16));
            for (int j = 0; j < 4; j++)
                acc[j] = _mm_add_epi64(
                    acc[j],
                    _mm_sad_epu8(a, _mm_loadu_si128((const __m128i*)(
                                        rb[j] + (int64_t)y * rw))));
        }
        for (int j = 0; j < 4; j++)
            out[j] = hsum_sad128(acc[j]);
        return;
    }
    if ((bw & 31) == 0) {
        __m256i acc[4] = {_mm256_setzero_si256(), _mm256_setzero_si256(),
                          _mm256_setzero_si256(), _mm256_setzero_si256()};
        for (int y = 0; y < bh; y++) {
            const uint8_t* a = o + y * bw;
            for (int x = 0; x < bw; x += 32) {
                __m256i av = _mm256_loadu_si256((const __m256i*)(a + x));
                for (int j = 0; j < 4; j++)
                    acc[j] = _mm256_add_epi64(
                        acc[j],
                        _mm256_sad_epu8(
                            av, _mm256_loadu_si256((const __m256i*)(
                                    rb[j] + (int64_t)y * rw + x))));
            }
        }
        for (int j = 0; j < 4; j++) {
            alignas(32) int64_t b4[4];
            _mm256_store_si256((__m256i*)b4, acc[j]);
            out[j] = b4[0] + b4[1] + b4[2] + b4[3];
        }
        return;
    }
    for (int j = 0; j < 4; j++)
        out[j] = sad8_interior(o, bw, bh, ref, rw, px[j], py[j]);
}

// SAD of orig (int32, bh x bw) vs a clamped window of the int16 ref plane
int64_t sad_at(const int32_t* orig, int bw, int bh, const int16_t* ref,
               int rw, int rh, int x0, int y0) {
    if (x0 >= 0 && y0 >= 0 && x0 + bw <= rw && y0 + bh <= rh) {
        // interior fast path: no clamps -> vectorizable
        int64_t s = 0;
        for (int y = 0; y < bh; y++) {
            const int16_t* row = ref + (int64_t)(y0 + y) * rw + x0;
            const int32_t* orow = orig + y * bw;
            int acc = 0;
            for (int x = 0; x < bw; x++) {
                int d = orow[x] - row[x];
                acc += d < 0 ? -d : d;
            }
            s += acc;
        }
        return s;
    }
    int64_t s = 0;
    for (int y = 0; y < bh; y++) {
        int yc = clip3i(0, rh - 1, y0 + y);
        const int16_t* row = ref + (int64_t)yc * rw;
        for (int x = 0; x < bw; x++) {
            int d = orig[y * bw + x] - row[clip3i(0, rw - 1, x0 + x)];
            s += d < 0 ? -d : d;
        }
    }
    return s;
}

// HM forward transform (ops/transform.forward_transform_np).
// DCT path exploits the cosine symmetry m[r][n-1-j] == +/- m[r][j]
// (+ for even rows, - for odd): each output needs only a half-length dot
// against the even/odd folded input. Sums are regrouped exact-integer, so
// results stay bit-identical to the plain matrix product.
#ifdef __AVX2__
// Specialized 4x4 forward transform (DCT4 / DST4): both passes as SSE 4x4
// matrix products. Plain matrix products are bit-identical to the folded
// scalar path (integer adds regroup exactly; rounding only at the shifts).
struct Fwd4Mats {
    alignas(16) int32_t mt[2][4][4];  // [dst][x][i] = m[i][x] (transposed)
    alignas(16) int32_t mr[2][4][4];  // [dst][j][y] = m[j][y]
    Fwd4Mats() {
        for (int d = 0; d < 2; d++) {
            const int32_t* m = dct_matrix_for(2, d);
            for (int i = 0; i < 4; i++)
                for (int x = 0; x < 4; x++) {
                    mt[d][x][i] = m[i * 4 + x];
                    mr[d][i][x] = m[i * 4 + x];
                }
        }
    }
};

static void fwd_transform4(const int32_t* res, int bit_depth, int use_dst,
                           int32_t* out) {
    static const Fwd4Mats fm;
    const int shift1 = bit_depth - 7;  // log2n + bit_depth - 9
    const __m128i r1v =
        _mm_set1_epi32(shift1 > 0 ? 1 << (shift1 - 1) : 0);
    const __m128i r2v = _mm_set1_epi32(1 << 7);  // shift2 = 8
    const int d = use_dst ? 1 : 0;
    __m128i t[4];
    for (int y = 0; y < 4; y++) {
        const int32_t* x = res + y * 4;
        __m128i acc = _mm_mullo_epi32(
            _mm_set1_epi32(x[0]),
            _mm_load_si128((const __m128i*)fm.mt[d][0]));
        for (int j = 1; j < 4; j++)
            acc = _mm_add_epi32(
                acc, _mm_mullo_epi32(
                         _mm_set1_epi32(x[j]),
                         _mm_load_si128((const __m128i*)fm.mt[d][j])));
        t[y] = shift1 > 0
                   ? _mm_srai_epi32(_mm_add_epi32(acc, r1v), shift1)
                   : _mm_slli_epi32(acc, -shift1);
    }
    for (int j = 0; j < 4; j++) {
        const int32_t* mj = fm.mr[d][j];
        __m128i acc = _mm_mullo_epi32(_mm_set1_epi32(mj[0]), t[0]);
        for (int y = 1; y < 4; y++)
            acc = _mm_add_epi32(
                acc, _mm_mullo_epi32(_mm_set1_epi32(mj[y]), t[y]));
        _mm_storeu_si128((__m128i*)(out + j * 4),
                         _mm_srai_epi32(_mm_add_epi32(acc, r2v), 8));
    }
}

// Specialized 8x8 pass 1: the even/odd-folded row transform as two
// interleaved 4x4 matrix products (even output rows from the folded sums,
// odd rows from the folded differences), exactly the scalar folding.
struct Fwd8Mats {
    alignas(16) int32_t met[4][4];  // [x][k] = m[2k][x]
    alignas(16) int32_t mot[4][4];  // [x][k] = m[2k+1][x]
    Fwd8Mats() {
        const int32_t* m = dct_matrix_for(3, 0);
        for (int k = 0; k < 4; k++)
            for (int x = 0; x < 4; x++) {
                met[x][k] = m[(2 * k) * 8 + x];
                mot[x][k] = m[(2 * k + 1) * 8 + x];
            }
    }
};

static void fwd_transform8_pass1(const int32_t* res, int shift1,
                                 int32_t* t) {
    static const Fwd8Mats fm;
    const __m128i r1v =
        _mm_set1_epi32(shift1 > 0 ? 1 << (shift1 - 1) : 0);
    for (int y = 0; y < 8; y++) {
        const int32_t* x = res + y * 8;
        __m128i lo = _mm_loadu_si128((const __m128i*)x);
        __m128i hi = _mm_loadu_si128((const __m128i*)(x + 4));
        __m128i hir = _mm_shuffle_epi32(hi, _MM_SHUFFLE(0, 1, 2, 3));
        __m128i e = _mm_add_epi32(lo, hir);
        __m128i o = _mm_sub_epi32(lo, hir);
        __m128i acc_e = _mm_mullo_epi32(
            _mm_shuffle_epi32(e, 0x00),
            _mm_load_si128((const __m128i*)fm.met[0]));
        __m128i acc_o = _mm_mullo_epi32(
            _mm_shuffle_epi32(o, 0x00),
            _mm_load_si128((const __m128i*)fm.mot[0]));
        acc_e = _mm_add_epi32(
            acc_e, _mm_mullo_epi32(
                       _mm_shuffle_epi32(e, 0x55),
                       _mm_load_si128((const __m128i*)fm.met[1])));
        acc_o = _mm_add_epi32(
            acc_o, _mm_mullo_epi32(
                       _mm_shuffle_epi32(o, 0x55),
                       _mm_load_si128((const __m128i*)fm.mot[1])));
        acc_e = _mm_add_epi32(
            acc_e, _mm_mullo_epi32(
                       _mm_shuffle_epi32(e, 0xAA),
                       _mm_load_si128((const __m128i*)fm.met[2])));
        acc_o = _mm_add_epi32(
            acc_o, _mm_mullo_epi32(
                       _mm_shuffle_epi32(o, 0xAA),
                       _mm_load_si128((const __m128i*)fm.mot[2])));
        acc_e = _mm_add_epi32(
            acc_e, _mm_mullo_epi32(
                       _mm_shuffle_epi32(e, 0xFF),
                       _mm_load_si128((const __m128i*)fm.met[3])));
        acc_o = _mm_add_epi32(
            acc_o, _mm_mullo_epi32(
                       _mm_shuffle_epi32(o, 0xFF),
                       _mm_load_si128((const __m128i*)fm.mot[3])));
        if (shift1 > 0) {
            acc_e = _mm_srai_epi32(_mm_add_epi32(acc_e, r1v), shift1);
            acc_o = _mm_srai_epi32(_mm_add_epi32(acc_o, r1v), shift1);
        } else {
            acc_e = _mm_slli_epi32(acc_e, -shift1);
            acc_o = _mm_slli_epi32(acc_o, -shift1);
        }
        _mm_storeu_si128((__m128i*)(t + y * 8),
                         _mm_unpacklo_epi32(acc_e, acc_o));
        _mm_storeu_si128((__m128i*)(t + y * 8 + 4),
                         _mm_unpackhi_epi32(acc_e, acc_o));
    }
}
#endif

#ifdef __AVX2__
// Pass 1 for n=16/32 as a broadcast GEMM over the even/odd folded halves:
// t[y][2k] = sum_j MET[j][k]*e[j], t[y][2k+1] = sum_j MOT[j][k]*o[j].
// Exactly the scalar folding's integer sums, fully vectorized over k.
struct FwdFoldMats {
    alignas(32) int32_t met16[8][8], mot16[8][8];
    alignas(32) int32_t met32[16][16], mot32[16][16];
    FwdFoldMats() {
        const int32_t* m16 = dct_matrix_for(4, 0);
        for (int j = 0; j < 8; j++)
            for (int k = 0; k < 8; k++) {
                met16[j][k] = m16[(2 * k) * 16 + j];
                mot16[j][k] = m16[(2 * k + 1) * 16 + j];
            }
        const int32_t* m32 = dct_matrix_for(5, 0);
        for (int j = 0; j < 16; j++)
            for (int k = 0; k < 16; k++) {
                met32[j][k] = m32[(2 * k) * 32 + j];
                mot32[j][k] = m32[(2 * k + 1) * 32 + j];
            }
    }
};

// VECS = accumulator vectors per half (1 for n=16, 2 for n=32)
template <int VECS>
static void fwd_pass1_folded(const int32_t* res, int n, int shift1,
                             const int32_t (*met)[8 * VECS],
                             const int32_t (*mot)[8 * VECS], int32_t* t) {
    const int h = n >> 1;
    const __m256i r1v =
        _mm256_set1_epi32(shift1 > 0 ? 1 << (shift1 - 1) : 0);
    for (int y = 0; y < n; y++) {
        const int32_t* x = res + y * n;
        __m256i ae[VECS], ao[VECS];
        for (int v = 0; v < VECS; v++) {
            ae[v] = _mm256_setzero_si256();
            ao[v] = _mm256_setzero_si256();
        }
        for (int j = 0; j < h; j++) {
            const __m256i be = _mm256_set1_epi32(x[j] + x[n - 1 - j]);
            const __m256i bo = _mm256_set1_epi32(x[j] - x[n - 1 - j]);
            for (int v = 0; v < VECS; v++) {
                ae[v] = _mm256_add_epi32(
                    ae[v], _mm256_mullo_epi32(
                               be, _mm256_load_si256(
                                       (const __m256i*)(met[j] + 8 * v))));
                ao[v] = _mm256_add_epi32(
                    ao[v], _mm256_mullo_epi32(
                               bo, _mm256_load_si256(
                                       (const __m256i*)(mot[j] + 8 * v))));
            }
        }
        int32_t* ty = t + y * n;
        for (int v = 0; v < VECS; v++) {
            __m256i e = ae[v], o = ao[v];
            if (shift1 > 0) {
                e = _mm256_srai_epi32(_mm256_add_epi32(e, r1v), shift1);
                o = _mm256_srai_epi32(_mm256_add_epi32(o, r1v), shift1);
            } else {
                e = _mm256_slli_epi32(e, -shift1);
                o = _mm256_slli_epi32(o, -shift1);
            }
            // interleave even/odd outputs: [e0,o0,e1,o1,...]
            __m256i lo = _mm256_unpacklo_epi32(e, o);
            __m256i hi = _mm256_unpackhi_epi32(e, o);
            _mm256_storeu_si256(
                (__m256i*)(ty + 16 * v),
                _mm256_permute2x128_si256(lo, hi, 0x20));
            _mm256_storeu_si256(
                (__m256i*)(ty + 16 * v + 8),
                _mm256_permute2x128_si256(lo, hi, 0x31));
        }
    }
}
#endif

void fwd_transform(const int32_t* res, int n, int bit_depth, int use_dst,
                   int32_t* out) {
    LeafTimer pt(6);
#ifdef __AVX2__
    if (n == 4) {
        fwd_transform4(res, bit_depth, use_dst, out);
        return;
    }
#endif
    int log2n = 0;
    while ((1 << log2n) < n)
        log2n++;
    const int32_t* m = dct_matrix_for(log2n, use_dst);
    const int shift1 = log2n + bit_depth - 9;
    const int shift2 = log2n + 6;
    static thread_local int32_t t[32 * 32];
    if (use_dst) {  // 4x4 DST: no even/odd symmetry; n == 4, cheap
        for (int y = 0; y < n; y++)
            for (int i = 0; i < n; i++) {
                int32_t acc = 0;
                for (int x = 0; x < n; x++)
                    acc += res[y * n + x] * m[i * n + x];
                t[y * n + i] = shift1 > 0
                    ? (acc + (1 << (shift1 - 1))) >> shift1
                    : acc << -shift1;
            }
        for (int j = 0; j < n; j++)
            for (int i = 0; i < n; i++) {
                int32_t acc = 0;
                for (int y = 0; y < n; y++)
                    acc += m[j * n + y] * t[y * n + i];
                out[j * n + i] = (acc + (1 << (shift2 - 1))) >> shift2;
            }
        return;
    }
    const int h = n >> 1;
    const int32_t r1 = shift1 > 0 ? 1 << (shift1 - 1) : 0;
    // pass 1 (rows): t[y][r] = sum_j m[r][j] res[y][j]
#ifdef __AVX2__
    if (n == 8) {
        fwd_transform8_pass1(res, shift1, t);
    } else if (n == 16 || n == 32) {
        static const FwdFoldMats ffm;
        if (n == 16)
            fwd_pass1_folded<1>(res, 16, shift1, ffm.met16, ffm.mot16, t);
        else
            fwd_pass1_folded<2>(res, 32, shift1, ffm.met32, ffm.mot32, t);
    } else
#endif
    for (int y = 0; y < n; y++) {
        const int32_t* x = res + y * n;
        int32_t e[16], o[16];
        for (int j = 0; j < h; j++) {
            e[j] = x[j] + x[n - 1 - j];
            o[j] = x[j] - x[n - 1 - j];
        }
        int32_t* ty = t + y * n;
        for (int r = 0; r < n; r++) {
            const int32_t* mr = m + r * n;
            const int32_t* src = (r & 1) ? o : e;
            int32_t acc = 0;
            for (int j = 0; j < h; j++)
                acc += mr[j] * src[j];
            ty[r] = shift1 > 0 ? (acc + r1) >> shift1 : acc << -shift1;
        }
    }
    // pass 2 (columns): out[r][i] = sum_y m[r][y] t[y][i]; fold y even/odd
    // and keep i as the (contiguous, vectorizable) inner dimension
    static thread_local int32_t te[16 * 32], to[16 * 32];
    for (int j = 0; j < h; j++) {
        const int32_t* a = t + j * n;
        const int32_t* b = t + (n - 1 - j) * n;
        int32_t* ej = te + j * n;
        int32_t* oj = to + j * n;
        for (int i = 0; i < n; i++) {
            ej[i] = a[i] + b[i];
            oj[i] = a[i] - b[i];
        }
    }
    const int32_t r2 = 1 << (shift2 - 1);
    static thread_local int32_t accv[32];
    for (int r = 0; r < n; r++) {
        const int32_t* mr = m + r * n;
        const int32_t* src = (r & 1) ? to : te;
        for (int i = 0; i < n; i++)
            accv[i] = 0;
        for (int y = 0; y < h; y++) {
            const int32_t c = mr[y];
            const int32_t* sy = src + y * n;
            for (int i = 0; i < n; i++)
                accv[i] += c * sy[i];
        }
        int32_t* orow = out + r * n;
        for (int i = 0; i < n; i++)
            orow[i] = (accv[i] + r2) >> shift2;
    }
}

// HM quantization with 1/3 (intra) / 1/6 rounding
// (intra_search.quantize_np). Returns nonzero count.
int quantize(const int32_t* coeffs, int n, int qp, int bit_depth, int log2,
             int intra, int16_t* levels) {
    LeafTimer pt(7);
    int t_shift = 15 - bit_depth - log2;
    int q_shift = 14 + qp / 6 + t_shift;
    int64_t f = en.quant_scales[qp % 6];
    // deadzone offset keyed on SLICE type (Reconstruct.cpp:439: 171/512 in
    // I slices, 85/512 in P/B — even for intra CUs inside inter pictures)
    int64_t rnd = (1LL << q_shift) / (g_sp.is_i ? 3 : 6);
    int nz = 0;
    for (int i = 0; i < n * n; i++) {
        int c = coeffs[i];
        int64_t a = c < 0 ? -(int64_t)c : c;
        int64_t lv = (a * f + rnd) >> q_shift;
        if (lv > 32767)
            lv = 32767;
        levels[i] = (int16_t)(c < 0 ? -lv : lv);
        nz += lv != 0;
    }
    return nz;
}

// mvd rate proxy (inter_search._mv_bits): EG1-ish, exact double parity
double mv_bits(int mvd_x, int mvd_y) {
    auto b = [](int v) -> double {
        int a = v < 0 ? -v : v;
        if (a == 0)
            return 1.0;
        // floor(log2(a + 1)) == msb index (log2 exact at powers of two)
        int fl = 31 - __builtin_clz((unsigned)(a + 1));
        return 3.0 + 2.0 * fl;
    };
    return b(mvd_x) + b(mvd_y);
}

int scan_for(int log2, int c_idx, int mode, int intra) {
    if (intra && (log2 == 2 || (log2 == 3 && c_idx == 0))) {
        if (6 <= mode && mode <= 14)
            return 2;
        if (22 <= mode && mode <= 30)
            return 1;
    }
    return 0;
}

// Exact CABAC fractional bits (+1 cbf bin) without mutating the live pool
// (intra_search._residual_bits)
double residual_bits_est(const int16_t* levels, int nz, int log2, int c_idx,
                         int mode, int intra) {
    if (!nz)
        return 1.0;
    LeafTimer pt(8);
    static thread_local uint8_t ctx_copy[512];
    std::memcpy(ctx_copy, cur.ctx, en.num_ctx);
    int64_t frac = tc_residual_bits(ctx_copy, log2, c_idx,
                                    scan_for(log2, c_idx, mode, intra),
                                    g_sp.sdh_enabled, levels);
    return (double)frac / 256.0 + 1.0;
}

// Apply the chosen block's context transitions to the live pool
// (intra_search._commit_residual_ctx)
void commit_residual_ctx(const int16_t* levels, int nz, int log2, int c_idx,
                         int mode, int intra) {
    if (!nz)
        return;
    tc_residual_bits(cur.ctx, log2, c_idx, scan_for(log2, c_idx, mode, intra),
                     g_sp.sdh_enabled, levels);
}

// ------------------------------------------------------- exact mode bins
// Exact CABAC rate of every mode bin (turing/EstimateRate.h parity;
// intra_search.py _emit_* twins — binarizations mirror the writer bin for
// bin). A CandRate chains one candidate's bins on a copy of the live
// pool; cr_commit adopts the winner's evolution + frac (the Python
// _mb_est/_mb_adopt twins). Bypass bins cost exactly 256 frac units.
struct CandRate {
    uint8_t ctx[512];
    int64_t frac;
    void init() {
        std::memcpy(ctx, cur.ctx, en.num_ctx);
        frac = 0;
    }
    inline void bin(int elem, int inc, int b) {
        const int idx = g_sp.off[elem] + inc;
        const uint8_t s = ctx[idx];
        ctx[idx] = b == (s & 1) ? g_next_mps[s] : g_next_lps[s];
        frac += g_rate_bits[s][b];
    }
    inline void bypass(int n) { frac += (int64_t)n << 8; }
    inline void egk1(int value) {  // EG1 bin count (rate.encode_egk_bypass)
        int k = 1, n = 1;
        while (value >= (1 << k)) {
            value -= 1 << k;
            k++;
            n++;
        }
        bypass(n + k);
    }
    inline void residual(const int16_t* lv, int log2, int c_idx, int scan) {
        frac += tc_residual_bits(ctx, log2, c_idx, scan, g_sp.sdh_enabled,
                                 lv);
    }
};

inline void cr_commit(const CandRate& cr) {
    std::memcpy(cur.ctx, cr.ctx, en.num_ctx);
    cur.ctu_frac += cr.frac;
}

void emit_split_flag(CandRate& cr, int x0, int y0, int depth, int split) {
    int inc = 0;
    if (sp_available(x0, y0, x0 - 1, y0))
        inc += g_sp.ct_depth[idx4(x0 - 1, y0)] > depth;
    if (sp_available(x0, y0, x0, y0 - 1))
        inc += g_sp.ct_depth[idx4(x0, y0 - 1)] > depth;
    cr.bin(E_SPLIT_CU, inc, split);
}

// commit a split_cu_flag bin on the live pool; returns lam * bits
double commit_split_flag(int x0, int y0, int log2, int depth, int split) {
    if (log2 <= g_sp.min_cb_log2)
        return 0.0;
    CandRate cr;
    cr.init();
    emit_split_flag(cr, x0, y0, depth, split);
    cr_commit(cr);
    return cur.lam * ((double)cr.frac / 256.0);
}

void emit_cu_skip(CandRate& cr, int x0, int y0, int skip) {
    int inc = 0;
    if (sp_available(x0, y0, x0 - 1, y0))
        inc += g_sp.skip_flag[idx4(x0 - 1, y0)] != 0;
    if (sp_available(x0, y0, x0, y0 - 1))
        inc += g_sp.skip_flag[idx4(x0, y0 - 1)] != 0;
    cr.bin(E_SKIP, inc, skip);
}

void emit_merge_idx(CandRate& cr, int idx) {
    const int c_max = g_sp.max_merge - 1;
    cr.bin(E_MERGE_IDX, 0, idx ? 1 : 0);
    if (idx)
        cr.bypass((idx - 1) + (idx < c_max ? 1 : 0));
}

void emit_skip_cu(CandRate& cr, int x0, int y0, int idx) {
    emit_cu_skip(cr, x0, y0, 1);
    if (g_sp.max_merge > 1)
        emit_merge_idx(cr, idx);
}

void emit_merge_pu(CandRate& cr, int idx) {
    cr.bin(E_MERGE_FLAG, 0, 1);
    if (g_sp.max_merge > 1)
        emit_merge_idx(cr, idx);
}

void emit_mvd(CandRate& cr, int mx, int my) {
    const int ax = mx < 0 ? -mx : mx, ay = my < 0 ? -my : my;
    cr.bin(E_MVD_G0, 0, ax > 0);
    cr.bin(E_MVD_G0, 0, ay > 0);
    if (ax > 0)
        cr.bin(E_MVD_G1, 0, ax > 1);
    if (ay > 0)
        cr.bin(E_MVD_G1, 0, ay > 1);
    for (int a : {ax, ay})
        if (a > 0) {
            if (a > 1)
                cr.egk1(a - 2);
            cr.bypass(1);  // sign
        }
}

// non-merge PU bins; amvp_mask bit l set when list l is predicted
void emit_amvp_pu(CandRate& cr, int cu_depth, int pw, int ph, int amvp_mask,
                  const int mvd[2][2], const int* mvp_fl) {
    cr.bin(E_MERGE_FLAG, 0, 0);
    const int ipi = amvp_mask;
    if (g_sp.is_b) {
        if (pw + ph != 12)
            cr.bin(E_INTER_DIR, cu_depth, ipi == 3 ? 1 : 0);
        if (ipi != 3)
            cr.bin(E_INTER_DIR, 4, ipi == 2 ? 1 : 0);
    }
    for (int lx = 0; lx < 2; lx++) {
        if (!((ipi >> lx) & 1))
            continue;
        if (g_sp.n_ref[lx] > 1)
            cr.bin(E_REF_IDX, 0, 0);  // encoder always uses ref 0
        if (lx == 1 && g_sp.mvd_l1_zero && ipi == 3) {
        } else {
            emit_mvd(cr, mvd[lx][0], mvd[lx][1]);
        }
        cr.bin(E_MVP_FLAG, 0, mvp_fl[lx]);
    }
}

void emit_inter_part_mode(CandRate& cr, int part, int log2) {
    // partition constants match hevc/types.py (2Nx2N=0, 2NxN=1, Nx2N=2,
    // NxN=3, 2NxnU=4, 2NxnD=5, nLx2N=6, nRx2N=7)
    if (part == 0) {
        cr.bin(E_PART_MODE, 0, 1);
        return;
    }
    cr.bin(E_PART_MODE, 0, 0);
    const bool at_min = log2 == g_sp.min_cb_log2;
    const bool amp = g_sp.amp_enabled && !at_min;
    const bool horizontal = part == 1 || part == 4 || part == 5;
    cr.bin(E_PART_MODE, 1, horizontal ? 1 : 0);
    if (at_min) {
        if (part == 1 || log2 == 3)
            return;
        cr.bin(E_PART_MODE, 2, part == 2 ? 1 : 0);
        return;
    }
    if (!amp)
        return;
    const bool sym = part == 1 || part == 2;
    cr.bin(E_PART_MODE, 3, sym ? 1 : 0);
    if (!sym)
        cr.bypass(1);
}

void emit_intra_luma_mode(CandRate& cr, int mode, const int mpm[3]) {
    const int mi = mode == mpm[0] ? 0
        : (mode == mpm[1] ? 1 : (mode == mpm[2] ? 2 : -1));
    cr.bin(E_PREV_INTRA, 0, mi >= 0);
    if (mi >= 0)
        cr.bypass(mi == 0 ? 1 : 2);
    else
        cr.bypass(5);
}

void emit_chroma_mode(CandRate& cr, int k) {
    cr.bin(E_CHROMA_MODE, 0, k == 0 ? 0 : 1);
    if (k)
        cr.bypass(2);
}

void emit_residual_ts(CandRate& cr, const int16_t* lv, int log2, int c_idx,
                      int mode, int intra, int ts) {
    if (g_sp.transform_skip_enabled && log2 == 2)
        cr.bin(c_idx == 0 ? E_TS_LUMA : E_TS_CHROMA, 0, ts);
    cr.residual(lv, log2, c_idx, scan_for(log2, c_idx, mode, intra));
}

// single-TU inter transform tree (TU == CU, chroma at log2-1)
void emit_tt_single(CandRate& cr, int log2, const int16_t* lv_y, int nz_y,
                    const int16_t* lv_cb, int nz_cb, const int16_t* lv_cr,
                    int nz_cr) {
    if (log2 <= g_sp.max_tb_log2 && log2 > g_sp.min_tb_log2
        && g_sp.mtd_inter > 0)
        cr.bin(E_SPLIT_TT, 5 - log2, 0);
    cr.bin(E_CBF_CHROMA, 0, nz_cb ? 1 : 0);
    cr.bin(E_CBF_CHROMA, 0, nz_cr ? 1 : 0);
    if (nz_cb || nz_cr)
        cr.bin(E_CBF_LUMA, 1, nz_y ? 1 : 0);
    if (nz_y)
        emit_residual_ts(cr, lv_y, log2, 0, 0, 0, 0);
    if (nz_cb)
        emit_residual_ts(cr, lv_cb, log2 - 1, 1, 0, 0, 0);
    if (nz_cr)
        emit_residual_ts(cr, lv_cr, log2 - 1, 2, 0, 0, 0);
}

// one-level-split inter transform tree (four luma TUs at log2-1, chroma
// at log2-2 each) in writer z-order; lv_y is (size, size) row-major,
// lv_cb/lv_cr (size/2, size/2)
void emit_tt_split(CandRate& cr, int log2, const int16_t* lv_y,
                   const int16_t* lv_cb, const int16_t* lv_cr) {
    if (log2 <= g_sp.max_tb_log2 && log2 > g_sp.min_tb_log2
        && g_sp.mtd_inter > 0)
        cr.bin(E_SPLIT_TT, 5 - log2, 1);
    const int size = 1 << log2, qh = size >> 1, cs = size >> 1,
              ch = qh >> 1;
    auto any16 = [](const int16_t* p, int stride, int x, int y, int n) {
        for (int yy = 0; yy < n; yy++)
            for (int xx = 0; xx < n; xx++)
                if (p[(y + yy) * stride + x + xx])
                    return 1;
        return 0;
    };
    const int my_cb = any16(lv_cb, cs, 0, 0, cs);
    const int my_cr = any16(lv_cr, cs, 0, 0, cs);
    cr.bin(E_CBF_CHROMA, 0, my_cb);
    cr.bin(E_CBF_CHROMA, 0, my_cr);
    static thread_local int16_t q_l[32 * 32], q_c[16 * 16];
    static const int zo[4][2] = {{0, 0}, {0, 1}, {1, 0}, {1, 1}};  // (dy,dx)
    for (int zi = 0; zi < 4; zi++) {
        const int dy = zo[zi][0] * qh, dx = zo[zi][1] * qh;
        const int cdy = dy >> 1, cdx = dx >> 1;
        const int q_cb = any16(lv_cb, cs, cdx, cdy, ch);
        const int q_cr = any16(lv_cr, cs, cdx, cdy, ch);
        if (my_cb)
            cr.bin(E_CBF_CHROMA, 1, q_cb);
        if (my_cr)
            cr.bin(E_CBF_CHROMA, 1, q_cr);
        const int nzq = any16(lv_y, size, dx, dy, qh);
        cr.bin(E_CBF_LUMA, 0, nzq);
        if (nzq) {
            for (int y = 0; y < qh; y++)
                std::memcpy(q_l + y * qh, lv_y + (dy + y) * size + dx,
                            qh * 2);
            emit_residual_ts(cr, q_l, log2 - 1, 0, 0, 0, 0);
        }
        if (q_cb) {
            for (int y = 0; y < ch; y++)
                std::memcpy(q_c + y * ch, lv_cb + (cdy + y) * cs + cdx,
                            ch * 2);
            emit_residual_ts(cr, q_c, log2 - 2, 1, 0, 0, 0);
        }
        if (q_cr) {
            for (int y = 0; y < ch; y++)
                std::memcpy(q_c + y * ch, lv_cr + (cdy + y) * cs + cdx,
                            ch * 2);
            emit_residual_ts(cr, q_c, log2 - 2, 2, 0, 0, 0);
        }
    }
}

// 8x8 inter CU with a one-level transform split: four 4x4 luma TUs but
// ONE 4x4 chroma TB pair (no chroma split below an 8x8 luma; the
// writer's chroma_last path), in writer order
// (intra_search._emit_tt_split8 twin)
void emit_tt_split8(CandRate& cr, const int16_t* lv_y,
                    const int16_t* lv_cb, const int16_t* lv_cr) {
    if (3 <= g_sp.max_tb_log2 && 3 > g_sp.min_tb_log2
        && g_sp.mtd_inter > 0)
        cr.bin(E_SPLIT_TT, 2, 1);
    auto any4 = [](const int16_t* p, int stride, int x, int y) {
        for (int yy = 0; yy < 4; yy++)
            for (int xx = 0; xx < 4; xx++)
                if (p[(y + yy) * stride + x + xx])
                    return 1;
        return 0;
    };
    const int my_cb = any4(lv_cb, 4, 0, 0);
    const int my_cr = any4(lv_cr, 4, 0, 0);
    cr.bin(E_CBF_CHROMA, 0, my_cb);
    cr.bin(E_CBF_CHROMA, 0, my_cr);
    int16_t q_l[16];
    static const int zo8[4][2] = {{0, 0}, {0, 1}, {1, 0}, {1, 1}};
    for (int zi = 0; zi < 4; zi++) {
        const int dy = zo8[zi][0] * 4, dx = zo8[zi][1] * 4;
        const int nzq = any4(lv_y, 8, dx, dy);
        cr.bin(E_CBF_LUMA, 0, nzq);
        if (nzq) {
            for (int y = 0; y < 4; y++)
                std::memcpy(q_l + y * 4, lv_y + (dy + y) * 8 + dx, 8);
            emit_residual_ts(cr, q_l, 2, 0, 0, 0, 0);
        }
    }
    if (my_cb)
        emit_residual_ts(cr, lv_cb, 2, 1, 0, 0, 0);
    if (my_cr)
        emit_residual_ts(cr, lv_cr, 2, 2, 0, 0, 0);
}

// exact writer bins of one 2Nx2N inter CU candidate
// (inter_search._cand_est_2nx2n twin); kind 0 merge, 1 amvp
void cand_rate_2nx2n(CandRate& cr, int x0, int y0, int log2, int depth,
                     int kind, int idx, int amvp_mask, const int mvd[2][2],
                     const int* mvp_fl, const int16_t* lv_y, int nz_y,
                     const int16_t* lv_cb, int nz_cb, const int16_t* lv_cr,
                     int nz_cr, bool split_tt) {
    cr.init();
    const int has = (nz_y || nz_cb || nz_cr) ? 1 : 0;
    if (kind == 0 && !has) {
        emit_skip_cu(cr, x0, y0, idx);  // merge w/o residual is a skip CU
        return;
    }
    emit_cu_skip(cr, x0, y0, 0);
    cr.bin(E_PRED_MODE, 0, 0);
    emit_inter_part_mode(cr, 0, log2);
    const int size = 1 << log2;
    if (kind == 0) {
        emit_merge_pu(cr, idx);
    } else {
        emit_amvp_pu(cr, depth, size, size, amvp_mask, mvd, mvp_fl);
        cr.bin(E_RQT_ROOT, 0, has);
    }
    if (has) {
        if (split_tt)
            emit_tt_split(cr, log2, lv_y, lv_cb, lv_cr);
        else
            emit_tt_single(cr, log2, lv_y, nz_y, lv_cb, nz_cb, lv_cr,
                           nz_cr);
    }
}

// ---------------------------------------------------------------- fills

template <typename T>
inline void fillq(T* base, int x0, int y0, int size, T v) {
    int bx = x0 >> 2, by = y0 >> 2, n = size >> 2;
    for (int y = 0; y < n; y++) {
        T* row = base + (int64_t)(by + y) * g_sp.w4 + bx;
        for (int x = 0; x < n; x++)
            row[x] = v;
    }
}

template <typename T>
inline void fillq_wh(T* base, int x0, int y0, int w, int h, T v) {
    int bx = x0 >> 2, by = y0 >> 2, nw = w >> 2, nh = h >> 2;
    for (int y = 0; y < nh; y++) {
        T* row = base + (int64_t)(by + y) * g_sp.w4 + bx;
        for (int x = 0; x < nw; x++)
            row[x] = v;
    }
}

// copy (n, n) int16 block between a strided plane and a compact buffer
inline void blk_save16(const int16_t* plane, int stride, int x0, int y0,
                       int n, int16_t* buf) {
    for (int y = 0; y < n; y++)
        std::memcpy(buf + y * n, plane + (int64_t)(y0 + y) * stride + x0,
                    n * 2);
}

inline void blk_load16(int16_t* plane, int stride, int x0, int y0, int n,
                       const int16_t* buf) {
    for (int y = 0; y < n; y++)
        std::memcpy(plane + (int64_t)(y0 + y) * stride + x0, buf + y * n,
                    n * 2);
}

template <typename T>
inline void q_save(const T* base, int x0, int y0, int size, T* buf) {
    int bx = x0 >> 2, by = y0 >> 2, n = size >> 2;
    for (int y = 0; y < n; y++)
        std::memcpy(buf + y * n, base + (int64_t)(by + y) * g_sp.w4 + bx,
                    n * sizeof(T));
}

template <typename T>
inline void q_load(T* base, int x0, int y0, int size, const T* buf) {
    int bx = x0 >> 2, by = y0 >> 2, n = size >> 2;
    for (int y = 0; y < n; y++)
        std::memcpy(base + (int64_t)(by + y) * g_sp.w4 + bx, buf + y * n,
                    n * sizeof(T));
}

// ---------------------------------------------------------------- snapshot
// intra_search._snapshot + inter_search extras, over one square region
struct Snap {
    int16_t rec_y[64 * 64], rec_cb[32 * 32], rec_cr[32 * 32];
    int16_t coeff_y[64 * 64], coeff_cb[32 * 32], coeff_cr[32 * 32];
    uint8_t ct_depth[256], part_mode[256], cu_pred_mode[256],
        intra_mode_y[256], intra_mode_c[256], tu_log2[256],
        cbf_y[256], cbf_cb[256], cbf_cr[256], cu_size_log2[256];
    int32_t tu_id[256], cu_id[256], pu_id[256];
    // inter extras
    uint8_t skip_flag[256], merge_flag[256], merge_idx[256],
        mvp_flag[2 * 256];
    int16_t mv[2 * 256 * 2], mvd[2 * 256 * 2];
    int8_t ref_idx[2 * 256];
    int32_t ref_poc[2 * 256];
    int32_t ids[3];
    uint8_t ctx[512];
    int64_t frac;
};

// free-list pool: decide_cqt allocates two Snaps (~37 KB each) per quadtree
// node; recursion depth <= 4 and <= 2 live per level, so a small pool
// removes the malloc/free traffic from the hot recursion
struct SnapPool {
    static const int N = 16;
    Snap* slots[N];
    int n = 0;
    Snap* get() { return n ? slots[--n] : new Snap; }
    void put(Snap* s) {
        if (n < N)
            slots[n++] = s;
        else
            delete s;
    }
};
thread_local SnapPool g_snap_pool;
inline Snap* snap_new() { return g_snap_pool.get(); }
inline void snap_free(Snap* s) { g_snap_pool.put(s); }

void snap_save(Snap& s, int x0, int y0, int size) {
    PhaseTimer pt(3);
    const int cs = size >> 1;
    blk_save16(en.rec[0], g_sp.pic_w, x0, y0, size, s.rec_y);
    blk_save16(en.rec[1], cw_(), x0 >> 1, y0 >> 1, cs, s.rec_cb);
    blk_save16(en.rec[2], cw_(), x0 >> 1, y0 >> 1, cs, s.rec_cr);
    blk_save16(g_sp.coeff_y, g_sp.pic_w, x0, y0, size, s.coeff_y);
    blk_save16(g_sp.coeff_cb, cw_(), x0 >> 1, y0 >> 1, cs, s.coeff_cb);
    blk_save16(g_sp.coeff_cr, cw_(), x0 >> 1, y0 >> 1, cs, s.coeff_cr);
    q_save(g_sp.ct_depth, x0, y0, size, s.ct_depth);
    q_save(g_sp.part_mode, x0, y0, size, s.part_mode);
    q_save(g_sp.cu_pred_mode, x0, y0, size, s.cu_pred_mode);
    q_save(g_sp.intra_mode_y, x0, y0, size, s.intra_mode_y);
    q_save(g_sp.intra_mode_c, x0, y0, size, s.intra_mode_c);
    q_save(g_sp.tu_log2, x0, y0, size, s.tu_log2);
    q_save(g_sp.cbf_y, x0, y0, size, s.cbf_y);
    q_save(g_sp.cbf_cb, x0, y0, size, s.cbf_cb);
    q_save(g_sp.cbf_cr, x0, y0, size, s.cbf_cr);
    q_save(g_sp.cu_size_log2, x0, y0, size, s.cu_size_log2);
    q_save(g_sp.tu_id, x0, y0, size, s.tu_id);
    q_save(g_sp.cu_id, x0, y0, size, s.cu_id);
    q_save(g_sp.pu_id, x0, y0, size, s.pu_id);
    if (!g_sp.is_i) {
        const int64_t plane4 = (int64_t)g_sp.h4 * g_sp.w4;
        int nb = size >> 2;
        q_save(g_sp.skip_flag, x0, y0, size, s.skip_flag);
        q_save(g_sp.merge_flag, x0, y0, size, s.merge_flag);
        q_save(g_sp.merge_idx, x0, y0, size, s.merge_idx);
        for (int l = 0; l < 2; l++) {
            q_save(g_sp.mvp_flag + l * plane4, x0, y0, size,
                   s.mvp_flag + l * nb * nb);
            q_save(g_sp.ref_idx + l * plane4, x0, y0, size,
                   s.ref_idx + l * nb * nb);
            q_save(g_sp.ref_poc + l * plane4, x0, y0, size,
                   s.ref_poc + l * nb * nb);
            // mv / mvd: (.., 2) pairs — copy rows of 2*nb int16
            int bx = x0 >> 2, by = y0 >> 2;
            for (int y = 0; y < nb; y++) {
                std::memcpy(s.mv + (l * nb * nb + y * nb) * 2,
                            g_sp.mv + (l * plane4
                                       + (int64_t)(by + y) * g_sp.w4 + bx)
                                          * 2,
                            nb * 4);
                std::memcpy(s.mvd + (l * nb * nb + y * nb) * 2,
                            g_sp.mvd + (l * plane4
                                        + (int64_t)(by + y) * g_sp.w4 + bx)
                                           * 2,
                            nb * 4);
            }
        }
    }
    s.ids[0] = cur.ids[0];
    s.ids[1] = cur.ids[1];
    s.ids[2] = cur.ids[2];
    std::memcpy(s.ctx, cur.ctx, en.num_ctx);
    s.frac = cur.ctu_frac;
}

void snap_restore(const Snap& s, int x0, int y0, int size) {
    PhaseTimer pt(3);
    const int cs = size >> 1;
    blk_load16(en.rec[0], g_sp.pic_w, x0, y0, size, s.rec_y);
    blk_load16(en.rec[1], cw_(), x0 >> 1, y0 >> 1, cs, s.rec_cb);
    blk_load16(en.rec[2], cw_(), x0 >> 1, y0 >> 1, cs, s.rec_cr);
    blk_load16(g_sp.coeff_y, g_sp.pic_w, x0, y0, size, s.coeff_y);
    blk_load16(g_sp.coeff_cb, cw_(), x0 >> 1, y0 >> 1, cs, s.coeff_cb);
    blk_load16(g_sp.coeff_cr, cw_(), x0 >> 1, y0 >> 1, cs, s.coeff_cr);
    q_load(g_sp.ct_depth, x0, y0, size, s.ct_depth);
    q_load(g_sp.part_mode, x0, y0, size, s.part_mode);
    q_load(g_sp.cu_pred_mode, x0, y0, size, s.cu_pred_mode);
    q_load(g_sp.intra_mode_y, x0, y0, size, s.intra_mode_y);
    q_load(g_sp.intra_mode_c, x0, y0, size, s.intra_mode_c);
    q_load(g_sp.tu_log2, x0, y0, size, s.tu_log2);
    q_load(g_sp.cbf_y, x0, y0, size, s.cbf_y);
    q_load(g_sp.cbf_cb, x0, y0, size, s.cbf_cb);
    q_load(g_sp.cbf_cr, x0, y0, size, s.cbf_cr);
    q_load(g_sp.cu_size_log2, x0, y0, size, s.cu_size_log2);
    q_load(g_sp.tu_id, x0, y0, size, s.tu_id);
    q_load(g_sp.cu_id, x0, y0, size, s.cu_id);
    q_load(g_sp.pu_id, x0, y0, size, s.pu_id);
    if (!g_sp.is_i) {
        const int64_t plane4 = (int64_t)g_sp.h4 * g_sp.w4;
        int nb = size >> 2;
        q_load(g_sp.skip_flag, x0, y0, size, s.skip_flag);
        q_load(g_sp.merge_flag, x0, y0, size, s.merge_flag);
        q_load(g_sp.merge_idx, x0, y0, size, s.merge_idx);
        for (int l = 0; l < 2; l++) {
            q_load(g_sp.mvp_flag + l * plane4, x0, y0, size,
                   s.mvp_flag + l * nb * nb);
            q_load(g_sp.ref_idx + l * plane4, x0, y0, size,
                   s.ref_idx + l * nb * nb);
            q_load(g_sp.ref_poc + l * plane4, x0, y0, size,
                   s.ref_poc + l * nb * nb);
            int bx = x0 >> 2, by = y0 >> 2;
            for (int y = 0; y < nb; y++) {
                std::memcpy(g_sp.mv + (l * plane4
                                       + (int64_t)(by + y) * g_sp.w4 + bx)
                                          * 2,
                            s.mv + (l * nb * nb + y * nb) * 2, nb * 4);
                std::memcpy(g_sp.mvd + (l * plane4
                                        + (int64_t)(by + y) * g_sp.w4 + bx)
                                           * 2,
                            s.mvd + (l * nb * nb + y * nb) * 2, nb * 4);
            }
        }
    }
    cur.ids[0] = s.ids[0];
    cur.ids[1] = s.ids[1];
    cur.ids[2] = s.ids[2];
    // the rate-context pool and frac counter follow the plan: a discarded
    // trial leaves no trace (CandidateStash restore, StateEncode.h:380)
    std::memcpy(cur.ctx, s.ctx, en.num_ctx);
    cur.ctu_frac = s.frac;
}

// ---------------------------------------------------------------- intra

// SATD-rank all 35 modes (intra_search._rank_modes). Returns candidate
// count; cands filled in rank order.
// Sweep-only angular prediction in scan-major layout: output rows are
// always indexed by dpos, so for modes < 18 the block is the TRANSPOSE of
// the spec layout. Contiguous stores for every mode; Hadamard SATD is
// transpose-invariant, so ranking costs are bit-identical when compared
// against the transposed original (intra_predict_core twin, spec 8.4.4.2.6
// with disable_edge semantics).
static void sweep_angular(int mode, const int32_t* rt, const int32_t* rl,
                          int32_t corner, int n, int32_t* pred) {
    const int angle = g_angle[mode];
    int32_t main_arr[130];  // index offset n: ref[-n .. 2n+1]
    const int32_t* ref_main = (mode >= 18) ? rt : rl;
    const int32_t* ref_other = (mode >= 18) ? rl : rt;
    main_arr[n] = corner;
    for (int i = 0; i < 2 * n; i++)
        main_arr[n + 1 + i] = ref_main[i];
    main_arr[3 * n + 1] = ref_main[2 * n - 1];
    if (angle < 0) {
        int inv = g_inv_angle[mode];
        int lo = (n * angle) >> 5;
        for (int x = -1; x > lo - 1; x--) {
            int idx = ((x * inv + 128) >> 8) - 1;
            main_arr[n + x] = idx < 0 ? corner
                : ref_other[idx < 2 * n - 1 ? idx : 2 * n - 1];
        }
    }
    for (int dpos = 1; dpos <= n; dpos++) {
        const int i_idx = (dpos * angle) >> 5;
        const int i_fact = (dpos * angle) & 31;
        const int32_t* m0 = main_arr + n + 1 + i_idx;
        int32_t* row = pred + (dpos - 1) * n;
        if (i_fact == 0) {
            std::memcpy(row, m0, n * 4);
            continue;
        }
#ifdef __AVX2__
        if (n >= 8) {
            const __m256i vf = _mm256_set1_epi32(i_fact);
            const __m256i vif = _mm256_set1_epi32(32 - i_fact);
            const __m256i half = _mm256_set1_epi32(16);
            for (int j = 0; j < n; j += 8) {
                __m256i a = _mm256_loadu_si256((const __m256i*)(m0 + j));
                __m256i b =
                    _mm256_loadu_si256((const __m256i*)(m0 + j + 1));
                __m256i v = _mm256_add_epi32(
                    _mm256_add_epi32(_mm256_mullo_epi32(vif, a),
                                     _mm256_mullo_epi32(vf, b)),
                    half);
                _mm256_storeu_si256((__m256i*)(row + j),
                                    _mm256_srai_epi32(v, 5));
            }
            continue;
        }
#endif
        for (int j = 0; j < n; j++)
            row[j] = ((32 - i_fact) * m0[j] + i_fact * m0[j + 1] + 16) >> 5;
    }
}

// Batched n=4 all-angular-mode sweep. Canonical 17-entry reference layout:
// ext[0..7] = left (rl), ext[8] = corner, ext[9..16] = top (rt). Each of an
// angular mode's 16 predicted pixels is a fixed 2-tap blend of two ext
// entries ((32-f)*a + f*b + 16) >> 5 — exactly sweep_angular's arithmetic,
// including its projected negative-index fill — so the (index, fraction)
// triplets depend only on the mode tables and are precomputed once.
// Predictions (and therefore rankings) are bit-identical to sweep_angular.
struct Sweep4Tables {
    alignas(32) int32_t idxa[33][16], idxb[33][16];
    alignas(32) int32_t frac[33][16], ifrac[33][16];
    Sweep4Tables() {
        for (int mode = 2; mode < 35; mode++) {
            const int angle = g_angle[mode];
            const int inv = g_inv_angle[mode];
            const bool top = mode >= 18;
            // ext index of main_arr[4 + k] in sweep_angular's layout
            auto ext_of = [&](int k) -> int32_t {
                if (k == 0)
                    return 8;  // corner
                if (k >= 1 && k <= 8)
                    return top ? 8 + k : k - 1;  // main reference
                if (k >= 9)
                    return top ? 16 : 7;  // clamped top-right / bottom-left
                int idx = ((k * inv + 128) >> 8) - 1;  // projected side ref
                if (idx < 0)
                    return 8;
                if (idx > 7)
                    idx = 7;
                return top ? idx : 9 + idx;
            };
            for (int dpos = 1; dpos <= 4; dpos++) {
                const int i_idx = (dpos * angle) >> 5;
                const int i_fact = (dpos * angle) & 31;
                for (int j = 0; j < 4; j++) {
                    const int p = (dpos - 1) * 4 + j;
                    idxa[mode - 2][p] = ext_of(1 + i_idx + j);
                    idxb[mode - 2][p] = ext_of(2 + i_idx + j);
                    frac[mode - 2][p] = i_fact;
                    ifrac[mode - 2][p] = 32 - i_fact;
                }
            }
        }
    }
};

int rank_modes(const int32_t* orig_b, const int32_t* rt, const int32_t* rl,
               int32_t corner, int n, const int cands_mpm[3], int count,
               int* out_cands, double* out_costs = nullptr, int n_mpm = 0,
               int64_t* out_satd = nullptr, int x0 = -1, int y0 = -1,
               int from_src = 0) {
    LeafTimer pt(12);
    // device-installed source-referenced SATD table: when the caller
    // ranks from SOURCE refs at an aligned position and the device stage
    // installed this size's table, the sweep's exact integers are read
    // instead of recomputed (TURING_TPU_DEVICE_ENC rank stage)
    const int32_t* tab = nullptr;
    if (from_src && x0 >= 0 && en.have_ranksatd) {
        const int lg = n == 4 ? 2 : (n == 8 ? 3 : (n == 16 ? 4 : 5));
        if ((en.have_ranksatd >> lg) & 1) {
            const int wn = en.ranksatd_wn[lg];
            tab = en.ranksatd[lg].data()
                + ((size_t)(y0 / n) * wn + x0 / n) * 35;
        }
    }
    static thread_local int32_t pred[32 * 32], orig_t[32 * 32];
    const int bd = g_sp.bit_depth_y;
    int32_t frt[64], frl[64], fc = corner;
    bool have_f = !tab && n > 4;
    if (have_f) {
        std::memcpy(frt, rt, 2 * n * 4);
        std::memcpy(frl, rl, 2 * n * 4);
        filter_intra_refs(frt, frl, &fc, n, 0, en.strong, bd);
    }
    const int thres = n == 8 ? 7 : (n == 16 ? 1 : 0);
    int bs = n >= 8 ? 8 : 4;
    // transposed original for the scan-major (mode < 18) comparisons
    if (!tab)
        for (int y = 0; y < n; y++)
            for (int x = 0; x < n; x++)
                orig_t[x * n + y] = orig_b[y * n + x];
    struct MC {
        double cost;
        int mode;
    } mc[35];
    auto score = [&](int mode, int64_t satd) {
        int in_mpm = mode == cands_mpm[0] || mode == cands_mpm[1]
                  || mode == cands_mpm[2];
        mc[mode].cost = (double)satd + cur.lam_bits * (in_mpm ? 2 : 6);
        mc[mode].mode = mode;
        if (out_satd)
            out_satd[mode] = satd;
    };
    int mode_begin = 0;
    if (tab) {
        for (int mode = 0; mode < 35; mode++)
            score(mode, (int64_t)tab[mode]);
        mode_begin = 35;
    } else if (n == 4) {
        // planar + DC via the generic path (no edge filtering at n=4)
        for (int mode = 0; mode < 2; mode++) {
            intra_predict_core(mode, rt, rl, corner, 4, 0, bd, 1, pred);
            score(mode, satd_region(orig_b, pred, 4, 4, 4));
        }
        // all 33 angular modes via the precomputed 2-tap blend tables
        static const Sweep4Tables s4;
        alignas(32) int32_t ext[24];
        std::memcpy(ext, rl, 8 * 4);
        ext[8] = corner;
        std::memcpy(ext + 9, rt, 8 * 4);
#ifdef __AVX2__
        const __m256i vhalf = _mm256_set1_epi32(16);
        const __m256i o0 = _mm256_loadu_si256((const __m256i*)orig_b);
        const __m256i o1 = _mm256_loadu_si256((const __m256i*)(orig_b + 8));
        const __m256i t0 = _mm256_loadu_si256((const __m256i*)orig_t);
        const __m256i t1 = _mm256_loadu_si256((const __m256i*)(orig_t + 8));
        for (int mode = 2; mode < 35; mode++) {
            const int m = mode - 2;
            __m256i a0 = _mm256_i32gather_epi32(
                ext, _mm256_load_si256((const __m256i*)s4.idxa[m]), 4);
            __m256i a1 = _mm256_i32gather_epi32(
                ext, _mm256_load_si256((const __m256i*)(s4.idxa[m] + 8)),
                4);
            __m256i b0 = _mm256_i32gather_epi32(
                ext, _mm256_load_si256((const __m256i*)s4.idxb[m]), 4);
            __m256i b1 = _mm256_i32gather_epi32(
                ext, _mm256_load_si256((const __m256i*)(s4.idxb[m] + 8)),
                4);
            __m256i p0 = _mm256_srai_epi32(
                _mm256_add_epi32(
                    _mm256_add_epi32(
                        _mm256_mullo_epi32(
                            _mm256_load_si256(
                                (const __m256i*)s4.ifrac[m]), a0),
                        _mm256_mullo_epi32(
                            _mm256_load_si256(
                                (const __m256i*)s4.frac[m]), b0)),
                    vhalf), 5);
            __m256i p1 = _mm256_srai_epi32(
                _mm256_add_epi32(
                    _mm256_add_epi32(
                        _mm256_mullo_epi32(
                            _mm256_load_si256(
                                (const __m256i*)(s4.ifrac[m] + 8)), a1),
                        _mm256_mullo_epi32(
                            _mm256_load_si256(
                                (const __m256i*)(s4.frac[m] + 8)), b1)),
                    vhalf), 5);
            __m256i d0 = _mm256_sub_epi32(p0, mode < 18 ? t0 : o0);
            __m256i d1 = _mm256_sub_epi32(p1, mode < 18 ? t1 : o1);
            score(mode, satd4_rows(_mm256_castsi256_si128(d0),
                                   _mm256_extracti128_si256(d0, 1),
                                   _mm256_castsi256_si128(d1),
                                   _mm256_extracti128_si256(d1, 1)));
        }
#else
        for (int mode = 2; mode < 35; mode++) {
            const int m = mode - 2;
            int32_t pr[16];
            for (int p = 0; p < 16; p++)
                pr[p] = (s4.ifrac[m][p] * ext[s4.idxa[m][p]]
                         + s4.frac[m][p] * ext[s4.idxb[m][p]] + 16) >> 5;
            const int32_t* cmp = mode < 18 ? orig_t : orig_b;
            score(mode, satd_region(cmp, pr, 4, 4, 4));
        }
#endif
        mode_begin = 35;
    }
    for (int mode = mode_begin; mode < 35; mode++) {
        bool filt = have_f && mode != 1
                 && (mode == 0
                     || std::min(std::abs(mode - 26), std::abs(mode - 10))
                            > thres);
        const int32_t* urt = filt ? frt : rt;
        const int32_t* url = filt ? frl : rl;
        const int32_t uc = filt ? fc : corner;
        const int32_t* cmp = orig_b;
        if (mode < 2) {
            intra_predict_core(mode, urt, url, uc, n, 0, bd, 1, pred);
        } else {
            sweep_angular(mode, urt, url, uc, n, pred);
            if (mode < 18)
                cmp = orig_t;
        }
        score(mode, satd_region(cmp, pred, n, n, bs));
    }
    int cnt = count < 35 ? count : 35;
    const double planar_cost = mc[0].cost;  // by-mode order until the sort
    // stable partial selection: element i = i-th smallest with ties kept in
    // mode order — the exact prefix std::stable_sort produced, without the
    // full-array merge sort per call
    for (int i = 0; i < cnt; i++) {
        int best = i;
        for (int j = i + 1; j < 35; j++)
            if (mc[j].cost < mc[best].cost)
                best = j;
        if (best != i) {
            MC tmp = mc[best];
            std::memmove(mc + i + 1, mc + i, (best - i) * sizeof(MC));
            mc[i] = tmp;
        }
    }
    bool has_planar = false;
    for (int i = 0; i < cnt; i++) {
        out_cands[i] = mc[i].mode;
        if (out_costs)
            out_costs[i] = mc[i].cost;
        has_planar |= mc[i].mode == 0;
    }
    if (!has_planar && cnt >= 2) {
        out_cands[cnt - 1] = 0;
        if (out_costs)
            out_costs[cnt - 1] = planar_cost;
    }
    // the reference appends the unsearched NEIGHBOUR modes (the first
    // candModeList.neighbourModes entries) to the RD refinement list with
    // ranking cost 0 — always refined, never SATD-gated
    // (Search.hpp:180-190; intra_search._rank_modes twin)
    for (int k = 0; k < n_mpm; k++) {
        const int m = cands_mpm[k];
        bool seen = false;
        for (int i = 0; i < cnt; i++)
            if (out_cands[i] == m)
                seen = true;
        if (!seen) {
            out_cands[cnt] = m;
            if (out_costs)
                out_costs[cnt] = 0.0;
            cnt++;
        }
    }
    return cnt;
}

// encoder side of sign data hiding: per-4x4-CG parity fix with a
// minimum-distortion +/-1 adjustment that preserves the first/last
// significant scan positions (intra_search.apply_sdh oracle, bit-exact)
void apply_sdh_c(int16_t* lv, const int32_t* coeffs, int qp_full, int bd,
                 int log2, int scan_idx) {
    static const int LS[6] = {40, 45, 51, 57, 64, 72};
    const int n = 1 << log2;
    const int8_t* pos = g_scan[2][scan_idx];
    const int64_t ls16 = ((int64_t)LS[qp_full % 6] << (qp_full / 6)) * 16;
    const int bd_shift = bd + log2 - 5;
    const int64_t rnd = (int64_t)1 << (bd_shift - 1);
    auto dq = [&](int64_t v) -> int64_t {
        return (v * ls16 + rnd) >> bd_shift;
    };
    for (int ys = 0; ys < n; ys += 4)
        for (int xs = 0; xs < n; xs += 4) {
            int lvs[16];
            int any = 0;
            for (int k = 0; k < 16; k++) {
                lvs[k] = lv[(ys + pos[2 * k + 1]) * n + xs + pos[2 * k]];
                any |= lvs[k];
            }
            if (!any)
                continue;
            int first = -1, last = -1;
            int sum_abs = 0;
            for (int k = 0; k < 16; k++) {
                if (lvs[k]) {
                    if (first < 0)
                        first = k;
                    last = k;
                }
                sum_abs += lvs[k] < 0 ? -lvs[k] : lvs[k];
            }
            if (last - first <= 3)
                continue;
            int want = lvs[first] < 0 ? 1 : 0;
            if ((sum_abs & 1) == want)
                continue;
            double best_cost = 0;
            int b_y = -1, b_x = -1, b_nv = 0;
            bool have = false;
            for (int k = 0; k < 16; k++) {
                int x = xs + pos[2 * k];
                int y = ys + pos[2 * k + 1];
                int v = lvs[k];
                double c = (double)coeffs[y * n + x];
                int deltas[2];
                int nd;
                if (k == first) {
                    deltas[0] = v > 0 ? 1 : -1;  // grow, keep sign
                    nd = 1;
                } else if (k > first && k <= last) {
                    if (v == 0) {
                        deltas[0] = c >= 0 ? 1 : -1;
                        nd = 1;
                    } else if (v == 1 || v == -1) {
                        deltas[0] = v > 0 ? 1 : -1;  // never zero a sig
                        nd = 1;
                    } else {
                        deltas[0] = 1;
                        deltas[1] = -1;
                        nd = 2;
                    }
                } else {
                    continue;
                }
                for (int di = 0; di < nd; di++) {
                    int d = deltas[di];
                    double e_new = (double)dq(v + d) - c;
                    double e_old = (double)dq(v) - c;
                    double cost = e_new * e_new - e_old * e_old;
                    if (!have || cost < best_cost) {
                        best_cost = cost;
                        b_y = y;
                        b_x = x;
                        b_nv = v + d;
                        have = true;
                    }
                }
            }
            lv[b_y * n + b_x] = (int16_t)b_nv;
        }
}

// ---------------------------------------------------------------- RDOQ
// HM-style rate-distortion optimized quantization (turing/Rdoq.cpp:35-444):
// per-coefficient level adjustment against context-exact CABAC rate
// estimates, 4x4 coefficient-group zeroing decisions, and an RD-optimal
// last-significant-position sweep. Reads (never mutates) the live
// rate-context pool; rates are 1/256-bit units, costs double
// (err^2 * 2^-(2*transformShift + 2*(bd-8)) + lambda * bits).

inline int32_t rdoq_est(int ctx_idx, int bin) {
    return g_rate_bits[cur.ctx[ctx_idx]][bin];
}

// lambda * rate of coding |level| (Rdoq::getLevelRateCost; 1 sign bit incl.)
inline double rdoq_level_cost(double lam, int level, int g1_ctx, int g2_ctx,
                              int rice, int g1_cnt, int g2_cnt) {
    int64_t rate = 256;  // sign
    const int base = g1_cnt < 8 ? (2 + (g2_cnt < 1)) : 1;
    if (level >= base) {
        int symbol = level - base;
        if (symbol < (3 << rice)) {
            rate += (int64_t)((symbol >> rice) + 1 + rice) << 8;
        } else {
            int length = rice;
            symbol -= 3 << rice;
            while (symbol >= (1 << length))
                symbol -= 1 << length++;
            rate += (int64_t)(3 + length + 1 - rice + length) << 8;
        }
        if (g1_cnt < 8) {
            rate += rdoq_est(g1_ctx, 1);
            if (g2_cnt < 1)
                rate += rdoq_est(g2_ctx, 1);
        }
    } else if (level == 1) {
        rate += rdoq_est(g1_ctx, 0);
    } else if (level == 2) {
        rate += rdoq_est(g1_ctx, 1);
        rate += rdoq_est(g2_ctx, 0);
    }
    return lam * ((double)rate / 256.0);
}

// lambda * rate of the last-significant-position syntax
// (Rdoq::getLastSigCoeffPosRateCost)
inline double rdoq_last_cost(double lam, int xc, int yc, int c_idx,
                             int log2) {
    static const int blen[32] = {0, 1, 2, 3, 4, 4, 5, 5, 6, 6, 6, 6, 7, 7,
                                 7, 7, 8, 8, 8, 8, 8, 8, 8, 8, 9, 9, 9, 9,
                                 9, 9, 9, 9};
    const int ctx_off = c_idx ? 15 : (3 * (log2 - 2) + ((log2 - 1) >> 2));
    const int ctx_shift = c_idx ? (log2 - 2) : ((log2 + 1) >> 2);
    int64_t rate = 0;
    const int lx = blen[xc], ly = blen[yc];
    for (int i = 0; i < lx; i++)
        rate += rdoq_est(
            g_off_lastx + clip3i(0, 17, (i >> ctx_shift) + ctx_off), 1);
    if (lx < 9)
        rate += rdoq_est(
            g_off_lastx + clip3i(0, 17, (lx >> ctx_shift) + ctx_off), 0);
    for (int i = 0; i < ly; i++)
        rate += rdoq_est(
            g_off_lasty + clip3i(0, 17, (i >> ctx_shift) + ctx_off), 1);
    if (ly < 9)
        rate += rdoq_est(
            g_off_lasty + clip3i(0, 17, (ly >> ctx_shift) + ctx_off), 0);
    if (lx > 3)
        rate += (int64_t)((lx - 2) >> 1) << 8;
    if (ly > 3)
        rate += (int64_t)((ly - 2) >> 1) << 8;
    return lam * ((double)rate / 256.0);
}

// Rdoq::runQuantisation. cbf_ctx_idx: absolute rate-pool index of the flag
// that gates an all-zero TU (rqt_root_cbf for a depth-0 inter luma TU,
// cbf_luma/cbf_cb/cbf_cr otherwise). Returns the nonzero count.
int rdoq_quantize(const int32_t* coeffs, int qp, int bd, int log2,
                  int c_idx, int scan_idx, int cbf_ctx_idx,
                  int16_t* levels) {
    LeafTimer pt(21);
    const int count = 1 << (2 * log2);
    const int ts = 15 - bd - log2;
    const double lam = cur.lam;
    const double err_scale = std::ldexp(1.0, -(2 * ts + 2 * (bd - 8)));
    const int q_shift = 14 + qp / 6 + ts;
    const int64_t q_scale = en.quant_scales[qp % 6];
    static const int LS[6] = {40, 45, 51, 57, 64, 72};
    const int inv_scale = LS[qp % 6] << (qp / 6);
    const int inv_shift = bd + log2 - 9;
    const int inv_offset = 1 << (inv_shift - 1);
    const int g1_off = g_off_gt1 + (c_idx > 0 ? 16 : 0);
    const int g2_off = g_off_gt2 + (c_idx > 0 ? 4 : 0);
    const int8_t* cg_scan = g_scan[log2 - 2][scan_idx];
    const int8_t* in_scan = g_scan[2][scan_idx];
    const int total_cg = count >> 4;
    const int cgw = 1 << (log2 - 2);

    static thread_local double dist0[32 * 32], rd_coeff[32 * 32],
        rate_sig[32 * 32];
    double rate_cg_sig[64] = {0.0};
    int csbf[64] = {0};
    double dist0_total = 0.0, rd_cost_tu = 0.0;
    int last_sp = -1, last_cg = -1;
    int context_set = 0, g1_idx = 1, g1_cnt = 0, g2_cnt = 0, rice = 0;

    // fast pre-pass: locate the first CG (in reverse scan) with any
    // nonzero round-to-nearest level. CGs above it contribute only their
    // zero-level distortion — err_scale is a power of two, so the batched
    // integer sum is bit-identical to per-coefficient accumulation.
    int start_cg = -1;
    {
        const int64_t thr_num = (1LL << q_shift) - (1LL << (q_shift - 1));
        // |c| quantizes to 0 iff |c|*q_scale + half < 2^q_shift
        for (int cgs = total_cg - 1; cgs >= 0 && start_cg < 0; cgs--) {
            const int cg_x = cg_scan[2 * cgs], cg_y = cg_scan[2 * cgs + 1];
            for (int k = 0; k < 16; k++) {
                const int xc = (cg_x << 2) + in_scan[2 * k];
                const int yc = (cg_y << 2) + in_scan[2 * k + 1];
                const int src = coeffs[(yc << log2) + xc];
                const int64_t a = src < 0 ? -(int64_t)src : src;
                if (a * q_scale >= thr_num) {
                    start_cg = cgs;
                    break;
                }
            }
        }
        if (start_cg < 0) {
            std::memset(levels, 0, count * 2);
            return 0;
        }
        int64_t sq = 0;
        for (int cgs = total_cg - 1; cgs > start_cg; cgs--) {
            const int cg_x = cg_scan[2 * cgs], cg_y = cg_scan[2 * cgs + 1];
            for (int k = 0; k < 16; k++) {
                const int xc = (cg_x << 2) + in_scan[2 * k];
                const int yc = (cg_y << 2) + in_scan[2 * k + 1];
                const int pos = (yc << log2) + xc;
                const int64_t a = coeffs[pos] < 0 ? -(int64_t)coeffs[pos]
                                                  : coeffs[pos];
                sq += a * a;
                levels[pos] = 0;
                dist0[cgs * 16 + k] = (double)(a * a) * err_scale;
                rd_coeff[cgs * 16 + k] = 0.0;
                rate_sig[cgs * 16 + k] = 0.0;
            }
        }
        dist0_total += (double)sq * err_scale;
        rd_cost_tu += (double)sq * err_scale;
    }

    // step 1: per-coefficient level adjustment + per-CG zeroing
    for (int cgs = start_cg; cgs >= 0; cgs--) {
        const int cg_x = cg_scan[2 * cgs], cg_y = cg_scan[2 * cgs + 1];
        const int cg_pos = cg_y * cgw + cg_x;
        int prev_csbf = 0;
        if (cg_x < cgw - 1)
            prev_csbf += csbf[cg_y * cgw + cg_x + 1];
        if (cg_y < cgw - 1)
            prev_csbf += csbf[(cg_y + 1) * cgw + cg_x] << 1;
        int nz_before_pos0 = 0;
        double cg_dist0 = 0.0, cg_rate_sig = 0.0, cg_rate_sig_pos0 = 0.0,
               cg_rd_coeff = 0.0;
        // branchless pre-pass over the CG (autovectorizes): gather,
        // round-to-nearest level, zero-level distortion, and the two
        // candidate reconstruction errors — identical arithmetic to the
        // serial statements they replace
        int pos16[16], abs16[16], qlv16[16];
        double d016[16], derr0[16], derr1[16];
        for (int k = 0; k < 16; k++) {
            const int xc = (cg_x << 2) + in_scan[2 * k];
            const int yc = (cg_y << 2) + in_scan[2 * k + 1];
            pos16[k] = (yc << log2) + xc;
        }
        for (int k = 0; k < 16; k++) {
            const int src = coeffs[pos16[k]];
            abs16[k] = src < 0 ? -src : src;
        }
        for (int k = 0; k < 16; k++) {
            int q_lv = (int)(((int64_t)abs16[k] * q_scale
                              + (1LL << (q_shift - 1))) >> q_shift);
            qlv16[k] = q_lv > 32767 ? 32767 : q_lv;
            d016[k] = (double)abs16[k] * abs16[k] * err_scale;
        }
        for (int k = 0; k < 16; k++) {
            const int lv0 = qlv16[k];
            const int lv1 = lv0 > 1 ? lv0 - 1 : 1;
            int r0 = (lv0 * inv_scale + inv_offset) >> inv_shift;
            int r1 = (lv1 * inv_scale + inv_offset) >> inv_shift;
            r0 = clip3i(-32768, 32767, r0);
            r1 = clip3i(-32768, 32767, r1);
            const double e0 = (double)(abs16[k] - r0);
            const double e1 = (double)(abs16[k] - r1);
            derr0[k] = e0 * e0 * err_scale;
            derr1[k] = e1 * e1 * err_scale;
        }
        for (int k = 15; k >= 0; k--) {
            const int sp = cgs * 16 + k;
            const int xc = (cg_x << 2) + in_scan[2 * k];
            const int yc = (cg_y << 2) + in_scan[2 * k + 1];
            const int pos = pos16[k];
            const int abs_src = abs16[k];
            const int q_lv = qlv16[k];
            dist0[sp] = d016[k];
            dist0_total += dist0[sp];
            rd_coeff[sp] = 0.0;
            rate_sig[sp] = 0.0;
            levels[pos] = (int16_t)q_lv;
            if (q_lv > 0 && last_sp < 0) {
                last_sp = sp;
                context_set = (sp < 16 || c_idx != 0) ? 0 : 2;
                last_cg = cgs;
            }
            if (last_sp >= 0) {
                const int g1_ctx = g1_off + 4 * context_set + g1_idx;
                const int g2_ctx = g2_off + context_set;
                const int sig_idx =
                    g_off_sig + sig_ctx(log2, c_idx, scan_idx, xc, yc,
                                        xc & 3, yc & 3, xc >> 2, yc >> 2,
                                        prev_csbf);
                const bool is_last = sp == last_sp;
                // getAdjustedQuantLevel
                int adj = 0;
                double rd_here, rate_sig_here;
                if (!is_last && q_lv < 3) {
                    rate_sig_here =
                        lam * ((double)rdoq_est(sig_idx, 0) / 256.0);
                    rd_here = dist0[sp] + rate_sig_here;
                } else {
                    rd_here = std::numeric_limits<double>::max();
                    rate_sig_here = 0.0;
                }
                if (q_lv != 0 || is_last || q_lv >= 3) {
                    double sig_cost1 =
                        is_last ? 0.0
                                : lam * ((double)rdoq_est(sig_idx, 1)
                                         / 256.0);
                    const int min_lv = q_lv > 1 ? q_lv - 1 : 1;
                    for (int lv = q_lv; lv >= min_lv; lv--) {
                        double c = (lv == q_lv ? derr0[k] : derr1[k])
                                 + rdoq_level_cost(lam, lv, g1_ctx, g2_ctx,
                                                   rice, g1_cnt, g2_cnt)
                                 + sig_cost1;
                        if (c < rd_here) {
                            adj = lv;
                            rd_here = c;
                            rate_sig_here = sig_cost1;
                        }
                    }
                }
                levels[pos] = (int16_t)adj;
                rd_coeff[sp] = rd_here;
                rate_sig[sp] = rate_sig_here;
                rd_cost_tu += rd_here;
                // updateEntropyCodingEngine
                const int base = g1_cnt < 8 ? (2 + (g2_cnt < 1)) : 1;
                if (adj >= base && adj > 3 * (1 << rice))
                    rice = std::min(rice + 1, 4);
                if (adj >= 1)
                    g1_cnt++;
                if (adj > 1) {
                    g1_idx = 0;
                    g2_cnt++;
                } else if (g1_idx < 3 && g1_idx > 0 && adj) {
                    g1_idx++;
                }
                if ((sp % 16 == 0) && sp > 0) {
                    rice = 0;
                    g1_cnt = 0;
                    g2_cnt = 0;
                    context_set = (sp == 16 || c_idx != 0) ? 0 : 2;
                    if (g1_idx == 0)
                        context_set++;
                    g1_idx = 1;
                }
            } else {
                rd_cost_tu += dist0[sp];
            }
            cg_rate_sig += rate_sig[sp];
            if (k == 0)
                cg_rate_sig_pos0 = rate_sig[sp];
            if (levels[pos]) {
                csbf[cg_pos] = 1;
                cg_rd_coeff += rd_coeff[sp] - rate_sig[sp];
                cg_dist0 += dist0[sp];
                if (k != 0)
                    nz_before_pos0++;
            }
        }
        // step 2: all-zero CG decision
        if (last_cg >= 0) {
            if (cgs) {
                int cc = 0;
                if (cg_x < cgw - 1)
                    cc += csbf[cg_y * cgw + cg_x + 1];
                if (cg_y < cgw - 1)
                    cc += csbf[(cg_y + 1) * cgw + cg_x];
                const int csbf_idx =
                    g_off_csbf + std::min(cc, 1) + (c_idx ? 2 : 0);
                if (csbf[cg_pos] == 0) {
                    const double cost0 =
                        lam * ((double)rdoq_est(csbf_idx, 0) / 256.0);
                    rd_cost_tu += cost0 - cg_rate_sig;
                    rate_cg_sig[cgs] = cost0;
                } else if (cgs < last_cg) {
                    if (nz_before_pos0 == 0) {
                        rd_cost_tu -= cg_rate_sig_pos0;
                        cg_rate_sig -= cg_rate_sig_pos0;
                    }
                    const double r0 =
                        lam * ((double)rdoq_est(csbf_idx, 0) / 256.0);
                    const double r1 =
                        lam * ((double)rdoq_est(csbf_idx, 1) / 256.0);
                    double rd_zero = rd_cost_tu;
                    rd_cost_tu += r1;
                    rd_zero += r0;
                    rate_cg_sig[cgs] = r1;
                    rd_zero += cg_dist0;
                    rd_zero -= cg_rd_coeff;
                    rd_zero -= cg_rate_sig;
                    if (rd_zero < rd_cost_tu) {
                        csbf[cg_pos] = 0;
                        rd_cost_tu = rd_zero;
                        rate_cg_sig[cgs] = r0;
                        for (int j = 15; j >= 0; j--) {
                            const int xj = (cg_x << 2) + in_scan[2 * j];
                            const int yj = (cg_y << 2) + in_scan[2 * j + 1];
                            const int pj = (yj << log2) + xj;
                            const int sj = cgs * 16 + j;
                            if (levels[pj]) {
                                levels[pj] = 0;
                                rd_coeff[sj] = dist0[sj];
                                rate_sig[sj] = 0.0;
                            }
                        }
                    }
                }
            } else {
                csbf[cg_pos] = 1;
            }
        }
    }
    if (last_sp < 0)
        return 0;

    // step 3: cbf gate + RD-optimal last significant position
    double rd_best = dist0_total
                   + lam * ((double)rdoq_est(cbf_ctx_idx, 0) / 256.0);
    rd_cost_tu += lam * ((double)rdoq_est(cbf_ctx_idx, 1) / 256.0);
    int last_pos_idx = 0;
    bool found = false;
    for (int cgs = last_cg; cgs >= 0 && !found; cgs--) {
        const int cg_x = cg_scan[2 * cgs], cg_y = cg_scan[2 * cgs + 1];
        rd_cost_tu -= rate_cg_sig[cgs];
        if (!csbf[cg_y * cgw + cg_x])
            continue;
        for (int k = 15; k >= 0; k--) {
            const int sp = cgs * 16 + k;
            if (sp > last_sp)
                continue;
            const int xc = (cg_x << 2) + in_scan[2 * k];
            const int yc = (cg_y << 2) + in_scan[2 * k + 1];
            const int pos = (yc << log2) + xc;
            if (levels[pos]) {
                const double rate_last =
                    scan_idx == 2
                        ? rdoq_last_cost(lam, yc, xc, c_idx, log2)
                        : rdoq_last_cost(lam, xc, yc, c_idx, log2);
                const double total = rd_cost_tu + rate_last - rate_sig[sp];
                if (total < rd_best) {
                    last_pos_idx = sp + 1;
                    rd_best = total;
                }
                if (levels[pos] > 1) {
                    found = true;
                    break;
                }
                rd_cost_tu -= rd_coeff[sp];
                rd_cost_tu += dist0[sp];
            } else {
                rd_cost_tu -= rate_sig[sp];
            }
        }
    }

    // finalize: recover signs below last_pos_idx, zero the rest
    int nz = 0;
    for (int sp = 0; sp <= last_sp; sp++) {
        const int cgs = sp >> 4, k = sp & 15;
        const int xc = (cg_scan[2 * cgs] << 2) + in_scan[2 * k];
        const int yc = (cg_scan[2 * cgs + 1] << 2) + in_scan[2 * k + 1];
        const int pos = (yc << log2) + xc;
        if (sp < last_pos_idx) {
            const int lv = levels[pos];
            if (lv) {
                nz++;
                levels[pos] = (int16_t)(coeffs[pos] < 0 ? -lv : lv);
            }
        } else {
            levels[pos] = 0;
        }
    }
    return nz;
}

// one intra TB trial: predict + transform + quant + recon; returns dist and
// fills levels/rec. pred is the exact (edge-filtered) prediction.
struct TbTrial {
    int16_t levels[32 * 32];
    int nz;
    int32_t rec[32 * 32];
    double dist;
};

void try_tb(const int32_t* orig_b, const int32_t* pred, int n, int log2,
            int qp_full, int bd, int use_dst, int intra, int scan_idx,
            int c_idx, int cbf_ctx, TbTrial& t) {
    LeafTimer pt(14);
    static thread_local int32_t res[32 * 32], coeffs[32 * 32];
    for (int i = 0; i < n * n; i++)
        res[i] = orig_b[i] - pred[i];
    fwd_transform(res, n, bd, use_dst, coeffs);
    t.nz = en.rdoq
        ? rdoq_quantize(coeffs, qp_full, bd, log2, c_idx, scan_idx,
                        cbf_ctx, t.levels)
        : quantize(coeffs, n, qp_full, bd, log2, intra, t.levels);
    if (t.nz && g_sp.sdh_enabled)
        apply_sdh_c(t.levels, coeffs, qp_full, bd, log2, scan_idx);
    int max_val = (1 << bd) - 1;
    if (t.nz) {
        std::memcpy(t.rec, pred, n * n * 4);
        dequant_idct_add(t.levels, n, n, log2, qp_full, bd, use_dst, t.rec);
        for (int i = 0; i < n * n; i++)
            t.rec[i] = clip3i(0, max_val, t.rec[i]);
    } else {
        for (int i = 0; i < n * n; i++)
            t.rec[i] = clip3i(0, max_val, pred[i]);
    }
    t.dist = (double)ssd_i32(t.rec, orig_b, n * n);
}

// gather an (n, n) int16 plane region into int32
inline void gather32(const int16_t* plane, int stride, int x0, int y0, int n,
                     int32_t* out) {
    for (int y = 0; y < n; y++)
        for (int x = 0; x < n; x++)
            out[y * n + x] = plane[(int64_t)(y0 + y) * stride + (x0 + x)];
}

inline void scatter16(int16_t* plane, int stride, int x0, int y0, int n,
                      const int32_t* in) {
    for (int y = 0; y < n; y++)
        for (int x = 0; x < n; x++)
            plane[(int64_t)(y0 + y) * stride + (x0 + x)] =
                (int16_t)in[y * n + x];
}

inline void scatter_lv(int16_t* plane, int stride, int x0, int y0, int n,
                       const int16_t* in) {
    for (int y = 0; y < n; y++)
        std::memcpy(plane + (int64_t)(y0 + y) * stride + x0, in + y * n,
                    n * 2);
}

// chroma half of an intra CU: candidate-searched chroma mode
// (searchIntraChroma, Search.hpp:271): DM + planar/vertical/horizontal/DC
// (34 substituted for a DM duplicate), each fully reconstructed and
// RD-costed; mode bits 1 (DM) / 3 (list entry) match the writer's
// binarization. Sets intra_mode_c; returns dist + lam * bits.
double intra_chroma(int cx, int cy, int cs, int clog2, int dm,
                    int x0, int y0, int size) {
    const int bd_c = g_sp.bit_depth_c;
    int cand[5] = {dm, 0, 26, 10, 1};
    for (int i = 1; i < 5; i++)
        if (cand[i] == dm)
            cand[i] = 34;
    static thread_local int32_t orig_c[2][32 * 32], pred[32 * 32];
    int32_t rt[2][64], rl[2][64], corner[2];
    for (int ci = 0; ci < 2; ci++) {
        gather32(en.orig[ci + 1], cw_(), cx, cy, cs, orig_c[ci]);
        build_intra_refs(en.rec[ci + 1], cw_(), chh_(), en.zscan32, g_sp.w4,
                         cx, cy, cs, 2, bd_c, rt[ci], rl[ci], &corner[ci]);
    }
    // SATD pre-ranking gate (beyond the reference, like the luma
    // SATD-gate): predict all 5 candidates for both planes once, rank by
    // SATD + mode bits (1 bin DM / 3 bins list entry), and RD-evaluate
    // only the top 2 — stable order, ties to the lower index
    static thread_local int32_t cpreds[5][2][32 * 32];
    double gate[5];
    const int cblk = cs >= 8 ? 8 : 4;
    for (int k = 0; k < 5; k++) {
        int m = cand[k];
        int64_t s = 0;
        for (int ci = 0; ci < 2; ci++) {
            intra_predict_core(m, rt[ci], rl[ci], corner[ci], cs, 1, bd_c,
                               0, cpreds[k][ci]);
            s += satd_region(orig_c[ci], cpreds[k][ci], cs, cs, cblk);
        }
        gate[k] = (double)s + cur.lam_bits * (k == 0 ? 1.0 : 3.0);
    }
    int keep0 = 0, keep1 = -1;
    for (int k = 1; k < 5; k++)
        if (gate[k] < gate[keep0]) {
            keep1 = keep0;
            keep0 = k;
        } else if (keep1 < 0 || gate[k] < gate[keep1]) {
            keep1 = k;
        }
    static thread_local TbTrial cur_t[2], best_t[2];
    CandRate best_cr;
    double best_cost = 0.0;
    int best_k = -1;
    for (int k = 0; k < 5; k++) {
        static const bool no_gate_env =
            getenv("TC_NO_SATDGATE") != nullptr;
        const bool no_gate = no_gate_env || en.rd_candidates >= 3;
        if (!no_gate && k != keep0 && k != keep1)
            continue;
        int m = cand[k];
        // exact chroma-mode bins, then cbf + residual chained cb -> cr
        // (intra_search._encode_chroma twin)
        CandRate crk;
        crk.init();
        emit_chroma_mode(crk, k);
        double ck = cur.lam * ((double)crk.frac / 256.0);
        for (int ci = 0; ci < 2; ci++) {
            int qp = ci == 0 ? cur.qp_cb_full : cur.qp_cr_full;
            try_tb(orig_c[ci], cpreds[k][ci], cs, clog2, qp, bd_c, 0, 1,
                   scan_for(clog2, ci + 1, m, 1), ci + 1,
                   g_sp.off[E_CBF_CHROMA], cur_t[ci]);
            const int64_t base = crk.frac;
            crk.bin(E_CBF_CHROMA, 0, cur_t[ci].nz ? 1 : 0);
            if (cur_t[ci].nz)
                emit_residual_ts(crk, cur_t[ci].levels, clog2, ci + 1, m,
                                 1, 0);
            ck += cur_t[ci].dist
                + cur.lam * ((double)(crk.frac - base) / 256.0);
        }
        if (best_k < 0 || ck < best_cost) {
            best_cost = ck;
            best_k = k;
            best_t[0] = cur_t[0];
            best_t[1] = cur_t[1];
            best_cr = crk;
        }
    }
    cr_commit(best_cr);
    const int m = cand[best_k];
    fillq(g_sp.intra_mode_c, x0, y0, size, (uint8_t)m);
    for (int ci = 0; ci < 2; ci++) {
        int16_t* coeffp = ci == 0 ? g_sp.coeff_cb : g_sp.coeff_cr;
        uint8_t* cbfp = ci == 0 ? g_sp.cbf_cb : g_sp.cbf_cr;
        scatter_lv(coeffp, cw_(), cx, cy, cs, best_t[ci].levels);
        fillq(cbfp, x0, y0, size, (uint8_t)(best_t[ci].nz ? 1 : 0));
        scatter16(en.rec[ci + 1], cw_(), cx, cy, cs, best_t[ci].rec);
    }
    return best_cost;
}

// intra_search._encode_cu: best 2Nx2N intra CU at (x0, y0).
// budget (inter pictures): the inter champion's RD cost less the
// pred_mode-flag bits — when even the best SATD ranking cost reaches it,
// the RD refinement is skipped outright (beyond the reference; the
// caller's snapshot restore rolls back the partial commit)
double encode_intra_cu(int x0, int y0, int log2, int depth,
                       double budget = std::numeric_limits<double>::max()) {
    PhaseTimer pt(2);
    const int size = 1 << log2;
    const int bd = g_sp.bit_depth_y;
    fillq(g_sp.ct_depth, x0, y0, size, (uint8_t)depth);
    fillq(g_sp.cu_pred_mode, x0, y0, size, (uint8_t)1);
    fillq(g_sp.part_mode, x0, y0, size, (uint8_t)0);
    fillq(g_sp.cu_size_log2, x0, y0, size, (uint8_t)log2);
    fillq(g_sp.cu_id, x0, y0, size, cur.ids[0]);
    fillq(g_sp.pu_id, x0, y0, size, cur.ids[1]);
    cur.ids[0]++;
    cur.ids[1]++;

    // CU-level mode bins (committed up front; the caller's snapshot rolls
    // them back if this trial loses): cu_skip=0 + pred_mode=1 in inter
    // slices, part_mode=2Nx2N at min CB size (intra_search._encode_cu)
    CandRate head;
    head.init();
    if (!g_sp.is_i) {
        emit_cu_skip(head, x0, y0, 0);
        head.bin(E_PRED_MODE, 0, 1);
    }
    if (log2 == g_sp.min_cb_log2)
        head.bin(E_PART_MODE, 0, 1);
    cr_commit(head);
    const double head_bits = cur.lam * ((double)head.frac / 256.0);

    static thread_local int32_t orig_y[64 * 64], pred[64 * 64];
    gather32(en.orig[0], g_sp.pic_w, x0, y0, size, orig_y);

    int32_t rt[64], rl[64], corner;
    build_intra_refs(en.rec[0], g_sp.pic_w, g_sp.pic_h, en.zscan32, g_sp.w4,
                     x0, y0, size, 1, bd, rt, rl, &corner);
    int mpm[3];
    const int n_mpm = sp_intra_mpm_n(x0, y0, mpm);
    int cands[35];
    // RD-refinement candidate count (Speed.h nCandidatesIntraRefinement:
    // slow 8; medium 3 above 8x8 else 8; fast 3 above 8x8 else 4)
    int ncand_want = en.rd_candidates >= 3
        ? 8 : (log2 > 3 ? 3 : (en.rd_candidates == 2 ? 8 : 4));
    double cand_costs[35];
    // Source-referenced SATD ranking (default at MET presets): neighbour
    // samples come from the SOURCE plane, so the ranking is a pure
    // positional function of the input picture — a whole-picture
    // precomputable stage with a device twin (rank SATD tables). RD
    // refinement keeps exact recon refs. BD vs recon-ranking (24f
    // caminandes): fast-LDP -0.16%, fast-RA +0.34% — kept off at slow
    // (+0.27% there). TC_SRC_RANK forces on, TC_NO_SRC_RANK off.
    static const bool src_force = getenv("TC_SRC_RANK") != nullptr;
    static const bool src_off = getenv("TC_NO_SRC_RANK") != nullptr;
    const bool src_rank =
        !src_off && (src_force || en.rd_candidates <= 2);
    int32_t srt[64], srl[64], scorner;
    if (src_rank)
        build_intra_refs(en.orig[0], g_sp.pic_w, g_sp.pic_h, en.zscan32,
                         g_sp.w4, x0, y0, size, 1, bd, srt, srl, &scorner);
    int ncand = rank_modes(orig_y, src_rank ? srt : rt, src_rank ? srl : rl,
                           src_rank ? scorner : corner, size, mpm,
                           ncand_want, cands, cand_costs,
                           g_sp.is_i ? n_mpm : 0, nullptr, x0, y0,
                           src_rank ? 1 : 0);
    {
        static const bool no_gate_env =
            getenv("TC_NO_SATDGATE") != nullptr;
        const bool no_gate = no_gate_env || en.rd_candidates >= 3;
        if (!no_gate && cand_costs[0] >= budget)
            return std::numeric_limits<double>::max();
    }

    static thread_local TbTrial trial, best_t;
    CandRate best_cr;
    double best_cost = 0.0;
    int best_mode = -1;
    int use_dst = log2 == 2;
    int32_t frt[64], frl[64], fc;
    for (int k = 0; k < ncand; k++) {
        int mode = cands[k];
        // SATD-gate (see encode_intra_nxn); the second clause stops the
        // refinement adaptively once the achieved RD cost undercuts the
        // next candidate's SATD ranking cost
        static const bool no_gate_env =
            getenv("TC_NO_SATDGATE") != nullptr;
        const bool no_gate = no_gate_env || en.rd_candidates >= 3;
        if (!no_gate && k > 0 && mode != 0
            && (cand_costs[k] > 1.5 * cand_costs[0]
                || (best_mode >= 0 && best_cost <= cand_costs[k])))
            continue;
        std::memcpy(frt, rt, 2 * size * 4);
        std::memcpy(frl, rl, 2 * size * 4);
        fc = corner;
        filter_intra_refs(frt, frl, &fc, size, mode, en.strong, bd);
        intra_predict_core(mode, frt, frl, fc, size, 0, bd, 0, pred);
        try_tb(orig_y, pred, size, log2, cur.qp_full, bd, use_dst, 1,
               scan_for(log2, 0, mode, 1), 0,
               g_sp.off[E_CBF_LUMA] + 1, trial);
        // exact mode + cbf + residual bins, chained on a pool copy
        CandRate crc;
        crc.init();
        emit_intra_luma_mode(crc, mode, mpm);
        crc.bin(E_CBF_LUMA, 1, trial.nz ? 1 : 0);
        if (trial.nz)
            emit_residual_ts(crc, trial.levels, log2, 0, mode, 1, 0);
        double cost = trial.dist + cur.lam * ((double)crc.frac / 256.0);
        if (best_mode < 0 || cost < best_cost) {
            best_cost = cost;
            best_mode = mode;
            best_t = trial;
            best_cr = crc;
        }
    }
    cr_commit(best_cr);
    best_cost += head_bits;
    fillq(g_sp.intra_mode_y, x0, y0, size, (uint8_t)best_mode);
    fillq(g_sp.tu_log2, x0, y0, size, (uint8_t)log2);
    fillq(g_sp.tu_id, x0, y0, size, cur.ids[2]);
    cur.ids[2]++;
    scatter_lv(g_sp.coeff_y, g_sp.pic_w, x0, y0, size, best_t.levels);
    fillq(g_sp.cbf_y, x0, y0, size, (uint8_t)(best_t.nz ? 1 : 0));
    scatter16(en.rec[0], g_sp.pic_w, x0, y0, size, best_t.rec);

    return best_cost
         + intra_chroma(x0 >> 1, y0 >> 1, size >> 1, log2 - 1, best_mode,
                        x0, y0, size);
}

// intra_search._encode_cu_nxn: four 4x4 PUs/TUs + 4x4 chroma pair.
// budget: the already-committed 8x8 winner's cost less the split bits —
// once the sum of committed sub-PU costs plus the next sub-PU's best
// SATD ranking cost reaches it, NxN cannot win and the trial bails
// (caller's snapshot restore rolls back the partial commit)
double encode_intra_nxn(int x0, int y0, int log2, int depth,
                        double budget = std::numeric_limits<double>::max()) {
    PhaseTimer pt(13);
    const int size = 1 << log2;
    const int half = size >> 1;
    const int bd = g_sp.bit_depth_y;
    const int64_t plane4 = (int64_t)g_sp.h4 * g_sp.w4;
    fillq(g_sp.ct_depth, x0, y0, size, (uint8_t)depth);
    fillq(g_sp.cu_pred_mode, x0, y0, size, (uint8_t)1);
    fillq(g_sp.part_mode, x0, y0, size, (uint8_t)3);  // PART_NxN
    fillq(g_sp.cu_size_log2, x0, y0, size, (uint8_t)log2);
    fillq(g_sp.cu_id, x0, y0, size, cur.ids[0]);
    cur.ids[0]++;
    fillq(g_sp.ref_idx, x0, y0, size, (int8_t)-1);
    fillq(g_sp.ref_idx + plane4, x0, y0, size, (int8_t)-1);

    // CU-level mode bins (see encode_intra_cu); part_mode bin = 0 (NxN)
    CandRate head;
    head.init();
    if (!g_sp.is_i) {
        emit_cu_skip(head, x0, y0, 0);
        head.bin(E_PRED_MODE, 0, 1);
    }
    head.bin(E_PART_MODE, 0, 0);
    cr_commit(head);
    const double head_bits = cur.lam * ((double)head.frac / 256.0);

    static thread_local int32_t orig_b[16], pred[16];
    int32_t rt[64], rl[64], corner;
    TbTrial trial, best_t;
    CandRate best_cr;
    double cost = head_bits;
    int modes[4];
    for (int i = 0; i < 4; i++) {
        int xb = x0 + (i & 1) * half;
        int yb = y0 + (i >> 1) * half;
        fillq(g_sp.pu_id, xb, yb, half, cur.ids[1]);
        cur.ids[1]++;
        gather32(en.orig[0], g_sp.pic_w, xb, yb, half, orig_b);
        build_intra_refs(en.rec[0], g_sp.pic_w, g_sp.pic_h, en.zscan32,
                         g_sp.w4, xb, yb, half, 1, bd, rt, rl, &corner);
        int mpm[3];
        const int n_mpm = sp_intra_mpm_n(xb, yb, mpm);
        // 4x4 partitions: 8 candidates at slow/medium, 4 at fast
        // (Speed.h nCandidatesIntraRefinement, log2PartitionSize == 2)
        int count = en.rd_candidates >= 2 ? 8 : 4;
        int cands[35];
        double cand_costs[35];
        static const bool src_force = getenv("TC_SRC_RANK") != nullptr;
        static const bool src_off = getenv("TC_NO_SRC_RANK") != nullptr;
        const bool src_rank =
            !src_off && (src_force || en.rd_candidates <= 2);
        int32_t srt[64], srl[64], scorner;
        if (src_rank)
            build_intra_refs(en.orig[0], g_sp.pic_w, g_sp.pic_h,
                             en.zscan32, g_sp.w4, xb, yb, half, 1, bd,
                             srt, srl, &scorner);
        int ncand = rank_modes(orig_b, src_rank ? srt : rt,
                               src_rank ? srl : rl,
                               src_rank ? scorner : corner, half, mpm,
                               count, cands, cand_costs,
                               g_sp.is_i ? n_mpm : 0, nullptr, xb, yb,
                               src_rank ? 1 : 0);
        {
            static const bool no_gate_env =
                getenv("TC_NO_SATDGATE") != nullptr;
            const bool no_gate =
                no_gate_env || en.rd_candidates >= 3;
            if (!no_gate && cost + cand_costs[0] >= budget)
                return std::numeric_limits<double>::max();
        }
        double best_cost = 0.0;
        int best_mode = -1;
        for (int k = 0; k < ncand; k++) {
            // SATD-gate (beyond the reference): a candidate whose ranking
            // cost is already 1.5x the leader's essentially never wins the
            // RD refinement; planar is exempt (kept for its flat-rate win).
            // Second clause: adaptive stop once the achieved RD cost
            // undercuts the next candidate's SATD ranking cost.
            static const bool no_gate_env =
                getenv("TC_NO_SATDGATE") != nullptr;
            const bool no_gate =
                no_gate_env || en.rd_candidates >= 3;
            if (!no_gate && k > 0 && cands[k] != 0
                && (cand_costs[k] > 1.5 * cand_costs[0]
                    || (best_mode >= 0 && best_cost <= cand_costs[k])))
                continue;
            int mode = cands[k];
            intra_predict_core(mode, rt, rl, corner, half, 0, bd, 0, pred);
            try_tb(orig_b, pred, half, 2, cur.qp_full, bd, 1, 1,
                   scan_for(2, 0, mode, 1), 0,
                   g_sp.off[E_CBF_LUMA], trial);
            // exact mode + cbf (trafo depth 1 -> ctx 0) + residual bins
            CandRate crc;
            crc.init();
            emit_intra_luma_mode(crc, mode, mpm);
            crc.bin(E_CBF_LUMA, 0, trial.nz ? 1 : 0);
            if (trial.nz)
                emit_residual_ts(crc, trial.levels, 2, 0, mode, 1, 0);
            double c = trial.dist + cur.lam * ((double)crc.frac / 256.0);
            if (best_mode < 0 || c < best_cost) {
                best_cost = c;
                best_mode = mode;
                best_t = trial;
                best_cr = crc;
            }
        }
        cr_commit(best_cr);
        cost += best_cost;
        modes[i] = best_mode;
        fillq(g_sp.intra_mode_y, xb, yb, half, (uint8_t)best_mode);
        fillq(g_sp.tu_log2, xb, yb, half, (uint8_t)2);
        fillq(g_sp.tu_id, xb, yb, half, cur.ids[2]);
        cur.ids[2]++;
        scatter_lv(g_sp.coeff_y, g_sp.pic_w, xb, yb, half, best_t.levels);
        fillq(g_sp.cbf_y, xb, yb, half, (uint8_t)(best_t.nz ? 1 : 0));
        scatter16(en.rec[0], g_sp.pic_w, xb, yb, half, best_t.rec);
    }
    return cost + intra_chroma(x0 >> 1, y0 >> 1, size >> 1, 2, modes[0],
                               x0, y0, size);
}

// 64x64 intra CU with the forced transform split (Search.hpp:374
// searchIntraCu at log2CbSize 6: four 32x32 TUs sharing one luma mode;
// chroma codes four 16x16 TB pairs under the depth-0 cbf). Trialed at
// the slow preset (rd_candidates >= 3) against the quadtree split.
// Ranking uses SOURCE-referenced neighbours for all four quadrants
// (quadrants 1-3 have no reconstruction before the mode is chosen);
// the RD refinement reconstructs quadrants sequentially from exact
// recon references, so decoder replay matches bit-exactly.
static const int Z4[4][2] = {{0, 0}, {0, 1}, {1, 0}, {1, 1}};  // (dy,dx)

double intra_chroma64(int x0, int y0, int dm) {
    const int bd_c = g_sp.bit_depth_c;
    const int cx = x0 >> 1, cy = y0 >> 1;  // 32x32 chroma area
    int cand[5] = {dm, 0, 26, 10, 1};
    for (int i = 1; i < 5; i++)
        if (cand[i] == dm)
            cand[i] = 34;
    static thread_local int32_t orig_q[2][4][16 * 16], pred[16 * 16];
    static thread_local int16_t base_rec[2][32 * 32], best_rec[2][32 * 32];
    static thread_local int16_t cur_lv[2][4][16 * 16],
        best_lv[2][4][16 * 16];
    int cur_nz[2][4], best_nz[2][4];
    const int cw = cw_();
    for (int ci = 0; ci < 2; ci++)
        for (int q = 0; q < 4; q++)
            gather32(en.orig[ci + 1], cw, cx + Z4[q][1] * 16,
                     cy + Z4[q][0] * 16, 16, orig_q[ci][q]);
    for (int ci = 0; ci < 2; ci++)
        for (int y = 0; y < 32; y++)
            std::memcpy(base_rec[ci] + y * 32,
                        en.rec[ci + 1] + (int64_t)(cy + y) * cw + cx,
                        32 * 2);
    CandRate best_cr;
    double best_cost = 0.0;
    int best_k = -1;
    int32_t rt[64], rl[64], corner;
    static thread_local TbTrial t;
    for (int k = 0; k < 5; k++) {
        const int m = cand[k];
        // reconstruct the four 16x16 TB pairs sequentially (later
        // quadrants predict from earlier ones' recon)
        double dist = 0.0;
        for (int q = 0; q < 4; q++) {
            const int qx = cx + Z4[q][1] * 16, qy = cy + Z4[q][0] * 16;
            for (int ci = 0; ci < 2; ci++) {
                build_intra_refs(en.rec[ci + 1], cw, chh_(), en.zscan32,
                                 g_sp.w4, qx, qy, 16, 2, bd_c, rt, rl,
                                 &corner);
                intra_predict_core(m, rt, rl, corner, 16, 1, bd_c, 0,
                                   pred);
                try_tb(orig_q[ci][q], pred, 16, 4,
                       ci == 0 ? cur.qp_cb_full : cur.qp_cr_full, bd_c, 0,
                       1, scan_for(4, ci + 1, m, 1), ci + 1,
                       g_sp.off[E_CBF_CHROMA] + 1, t);
                std::memcpy(cur_lv[ci][q], t.levels, 16 * 16 * 2);
                cur_nz[ci][q] = t.nz;
                dist += t.dist;
                scatter16(en.rec[ci + 1], cw, qx, qy, 16, t.rec);
            }
        }
        // exact chroma-group bins in writer order: mode, parent cbf_cb/
        // cbf_cr (ctx 0), then per quadrant cbf pair (ctx 1) + residuals
        CandRate crk;
        crk.init();
        emit_chroma_mode(crk, k);
        // nz is a nonzero-coefficient count: normalize to bin values
        const int p_cb = (cur_nz[0][0] || cur_nz[0][1] || cur_nz[0][2]
                          || cur_nz[0][3]) ? 1 : 0;
        const int p_cr = (cur_nz[1][0] || cur_nz[1][1] || cur_nz[1][2]
                          || cur_nz[1][3]) ? 1 : 0;
        crk.bin(E_CBF_CHROMA, 0, p_cb);
        crk.bin(E_CBF_CHROMA, 0, p_cr);
        for (int q = 0; q < 4; q++) {
            if (p_cb)
                crk.bin(E_CBF_CHROMA, 1, cur_nz[0][q] ? 1 : 0);
            if (p_cr)
                crk.bin(E_CBF_CHROMA, 1, cur_nz[1][q] ? 1 : 0);
            if (cur_nz[0][q])
                emit_residual_ts(crk, cur_lv[0][q], 4, 1, m, 1, 0);
            if (cur_nz[1][q])
                emit_residual_ts(crk, cur_lv[1][q], 4, 2, m, 1, 0);
        }
        const double ck = dist + cur.lam * ((double)crk.frac / 256.0);
        const bool take = best_k < 0 || ck < best_cost;
        if (take) {
            best_cost = ck;
            best_k = k;
            best_cr = crk;
            std::memcpy(best_nz, cur_nz, sizeof(cur_nz));
            std::memcpy(best_lv, cur_lv, sizeof(cur_lv));
            for (int ci = 0; ci < 2; ci++)
                for (int y = 0; y < 32; y++)
                    std::memcpy(best_rec[ci] + y * 32,
                                en.rec[ci + 1] + (int64_t)(cy + y) * cw
                                    + cx, 32 * 2);
        }
        // roll the trial recon back for the next candidate
        if (k < 4)
            for (int ci = 0; ci < 2; ci++)
                for (int y = 0; y < 32; y++)
                    std::memcpy(en.rec[ci + 1] + (int64_t)(cy + y) * cw
                                    + cx, base_rec[ci] + y * 32, 32 * 2);
    }
    cr_commit(best_cr);
    const int m = cand[best_k];
    fillq(g_sp.intra_mode_c, x0, y0, 64, (uint8_t)m);
    for (int ci = 0; ci < 2; ci++) {
        int16_t* coeffp = ci == 0 ? g_sp.coeff_cb : g_sp.coeff_cr;
        uint8_t* cbfp = ci == 0 ? g_sp.cbf_cb : g_sp.cbf_cr;
        for (int q = 0; q < 4; q++) {
            const int qx = cx + Z4[q][1] * 16, qy = cy + Z4[q][0] * 16;
            for (int y = 0; y < 16; y++)
                std::memcpy(coeffp + (int64_t)(qy + y) * cw + qx,
                            best_lv[ci][q] + y * 16, 16 * 2);
            fillq(cbfp, x0 + Z4[q][1] * 32, y0 + Z4[q][0] * 32, 32,
                  (uint8_t)(best_nz[ci][q] ? 1 : 0));
        }
        for (int y = 0; y < 32; y++)
            std::memcpy(en.rec[ci + 1] + (int64_t)(cy + y) * cw + cx,
                        best_rec[ci] + y * 32, 32 * 2);
    }
    return best_cost;
}

double encode_intra_cu64(int x0, int y0, int depth,
                         double budget
                         = std::numeric_limits<double>::max()) {
    PhaseTimer pt(2);
    const int bd = g_sp.bit_depth_y;
    fillq(g_sp.ct_depth, x0, y0, 64, (uint8_t)depth);
    fillq(g_sp.cu_pred_mode, x0, y0, 64, (uint8_t)1);
    fillq(g_sp.part_mode, x0, y0, 64, (uint8_t)0);
    fillq(g_sp.cu_size_log2, x0, y0, 64, (uint8_t)6);
    fillq(g_sp.cu_id, x0, y0, 64, cur.ids[0]);
    fillq(g_sp.pu_id, x0, y0, 64, cur.ids[1]);
    cur.ids[0]++;
    cur.ids[1]++;

    CandRate head;
    head.init();
    if (!g_sp.is_i) {
        emit_cu_skip(head, x0, y0, 0);
        head.bin(E_PRED_MODE, 0, 1);
    }
    cr_commit(head);
    const double head_bits = cur.lam * ((double)head.frac / 256.0);

    // per-quadrant SOURCE-referenced 35-mode SATD, summed per mode
    static thread_local int32_t orig_q[4][32 * 32];
    int64_t satd[4][35];
    int mpm[3];
    sp_intra_mpm_n(x0, y0, mpm);
    {
        int32_t srt[64], srl[64], sc;
        int dummy[35];
        for (int q = 0; q < 4; q++) {
            const int qx = x0 + Z4[q][1] * 32, qy = y0 + Z4[q][0] * 32;
            gather32(en.orig[0], g_sp.pic_w, qx, qy, 32, orig_q[q]);
            build_intra_refs(en.orig[0], g_sp.pic_w, g_sp.pic_h,
                             en.zscan32, g_sp.w4, qx, qy, 32, 1, bd, srt,
                             srl, &sc);
            rank_modes(orig_q[q], srt, srl, sc, 32, mpm, 1, dummy,
                       nullptr, 0, satd[q], qx, qy, 1);
        }
    }
    struct MC {
        double cost;
        int mode;
    } mc[35];
    for (int m = 0; m < 35; m++) {
        const int in_mpm = m == mpm[0] || m == mpm[1] || m == mpm[2];
        mc[m].cost = (double)(satd[0][m] + satd[1][m] + satd[2][m]
                              + satd[3][m])
                   + cur.lam_bits * (in_mpm ? 2 : 6);
        mc[m].mode = m;
    }
    const int ncand = en.rd_candidates >= 3 ? 8 : 3;
    for (int i = 0; i < ncand; i++) {  // stable partial selection
        int best = i;
        for (int j = i + 1; j < 35; j++)
            if (mc[j].cost < mc[best].cost)
                best = j;
        if (best != i) {
            MC tmp = mc[best];
            std::memmove(mc + i + 1, mc + i, (best - i) * sizeof(MC));
            mc[i] = tmp;
        }
    }

    // refinement: reconstruct the four 32x32 TUs sequentially per mode
    static thread_local int16_t base_rec[64 * 64], best_rec[64 * 64];
    static thread_local int16_t cur_lv[4][32 * 32], best_lv[4][32 * 32];
    static thread_local int32_t pred[32 * 32];
    static thread_local TbTrial t;
    int cur_nz[4], best_nz[4];
    const int pw = g_sp.pic_w;
    for (int y = 0; y < 64; y++)
        std::memcpy(base_rec + y * 64,
                    en.rec[0] + (int64_t)(y0 + y) * pw + x0, 64 * 2);
    CandRate best_cr;
    double best_cost = 0.0;
    int best_mode = -1;
    int32_t rt[64], rl[64], corner, frt[64], frl[64], fc;
    for (int k = 0; k < ncand; k++) {
        const int mode = mc[k].mode;
        double dist = 0.0;
        CandRate crc;
        crc.init();
        emit_intra_luma_mode(crc, mode, mpm);
        for (int q = 0; q < 4; q++) {
            const int qx = x0 + Z4[q][1] * 32, qy = y0 + Z4[q][0] * 32;
            build_intra_refs(en.rec[0], pw, g_sp.pic_h, en.zscan32,
                             g_sp.w4, qx, qy, 32, 1, bd, rt, rl, &corner);
            std::memcpy(frt, rt, 2 * 32 * 4);
            std::memcpy(frl, rl, 2 * 32 * 4);
            fc = corner;
            filter_intra_refs(frt, frl, &fc, 32, mode, en.strong, bd);
            intra_predict_core(mode, frt, frl, fc, 32, 0, bd, 0, pred);
            try_tb(orig_q[q], pred, 32, 5, cur.qp_full, bd, 0, 1,
                   scan_for(5, 0, mode, 1), 0, g_sp.off[E_CBF_LUMA], t);
            std::memcpy(cur_lv[q], t.levels, 32 * 32 * 2);
            cur_nz[q] = t.nz;
            dist += t.dist;
            scatter16(en.rec[0], pw, qx, qy, 32, t.rec);
            crc.bin(E_CBF_LUMA, 0, t.nz ? 1 : 0);
            if (t.nz)
                emit_residual_ts(crc, cur_lv[q], 5, 0, mode, 1, 0);
        }
        const double cost = dist + cur.lam * ((double)crc.frac / 256.0);
        if (best_mode < 0 || cost < best_cost) {
            best_cost = cost;
            best_mode = mode;
            best_cr = crc;
            std::memcpy(best_nz, cur_nz, sizeof(cur_nz));
            std::memcpy(best_lv, cur_lv, sizeof(cur_lv));
            for (int y = 0; y < 64; y++)
                std::memcpy(best_rec + y * 64,
                            en.rec[0] + (int64_t)(y0 + y) * pw + x0,
                            64 * 2);
        }
        if (k < ncand - 1)
            for (int y = 0; y < 64; y++)
                std::memcpy(en.rec[0] + (int64_t)(y0 + y) * pw + x0,
                            base_rec + y * 64, 64 * 2);
    }
    cr_commit(best_cr);
    best_cost += head_bits;
    fillq(g_sp.intra_mode_y, x0, y0, 64, (uint8_t)best_mode);
    fillq(g_sp.tu_log2, x0, y0, 64, (uint8_t)5);
    for (int q = 0; q < 4; q++) {
        const int qx = x0 + Z4[q][1] * 32, qy = y0 + Z4[q][0] * 32;
        fillq(g_sp.tu_id, qx, qy, 32, cur.ids[2]);
        cur.ids[2]++;
        scatter_lv(g_sp.coeff_y, pw, qx, qy, 32, best_lv[q]);
        fillq(g_sp.cbf_y, qx, qy, 32, (uint8_t)(best_nz[q] ? 1 : 0));
    }
    for (int y = 0; y < 64; y++)
        std::memcpy(en.rec[0] + (int64_t)(y0 + y) * pw + x0,
                    best_rec + y * 64, 64 * 2);
    (void)budget;
    return best_cost + intra_chroma64(x0, y0, best_mode);
}

// ---------------------------------------------------------------- inter

// ---- subpel plane cache build/read (see EN::SubpelSet) ----
// SP_B: integer-pel reach beyond the picture still served by the planes
// (larger motions fall back to per-candidate mc_interp, bit-equal).
static const int SP_B = 24;
static const int SP_P = SP_B + 4;    // stored plane pad (V taps reach +4)
static const int SP_EXT = SP_P + 4;  // ext/H-plane pad (H taps reach +4)

// All three build stages are row-banded so that overlap-mode consumers
// can filter an in-flight reference plane incrementally, bounded by its
// producer's published final rows (values identical to the whole-plane
// build: every row is a pure function of the ref rows it reads).
static void sp_build_ext_rows(EN::SubpelSet& s, const int16_t* ref,
                              int y1) {
    const int w = g_sp.pic_w, h = g_sp.pic_h;
    const int pw = w + 2 * SP_EXT, ph = h + 2 * SP_EXT;
    if (y1 > ph)
        y1 = ph;
    s.ext.resize((size_t)pw * ph);
    int16_t* dst = s.ext.data();
    for (int y = s.ext_rows; y < y1; y++) {
        const int sy = clip3i(0, h - 1, y - SP_EXT);
        const int16_t* row = ref + (int64_t)sy * w;
        int16_t* drow = dst + (int64_t)y * pw;
        for (int x = 0; x < SP_EXT; x++)
            drow[x] = row[0];
        std::memcpy(drow + SP_EXT, row, w * sizeof(int16_t));
        for (int x = 0; x < SP_EXT; x++)
            drow[SP_EXT + w + x] = row[w - 1];
    }
    if (y1 > s.ext_rows)
        s.ext_rows = y1;
}

// H-filtered intermediate for xf (rows cover pad SP_EXT vertically so the
// 2D V pass can read its tap reach); same acc>>shift1 as mc_interp
static void sp_build_h_rows(EN::SubpelSet& s, const int16_t* ref, int xf,
                            int y1) {
    const int w = g_sp.pic_w, h = g_sp.pic_h;
    const int pw = w + 2 * SP_EXT, ph = h + 2 * SP_EXT;
    if (y1 > ph)
        y1 = ph;
    sp_build_ext_rows(s, ref, y1);
    const int shift1 = g_sp.bit_depth_y - 8;
    const int32_t* fh = en.luma_filt[xf];
    auto& hp = s.hplane[xf];
    hp.resize((size_t)pw * ph);
    const int16_t* ext = s.ext.data();
    int16_t* dst = hp.data();
    // output col x (ext coords) needs ext[x-3 .. x+4]: valid for
    // x in [3, pw-5]; edge cols replicate the clamped filter result
    for (int y = s.h_rows[xf]; y < y1; y++) {
        const int16_t* row = ext + (int64_t)y * pw;
        int16_t* drow = dst + (int64_t)y * pw;
        for (int x = 0; x < pw; x++) {
            int acc = 0;
            if (x >= 3 && x + 4 < pw) {
                const int16_t* p = row + x - 3;
                for (int k = 0; k < 8; k++)
                    acc += fh[k] * p[k];
            } else {
                for (int k = 0; k < 8; k++)
                    acc += fh[k] * row[clip3i(0, pw - 1, x - 3 + k)];
            }
            drow[x] = (int16_t)(acc >> shift1);
        }
    }
    if (y1 > s.h_rows[xf])
        s.h_rows[xf] = y1;
}

static void sp_build_plane_rows(EN::SubpelSet& s, const int16_t* ref,
                                int xf, int yf, int y1p) {
    PhaseTimer pt(26);
    const int w = g_sp.pic_w, h = g_sp.pic_h;
    const int pw = w + 2 * SP_P, ph = h + 2 * SP_P;
    const int ew = w + 2 * SP_EXT;
    const int shift1 = g_sp.bit_depth_y - 8;
    const int pos = xf + 4 * yf;
    if (y1p > ph)
        y1p = ph;
    auto& pl = s.plane[pos];
    pl.resize((size_t)pw * ph);
    int16_t* dst = pl.data();
    const int y0p = s.rows_built[pos].load(std::memory_order_relaxed);
    if (y0p >= y1p)
        return;
    const int d = SP_EXT - SP_P;  // = 4: ext/h coords minus plane coords
    if (yf == 0) {
        sp_build_h_rows(s, ref, xf, y1p + 8);
        const int16_t* hp = s.hplane[xf].data();
        for (int y = y0p; y < y1p; y++)
            std::memcpy(dst + (int64_t)y * pw,
                        hp + (int64_t)(y + d) * ew + d,
                        pw * sizeof(int16_t));
    } else if (xf == 0) {
        sp_build_ext_rows(s, ref, y1p + 8);
        const int32_t* fv = en.luma_filt[yf];
        const int16_t* ext = s.ext.data();
        for (int y = y0p; y < y1p; y++) {
            // V taps read ext rows y+d-3 .. y+d+4 — always in range
            const int16_t* col0 = ext + (int64_t)(y + d - 3) * ew + d;
            int16_t* drow = dst + (int64_t)y * pw;
            for (int x = 0; x < pw; x++) {
                int acc = 0;
                for (int k = 0; k < 8; k++)
                    acc += fv[k] * col0[(int64_t)k * ew + x];
                drow[x] = (int16_t)(acc >> shift1);
            }
        }
    } else {
        sp_build_h_rows(s, ref, xf, y1p + 8);
        const int32_t* fv = en.luma_filt[yf];
        const int16_t* hp = s.hplane[xf].data();
        for (int y = y0p; y < y1p; y++) {
            const int16_t* col0 = hp + (int64_t)(y + d - 3) * ew + d;
            int16_t* drow = dst + (int64_t)y * pw;
            for (int x = 0; x < pw; x++) {
                int acc = 0;
                for (int k = 0; k < 8; k++)
                    acc += fv[k] * col0[(int64_t)k * ew + x];
                drow[x] = (int16_t)(acc >> 6);
            }
        }
    }
    s.rows_built[pos].store(y1p, std::memory_order_release);
}

// plane lookup: returns the padded plane for (lx, ref, xf, yf) with at
// least need_rows plane rows built (lazy, thread-safe: WPP row threads
// may race on first use), or nullptr when the cache doesn't cover this
// reference / the producer hasn't published enough rows yet (caller
// falls back to per-candidate mc_interp, bit-equal)
static inline const int16_t* sp_plane(int lx, int ref, int xf, int yf,
                                      int need_rows) {
    const int si = en.sp_of[lx][ref];
    if (si < 0)
        return nullptr;
    EN::SubpelSet& s = en.spsets[si];
    const int pos = xf + 4 * yf;
    const int ph = g_sp.pic_h + 2 * SP_P;
    if (need_rows > ph)
        need_rows = ph;
    if (s.rows_built[pos].load(std::memory_order_acquire) >= need_rows)
        return s.plane[pos].data();
    // build budget: complete refs build the whole plane at once; for an
    // in-flight ref, plane row y needs ref rows <= y - SP_P + 4, so the
    // published V final rows allow plane rows < V + SP_P - 4
    int budget = ph;
    if (s.src_prog) {
        const int64_t P =
            __atomic_load_n((const int64_t*)s.src_prog, __ATOMIC_ACQUIRE);
        const int V = (int)std::min<int64_t>(P << g_sp.ctb_log2,
                                             g_sp.pic_h);
        budget = V >= g_sp.pic_h ? ph : V + SP_P - 4;
        if (budget < need_rows)
            return nullptr;
    }
    std::lock_guard<std::mutex> lk(s.mtx);
    if (s.rows_built[pos].load(std::memory_order_relaxed) < need_rows)
        sp_build_plane_rows(s, en.refs[lx][ref][0], xf, yf, budget);
    return s.plane[pos].data();
}

// 14-bit luma MC for one motion (inter_search._mc14 luma part).
// Fractional positions are served from the subpel plane cache when the
// footprint fits its pad (bit-equal values); larger excursions and
// integer positions fall through to per-candidate mc_interp.
inline void mc14_luma(int lx, int ref, int mvx, int mvy, int x0, int y0,
                      int w, int h, int32_t* out) {
    const int xf = mvx & 3, yf = mvy & 3;
    const int xi = x0 + (mvx >> 2), yi = y0 + (mvy >> 2);
    if (xf | yf) {
        if (xi >= -SP_P && yi >= -SP_P && xi + w <= g_sp.pic_w + SP_P
            && yi + h <= g_sp.pic_h + SP_P) {
            const int16_t* pl = sp_plane(lx, ref, xf, yf, yi + h + SP_P);
            if (pl) {
                const int pw = g_sp.pic_w + 2 * SP_P;
                for (int y = 0; y < h; y++) {
                    const int16_t* row =
                        pl + (int64_t)(yi + y + SP_P) * pw + xi + SP_P;
                    int32_t* drow = out + (int64_t)y * w;
                    for (int x = 0; x < w; x++)
                        drow[x] = row[x];
                }
                return;
            }
        }
    }
    mc_interp(en.refs[lx][ref][0], g_sp.pic_w, g_sp.pic_h, xi, yi, xf, yf,
              w, h, g_sp.bit_depth_y, 8, en.luma_filt, 8, out);
}

inline void mc14_chroma(int lx, int ref, int c, int mvx, int mvy, int x0,
                        int y0, int w, int h, int32_t* out) {
    mc_interp(en.refs[lx][ref][c], cw_(), chh_(),
              (x0 >> 1) + (mvx >> 3), (y0 >> 1) + (mvy >> 3), mvx & 7,
              mvy & 7, w >> 1, h >> 1, g_sp.bit_depth_c, 4,
              (const int32_t(*)[8])en.chroma_filt, 4, out);
}

// finalize uni/bi 14-bit parts into clipped int32 samples
void finalize14(const int32_t* p0, const int32_t* p1, int w, int h, int bd,
                int32_t* out) {
    int max_v = (1 << bd) - 1;
    if (p0 && p1) {
        int shift = 14 - bd;
        int rnd = 1 << shift;
        for (int i = 0; i < w * h; i++)
            out[i] = clip3i(0, max_v, (p0[i] + p1[i] + rnd) >> (shift + 1));
    } else {
        const int32_t* p = p0 ? p0 : p1;
        int shift = 14 - bd;
        int rnd = 1 << (shift - 1);
        for (int i = 0; i < w * h; i++)
            out[i] = clip3i(0, max_v, (p[i] + rnd) >> shift);
    }
}

// luma-only finalized prediction for SATD ranking
// (inter_search._pred_luma_for_motion)
void pred_luma_for_motion(const int pf[2], const int mv[2][2],
                          const int ref[2], int x0, int y0, int w, int h,
                          int32_t* out) {
    LeafTimer pt(10);
    static thread_local int32_t p14[2][64 * 64];
    const int32_t* parts[2] = {nullptr, nullptr};
    for (int l = 0; l < 2; l++)
        if (pf[l]) {
            mc14_luma(l, ref[l], mv[l][0], mv[l][1], x0, y0, w, h, p14[l]);
            parts[l] = p14[l];
        }
    finalize14(parts[0], parts[1], w, h, g_sp.bit_depth_y, out);
}

// all-plane finalized prediction (inter_search._pred_for_motion)
void pred_full_for_motion(const int pf[2], const int mv[2][2],
                          const int ref[2], int x0, int y0, int w, int h,
                          int32_t* oy, int32_t* ocb, int32_t* ocr) {
    LeafTimer pt(9);
    static thread_local int32_t py[2][64 * 64], pcb[2][32 * 32],
        pcr[2][32 * 32];
    const int32_t *ay[2] = {nullptr, nullptr}, *ab[2] = {nullptr, nullptr},
                  *ar[2] = {nullptr, nullptr};
    for (int l = 0; l < 2; l++)
        if (pf[l]) {
            mc14_luma(l, ref[l], mv[l][0], mv[l][1], x0, y0, w, h, py[l]);
            mc14_chroma(l, ref[l], 1, mv[l][0], mv[l][1], x0, y0, w, h,
                        pcb[l]);
            mc14_chroma(l, ref[l], 2, mv[l][0], mv[l][1], x0, y0, w, h,
                        pcr[l]);
            ay[l] = py[l];
            ab[l] = pcb[l];
            ar[l] = pcr[l];
        }
    finalize14(ay[0], ay[1], w, h, g_sp.bit_depth_y, oy);
    finalize14(ab[0], ab[1], w >> 1, h >> 1, g_sp.bit_depth_c, ocb);
    finalize14(ar[0], ar[1], w >> 1, h >> 1, g_sp.bit_depth_c, ocr);
}

// full-pel pattern search (inter_search._full_pel_search); ties break on
// lexicographically smaller (ix, iy), mirroring Python's min over tuples
struct FpBest {
    double cost;
    int ix, iy;
};

inline bool fp_better(double c, int ix, int iy, const FpBest& b) {
    if (c != b.cost)
        return c < b.cost;
    if (ix != b.ix)
        return ix < b.ix;
    return iy < b.iy;
}

struct FpCache {
    // dense window |ix|,|iy| <= 128 (interleaved cost+stamp: one cache
    // line per probe) + overflow list for far probes; a dropped overflow
    // entry just means the identical cost is recomputed, so the search
    // result is unchanged
    static const int R = 128;
    struct Entry {
        double cost;
        uint32_t stamp;
        uint32_t pad;
    };
    Entry e[(2 * R + 1) * (2 * R + 1)];
    uint32_t epoch = 0;
    int n_ovf = 0;
    int ovf_xy[32][2];
    double ovf_c[32];

    void reset() {
        if (++epoch == 0) {  // epoch wrap: invalidate stale stamps
            std::memset(e, 0, sizeof(e));
            epoch = 1;
        }
        n_ovf = 0;
    }
    bool get(int ix, int iy, double* c) {
        if (ix >= -R && ix <= R && iy >= -R && iy <= R) {
            const Entry& en_ = e[(iy + R) * (2 * R + 1) + (ix + R)];
            if (en_.stamp == epoch) {
                *c = en_.cost;
                return true;
            }
            return false;
        }
        for (int i = 0; i < n_ovf; i++)
            if (ovf_xy[i][0] == ix && ovf_xy[i][1] == iy) {
                *c = ovf_c[i];
                return true;
            }
        return false;
    }
    void put(int ix, int iy, double c) {
        if (ix >= -R && ix <= R && iy >= -R && iy <= R) {
            Entry& en_ = e[(iy + R) * (2 * R + 1) + (ix + R)];
            en_.stamp = epoch;
            en_.cost = c;
        } else if (n_ovf < 32) {
            ovf_xy[n_ovf][0] = ix;
            ovf_xy[n_ovf][1] = iy;
            ovf_c[n_ovf++] = c;
        }
    }
};

// thread_local: concurrent WPP row threads each run their own ME; a shared
// cache would let one row's probe costs leak into another's search
thread_local FpCache fp_cache;

void full_pel_search(const int32_t* orig, int x0, int y0, int w, int h,
                     int lx, int ref, const int mvp[2],
                     const int (*seeds)[2], int n_seeds, int* out_ix,
                     int* out_iy) {
    PhaseTimer pt(4);
    PROF_COUNT(16, 1);
    const int16_t* plane = en.refs[lx][ref][0];
    const uint8_t* plane8 = en.ref8[lx][ref];
    fp_cache.reset();
    static thread_local int16_t orig16[64 * 64];
    static thread_local uint8_t orig8[64 * 64];
    if (plane8)
        for (int i = 0; i < w * h; i++)
            orig8[i] = (uint8_t)orig[i];
    else
        for (int i = 0; i < w * h; i++)
            orig16[i] = (int16_t)orig[i];
    // overlap-mode MV y-clamp (LimitFullPelMv's job, Search.hpp:1378-1394
    // with howCloseDoYouDare=15): probes may not reach below the rows the
    // reference picture is guaranteed to have finished. Row-granular
    // waits make the reference's x-clamp unnecessary. Static in the CTU
    // position -> deterministic at any thread count. Saturates off near
    // the picture bottom, where the wait guarantees the whole reference.
    int iy_max = INT32_MAX;
    if (en.ovl.clamp) {
        const int ctb = 1 << g_sp.ctb_log2;
        const int yctb = y0 & ~(ctb - 1);
        if ((yctb >> g_sp.ctb_log2) + 4 < ovl_hc())
            iy_max = yctb + 2 * ctb - 15 - y0 - h;
    }
    // dense-surface service: aligned multiple-of-16 PUs on ref 0 read
    // exact SADs out of the prepass surface when the probe lands within
    // every 16x16 child's +/-8 window around its seed. Identical
    // integers (the sweep's padded-plane reads equal the per-probe
    // clamped reads, and SAD is child-separable), so bitstreams are
    // unchanged — the ME candidate search is served by the batched
    // whole-picture stage (the device stage under TURING_TPU_DEVICE_ENC)
    // instead of per-probe host arithmetic.
    bool surf_ok = false;
    int sbx0 = 0, sby0 = 0, snbx = 0, snby = 0;
    if (ref == 0 && en.have_surf[lx] && !(w & 15) && !(h & 15)
        && !(x0 & 15) && !(y0 & 15)) {
        sbx0 = x0 >> 4;
        sby0 = y0 >> 4;
        snbx = w >> 4;
        snby = h >> 4;
        surf_ok = x0 + w <= (g_sp.pic_w & ~15)
               && y0 + h <= (g_sp.pic_h & ~15);
    }
    auto surf_sad = [&](int ix, int iy, int64_t* out_sad) -> bool {
        if (!surf_ok)
            return false;
        const int swb = en.seed_wb;
        const int32_t* sf = en.dense_surf[lx].data();
        const int16_t* sd = en.seed_mv[lx].data();
        int64_t acc = 0;
        for (int cy = 0; cy < snby; cy++)
            for (int cx = 0; cx < snbx; cx++) {
                const int64_t b = (int64_t)(sby0 + cy) * swb + sbx0 + cx;
                const int dx = ix - sd[b * 2] + DENSE_R;
                const int dy = iy - sd[b * 2 + 1] + DENSE_R;
                if ((unsigned)dx >= DENSE_W || (unsigned)dy >= DENSE_W) {
                    PROF_COUNT(23, 1);
                    return false;
                }
                acc += sf[b * DENSE_W * DENSE_W + dy * DENSE_W + dx];
            }
        PROF_COUNT(22, 1);
        *out_sad = acc;
        return true;
    };
    auto cost_at = [&](int ix, int iy) -> double {
        double c;
        if (!fp_cache.get(ix, iy, &c)) {
            if (iy > iy_max) {
                c = 1e30;  // outside the overlap reach bound
                fp_cache.put(ix, iy, c);
                return c;
            }
            PROF_COUNT(17, 1);
            int64_t sad;
            if (surf_sad(ix, iy, &sad)) {
            } else if (x0 + ix >= 0 && y0 + iy >= 0
                       && x0 + ix + w <= g_sp.pic_w
                       && y0 + iy + h <= g_sp.pic_h)
                sad = plane8
                    ? sad8_interior(orig8, w, h, plane8, g_sp.pic_w,
                                    x0 + ix, y0 + iy)
                    : sad16_interior(orig16, w, h, plane, g_sp.pic_w,
                                     x0 + ix, y0 + iy);
            else
                sad = sad_at(orig, w, h, plane, g_sp.pic_w, g_sp.pic_h,
                             x0 + ix, y0 + iy);
            c = (double)sad
              + cur.lam_me * mv_bits(4 * ix - mvp[0], 4 * iy - mvp[1]);
            fp_cache.put(ix, iy, c);
        }
        return c;
    };
    // seed 0: zero MV (further seeds — the predictor and the callers'
    // extra hints — are evaluated below, after the pattern helpers, so
    // MET probes can interleave with them exactly as in the reference)
    FpBest best{cost_at(0, 0), 0, 0};

    // HM-style star search (Search.hpp:2202-2301 fullPelMotionEstimation):
    // 16-point diamond scanned at doubling distances around a fixed center,
    // raster fallback when the best improvement came from far away, then
    // star refinement passes until converged.
    // the search window caps star DISTANCES around the (seed-chained)
    // center, like the reference (searchWindow only bounds one pass;
    // LimitFullPelMv clamps to picture/wavefront reach, not to an absolute
    // range) — probes themselves are bounded only by the dense cache radius
    const int sr = 128;
    // quarter-pel basis patterns; (entry*dist)>>2 is always an integer for
    // the (step, dist) pairs used
    static const int STAR16[16][2] = {
        {0, -4}, {1, -3}, {2, -2}, {3, -1}, {4, 0}, {3, 1}, {2, 2}, {1, 3},
        {0, 4}, {-1, 3}, {-2, 2}, {-3, 1}, {-4, 0}, {-3, -1}, {-2, -2},
        {-1, -3}};
    static const int SQUARE4[4][2] = {{-4, -4}, {-4, 4}, {4, 4}, {4, -4}};
    // batch-evaluate uncached interior points 4 at a time (multiref SAD);
    // per-point arithmetic is identical to cost_at, so costs are bit-equal
    auto eval_batch = [&](const int (*pts)[2], int npts) {
        int bx[32], by[32];
        int nb = 0;
        double c;
        for (int i = 0; i < npts; i++) {
            const int ix = pts[i][0], iy = pts[i][1];
            if (fp_cache.get(ix, iy, &c))
                continue;
            int64_t sad;
            if (iy <= iy_max && surf_sad(ix, iy, &sad)) {
                c = (double)sad + cur.lam_me * mv_bits(4 * ix - mvp[0],
                                                       4 * iy - mvp[1]);
                fp_cache.put(ix, iy, c);
                continue;
            }
            if (iy <= iy_max
                && x0 + ix >= 0 && y0 + iy >= 0
                && x0 + ix + w <= g_sp.pic_w
                && y0 + iy + h <= g_sp.pic_h) {
                bx[nb] = ix;
                by[nb] = iy;
                nb++;
            } else {
                cost_at(ix, iy);  // clamped path, cached inside
            }
        }
        for (int i = 0; i < nb; i += 4) {
            int px[4], py[4];
            for (int j = 0; j < 4; j++) {
                const int k = i + j < nb ? i + j : nb - 1;  // pad
                px[j] = x0 + bx[k];
                py[j] = y0 + by[k];
            }
            int64_t sads[4];
            PROF_COUNT(18, 4);
            if (plane8)
                sad8_interior_x4(orig8, w, h, plane8, g_sp.pic_w, px, py,
                                 sads);
            else
                sad16_interior_x4(orig16, w, h, plane, g_sp.pic_w, px, py,
                                  sads);
            for (int j = 0; j < 4 && i + j < nb; j++) {
                PROF_COUNT(20, 1);
                const int ix = bx[i + j], iy = by[i + j];
                fp_cache.put(ix, iy,
                             (double)sads[j]
                                 + cur.lam_me * mv_bits(4 * ix - mvp[0],
                                                        4 * iy - mvp[1]));
            }
        }
    };
    auto consider_pattern = [&](int cx, int cy, const int (*pat)[2],
                                int npat, int step, int dist) -> bool {
        int pts[16][2];
        int np_ = 0;
        for (int i = 0; i < npat; i += step) {
            int ix = cx + ((pat[i][0] * dist) >> 2);
            int iy = cy + ((pat[i][1] * dist) >> 2);
            if (std::abs(ix) > sr || std::abs(iy) > sr)
                continue;
            pts[np_][0] = ix;
            pts[np_][1] = iy;
            np_++;
        }
        eval_batch(pts, np_);
        FpBest pb{0.0, 0, 0};
        bool have = false;
        for (int i = 0; i < np_; i++) {
            double c = cost_at(pts[i][0], pts[i][1]);
            if (!have || fp_better(c, pts[i][0], pts[i][1], pb)) {
                pb = {c, pts[i][0], pts[i][1]};
                have = true;
            }
        }
        if (have && pb.cost < best.cost) {
            best = pb;
            return true;
        }
        return false;
    };
    // with a lowres pre-ME seed the star only needs to descend locally:
    // tight window, and the raster fallback (whose job the exhaustive
    // lowres sweep already did) is skipped
    const bool has_lr = en.have_seed[lx] && ref == 0;
    const int search_window = en.search_range >= 64 ? 64 : 32;
    const int max_counter = en.search_range >= 64 ? 3 : 2;
    const int raster_q = en.search_range >= 64 ? 240 : 120;
    // MET probe (ME early termination; Speed.h useMet fast/medium,
    // Search.hpp:2110-2124): a +/-1 cross around the current best, a
    // +/-2 hexagon too for 32+ blocks; false = no improvement found,
    // i.e. the current best is a local optimum
    auto met_probe = [&]() -> bool {
        static const int CROSS4Q[4][2] = {{0, -4}, {-4, 0}, {0, 4}, {4, 0}};
        bool improved = consider_pattern(best.ix, best.iy, CROSS4Q, 4, 1, 1);
        if (!improved && (w >= 32 || h >= 32)) {
            static const int HEX6Q[6][2] = {{0, -8}, {8, -4}, {8, 4},
                                            {0, 8},  {-8, 4}, {-8, -4}};
            improved = consider_pattern(best.ix, best.iy, HEX6Q, 6, 1, 1);
        }
        return improved;
    };
    // remaining seeds (the predictor, then the callers' hints: second MVP,
    // merge candidate MVs, previous 2Nx2N integer best), with the
    // reference's per-seed MET flow (Search.hpp:2104-2194): after any
    // seed that improves the running best — the zero MV always does —
    // probe around it; if the probe finds nothing better, stop the whole
    // search there
    bool met_stop = en.met && !met_probe();
    auto try_seed = [&](int sx, int sy) -> bool {  // true = MET stop
        if (sx == 0 && sy == 0)
            return false;
        double c = cost_at(sx, sy);
        if (fp_better(c, sx, sy, best)) {
            best = {c, sx, sy};
            if (en.met && !met_probe())
                return true;
        }
        return false;
    };
    if (!met_stop)
        met_stop = try_seed(mvp[0] >> 2, mvp[1] >> 2);
    for (int i = 0; i < n_seeds && !met_stop; i++)
        met_stop = try_seed(seeds[i][0] >> 2, seeds[i][1] >> 2);
    // dense full-res ME field winners for the cells under this PU —
    // evaluated as plain cost candidates, and only on non-MET presets
    // (slow): with MET's early stops the extra SAD-optimal candidates
    // measured -0.3..-0.9% BD at fast by bending the star's trajectory,
    // while at slow they are a pure candidate-set superset
    const bool has_dense = en.have_dense[lx] && ref == 0 && !en.met;
    if (has_dense && !met_stop) {
        const int16_t* dm = en.dense_mv[lx].data();
        const int wb = en.seed_wb, hb = en.seed_hb;
        auto dcell = [&](int px, int py) -> const int16_t* {
            int bx = px >> 4, by = py >> 4;
            bx = bx < 0 ? 0 : (bx >= wb ? wb - 1 : bx);
            by = by < 0 ? 0 : (by >= hb ? hb - 1 : by);
            return dm + ((int64_t)by * wb + bx) * 2;
        };
        auto deval = [&](int sx, int sy) {
            double c = cost_at(sx, sy);
            if (fp_better(c, sx, sy, best))
                best = {c, sx, sy};
        };
        const int16_t* s = dcell(x0 + w / 2, y0 + h / 2);
        deval(s[0], s[1]);
        if (w >= 32 || h >= 32)
            for (int q = 0; q < 4; q++) {
                const int16_t* sq = dcell(x0 + (q & 1 ? 3 * w / 4 : w / 4),
                                          y0 + (q & 2 ? 3 * h / 4 : h / 4));
                if (sq[0] != s[0] || sq[1] != s[1])
                    deval(sq[0], sq[1]);
            }
    }
    if (met_stop) {
        PROF_COUNT(19, 1);
        *out_ix = best.ix;
        *out_iy = best.iy;
        return;
    }
    {  // initial star around the seed winner (fixed center)
        const int cx = best.ix, cy = best.iy;
        int dist_best = 0, counter = 0, step = 4;
        for (int dist = 1; dist <= search_window && counter < max_counter;
             dist <<= 1) {
            if (dist == 2 || dist == 8)
                step >>= 1;
            if (consider_pattern(cx, cy, STAR16, 16, step, dist)) {
                dist_best = dist;
                counter = 0;
            } else {
                counter++;
            }
        }
        if (dist_best == 1) {
            dist_best = 0;
            consider_pattern(best.ix, best.iy, SQUARE4, 4, 1, 1);
        }
        if (dist_best > 5 && has_lr) {
            // the initial star's winner came from far out: instead of the
            // raster sweep below, consult the lowres pre-ME winners for
            // the cells under this PU — the exhaustive quarter-res sweep
            // already did the raster's wide-scan job for this picture
            LeafTimer pt15(15);
            const int16_t* sm = en.seed_mv[lx].data();
            const int wb = en.seed_wb, hb = en.seed_hb;
            auto cell = [&](int px, int py) -> const int16_t* {
                int bx = px >> 4, by = py >> 4;
                bx = bx < 0 ? 0 : (bx >= wb ? wb - 1 : bx);
                by = by < 0 ? 0 : (by >= hb ? hb - 1 : by);
                return sm + ((int64_t)by * wb + bx) * 2;
            };
            auto eval_seed = [&](int sx, int sy) {
                double c = cost_at(sx, sy);
                if (fp_better(c, sx, sy, best))
                    best = {c, sx, sy};
            };
            const int16_t* s = cell(x0 + w / 2, y0 + h / 2);
            eval_seed(s[0], s[1]);
            if (w >= 32 || h >= 32)
                for (int q = 0; q < 4; q++) {
                    const int16_t* sq =
                        cell(x0 + (q & 1 ? 3 * w / 4 : w / 4),
                             y0 + (q & 2 ? 3 * h / 4 : h / 4));
                    if (sq[0] != s[0] || sq[1] != s[1])
                        eval_seed(sq[0], sq[1]);
                }
            dist_best = 5;
        } else if (dist_best > 5) {
            LeafTimer pt15(15);
            // raster sweep on a 5-pel grid (quarter-pel +/-raster_q),
            // batched row by row through the multiref SAD
            FpBest rb{0.0, 0, 0};
            bool have = false;
            for (int qy = -raster_q; qy <= raster_q; qy += 20) {
                // raster_q 240 -> 25 points per row
                int pts[32][2];
                int np_ = 0;
                for (int qx = -raster_q; qx <= raster_q; qx += 20) {
                    int ix = qx >> 2, iy = qy >> 2;
                    if (std::abs(ix) > sr || std::abs(iy) > sr)
                        continue;
                    pts[np_][0] = ix;
                    pts[np_][1] = iy;
                    np_++;
                }
                eval_batch(pts, np_);
                for (int i = 0; i < np_; i++) {
                    double c = cost_at(pts[i][0], pts[i][1]);
                    if (!have || fp_better(c, pts[i][0], pts[i][1], rb)) {
                        rb = {c, pts[i][0], pts[i][1]};
                        have = true;
                    }
                }
            }
            if (have && rb.cost < best.cost)
                best = rb;
            dist_best = 5;
        }
        // star refinement until no distance improves
        while (dist_best > 0) {
            const int rx = best.ix, ry = best.iy;
            dist_best = 0;
            step = 4;
            for (int dist = 1; dist <= search_window; dist <<= 1) {
                if (dist == 2 || dist == 8)
                    step >>= 1;
                if (consider_pattern(rx, ry, STAR16, 16, step, dist))
                    dist_best = dist;
            }
            if (dist_best == 1) {
                consider_pattern(rx, ry, SQUARE4, 4, 1, 1);
                dist_best = 0;
            }
        }
    }
    if (en.search_range >= 64) {
        // final +/-1 cross descent (slow/medium; Search.hpp:2300-2335)
        static const int CROSS4[4][2] = {{0, -4}, {-4, 0}, {0, 4}, {4, 0}};
        while (consider_pattern(best.ix, best.iy, CROSS4, 4, 1, 1)) {
        }
    }
    *out_ix = best.ix;
    *out_iy = best.iy;
}

// Batched half-pel probe costs: the 8 step-2 probes around an
// integer-pel center share one horizontal xf=2 filter pass (the same
// acc>>shift1 arithmetic as mc_interp's H-only and 2D-tmp stages, so
// every probe's 14-bit prediction — and hence its SATD cost — is
// bit-equal to the per-probe mc14_luma path). Returns false when the
// union footprint touches a picture edge (caller falls back).
static bool half_probe_costs(const int32_t* orig, int x0, int y0, int w,
                             int h, int lx, int ref, int bxi, int byi,
                             const int mvp[2], const int (*dirs)[2],
                             int bs, double* out_costs) {
    const int bd = g_sp.bit_depth_y;
    const int shift1 = bd - 8;
    const int sh4 = 14 - bd;
    const int max_v = (1 << bd) - 1;
    const int rw = g_sp.pic_w, rh = g_sp.pic_h;
    const int ax = x0 + bxi, ay = y0 + byi;  // absolute integer position
    if (ax - 4 < 0 || ay - 4 < 0 || ax + w + 4 > rw || ay + h + 4 > rh)
        return false;
    const int16_t* refp = en.refs[lx][ref][0];
    const int32_t* fh = en.luma_filt[2];
    static thread_local int32_t h2buf[(64 + 8) * (64 + 1)];
    const int w2 = w + 1;
    for (int r = 0; r < h + 8; r++) {
        const int16_t* row = refp + (int64_t)(ay - 4 + r) * rw + (ax - 4);
        for (int j = 0; j < w2; j++) {
            int acc = 0;
            for (int k = 0; k < 8; k++)
                acc += fh[k] * row[j + k];
            h2buf[r * w2 + j] = acc >> shift1;
        }
    }
    static thread_local int32_t p14[64 * 64], pred[64 * 64];
    for (int d = 0; d < 8; d++) {
        const int dx = dirs[d][0], dy = dirs[d][1];
        if (dx == 0) {
            // V-only (xf=0): 8-tap on integer columns
            const int yi = ay + (dy < 0 ? -1 : 0);
            for (int y = 0; y < h; y++) {
                const int16_t* col0 =
                    refp + (int64_t)(yi + y - 3) * rw + ax;
                for (int x = 0; x < w; x++) {
                    int acc = 0;
                    for (int k = 0; k < 8; k++)
                        acc += fh[k] * col0[(int64_t)k * rw + x];
                    p14[y * w + x] = acc >> shift1;
                }
            }
        } else if (dy == 0) {
            // H-only: rows of the shared pass
            const int cx = dx < 0 ? 0 : 1;
            for (int y = 0; y < h; y++)
                std::memcpy(p14 + y * w, h2buf + (y + 4) * w2 + cx,
                            w * sizeof(int32_t));
        } else {
            // 2D: vertical 8-tap over the shared pass, >> 6
            const int cx = dx < 0 ? 0 : 1;
            const int r0 = dy < 0 ? 0 : 1;
            for (int y = 0; y < h; y++)
                for (int x = 0; x < w; x++) {
                    int acc = 0;
                    for (int k = 0; k < 8; k++)
                        acc += fh[k] * h2buf[(y + k + r0) * w2 + cx + x];
                    p14[y * w + x] = acc >> 6;
                }
        }
        for (int i = 0; i < w * h; i++)
            pred[i] = clip3i(0, max_v, (p14[i] + (1 << (sh4 - 1))) >> sh4);
        const int mvx = 4 * bxi + 2 * dx, mvy = 4 * byi + 2 * dy;
        out_costs[d] = (double)satd_region(orig, pred, w, h, bs)
                     + cur.lam_me * mv_bits(mvx - mvp[0], mvy - mvp[1]);
    }
    return true;
}

// half- then quarter-pel 8-neighbour SATD refinement
// (inter_search._sub_pel_refine)
void sub_pel_refine(const int32_t* orig, int x0, int y0, int w, int h,
                    int lx, int ref, int int_mv_x, int int_mv_y,
                    const int mvp[2], int* out_mvx, int* out_mvy) {
    PhaseTimer pt(5);
    const int bd = g_sp.bit_depth_y;
    const int sh4 = 14 - bd;
    const int max_v = (1 << bd) - 1;
    const int bs = (std::min(w, h) >= 8 && w % 8 == 0 && h % 8 == 0) ? 8 : 4;
    // tiny mv-keyed cache (1 start + up to 2*8 probes)
    int cache_mv[24][2];
    double cache_c[24];
    int n_cache = 0;
    auto cached = [&](int mvx, int mvy, double* c) {
        for (int i = 0; i < n_cache; i++)
            if (cache_mv[i][0] == mvx && cache_mv[i][1] == mvy) {
                *c = cache_c[i];
                return true;
            }
        return false;
    };
    auto raw_cost = [&](int mvx, int mvy) -> double {
        int32_t p14[64 * 64], pred[64 * 64];
        mc14_luma(lx, ref, mvx, mvy, x0, y0, w, h, p14);
        for (int i = 0; i < w * h; i++)
            pred[i] = clip3i(0, max_v, (p14[i] + (1 << (sh4 - 1))) >> sh4);
        int64_t satd = satd_region(orig, pred, w, h, bs);
        return (double)satd
             + cur.lam_me * mv_bits(mvx - mvp[0], mvy - mvp[1]);
    };
    static const int dirs[8][2] = {{1, 0}, {-1, 0}, {0, 1}, {0, -1},
                                   {1, 1}, {-1, -1}, {1, -1}, {-1, 1}};
    int bx = int_mv_x * 4, by = int_mv_y * 4;
    double bc = raw_cost(bx, by);
    cache_mv[0][0] = bx;
    cache_mv[0][1] = by;
    cache_c[0] = bc;
    n_cache = 1;
    int n_steps = en.rd_candidates >= 2 ? 2 : 1;
    const int steps[2] = {2, 1};
    for (int si = 0; si < n_steps; si++) {
        int step = steps[si];
        double pcs[8];
        int pmx[8], pmy[8];
        bool fresh[8];
        for (int d = 0; d < 8; d++) {
            pmx[d] = bx + dirs[d][0] * step;
            pmy[d] = by + dirs[d][1] * step;
            fresh[d] = !cached(pmx[d], pmy[d], &pcs[d]);
        }
        // half-pel pass around an integer center: shared-H batch (only
        // when the subpel plane cache doesn't already serve this ref —
        // plane-served probes are cheaper than the shared-H rebuild)
        bool batched = false;
        double bc8[8];
        if (step == 2 && (bx & 3) == 0 && (by & 3) == 0
            && en.sp_of[lx][ref] < 0)
            batched = half_probe_costs(orig, x0, y0, w, h, lx, ref,
                                       bx >> 2, by >> 2, mvp, dirs, bs,
                                       bc8);
        for (int d = 0; d < 8; d++)
            if (fresh[d])
                pcs[d] = batched ? bc8[d] : raw_cost(pmx[d], pmy[d]);
        // min over the 8 probes with (cost, (mvx, mvy)) tuple tie-break
        double pc = 0;
        int px = 0, py = 0;
        bool have = false;
        for (int d = 0; d < 8; d++) {
            if (fresh[d] && n_cache < 24) {
                cache_mv[n_cache][0] = pmx[d];
                cache_mv[n_cache][1] = pmy[d];
                cache_c[n_cache++] = pcs[d];
            }
            double c = pcs[d];
            int mvx = pmx[d], mvy = pmy[d];
            if (!have || c < pc
                || (c == pc && (mvx < px || (mvx == px && mvy < py)))) {
                pc = c;
                px = mvx;
                py = mvy;
                have = true;
            }
        }
        if (pc < bc) {
            bc = pc;
            bx = px;
            by = py;
        }
    }
    *out_mvx = bx;
    *out_mvy = by;
}

// one alternating pass of bi-prediction refinement: L1 then L0, the other
// list's 14-bit prediction held fixed (inter_search._bi_refine oracle)
void bi_refine(const int32_t* orig, int x0, int y0, int w, int h,
               int mv_bi[2][2], const int uni_mvps[2][2][2]) {
    const int bd = g_sp.bit_depth_y;
    const int shift = 14 - bd;
    const int maxv = (1 << bd) - 1;
    const int bs = (std::min(w, h) >= 8 && w % 8 == 0 && h % 8 == 0) ? 8 : 4;
    const int n_steps = en.rd_candidates >= 2 ? 2 : 1;
    const int steps[2] = {2, 1};
    static const int dirs[8][2] = {{1, 0}, {-1, 0}, {0, 1}, {0, -1},
                                   {1, 1}, {-1, -1}, {1, -1}, {-1, 1}};
    int32_t o14[64 * 64];
    for (int pass = 0; pass < 2; pass++) {
        const int lx = pass == 0 ? 1 : 0;
        const int other = 1 - lx;
        mc14_luma(other, 0, mv_bi[other][0], mv_bi[other][1], x0, y0, w, h,
                  o14);
        const int* mvp = uni_mvps[lx][0];
        int cache_mv[24][2];
        double cache_c[24];
        int n_cache = 0;
        auto cached = [&](int mvx, int mvy, double* c) {
            for (int i = 0; i < n_cache; i++)
                if (cache_mv[i][0] == mvx && cache_mv[i][1] == mvy) {
                    *c = cache_c[i];
                    return true;
                }
            return false;
        };
        auto raw_cost = [&](int mvx, int mvy) -> double {
            int32_t t14[64 * 64], pred[64 * 64];
            mc14_luma(lx, 0, mvx, mvy, x0, y0, w, h, t14);
            for (int i = 0; i < w * h; i++)
                pred[i] = clip3i(
                    0, maxv,
                    (t14[i] + (o14[i] + (1 << shift))) >> (shift + 1));
            return (double)satd_region(orig, pred, w, h, bs)
                 + cur.lam_me * mv_bits(mvx - mvp[0], mvy - mvp[1]);
        };
        int bx = mv_bi[lx][0], by = mv_bi[lx][1];
        double bc = raw_cost(bx, by);
        cache_mv[0][0] = bx;
        cache_mv[0][1] = by;
        cache_c[0] = bc;
        n_cache = 1;
        for (int si = 0; si < n_steps; si++) {
            int step = steps[si];
            double pc = 0;
            int px = 0, py = 0;
            bool have = false;
            for (int d = 0; d < 8; d++) {
                int mvx = bx + dirs[d][0] * step, mvy = by + dirs[d][1] * step;
                double c;
                if (!cached(mvx, mvy, &c)) {
                    c = raw_cost(mvx, mvy);
                    if (n_cache < 24) {
                        cache_mv[n_cache][0] = mvx;
                        cache_mv[n_cache][1] = mvy;
                        cache_c[n_cache++] = c;
                    }
                }
                if (!have || c < pc
                    || (c == pc && (mvx < px || (mvx == px && mvy < py)))) {
                    pc = c;
                    px = mvx;
                    py = mvy;
                    have = true;
                }
            }
            if (pc < bc) {
                bc = pc;
                bx = px;
                by = py;
            }
        }
        mv_bi[lx][0] = bx;
        mv_bi[lx][1] = by;
    }
}

// Overlap-mode merge/skip candidate gate: the wait rule only guarantees
// the refs' first min(ry+4, hc) CTU rows are final, so a merge candidate
// whose luma prediction (incl. the 8-tap's +3-row reach) would read
// beyond that is not trialed. The reference leaves merge unchecked and
// relies on the wait slack (TaskEncodeSubstream.cpp:71-93); checking
// makes the no-race guarantee unconditional. Static in (y0, ph, mv) ->
// deterministic at any thread count.
static inline bool ovl_cand_ok(const Cand& c, int y0, int ph) {
    if (!en.ovl.clamp)
        return true;
    const int ctb = 1 << g_sp.ctb_log2;
    const int ry = (y0 & ~(ctb - 1)) >> g_sp.ctb_log2;
    if (ry + 4 >= ovl_hc())
        return true;  // wait guarantees the whole reference
    const int limit = (ry + 4) * ctb - 16;
    if (c.pf0 && y0 + ph + ((c.mv01 + 3) >> 2) + 4 > limit)
        return false;
    if (c.pf1 && y0 + ph + ((c.mv11 + 3) >> 2) + 4 > limit)
        return false;
    return true;
}

// one PU's motion decision (inter_search._search_pu). Returns the choice.
struct PuChoice {
    int kind;          // 0 merge, 1 amvp
    int merge_idx;
    Cand cand;         // merge winner
    int amvp_mask;     // bit l: list l present
    int mv[2][2], mvd[2][2], mvp_fl[2];
};

void search_pu(int px, int py, int pw, int ph, const int cb_info[6],
               int part_idx, int part_mode, PuChoice* out) {
    static thread_local int32_t orig[64 * 64], pred[64 * 64];
    for (int y = 0; y < ph; y++)
        for (int x = 0; x < pw; x++)
            orig[y * pw + x] =
                en.orig[0][(int64_t)(py + y) * g_sp.pic_w + (px + x)];
    int bs = (std::min(pw, ph) >= 8 && pw % 8 == 0 && ph % 8 == 0) ? 8 : 4;
    Cand cands[5];
    int ncand = sp_merge_candidates(cb_info[0], cb_info[1], cb_info[2], px,
                                    py, pw, ph, part_idx, part_mode,
                                    g_sp.max_merge, cands);
    bool have = false;
    double best_cost = 0;
    PuChoice best{};
    Cand seen[5];
    int n_seen = 0;
    for (int mi = 0; mi < ncand; mi++) {
        const Cand& c = cands[mi];
        bool dup = false;
        for (int i = 0; i < n_seen; i++)
            if (seen[i].equal(c))
                dup = true;
        if (dup || !(c.pf0 || c.pf1))
            continue;
        seen[n_seen++] = c;
        if (!ovl_cand_ok(c, py, ph))
            continue;
        // dedup on the RAW candidate, but predict/commit the small-PU-
        // cleared motion: bi is forbidden for 8x4/4x8 PUs, L1 dropped
        // after selection (spec 8.5.3.2.1; decode/mvp.py:381 twin)
        Cand cc = c;
        if (pw + ph == 12 && cc.pf0 && cc.pf1) {
            cc.pf1 = 0;
            cc.r1 = -1;
            cc.mv10 = 0;
            cc.mv11 = 0;
        }
        int pf[2] = {cc.pf0, cc.pf1};
        int mv[2][2] = {{cc.mv00, cc.mv01}, {cc.mv10, cc.mv11}};
        int ref[2] = {cc.r0 < 0 ? 0 : cc.r0, cc.r1 < 0 ? 0 : cc.r1};
        pred_luma_for_motion(pf, mv, ref, px, py, pw, ph, pred);
        double cost = (double)satd_region(orig, pred, pw, ph, bs)
                    + cur.lam_me * (2 + mi);
        if (!have || cost < best_cost) {
            best_cost = cost;
            best.kind = 0;
            best.merge_idx = mi;
            best.cand = cc;
            have = true;
        }
    }
    int n_lists = (g_sp.is_b && g_sp.n_ref[1] > 0) ? 2 : 1;
    for (int lx = 0; lx < n_lists; lx++) {
        int mvps[2][2];
        sp_amvp(px, py, pw, ph, lx, 0, cb_info, mvps);
        int seeds[8][2];
        int ns = 0;
        seeds[ns][0] = mvps[1][0];
        seeds[ns][1] = mvps[1][1];
        ns++;
        for (int mi = 0; mi < ncand; mi++)
            if (cands[mi].pf(lx)) {
                seeds[ns][0] = cands[mi].mvx(lx);
                seeds[ns][1] = cands[mi].mvy(lx);
                ns++;
            }
        if (cur.prev_int_valid[lx]) {
            seeds[ns][0] = cur.prev_int_mv[lx][0];
            seeds[ns][1] = cur.prev_int_mv[lx][1];
            ns++;
        }
        int ix, iy;
        full_pel_search(orig, px, py, pw, ph, lx, 0, mvps[0], seeds, ns,
                        &ix, &iy);
        int mvx, mvy;
        sub_pel_refine(orig, px, py, pw, ph, lx, 0, ix, iy, mvps[0], &mvx,
                       &mvy);
        double bits0 = mv_bits(mvx - mvps[0][0], mvy - mvps[0][1]);
        double bits1 = mv_bits(mvx - mvps[1][0], mvy - mvps[1][1]);
        int mvp_flag = bits1 < bits0 ? 1 : 0;
        int mvd[2] = {mvx - mvps[mvp_flag][0], mvy - mvps[mvp_flag][1]};
        int pf[2] = {lx == 0 ? 1 : 0, lx == 0 ? 0 : 1};
        int mv[2][2] = {{mvx, mvy}, {mvx, mvy}};
        int ref[2] = {0, 0};
        pred_luma_for_motion(pf, mv, ref, px, py, pw, ph, pred);
        double cost = (double)satd_region(orig, pred, pw, ph, bs)
                    + cur.lam_me * (3 + std::min(bits0, bits1));
        if (!have || cost < best_cost) {
            best_cost = cost;
            best.kind = 1;
            best.amvp_mask = 1 << lx;
            best.mv[lx][0] = mvx;
            best.mv[lx][1] = mvy;
            best.mvd[lx][0] = mvd[0];
            best.mvd[lx][1] = mvd[1];
            best.mvp_fl[lx] = mvp_flag;
            have = true;
        }
    }
    *out = best;
}

// write one PU's motion into the plan (inter_search._commit_pu_motion)
void commit_pu_motion(int px, int py, int pw, int ph, const PuChoice& ch) {
    const int64_t plane4 = (int64_t)g_sp.h4 * g_sp.w4;
    if (ch.kind == 0) {
        fillq_wh(g_sp.merge_flag, px, py, pw, ph, (uint8_t)1);
        fillq_wh(g_sp.merge_idx, px, py, pw, ph, (uint8_t)ch.merge_idx);
        const Cand& c = ch.cand;
        for (int l = 0; l < 2; l++) {
            int pf = l ? c.pf1 : c.pf0;
            int r = l ? c.r1 : c.r0;
            int bx = px >> 2, by = py >> 2, nw = pw >> 2, nh = ph >> 2;
            for (int y = 0; y < nh; y++) {
                int64_t row = l * plane4 + (int64_t)(by + y) * g_sp.w4 + bx;
                for (int x = 0; x < nw; x++) {
                    if (pf) {
                        g_sp.ref_idx[row + x] = (int8_t)r;
                        g_sp.mv[(row + x) * 2] = (int16_t)c.mvx(l);
                        g_sp.mv[(row + x) * 2 + 1] = (int16_t)c.mvy(l);
                        g_sp.ref_poc[row + x] = g_sp.ref_pocs[l][r];
                    } else {
                        g_sp.ref_idx[row + x] = -1;
                        g_sp.mv[(row + x) * 2] = 0;
                        g_sp.mv[(row + x) * 2 + 1] = 0;
                    }
                }
            }
        }
    } else {
        fillq_wh(g_sp.merge_flag, px, py, pw, ph, (uint8_t)0);
        for (int l = 0; l < 2; l++) {
            int bx = px >> 2, by = py >> 2, nw = pw >> 2, nh = ph >> 2;
            bool on = (ch.amvp_mask >> l) & 1;
            for (int y = 0; y < nh; y++) {
                int64_t row = l * plane4 + (int64_t)(by + y) * g_sp.w4 + bx;
                for (int x = 0; x < nw; x++) {
                    if (on) {
                        g_sp.ref_idx[row + x] = 0;
                        g_sp.mv[(row + x) * 2] = (int16_t)ch.mv[l][0];
                        g_sp.mv[(row + x) * 2 + 1] = (int16_t)ch.mv[l][1];
                        g_sp.ref_poc[row + x] = g_sp.ref_pocs[l][0];
                        g_sp.mvd[(row + x) * 2] = (int16_t)ch.mvd[l][0];
                        g_sp.mvd[(row + x) * 2 + 1] = (int16_t)ch.mvd[l][1];
                        g_sp.mvp_flag[row + x] = (uint8_t)ch.mvp_fl[l];
                    } else {
                        g_sp.ref_idx[row + x] = -1;
                        g_sp.mv[(row + x) * 2] = 0;
                        g_sp.mv[(row + x) * 2 + 1] = 0;
                    }
                }
            }
        }
    }
}

// PU rectangles per part mode (ctu_write._pu_rects)
int pu_rects(int x0, int y0, int size, int part, int geo[4][4]) {
    int s = size, h = s >> 1, q = s >> 2;
    switch (part) {
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
    default:  // 7 = nRx2N
        geo[0][0] = x0; geo[0][1] = y0; geo[0][2] = s - q; geo[0][3] = s;
        geo[1][0] = x0 + s - q; geo[1][1] = y0; geo[1][2] = q; geo[1][3] = s;
        return 2;
    }
}

double encode_inter_smp(int x0, int y0, int log2, int depth, int part);
double encode_inter_cu(int x0, int y0, int log2, int depth);

// APS state: the 2Nx2N champion's per-quadrant |prediction residual|
// (Aps.h analyseResidueEnergy input; Reconstruct.cpp:1283)
thread_local int64_t g_aps_quad[4];
thread_local int g_aps_valid = 0;

// inter_search._encode_cu dispatch: inter vs intra, SMP/AMP trials,
// early-skip gating
double encode_cu_dispatch(int x0, int y0, int log2, int depth) {
    if (g_sp.is_i)
        return encode_intra_cu(x0, y0, log2, depth);
    int size = 1 << log2;
    Snap* state = snap_new();
    Snap* best_state = snap_new();
    snap_save(*state, x0, y0, size);
    double cost_best = encode_inter_cu(x0, y0, log2, depth);
    snap_save(*best_state, x0, y0, size);
    // an ESD skip champion ends the partition loop (the reference's esd
    // break exits all part modes)
    if (en.rd_candidates >= 2 && log2 >= 3
        && !(en.esd && g_sp.skip_flag[idx4(x0, y0)])) {
        // APS (Aps.h:45-85): gate 2NxN/Nx2N by the residue-energy
        // balance of the 2Nx2N champion's prediction quadrants
        bool do_2nxn = true, do_nx2n = true;
        if (en.aps && g_aps_valid) {
            const int half = size >> 1;
            const int64_t thr = (int64_t)4 * half * half * 2;
            int64_t num = g_aps_quad[0] + g_aps_quad[1];
            int64_t den = g_aps_quad[2] + g_aps_quad[3];
            if (num < thr && den < thr) {
                do_2nxn = false;
            } else {
                int64_t delta = den >> 2;
                do_2nxn = !(den - delta < num && num < den + delta);
            }
            num = g_aps_quad[0] + g_aps_quad[2];
            den = g_aps_quad[1] + g_aps_quad[3];
            if (num < thr && den < thr) {
                do_nx2n = false;
            } else {
                int64_t delta = den >> 2;
                do_nx2n = !(den - delta < num && num < den + delta);
            }
        }
        int parts[6];
        int n_parts = 0;
        parts[n_parts++] = 1;  // 2NxN
        parts[n_parts++] = 2;  // Nx2N
        if (g_sp.amp_enabled && en.rd_candidates >= 3 && log2 >= 4) {
            parts[n_parts++] = 4;
            parts[n_parts++] = 5;
            parts[n_parts++] = 6;
            parts[n_parts++] = 7;
        }
        for (int i = 0; i < n_parts; i++) {
            if (en.aps) {
                if (parts[i] == 1 && !do_2nxn)
                    continue;
                if (parts[i] == 2 && !do_nx2n)
                    continue;
            }
            snap_restore(*state, x0, y0, size);
            double c = encode_inter_smp(x0, y0, log2, depth, parts[i]);
            if (c < cost_best) {
                cost_best = c;
                snap_save(*best_state, x0, y0, size);
            }
        }
    }
    // early skip: best inter choice is a skip CU -> no intra trial
    snap_restore(*best_state, x0, y0, size);
    if (g_sp.skip_flag[idx4(x0, y0)]) {
        snap_free(state);
        snap_free(best_state);
        return cost_best;
    }
    // CFM (cbf fast mode; fast/medium presets): inter winner without coded
    // coefficients skips the intra trial
    if (en.rd_candidates <= 2 && !g_sp.cbf_y[idx4(x0, y0)]
        && !g_sp.cbf_cb[idx4(x0, y0)] && !g_sp.cbf_cr[idx4(x0, y0)]) {
        snap_free(state);
        snap_free(best_state);
        return cost_best;
    }
    static const bool no_ii = getenv("TC_NO_II") != nullptr;
    if (no_ii
        || (log2 > g_sp.max_tb_log2
            && (getenv("TC_NO_I64") || log2 != 6
                || en.rd_candidates < 3))) {
        // 64x64 intra (forced TU split) is trialed at slow only
        snap_free(state);
        snap_free(best_state);
        return cost_best;
    }
    snap_restore(*state, x0, y0, size);
    // the intra trial's cost includes its own cu_skip/pred_mode/part_mode
    // bins exactly (committed inside encode_intra_cu)
    double cost_intra = log2 > g_sp.max_tb_log2
        ? encode_intra_cu64(x0, y0, depth, cost_best)
        : encode_intra_cu(x0, y0, log2, depth, cost_best);
    if (cost_best <= cost_intra) {
        snap_restore(*best_state, x0, y0, size);
        snap_free(state);
        snap_free(best_state);
        return cost_best;
    }
    snap_free(state);
    snap_free(best_state);
    return cost_intra;
}

// inter_search._encode_inter_smp: two-PU SMP/AMP CU with the forced
// one-level transform split
double encode_inter_smp(int x0, int y0, int log2, int depth, int part) {
    PhaseTimer pt(1);
    const int size = 1 << log2;
    const int half = size >> 1;
    const int bd = g_sp.bit_depth_y, bd_c = g_sp.bit_depth_c;
    fillq(g_sp.ct_depth, x0, y0, size, (uint8_t)depth);
    fillq(g_sp.cu_pred_mode, x0, y0, size, (uint8_t)0);
    fillq(g_sp.part_mode, x0, y0, size, (uint8_t)part);
    fillq(g_sp.cu_size_log2, x0, y0, size, (uint8_t)log2);
    fillq(g_sp.cu_id, x0, y0, size, cur.ids[0]);
    fillq(g_sp.skip_flag, x0, y0, size, (uint8_t)0);
    cur.ids[0]++;

    int geo[4][4];
    int n_pu = pu_rects(x0, y0, size, part, geo);
    static thread_local int32_t pred_y[64 * 64], pred_cb[32 * 32],
        pred_cr[32 * 32];
    static thread_local int32_t ppy[64 * 64], ppcb[32 * 32], ppcr[32 * 32];
    PuChoice chs[4];
    const int64_t plane4 = (int64_t)g_sp.h4 * g_sp.w4;
    for (int pi = 0; pi < n_pu; pi++) {
        int px = geo[pi][0], py = geo[pi][1], pw = geo[pi][2],
            ph = geo[pi][3];
        fillq_wh(g_sp.pu_id, px, py, pw, ph, cur.ids[1]);
        cur.ids[1]++;
        int cb_info[6] = {x0, y0, size, pw, ph, pi};
        PuChoice& ch = chs[pi];
        search_pu(px, py, pw, ph, cb_info, pi, part, &ch);
        commit_pu_motion(px, py, pw, ph, ch);
        int64_t b = idx4(px, py);
        int pf[2], mv[2][2], ref[2];
        for (int l = 0; l < 2; l++) {
            int r = g_sp.ref_idx[l * plane4 + b];
            pf[l] = r >= 0;
            ref[l] = r < 0 ? 0 : r;
            mv[l][0] = g_sp.mv[(l * plane4 + b) * 2];
            mv[l][1] = g_sp.mv[(l * plane4 + b) * 2 + 1];
        }
        pred_full_for_motion(pf, mv, ref, px, py, pw, ph, ppy, ppcb, ppcr);
        for (int y = 0; y < ph; y++)
            std::memcpy(pred_y + (py - y0 + y) * size + (px - x0),
                        ppy + y * pw, pw * 4);
        int cph = ph >> 1, cpw = pw >> 1;
        int cy0 = (py - y0) >> 1, cx0 = (px - x0) >> 1;
        for (int y = 0; y < cph; y++) {
            std::memcpy(pred_cb + (cy0 + y) * half + cx0, ppcb + y * cpw,
                        cpw * 4);
            std::memcpy(pred_cr + (cy0 + y) * half + cx0, ppcr + y * cpw,
                        cpw * 4);
        }
    }

    // residual: forced TT split, four TUs at log2-1, chroma at log2-2;
    // levels collected for the exact whole-CU rate walk below
    const int cs = size >> 1, cx = x0 >> 1, cy = y0 >> 1;
    static thread_local int32_t oy_b[32 * 32], py_b[32 * 32], res[32 * 32],
        coeffs[32 * 32], rec_b[32 * 32];
    static thread_local int16_t levels[32 * 32];
    static thread_local int16_t lvy[64 * 64], lvcb[32 * 32], lvcr[32 * 32];
    std::memset(lvy, 0, size * size * 2);
    std::memset(lvcb, 0, cs * cs * 2);
    std::memset(lvcr, 0, cs * cs * 2);
    int nz_any = 0;
    double dist = 0.0;
    const int qh = half;
    static const int zoff[4][2] = {{0, 0}, {0, 1}, {1, 0}, {1, 1}};  // (dy,dx)
    for (int zi = 0; zi < 4; zi++) {
        int dy = zoff[zi][0] * qh, dx = zoff[zi][1] * qh;
        // luma TU
        for (int y = 0; y < qh; y++)
            for (int x = 0; x < qh; x++) {
                oy_b[y * qh + x] = en.orig[0][(int64_t)(y0 + dy + y)
                                              * g_sp.pic_w + (x0 + dx + x)];
                py_b[y * qh + x] = pred_y[(dy + y) * size + (dx + x)];
                res[y * qh + x] = oy_b[y * qh + x] - py_b[y * qh + x];
            }
        fwd_transform(res, qh, bd, 0, coeffs);
        int nz = en.rdoq
            ? rdoq_quantize(coeffs, cur.qp_full, bd, log2 - 1, 0, 0,
                            g_sp.off[E_CBF_LUMA], levels)
            : quantize(coeffs, qh, cur.qp_full, bd, log2 - 1, 0, levels);
        if (nz && g_sp.sdh_enabled)
            apply_sdh_c(levels, coeffs, cur.qp_full, bd, log2 - 1, 0);
        int max_v = (1 << bd) - 1;
        if (nz) {
            std::memcpy(rec_b, py_b, qh * qh * 4);
            dequant_idct_add(levels, qh, qh, log2 - 1, cur.qp_full, bd, 0,
                             rec_b);
            for (int i = 0; i < qh * qh; i++)
                rec_b[i] = clip3i(0, max_v, rec_b[i]);
            for (int y = 0; y < qh; y++)
                std::memcpy(lvy + (dy + y) * size + dx, levels + y * qh,
                            qh * 2);
            nz_any = 1;
        } else {
            std::memcpy(rec_b, py_b, qh * qh * 4);
        }
        scatter16(en.rec[0], g_sp.pic_w, x0 + dx, y0 + dy, qh, rec_b);
        scatter_lv(g_sp.coeff_y, g_sp.pic_w, x0 + dx, y0 + dy, qh, levels);
        fillq(g_sp.cbf_y, x0 + dx, y0 + dy, qh, (uint8_t)(nz ? 1 : 0));
        fillq(g_sp.tu_log2, x0 + dx, y0 + dy, qh, (uint8_t)(log2 - 1));
        fillq(g_sp.tu_id, x0 + dx, y0 + dy, qh, cur.ids[2]);
        cur.ids[2]++;
        dist += (double)ssd_i32(rec_b, oy_b, qh * qh);

        // chroma TUs at log2-2 (16x16+ CUs; 8x8 keeps one 4x4 pair)
        if (log2 == 3)
            continue;
        int chh2 = qh >> 1;
        int cdy = dy >> 1, cdx = dx >> 1;
        int max_c = (1 << bd_c) - 1;
        for (int ci = 0; ci < 2; ci++) {
            const int32_t* p_c = ci == 0 ? pred_cb : pred_cr;
            int16_t* rplane = en.rec[ci + 1];
            int16_t* coeff_pl = ci == 0 ? g_sp.coeff_cb : g_sp.coeff_cr;
            uint8_t* cbf_pl = ci == 0 ? g_sp.cbf_cb : g_sp.cbf_cr;
            int qp_c = ci == 0 ? cur.qp_cb_full : cur.qp_cr_full;
            for (int y = 0; y < chh2; y++)
                for (int x = 0; x < chh2; x++) {
                    oy_b[y * chh2 + x] =
                        en.orig[ci + 1][(int64_t)(cy + cdy + y) * cw_()
                                        + (cx + cdx + x)];
                    py_b[y * chh2 + x] = p_c[(cdy + y) * half + (cdx + x)];
                    res[y * chh2 + x] = oy_b[y * chh2 + x]
                                      - py_b[y * chh2 + x];
                }
            fwd_transform(res, chh2, bd_c, 0, coeffs);
            int nzc = en.rdoq
                ? rdoq_quantize(coeffs, qp_c, bd_c, log2 - 2, ci + 1, 0,
                                g_sp.off[E_CBF_CHROMA] + 1, levels)
                : quantize(coeffs, chh2, qp_c, bd_c, log2 - 2, 0, levels);
            if (nzc && g_sp.sdh_enabled)
                apply_sdh_c(levels, coeffs, qp_c, bd_c, log2 - 2, 0);
            if (nzc) {
                std::memcpy(rec_b, py_b, chh2 * chh2 * 4);
                dequant_idct_add(levels, chh2, chh2, log2 - 2, qp_c, bd_c, 0,
                                 rec_b);
                for (int i = 0; i < chh2 * chh2; i++)
                    rec_b[i] = clip3i(0, max_c, rec_b[i]);
                int16_t* lvc = ci == 0 ? lvcb : lvcr;
                for (int y = 0; y < chh2; y++)
                    std::memcpy(lvc + (cdy + y) * cs + cdx,
                                levels + y * chh2, chh2 * 2);
                nz_any = 1;
            } else {
                std::memcpy(rec_b, py_b, chh2 * chh2 * 4);
            }
            scatter16(rplane, cw_(), cx + cdx, cy + cdy, chh2, rec_b);
            scatter_lv(coeff_pl, cw_(), cx + cdx, cy + cdy, chh2, levels);
            fillq(cbf_pl, x0 + dx, y0 + dy, qh, (uint8_t)(nzc ? 1 : 0));
            dist += (double)ssd_i32(rec_b, oy_b, chh2 * chh2);
        }
    }

    if (log2 == 3) {
        // 8x8 SMP: one 4x4 chroma TB pair covering the CU (chroma_last)
        const int chs = 4;
        const int max_c = (1 << bd_c) - 1;
        for (int ci = 0; ci < 2; ci++) {
            const int32_t* p_c = ci == 0 ? pred_cb : pred_cr;
            int16_t* rplane = en.rec[ci + 1];
            int16_t* coeff_pl = ci == 0 ? g_sp.coeff_cb : g_sp.coeff_cr;
            uint8_t* cbf_pl = ci == 0 ? g_sp.cbf_cb : g_sp.cbf_cr;
            int16_t* lvc = ci == 0 ? lvcb : lvcr;
            int qp_c = ci == 0 ? cur.qp_cb_full : cur.qp_cr_full;
            for (int y = 0; y < chs; y++)
                for (int x = 0; x < chs; x++) {
                    oy_b[y * chs + x] =
                        en.orig[ci + 1][(int64_t)(cy + y) * cw_()
                                        + (cx + x)];
                    py_b[y * chs + x] = p_c[y * half + x];
                    res[y * chs + x] = oy_b[y * chs + x]
                                     - py_b[y * chs + x];
                }
            fwd_transform(res, chs, bd_c, 0, coeffs);
            int nzc = en.rdoq
                ? rdoq_quantize(coeffs, qp_c, bd_c, 2, ci + 1, 0,
                                g_sp.off[E_CBF_CHROMA], levels)
                : quantize(coeffs, chs, qp_c, bd_c, 2, 0, levels);
            if (nzc && g_sp.sdh_enabled)
                apply_sdh_c(levels, coeffs, qp_c, bd_c, 2, 0);
            if (nzc) {
                std::memcpy(rec_b, py_b, chs * chs * 4);
                dequant_idct_add(levels, chs, chs, 2, qp_c, bd_c, 0,
                                 rec_b);
                for (int i = 0; i < chs * chs; i++)
                    rec_b[i] = clip3i(0, max_c, rec_b[i]);
                std::memcpy(lvc, levels, chs * chs * 2);
                nz_any = 1;
            } else {
                std::memcpy(rec_b, py_b, chs * chs * 4);
            }
            scatter16(rplane, cw_(), cx, cy, chs, rec_b);
            scatter_lv(coeff_pl, cw_(), cx, cy, chs, levels);
            fillq(cbf_pl, x0, y0, size, (uint8_t)(nzc ? 1 : 0));
            dist += (double)ssd_i32(rec_b, oy_b, chs * chs);
        }
    }

    // exact writer bins of the whole CU, in order (the only candidate of
    // this part mode — committed immediately; inter_search twin)
    CandRate cr;
    cr.init();
    emit_cu_skip(cr, x0, y0, 0);
    cr.bin(E_PRED_MODE, 0, 0);
    emit_inter_part_mode(cr, part, log2);
    for (int pi = 0; pi < n_pu; pi++) {
        const PuChoice& ch = chs[pi];
        if (ch.kind == 0)
            emit_merge_pu(cr, ch.merge_idx);
        else
            emit_amvp_pu(cr, depth, geo[pi][2], geo[pi][3], ch.amvp_mask,
                         ch.mvd, ch.mvp_fl);
    }
    cr.bin(E_RQT_ROOT, 0, nz_any);
    if (nz_any) {
        if (log2 == 3)
            emit_tt_split8(cr, lvy, lvcb, lvcr);
        else
            emit_tt_split(cr, log2, lvy, lvcb, lvcr);
    }
    cr_commit(cr);
    return dist + cur.lam * ((double)cr.frac / 256.0);
}

// inter_search._encode_inter_cu: 2Nx2N merge/skip/AMVP decision
double encode_inter_cu(int x0, int y0, int log2, int depth) {
    PhaseTimer pt(0);
    g_aps_valid = 0;
    const int size = 1 << log2;
    const int cs = size >> 1, cx = x0 >> 1, cy = y0 >> 1;
    const int bd = g_sp.bit_depth_y, bd_c = g_sp.bit_depth_c;
    const int64_t plane4 = (int64_t)g_sp.h4 * g_sp.w4;
    static thread_local int32_t orig_y[64 * 64], orig_cb[32 * 32],
        orig_cr[32 * 32];
    gather32(en.orig[0], g_sp.pic_w, x0, y0, size, orig_y);
    gather32(en.orig[1], cw_(), cx, cy, cs, orig_cb);
    gather32(en.orig[2], cw_(), cx, cy, cs, orig_cr);

    fillq(g_sp.ct_depth, x0, y0, size, (uint8_t)depth);
    fillq(g_sp.cu_pred_mode, x0, y0, size, (uint8_t)0);
    fillq(g_sp.part_mode, x0, y0, size, (uint8_t)0);
    fillq(g_sp.cu_size_log2, x0, y0, size, (uint8_t)log2);
    fillq(g_sp.cu_id, x0, y0, size, cur.ids[0]);
    fillq(g_sp.pu_id, x0, y0, size, cur.ids[1]);
    cur.ids[0]++;
    cur.ids[1]++;

    Cand merge_cands[5];
    int n_merge = sp_merge_candidates(x0, y0, size, x0, y0, size, size, 0, 0,
                                      g_sp.max_merge, merge_cands);

    // stage 1: luma-only SATD ranking
    struct Scored {
        double sc;
        int kind;  // 0 merge, 1 amvp
        int idx;   // merge idx / lx (2 = bi)
        int amvp_mask;
        int mv[2][2], mvd[2][2], mvp_fl[2];
        int pf[2], ref[2];
        int motion_mv[2][2];
    };
    static thread_local Scored scored[16];
    int n_scored = 0;
    static thread_local int32_t pl[64 * 64];
    Cand seen[5];
    int n_seen = 0;
    for (int mi = 0; mi < n_merge; mi++) {
        const Cand& c = merge_cands[mi];
        bool dup = false;
        for (int i = 0; i < n_seen; i++)
            if (seen[i].equal(c))
                dup = true;
        if (dup)
            continue;
        seen[n_seen++] = c;
        if (!(c.pf0 || c.pf1))
            continue;
        if (!ovl_cand_ok(c, y0, size))
            continue;
        Scored& s = scored[n_scored];
        s.kind = 0;
        s.idx = mi;
        s.pf[0] = c.pf0;
        s.pf[1] = c.pf1;
        s.ref[0] = c.r0 < 0 ? 0 : c.r0;
        s.ref[1] = c.r1 < 0 ? 0 : c.r1;
        s.motion_mv[0][0] = c.mv00;
        s.motion_mv[0][1] = c.mv01;
        s.motion_mv[1][0] = c.mv10;
        s.motion_mv[1][1] = c.mv11;
        pred_luma_for_motion(s.pf, s.motion_mv, s.ref, x0, y0, size, size,
                             pl);
        s.sc = (double)satd_region(orig_y, pl, size, size, 8)
             + cur.lam_me * (2 + mi);
        n_scored++;
    }
    // ESD (early skip detection, Speed.h useEsd medium/fast;
    // searchInterCu's esd break, Search.hpp:1059): full residual trial of
    // the SATD-best merge candidate BEFORE motion estimation — when it
    // quantizes to all-zero, commit the skip CU outright and bypass
    // ME + stage 2 (inter_search Python twin)
    if (en.esd && n_scored > 0) {
        int e_best = 0;
        for (int i = 1; i < n_scored; i++)
            if (scored[i].sc < scored[e_best].sc)
                e_best = i;
        const Scored& s0 = scored[e_best];
        static thread_local int32_t e_py[64 * 64], e_pcb[32 * 32],
            e_pcr[32 * 32], e_res[64 * 64], e_cf[64 * 64];
        static thread_local int16_t e_lv[64 * 64];
        pred_full_for_motion(s0.pf, s0.motion_mv, s0.ref, x0, y0, size,
                             size, e_py, e_pcb, e_pcr);
        int e_nz = 0;
        if (log2 <= g_sp.max_tb_log2) {
            for (int i = 0; i < size * size; i++)
                e_res[i] = orig_y[i] - e_py[i];
            fwd_transform(e_res, size, bd, 0, e_cf);
            e_nz = en.rdoq
                ? rdoq_quantize(e_cf, cur.qp_full, bd, log2, 0, 0,
                                g_sp.off[E_RQT_ROOT], e_lv)
                : quantize(e_cf, size, cur.qp_full, bd, log2, 0, e_lv);
            if (!e_nz)
                for (int ci = 0; ci < 2 && !e_nz; ci++) {
                    const int32_t* o = ci == 0 ? orig_cb : orig_cr;
                    const int32_t* p = ci == 0 ? e_pcb : e_pcr;
                    int qp_c = ci == 0 ? cur.qp_cb_full : cur.qp_cr_full;
                    for (int i = 0; i < cs * cs; i++)
                        e_res[i] = o[i] - p[i];
                    fwd_transform(e_res, cs, bd_c, 0, e_cf);
                    e_nz = en.rdoq
                        ? rdoq_quantize(e_cf, qp_c, bd_c, log2 - 1, ci + 1,
                                        0, g_sp.off[E_CBF_CHROMA], e_lv)
                        : quantize(e_cf, cs, qp_c, bd_c, log2 - 1, 0,
                                   e_lv);
                }
        } else {
            // CU above the max TB (64x64): quadrant transforms with the
            // split-tree ctx indices (the forced-split stage-2 twin)
            const int qh = size >> 1, chq = size >> 2;
            static const int ezo[4][2] = {{0, 0}, {0, 1}, {1, 0}, {1, 1}};
            for (int zi = 0; zi < 4 && !e_nz; zi++) {
                const int dy = ezo[zi][0] * qh, dx = ezo[zi][1] * qh;
                for (int y = 0; y < qh; y++)
                    for (int x = 0; x < qh; x++)
                        e_res[y * qh + x] =
                            orig_y[(dy + y) * size + dx + x]
                            - e_py[(dy + y) * size + dx + x];
                fwd_transform(e_res, qh, bd, 0, e_cf);
                e_nz = en.rdoq
                    ? rdoq_quantize(e_cf, cur.qp_full, bd, log2 - 1, 0, 0,
                                    g_sp.off[E_CBF_LUMA], e_lv)
                    : quantize(e_cf, qh, cur.qp_full, bd, log2 - 1, 0,
                               e_lv);
                if (e_nz)
                    break;
                const int cdy = dy >> 1, cdx = dx >> 1;
                for (int ci = 0; ci < 2 && !e_nz; ci++) {
                    const int32_t* o = ci == 0 ? orig_cb : orig_cr;
                    const int32_t* p = ci == 0 ? e_pcb : e_pcr;
                    int qp_c = ci == 0 ? cur.qp_cb_full : cur.qp_cr_full;
                    for (int y = 0; y < chq; y++)
                        for (int x = 0; x < chq; x++)
                            e_res[y * chq + x] =
                                o[(cdy + y) * cs + cdx + x]
                                - p[(cdy + y) * cs + cdx + x];
                    fwd_transform(e_res, chq, bd_c, 0, e_cf);
                    e_nz = en.rdoq
                        ? rdoq_quantize(e_cf, qp_c, bd_c, log2 - 2, ci + 1,
                                        0, g_sp.off[E_CBF_CHROMA] + 1,
                                        e_lv)
                        : quantize(e_cf, chq, qp_c, bd_c, log2 - 2, 0,
                                   e_lv);
                }
            }
        }
        if (!e_nz) {
            double dist0 = (double)ssd_i32(e_py, orig_y, size * size)
                         + (double)ssd_i32(e_pcb, orig_cb, cs * cs)
                         + (double)ssd_i32(e_pcr, orig_cr, cs * cs);
            CandRate cr0;
            cr0.init();
            emit_skip_cu(cr0, x0, y0, s0.idx);
            cr_commit(cr0);
            double cost0 = dist0 + cur.lam * ((double)cr0.frac / 256.0);
            const Cand& c = merge_cands[s0.idx];
            fillq(g_sp.merge_flag, x0, y0, size, (uint8_t)1);
            fillq(g_sp.merge_idx, x0, y0, size, (uint8_t)s0.idx);
            fillq(g_sp.skip_flag, x0, y0, size, (uint8_t)1);
            for (int l = 0; l < 2; l++) {
                int pf = l ? c.pf1 : c.pf0;
                int r = l ? c.r1 : c.r0;
                int bx = x0 >> 2, by = y0 >> 2, nb = size >> 2;
                for (int y = 0; y < nb; y++) {
                    int64_t row = l * plane4 + (int64_t)(by + y) * g_sp.w4
                                + bx;
                    for (int x = 0; x < nb; x++) {
                        if (pf) {
                            g_sp.ref_idx[row + x] = (int8_t)r;
                            g_sp.mv[(row + x) * 2] = (int16_t)c.mvx(l);
                            g_sp.mv[(row + x) * 2 + 1] = (int16_t)c.mvy(l);
                            g_sp.ref_poc[row + x] = g_sp.ref_pocs[l][r];
                        } else {
                            g_sp.ref_idx[row + x] = -1;
                            g_sp.mv[(row + x) * 2] = 0;
                            g_sp.mv[(row + x) * 2 + 1] = 0;
                        }
                    }
                }
            }
            int tl0 = log2 < g_sp.max_tb_log2 ? log2 : g_sp.max_tb_log2;
            fillq(g_sp.tu_log2, x0, y0, size, (uint8_t)tl0);
            fillq(g_sp.tu_id, x0, y0, size, cur.ids[2]);
            cur.ids[2]++;
            std::memset(e_lv, 0, size * size * 2);
            scatter_lv(g_sp.coeff_y, g_sp.pic_w, x0, y0, size, e_lv);
            scatter_lv(g_sp.coeff_cb, cw_(), cx, cy, cs, e_lv);
            scatter_lv(g_sp.coeff_cr, cw_(), cx, cy, cs, e_lv);
            fillq(g_sp.cbf_y, x0, y0, size, (uint8_t)0);
            fillq(g_sp.cbf_cb, x0, y0, size, (uint8_t)0);
            fillq(g_sp.cbf_cr, x0, y0, size, (uint8_t)0);
            scatter16(en.rec[0], g_sp.pic_w, x0, y0, size, e_py);
            scatter16(en.rec[1], cw_(), cx, cy, cs, e_pcb);
            scatter16(en.rec[2], cw_(), cx, cy, cs, e_pcr);
            return cost0;
        }
    }

    // AMVP per list + bi
    int cb_info[6] = {x0, y0, size, size, size, 0};
    int n_lists = (g_sp.is_b && g_sp.n_ref[1] > 0) ? 2 : 1;
    int uni_mv[2][2], uni_mvd[2][2], uni_mvp[2];
    int uni_mvps[2][2][2];
    for (int lx = 0; lx < n_lists; lx++) {
        int mvps[2][2];
        sp_amvp(x0, y0, size, size, lx, 0, cb_info, mvps);
        std::memcpy(uni_mvps[lx], mvps, sizeof(mvps));
        int seeds[8][2];
        int ns = 0;
        seeds[ns][0] = mvps[1][0];
        seeds[ns][1] = mvps[1][1];
        ns++;
        for (int mi = 0; mi < n_merge; mi++)
            if (merge_cands[mi].pf(lx)) {
                seeds[ns][0] = merge_cands[mi].mvx(lx);
                seeds[ns][1] = merge_cands[mi].mvy(lx);
                ns++;
            }
        if (cur.prev_int_valid[lx]) {
            // previous 2Nx2N integer best (mvPreviousInteger2Nx2N seed)
            seeds[ns][0] = cur.prev_int_mv[lx][0];
            seeds[ns][1] = cur.prev_int_mv[lx][1];
            ns++;
        }
        int ix, iy;
        full_pel_search(orig_y, x0, y0, size, size, lx, 0, mvps[0], seeds,
                        ns, &ix, &iy);
        cur.prev_int_mv[lx][0] = 4 * ix;
        cur.prev_int_mv[lx][1] = 4 * iy;
        cur.prev_int_valid[lx] = 1;
        int mvx, mvy;
        sub_pel_refine(orig_y, x0, y0, size, size, lx, 0, ix, iy, mvps[0],
                       &mvx, &mvy);
        double bits0 = mv_bits(mvx - mvps[0][0], mvy - mvps[0][1]);
        double bits1 = mv_bits(mvx - mvps[1][0], mvy - mvps[1][1]);
        int mvp_flag = bits1 < bits0 ? 1 : 0;
        uni_mv[lx][0] = mvx;
        uni_mv[lx][1] = mvy;
        uni_mvd[lx][0] = mvx - mvps[mvp_flag][0];
        uni_mvd[lx][1] = mvy - mvps[mvp_flag][1];
        uni_mvp[lx] = mvp_flag;
        Scored& s = scored[n_scored];
        s.kind = 1;
        s.idx = lx;
        s.amvp_mask = 1 << lx;
        s.mv[lx][0] = mvx;
        s.mv[lx][1] = mvy;
        s.mvd[lx][0] = uni_mvd[lx][0];
        s.mvd[lx][1] = uni_mvd[lx][1];
        s.mvp_fl[lx] = mvp_flag;
        s.pf[0] = lx == 0 ? 1 : 0;
        s.pf[1] = lx == 0 ? 0 : 1;
        s.ref[0] = 0;
        s.ref[1] = 0;
        s.motion_mv[0][0] = mvx;
        s.motion_mv[0][1] = mvy;
        s.motion_mv[1][0] = mvx;
        s.motion_mv[1][1] = mvy;
        pred_luma_for_motion(s.pf, s.motion_mv, s.ref, x0, y0, size, size,
                             pl);
        s.sc = (double)satd_region(orig_y, pl, size, size, 8)
             + cur.lam_me * (3 + std::min(bits0, bits1));
        n_scored++;
    }
    if (n_lists == 2) {
        int mv_bi[2][2] = {{uni_mv[0][0], uni_mv[0][1]},
                           {uni_mv[1][0], uni_mv[1][1]}};
        bi_refine(orig_y, x0, y0, size, size, mv_bi, uni_mvps);
        Scored& s = scored[n_scored];
        s.kind = 1;
        s.idx = 2;
        s.amvp_mask = 3;
        for (int l = 0; l < 2; l++) {
            s.mv[l][0] = mv_bi[l][0];
            s.mv[l][1] = mv_bi[l][1];
            double b0 = mv_bits(mv_bi[l][0] - uni_mvps[l][0][0],
                                mv_bi[l][1] - uni_mvps[l][0][1]);
            double b1 = mv_bits(mv_bi[l][0] - uni_mvps[l][1][0],
                                mv_bi[l][1] - uni_mvps[l][1][1]);
            int fl = b1 < b0 ? 1 : 0;
            s.mvd[l][0] = mv_bi[l][0] - uni_mvps[l][fl][0];
            s.mvd[l][1] = mv_bi[l][1] - uni_mvps[l][fl][1];
            s.mvp_fl[l] = fl;
        }
        s.pf[0] = s.pf[1] = 1;
        s.ref[0] = s.ref[1] = 0;
        s.motion_mv[0][0] = mv_bi[0][0];
        s.motion_mv[0][1] = mv_bi[0][1];
        s.motion_mv[1][0] = mv_bi[1][0];
        s.motion_mv[1][1] = mv_bi[1][1];
        pred_luma_for_motion(s.pf, s.motion_mv, s.ref, x0, y0, size, size,
                             pl);
        s.sc = (double)satd_region(orig_y, pl, size, size, 8)
             + cur.lam_me * 6;
        n_scored++;
    }

    // stage 2: full RD for the top survivors
    static thread_local int order[16];
    for (int i = 0; i < n_scored; i++)
        order[i] = i;
    std::stable_sort(order, order + n_scored, [&](int a, int b) {
        return scored[a].sc < scored[b].sc;
    });
    int keep = en.rd_candidates > 2 ? en.rd_candidates : 2;
    // adaptive 3rd stage-2 candidate: RD it only when its SATD ranking
    // cost is close to the leader's (the reference RDs every PU mode;
    // measured -0.5% BD-rate at unchanged speed on caminandes fast LDP)
    if (en.rd_candidates <= 2 && n_scored > keep
        && scored[order[keep]].sc <= 1.15 * scored[order[0]].sc)
        keep++;
    if (keep > n_scored)
        keep = n_scored;

    static thread_local int32_t cpy[64 * 64], cpcb[32 * 32], cpcr[32 * 32];
    static thread_local int32_t res[64 * 64], coeffs[64 * 64];
    static thread_local int16_t lv_y[64 * 64], lv_cb[32 * 32],
        lv_cr[32 * 32];
    static thread_local int32_t rec_y[64 * 64], rec_cb[32 * 32],
        rec_cr[32 * 32];
    static thread_local int16_t b_lv_y[64 * 64], b_lv_cb[32 * 32],
        b_lv_cr[32 * 32];
    static thread_local int32_t b_rec_y[64 * 64], b_rec_cb[32 * 32],
        b_rec_cr[32 * 32];
    double best_cost = 0;
    int best_i = -1;
    int b_nz_y = 0, b_nz_cb = 0, b_nz_cr = 0, b_has = 0;
    CandRate best_cr;

    // One-level transform-split stage-2 + commit: forced for CUs above
    // the max TB (64x64), and the RQT trial for 16/32 CUs at slow
    // (inter_search._finish_inter_cu_split_tt oracle)
    auto stage2_split_tt = [&]() -> double {
        best_cost = 0;
        best_i = -1;
        b_nz_y = b_nz_cb = b_nz_cr = 0;
        b_has = 0;
        CandRate best_cr;
        const int qh = size >> 1;
        const int chh2 = qh >> 1;
        static thread_local int16_t qlv[32 * 32], qlv_c[16 * 16];
        static thread_local int32_t oy_b[32 * 32], pq_b[32 * 32],
            rq_b[32 * 32];
        static const int zoff[4][2] = {{0, 0}, {0, 1}, {1, 0}, {1, 1}};
        for (int k = 0; k < keep; k++) {
            const Scored& s = scored[order[k]];
            pred_full_for_motion(s.pf, s.motion_mv, s.ref, x0, y0, size,
                                 size, cpy, cpcb, cpcr);
            // FDM/FDAM: zero-residual champion -> zero-residual-only trial
            // (same rule as the single-TU stage-2 loop below)
            if (en.fdam && best_i >= 0 && !b_has) {
                double dist0 = (double)ssd_i32(cpy, orig_y, size * size)
                             + (double)ssd_i32(cpcb, orig_cb, cs * cs)
                             + (double)ssd_i32(cpcr, orig_cr, cs * cs);
                CandRate e0;
                cand_rate_2nx2n(e0, x0, y0, log2, depth, s.kind, s.idx,
                                s.amvp_mask, s.mvd, s.mvp_fl, nullptr, 0,
                                nullptr, 0, nullptr, 0, true);
                double cost0 = dist0 + cur.lam * ((double)e0.frac / 256.0);
                if (cost0 < best_cost) {
                    best_cost = cost0;
                    best_i = order[k];
                    b_nz_y = b_nz_cb = b_nz_cr = 0;
                    b_has = 0;
                    best_cr = e0;
                    std::memset(b_lv_y, 0, size * size * 2);
                    std::memset(b_lv_cb, 0, cs * cs * 2);
                    std::memset(b_lv_cr, 0, cs * cs * 2);
                    std::memcpy(b_rec_y, cpy, size * size * 4);
                    std::memcpy(b_rec_cb, cpcb, cs * cs * 4);
                    std::memcpy(b_rec_cr, cpcr, cs * cs * 4);
                }
                continue;
            }
            double dist = 0.0;
            int nz_y = 0, nz_cb = 0, nz_cr = 0;
            int max_v = (1 << bd) - 1, max_c = (1 << bd_c) - 1;
            for (int zi = 0; zi < 4; zi++) {
                int dy = zoff[zi][0] * qh, dx = zoff[zi][1] * qh;
                for (int y = 0; y < qh; y++)
                    for (int x = 0; x < qh; x++) {
                        oy_b[y * qh + x] = orig_y[(dy + y) * size + dx + x];
                        pq_b[y * qh + x] = cpy[(dy + y) * size + dx + x];
                        res[y * qh + x] = oy_b[y * qh + x]
                                        - pq_b[y * qh + x];
                    }
                fwd_transform(res, qh, bd, 0, coeffs);
                int nz = en.rdoq
                    ? rdoq_quantize(coeffs, cur.qp_full, bd, log2 - 1, 0, 0,
                                    g_sp.off[E_CBF_LUMA], qlv)
                    : quantize(coeffs, qh, cur.qp_full, bd, log2 - 1, 0,
                               qlv);
                if (nz && g_sp.sdh_enabled)
                    apply_sdh_c(qlv, coeffs, cur.qp_full, bd, log2 - 1, 0);
                if (nz) {
                    std::memcpy(rq_b, pq_b, qh * qh * 4);
                    dequant_idct_add(qlv, qh, qh, log2 - 1, cur.qp_full, bd,
                                     0, rq_b);
                    for (int i = 0; i < qh * qh; i++)
                        rq_b[i] = clip3i(0, max_v, rq_b[i]);
                } else {
                    std::memcpy(rq_b, pq_b, qh * qh * 4);
                }
                nz_y += nz;
                for (int y = 0; y < qh; y++) {
                    std::memcpy(lv_y + (dy + y) * size + dx, qlv + y * qh,
                                qh * 2);
                    std::memcpy(rec_y + (dy + y) * size + dx, rq_b + y * qh,
                                qh * 4);
                }
                dist += (double)ssd_i32(rq_b, oy_b, qh * qh);
                int cdy = dy >> 1, cdx = dx >> 1;
                for (int ci = 0; ci < 2; ci++) {
                    const int32_t* o_c = ci == 0 ? orig_cb : orig_cr;
                    const int32_t* p_c = ci == 0 ? cpcb : cpcr;
                    int16_t* lvp = ci == 0 ? lv_cb : lv_cr;
                    int32_t* recp = ci == 0 ? rec_cb : rec_cr;
                    int qp_c = ci == 0 ? cur.qp_cb_full : cur.qp_cr_full;
                    for (int y = 0; y < chh2; y++)
                        for (int x = 0; x < chh2; x++) {
                            oy_b[y * chh2 + x] =
                                o_c[(cdy + y) * cs + cdx + x];
                            pq_b[y * chh2 + x] =
                                p_c[(cdy + y) * cs + cdx + x];
                            res[y * chh2 + x] = oy_b[y * chh2 + x]
                                              - pq_b[y * chh2 + x];
                        }
                    fwd_transform(res, chh2, bd_c, 0, coeffs);
                    int nzc = en.rdoq
                        ? rdoq_quantize(coeffs, qp_c, bd_c, log2 - 2,
                                        ci + 1, 0,
                                        g_sp.off[E_CBF_CHROMA] + 1, qlv_c)
                        : quantize(coeffs, chh2, qp_c, bd_c, log2 - 2, 0,
                                   qlv_c);
                    if (nzc && g_sp.sdh_enabled)
                        apply_sdh_c(qlv_c, coeffs, qp_c, bd_c, log2 - 2, 0);
                    if (nzc) {
                        std::memcpy(rq_b, pq_b, chh2 * chh2 * 4);
                        dequant_idct_add(qlv_c, chh2, chh2, log2 - 2, qp_c,
                                         bd_c, 0, rq_b);
                        for (int i = 0; i < chh2 * chh2; i++)
                            rq_b[i] = clip3i(0, max_c, rq_b[i]);
                    } else {
                        std::memcpy(rq_b, pq_b, chh2 * chh2 * 4);
                    }
                    if (ci == 0)
                        nz_cb += nzc;
                    else
                        nz_cr += nzc;
                    for (int y = 0; y < chh2; y++) {
                        std::memcpy(lvp + (cdy + y) * cs + cdx,
                                    qlv_c + y * chh2, chh2 * 2);
                        std::memcpy(recp + (cdy + y) * cs + cdx,
                                    rq_b + y * chh2, chh2 * 4);
                    }
                    dist += (double)ssd_i32(rq_b, oy_b, chh2 * chh2);
                }
            }
            CandRate ce;
            cand_rate_2nx2n(ce, x0, y0, log2, depth, s.kind, s.idx,
                            s.amvp_mask, s.mvd, s.mvp_fl, lv_y, nz_y,
                            lv_cb, nz_cb, lv_cr, nz_cr, true);
            double cost = dist + cur.lam * ((double)ce.frac / 256.0);
            int has_coeff = (nz_y || nz_cb || nz_cr) ? 1 : 0;
            if (best_i < 0 || cost < best_cost) {
                best_cost = cost;
                best_i = order[k];
                b_nz_y = nz_y;
                b_nz_cb = nz_cb;
                b_nz_cr = nz_cr;
                b_has = has_coeff;
                best_cr = ce;
                std::memcpy(b_lv_y, lv_y, size * size * 2);
                std::memcpy(b_lv_cb, lv_cb, cs * cs * 2);
                std::memcpy(b_lv_cr, lv_cr, cs * cs * 2);
                std::memcpy(b_rec_y, rec_y, size * size * 4);
                std::memcpy(b_rec_cb, rec_cb, cs * cs * 4);
                std::memcpy(b_rec_cr, rec_cr, cs * cs * 4);
            }
            // zero-residual variant (skip / rqt_root_cbf=0 trial)
            if (has_coeff) {
                double dist0 = (double)ssd_i32(cpy, orig_y, size * size)
                             + (double)ssd_i32(cpcb, orig_cb, cs * cs)
                             + (double)ssd_i32(cpcr, orig_cr, cs * cs);
                CandRate e0;
                cand_rate_2nx2n(e0, x0, y0, log2, depth, s.kind, s.idx,
                                s.amvp_mask, s.mvd, s.mvp_fl, nullptr, 0,
                                nullptr, 0, nullptr, 0, true);
                double cost0 = dist0 + cur.lam * ((double)e0.frac / 256.0);
                if (cost0 < best_cost) {
                    best_cost = cost0;
                    best_i = order[k];
                    b_nz_y = b_nz_cb = b_nz_cr = 0;
                    b_has = 0;
                    best_cr = e0;
                    std::memset(b_lv_y, 0, size * size * 2);
                    std::memset(b_lv_cb, 0, cs * cs * 2);
                    std::memset(b_lv_cr, 0, cs * cs * 2);
                    std::memcpy(b_rec_y, cpy, size * size * 4);
                    std::memcpy(b_rec_cb, cpcb, cs * cs * 4);
                    std::memcpy(b_rec_cr, cpcr, cs * cs * 4);
                }
            }
        }
        cr_commit(best_cr);
        // commit motion (same as the single-TU path below)
        const Scored& s = scored[best_i];
        if (s.kind == 0) {
            const Cand& c = merge_cands[s.idx];
            fillq(g_sp.merge_flag, x0, y0, size, (uint8_t)1);
            fillq(g_sp.merge_idx, x0, y0, size, (uint8_t)s.idx);
            fillq(g_sp.skip_flag, x0, y0, size, (uint8_t)(b_has ? 0 : 1));
            for (int l = 0; l < 2; l++) {
                int pf = l ? c.pf1 : c.pf0;
                int r = l ? c.r1 : c.r0;
                int bx = x0 >> 2, by = y0 >> 2, nb = size >> 2;
                for (int y = 0; y < nb; y++) {
                    int64_t row = l * plane4 + (int64_t)(by + y) * g_sp.w4
                                + bx;
                    for (int x = 0; x < nb; x++) {
                        if (pf) {
                            g_sp.ref_idx[row + x] = (int8_t)r;
                            g_sp.mv[(row + x) * 2] = (int16_t)c.mvx(l);
                            g_sp.mv[(row + x) * 2 + 1] = (int16_t)c.mvy(l);
                            g_sp.ref_poc[row + x] = g_sp.ref_pocs[l][r];
                        } else {
                            g_sp.ref_idx[row + x] = -1;
                            g_sp.mv[(row + x) * 2] = 0;
                            g_sp.mv[(row + x) * 2 + 1] = 0;
                        }
                    }
                }
            }
        } else {
            fillq(g_sp.merge_flag, x0, y0, size, (uint8_t)0);
            fillq(g_sp.skip_flag, x0, y0, size, (uint8_t)0);
            for (int l = 0; l < 2; l++) {
                int bx = x0 >> 2, by = y0 >> 2, nb = size >> 2;
                bool on = (s.amvp_mask >> l) & 1;
                for (int y = 0; y < nb; y++) {
                    int64_t row = l * plane4 + (int64_t)(by + y) * g_sp.w4
                                + bx;
                    for (int x = 0; x < nb; x++) {
                        if (on) {
                            g_sp.ref_idx[row + x] = 0;
                            g_sp.mv[(row + x) * 2] = (int16_t)s.mv[l][0];
                            g_sp.mv[(row + x) * 2 + 1] =
                                (int16_t)s.mv[l][1];
                            g_sp.ref_poc[row + x] = g_sp.ref_pocs[l][0];
                            g_sp.mvd[(row + x) * 2] = (int16_t)s.mvd[l][0];
                            g_sp.mvd[(row + x) * 2 + 1] =
                                (int16_t)s.mvd[l][1];
                            g_sp.mvp_flag[row + x] = (uint8_t)s.mvp_fl[l];
                        } else {
                            g_sp.ref_idx[row + x] = -1;
                            g_sp.mv[(row + x) * 2] = 0;
                            g_sp.mv[(row + x) * 2 + 1] = 0;
                        }
                    }
                }
            }
        }
        fillq(g_sp.tu_log2, x0, y0, size, (uint8_t)(log2 - 1));
        // per-quadrant TU records + contexts in writer order (z-scan)
        for (int zi = 0; zi < 4; zi++) {
            int dy = zoff[zi][0] * qh, dx = zoff[zi][1] * qh;
            fillq(g_sp.tu_id, x0 + dx, y0 + dy, qh, cur.ids[2]);
            cur.ids[2]++;
            int nzq = 0, nzqb = 0, nzqr = 0;
            for (int y = 0; y < qh && !nzq; y++)
                for (int x = 0; x < qh; x++)
                    if (b_lv_y[(dy + y) * size + dx + x]) {
                        nzq = 1;
                        break;
                    }
            int cdy = dy >> 1, cdx = dx >> 1;
            for (int y = 0; y < chh2 && !nzqb; y++)
                for (int x = 0; x < chh2; x++)
                    if (b_lv_cb[(cdy + y) * cs + cdx + x]) {
                        nzqb = 1;
                        break;
                    }
            for (int y = 0; y < chh2 && !nzqr; y++)
                for (int x = 0; x < chh2; x++)
                    if (b_lv_cr[(cdy + y) * cs + cdx + x]) {
                        nzqr = 1;
                        break;
                    }
            fillq(g_sp.cbf_y, x0 + dx, y0 + dy, qh, (uint8_t)nzq);
            fillq(g_sp.cbf_cb, x0 + dx, y0 + dy, qh, (uint8_t)nzqb);
            fillq(g_sp.cbf_cr, x0 + dx, y0 + dy, qh, (uint8_t)nzqr);
        }
        scatter_lv(g_sp.coeff_y, g_sp.pic_w, x0, y0, size, b_lv_y);
        scatter_lv(g_sp.coeff_cb, cw_(), cx, cy, cs, b_lv_cb);
        scatter_lv(g_sp.coeff_cr, cw_(), cx, cy, cs, b_lv_cr);
        scatter16(en.rec[0], g_sp.pic_w, x0, y0, size, b_rec_y);
        scatter16(en.rec[1], cw_(), cx, cy, cs, b_rec_cb);
        scatter16(en.rec[2], cw_(), cx, cy, cs, b_rec_cr);
        return best_cost;
    };

    if (log2 > g_sp.max_tb_log2)
        return stage2_split_tt();

    // inter RQT (Speed.h useRqt; inter_search twin): snapshot before the
    // single-TU stage 2 so the split trial can re-run from the same state
    const bool do_rqt = en.rqt && log2 >= 4 && log2 <= g_sp.max_tb_log2;
    Snap* rqt_pre = nullptr;
    if (do_rqt) {
        rqt_pre = snap_new();
        snap_save(*rqt_pre, x0, y0, size);
    }

    for (int k = 0; k < keep; k++) {
        const Scored& s = scored[order[k]];
        pred_full_for_motion(s.pf, s.motion_mv, s.ref, x0, y0, size, size,
                             cpy, cpcb, cpcr);
        // FDM/FDAM (Speed.h useFdm/useFdam, Search.hpp:990,1008): once a
        // zero-residual champion exists, later candidates are evaluated
        // zero-residual only (no transform/quant trial)
        if (en.fdam && best_i >= 0 && !b_has) {
            double dist0 = (double)ssd_i32(cpy, orig_y, size * size)
                         + (double)ssd_i32(cpcb, orig_cb, cs * cs)
                         + (double)ssd_i32(cpcr, orig_cr, cs * cs);
            CandRate e0;
            cand_rate_2nx2n(e0, x0, y0, log2, depth, s.kind, s.idx,
                            s.amvp_mask, s.mvd, s.mvp_fl, nullptr, 0,
                            nullptr, 0, nullptr, 0, false);
            double cost0 = dist0 + cur.lam * ((double)e0.frac / 256.0);
            if (cost0 < best_cost) {
                best_cost = cost0;
                best_i = order[k];
                b_nz_y = b_nz_cb = b_nz_cr = 0;
                b_has = 0;
                best_cr = e0;
                std::memset(b_lv_y, 0, size * size * 2);
                std::memset(b_lv_cb, 0, cs * cs * 2);
                std::memset(b_lv_cr, 0, cs * cs * 2);
                std::memcpy(b_rec_y, cpy, size * size * 4);
                std::memcpy(b_rec_cb, cpcb, cs * cs * 4);
                std::memcpy(b_rec_cr, cpcr, cs * cs * 4);
            }
            continue;
        }
        // luma residual
        for (int i = 0; i < size * size; i++)
            res[i] = orig_y[i] - cpy[i];
        fwd_transform(res, size, bd, 0, coeffs);
        int nz_y = en.rdoq
            ? rdoq_quantize(coeffs, cur.qp_full, bd, log2, 0, 0,
                            g_sp.off[E_RQT_ROOT], lv_y)
            : quantize(coeffs, size, cur.qp_full, bd, log2, 0, lv_y);
        if (nz_y && g_sp.sdh_enabled)
            apply_sdh_c(lv_y, coeffs, cur.qp_full, bd, log2, 0);
        int max_v = (1 << bd) - 1;
        if (nz_y) {
            std::memcpy(rec_y, cpy, size * size * 4);
            dequant_idct_add(lv_y, size, size, log2, cur.qp_full, bd, 0,
                             rec_y);
            for (int i = 0; i < size * size; i++)
                rec_y[i] = clip3i(0, max_v, rec_y[i]);
        } else {
            std::memcpy(rec_y, cpy, size * size * 4);
        }
        // chroma residuals
        int max_c = (1 << bd_c) - 1;
        int nz_cb = 0, nz_cr = 0;
        for (int ci = 0; ci < 2; ci++) {
            const int32_t* o = ci == 0 ? orig_cb : orig_cr;
            const int32_t* p = ci == 0 ? cpcb : cpcr;
            int16_t* lv = ci == 0 ? lv_cb : lv_cr;
            int32_t* rc2 = ci == 0 ? rec_cb : rec_cr;
            int qp_c = ci == 0 ? cur.qp_cb_full : cur.qp_cr_full;
            for (int i = 0; i < cs * cs; i++)
                res[i] = o[i] - p[i];
            fwd_transform(res, cs, bd_c, 0, coeffs);
            int nzc = en.rdoq
                ? rdoq_quantize(coeffs, qp_c, bd_c, log2 - 1, ci + 1, 0,
                                g_sp.off[E_CBF_CHROMA], lv)
                : quantize(coeffs, cs, qp_c, bd_c, log2 - 1, 0, lv);
            if (nzc && g_sp.sdh_enabled)
                apply_sdh_c(lv, coeffs, qp_c, bd_c, log2 - 1, 0);
            if (nzc) {
                std::memcpy(rc2, p, cs * cs * 4);
                dequant_idct_add(lv, cs, cs, log2 - 1, qp_c, bd_c, 0, rc2);
                for (int i = 0; i < cs * cs; i++)
                    rc2[i] = clip3i(0, max_c, rc2[i]);
            } else {
                std::memcpy(rc2, p, cs * cs * 4);
            }
            if (ci == 0)
                nz_cb = nzc;
            else
                nz_cr = nzc;
        }
        double dist = (double)ssd_i32(rec_y, orig_y, size * size)
                    + (double)ssd_i32(rec_cb, orig_cb, cs * cs)
                    + (double)ssd_i32(rec_cr, orig_cr, cs * cs);
        CandRate ce;
        cand_rate_2nx2n(ce, x0, y0, log2, depth, s.kind, s.idx,
                        s.amvp_mask, s.mvd, s.mvp_fl, lv_y, nz_y, lv_cb,
                        nz_cb, lv_cr, nz_cr, false);
        double cost = dist + cur.lam * ((double)ce.frac / 256.0);
        int has_coeff = (nz_y || nz_cb || nz_cr) ? 1 : 0;
        if (best_i < 0 || cost < best_cost) {
            best_cost = cost;
            best_i = order[k];
            b_nz_y = nz_y;
            b_nz_cb = nz_cb;
            b_nz_cr = nz_cr;
            b_has = has_coeff;
            best_cr = ce;
            std::memcpy(b_lv_y, lv_y, size * size * 2);
            std::memcpy(b_lv_cb, lv_cb, cs * cs * 2);
            std::memcpy(b_lv_cr, lv_cr, cs * cs * 2);
            std::memcpy(b_rec_y, rec_y, size * size * 4);
            std::memcpy(b_rec_cb, rec_cb, cs * cs * 4);
            std::memcpy(b_rec_cr, rec_cr, cs * cs * 4);
        }
        // zero-residual variant (skip / rqt_root_cbf=0 trial,
        // inter_search._encode_inter_cu oracle)
        if (has_coeff) {
            double dist0 = (double)ssd_i32(cpy, orig_y, size * size)
                         + (double)ssd_i32(cpcb, orig_cb, cs * cs)
                         + (double)ssd_i32(cpcr, orig_cr, cs * cs);
            CandRate e0;
            cand_rate_2nx2n(e0, x0, y0, log2, depth, s.kind, s.idx,
                            s.amvp_mask, s.mvd, s.mvp_fl, nullptr, 0,
                            nullptr, 0, nullptr, 0, false);
            double cost0 = dist0 + cur.lam * ((double)e0.frac / 256.0);
            if (cost0 < best_cost) {
                best_cost = cost0;
                best_i = order[k];
                b_nz_y = b_nz_cb = b_nz_cr = 0;
                b_has = 0;
                best_cr = e0;
                std::memset(b_lv_y, 0, size * size * 2);
                std::memset(b_lv_cb, 0, cs * cs * 2);
                std::memset(b_lv_cr, 0, cs * cs * 2);
                std::memcpy(b_rec_y, cpy, size * size * 4);
                std::memcpy(b_rec_cb, cpcb, cs * cs * 4);
                std::memcpy(b_rec_cr, cpcr, cs * cs * 4);
            }
        }
    }

    // APS: champion's prediction residual per quadrant (Python twin
    // recomputes from the winning candidate's pred — identical values)
    if (en.aps && log2 >= 4 && en.rd_candidates >= 2) {
        const Scored& sw = scored[best_i];
        pred_full_for_motion(sw.pf, sw.motion_mv, sw.ref, x0, y0, size,
                             size, cpy, cpcb, cpcr);
        const int qh2 = size >> 1;
        int64_t q[4] = {0, 0, 0, 0};
        for (int y = 0; y < size; y++)
            for (int x = 0; x < size; x++) {
                int d = orig_y[y * size + x] - cpy[y * size + x];
                q[((y >= qh2) << 1) | (x >= qh2)] += d < 0 ? -d : d;
            }
        for (int i2 = 0; i2 < 4; i2++)
            g_aps_quad[i2] = q[i2];
        g_aps_valid = 1;
    }

    // commit
    const Scored& s = scored[best_i];
    if (s.kind == 0) {
        const Cand& c = merge_cands[s.idx];
        fillq(g_sp.merge_flag, x0, y0, size, (uint8_t)1);
        fillq(g_sp.merge_idx, x0, y0, size, (uint8_t)s.idx);
        fillq(g_sp.skip_flag, x0, y0, size, (uint8_t)(b_has ? 0 : 1));
        for (int l = 0; l < 2; l++) {
            int pf = l ? c.pf1 : c.pf0;
            int r = l ? c.r1 : c.r0;
            int bx = x0 >> 2, by = y0 >> 2, nb = size >> 2;
            for (int y = 0; y < nb; y++) {
                int64_t row = l * plane4 + (int64_t)(by + y) * g_sp.w4 + bx;
                for (int x = 0; x < nb; x++) {
                    if (pf) {
                        g_sp.ref_idx[row + x] = (int8_t)r;
                        g_sp.mv[(row + x) * 2] = (int16_t)c.mvx(l);
                        g_sp.mv[(row + x) * 2 + 1] = (int16_t)c.mvy(l);
                        g_sp.ref_poc[row + x] = g_sp.ref_pocs[l][r];
                    } else {
                        g_sp.ref_idx[row + x] = -1;
                        g_sp.mv[(row + x) * 2] = 0;
                        g_sp.mv[(row + x) * 2 + 1] = 0;
                    }
                }
            }
        }
    } else {
        fillq(g_sp.merge_flag, x0, y0, size, (uint8_t)0);
        fillq(g_sp.skip_flag, x0, y0, size, (uint8_t)0);
        for (int l = 0; l < 2; l++) {
            int bx = x0 >> 2, by = y0 >> 2, nb = size >> 2;
            bool on = (s.amvp_mask >> l) & 1;
            for (int y = 0; y < nb; y++) {
                int64_t row = l * plane4 + (int64_t)(by + y) * g_sp.w4 + bx;
                for (int x = 0; x < nb; x++) {
                    if (on) {
                        g_sp.ref_idx[row + x] = 0;
                        g_sp.mv[(row + x) * 2] = (int16_t)s.mv[l][0];
                        g_sp.mv[(row + x) * 2 + 1] = (int16_t)s.mv[l][1];
                        g_sp.ref_poc[row + x] = g_sp.ref_pocs[l][0];
                        g_sp.mvd[(row + x) * 2] = (int16_t)s.mvd[l][0];
                        g_sp.mvd[(row + x) * 2 + 1] = (int16_t)s.mvd[l][1];
                        g_sp.mvp_flag[row + x] = (uint8_t)s.mvp_fl[l];
                    } else {
                        g_sp.ref_idx[row + x] = -1;
                        g_sp.mv[(row + x) * 2] = 0;
                        g_sp.mv[(row + x) * 2 + 1] = 0;
                    }
                }
            }
        }
    }
    int tl = log2 < g_sp.max_tb_log2 ? log2 : g_sp.max_tb_log2;
    fillq(g_sp.tu_log2, x0, y0, size, (uint8_t)tl);
    fillq(g_sp.tu_id, x0, y0, size, cur.ids[2]);
    cur.ids[2]++;
    cr_commit(best_cr);
    scatter_lv(g_sp.coeff_y, g_sp.pic_w, x0, y0, size, b_lv_y);
    scatter_lv(g_sp.coeff_cb, cw_(), cx, cy, cs, b_lv_cb);
    scatter_lv(g_sp.coeff_cr, cw_(), cx, cy, cs, b_lv_cr);
    fillq(g_sp.cbf_y, x0, y0, size, (uint8_t)(b_nz_y ? 1 : 0));
    fillq(g_sp.cbf_cb, x0, y0, size, (uint8_t)(b_nz_cb ? 1 : 0));
    fillq(g_sp.cbf_cr, x0, y0, size, (uint8_t)(b_nz_cr ? 1 : 0));
    scatter16(en.rec[0], g_sp.pic_w, x0, y0, size, b_rec_y);
    scatter16(en.rec[1], cw_(), cx, cy, cs, b_rec_cb);
    scatter16(en.rec[2], cw_(), cx, cy, cs, b_rec_cr);
    if (do_rqt && b_has) {
        // split can't beat a zero-residual winner (it only adds rate)
        const double cost_single = best_cost;
        Snap* ssingle = snap_new();
        snap_save(*ssingle, x0, y0, size);
        snap_restore(*rqt_pre, x0, y0, size);
        const double cost_split = stage2_split_tt();
        if (cost_single <= cost_split) {
            snap_restore(*ssingle, x0, y0, size);
            snap_free(ssingle);
            snap_free(rqt_pre);
            return cost_single;
        }
        snap_free(ssingle);
        snap_free(rqt_pre);
        return cost_split;
    }
    if (rqt_pre)
        snap_free(rqt_pre);
    return best_cost;
}

// ---------------------------------------------------------------- quadtree
// RCU-depth status for the current CTU (intra_search._rcu_status twin;
// reference Search.hpp:721-790). Out-of-picture neighbours read as depth 0.
thread_local int g_rcu_status = 0;

inline int rcu_ctdepth_at(int px, int py) {
    if (px < 0 || py < 0)
        return 0;
    int bx = px >> 2, by = py >> 2;
    if (bx > g_sp.w4 - 1)
        bx = g_sp.w4 - 1;
    if (by > g_sp.h4 - 1)
        by = g_sp.h4 - 1;
    return g_sp.ct_depth[(int64_t)by * g_sp.w4 + bx];
}

// intra_search._decide_cqt: recursive split RDO with snapshot/restore
double decide_cqt(int x0, int y0, int log2, int depth) {
    const int w = g_sp.pic_w, h = g_sp.pic_h;
    const int size = 1 << log2;
    if (depth == 0) {
        g_rcu_status = 0;
        if (en.rcudepth && !g_sp.is_i && (x0 || y0)) {
            if (x0 && y0) {
                int stepx = x0 + size <= w ? 32 : 16;
                int stepy = y0 + size <= h ? 32 : 16;
                int ds = rcu_ctdepth_at(x0, y0 - 1)
                       + rcu_ctdepth_at(x0 + stepx, y0 - 1)
                       + rcu_ctdepth_at(x0 - 1, y0)
                       + rcu_ctdepth_at(x0 - 1, y0 + stepy)
                       + rcu_ctdepth_at(x0 - 1, y0 - 1);
                g_rcu_status = ds < 6 ? 1 : (ds < 14 ? 2 : 3);
            } else if (x0) {
                int stepx = x0 + size <= w ? 32 : 16;
                int ds = rcu_ctdepth_at(x0, y0 - 1)
                       + rcu_ctdepth_at(x0 + stepx, y0 - 1);
                g_rcu_status = ds < 4 ? 1 : 2;
            } else {
                int stepy = y0 + size <= h ? 32 : 16;
                int ds = rcu_ctdepth_at(x0 - 1, y0)
                       + rcu_ctdepth_at(x0 - 1, y0 + stepy);
                g_rcu_status = ds < 4 ? 1 : 2;
            }
        }
    }
    bool in_pic = x0 + size <= w && y0 + size <= h;
    if (!in_pic) {
        if (x0 >= w || y0 >= h)
            return 0.0;
        double cost = 0.0;
        int half = size >> 1;
        static const int q[4][2] = {{0, 0}, {1, 0}, {0, 1}, {1, 1}};
        for (int i = 0; i < 4; i++) {
            int dx = q[i][0] * half, dy = q[i][1] * half;
            if (x0 + dx < w && y0 + dy < h)
                cost += decide_cqt(x0 + dx, y0 + dy, log2 - 1, depth + 1);
        }
        return cost;
    }
    if (en.aq_depth >= 0)
        aq_set_cu_qp(x0, y0, depth);
    int cu_limit = g_sp.is_i ? en.max_cu_log2 : en.max_cu_inter;
    if (log2 > cu_limit) {
        // 64x64 intra CU trial at slow (forced TU split,
        // Search.hpp:374): compare the whole-CTB intra CU with the split
        // dynamic getenv: tests toggle TC_NO_I64 in-process
        if (!getenv("TC_NO_I64") && log2 == 6 && g_sp.is_i
            && en.rd_candidates >= 3) {
            Snap* state = snap_new();
            snap_save(*state, x0, y0, size);
            const double f0 = commit_split_flag(x0, y0, log2, depth, 0);
            const double cost_here = encode_intra_cu64(x0, y0, depth) + f0;
            Snap* here = snap_new();
            snap_save(*here, x0, y0, size);
            snap_restore(*state, x0, y0, size);
            snap_free(state);
            double cost_split = commit_split_flag(x0, y0, log2, depth, 1);
            int half = size >> 1;
            static const int q6[4][2] = {{0, 0}, {1, 0}, {0, 1}, {1, 1}};
            for (int i = 0; i < 4; i++)
                cost_split += decide_cqt(x0 + q6[i][0] * half,
                                         y0 + q6[i][1] * half, log2 - 1,
                                         depth + 1);
            if (cost_here <= cost_split) {
                snap_restore(*here, x0, y0, size);
                snap_free(here);
                return cost_here;
            }
            snap_free(here);
            return cost_split;
        }
        double cost = commit_split_flag(x0, y0, log2, depth, 1);
        int half = size >> 1;
        static const int q[4][2] = {{0, 0}, {1, 0}, {0, 1}, {1, 1}};
        for (int i = 0; i < 4; i++)
            cost += decide_cqt(x0 + q[i][0] * half, y0 + q[i][1] * half,
                               log2 - 1, depth + 1);
        return cost;
    }

    // RCU-depth gates (Search.hpp:798-806): status 2/3 skips the 64x64
    // full-CU trial, status 3 also skips 32x32
    const int rcu_st = g_rcu_status;
    if (rcu_st && ((depth == 0 && rcu_st >= 2)
                   || (depth == 1 && rcu_st == 3))) {
        int half_r = size >> 1;
        double cost_split = commit_split_flag(x0, y0, log2, depth, 1);
        static const int qr[4][2] = {{0, 0}, {1, 0}, {0, 1}, {1, 1}};
        for (int i = 0; i < 4; i++)
            cost_split += decide_cqt(x0 + qr[i][0] * half_r,
                                     y0 + qr[i][1] * half_r, log2 - 1,
                                     depth + 1);
        return cost_split;
    }

    // candidate: no-split at this size (split_cu_flag=0 committed first —
    // writer bin order is top-down)
    Snap* state = snap_new();
    snap_save(*state, x0, y0, size);
    const double flag0 = commit_split_flag(x0, y0, log2, depth, 0);
    double cost_here = encode_cu_dispatch(x0, y0, log2, depth) + flag0;
    if (log2 == g_sp.min_cb_log2) {
        // no split flag exists at the min CB size
        if (g_sp.is_i || g_sp.cu_pred_mode[idx4(x0, y0)] == 1) {
            Snap* here = snap_new();
            snap_save(*here, x0, y0, size);
            snap_restore(*state, x0, y0, size);
            double cost_nxn = encode_intra_nxn(x0, y0, log2, depth,
                                               cost_here);
            if (cost_nxn < cost_here) {
                snap_free(here);
                snap_free(state);
                return cost_nxn;
            }
            snap_restore(*here, x0, y0, size);
            snap_free(here);
        }
        snap_free(state);
        return cost_here;
    }
    Snap* here = snap_new();
    snap_save(*here, x0, y0, size);
    // ECU (early CU termination; fast/medium): skip CU ends the recursion
    if (en.rd_candidates <= 2 && !g_sp.is_i
        && g_sp.skip_flag[idx4(x0, y0)]) {
        snap_free(here);
        snap_free(state);
        return cost_here;
    }
    // RCU-depth: status 1 keeps the 16x16 result without trying 8x8
    if (rcu_st == 1 && depth == 2) {
        snap_free(here);
        snap_free(state);
        return cost_here;
    }
    snap_restore(*state, x0, y0, size);
    snap_free(state);

    int half = size >> 1;
    double cost_split = commit_split_flag(x0, y0, log2, depth, 1);
    static const int q[4][2] = {{0, 0}, {1, 0}, {0, 1}, {1, 1}};
    for (int i = 0; i < 4; i++)
        cost_split += decide_cqt(x0 + q[i][0] * half, y0 + q[i][1] * half,
                                 log2 - 1, depth + 1);
    if (cost_here <= cost_split) {
        snap_restore(*here, x0, y0, size);
        snap_free(here);
        return cost_here;
    }
    snap_free(here);
    return cost_split;
}

}  // namespace

// ---------------------------------------------------------------- SAO RDO
// encode/sao_search.py oracle (EncSao::rdSao analogue, turing/EncSao.h:950):
// closed-form offset k on n samples with error sum e changes SSD by
// n*k^2 - 2*k*e.

namespace {

struct SaoCand {
    double cost;
    int cls;
    int offs[4];
};

void sao_best_offset(int64_t n, double e, double lam, int sign, int* out_k,
                     double* out_c) {
    // sign: 0 = unconstrained (band), +1/-1 = edge-class constraint
    if (n == 0) {
        *out_k = 0;
        *out_c = 0.0;
        return;
    }
    int best_k = 0;
    double best_c = 0.0;
    double q = std::nearbyint(e / (double)n);  // ties-to-even (Python round)
    int k0 = (int)clip3i(-7, 7, (int)q);
    int lo = k0 >= 0 ? 0 : k0, hi = k0 >= 0 ? k0 : 0;
    for (int k = lo; k <= hi; k++) {
        if (sign != 0 && k * sign < 0)
            continue;
        double c = (double)(n * k * k) - 2.0 * k * e
                 + lam * ((k < 0 ? -k : k) + 1);
        if (c < best_c) {
            best_c = c;
            best_k = k;
        }
    }
    *out_k = best_k;
    *out_c = best_c;
}

// raw per-class statistics of one CTB of one component, for costing a
// NEIGHBOUR's params on this CTB (merge candidates) — sao_search twin
struct SaoStats {
    int64_t cnt[4][5];   // [eo][class]
    int64_t esum[4][5];
    int64_t n_b[32];
    int64_t e_b[32];
};

// candidates for one CTB of one component: [0]=off, [1]=band, [2..5]=eo 0..3
void sao_ctb_candidates(const int16_t* o, const int16_t* r, int w, int h,
                        int y0, int y1, int x0, int x1, int bd, double lam,
                        SaoCand out[6], SaoStats* st) {
    static const int eo_n[4][2][2] = {{{0, -1}, {0, 1}},
                                      {{-1, 0}, {1, 0}},
                                      {{-1, -1}, {1, 1}},
                                      {{-1, 1}, {1, -1}}};
    static const int remap[5] = {1, 2, 0, 3, 4};
    out[0].cost = 0.0;
    out[0].cls = 0;
    out[0].offs[0] = out[0].offs[1] = out[0].offs[2] = out[0].offs[3] = 0;

    for (int eo = 0; eo < 4; eo++) {
        int64_t cnt[5] = {0, 0, 0, 0, 0};
        int64_t esum[5] = {0, 0, 0, 0, 0};
        int ady = eo_n[eo][0][0], adx = eo_n[eo][0][1];
        int bdy = eo_n[eo][1][0], bdx = eo_n[eo][1][1];
        for (int y = y0; y < y1; y++)
            for (int x = x0; x < x1; x++) {
                int ay = y + ady, ax = x + adx;
                int by = y + bdy, bx = x + bdx;
                if (ay < 0 || ay >= h || ax < 0 || ax >= w || by < 0
                    || by >= h || bx < 0 || bx >= w)
                    continue;
                int rv = r[(int64_t)y * w + x];
                int da = rv - r[(int64_t)ay * w + ax];
                int db = rv - r[(int64_t)by * w + bx];
                int cat = 2 + (da > 0) - (da < 0) + (db > 0) - (db < 0);
                int cls = remap[cat];
                if (cls == 0)
                    continue;
                cnt[cls]++;
                esum[cls] += o[(int64_t)y * w + x] - rv;
            }
        double cost = 0.0;
        SaoCand& c = out[2 + eo];
        for (int i = 0; i < 4; i++) {
            static const int cls_sgn[4][2] = {{1, 1}, {2, 1}, {3, -1},
                                              {4, -1}};
            int k;
            double cc;
            sao_best_offset(cnt[cls_sgn[i][0]],
                            (double)esum[cls_sgn[i][0]], lam, cls_sgn[i][1],
                            &k, &cc);
            c.offs[i] = k;
            cost += cc;
        }
        c.cost = cost;
        c.cls = eo;
        if (st)
            for (int i = 0; i < 5; i++) {
                st->cnt[eo][i] = cnt[i];
                st->esum[eo][i] = esum[i];
            }
    }

    // band offsets
    int shift = bd - 5;
    int64_t n_b[32] = {};
    int64_t e_b[32] = {};
    for (int y = y0; y < y1; y++)
        for (int x = x0; x < x1; x++) {
            int rv = r[(int64_t)y * w + x];
            int b = rv >> shift;
            n_b[b]++;
            e_b[b] += o[(int64_t)y * w + x] - rv;
        }
    if (st)
        for (int b = 0; b < 32; b++) {
            st->n_b[b] = n_b[b];
            st->e_b[b] = e_b[b];
        }
    int kb[32];
    double cb[32];
    for (int b = 0; b < 32; b++)
        sao_best_offset(n_b[b], (double)e_b[b], lam, 0, &kb[b], &cb[b]);
    int best_pos = 0;
    double best_cost = 1e30;
    for (int pos = 0; pos < 29; pos++) {
        double c = cb[pos] + cb[pos + 1] + cb[pos + 2] + cb[pos + 3];
        if (c < best_cost) {
            best_cost = c;
            best_pos = pos;
        }
    }
    out[1].cost = best_cost;
    out[1].cls = best_pos;
    for (int i = 0; i < 4; i++)
        out[1].offs[i] = kb[best_pos + i];
}

void sao_apply(uint8_t* sao_type, uint8_t* sao_class, int8_t* sao_offsets,
               int wc, int64_t cur, int c_idx, int key, const SaoCand& c) {
    if (key == 0) {
        sao_type[cur * 3 + c_idx] = 0;
        sao_class[cur * 3 + c_idx] = 0;
        for (int i = 0; i < 4; i++)
            sao_offsets[cur * 12 + c_idx * 4 + i] = 0;
    } else {
        sao_type[cur * 3 + c_idx] = key == 1 ? 1 : 2;
        sao_class[cur * 3 + c_idx] = (uint8_t)c.cls;
        for (int i = 0; i < 4; i++)
            sao_offsets[cur * 12 + c_idx * 4 + i] = (int8_t)c.offs[i];
    }
}

// ------------------------------------------------- wavefront row threading
// The TaskEncodeSubstream analogue (reference TaskEncodeSubstream.cpp:55-184,
// SURVEY §2.7 axis 1): one logical task per CTU row, scheduled round-robin
// over nthreads OS threads with the standard WPP wavefront lag — CTU
// (rx, ry) may start once the row above has finished CTU rx+1 (top-right
// neighbour rule, TaskEncodeSubstream.cpp:62-69). Decisions are
// bit-identical to the sequential walk: the rate contexts evolve per row
// exactly as WPP inheritance dictates, and every cross-row read (intra
// reference samples, merge/AMVP neighbours, ct_depth pruning) stays behind
// the wavefront. Only the cu/pu/tu id numbering differs (per-CTU bases);
// ids are only ever compared for equality across block edges, so the
// bitstream and reconstruction are byte-identical with the 1-thread walk
// (asserted in tests/test_native.py).
struct RowProgress {
    std::atomic<int> done{0};
    char pad[64 - sizeof(std::atomic<int>)];  // avoid false sharing
};

// optional per-CTU committed-frac output (checkRate invariant harness)

double enc_picture_mt(uint8_t* ctx, int32_t* ids, const int32_t* qp3,
                      const double* lam3, int snap_rx,
                      const uint8_t* init_states, int nthreads, int wc,
                      int hc) {
    const int T = std::min(nthreads, hc);
    const int nctx = en.num_ctx;
    std::vector<RowProgress> prog(hc);
    std::vector<std::array<uint8_t, 512>> snaps(hc);
    std::vector<double> ctu_cost((size_t)wc * hc, 0.0);
    std::atomic<int> err{0};

    auto worker = [&](int tid) {
        alignas(64) uint8_t myctx[512];
        int32_t myids[3];
        for (int ry = tid; ry < hc; ry += T) {
            if (ry == 0)
                std::memcpy(myctx, ctx, nctx);
            cur.ctx = myctx;
            cur.ids = myids;
            cur.prev_int_valid[0] = cur.prev_int_valid[1] = 0;
            ovl_wait_row(ry);
            for (int rx = 0; rx < wc; rx++) {
                if (ry > 0) {
                    const int need = std::min(wc, rx + 2);
                    while (prog[ry - 1].done.load(std::memory_order_acquire)
                           < need) {
                        if (err.load(std::memory_order_relaxed))
                            return;
                        std::this_thread::yield();
                    }
                    if (rx == 0)  // WPP inheritance from the row above
                        std::memcpy(myctx, snaps[ry - 1].data(), nctx);
                }
                const int64_t i = (int64_t)ry * wc + rx;
                cur.qp_full = qp3[i * 3];
                cur.qp_cb_full = qp3[i * 3 + 1];
                cur.qp_cr_full = qp3[i * 3 + 2];
                cur.lam = lam3[i * 3];
                cur.lam_bits = lam3[i * 3 + 1];
                cur.lam_me = lam3[i * 3 + 2];
                // per-CTU id bases keep ids unique without a shared counter
                myids[0] = myids[1] = myids[2] = (int32_t)(i * 512);
                cur.err = 0;
                cur.ctu_frac = 0;
                ctu_cost[i] = decide_cqt(rx << g_sp.ctb_log2,
                                         ry << g_sp.ctb_log2,
                                         g_sp.ctb_log2, 0);
                if (en.frac_out)
                    en.frac_out[i] = cur.ctu_frac;
                if (cur.err) {
                    err.store(1, std::memory_order_relaxed);
                    return;
                }
                if (rx == snap_rx)
                    std::memcpy(snaps[ry].data(), myctx, nctx);
                prog[ry].done.store(rx + 1, std::memory_order_release);
            }
            // rows complete in order (the WPP top-right rule transitively
            // requires row ry-1 done before row ry's last CTU); publish
            // via CAS-max since the stores race across row threads
            if (en.ovl.self_rows)
                ovl_publish(en.ovl.self_rows, ry + 1);
            if (ry == hc - 1)  // caller continues from the last row's state
                std::memcpy(ctx, myctx, nctx);
        }
    };

    std::vector<std::thread> threads;
    threads.reserve(T - 1);
    // WPP row threads inherit the spawner's picture context
    SP* sp_ = g_sp_ptr;
    EN* en_ = g_en_ptr;
    auto tworker = [&worker, sp_, en_](int t) {
        g_sp_ptr = sp_;
        g_en_ptr = en_;
        worker(t);
    };
    for (int t = 1; t < T; t++)
        threads.emplace_back(tworker, t);
    worker(0);
    for (auto& th : threads)
        th.join();
    if (err.load())
        return -1.0;
    ids[0] = ids[1] = ids[2] = (int32_t)((int64_t)wc * hc * 512);
    double total = 0.0;  // raster-order sum: identical FP result
    for (size_t i = 0; i < ctu_cost.size(); i++)
        total += ctu_cost[i];
    return total;
}

}  // namespace

// ---------------------------------------------------------------- ctypes

extern "C" {

// kernel parity test shims (tests/test_native.py)
int64_t tc_test_satd(const int32_t* a, const int32_t* b, int bs) {
    return satd_block(a, b, bs, bs, bs);
}
int64_t tc_test_satd_scalar(const int32_t* a, const int32_t* b, int bs) {
    return bs == 8 ? satd_block_t<8>(a, b, bs, bs)
                   : satd_block_t<4>(a, b, bs, bs);
}
void tc_test_fwd_transform(const int32_t* res, int n, int bit_depth,
                           int use_dst, int32_t* out) {
    fwd_transform(res, n, bit_depth, use_dst, out);
}

// SAO parameter estimation for the whole picture (sao_search.estimate_sao
// oracle): luma independent, chroma joint-type. Writes plan.sao_* directly.
// approximate signalling bits of one component's explicit params,
// mirroring write_sao's bins (sao_search._explicit_bits twin)
static int sao_explicit_bits(int key /*0 off,1 band,2..5 eo*/,
                             const SaoCand& c, int bd, int c_idx) {
    if (key == 0)
        return c_idx <= 1 ? 1 : 0;
    // offset TR bits are NOT counted here: _best_offset already folds
    // lam*(|k|+1) per offset into the candidate cost (counting them
    // again biased decisions toward merge/off)
    int bits = c_idx <= 1 ? 2 : 0;
    if (key == 1) {
        for (int i = 0; i < 4; i++)
            bits += c.offs[i] != 0;
        bits += 5;
    } else if (c_idx <= 1) {
        bits += 2;
    }
    return bits;
}

// delta-SSD of applying (type, class, offsets) to a CTB with stats st
// (sao_search._merge_delta_ssd twin)
static double sao_merge_delta(const SaoStats& st, int t, int cls,
                              const int8_t* offs) {
    if (t == 0)
        return 0.0;
    double d = 0.0;
    if (t == 1) {
        for (int i = 0; i < 4; i++) {
            const int k = offs[i];
            const int b = (cls + i) & 31;
            d += (double)st.n_b[b] * k * k - 2.0 * k * (double)st.e_b[b];
        }
    } else {
        static const int map_[4] = {1, 2, 3, 4};
        for (int i = 0; i < 4; i++) {
            const int k = offs[i];
            d += (double)st.cnt[cls][map_[i]] * k * k
               - 2.0 * k * (double)st.esum[cls][map_[i]];
        }
    }
    return d;
}

// cy0/cy1 restrict to CTB rows [cy0, cy1): the per-CTB decision only
// consults ALREADY-DECIDED left/up plan params, so a row-banded call
// sequence equals the whole-picture raster walk exactly (the overlap
// follower estimates behind the deblock band)
void tc_sao_estimate(const int64_t* orig_ptrs, const int64_t* rec_ptrs,
                     int64_t sao_type_p, int64_t sao_class_p,
                     int64_t sao_offsets_p, int64_t sao_merge_p,
                     int64_t slice_idx_p, int64_t tile_id_p,
                     int32_t wc, int32_t hc,
                     int32_t ctb, int32_t pic_w, int32_t pic_h,
                     int32_t bd_y, int32_t bd_c, double lam,
                     int32_t cy0, int32_t cy1) {
    const int16_t* o[3];
    const int16_t* r[3];
    for (int i = 0; i < 3; i++) {
        o[i] = (const int16_t*)orig_ptrs[i];
        r[i] = (const int16_t*)rec_ptrs[i];
    }
    uint8_t* sao_type = (uint8_t*)sao_type_p;
    uint8_t* sao_class = (uint8_t*)sao_class_p;
    int8_t* sao_offsets = (int8_t*)sao_offsets_p;
    uint8_t* sao_merge = (uint8_t*)sao_merge_p;
    const int32_t* slice_idx = (const int32_t*)slice_idx_p;
    const int32_t* tile_id = (const int32_t*)tile_id_p;
    const int cwd = pic_w >> 1, chd = pic_h >> 1;
    const int cs = ctb >> 1;
    if (cy1 > hc)
        cy1 = hc;
    for (int cy = cy0; cy < cy1; cy++)
        for (int cx = 0; cx < wc; cx++) {
            const int64_t cur = (int64_t)cy * wc + cx;
            SaoCand cl[6];
            SaoStats stl;
            {
                int y0 = cy * ctb, x0 = cx * ctb;
                int y1 = y0 + ctb < pic_h ? y0 + ctb : pic_h;
                int x1 = x0 + ctb < pic_w ? x0 + ctb : pic_w;
                sao_ctb_candidates(o[0], r[0], pic_w, pic_h, y0, y1, x0, x1,
                                   bd_y, lam, cl, &stl);
            }
            SaoCand cc[2][6];
            SaoStats stc[2];
            for (int ci = 0; ci < 2; ci++) {
                int y0 = cy * cs, x0 = cx * cs;
                int y1 = y0 + cs < chd ? y0 + cs : chd;
                int x1 = x0 + cs < cwd ? x0 + cs : cwd;
                sao_ctb_candidates(o[ci + 1], r[ci + 1], cwd, chd, y0, y1,
                                   x0, x1, bd_c, lam, cc[ci], &stc[ci]);
            }
            const bool left_ok = cx > 0 && slice_idx[cur - 1] == slice_idx[cur]
                && tile_id[cur] == tile_id[cur - 1];
            const bool up_ok = cy > 0 && slice_idx[cur - wc] == slice_idx[cur]
                && tile_id[cur] == tile_id[cur - wc];

            // explicit (new) decision per component with signalling bits;
            // candidate order off, band, eo0..3 — first minimum wins
            int lkey = 0;
            double lcost = 0.0;
            for (int key = 0; key < 6; key++) {
                const double c = cl[key].cost
                    + lam * sao_explicit_bits(key, cl[key], bd_y, 0);
                if (key == 0 || c < lcost) {
                    lkey = key;
                    lcost = c;
                }
            }
            int ckey = 0;
            double ccost = 0.0;
            for (int key = 0; key < 6; key++) {
                const double c = cc[0][key].cost + cc[1][key].cost
                    + lam * (sao_explicit_bits(key, cc[0][key], bd_c, 1)
                             + sao_explicit_bits(key, cc[1][key], bd_c, 2));
                if (key == 0 || c < ccost) {
                    ckey = key;
                    ccost = c;
                }
            }
            const double new_cost = lcost + ccost
                + lam * ((left_ok ? 1 : 0) + (up_ok ? 1 : 0));

            // merge candidates: apply the neighbour's resolved params
            auto merge_cost = [&](int64_t nb, int flag_bits) -> double {
                double d = 0.0;
                const SaoStats* sts[3] = {&stl, &stc[0], &stc[1]};
                for (int ci = 0; ci < 3; ci++)
                    d += sao_merge_delta(*sts[ci], sao_type[nb * 3 + ci],
                                         sao_class[nb * 3 + ci],
                                         sao_offsets + nb * 12 + ci * 4);
                return d + lam * flag_bits;
            };
            int choice = 0;
            double best = new_cost;
            if (left_ok) {
                const double c = merge_cost(cur - 1, 1);
                if (c < best) {
                    best = c;
                    choice = 1;
                }
            }
            if (up_ok) {
                const double c = merge_cost(cur - wc, left_ok ? 2 : 1);
                if (c < best) {
                    best = c;
                    choice = 2;
                }
            }
            sao_merge[cur] = (uint8_t)choice;
            if (choice) {
                const int64_t nb = choice == 1 ? cur - 1 : cur - wc;
                for (int ci = 0; ci < 3; ci++) {
                    sao_type[cur * 3 + ci] = sao_type[nb * 3 + ci];
                    sao_class[cur * 3 + ci] = sao_class[nb * 3 + ci];
                    for (int i = 0; i < 4; i++)
                        sao_offsets[cur * 12 + ci * 4 + i] =
                            sao_offsets[nb * 12 + ci * 4 + i];
                }
            } else {
                sao_apply(sao_type, sao_class, sao_offsets, wc, cur, 0,
                          lkey, cl[lkey]);
                sao_apply(sao_type, sao_class, sao_offsets, wc, cur, 1,
                          ckey, cc[0][ckey]);
                sao_apply(sao_type, sao_class, sao_offsets, wc, cur, 2,
                          ckey, cc[1][ckey]);
            }
        }
}

// Per-picture setup. g_sp must already be configured via tc_slice_setup.
// ptrs: [orig_y, orig_cb, orig_cr, rec_y, rec_cb, rec_cr, zscan32,
//        then 2*16*3 reference plane ptrs]
// ip: [rd_candidates, max_cu_log2, search_range, strong, num_ctx]
void tc_enc_setup(const int64_t* ptrs, const int32_t* ip,
                  const int32_t* quant_scales, const int32_t* luma_filt,
                  const int32_t* chroma_filt) {
    int k = 0;
    for (int i = 0; i < 3; i++)
        en.orig[i] = (const int16_t*)ptrs[k++];
    for (int i = 0; i < 3; i++)
        en.rec[i] = (int16_t*)ptrs[k++];
    en.zscan32 = (const int32_t*)ptrs[k++];
    // int16 SATD measures speed-neutral on this uarch (the kernel is
    // load-bound: 6.7ns/blk either way, tc_satd_selftest) — keep the
    // int32 path; flip via TC_SATD_I16 to re-measure elsewhere
    g_satd_i16 = g_sp.bit_depth_y == 8 && g_sp.bit_depth_c == 8
                 && getenv("TC_SATD_I16") != nullptr;
    for (int l = 0; l < 2; l++)
        for (int r = 0; r < 16; r++)
            for (int c = 0; c < 3; c++)
                en.refs[l][r][c] = (const int16_t*)ptrs[k++];
    // overlap mode (ip[13], see EN::Overlap): reference planes are still
    // being encoded, so nothing here may read them eagerly — the u8
    // shadows come from the producer pictures' follower
    // (tc_enc_overlap_setup) and the subpel plane cache stays off
    const int ovl_flag = ip[13];
    en.ovl = EN::Overlap();
    en.ovl.active = en.ovl.clamp = ovl_flag;
    // u8 shadows of the reference luma planes for the psadbw ME fast
    // path (bit-equal: 8-bit samples fit a byte); planes shared between
    // lists (GPB) convert once
    static thread_local std::vector<uint8_t> ref8_store[2][16];
    for (int l = 0; l < 2; l++)
        for (int r = 0; r < 16; r++) {
            en.ref8[l][r] = nullptr;
            const int16_t* src = en.refs[l][r][0];
            if (g_sp.bit_depth_y != 8 || !src || ovl_flag)
                continue;
            bool shared = false;
            for (int l2 = 0; l2 <= l && !shared; l2++)
                for (int r2 = 0; r2 < (l2 == l ? r : 16); r2++)
                    if (en.refs[l2][r2][0] == src && en.ref8[l2][r2]) {
                        en.ref8[l][r] = en.ref8[l2][r2];
                        shared = true;
                        break;
                    }
            if (shared)
                continue;
            const int64_t n = (int64_t)g_sp.pic_w * g_sp.pic_h;
            auto& v = ref8_store[l][r];
            v.resize(n);
            uint8_t* dst = v.data();
            for (int64_t i = 0; i < n; i++)
                dst[i] = (uint8_t)src[i];
            en.ref8[l][r] = dst;
        }
    en.have_seed[0] = en.have_seed[1] = 0;  // per-picture (set in prepass)
    en.have_dense[0] = en.have_dense[1] = 0;
    en.have_surf[0] = en.have_surf[1] = 0;
    en.aq_depth = -1;  // per-picture (tc_enc_install_aqlayer)
    en.have_ranksatd = 0;  // per-picture (device install after setup)
    // subpel plane cache: one set per distinct hot reference plane,
    // nearest refs first (they take nearly all subpel probes); planes
    // rebuild lazily per picture (flags cleared here — reference recon
    // storage may be reused across pictures, so no cross-picture reuse)
    {
        static const bool sp_off =
            getenv("TC_NO_SUBPEL_PLANES") != nullptr;
        std::memset(en.sp_of, -1, sizeof(en.sp_of));
        int next = 0;
        if (!sp_off && !g_sp.is_i && !ovl_flag) {
            static const int prio[6][2] = {{0, 0}, {1, 0}, {0, 1},
                                           {1, 1}, {0, 2}, {0, 3}};
            for (auto& pr : prio) {
                const int l = pr[0], r = pr[1];
                const int16_t* p = en.refs[l][r][0];
                if (!p)
                    continue;
                int found = -1;
                for (int l2 = 0; l2 < 2 && found < 0; l2++)
                    for (int r2 = 0; r2 < 16; r2++)
                        if (en.sp_of[l2][r2] >= 0
                            && en.refs[l2][r2][0] == p) {
                            found = en.sp_of[l2][r2];
                            break;
                        }
                if (found >= 0) {
                    en.sp_of[l][r] = (int8_t)found;
                    continue;
                }
                if (next >= EN::N_SPSETS)
                    continue;
                en.spsets[next].reset(nullptr);
                en.sp_of[l][r] = (int8_t)next++;
            }
        }
    }
    int j = 0;
    en.rd_candidates = ip[j++];
    en.max_cu_log2 = ip[j++];
    en.max_cu_inter = ip[j++];
    en.search_range = ip[j++];
    en.strong = ip[j++];
    en.num_ctx = ip[j++];
    en.rcudepth = ip[j++];
    en.rdoq = ip[j++];
    en.met = ip[j++];
    en.fdam = ip[j++];
    en.rqt = ip[j++];
    en.esd = ip[j++];
    en.aps = ip[j++];
    std::memcpy(en.quant_scales, quant_scales, sizeof(en.quant_scales));
    std::memcpy(en.luma_filt, luma_filt, sizeof(en.luma_filt));
    std::memcpy(en.chroma_filt, chroma_filt, sizeof(en.chroma_filt));
}

// Bind the inter-picture overlap plumbing for the picture bound to this
// thread's context (call after tc_enc_setup with overlap flagged).
// self_rows: int64* receiving the search's completed CTU rows (0 = none).
// ref_rows[l*16+r]: int64* (as intptr; 0 = reference already complete)
// holding the reference's published FINAL (loop-filtered) CTU row count.
// ref_u8[l*16+r]: u8 luma shadow maintained by the reference's follower,
// valid up to the published rows (0 = none).
void tc_enc_overlap_setup(int64_t self_rows, const int64_t* ref_rows,
                          const int64_t* ref_u8) {
    en.ovl.self_rows = (volatile int64_t*)self_rows;
    static thread_local std::vector<uint8_t> ovl_u8_store[2][16];
    for (int l = 0; l < 2; l++)
        for (int r = 0; r < 16; r++) {
            en.ovl.ref_rows[l][r] = nullptr;
            const int16_t* src = en.refs[l][r][0];
            if (!src)
                continue;
            en.ovl.ref_rows[l][r] =
                (const volatile int64_t*)ref_rows[l * 16 + r];
            if (ref_u8[l * 16 + r]) {
                en.ref8[l][r] = (const uint8_t*)ref_u8[l * 16 + r];
            } else if (!ref_rows[l * 16 + r] && g_sp.bit_depth_y == 8) {
                // complete reference without a follower shadow: eager
                // conversion is safe now (skipped in tc_enc_setup)
                bool shared = false;
                for (int l2 = 0; l2 <= l && !shared; l2++)
                    for (int r2 = 0; r2 < (l2 == l ? r : 16); r2++)
                        if (en.refs[l2][r2][0] == src && en.ref8[l2][r2]) {
                            en.ref8[l][r] = en.ref8[l2][r2];
                            shared = true;
                            break;
                        }
                if (shared)
                    continue;
                const int64_t n = (int64_t)g_sp.pic_w * g_sp.pic_h;
                auto& v = ovl_u8_store[l][r];
                v.resize(n);
                uint8_t* dst = v.data();
                for (int64_t i = 0; i < n; i++)
                    dst[i] = (uint8_t)src[i];
                en.ref8[l][r] = dst;
            }
        }
    // subpel plane cache for COMPLETE references only (their samples are
    // final, so the whole-plane lazy build is safe; in-flight refs fall
    // back to per-candidate mc14 interpolation, whose reads the y-clamp
    // bounds)
    static const bool sp_off = getenv("TC_NO_SUBPEL_PLANES") != nullptr;
    if (!sp_off && !g_sp.is_i) {
        int next = 0;
        static const int prio[6][2] = {{0, 0}, {1, 0}, {0, 1},
                                       {1, 1}, {0, 2}, {0, 3}};
        for (auto& pr : prio) {
            const int l = pr[0], r = pr[1];
            const int16_t* p = en.refs[l][r][0];
            if (!p)
                continue;
            int found = -1;
            for (int l2 = 0; l2 < 2 && found < 0; l2++)
                for (int r2 = 0; r2 < 16; r2++)
                    if (en.sp_of[l2][r2] >= 0
                        && en.refs[l2][r2][0] == p) {
                        found = en.sp_of[l2][r2];
                        break;
                    }
            if (found >= 0) {
                en.sp_of[l][r] = (int8_t)found;
                continue;
            }
            if (next >= EN::N_SPSETS)
                continue;
            // in-flight refs build in bands bounded by the producer's
            // published final rows; complete refs (null prog) build whole
            en.spsets[next].reset(
                (const volatile int64_t*)ref_rows[l * 16 + r]);
            en.sp_of[l][r] = (int8_t)next++;
        }
    }
}

// Encode a whole picture's CTUs (full RDO), replacing the per-CTU Python
// loop (intra_search.encode_picture): WPP rate-context inheritance, per-CTB
// QP/lambda (AQ), and the CTU raster walk all run natively in one call.
// qp3: (hc*wc, 3) int32 [qp_y_full, qp_cb_full, qp_cr_full] per CTB;
// lam3: (hc*wc, 3) double [lam, lam_bits, lam_me] per CTB;
// init_states: fresh CABAC rate-context pool for WPP/slice re-init.
// Returns total RD cost; negative on error.
double tc_enc_picture(uint8_t* ctx, int32_t* ids, const int32_t* qp3,
                      const double* lam3, int32_t wpp, int32_t snap_rx,
                      const uint8_t* init_states, int32_t nthreads) {
    const int wc = (g_sp.pic_w + (1 << g_sp.ctb_log2) - 1) >> g_sp.ctb_log2;
    const int hc = (g_sp.pic_h + (1 << g_sp.ctb_log2) - 1) >> g_sp.ctb_log2;
    lowres_prepass(nthreads);
    if (nthreads > 1 && wpp && hc > 1)
        return enc_picture_mt(ctx, ids, qp3, lam3, snap_rx, init_states,
                              nthreads, wc, hc);
    cur.ctx = ctx;
    cur.ids = ids;
    cur.err = 0;
    static thread_local uint8_t snap_ctx[512];
    bool have_snap = false;
    double total = 0.0;
    for (int ry = 0; ry < hc; ry++) {
        ovl_wait_row(ry);
        for (int rx = 0; rx < wc; rx++) {
            if (rx == 0)  // ME seed state is row-local (thread-count inv.)
                cur.prev_int_valid[0] = cur.prev_int_valid[1] = 0;
            if (wpp && rx == 0 && ry > 0) {
                // mirror the writer's WPP context inheritance
                std::memcpy(ctx, have_snap ? snap_ctx : init_states,
                            en.num_ctx);
            }
            const int64_t i = (int64_t)ry * wc + rx;
            cur.qp_full = qp3[i * 3];
            cur.qp_cb_full = qp3[i * 3 + 1];
            cur.qp_cr_full = qp3[i * 3 + 2];
            cur.lam = lam3[i * 3];
            cur.lam_bits = lam3[i * 3 + 1];
            cur.lam_me = lam3[i * 3 + 2];
            cur.ctu_frac = 0;
            total += decide_cqt(rx << g_sp.ctb_log2, ry << g_sp.ctb_log2,
                                g_sp.ctb_log2, 0);
            if (en.frac_out)
                en.frac_out[i] = cur.ctu_frac;
            if (cur.err)
                return -1.0;
            if (wpp && rx == snap_rx) {
                std::memcpy(snap_ctx, ctx, en.num_ctx);
                have_snap = true;
            }
        }
        if (en.ovl.self_rows)
            ovl_publish(en.ovl.self_rows, ry + 1);
    }
    return total;
}

// Encode one CTU (full RDO). Returns the RD cost; negative on error.
void tc_enc_me_seed_reset() {
    // tile-row starts (tiles walk CTUs per tile, so rows begin at the
    // tile's left column, not x0 == 0)
    cur.prev_int_valid[0] = cur.prev_int_valid[1] = 0;
}

double tc_enc_ctu(int32_t x0, int32_t y0, uint8_t* ctx, int32_t* ids,
                  int32_t qp_full, int32_t qp_cb_full, int32_t qp_cr_full,
                  double lam, double lam_bits, double lam_me) {
    if (x0 == 0)  // ME seed state is row-local
        cur.prev_int_valid[0] = cur.prev_int_valid[1] = 0;
    cur.ctx = ctx;
    cur.ids = ids;
    cur.qp_full = qp_full;
    cur.qp_cb_full = qp_cb_full;
    cur.qp_cr_full = qp_cr_full;
    cur.lam = lam;
    cur.lam_bits = lam_bits;
    cur.lam_me = lam_me;
    cur.err = 0;
    cur.ctu_frac = 0;
    double cost = decide_cqt(x0, y0, g_sp.ctb_log2, 0);
    if (en.frac_out) {
        const int wc2 = (g_sp.pic_w + (1 << g_sp.ctb_log2) - 1)
                        >> g_sp.ctb_log2;
        en.frac_out[(int64_t)(y0 >> g_sp.ctb_log2) * wc2
                   + (x0 >> g_sp.ctb_log2)] = cur.ctu_frac;
    }
    return cur.err ? -1.0 : cost;
}

// install/clear the per-CTU frac output buffer (raster order, wc*hc)
void tc_enc_set_frac_out(int64_t* p) { en.frac_out = p; }

// install device-computed subpel planes for (list, ref): data is
// (15, ph, pw) int16, positions xf + 4*yf for pos 1..15, pad SP_P —
// integer-exact twins of sp_build_plane (device_analysis.subpel_planes)
void tc_enc_install_subpel(int32_t l, int32_t r, const int16_t* data,
                           int32_t pw, int32_t ph) {
    const int si = en.sp_of[l][r];
    if (si < 0 || pw != g_sp.pic_w + 2 * SP_P
        || ph != g_sp.pic_h + 2 * SP_P)
        return;
    EN::SubpelSet& s = en.spsets[si];
    for (int pos = 1; pos < 16; pos++) {
        s.plane[pos].assign(data + (size_t)(pos - 1) * ph * pw,
                            data + (size_t)pos * ph * pw);
        s.rows_built[pos].store(ph, std::memory_order_release);
    }
}

// read one subpel plane (building it natively if needed) — device-twin
// verification hook; out: (ph, pw) int16
void tc_enc_subpel_plane(int32_t l, int32_t r, int32_t xf, int32_t yf,
                         int16_t* out) {
    const int16_t* pl = sp_plane(l, r, xf, yf,
                                 g_sp.pic_h + 2 * SP_P);
    if (!pl)
        return;
    const size_t n = (size_t)(g_sp.pic_w + 2 * SP_P)
                     * (g_sp.pic_h + 2 * SP_P);
    std::memcpy(out, pl, n * sizeof(int16_t));
}

// install a device-computed rank-SATD table for size 1<<log2:
// (hn, wn, 35) int32, hn*wn aligned blocks
void tc_enc_install_ranksatd(int32_t log2, const int32_t* data,
                             int32_t hn, int32_t wn) {
    if (log2 < 2 || log2 > 5)
        return;
    en.ranksatd[log2].assign(data, data + (size_t)hn * wn * 35);
    en.ranksatd_wn[log2] = wn;
    en.have_ranksatd |= 1 << log2;
}

// install a device-computed lowres pre-ME seed field for list l
// (encode/device_analysis.py; exact lowres_prepass values)
void tc_enc_install_seeds(int32_t l, const int16_t* mv, int32_t wb,
                          int32_t hb) {
    en.seed_wb = wb;
    en.seed_hb = hb;
    en.seed_mv[l].assign(mv, mv + (size_t)hb * wb * 2);
    en.have_seed[l] = 1;
    en.seeds_external = 1;
}

// Standalone encoder pre-analysis on arbitrary planes: lowres pre-ME
// seeds + dense full-pel ME field + winner SADs (the facade's
// noise-adaptivity input). Twin of inter_search._lowres_seed_field +
// _dense_field; identical integers to the in-picture prepass. orig/ref:
// int16 (h, w) planes; out_seeds/out_dense: (hb*wb, 2) int16;
// out_sad: (hb*wb) int32.
void tc_dense_analysis(const int16_t* orig, const int16_t* ref, int32_t w,
                       int32_t h, int32_t bd, int32_t nthreads,
                       int16_t* out_seeds, int16_t* out_dense,
                       int32_t* out_sad, int32_t* out_surf) {
    PhaseTimer pt(25);  // facade-driven prepass (device-offloadable)
    const int lw = (w + 3) >> 2, lh = (h + 3) >> 2;
    const int wb = (lw + 3) >> 2, hb = (lh + 3) >> 2;
    const int B = 8;
    const int dw = wb * 4 + 2 * B;
    static thread_local std::vector<int16_t> lr_cur, lr_ref, cur_t,
        cur_h, cur_ht, ref_h;
    lr_cur.resize((size_t)(hb * 4 + 2 * B) * dw);
    lr_ref.resize((size_t)(hb * 4 + 2 * B) * dw);
    lowres_plane<4, 4>(orig, w, h, wb, hb, B, lr_cur.data());
    lowres_plane<4, 4>(ref, w, h, wb, hb, B, lr_ref.data());
    const int cw = wb * 4;
    cur_t.resize((size_t)hb * 4 * cw);
    for (int y = 0; y < hb * 4; y++)
        std::memcpy(cur_t.data() + (int64_t)y * cw,
                    lr_cur.data() + (int64_t)(y + B) * dw + B,
                    cw * sizeof(int16_t));
    const int B2 = 24;
    const int cw2 = wb * 8, dw2 = wb * 8 + 2 * B2;
    cur_h.resize((size_t)(hb * 8 + 2 * B2) * dw2);
    lowres_plane<2, 8>(orig, w, h, wb, hb, B2, cur_h.data());
    cur_ht.resize((size_t)hb * 8 * cw2);
    for (int y = 0; y < hb * 8; y++)
        std::memcpy(cur_ht.data() + (int64_t)y * cw2,
                    cur_h.data() + (int64_t)(y + B2) * dw2 + B2,
                    cw2 * sizeof(int16_t));
    ref_h.resize((size_t)(hb * 8 + 2 * B2) * dw2);
    lowres_plane<2, 8>(ref, w, h, wb, hb, B2, ref_h.data());
    const bool u8 = bd == 8;
    static thread_local std::vector<uint8_t> c8, r8;
    static thread_local std::vector<int16_t> c16, r16;
    const size_t rsz = (size_t)(hb * 16 + 2 * DENSE_P)
        * (wb * 16 + 2 * DENSE_P);
    if (u8) {
        c8.resize((size_t)hb * 16 * (wb * 16));
        r8.resize(rsz);
        dense_pad_plane<uint8_t>(orig, w, h, wb, hb, 0, c8.data());
        dense_pad_plane<uint8_t>(ref, w, h, wb, hb, DENSE_P, r8.data());
    } else {
        c16.resize((size_t)hb * 16 * (wb * 16));
        r16.resize(rsz);
        dense_pad_plane<int16_t>(orig, w, h, wb, hb, 0, c16.data());
        dense_pad_plane<int16_t>(ref, w, h, wb, hb, DENSE_P, r16.data());
    }
    const int T = std::max(1, std::min((int)nthreads, hb));
    // raw pointers: the scratch vectors are thread_local, so helper
    // threads must receive the spawner's storage, not their own
    const int16_t* ctp = cur_t.data();
    const int16_t* lrp = lr_ref.data();
    const int16_t* chp = cur_ht.data();
    const int16_t* rhp = ref_h.data();
    const uint8_t* c8p = u8 ? c8.data() : nullptr;
    const uint8_t* r8p = u8 ? r8.data() : nullptr;
    const int16_t* c16p = u8 ? nullptr : c16.data();
    const int16_t* r16p = u8 ? nullptr : r16.data();
    auto rows = [=](int by0, int by1) {
        lowres_search_rows(ctp, lrp, wb, hb, B, by0, by1, out_seeds);
        halfres_refine_rows(chp, rhp, wb, hb, B2, by0, by1, out_seeds);
        if (u8)
            dense_search_rows<uint8_t>(c8p, r8p, wb, hb, out_seeds, by0,
                                       by1, out_dense, out_sad, out_surf);
        else
            dense_search_rows<int16_t>(c16p, r16p, wb, hb, out_seeds, by0,
                                       by1, out_dense, out_sad, out_surf);
    };
    if (T > 1) {
        // two barriers: dense reads seeds of its own rows only, so the
        // same row split can run both stages back to back per thread
        std::vector<std::thread> ts;
        for (int t = 0; t < T; t++)
            ts.emplace_back(rows, hb * t / T, hb * (t + 1) / T);
        for (auto& th : ts)
            th.join();
    } else {
        rows(0, hb);
    }
}

// install a device-computed dense full-pel ME field for list l
// (encode/device_analysis.py; exact dense_prepass values)
void tc_enc_install_dense(int32_t l, const int16_t* mv, int32_t wb,
                          int32_t hb) {
    en.seed_wb = wb;
    en.seed_hb = hb;
    en.dense_mv[l].assign(mv, mv + (size_t)hb * wb * 2);
    en.have_dense[l] = 1;
    en.have_surf[l] = 0;  // a surface must be re-installed alongside
    en.dense_external = 1;
}

// install the dense sweep's full SAD surface for list l ((hb*wb, 17*17)
// int32, tc_dense_analysis out_surf) — ONLY valid when the analysis ran
// against the true list-l ref-0 reconstruction (source-referenced
// analysis fields must not install a surface: their SADs differ from
// the probe SADs the search computes against the reconstruction)
void tc_enc_install_densesurf(int32_t l, const int32_t* surf, int32_t wb,
                              int32_t hb) {
    if (wb != en.seed_wb || hb != en.seed_hb || !en.have_dense[l])
        return;
    en.dense_surf[l].assign(surf,
                            surf + (size_t)hb * wb * DENSE_W * DENSE_W);
    en.have_surf[l] = 1;
}

// install one per-CU AQ layer: three (hn*wn) int32 maps of FULL QPs
// (luma + derived chroma, bd offsets included) at unit size ctb>>d;
// installing any layer turns the per-CU query on with depth max(d...)
void tc_enc_install_aqlayer(int32_t d, const int32_t* qy,
                            const int32_t* qcb, const int32_t* qcr,
                            int32_t wn, int32_t hn) {
    if (d < 0 || d > 3)
        return;
    const size_t n = (size_t)hn * wn;
    en.aq_qp[d][0].assign(qy, qy + n);
    en.aq_qp[d][1].assign(qcb, qcb + n);
    en.aq_qp[d][2].assign(qcr, qcr + n);
    en.aq_wn[d] = wn;
    if (d > en.aq_depth)
        en.aq_depth = d;
}

// ------------------------------------------------- picture contexts
// Concurrent-frame encoding (reference --concurrent-frames analogue,
// TaskEncodeInput.cpp:41-52): each in-flight picture gets its own
// (SP, EN) context; a Python worker thread binds one and every
// subsequent native call from that thread (setup, prepass install,
// encode, write) operates on it. Native helper threads inherit the
// spawner's binding by capture.
struct TcCtx {
    SP sp;
    EN enc;  // named 'enc': 'en' is the context-pointer macro
};

void* tc_ctx_new() {
    TcCtx* c = new TcCtx();
    return c;
}

void tc_ctx_bind(void* ctx) {
    if (ctx) {
        TcCtx* c = (TcCtx*)ctx;
        g_sp_ptr = &c->sp;
        g_en_ptr = &c->enc;
    } else {
        g_sp_ptr = &g_sp_default;
        g_en_ptr = &g_en_default;
    }
}

void tc_ctx_free(void* ctx) {
    delete (TcCtx*)ctx;
}

// SATD kernel self-test + cycle bench (havoc_test analogue): random
// 8-bit blocks, optimized-vs-template mismatch count and per-variant ns.
// out: [mismatches, ns_int32_path, ns_int16_path]
void tc_satd_selftest(int iters, int64_t* out) {
    uint64_t s = 0x123456789abcdefULL;
    auto rnd = [&]() {
        s = s * 6364136223846793005ULL + 1442695040888963407ULL;
        return (int)((s >> 33) & 255);
    };
    static int32_t a[64 * 72], b[64 * 72];
    for (int i = 0; i < 64 * 72; i++) {
        a[i] = rnd();
        b[i] = rnd();
    }
    out[0] = 0;
    int64_t acc32 = 0, acc16 = 0;
    const bool saved = g_satd_i16;
    for (int rep = 0; rep < 2; rep++) {
        for (int it = 0; it < iters; it++) {
            const int off = (it * 37) % (8 * 72);
            int64_t ref = satd_block_t<8>(a + off, b + off, 72, 72);
            g_satd_i16 = rep == 1;
            int64_t t0 = now_ns();
            int64_t got = 0;
            for (int k = 0; k < 16; k++)
                got += satd_block(a + off, b + off, 72, 72, 8);
            (rep ? acc16 : acc32) += now_ns() - t0;
            if (got != 16 * ref)
                out[0]++;
        }
    }
    g_satd_i16 = saved;
    out[1] = acc32;
    out[2] = acc16;
}

}  // extern "C"
