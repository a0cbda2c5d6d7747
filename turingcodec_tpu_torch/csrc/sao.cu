// The decoder's SAO filter, for Hopper (sm_90a).
//
// Replaces the XLA program turingcodec_tpu/ops/sao.py _sao_plane (:33-96),
// which sao_picture_device (:98) runs once per component, bit-exact for
// any int16 samples and bit depth 8..16: per sample, the band offset (band
// (p >> (bd - 5)) - class, mod 32, below 4 takes that offset) or the edge
// offset of the CTB's class (the sign remap of the two neighbours along the
// class's direction, used only where both lie in the picture and, in both
// directions, in the same slice or the slice allows filtering across, and
// in the same tile or the picture allows it), each clipped to
// [0, 2^bd - 1]; unchanged where the CTB's type is 0, its slice (per-slice
// enables, a negative index: disabled) does not enable SAO for the
// component, or the 4x4 skip map (PCM with the loop filter off, transquant
// bypass) holds the sample. The direction offsets and the remap are
// compiled in as immediates from ops/sao.py by ops/kernel_build.py.
//
// What bounds it. A 1080p 4:2:0 picture is 6.2 MB of int16 read once and
// written once, and its per-CTB maps and 4x4 skip map are under 0.2 MB:
// about 3.7 us at 3.35 TB/s. Bytes bound it.
//
// Design: one launch for F pictures (blockIdx.z) and one to three
// components of one geometry: component 0, and for a picture Cb and Cr at
// half its resolution, all on one CTB grid. A CTA owns component 0's
// 64x64 window at (64 bx, 64 by) and the others' 32x32 windows at
// (32 bx, 32 by): whole CTBs (at most 8 x 8 of them: CTBs of 8 samples or
// more), and the 4x4 skip blocks under them. It
//   1. issues every load at once: each window with a one-sample halo into
//      shared memory by cp.async (16 bytes where 8 samples lie inside the
//      row at a 16-byte address, 4 bytes for a halo pair, single samples
//      elsewhere), and into registers each component's type, class and
//      offsets of the window's CTBs, the slice and tile ids of those CTBs
//      and of their ring of neighbours, the window's skip bytes and, up to
//      kSlices slices, the per-slice enable and across flags;
//   2. derives once per CTB, not per sample, its 3x3 mask of the
//      neighbouring CTBs an edge offset may read (the same slice or the
//      CTB's slice filters across slices; the same tile or the picture
//      filters across tiles), and each component's effective type (0 where
//      its slice disables the component, or the type or edge class is
//      none): a sample's edge offset is valid where both neighbours lie in
//      the picture and the mask holds both neighbours' CTBs, which is
//      _sao_plane's per-sample rule (ops/sao.py sao_neighbour_mask is its
//      plain version, and a CPU test holds the two rules equal);
//   3. filters, a thread per 8 consecutive samples of a row, from shared
//      memory, and writes them with one 16-byte store (single samples at a
//      ragged edge or an unaligned row); type 0, a disabled slice and the
//      skipped blocks copy the staged samples through. An edge offset's
//      validity is a bitmask for the 8 samples, from the mask and the
//      picture's sides; its offset comes from a per-CTB table by the sum
//      of the two signs, the loop specialised on the class's horizontal
//      direction.
// Out of place: the neighbours must be read before SAO. The copy is the
// kernel's own read and write, so each sample is read from and written to
// device memory once. At 1080p the 510 CTAs (256 threads, 4 an SM) run in
// one wave, so nothing overlaps a CTA's loads with another's arithmetic:
// on an H100 the loads, derivations and barriers alone take about half
// the time, the filter's instructions most of the rest, and bytes do not
// bind it yet (PERF.md section 6). Staging a window in row bands, each
// filtered as its cp.async group arrived, ran slower; so did CTAs of 512
// or 768 threads at 1080p (fewer an SM: more than one wave).
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#if !defined(TC_SAO_EO_A) || !defined(TC_SAO_REMAP)
#error "SAO tables undefined: build with ops/kernel_build.py, which pre-includes them from ops/sao.py"
#endif

namespace {

constexpr int kT = 64;                 // component 0's window side
constexpr int kThreads = 256;
constexpr int kMaxComp = 3;
constexpr int kCtbs = 8;               // CTBs a window side, at most
constexpr int kCtbsSq = kCtbs * kCtbs;
constexpr int kRing = kCtbs + 2;       // with their neighbours
constexpr int kSkip = 32;              // skip bytes a window side, at most
constexpr int kSlices = 256;           // per-slice flags staged up to this
constexpr int kPad = 8;                // staged column of a window's x0
constexpr int kRows0 = kT + 2, kPitch0 = kT + 2 * kPad;
constexpr int kRows1 = kT / 2 + 2, kPitch1 = kT / 2 + 2 * kPad;
constexpr int kGroups0 = kT * (kT / 8);              // 8-sample groups
constexpr int kGroups1 = (kT / 2) * (kT / 16);
constexpr int kSkipPer = kSkip * kSkip / kThreads;   // skip bytes a thread
static_assert(kSlices == kThreads, "a slice's flags a thread");
static_assert(2 * kGroups1 == kThreads, "a chroma group a thread");

struct Plane {
    const int16_t* src;
    int16_t* dst;
    int h, w, ctb_log2, skip_log2, bd;
};

struct Params {
    Plane pl[kMaxComp];
    int n_comp;
    // per CTB (F, n_comp, hc, wc); offsets (F, n_comp, hc, wc, n_off)
    const int32_t* type;
    const int32_t* cls;
    const int32_t* off;
    // per CTB (F, hc, wc)
    const int32_t* slice;
    const int32_t* tile;
    // per slice: enable (F, n_comp, n_sl), across (F, n_sl)
    const uint8_t* enable;
    const uint8_t* across;
    // per picture, (F,); null: across_all for every picture
    const uint8_t* across_tiles;
    // per 4x4 luma block, (F, hs, ws)
    const uint8_t* skip;
    int hc, wc, n_off, n_sl, hs, ws, across_all;
};

struct Stage {
    // the windows: row r, column c is (y0 - 1 + r, x0 - kPad + c)
    int16_t t0[kRows0][kPitch0];
    int16_t t1[2][kRows1][kPitch1];
    // the band offsets, and the edge offsets by sign sum + 2 (5 used)
    int32_t off[kMaxComp][kCtbsSq][4];
    int32_t eo[kMaxComp][kCtbsSq][8];
    // the CTBs (cy0 - 1 + r, cx0 - 1 + c)
    int32_t slice[kRing][kRing];
    int32_t tile[kRing][kRing];
    // per CTB of the window: the 3x3 mask, bit (dy + 1) * 3 + dx + 1
    uint16_t mask[kCtbsSq];
    int8_t type[kMaxComp][kCtbsSq];   // effective: 0 none, 1 band, 2 edge
    int8_t cls[kMaxComp][kCtbsSq];
    uint8_t skip[kSkip][kSkip];
    uint8_t across[kSlices];
    uint8_t enable[kMaxComp][kSlices];
};

union Row8 {
    int4 v;
    int16_t s[8];
};

__device__ inline bool aligned(const void* p, uintptr_t a) {
    return (reinterpret_cast<uintptr_t>(p) & (a - 1)) == 0;
}

__device__ inline void cp_async16(void* sdst, const void* gsrc) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"((uint32_t)__cvta_generic_to_shared(sdst)),
                    "l"(gsrc) : "memory");
}

__device__ inline void cp_async4(void* sdst, const void* gsrc) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"((uint32_t)__cvta_generic_to_shared(sdst)),
                    "l"(gsrc) : "memory");
}

__device__ inline int clip(int v, int hi) { return min(max(v, 0), hi); }

__device__ inline int sgn(int v) { return (v > 0) - (v < 0); }

template <int V>
struct Const {
    static constexpr int value = V;
};

// What every thread of a CTA knows of its window: the CTB grid cell of its
// first CTB and the log2 of its CTBs a side (the window is aligned to CTBs
// of up to 64 samples, so it holds 2^ncl x 2^ncl of them, or lies in one),
// and the first skip byte.
struct Window {
    int f, bx, by, cy0, cx0, ncl, sy0, sx0;
};

// Component c's window (T samples a side) and its one-sample halo into the
// staged tile t: rows y0 - 1 .. y0 + T, 8 samples a copy from x0, then the
// pairs x0 - 2, x0 - 1 and x0 + T, x0 + T + 1; all by cp.async where the
// address allows, else a sample at a time.
template <int T>
__device__ void stage_window(const Plane& q, int16_t* t, const Window& wn) {
    constexpr int pitch = T + 2 * kPad, per_row = T / 8 + 2;
    const int x0 = wn.bx * T, y0 = wn.by * T;
    if (x0 >= q.w || y0 >= q.h) return;   // past this plane
    const int16_t* src = q.src + (size_t)wn.f * q.h * q.w;
    for (int i = threadIdx.x; i < (T + 2) * per_row; i += kThreads) {
        const int r = i / per_row, j = i - r * per_row;
        const int y = y0 - 1 + r;
        if (y < 0 || y >= q.h) continue;
        const int16_t* row = src + (size_t)y * q.w;
        int16_t* srow = t + r * pitch;
        int x, col, n;
        if (j < T / 8) {            // 8 samples from x0 + 8 j
            x = x0 + 8 * j;
            col = kPad + 8 * j;
            n = min(8, q.w - x);
            if (n == 8 && aligned(row + x, 16)) {
                cp_async16(srow + col, row + x);
                continue;
            }
        } else if (j == T / 8) {    // x0 - 1, with x0 - 2 as a pair
            x = x0 - 2;
            col = kPad - 2;
            n = 2;
            if (x < 0) {
                x = x0 - 1;
                col = kPad - 1;
                n = 1;
            }
        } else {                    // x0 + T, with x0 + T + 1
            x = x0 + T;
            col = kPad + T;
            n = min(2, q.w - x);
        }
        if (n <= 0 || x < 0) continue;
        if (n == 2 && aligned(row + x, 4)) {
            cp_async4(srow + col, row + x);
            continue;
        }
        for (int k = 0; k < n; ++k) srow[col + k] = row[x + k];
    }
}

// The 8 samples from (x, y) = (bx T + 8 g, by T + row) of component c,
// filtered from the staged tile t into dst (the picture's plane).
template <int T>
__device__ void filter_group(const Plane& q, int16_t* dst, const int16_t* t,
                             const Stage& s, int c, const Window& wn,
                             int row, int g) {
    constexpr int eo_a[4][2] = {TC_SAO_EO_A};
    constexpr int pitch = T + 2 * kPad;
    const int y = wn.by * T + row, x = wn.bx * T + 8 * g;
    if (y >= q.h || x >= q.w) return;
    const int16_t* tr = t + (row + 1) * pitch + kPad + 8 * g;
    Row8 cur;
    cur.v = *reinterpret_cast<const int4*>(tr);
    Row8 out = cur;
    const int l = q.ctb_log2;
    const int cy = y >> l;
    const int k = ((cy - wn.cy0) << wn.ncl) | ((x >> l) - wn.cx0);
    const int type = s.type[c][k];
    if (type) {
        const int max_val = (1 << q.bd) - 1;
        const int cls = s.cls[c][k];
        const int4 o4 = *reinterpret_cast<const int4*>(s.off[c][k]);
        // the skipped samples, a bit each (a skip byte covers 2^sl of
        // them; x is a multiple of 8)
        const int sl = q.skip_log2, span = 1 << sl;
        const uint8_t* sk = s.skip[(y >> sl) - wn.sy0] + ((x >> sl) - wn.sx0);
        unsigned skipped = 0;
        for (int i = 0; i < 8; i += span)
            if (sk[i >> sl]) skipped |= ((1u << span) - 1) << i;
        if (type == 1) {
            const int shift = q.bd - 5;
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                const int p = cur.s[i];
                const int idx = ((p >> shift) - cls) & 31;
                const int o = idx == 0 ? o4.x : idx == 1 ? o4.y
                              : idx == 2 ? o4.z : idx == 3 ? o4.w : 0;
                const int v = clip(p + o, max_val);
                if (!((skipped >> i) & 1)) out.s[i] = (int16_t)v;
            }
        } else {
            int dy = 0, dx = 0;
#pragma unroll
            for (int e = 0; e < 4; ++e)
                if (cls == e) {
                    dy = eo_a[e][0];
                    dx = eo_a[e][1];
                }
            // the rows of neighbours a (y + dy) and b (y - dy), x - 1 to
            // x + 8
            const int16_t* ta = tr + dy * pitch;
            const int16_t* tb = tr - dy * pitch;
            Row8 ra, rb;
            ra.v = *reinterpret_cast<const int4*>(ta);
            rb.v = *reinterpret_cast<const int4*>(tb);
            const int a_l = ta[-1], a_r = ta[8], b_l = tb[-1], b_r = tb[8];
            // which samples may read both neighbours, a bit each: the
            // mask's bit of a neighbour's CTB; samples 1..6 read theirs in
            // their own CTB column, sample 0's x - 1 and sample 7's x + 8
            // lie a column over where x or x + 8 starts a CTB
            const int ya = y + dy, yb = y - dy;
            unsigned valid = 0;
            if (ya >= 0 && ya < q.h && yb >= 0 && yb < q.h) {
                const unsigned m = s.mask[k];
                const int ba = ((ya >> l) - cy + 1) * 3 + 1;
                const int bb = ((yb >> l) - cy + 1) * 3 + 1;
                const int ctb_m = (1 << l) - 1;
                const int dl = (x & ctb_m) == 0 ? -1 : 0;
                const int dr = ((x + 8) & ctb_m) == 0 ? 1 : 0;
                valid = ((m >> ba) & (m >> bb) & 1u) ? 0x7eu : 0u;
                valid |= (m >> (ba + (dx < 0 ? dl : 0)))
                         & (m >> (bb + (dx > 0 ? dl : 0))) & 1u;
                valid |= ((m >> (ba + (dx > 0 ? dr : 0)))
                          & (m >> (bb + (dx < 0 ? dr : 0))) & 1u) << 7;
                if (dx != 0) {
                    if (x == 0) valid &= ~1u;   // x - 1 outside
                    const int n = q.w - 1 - x;  // samples whose x + 1 is in
                    if (n < 8) valid &= (1u << max(n, 0)) - 1;
                }
            }
            valid &= ~skipped;
            // per sample the sign sum's offset, a's and b's samples
            // along the class's horizontal direction
            const int32_t* eo = s.eo[c][k] + 2;
            auto run = [&](auto dxc) {
                constexpr int DX = decltype(dxc)::value;
                int av[10], bv[10];
                av[0] = a_l;
                av[9] = a_r;
                bv[0] = b_l;
                bv[9] = b_r;
#pragma unroll
                for (int i = 0; i < 8; ++i) {
                    av[i + 1] = ra.s[i];
                    bv[i + 1] = rb.s[i];
                }
#pragma unroll
                for (int i = 0; i < 8; ++i) {
                    const int p = cur.s[i];
                    const int sg = sgn(p - av[1 + i + DX])
                                   + sgn(p - bv[1 + i - DX]);
                    const int v = clip(p + eo[sg], max_val);
                    if ((valid >> i) & 1) out.s[i] = (int16_t)v;
                }
            };
            if (dx < 0)
                run(Const<-1>());
            else if (dx > 0)
                run(Const<1>());
            else
                run(Const<0>());
        }
    }
    int16_t* d = dst + (size_t)y * q.w + x;
    if (x + 8 <= q.w && aligned(d, 16)) {
        *reinterpret_cast<int4*>(d) = out.v;
    } else {
        const int n = min(8, q.w - x);
#pragma unroll
        for (int i = 0; i < 8; ++i)
            if (i < n) d[i] = out.s[i];
    }
}

__global__ void __launch_bounds__(kThreads, 4)
sao_kernel(const __grid_constant__ Params P) {
    __shared__ __align__(16) Stage s;
    const int tid = threadIdx.x;
    Window wn;
    wn.f = blockIdx.z;
    wn.bx = blockIdx.x;
    wn.by = blockIdx.y;
    const int f = wn.f;
    const int l0 = P.pl[0].ctb_log2;
    wn.ncl = max(0, 6 - l0);
    wn.cy0 = (wn.by * kT) >> l0;
    wn.cx0 = (wn.bx * kT) >> l0;
    const int ncx = 1 << wn.ncl, nctb = ncx * ncx;
    // the window's skip bytes, the same for every component: S = 2^ss a
    // side
    const int ss = 6 - P.pl[0].skip_log2, S = 1 << ss;
    wn.sy0 = wn.by * S;
    wn.sx0 = wn.bx * S;
    const bool flags_staged = P.n_sl <= kSlices;

    // 1. the windows in, by cp.async
    stage_window<kT>(P.pl[0], &s.t0[0][0], wn);
    if (P.n_comp > 1) {
        stage_window<kT / 2>(P.pl[1], &s.t1[0][0][0], wn);
        stage_window<kT / 2>(P.pl[2], &s.t1[1][0][0], wn);
    }

    // the window's CTB parameters, a (component, CTB) a thread, kept in
    // registers until the per-slice flags are staged
    const int pc = tid >> (2 * wn.ncl), pk = tid & (nctb - 1);
    const bool has_param = pc < P.n_comp;
    const int pcy = wn.cy0 + (pk >> wn.ncl), pcx = wn.cx0 + (pk & (ncx - 1));
    int r_type = 0, r_cls = 0, r_slice = -1;
    int4 r_off = make_int4(0, 0, 0, 0);
    if (has_param && pcy < P.hc && pcx < P.wc) {
        const size_t ci = ((size_t)(f * P.n_comp + pc) * P.hc + pcy) * P.wc
                          + pcx;
        r_type = __ldg(P.type + ci);
        r_cls = __ldg(P.cls + ci);
        r_slice = __ldg(P.slice + ((size_t)f * P.hc + pcy) * P.wc + pcx);
        const int32_t* o = P.off + ci * P.n_off;
        if (P.n_off == 4 && aligned(o, 16))
            r_off = __ldg(reinterpret_cast<const int4*>(o));
        else
            r_off = make_int4(__ldg(o), __ldg(o + 1), __ldg(o + 2),
                              __ldg(o + 3));
    }
    // the slice and tile ids of the window's CTBs and their ring, a 16 x
    // 16 grid of threads over the (ncx + 2)^2 of them
    const int ry = tid >> 4, rx = tid & 15;
    const bool has_ring = ry < ncx + 2 && rx < ncx + 2;
    const int rcy = wn.cy0 - 1 + ry, rcx = wn.cx0 - 1 + rx;
    int r_rs = 0, r_rt = 0;
    if (has_ring && rcy >= 0 && rcy < P.hc && rcx >= 0 && rcx < P.wc) {
        const size_t i = ((size_t)f * P.hc + rcy) * P.wc + rcx;
        r_rs = __ldg(P.slice + i);
        r_rt = __ldg(P.tile + i);
    }
    // the skip bytes of the window's S x S blocks
    uint8_t r_skip[kSkipPer];
#pragma unroll
    for (int k = 0; k < kSkipPer; ++k) {
        const int i = tid + k * kThreads;
        const int yy = wn.sy0 + (i >> ss), xx = wn.sx0 + (i & (S - 1));
        r_skip[k] = i < S * S && yy < P.hs && xx < P.ws
                    ? __ldg(P.skip + ((size_t)f * P.hs + yy) * P.ws + xx) : 0;
    }
    // the per-slice across flag and each component's enable, a slice a
    // thread
    const bool has_flag = flags_staged && tid < P.n_sl;
    uint8_t r_across = 0, r_en[kMaxComp] = {0, 0, 0};
    if (has_flag) {
        r_across = __ldg(P.across + (size_t)f * P.n_sl + tid);
#pragma unroll
        for (int c = 0; c < kMaxComp; ++c)
            if (c < P.n_comp)
                r_en[c] = __ldg(P.enable + ((size_t)f * P.n_comp + c)
                                               * P.n_sl + tid);
    }
    if (has_ring) {
        s.slice[ry][rx] = r_rs;
        s.tile[ry][rx] = r_rt;
    }
#pragma unroll
    for (int k = 0; k < kSkipPer; ++k) {
        const int i = tid + k * kThreads;
        if (i < S * S) s.skip[i >> ss][i & (S - 1)] = r_skip[k];
    }
    if (has_flag) {
        s.across[tid] = r_across;
#pragma unroll
        for (int c = 0; c < kMaxComp; ++c) s.enable[c][tid] = r_en[c];
    }
    __syncthreads();

    // 2. once per CTB: each component's effective type, and the mask
    const int n_sl1 = P.n_sl - 1;
    if (has_param) {
        const int sl = min(max(r_slice, 0), n_sl1);
        const bool enabled =
            r_slice >= 0
            && (flags_staged ? s.enable[pc][sl]
                             : __ldg(P.enable + ((size_t)f * P.n_comp + pc)
                                                    * P.n_sl + sl)) != 0;
        int t = 0;
        if (enabled && r_type == 1) t = 1;
        if (enabled && r_type == 2 && r_cls >= 0 && r_cls < 4) t = 2;
        s.type[pc][pk] = (int8_t)t;
        s.cls[pc][pk] = (int8_t)(t == 1 ? r_cls & 31 : r_cls & 3);
        *reinterpret_cast<int4*>(s.off[pc][pk]) = r_off;
        constexpr int remap[5] = {TC_SAO_REMAP};
        auto off_of = [&](int e) {
            return e == 1 ? r_off.x : e == 2 ? r_off.y : e == 3 ? r_off.z
                   : e == 4 ? r_off.w : 0;
        };
#pragma unroll
        for (int j = 0; j < 5; ++j) s.eo[pc][pk][j] = off_of(remap[j]);
    }
    if (tid < nctb) {
        const int ky = tid >> wn.ncl, kx = tid & (ncx - 1);
        const int cur = s.slice[ky + 1][kx + 1], tl = s.tile[ky + 1][kx + 1];
        const int sl = min(max(cur, 0), n_sl1);
        const bool allowed =
            cur < 0 || (flags_staged ? s.across[sl]
                                     : __ldg(P.across + (size_t)f * P.n_sl
                                             + sl)) != 0;
        const bool across_tiles = P.across_tiles ? P.across_tiles[f] != 0
                                                 : P.across_all != 0;
        unsigned m = 0;
#pragma unroll
        for (int dy = -1; dy <= 1; ++dy) {
#pragma unroll
            for (int dx = -1; dx <= 1; ++dx) {
                const int ny = wn.cy0 + ky + dy, nx = wn.cx0 + kx + dx;
                const int ns = s.slice[ky + 1 + dy][kx + 1 + dx];
                const int nt = s.tile[ky + 1 + dy][kx + 1 + dx];
                const bool ok = ny >= 0 && ny < P.hc && nx >= 0 && nx < P.wc
                                && (ns == cur || allowed)
                                && (across_tiles || nt == tl);
                m |= (unsigned)ok << ((dy + 1) * 3 + dx + 1);
            }
        }
        s.mask[tid] = (uint16_t)m;
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();

    // 3. a thread per 8 samples of a row: filtered from shared memory, out
    // with one 16-byte store; component 0's 64 rows of 8 groups, then the
    // others' 32 rows of 4
    {
        const Plane& q = P.pl[0];
        int16_t* dst = q.dst + (size_t)f * q.h * q.w;
        for (int j = tid; j < kGroups0; j += kThreads)
            filter_group<kT>(q, dst, &s.t0[0][0], s, 0, wn, j >> 3, j & 7);
    }
    if (P.n_comp > 1) {
        const int c = 1 + tid / kGroups1, j = tid % kGroups1;
        const Plane& q = P.pl[1];   // Cb and Cr share every size
        int16_t* dst = (c == 1 ? q.dst : P.pl[2].dst)
                       + (size_t)f * q.h * q.w;
        filter_group<kT / 2>(q, dst, &s.t1[c - 1][0][0], s, c, wn, j >> 2,
                             j & 3);
    }
}

}  // namespace

// n_comp (1 or 3) components of F pictures: src[c] and dst[c] (F, h, w)
// int16, contiguous on the device, distinct; dims[5 c ..] is component
// c's (h, w, ctb_log2, skip_log2, bd). Every CTB is 8 samples a side or
// more, component 0's 128 at most, the others' half as large as its, on
// the same (hc, wc)
// grid (hc = ceil(h / 2^ctb_log2) for every component, wc likewise), and
// every component's skip_log2 maps the same window of the (hs, ws) skip
// map (hs = ceil(h / 2^skip_log2)): component 0 at 2 (4x4 blocks) or 1,
// the others one less. The per-CTB maps (F, n_comp, hc, wc) int32, the
// offsets (F, n_comp, hc, wc, n_off >= 4) int32, slice and tile
// (F, hc, wc) int32; the per-slice enables (F, n_comp, n_sl) and across
// flags (F, n_sl) bool, n_sl >= 1; across_tiles (F,) bool or null for
// across_all; the skip map (F, hs, ws) bool. Launches once on `stream`
// and returns cudaGetLastError() (0 on success), or cudaErrorInvalidValue
// for a bit depth outside 8..16 or sizes it does not take; never
// synchronises.
extern "C" int sao_launch(int n_comp, const void* const* src,
                          void* const* dst, const int* dims, int frames,
                          const void* type, const void* cls, const void* off,
                          int n_off, const void* slice, const void* tile,
                          int hc, int wc, const void* enable,
                          const void* across, int n_sl,
                          const void* across_tiles, int across_all,
                          const void* skip, int hs, int ws, void* stream) {
    if ((n_comp != 1 && n_comp != kMaxComp) || frames < 1 || frames > 65535
        || n_sl < 1 || n_off < 4 || hc < 1 || wc < 1 || hs < 1 || ws < 1)
        return (int)cudaErrorInvalidValue;
    Params P{};
    const int l0 = dims[2], sl0 = dims[3];
    if (l0 < 3 || l0 > 7 || sl0 < 1 || sl0 > 2)
        return (int)cudaErrorInvalidValue;
    int gx = 1, gy = 1;
    for (int c = 0; c < n_comp; ++c) {
        const int h = dims[5 * c], w = dims[5 * c + 1], l = dims[5 * c + 2];
        const int sl = dims[5 * c + 3], bd = dims[5 * c + 4];
        const int T = c ? kT / 2 : kT, shift = c ? 1 : 0;
        if (h < 1 || w < 1 || bd < 8 || bd > 16 || l != l0 - shift || l < 3
            || sl != sl0 - shift || ((h - 1) >> l) + 1 != hc
            || ((w - 1) >> l) + 1 != wc || ((h - 1) >> sl) + 1 != hs
            || ((w - 1) >> sl) + 1 != ws || src[c] == nullptr
            || dst[c] == nullptr)
            return (int)cudaErrorInvalidValue;
        if (c == 2 && (h != dims[5] || w != dims[6] || bd != dims[9]))
            return (int)cudaErrorInvalidValue;   // Cr sized as Cb
        P.pl[c] = Plane{(const int16_t*)src[c], (int16_t*)dst[c], h, w, l,
                        sl, bd};
        gx = max(gx, (w + T - 1) / T);
        gy = max(gy, (h + T - 1) / T);
    }
    P.n_comp = n_comp;
    P.type = (const int32_t*)type;
    P.cls = (const int32_t*)cls;
    P.off = (const int32_t*)off;
    P.slice = (const int32_t*)slice;
    P.tile = (const int32_t*)tile;
    P.enable = (const uint8_t*)enable;
    P.across = (const uint8_t*)across;
    P.across_tiles = (const uint8_t*)across_tiles;
    P.skip = (const uint8_t*)skip;
    P.hc = hc;
    P.wc = wc;
    P.n_off = n_off;
    P.n_sl = n_sl;
    P.hs = hs;
    P.ws = ws;
    P.across_all = across_all;
    sao_kernel<<<dim3(gx, gy, frames), kThreads, 0, (cudaStream_t)stream>>>(
        P);
    return (int)cudaGetLastError();
}

// The kernel's resources on the current device: out[0] registers a
// thread, [1] local (spilled) bytes a thread, [2] shared bytes a CTA,
// [3] CTAs an SM, [4] threads a CTA, [5] CTAs a 1920x1080 picture
// launches. Returns a CUDA error code (0 on success).
extern "C" int sao_occupancy(int* out) {
    cudaFuncAttributes a;
    cudaError_t e = cudaFuncGetAttributes(&a, sao_kernel);
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[3], sao_kernel,
                                                          kThreads, 0);
    if (e != cudaSuccess) return (int)e;
    out[0] = a.numRegs;
    out[1] = (int)a.localSizeBytes;
    out[2] = (int)a.sharedSizeBytes;
    out[4] = kThreads;
    out[5] = ((1920 + kT - 1) / kT) * ((1080 + kT - 1) / kT);
    return 0;
}
