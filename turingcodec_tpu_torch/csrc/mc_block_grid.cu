// Fractional motion compensation for Hopper (sm_90a): two kernels over one
// filter.
//
// mc_block_grid_kernel replaces the XLA program turingcodec_tpu/ops/inter.py
// mc_block_grid (its int32 einsums, :96-104). Every 4x4 luma (2x2 chroma)
// min-block b of a picture carries, per reference list l, its PU's motion: a
// reference index sel[l][b], the integer top-left sample (xi[l][b],
// yi[l][b]) and the fractional phase (xf[l][b], yf[l][b]). For each list and
// component the kernel reads the (bs + taps - 1)^2 window of reference plane
// sel[l][b] around it with every coordinate clamped into the plane (the
// spec's edge extension), then runs the separable 8-tap luma or 4-tap chroma
// filter and writes the 14-bit intermediate prediction with the spec's four
// phase cases:
//   full-pel:  ref << (14 - bd)
//   H only:    sum_k win * fh >> (bd - 8)
//   V only:    sum_k win * fv >> (bd - 8)
//   2-D:       sum_k (H pass >> (bd - 8)) * fv >> 6.
// All sums are exact in int32. The filter table comes in from the wrapper
// (hevc/tables.py LUMA_FILTER / CHROMA_FILTER).
//
// What bounds it on this card. The largest call of a 1080p P picture covers
// B = 87,168 luma blocks per list: one list writes 5.6 MB of int32, reads
// 1.7 MB of motion and about 4 MB of reference plane (the windows overlap,
// so the rest are cache hits), 11.3 MB or 3.4 us at 3.35 TB/s; its 42 M
// multiply-adds are 2.5 us of INT32 issue. The bytes bound it. The encoder's
// low-delay pictures are B slices whose blocks use both lists, each list
// holding the same picture: a picture writes and reads motion twice but reads
// its one reference plane once, 18.7 MB or 5.6 us. The first design staged every window in shared memory
// as int32 (7.6 times the samples it writes), reloaded the motion for every
// window element behind divides by 11 and 121, ran three phases behind
// __syncthreads at 16 blocks per CTA, and took one launch per list and
// component.
//
// Design. One thread per block: it loads its motion once into registers,
// clamps the window's columns once, and walks the window a row at a time,
// reading the int16 samples of the row into registers (a register window),
// running the horizontal pass of that row once and adding its products into
// the bs x bs vertical sums, so nothing is staged and nothing is divided. A
// full-pel block only reads its bs x bs samples, an H-only block only its bs
// rows. The output block goes out in 16-byte stores. Reference planes come
// through a table of plane addresses passed by value (no stack of the
// planes is copied), one row of the table per (list, component) group; the
// groups are the grid's second dimension, so one launch covers both lists,
// and Cb with Cr.
//
// mc_picture_kernel is the decoder pipeline's whole MC stage in one launch.
// It replaces the host glue of turingcodec_tpu/decode/device_pipeline.py
// _mc_device (:73) as the port ran it: np.nonzero over the picture's
// min-blocks, the per-block motion gathered, stacked and uploaded, two
// mc_block_grid launches into int32 (L, C, B, bs, bs) arrays, the default
// weighted combine (turingcodec_tpu/decode/device_recon.py _combine_uni_bi,
// :29) as a dozen torch launches a component, and three index_put scatters
// (device_pipeline.py _scatter_blocks, :54). That chain held about 13 ms of
// host time a 1080p picture around a 10 us kernel. Here the kernel reads
// the plan's dense maps (the inter mask, ref_idx and mv as the parser holds
// them), leaves a block that is not inter untouched, runs the filter above
// (the same device function) for each list a block uses, combines
// (8.5.3.3.4.2: bi (p0 + p1 + 2^(14-bd)) >> (15-bd), uni (p + 2^(13-bd))
// >> (14-bd)), clips to the bit depth and stores int16 rows into the
// picture's plane; no intermediate goes to memory. What bounds it: a 1080p
// B picture reads 1.4 MB of maps and each referenced picture once (3.1 MB
// of planes), writes up to 6.2 MB of samples, and needs about 480
// multiply-adds a luma block and list in the 2-D case, so its bytes and its
// INT32 issue are both some 6 us. What holds it: each thread walks its
// window's 11 (luma) or 5 (chroma) rows one after another, each row a
// round trip to L2, so resident warps are what hide the latency. Two lanes
// of a warp take a block's two lists (a thread's chain is one list's
// window, and a list's lane is idle where the block does not use it), add
// the predictions through a shuffle and store half the rows each; the
// launch is capped at 64 registers for 8 CTAs an SM. Against one thread a
// block walking both lists (110 registers, 4 CTAs), that took 42.4 us for
// 55.3 on a synthetic 1080p picture past L2 (H100 SXM, 700 W); an L2 or L1
// prefetch of the window rows gained nothing.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxGroups = 4;    // lists x components
constexpr int kMaxPlanes = 64;   // lists x components x references
constexpr int kMaxRefs = 16;     // references an HEVC list holds

struct PlaneTable {
    const int16_t* p[kMaxPlanes];
    int first[kMaxGroups];       // a group's first plane in p
    int count[kMaxGroups];       // its references
};

// Both lists' reference pictures for mc_picture_kernel, by value.
struct PictureRefs {
    const int16_t* p[2][kMaxRefs][3];   // [list][reference][component]
    int count[2];                        // each list's references
};

// The 14-bit intermediate prediction of one bs x bs block whose integer
// top-left sample is (xi, yi) in the (H, W) plane `ref`, at phase (fx, fy),
// into v: the register-window separable filter with the four phase cases.
template <int BS, int TAPS>
__device__ __forceinline__ void predict_block(
    const int16_t* __restrict__ ref, int H, int W, int xi, int yi, int fx,
    int fy, const int32_t* __restrict__ filt, int shift1, int shift3,
    int (&v)[BS * BS]) {
    constexpr int SPAN = BS + TAPS - 1;
    constexpr int OFF = TAPS / 2 - 1;
    const int x0 = xi - OFF;
    const int y0 = yi - OFF;

    int col[SPAN];
#pragma unroll
    for (int k = 0; k < SPAN; ++k) col[k] = min(max(x0 + k, 0), W - 1);
    auto row_at = [&](int r) {
        return ref + (size_t)min(max(y0 + r, 0), H - 1) * W;
    };

    if (fx == 0 && fy == 0) {
#pragma unroll
        for (int y = 0; y < BS; ++y) {
            const int16_t* row = row_at(OFF + y);
#pragma unroll
            for (int x = 0; x < BS; ++x)
                v[y * BS + x] = (int)row[col[OFF + x]] << shift3;
        }
    } else if (fy == 0) {
        int fh[TAPS];
#pragma unroll
        for (int k = 0; k < TAPS; ++k) fh[k] = __ldg(filt + fx * TAPS + k);
#pragma unroll
        for (int y = 0; y < BS; ++y) {
            const int16_t* row = row_at(OFF + y);
            int w[SPAN];
#pragma unroll
            for (int k = 0; k < SPAN; ++k) w[k] = row[col[k]];
#pragma unroll
            for (int x = 0; x < BS; ++x) {
                int acc = 0;
#pragma unroll
                for (int k = 0; k < TAPS; ++k) acc += w[x + k] * fh[k];
                v[y * BS + x] = acc >> shift1;
            }
        }
    } else {
        // V only (fx == 0) or 2-D: walk the window's rows once, each row's
        // horizontal pass (or its centre samples) feeding every output row
        // whose vertical taps reach it
        int fh[TAPS], fv[TAPS];
#pragma unroll
        for (int k = 0; k < TAPS; ++k) {
            fh[k] = __ldg(filt + fx * TAPS + k);
            fv[k] = __ldg(filt + fy * TAPS + k);
        }
        const bool h_pass = fx != 0;
#pragma unroll
        for (int i = 0; i < BS * BS; ++i) v[i] = 0;
#pragma unroll
        for (int r = 0; r < SPAN; ++r) {
            const int16_t* row = row_at(r);
            int hr[BS];
            if (h_pass) {
                int w[SPAN];
#pragma unroll
                for (int k = 0; k < SPAN; ++k) w[k] = row[col[k]];
#pragma unroll
                for (int x = 0; x < BS; ++x) {
                    int acc = 0;
#pragma unroll
                    for (int k = 0; k < TAPS; ++k) acc += w[x + k] * fh[k];
                    hr[x] = acc >> shift1;
                }
            } else {
#pragma unroll
                for (int x = 0; x < BS; ++x) hr[x] = row[col[OFF + x]];
            }
#pragma unroll
            for (int y = 0; y < BS; ++y) {
                if (r - y >= 0 && r - y < TAPS) {
#pragma unroll
                    for (int x = 0; x < BS; ++x)
                        v[y * BS + x] += hr[x] * fv[r - y];
                }
            }
        }
        const int sh = h_pass ? 6 : shift1;
#pragma unroll
        for (int i = 0; i < BS * BS; ++i) v[i] >>= sh;
    }
}

template <int BS, int TAPS>
__global__ void __launch_bounds__(kThreads)
mc_block_grid_kernel(PlaneTable tab, int C, int H, int W,
                     const int32_t* __restrict__ sel,
                     const int32_t* __restrict__ xi,
                     const int32_t* __restrict__ yi,
                     const int32_t* __restrict__ xf,
                     const int32_t* __restrict__ yf,
                     const int32_t* __restrict__ filt, int B, int shift1,
                     int shift3, int32_t* __restrict__ out) {
    constexpr int PHASES = TAPS == 8 ? 4 : 8;
    const int b = blockIdx.x * kThreads + threadIdx.x;
    if (b >= B) return;
    const int g = blockIdx.y;               // (list, component) group
    const size_t m = (size_t)(g / C) * B + b;  // the list's motion of b
    const int16_t* __restrict__ ref =
        tab.p[tab.first[g] + min(max(sel[m], 0), tab.count[g] - 1)];
    int v[BS * BS];
    predict_block<BS, TAPS>(ref, H, W, xi[m], yi[m],
                            min(max(xf[m], 0), PHASES - 1),
                            min(max(yf[m], 0), PHASES - 1), filt, shift1,
                            shift3, v);

    int4* o = reinterpret_cast<int4*>(out + ((size_t)g * B + b) * BS * BS);
#pragma unroll
    for (int q = 0; q < BS * BS / 4; ++q)
        o[q] = make_int4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
}

template <int BS, int TAPS>
void launch(const PlaneTable& tab, int G, int C, int H, int W,
            const int32_t* sel, const int32_t* xi, const int32_t* yi,
            const int32_t* xf, const int32_t* yf, const int32_t* filt, int B,
            int bit_depth, int32_t* out, cudaStream_t stream) {
    const dim3 grid((unsigned)((B + kThreads - 1) / kThreads), (unsigned)G);
    mc_block_grid_kernel<BS, TAPS><<<grid, kThreads, 0, stream>>>(
        tab, C, H, W, sel, xi, yi, xf, yf, filt, B, bit_depth - 8,
        14 - bit_depth, out);
}

// List l's share of min-block b = (by, bx) of component c (bs x bs
// samples of the (H, W) plane `out`): the lanes 2k and 2k + 1 of a warp
// hold block k's list 0 and list 1, each predicts from its list where the
// block is inter and its ref_idx is >= 0, the pair adds the two through a
// shuffle, and each lane combines, clips and stores half the rows. A block
// neither lane predicts is left untouched. Every lane of the warp takes
// part in the shuffles (live is false past the picture's last block).
template <int BS, int TAPS>
__device__ __forceinline__ void mc_picture_block(
    const PictureRefs& refs, int c, int b, int l, bool live, int n, int by,
    int bx, int H, int W, const uint8_t* __restrict__ inter,
    const int8_t* __restrict__ ref_idx, const int32_t* __restrict__ mv,
    const int32_t* __restrict__ filt, int bd, int16_t* __restrict__ out) {
    constexpr int PHASES = TAPS == 8 ? 4 : 8;
    constexpr int MV_SHIFT = TAPS == 8 ? 2 : 3;  // 1/4 luma, 1/8 4:2:0 chroma
    int v[BS * BS];
    bool on = false;
    if (live && inter[b]) {
        const int r = ref_idx[(size_t)l * n + b];
        if (r >= 0 && refs.count[l] > 0) {
            on = true;
            // (mvx, mvy) as the plan holds them: two int16, x first
            const int m = mv[(size_t)l * n + b];
            const int mvx = (int)(int16_t)(m & 0xffff);
            const int mvy = m >> 16;
            predict_block<BS, TAPS>(
                refs.p[l][min(r, refs.count[l] - 1)][c], H, W,
                bx * BS + (mvx >> MV_SHIFT), by * BS + (mvy >> MV_SHIFT),
                mvx & (PHASES - 1), mvy & (PHASES - 1), filt, bd - 8,
                14 - bd, v);
        }
    }
    if (!on) {
#pragma unroll
        for (int i = 0; i < BS * BS; ++i) v[i] = 0;
    }
    const int lists = (int)on + __shfl_xor_sync(0xffffffffu, (int)on, 1);
#pragma unroll
    for (int i = 0; i < BS * BS; ++i)
        v[i] += __shfl_xor_sync(0xffffffffu, v[i], 1);
    if (!live || !lists) return;
    const int shift = 13 - bd + lists;   // uni 14 - bd, bi 15 - bd
    const int round = 1 << (shift - 1);
    const int top = (1 << bd) - 1;
#pragma unroll
    for (int h = 0; h < BS / 2; ++h) {
        const int y = l * (BS / 2) + h;
        uint32_t q[BS / 2];
#pragma unroll
        for (int x = 0; x < BS; x += 2) {
            const int a = min(max((v[y * BS + x] + round) >> shift, 0), top);
            const int e =
                min(max((v[y * BS + x + 1] + round) >> shift, 0), top);
            q[x / 2] = (uint32_t)(uint16_t)a | ((uint32_t)(uint16_t)e << 16);
        }
        int16_t* row = out + (size_t)(by * BS + y) * W + bx * BS;
        if constexpr (BS == 4)
            *reinterpret_cast<uint2*>(row) = make_uint2(q[0], q[1]);
        else
            *reinterpret_cast<uint32_t*>(row) = q[0];
    }
}

// Two threads a min-block (one a list), the grid's second dimension the
// component; 8 CTAs an SM (64 registers, 12 bytes of spill).
__global__ void __launch_bounds__(kThreads, 8)
mc_picture_kernel(const __grid_constant__ PictureRefs refs, int h4, int w4,
                  const uint8_t* __restrict__ inter,
                  const int8_t* __restrict__ ref_idx,
                  const int32_t* __restrict__ mv,
                  const int32_t* __restrict__ luma_filt,
                  const int32_t* __restrict__ chroma_filt, int bd_y,
                  int bd_c, int16_t* __restrict__ y,
                  int16_t* __restrict__ cb, int16_t* __restrict__ cr) {
    const int n = h4 * w4;
    const int t = blockIdx.x * kThreads + threadIdx.x;
    const int b = t >> 1, l = t & 1;
    const bool live = b < n;
    const int by = live ? b / w4 : 0, bx = live ? b - by * w4 : 0;
    const int c = blockIdx.y;
    if (c == 0)
        mc_picture_block<4, 8>(refs, 0, b, l, live, n, by, bx, 4 * h4,
                               4 * w4, inter, ref_idx, mv, luma_filt, bd_y,
                               y);
    else
        mc_picture_block<2, 4>(refs, c, b, l, live, n, by, bx, 2 * h4,
                               2 * w4, inter, ref_idx, mv, chroma_filt, bd_c,
                               c == 1 ? cb : cr);
}

}  // namespace

// L lists of C components each make G = L * C <= 4 groups, list-major;
// counts[g] is group g's number of references and planes holds every
// group's device pointers to (H, W) int16 contiguous planes, one group
// after the other (at most 64 in all); both arrays are on the host.
// sel, xi, yi, xf, yf: (L, B) int32; filt: (4, 8) int32 for bs 4 (luma) or
// (8, 4) int32 for bs 2 (chroma); out: (L, C, B, bs, bs) int32; all
// contiguous on the device. Launches on `stream` and returns
// cudaGetLastError() (0 on success, cudaErrorInvalidValue for another bs or
// too many groups or planes); never synchronises.
extern "C" int mc_block_grid_launch(const void* const* planes,
                                    const int* counts, int L, int C, int H,
                                    int W, const void* sel, const void* xi,
                                    const void* yi, const void* xf,
                                    const void* yf, const void* filt, int B,
                                    int bs, int bit_depth, void* out,
                                    void* stream) {
    const int G = L * C;
    if (L < 1 || C < 1 || G > kMaxGroups) return (int)cudaErrorInvalidValue;
    PlaneTable tab = {};
    int n = 0;
    for (int g = 0; g < G; ++g) {
        if (counts[g] < 1 || n + counts[g] > kMaxPlanes)
            return (int)cudaErrorInvalidValue;
        tab.first[g] = n;
        tab.count[g] = counts[g];
        for (int i = 0; i < counts[g]; ++i, ++n)
            tab.p[n] = (const int16_t*)planes[n];
    }
    if (B > 0) {
        const int32_t* s = (const int32_t*)sel;
        const int32_t* x = (const int32_t*)xi;
        const int32_t* y = (const int32_t*)yi;
        const int32_t* fx = (const int32_t*)xf;
        const int32_t* fy = (const int32_t*)yf;
        const int32_t* f = (const int32_t*)filt;
        int32_t* o = (int32_t*)out;
        cudaStream_t st = (cudaStream_t)stream;
        if (bs == 4)
            launch<4, 8>(tab, G, C, H, W, s, x, y, fx, fy, f, B, bit_depth, o,
                         st);
        else if (bs == 2)
            launch<2, 4>(tab, G, C, H, W, s, x, y, fx, fy, f, B, bit_depth, o,
                         st);
        else
            return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

// The whole MC stage of an (h4, w4) min-block 4:2:0 picture, into its
// planes y (4 h4, 4 w4), cb and cr (2 h4, 2 w4), int16, in place. counts[l]
// is list l's number of references (0..16) and planes holds, list 0 first,
// each reference's (y, cb, cr) device pointers, the shapes of the picture's
// own planes; both arrays are on the host. inter: (h4, w4) uint8, nonzero
// where a block is inter-predicted; ref_idx: (2, h4, w4) int8, -1 where a
// list is unused; mv: (2, h4, w4, 2) int16 at a 4-byte boundary; luma_filt
// (4, 8) and chroma_filt (8, 4) int32; bit depths 8..13. All contiguous on
// the device. Launches on `stream` and returns cudaGetLastError() (0 on
// success, cudaErrorInvalidValue for counts or depths out of range); never
// synchronises.
extern "C" int mc_picture_launch(const void* const* planes,
                                 const int* counts, int h4, int w4,
                                 const void* inter, const void* ref_idx,
                                 const void* mv, const void* luma_filt,
                                 const void* chroma_filt, int bd_y, int bd_c,
                                 void* y, void* cb, void* cr, void* stream) {
    if (bd_y < 8 || bd_y > 13 || bd_c < 8 || bd_c > 13 || h4 < 0 || w4 < 0)
        return (int)cudaErrorInvalidValue;
    PictureRefs refs = {};
    int n = 0;
    for (int l = 0; l < 2; ++l) {
        if (counts[l] < 0 || counts[l] > kMaxRefs)
            return (int)cudaErrorInvalidValue;
        refs.count[l] = counts[l];
        for (int r = 0; r < counts[l]; ++r)
            for (int c = 0; c < 3; ++c)
                refs.p[l][r][c] = (const int16_t*)planes[n++];
    }
    const int threads = 2 * h4 * w4;
    if (threads > 0) {
        const dim3 grid((unsigned)((threads + kThreads - 1) / kThreads), 3);
        mc_picture_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
            refs, h4, w4, (const uint8_t*)inter, (const int8_t*)ref_idx,
            (const int32_t*)mv, (const int32_t*)luma_filt,
            (const int32_t*)chroma_filt, bd_y, bd_c, (int16_t*)y,
            (int16_t*)cb, (int16_t*)cr);
    }
    return (int)cudaGetLastError();
}
