// Per-block fractional motion compensation for Hopper (sm_90a).
//
// Replaces the XLA program turingcodec_tpu/ops/inter.py mc_block_grid (its
// int32 einsums, :96-104). Every 4x4 luma (2x2 chroma) min-block b of a
// picture carries, per reference list l, its PU's motion: a reference index
// sel[l][b], the integer top-left sample (xi[l][b], yi[l][b]) and the
// fractional phase (xf[l][b], yf[l][b]). For each list and component the
// kernel reads the (bs + taps - 1)^2 window of reference plane sel[l][b]
// around it with every coordinate clamped into the plane (the spec's edge
// extension), then runs the separable 8-tap luma or 4-tap chroma filter and
// writes the 14-bit intermediate prediction with the spec's four phase
// cases:
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
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxGroups = 4;    // lists x components
constexpr int kMaxPlanes = 64;   // lists x components x references

struct PlaneTable {
    const int16_t* p[kMaxPlanes];
    int first[kMaxGroups];       // a group's first plane in p
    int count[kMaxGroups];       // its references
};

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
    constexpr int SPAN = BS + TAPS - 1;
    constexpr int OFF = TAPS / 2 - 1;
    constexpr int PHASES = TAPS == 8 ? 4 : 8;
    const int b = blockIdx.x * kThreads + threadIdx.x;
    if (b >= B) return;
    const int g = blockIdx.y;               // (list, component) group
    const size_t m = (size_t)(g / C) * B + b;  // the list's motion of b
    const int16_t* __restrict__ ref =
        tab.p[tab.first[g] + min(max(sel[m], 0), tab.count[g] - 1)];
    const int x0 = xi[m] - OFF;
    const int y0 = yi[m] - OFF;
    const int fx = min(max(xf[m], 0), PHASES - 1);
    const int fy = min(max(yf[m], 0), PHASES - 1);

    int col[SPAN];
#pragma unroll
    for (int k = 0; k < SPAN; ++k) col[k] = min(max(x0 + k, 0), W - 1);
    auto row_at = [&](int r) {
        return ref + (size_t)min(max(y0 + r, 0), H - 1) * W;
    };

    int v[BS * BS];
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
