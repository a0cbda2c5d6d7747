// Luma interpolation at all 16 quarter-sample phases of a batch of
// windows, for Hopper (sm_90a).
//
// Replaces the XLA program turingcodec_tpu/ops/inter.py
// interp_luma_all_phases (its int32 einsums, :38, :47 and :57). Each
// (h + 7, w + 7) window gives the (4, 4, h, w) 14-bit intermediate
// predictions of the block at its (3, 3) for every phase (yf, xf), with the
// spec's four cases (decode/inter_pred.py interp_luma):
//   (0, 0):          win << (14 - bd)
//   (0, xf > 0):     H = sum_k fh[k] win[y + 3][x + k] >> (bd - 8)
//   (yf > 0, 0):     sum_k fv[k] win[y + k][x + 3] >> (bd - 8)
//   (yf > 0, xf > 0): sum_k fv[k] H(y + k) >> 6, H over the window's rows.
// All sums are exact in int32, and H fits int16 at 8..14 bits: its taps sum
// to at most 88 in magnitude, so |H| < 88 * 2^8. The filter taps are
// compiled in as immediates from hevc/tables.py LUMA_FILTER by
// ops/kernel_build.py: loaded from a parameter, they held 24 registers a
// thread and made the kernel spill at its 64-register limit.
//
// What bounds it. The output is 16 times the block: at one 1080p picture's
// 32,400 8x8 windows, 133 MB of int32 written against 14.6 MB of int16
// windows read, 44 us at 3.35 TB/s. The multiply-adds (3 H phases per
// window sample, 12 x 8 per output sample) take under half of that in
// INT32 issue. Writing the output bounds it, and a store that covers a
// fraction of a line costs the memory system a whole transaction.
//
// Design. A CTA owns a tile whose windows and whose output are each one
// contiguous range of device memory: a run of k consecutive windows, or,
// when one window's output would not fit, a band of th output rows of one
// window (its output then 16 contiguous per-phase chunks). It
//   1. copies the tile's window rows into shared memory with 16-byte loads
//      at the same offset mod 16 (the ragged ends one sample at a time);
//   2. computes, once per window row and column, the centre sample and the
//      three horizontal phases into four int16 planes in shared memory;
//   3. computes every output sample's 16 phases from eight rows of those
//      planes into the output tile in shared memory, laid out as in device
//      memory;
//   4. writes the tile out with 16-byte streaming stores from every thread
//      (st.global.cs), neighbouring threads on neighbouring addresses: each
//      store instruction of a warp writes 512 contiguous bytes (a run's
//      output is 64 h w bytes per window, so 16-byte stores fit at any w
//      and h), where a store per phase plane and output row of a window
//      would write a fraction of a 128-byte line.
// Nothing is recomputed except the 7 extra window rows of each band. A
// tile's shared memory stays under 48 KB, so four CTAs share an SM and one
// CTA's stores overlap the others' arithmetic.
#include <cuda_runtime.h>
#include <stdint.h>

#ifndef TC_LUMA_FILTER
#error "TC_LUMA_FILTER undefined: build with ops/kernel_build.py, which pre-includes hevc/tables.py's luma filter"
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kSmemBudget = 48 * 1024;  // dynamic, without an opt-in

__host__ __device__ inline int align16(int bytes) { return (bytes + 15) & ~15; }

// A tile's shared memory: the output tile (16 planes of k * ty * w int32),
// four int16 planes of k * (ty + 7) * w (centre sample, H phases 1..3),
// then the n window samples with up to 7 samples of alignment in front.
struct Layout {
    int out_words, h_plane, win_elems;
    __host__ __device__ Layout(int k, int ty, int w, int n)
        : out_words(16 * k * ty * w), h_plane(k * (ty + 7) * w),
          win_elems(n + 8) {}
    __host__ __device__ int h_off() const { return out_words * 4; }
    __host__ __device__ int win_off() const {
        return h_off() + align16(8 * h_plane);
    }
    __host__ __device__ int bytes() const {
        return win_off() + align16(2 * win_elems);
    }
};

// A thread's item index in mixed radix (hi, mid, lo), lo < nlo and mid <
// nmid, advanced by kThreads per step without a division.
struct Walk {
    int hi, mid, lo, dhi, dmid, dlo, nmid, nlo;
    __device__ Walk(int start, int nmid_, int nlo_) : nmid(nmid_), nlo(nlo_) {
        int q = start / nlo;
        lo = start - q * nlo;
        hi = q / nmid;
        mid = q - hi * nmid;
        q = kThreads / nlo;
        dlo = kThreads - q * nlo;
        dhi = q / nmid;
        dmid = q - dhi * nmid;
    }
    __device__ void next() {
        lo += dlo;
        int c = lo >= nlo;
        if (c) lo -= nlo;
        mid += dmid + c;
        c = mid >= nmid;
        if (c) mid -= nmid;
        hi += dhi + c;
    }
};

constexpr int kFlat = 1 << 30;  // nmid for a two-level (mid, lo) walk

// nch chunks of len units T of the shared tile s, chunk c to g + c *
// gstride units, as streaming stores.
template <class T>
__device__ void store_tile(const int32_t* s, int32_t* g, int nch, int len,
                           size_t gstride) {
    const T* src = reinterpret_cast<const T*>(s);
    T* dst = reinterpret_cast<T*>(g);
    for (Walk it(threadIdx.x, kFlat, len); it.mid < nch; it.next())
        __stcs(dst + it.mid * gstride + it.lo, src[it.mid * len + it.lo]);
}

__global__ void __launch_bounds__(kThreads, 4)
interp_all_phases_kernel(const int16_t* __restrict__ win, int B, int w,
                         int h, int k, int th, int nb, int shift1, int shift3,
                         int32_t* __restrict__ out) {
    // the (4 phases, 8 taps) luma filter; folded into the arithmetic
    constexpr int f[4][8] = {TC_LUMA_FILTER};
    extern __shared__ __align__(16) unsigned char smem[];
    const int tid = threadIdx.x;
    const int ww = w + 7;
    const size_t wsz = (size_t)(h + 7) * ww;

    // the tile: windows b0 .. b0 + kt - 1, output rows y0 .. y0 + ty - 1
    int b0, kt, y0, ty;
    if (th == 0) {
        b0 = blockIdx.x * k;
        kt = min(k, B - b0);
        y0 = 0;
        ty = h;
    } else {
        b0 = blockIdx.x / nb;
        kt = 1;
        y0 = (blockIdx.x - b0 * nb) * th;
        ty = min(th, h - y0);
    }
    const int rows = ty + 7;    // window rows per window of the tile
    const int n = kt * rows * ww;
    const Layout L(kt, ty, w, n);
    int32_t* so = reinterpret_cast<int32_t*>(smem);
    int16_t* sh = reinterpret_cast<int16_t*>(smem + L.h_off());
    int16_t* sw = reinterpret_cast<int16_t*>(smem + L.win_off());
    const int hp = L.h_plane;

    // 1. the tile's window rows, one contiguous range: element i to sw[off
    // + i], so that 16-byte quads of device and shared memory line up
    const int16_t* g = win + (size_t)b0 * wsz + (size_t)y0 * ww;
    const int off = (int)((reinterpret_cast<uintptr_t>(g) >> 1) & 7);
    {
        const int4* g4 = reinterpret_cast<const int4*>(g - off);
        int4* s4 = reinterpret_cast<int4*>(sw);
        const int q0 = (off + 7) >> 3, q1 = (off + n) >> 3;
        for (int q = q0 + tid; q < q1; q += kThreads) s4[q] = __ldg(g4 + q);
        const int head = min(n, 8 * q0 - off);
        const int tail = max(head, 8 * q1 - off);
        for (int i = tid; i < head; i += kThreads) sw[off + i] = __ldg(g + i);
        for (int i = tail + tid; i < n; i += kThreads)
            sw[off + i] = __ldg(g + i);
    }
    __syncthreads();

    // 2. per window row and output column: the centre sample and the three
    // horizontal phases, >> shift1
    for (Walk it(tid, kFlat, w); it.mid < kt * rows; it.next()) {
        const int16_t* s = sw + off + it.mid * ww + it.lo;
        int v[8];
#pragma unroll
        for (int t = 0; t < 8; ++t) v[t] = s[t];
        int16_t* d = sh + it.mid * w + it.lo;
        d[0] = (int16_t)v[3];
#pragma unroll
        for (int p = 1; p < 4; ++p) {
            int acc = 0;
#pragma unroll
            for (int t = 0; t < 8; ++t) acc += f[p][t] * v[t];
            d[p * hp] = (int16_t)(acc >> shift1);
        }
    }
    __syncthreads();

    // 3. per output sample (window j, row y, column x): the 16 phases from
    // rows y .. y + 7 of the four planes
    const int plane = ty * w;  // output words of one phase in the tile
    for (Walk it(tid, ty, w); it.hi < kt; it.next()) {
        const int16_t* s = sh + (it.hi * rows + it.mid) * w + it.lo;
        int32_t* d = so + it.hi * 16 * plane + it.mid * w + it.lo;
#pragma unroll
        for (int xf = 0; xf < 4; ++xf) {
            int v[8];
#pragma unroll
            for (int t = 0; t < 8; ++t) v[t] = s[xf * hp + t * w];
            d[xf * plane] = xf ? v[3] : v[3] << shift3;
#pragma unroll
            for (int yf = 1; yf < 4; ++yf) {
                int acc = 0;
#pragma unroll
                for (int t = 0; t < 8; ++t) acc += f[yf][t] * v[t];
                d[(yf * 4 + xf) * plane] = acc >> (xf ? 6 : shift1);
            }
        }
    }
    __syncthreads();

    // 4. the output tile: a run is one range of kt * 16 h w words, a band
    // 16 chunks of ty * w words, h * w apart
    int32_t* go = out + (size_t)b0 * 16 * h * w + (size_t)y0 * w;
    const int nch = th ? 16 : 1;
    const int len = th ? plane : kt * 16 * plane;
    const size_t gstride = (size_t)h * w;
    if ((reinterpret_cast<uintptr_t>(go) & 15) == 0 && len % 4 == 0
            && (nch == 1 || gstride % 4 == 0))
        store_tile<int4>(so, go, nch, len / 4, gstride / 4);
    else
        store_tile<int>(so, go, nch, len, gstride);
}

}  // namespace

// win: (B, h + 7, w + 7) int16; out: (B, 4, 4, h, w) int32; both
// contiguous on the device; bit_depth in 8..14. Launches on
// `stream` and returns cudaGetLastError() (0 on success,
// cudaErrorInvalidValue for a bit depth outside 8..14, a size below 1, or a
// window too wide for one output row's tile, w above 382); never
// synchronises.
extern "C" int interp_all_phases_launch(const void* win, int B, int w, int h,
                                        int bit_depth, void* out,
                                        void* stream) {
    if (bit_depth < 8 || bit_depth > 14 || w < 1 || h < 1)
        return (int)cudaErrorInvalidValue;
    if (B <= 0) return (int)cudaGetLastError();
    const int ww = w + 7, wsz = (h + 7) * ww;
    int k = 1, th = 0, nb = 1;
    long long grid;
    if (Layout(1, h, w, wsz).bytes() <= kSmemBudget) {
        // as many whole windows as fit
        while (k < B && Layout(k + 1, h, w, (k + 1) * wsz).bytes()
                            <= kSmemBudget)
            ++k;
        grid = (B + k - 1) / k;
    } else {
        // bands of output rows, as even as the budget allows
        th = h;
        while (th > 0 && Layout(1, th, w, (th + 7) * ww).bytes() > kSmemBudget)
            --th;
        if (th == 0) return (int)cudaErrorInvalidValue;
        nb = (h + th - 1) / th;
        th = (h + nb - 1) / nb;
        grid = (long long)B * nb;
    }
    if (grid > 0x7fffffff) return (int)cudaErrorInvalidValue;
    const int bytes = th ? Layout(1, th, w, (th + 7) * ww).bytes()
                         : Layout(k, h, w, k * wsz).bytes();
    interp_all_phases_kernel<<<(unsigned)grid, kThreads, bytes,
                               (cudaStream_t)stream>>>(
        (const int16_t*)win, B, w, h, k, th, nb, bit_depth - 8,
        14 - bit_depth, (int32_t*)out);
    return (int)cudaGetLastError();
}
