// Jump-flood (JFA) steps over the packed i32 nearest-seed state of an [H, W]
// plane, for Hopper (sm_90a).
//
// Replaces the TPU kernel of kanter_core_tpu/ops/pallas_distance.py:
// `_jfa_step_call` (pallas_distance.py:90), run once per step by
// `_jfa_ladder` (:284) through `jfa_propagate_pallas` (:309). Like them it
// computes exactly the steps of kanter_core_tpu/ops/distance.distance_plane's
// step-batched ladder:
//
//   state[y, x] packs the nearest seed found so far as (sy << 16) | sx, or
//   the sentinel 0x7FFFFFFF when none is known. For step k, the pixel starts
//   from its own candidate and folds the 8 candidates
//       cand(oy, ox) = in[(y - oy) mod H][(x - ox) mod W]
//   for oy in (-k, 0, k), ox in (-k, 0, k), (0, 0) skipped, in that order,
//   keeping a candidate only when its toroidal d^2 is strictly smaller
//   (first seen wins ties). `jnp.roll(a, s)[i] == a[(i - s) mod n]`, so the
//   candidate at offset (oy, ox) sits at (y - oy, x - ox).
//
// What bounds it on this card: instructions, not bytes. A step moves 8 bytes
// per pixel through device memory (0.04 ms at 4096^2) but folds 9 candidates
// of some 17 operations each. The one-pixel-per-thread integer kernel this
// file held before took the same 0.175 ms for every step of a 4096^2 ladder,
// k = 2048 and k = 1 alike (so neither L2 nor device memory held it): nearly
// all of its instructions (unpack, |d|, wrap, compare, select) go to the
// SM's integer ALUs, which run at half the rate of the FP32 pipes, and it
// re-did the unpack for each of the nine pixels that read a value.
//
// The design.
//
// - The metric in exact f32 where it fits. Coordinates are below 2^16 and a
//   toroidal d^2 is at most (H/2)^2 + (W/2)^2; where that is at most 2^24
//   (every plane up to 5792^2, 4096^2 included) every intermediate is an
//   integer or half-integer that f32 holds exactly, so the FP32 pipes give
//   the same d^2 and the same comparisons as the i32 reference, bit for bit
//   in the packed result. A coordinate becomes a float by one byte permute
//   (0x4B00hhhh = 2^23 + c, the bias cancels in the difference); the
//   toroidal wrap is n/2 - ||d| - n/2|, two subtractions with free absolute
//   values instead of compare and select. Inside a kernel the sentinel is
//   held as 0xFFFFFFFF: its coordinates (65535, 65535) are so far from every
//   pixel of such a plane that its d^2 exceeds every real one, which is all
//   the reference's 1 << 30 does; it is mapped back on the way out. Larger
//   planes take the same kernels with the i32 metric (`MetricI32`).
// - Far steps, `jfa_lattice`: for step k with k | H and k | W the pixels
//   split into k x k lattices of stride k, and a pixel's 8 candidates are
//   the own values of its lattice neighbours. A thread owns a 2 x 4 patch of
//   one lattice: it starts its 4 x 6 loads up front (3 per pixel instead of
//   9; lanes run along x, so each is a coalesced segment), unpacks each
//   value once and folds all 8 pixels from registers.
// - Far steps on other shapes, `jfa_step`: the one-pixel-per-thread form,
//   for steps that do not divide the extents or reach past them (97x411,
//   33x2049, k >= H). Same metric and fold.
// - Near steps, `jfa_near`: the trailing steps of a ladder whose sum is at
//   most 16 (8, 4, 2, 1, 1) run in one launch. A block stages a tile plus a
//   halo of that sum into shared memory, with wrapped global coordinates,
//   and runs the steps between barriers on two ping-pong buffers while the
//   valid region shrinks by k a step; the last step writes the tile to
//   device memory. Five launches and round trips become one; a 64 x 64 tile
//   with halo 16 takes 74,496 bytes (three blocks to an SM) and does 1.2
//   times the folds. At 218 instructions per cell and step the run keeps
//   every instruction slot of the card busy: it is bound by the fold itself.
//
// A batch. Both entries take B states at their own batch strides for the
// input and the output (64-bit offsets) and carry the canvas in blockIdx.z,
// B <= 65535: one launch per entry of the ladder whatever B is, where the
// batching rule of `_jfa_ladder` (pallas_distance.py:297-304) maps the rank-2
// ladder over the batch. Every canvas folds exactly as a single state does.
//
// `kanter_jfa_step_i32` runs one far step and picks the lattice or the
// one-pixel form by shape (`jfa_step_form` in ops/distance.py says which);
// `kanter_jfa_near_i32` runs a fused run of near steps. The host-side plan
// of a ladder is `jfa_launch_plan` in ops/distance.py. Both entries launch
// once on the caller's stream, allocate nothing and return
// cudaGetLastError() (cudaErrorInvalidValue for arguments they do not take).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSentinel = 0x7FFFFFFF;
constexpr int kFar = 1 << 30;
// lattice rows and columns per thread, and the blocks the lattice kernel is
// compiled to fit on an SM (scripts/kernel_tile_sweep.py --lattice rebuilds
// with other values)
#ifndef KANTER_JFA_LATTICE_ROWS
#define KANTER_JFA_LATTICE_ROWS 2
#endif
#ifndef KANTER_JFA_LATTICE_COLS
#define KANTER_JFA_LATTICE_COLS 4
#endif
#ifndef KANTER_JFA_LATTICE_BLOCKS
#define KANTER_JFA_LATTICE_BLOCKS 1
#endif
constexpr int kLatR = KANTER_JFA_LATTICE_ROWS;
constexpr int kLatC = KANTER_JFA_LATTICE_COLS;
constexpr int kMaxNearSteps = 8;
constexpr int kMaxSmem = 232448;
constexpr int kMaxGridZ = 65535;  // canvases per launch

// this block's canvas of a batch, `stride` elements apart; one plane (not
// BATCHED) keeps the pointer as it is, so its instance is the unbatched code
// (on an H100 SXM the batched instance takes 2.8% longer on one 4096^2
// state: scripts/batch_instance_ab.py)
template <bool BATCHED, class T>
__device__ __forceinline__ T* canvas(T* base, long long stride) {
    return BATCHED ? base + (long long)blockIdx.z * stride : base;
}

// i wrapped into [0, n), any i (a remainder: staging and set-up only)
__device__ __forceinline__ int wrap_any(int i, int n) {
    i %= n;
    return i < 0 ? i + n : i;
}

// i wrapped into [0, n) for -n <= i < 3n, without a division
__device__ __forceinline__ int wrap_ring(int i, int n) {
    if (i < 0) i += n;
    if (i >= n) i -= n;
    if (i >= n) i -= n;
    return i;
}

// floor(q / d) as a multiply-high by `inv` = reciprocal(d), exact for
// q * d < 2^32; d = 1 has no such reciprocal and is passed as inv = 0
__host__ __device__ __forceinline__ unsigned reciprocal(unsigned d) {
    return d < 2 ? 0u : 0xFFFFFFFFu / d + 1u;
}
__device__ __forceinline__ int fast_div(int q, unsigned inv) {
    return inv == 0 ? q : (int)__umulhi((unsigned)q, inv);
}

// The toroidal squared distance in exact f32 (planes with
// (H/2)^2 + (W/2)^2 <= 2^24).
struct MetricF32 {
    float half_h, half_w;
    struct Pixel { float y, x; };
    struct Cand { float y, x; };
    typedef float Dist;
    __host__ MetricF32(int h, int w) : half_h(0.5f * h), half_w(0.5f * w) {}
    // the state's value as the kernels hold it, and back
    static __device__ __forceinline__ int encode(int v) { return v == kSentinel ? -1 : v; }
    static __device__ __forceinline__ int decode(int v) {
        return (unsigned)v >= 0xFFFF0000u ? kSentinel : v;
    }
    static __device__ __forceinline__ Pixel pixel(int y, int x) {
        return {__int_as_float(0x4B000000 | y), __int_as_float(0x4B000000 | x)};
    }
    static __device__ __forceinline__ Cand unpack(int v) {
        return {__int_as_float(__byte_perm(v, 0x4B000000, 0x7632)),
                __int_as_float(__byte_perm(v, 0x4B000000, 0x7610))};
    }
    __device__ __forceinline__ Dist d2(const Pixel& p, const Cand& c) const {
        const float ay = __fsub_rn(fabsf(__fsub_rn(p.y, c.y)), half_h);
        const float ax = __fsub_rn(fabsf(__fsub_rn(p.x, c.x)), half_w);
        const float by = __fsub_rn(half_h, fabsf(ay));
        const float bx = __fsub_rn(half_w, fabsf(ax));
        return __fmaf_rn(bx, bx, __fmul_rn(by, by));
    }
};

// The same in i32, for any plane within the packing bound.
struct MetricI32 {
    int h, w;
    struct Pixel { int y, x; };
    struct Cand { int y, x; bool far; };
    typedef int Dist;
    __host__ MetricI32(int h_, int w_) : h(h_), w(w_) {}
    static __device__ __forceinline__ int encode(int v) { return v; }
    static __device__ __forceinline__ int decode(int v) { return v; }
    static __device__ __forceinline__ Pixel pixel(int y, int x) { return {y, x}; }
    static __device__ __forceinline__ Cand unpack(int v) {
        return {v >> 16, v & 0xFFFF, v == kSentinel};
    }
    __device__ __forceinline__ Dist d2(const Pixel& p, const Cand& c) const {
        int dy = abs(p.y - c.y);
        dy = min(dy, h - dy);
        int dx = abs(p.x - c.x);
        dx = min(dx, w - dx);
        return c.far ? kFar : dy * dy + dx * dx;
    }
};

// keep the candidate on a strictly smaller distance
template <class M>
__device__ __forceinline__ void fold(const M& m, const typename M::Pixel& p, int v,
                                     const typename M::Cand& c, int& best,
                                     typename M::Dist& best_d2) {
    const typename M::Dist d2 = m.d2(p, c);
    if (d2 < best_d2) {
        best = v;
        best_d2 = d2;
    }
}

// One far step, one pixel per thread: any k, any shape.
template <class M, bool BATCHED>
__global__ void __launch_bounds__(kThreads)
jfa_step(const int* __restrict__ in, int* __restrict__ out, const M metric, const int ky,
         const int kx, const int h, const int w, const long long in_stride,
         const long long out_stride) {
    in = canvas<BATCHED>(in, in_stride);
    out = canvas<BATCHED>(out, out_stride);
    const int x = blockIdx.x * blockDim.x + threadIdx.x;
    if (x >= w) return;
    // source columns of ox = -k, 0, +k: (x - ox) mod W
    int xs[3];
    xs[0] = x + kx >= w ? x + kx - w : x + kx;
    xs[1] = x;
    xs[2] = x - kx < 0 ? x - kx + w : x - kx;
    for (int y = blockIdx.y; y < h; y += gridDim.y) {
        int ys[3];
        ys[0] = y + ky >= h ? y + ky - h : y + ky;
        ys[1] = y;
        ys[2] = y - ky < 0 ? y - ky + h : y - ky;
        int v[3][3];
#pragma unroll
        for (int i = 0; i < 3; ++i) {
#pragma unroll
            for (int j = 0; j < 3; ++j) v[i][j] = M::encode(in[(size_t)ys[i] * w + xs[j]]);
        }
        const typename M::Pixel p = M::pixel(y, x);
        int best = v[1][1];
        typename M::Dist best_d2 = metric.d2(p, M::unpack(best));
#pragma unroll
        for (int i = 0; i < 3; ++i) {
#pragma unroll
            for (int j = 0; j < 3; ++j) {
                if (i == 1 && j == 1) continue;
                fold(metric, p, v[i][j], M::unpack(v[i][j]), best, best_d2);
            }
        }
        out[(size_t)y * w + x] = M::decode(best);
    }
}

// One far step with ky | h and kx | w: a thread owns kLatR x kLatC points of
// one lattice of stride (ky, kx). ly = h / ky and lx = w / kx are the
// lattice's extents (at least 2), tiles_i x tiles_j its patches, inv_ky and
// inv_kx the steps' reciprocals.
template <class M, bool BATCHED>
__global__ void __launch_bounds__(kThreads, KANTER_JFA_LATTICE_BLOCKS)
jfa_lattice(const int* __restrict__ in, int* __restrict__ out, const M metric, const int ky,
            const int kx, const unsigned inv_ky, const unsigned inv_kx, const int ly,
            const int lx, const int tiles_i, const int tiles_j, const int w,
            const long long in_stride, const long long out_stride) {
    in = canvas<BATCHED>(in, in_stride);
    out = canvas<BATCHED>(out, out_stride);
    const int u = blockIdx.x * blockDim.x + threadIdx.x;  // (patch column, x residue)
    const int s = blockIdx.y * blockDim.y + threadIdx.y;  // (patch row, y residue)
    const int pj = fast_div(u, inv_kx);
    const int pi = fast_div(s, inv_ky);
    if (pj >= tiles_j || pi >= tiles_i) return;
    const int rx = u - pj * kx;
    const int ry = s - pi * ky;
    // rows and columns of the patch and its ring of lattice neighbours
    int ys[kLatR + 2], xs[kLatC + 2];
#pragma unroll
    for (int i = 0; i < kLatR + 2; ++i) ys[i] = ry + ky * wrap_ring(pi * kLatR + i - 1, ly);
#pragma unroll
    for (int j = 0; j < kLatC + 2; ++j) xs[j] = rx + kx * wrap_ring(pj * kLatC + j - 1, lx);
    int v[kLatR + 2][kLatC + 2];
#pragma unroll
    for (int i = 0; i < kLatR + 2; ++i) {
        const int* row = in + (size_t)ys[i] * w;
#pragma unroll
        for (int j = 0; j < kLatC + 2; ++j) v[i][j] = M::encode(row[xs[j]]);
    }
    typename M::Cand c[kLatR + 2][kLatC + 2];
#pragma unroll
    for (int i = 0; i < kLatR + 2; ++i) {
#pragma unroll
        for (int j = 0; j < kLatC + 2; ++j) c[i][j] = M::unpack(v[i][j]);
    }
#pragma unroll
    for (int i = 1; i <= kLatR; ++i) {
        if (pi * kLatR + i - 1 >= ly) continue;
#pragma unroll
        for (int j = 1; j <= kLatC; ++j) {
            if (pj * kLatC + j - 1 >= lx) continue;
            const typename M::Pixel p = M::pixel(ys[i], xs[j]);
            int best = v[i][j];
            typename M::Dist best_d2 = metric.d2(p, c[i][j]);
            // oy = -k is the lattice neighbour below (y + k), ox = -k the one
            // to the right
#pragma unroll
            for (int di = 1; di >= -1; --di) {
#pragma unroll
                for (int dj = 1; dj >= -1; --dj) {
                    if (di == 0 && dj == 0) continue;
                    fold(metric, p, v[i + di][j + dj], c[i + di][j + dj], best, best_d2);
                }
            }
            out[(size_t)ys[i] * w + xs[j]] = M::decode(best);
        }
    }
}

struct NearSteps {
    int k[kMaxNearSteps];
    int n;
};

// The run of near steps on one th x tw tile and its halo (the steps' sum).
template <class M, bool BATCHED>
__global__ void __launch_bounds__(kThreads)
jfa_near(const int* __restrict__ in, int* __restrict__ out, const M metric,
         const NearSteps steps, const int halo, const int h, const int w, const int th,
         const int tw, const long long in_stride, const long long out_stride) {
    extern __shared__ int near_smem[];
    in = canvas<BATCHED>(in, in_stride);
    out = canvas<BATCHED>(out, out_stride);
    const int rh = th + 2 * halo;
    const int rw = tw + 2 * halo;
    int* src = near_smem;
    int* dst = near_smem + rh * rw;
    int* const gy = near_smem + 2 * rh * rw;  // the region's rows and
    int* const gx = gy + rh;                  // columns on the plane
    const int org_y = blockIdx.y * th - halo;  // the staged region's origin
    const int org_x = blockIdx.x * tw - halo;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    for (int i = threadIdx.x; i < rh + rw; i += kThreads) {
        gy[i] = i < rh ? wrap_any(org_y + i, h) : wrap_any(org_x + i - rh, w);
    }
    __syncthreads();
    for (int i = warp; i < rh; i += kWarps) {
        const int* row = in + (size_t)gy[i] * w;
        for (int j = lane; j < rw; j += 32) src[i * rw + j] = M::encode(row[gx[j]]);
    }
    __syncthreads();
    int margin = 0;
    for (int step = 0; step < steps.n; ++step) {
        const int k = steps.k[step];
        const bool last = step == steps.n - 1;
        margin += k;
        const int cols = rw - 2 * margin;
        const int cells = (rh - 2 * margin) * cols;
        const unsigned inv_cols = reciprocal(cols);
        const int kr = k * rw;
        for (int q = threadIdx.x; q < cells; q += kThreads) {
            const int qi = fast_div(q, inv_cols);
            const int i = margin + qi;
            const int j = margin + q - qi * cols;
            const typename M::Pixel p = M::pixel(gy[i], gx[j]);
            // the 8 neighbours in fold order: oy = -k is the row below
            // (y + k), ox = -k the column to the right
            const int* centre = src + i * rw + j;
            const int* below = centre + kr;
            const int* above = centre - kr;
            const int v[9] = {below[k], below[0], below[-k], centre[k], centre[-k],
                              above[k], above[0], above[-k], centre[0]};
            int best = v[8];
            typename M::Dist best_d2 = metric.d2(p, M::unpack(best));
#pragma unroll
            for (int n = 0; n < 8; ++n) fold(metric, p, v[n], M::unpack(v[n]), best, best_d2);
            if (!last) {
                dst[i * rw + j] = best;
            } else if (org_y + i < h && org_x + j < w) {
                // after the last step the margin is the halo: the tile itself
                out[(size_t)(org_y + i) * w + org_x + j] = M::decode(best);
            }
        }
        __syncthreads();
        int* swap = src;
        src = dst;
        dst = swap;
    }
}

bool fits_f32(int h, int w) {
    const long long hy = h / 2, hx = w / 2;
    return hy * hy + hx * hx <= (1LL << 24);
}

template <class M, bool BATCHED>
int launch_step(const int* in, int* out, int k, int h, int w, int batch, long long in_stride,
                long long out_stride, cudaStream_t stream) {
    // the step along each axis, reduced first: k may exceed H or W on a
    // non-square canvas (k and the extents are positive, so % is a mod)
    const int ky = k % h;
    const int kx = k % w;
    const M metric(h, w);
    if (ky > 0 && kx > 0 && h % ky == 0 && w % kx == 0) {
        const int ly = h / ky, lx = w / kx;
        const int tiles_i = (ly + kLatR - 1) / kLatR, tiles_j = (lx + kLatC - 1) / kLatC;
        const dim3 block(32, kThreads / 32);
        const long long gx = ((long long)kx * tiles_j + block.x - 1) / block.x;
        const long long gy = ((long long)ky * tiles_i + block.y - 1) / block.y;
        if (gy <= 65535) {
            jfa_lattice<M, BATCHED><<<dim3((unsigned)gx, (unsigned)gy, batch), block, 0, stream>>>(
                in, out, metric, ky, kx, reciprocal(ky), reciprocal(kx), ly, lx, tiles_i,
                tiles_j, w, in_stride, out_stride);
            return (int)cudaGetLastError();
        }
    }
    const dim3 grid((w + kThreads - 1) / kThreads, h < 65535 ? h : 65535, batch);
    jfa_step<M, BATCHED><<<grid, kThreads, 0, stream>>>(in, out, metric, ky, kx, h, w, in_stride,
                                                        out_stride);
    return (int)cudaGetLastError();
}

template <class M, bool BATCHED>
int launch_near(const int* in, int* out, const NearSteps& steps, int halo, int h, int w,
                int th, int tw, size_t smem, int batch, long long in_stride,
                long long out_stride, cudaStream_t stream) {
    auto kernel = jfa_near<M, BATCHED>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((w + tw - 1) / tw, (h + th - 1) / th, batch);
    if (grid.y > 65535) return (int)cudaErrorInvalidValue;
    kernel<<<grid, kThreads, smem, stream>>>(in, out, M(h, w), steps, halo, h, w, th, tw,
                                             in_stride, out_stride);
    return (int)cudaGetLastError();
}

}  // namespace

// one far step k >= 1 from `in` to `out`, for `batch` canvases: canvas b at
// in + b * in_stride and out + b * out_stride (elements)
extern "C" int kanter_jfa_step_i32(const int* in, int* out, int k, int h, int w, int batch,
                                   long long in_stride, long long out_stride,
                                   cudaStream_t stream) {
    if (k < 1 || h < 1 || w < 1 || batch < 1 || batch > kMaxGridZ) {
        return (int)cudaErrorInvalidValue;
    }
    if (batch > 1) {
        return fits_f32(h, w)
                   ? launch_step<MetricF32, true>(in, out, k, h, w, batch, in_stride, out_stride,
                                                  stream)
                   : launch_step<MetricI32, true>(in, out, k, h, w, batch, in_stride, out_stride,
                                                  stream);
    }
    return fits_f32(h, w) ? launch_step<MetricF32, false>(in, out, k, h, w, 1, 0, 0, stream)
                          : launch_step<MetricI32, false>(in, out, k, h, w, 1, 0, 0, stream);
}

// the n steps `steps_host` (host memory, each >= 1) from `in` to `out` in one
// launch, on tiles of th x tw pixels (tw >= 2), for `batch` canvases as above
extern "C" int kanter_jfa_near_i32(const int* in, int* out, const int* steps_host, int n,
                                   int h, int w, int th, int tw, int batch,
                                   long long in_stride, long long out_stride,
                                   cudaStream_t stream) {
    if (n < 1 || n > kMaxNearSteps || h < 1 || w < 1 || th < 1 || tw < 2 || batch < 1 ||
        batch > kMaxGridZ) {
        return (int)cudaErrorInvalidValue;
    }
    NearSteps steps = {};
    steps.n = n;
    int halo = 0;
    for (int i = 0; i < n; ++i) {
        if (steps_host[i] < 1) return (int)cudaErrorInvalidValue;
        steps.k[i] = steps_host[i];
        halo += steps_host[i];
    }
    // two buffers of the tile and its halo, and the region's row and column
    // coordinates
    const size_t rh = th + 2 * halo, rw = tw + 2 * halo;
    const size_t smem = (2 * rh * rw + rh + rw) * sizeof(int);
    if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
    if (batch > 1) {
        return fits_f32(h, w)
                   ? launch_near<MetricF32, true>(in, out, steps, halo, h, w, th, tw, smem, batch,
                                                  in_stride, out_stride, stream)
                   : launch_near<MetricI32, true>(in, out, steps, halo, h, w, th, tw, smem, batch,
                                                  in_stride, out_stride, stream);
    }
    return fits_f32(h, w) ? launch_near<MetricF32, false>(in, out, steps, halo, h, w, th, tw,
                                                          smem, 1, 0, 0, stream)
                          : launch_near<MetricI32, false>(in, out, steps, halo, h, w, th, tw,
                                                          smem, 1, 0, 0, stream);
}
