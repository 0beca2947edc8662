// Separable toroidal Gaussian blur of one [H, W] f32 plane, for Hopper (sm_90a).
//
// Replaces the TPU kernel of kanter_core_tpu/ops/pallas_blur.py: `_halo_call`
// (pallas_blur.py:77) and `_padded_call` (pallas_blur.py:260), dispatched by
// `blur_pallas` (pallas_blur.py:393) through `_blur_pallas_wrapped`. Like
// them it computes exactly what kanter_core_tpu/ops/blur._blur_axis0 computes
// on the plane and then on its transpose:
//
//   vertical:   tmp[y, x] = sum_t w[t] * in [(y + t - r) mod H, x]
//   horizontal: out[y, x] = sum_t w[t] * tmp[y, (x + t - r) mod W]
//
// for t = 0 .. 2r in that order, each sum starting from 0.0f and adding every
// separately rounded product (__fmul_rn, __fadd_rn: no FMA contraction; the
// build also passes -fmad=false). Starting from the first product instead
// would turn a leading -0.0 product into -0.0 where the reference has +0.0.
// The taps are the host-computed f32 values of blur.gaussian_taps, passed in
// device memory; they are never recomputed here.
//
// What bounds it on this card: memory bandwidth. As written it reads the
// plane twice and writes it twice (input -> scratch -> output, 16 bytes per
// pixel); the vertical pass re-reads each input row 2r+1 times, and those
// re-reads are served by L1/L2 rather than device memory. The design is the
// simple one: one thread per output pixel, the vertical pass straight from
// global memory (neighbouring threads read neighbouring addresses), the
// horizontal pass from a shared-memory row segment holding the block's
// pixels plus the wrap halo. The TPU kernel's 8-row strips, chunk picker and
// double buffering existed for Mosaic and are not carried over. A fused
// single-pass tile, TMA loads and a register-blocked vertical pass are later
// work.
//
// The block form, `kanter_blur_block_f32`, replaces `_blur_block`
// (pallas_blur.py:419), which `_blur_pallas_sharded` (pallas_blur.py:474)
// runs on every shard of a row-sharded plane after a ring exchange of
// +-radius rows. It blurs one [block_h, W] row block whose vertical
// neighbours arrive as two explicit halos: `top`, the r rows before the
// block, and `bot`, the r rows after it. The vertical pass reads row
// y + t - r of the window [top; block; bot] straight from whichever of the
// three buffers holds it (no concatenated copy, as the TPU kernel DMAs the
// block in place); the horizontal pass is the dense one on block_h rows.
// Same taps, same order, same zero-initialised accumulator, so a sharded
// blur is bit-identical to the dense one. Bound as the dense form: bytes,
// 16 per pixel plus the 2*r*W*4 bytes of the halos.
//
// The C entry points launch on the caller's stream, allocate nothing and
// return cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGridY = 65535;

__device__ __forceinline__ int wrap_index(int i, int n) {
    // correct for |i| > n too (e.g. 37 taps on a 5-row plane)
    return ((i % n) + n) % n;
}

__global__ void blur_vertical(const float* __restrict__ in, float* __restrict__ out,
                              const float* __restrict__ taps, int ntaps, int h, int w) {
    extern __shared__ float s_taps[];
    for (int t = threadIdx.x; t < ntaps; t += blockDim.x) s_taps[t] = taps[t];
    __syncthreads();
    const int x = blockIdx.x * blockDim.x + threadIdx.x;
    if (x >= w) return;
    const int r = (ntaps - 1) / 2;
    for (int y = blockIdx.y; y < h; y += gridDim.y) {
        float acc = 0.0f;
        for (int t = 0; t < ntaps; ++t) {
            const int sy = wrap_index(y + t - r, h);
            acc = __fadd_rn(acc, __fmul_rn(in[(size_t)sy * w + x], s_taps[t]));
        }
        out[(size_t)y * w + x] = acc;
    }
}

// row sy in [-r, block_h + r) of the window [top; block; bot]
__device__ __forceinline__ const float* window_row(const float* top, const float* block,
                                                   const float* bot, int sy, int r,
                                                   int block_h, int w) {
    if (sy < 0) return top + (size_t)(sy + r) * w;
    if (sy >= block_h) return bot + (size_t)(sy - block_h) * w;
    return block + (size_t)sy * w;
}

__global__ void blur_vertical_block(const float* __restrict__ top,
                                    const float* __restrict__ block,
                                    const float* __restrict__ bot, float* __restrict__ out,
                                    const float* __restrict__ taps, int ntaps, int block_h,
                                    int w) {
    extern __shared__ float s_taps[];
    for (int t = threadIdx.x; t < ntaps; t += blockDim.x) s_taps[t] = taps[t];
    __syncthreads();
    const int x = blockIdx.x * blockDim.x + threadIdx.x;
    if (x >= w) return;
    const int r = (ntaps - 1) / 2;
    for (int y = blockIdx.y; y < block_h; y += gridDim.y) {
        float acc = 0.0f;
        for (int t = 0; t < ntaps; ++t) {
            const float* row = window_row(top, block, bot, y + t - r, r, block_h, w);
            acc = __fadd_rn(acc, __fmul_rn(row[x], s_taps[t]));
        }
        out[(size_t)y * w + x] = acc;
    }
}

__global__ void blur_horizontal(const float* __restrict__ in, float* __restrict__ out,
                                const float* __restrict__ taps, int ntaps, int h, int w) {
    extern __shared__ float smem[];
    float* s_taps = smem;         // ntaps
    float* s_row = smem + ntaps;  // blockDim.x + 2r: the block's pixels + wrap halo
    for (int t = threadIdx.x; t < ntaps; t += blockDim.x) s_taps[t] = taps[t];
    const int r = (ntaps - 1) / 2;
    const int x0 = blockIdx.x * blockDim.x;
    const int span = blockDim.x + 2 * r;
    const int x = x0 + threadIdx.x;
    for (int y = blockIdx.y; y < h; y += gridDim.y) {
        const float* row = in + (size_t)y * w;
        __syncthreads();  // previous row's readers are done with s_row
        for (int i = threadIdx.x; i < span; i += blockDim.x) {
            s_row[i] = row[wrap_index(x0 - r + i, w)];
        }
        __syncthreads();
        if (x < w) {
            float acc = 0.0f;
            for (int t = 0; t < ntaps; ++t) {
                acc = __fadd_rn(acc, __fmul_rn(s_row[threadIdx.x + t], s_taps[t]));
            }
            out[(size_t)y * w + x] = acc;
        }
    }
}

dim3 grid_for(int h, int w) {
    return dim3((w + kThreads - 1) / kThreads, h < kMaxGridY ? h : kMaxGridY);
}

size_t horizontal_smem(int ntaps) {
    return (size_t)(ntaps + kThreads + (ntaps - 1)) * sizeof(float);
}

}  // namespace

extern "C" int kanter_blur_wrap_f32(const float* in, float* scratch, float* out,
                                    const float* taps, int ntaps, int h, int w,
                                    cudaStream_t stream) {
    const dim3 grid = grid_for(h, w);
    blur_vertical<<<grid, kThreads, ntaps * sizeof(float), stream>>>(in, scratch, taps, ntaps,
                                                                    h, w);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    blur_horizontal<<<grid, kThreads, horizontal_smem(ntaps), stream>>>(scratch, out, taps,
                                                                       ntaps, h, w);
    return (int)cudaGetLastError();
}

// top and bot hold (ntaps - 1) / 2 rows each, block block_h >= that many
extern "C" int kanter_blur_block_f32(const float* top, const float* block, const float* bot,
                                     float* scratch, float* out, const float* taps, int ntaps,
                                     int block_h, int w, cudaStream_t stream) {
    const dim3 grid = grid_for(block_h, w);
    blur_vertical_block<<<grid, kThreads, ntaps * sizeof(float), stream>>>(
        top, block, bot, scratch, taps, ntaps, block_h, w);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    blur_horizontal<<<grid, kThreads, horizontal_smem(ntaps), stream>>>(scratch, out, taps,
                                                                       ntaps, block_h, w);
    return (int)cudaGetLastError();
}
