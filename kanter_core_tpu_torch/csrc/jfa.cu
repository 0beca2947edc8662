// One jump-flood (JFA) step over the packed i32 nearest-seed state of an
// [H, W] plane, for Hopper (sm_90a).
//
// Replaces the TPU kernel of kanter_core_tpu/ops/pallas_distance.py:
// `_jfa_step_call` (pallas_distance.py:90), run once per step by
// `_jfa_ladder` (:284) through `jfa_propagate_pallas` (:309). Like them it
// computes exactly one step of kanter_core_tpu/ops/distance.distance_plane's
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
// Everything is 32-bit integer arithmetic on coordinates below 2^16, so the
// result is bit-identical to the JAX package's fold by construction.
//
// What bounds it on this card: per step it reads the state once from device
// memory and writes it once (8 bytes per pixel); the 9 reads per pixel hit
// rows y - k, y, y + k, which neighbouring threads share through L1/L2.
// Past that it does about 150 integer operations per pixel and step (9 unpack
// + toroidal d^2 + compare/select), well under the card's INT32 rate at
// 4096^2. The design is the simple one: one thread per pixel, one launch per
// step, ping-pong between two buffers. The TPU kernel's 8-row chunks, DMA
// double buffering and near/far step split existed for Mosaic's VMEM and
// are not carried over; a shared-memory tile for k < 8 and fused near steps
// are later work.
//
// The C entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGridY = 65535;
constexpr int kSentinel = 0x7FFFFFFF;
constexpr int kFar = 1 << 30;

__device__ __forceinline__ int toroidal_d2(int cand, int y, int x, int h, int w) {
    if (cand == kSentinel) return kFar;
    int dy = abs(y - (cand >> 16));
    if (dy > h / 2) dy = h - dy;
    int dx = abs(x - (cand & 0xFFFF));
    if (dx > w / 2) dx = w - dx;
    return dy * dy + dx * dx;
}

__global__ void jfa_step(const int* __restrict__ in, int* __restrict__ out,
                         int ky, int kx, int h, int w) {
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
        int best = in[(size_t)y * w + x];
        int best_d2 = toroidal_d2(best, y, x, h, w);
#pragma unroll
        for (int i = 0; i < 3; ++i) {
#pragma unroll
            for (int j = 0; j < 3; ++j) {
                if (i == 1 && j == 1) continue;
                const int cand = in[(size_t)ys[i] * w + xs[j]];
                const int d2 = toroidal_d2(cand, y, x, h, w);
                if (d2 < best_d2) {
                    best = cand;
                    best_d2 = d2;
                }
            }
        }
        out[(size_t)y * w + x] = best;
    }
}

}  // namespace

extern "C" int kanter_jfa_step_i32(const int* in, int* out, int k, int h, int w,
                                   cudaStream_t stream) {
    // the step along each axis, reduced first: k may exceed H or W on a
    // non-square canvas (k and the extents are positive, so % is a mod)
    const int ky = k % h;
    const int kx = k % w;
    const dim3 block(kThreads);
    const dim3 grid((w + kThreads - 1) / kThreads, h < kMaxGridY ? h : kMaxGridY);
    jfa_step<<<grid, block, 0, stream>>>(in, out, ky, kx, h, w);
    return (int)cudaGetLastError();
}
