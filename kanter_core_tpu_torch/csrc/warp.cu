// Directional bilinear toroidal warp of up to four [H, W] f32 planes by one
// gray strength map, for Hopper (sm_90a).
//
// Replaces the TPU kernel of kanter_core_tpu/ops/pallas_warp.py:
// `_warp_padded_call` (pallas_warp.py:147), dispatched by `warp_pallas`
// (:345) through `_warp_pallas_wrapped` (:456). It computes exactly what
// kanter_core_tpu/ops/warp.warp_planes computes through
// transform.bilinear_wrap_gather, per output pixel (x, y):
//
//   ms = clip(m, 0, 1), NaN -> 0.5;   d = ms - 0.5
//   u = x + kx*d,  v = y + ky*d          (each product rounded on its own)
//   uf = clip(floor(u), -1e9, 1e9),  x0 = int(uf) floor-mod W,  x1 = x0+1 wrapped
//   vf, y0, y1 likewise with H
//   nx0 = n00 + fu*(n10 - n00),  nx1 = n01 + fu*(n11 - n01)
//   out = nx0 + fv*(nx1 - nx0)           fu = u - uf, fv = v - vf
//
// with __fmul_rn/__fadd_rn/__fsub_rn (no FMA contraction; the build also
// passes -fmad=false) and the int conversion of a NaN coordinate giving 0,
// as XLA's does. (kx, ky) = intensity*(cos, sin) come from the host in f64,
// rounded once.
//
// What bounds it on this card: memory. Per pixel the compulsory traffic is
// the strength (4 bytes), each plane's texels once (16 for RGBA) and each
// output once (16): 36 bytes. The four texels a pixel gathers per plane lie
// within a few rows of it for a bounded displacement, so the re-reads are
// served by L1/L2. The coordinates are computed once per pixel and reused for
// every plane. The TPU kernel's staircase pair table, halo buckets and
// `fits_kernel` gates existed only because XLA:TPU gathers slowly; a direct
// gather needs none of them and serves unbounded intensity as well.
//
// The block form, `kanter_warp_block_f32`, replaces `_warp_block`
// (pallas_warp.py:306), which `_warp_pallas_sharded` (pallas_warp.py:376)
// runs on every shard of a row-sharded plane after a ring exchange of
// +-halo rows. Output row ly of a [block_h, W] block is global row
// y = row_origin + ly; the coordinates above use that global y and the
// global height H, and the wrapped global source row y0 (and y1) is read
// from the window [top; block; bot] at local row (y0 - row_origin + halo)
// mod H -- the JAX package's `row_local` (ops/warp.py:263-266) -- through
// three pointers per plane: `top` holds the halo rows before the block,
// `bot` the halo rows after it. The caller guarantees halo >=
// ceil(|ky|/2) + 2, so every sampled row lies in the window. Same
// arithmetic, same texels: a sharded warp is bit-identical to the dense
// one. Bound as the dense form: bytes, 36 per pixel plus the halo rows.
//
// The C entry points launch on the caller's stream, allocate nothing and
// return cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGridY = 65535;
constexpr int kMaxPlanes = 4;

struct Planes {
    const float* in[kMaxPlanes];
    float* out[kMaxPlanes];
};

// one row block per plane, as three row ranges of the window [top; mid; bot]
struct BlockPlanes {
    const float* top[kMaxPlanes];
    const float* mid[kMaxPlanes];
    const float* bot[kMaxPlanes];
    float* out[kMaxPlanes];
};

__device__ __forceinline__ float clip_floor(float c) {
    float f = floorf(c);
    // NaN compares false and stays NaN
    if (f < -1e9f) f = -1e9f;
    if (f > 1e9f) f = 1e9f;
    return f;
}

__device__ __forceinline__ int wrap_index(float f, int n) {
    const int i = f != f ? 0 : (int)f;
    const int r = i % n;
    return r < 0 ? r + n : r;
}

// where output pixel (x, y) samples: the fractional offsets and the wrapped
// texel columns and rows of its bilinear footprint
struct Sample {
    float fu, fv;
    int x0, x1, y0, y1;
};

__device__ __forceinline__ Sample sample_at(float m, int x, int y, float kx, float ky, int h,
                                            int w) {
    float ms = m < 0.0f ? 0.0f : (m > 1.0f ? 1.0f : m);
    if (m != m) ms = 0.5f;
    const float d = __fsub_rn(ms, 0.5f);
    const float u = __fadd_rn((float)x, __fmul_rn(kx, d));
    const float v = __fadd_rn((float)y, __fmul_rn(ky, d));
    const float uf = clip_floor(u);
    const float vf = clip_floor(v);
    Sample s;
    s.fu = __fsub_rn(u, uf);
    s.fv = __fsub_rn(v, vf);
    s.x0 = wrap_index(uf, w);
    s.y0 = wrap_index(vf, h);
    s.x1 = s.x0 + 1 == w ? 0 : s.x0 + 1;
    s.y1 = s.y0 + 1 == h ? 0 : s.y0 + 1;
    return s;
}

// bilinear lerp of the four texels at rows r0, r1 and columns x0, x1
__device__ __forceinline__ float lerp_at(const float* r0, const float* r1, const Sample& s) {
    const float n00 = r0[s.x0];
    const float n10 = r0[s.x1];
    const float n01 = r1[s.x0];
    const float n11 = r1[s.x1];
    const float nx0 = __fadd_rn(n00, __fmul_rn(s.fu, __fsub_rn(n10, n00)));
    const float nx1 = __fadd_rn(n01, __fmul_rn(s.fu, __fsub_rn(n11, n01)));
    return __fadd_rn(nx0, __fmul_rn(s.fv, __fsub_rn(nx1, nx0)));
}

__global__ void warp_bilinear(Planes planes, int n_planes, const float* __restrict__ strength,
                              float kx, float ky, int h, int w) {
    const int x = blockIdx.x * blockDim.x + threadIdx.x;
    if (x >= w) return;
    for (int y = blockIdx.y; y < h; y += gridDim.y) {
        const size_t idx = (size_t)y * w + x;
        const Sample s = sample_at(strength[idx], x, y, kx, ky, h, w);
        const size_t r0 = (size_t)s.y0 * w;
        const size_t r1 = (size_t)s.y1 * w;
#pragma unroll
        for (int p = 0; p < kMaxPlanes; ++p) {
            if (p >= n_planes) break;
            planes.out[p][idx] = lerp_at(planes.in[p] + r0, planes.in[p] + r1, s);
        }
    }
}

// local row i in [0, block_h + 2*halo) of the window [top; mid; bot]
__device__ __forceinline__ const float* window_row(const float* top, const float* mid,
                                                   const float* bot, int i, int halo,
                                                   int block_h, int w) {
    if (i < halo) return top + (size_t)i * w;
    if (i < halo + block_h) return mid + (size_t)(i - halo) * w;
    return bot + (size_t)(i - halo - block_h) * w;
}

__device__ __forceinline__ int local_row(int y, int row_origin, int halo, int h) {
    const int r = (y - row_origin + halo) % h;
    return r < 0 ? r + h : r;
}

__global__ void warp_bilinear_block(BlockPlanes planes, int n_planes,
                                    const float* __restrict__ strength, float kx, float ky,
                                    int block_h, int w, int h, int row_origin, int halo) {
    const int x = blockIdx.x * blockDim.x + threadIdx.x;
    if (x >= w) return;
    for (int ly = blockIdx.y; ly < block_h; ly += gridDim.y) {
        const size_t idx = (size_t)ly * w + x;
        const Sample s = sample_at(strength[idx], x, row_origin + ly, kx, ky, h, w);
        const int i0 = local_row(s.y0, row_origin, halo, h);
        const int i1 = local_row(s.y1, row_origin, halo, h);
#pragma unroll
        for (int p = 0; p < kMaxPlanes; ++p) {
            if (p >= n_planes) break;
            const float* r0 = window_row(planes.top[p], planes.mid[p], planes.bot[p], i0, halo,
                                         block_h, w);
            const float* r1 = window_row(planes.top[p], planes.mid[p], planes.bot[p], i1, halo,
                                         block_h, w);
            planes.out[p][idx] = lerp_at(r0, r1, s);
        }
    }
}

dim3 grid_for(int h, int w) {
    return dim3((w + kThreads - 1) / kThreads, h < kMaxGridY ? h : kMaxGridY);
}

}  // namespace

extern "C" int kanter_warp_bilinear_f32(const float* in0, const float* in1, const float* in2,
                                        const float* in3, float* out0, float* out1, float* out2,
                                        float* out3, int n_planes, const float* strength,
                                        float kx, float ky, int h, int w, cudaStream_t stream) {
    if (n_planes < 1 || n_planes > kMaxPlanes) return (int)cudaErrorInvalidValue;
    const Planes planes = {{in0, in1, in2, in3}, {out0, out1, out2, out3}};
    warp_bilinear<<<grid_for(h, w), kThreads, 0, stream>>>(planes, n_planes, strength, kx, ky,
                                                           h, w);
    return (int)cudaGetLastError();
}

// per plane p: top_p and bot_p hold `halo` rows, mid_p and out_p `block_h`
// rows, all of width w; strength is the block's [block_h, w] map
extern "C" int kanter_warp_block_f32(const float* top0, const float* top1, const float* top2,
                                     const float* top3, const float* mid0, const float* mid1,
                                     const float* mid2, const float* mid3, const float* bot0,
                                     const float* bot1, const float* bot2, const float* bot3,
                                     float* out0, float* out1, float* out2, float* out3,
                                     int n_planes, const float* strength, float kx, float ky,
                                     int block_h, int w, int h, int row_origin, int halo,
                                     cudaStream_t stream) {
    if (n_planes < 1 || n_planes > kMaxPlanes || halo < 1 || h < 1) {
        return (int)cudaErrorInvalidValue;
    }
    const BlockPlanes planes = {{top0, top1, top2, top3},
                                {mid0, mid1, mid2, mid3},
                                {bot0, bot1, bot2, bot3},
                                {out0, out1, out2, out3}};
    warp_bilinear_block<<<grid_for(block_h, w), kThreads, 0, stream>>>(
        planes, n_planes, strength, kx, ky, block_h, w, h, row_origin, halo);
    return (int)cudaGetLastError();
}
