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
// The C entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGridY = 65535;
constexpr int kMaxPlanes = 4;

struct Planes {
    const float* in[kMaxPlanes];
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

__global__ void warp_bilinear(Planes planes, int n_planes, const float* __restrict__ strength,
                              float kx, float ky, int h, int w) {
    const int x = blockIdx.x * blockDim.x + threadIdx.x;
    if (x >= w) return;
    for (int y = blockIdx.y; y < h; y += gridDim.y) {
        const size_t idx = (size_t)y * w + x;
        const float m = strength[idx];
        float ms = m < 0.0f ? 0.0f : (m > 1.0f ? 1.0f : m);
        if (m != m) ms = 0.5f;
        const float d = __fsub_rn(ms, 0.5f);
        const float u = __fadd_rn((float)x, __fmul_rn(kx, d));
        const float v = __fadd_rn((float)y, __fmul_rn(ky, d));
        const float uf = clip_floor(u);
        const float vf = clip_floor(v);
        const float fu = __fsub_rn(u, uf);
        const float fv = __fsub_rn(v, vf);
        const int x0 = wrap_index(uf, w);
        const int y0 = wrap_index(vf, h);
        const int x1 = x0 + 1 == w ? 0 : x0 + 1;
        const int y1 = y0 + 1 == h ? 0 : y0 + 1;
        const size_t r0 = (size_t)y0 * w;
        const size_t r1 = (size_t)y1 * w;
#pragma unroll
        for (int p = 0; p < kMaxPlanes; ++p) {
            if (p >= n_planes) break;
            const float* in = planes.in[p];
            const float n00 = in[r0 + x0];
            const float n10 = in[r0 + x1];
            const float n01 = in[r1 + x0];
            const float n11 = in[r1 + x1];
            const float nx0 = __fadd_rn(n00, __fmul_rn(fu, __fsub_rn(n10, n00)));
            const float nx1 = __fadd_rn(n01, __fmul_rn(fu, __fsub_rn(n11, n01)));
            planes.out[p][idx] = __fadd_rn(nx0, __fmul_rn(fv, __fsub_rn(nx1, nx0)));
        }
    }
}

}  // namespace

extern "C" int kanter_warp_bilinear_f32(const float* in0, const float* in1, const float* in2,
                                        const float* in3, float* out0, float* out1, float* out2,
                                        float* out3, int n_planes, const float* strength,
                                        float kx, float ky, int h, int w, cudaStream_t stream) {
    if (n_planes < 1 || n_planes > kMaxPlanes) return (int)cudaErrorInvalidValue;
    const Planes planes = {{in0, in1, in2, in3}, {out0, out1, out2, out3}};
    const dim3 block(kThreads);
    const dim3 grid((w + kThreads - 1) / kThreads, h < kMaxGridY ? h : kMaxGridY);
    warp_bilinear<<<grid, block, 0, stream>>>(planes, n_planes, strength, kx, ky, h, w);
    return (int)cudaGetLastError();
}
