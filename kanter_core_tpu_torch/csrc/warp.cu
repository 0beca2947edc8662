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
// A batch. The dense entry takes B canvases in one launch, the canvas in
// blockIdx.z (B <= 65535), every operand at its own batch stride with 64-bit
// offsets: a stride of 0 shares one plane or one strength map among all
// canvases, as vmap broadcasts an unbatched operand (the batched flagship
// warps batched planes by an unbatched Noise strength). Every canvas is
// warped exactly as a single one is. This replaces the batching rule of
// `_warp_pallas_wrapped` (pallas_warp.py:468-479), which maps the rank-2 TPU
// kernel over a batch whose operands are all batched.
//
// The block form, `kanter_warp_block_f32`, replaces `_warp_block`
// (pallas_warp.py:306), which `_warp_pallas_sharded` (pallas_warp.py:376)
// runs on every shard of a row-sharded plane after a ring exchange of
// +-halo rows. Output row ly of a [block_h, W] block is global row
// y = row_origin + ly; the coordinates above use that global y and the
// global height H, and the texels come from the window [top; block; bot]
// through three pointers per plane (`top` the halo rows before the block,
// `bot` those after it; no concatenated copy). The JAX package finds a
// sample's window row as `row_local`, (y0 - row_origin + halo) mod H
// (ops/warp.py:263-266). Same arithmetic, same texels: a sharded warp is
// bit-identical to the dense one. Bound as the dense form: bytes, 36 per
// pixel plus the halo rows. What the design does about a block's costs:
//
//   1. No remainder by a runtime divisor on the fast path (a general one
//      would take four per pixel: the column's and the row's wrap and two
//      `local_row`s). A sample's floor lies within cx = ceil(|kx|/2)
//      columns and cy = ceil(|ky|/2) rows of its pixel. The caller
//      guarantees halo >= cy + 2; where also block_h + 2 halo <= H (the
//      mesh's gate gives it), the window row is r0 = (int)vf - row_origin +
//      halo from the unwrapped floor -- the same residue mod H of a number
//      in [0, H) -- and r1 = r0 + 1; where cx + 2 <= W the column wraps by
//      one conditional add or subtract. The host picks this index mode per
//      call (ops/warp.py `warp_block_index_mode`) and the entry checks it
//      again; the other modes keep a remainder for the column (kColGeneral)
//      or for both (kGeneral), for narrow planes, huge or non-finite kx,
//      and windows taller than the plane.
//   2. One segment pick (top, block or bot) per sample row, shared by the
//      planes, each of which then adds only its base pointer; the rows
//      whose samples all lie in the block itself -- all but the first cy
//      and the last cy + 1 -- read `block` with no pick at all.
//   3. Two adjacent pixels per thread, with 8-byte strength loads and
//      output stores where W is even and the strength aligned (else two
//      pixels a block's width apart, scalar), on a tile of 8 rows x 64
//      columns (16 x 32 where samples reach more than 4 rows): the rows of
//      a block share most of their source rows in L1.
//
// Tried and taken out (PERF.md): staging each plane's source window in
// shared memory with 16-byte cp.async (slower than the direct gather at
// every tile tried); 1 or 4 pixels per thread, register bounds for more
// blocks per SM (scripts/kernel_tile_sweep.py --warp builds these from an
// edited copy of this file): slower.
//
// The C entry points launch on the caller's stream, allocate nothing and
// return cudaGetLastError().

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGridY = 65535;
constexpr int kMaxPlanes = 4;
constexpr int kMaxGridZ = 65535;  // canvases per launch

struct Planes {
    const float* in[kMaxPlanes];
    float* out[kMaxPlanes];
    long long in_stride[kMaxPlanes];  // batch strides in floats; 0: shared
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

// BATCHED: canvas blockIdx.z of each operand at its batch stride; one plane
// keeps the instance without the batch's 64-bit arithmetic (on an H100 SXM
// the batched instance takes 2.9% longer on one 4096^2 RGBA image:
// scripts/batch_instance_ab.py)
template <bool BATCHED>
__global__ void warp_bilinear(Planes planes, int n_planes, const float* __restrict__ strength,
                              float kx, float ky, int h, int w, long long strength_stride,
                              long long out_stride) {
    const int x = blockIdx.x * blockDim.x + threadIdx.x;
    if (x >= w) return;
    if (BATCHED) {
        const long long z = blockIdx.z;
        strength += z * strength_stride;
#pragma unroll
        for (int p = 0; p < kMaxPlanes; ++p) {
            planes.in[p] += z * planes.in_stride[p];
            planes.out[p] += z * out_stride;
        }
    }
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

// ---- the block form ----

// pixels per thread of a block launch, adjacent in a row
constexpr int kPx = 2;

// How a block launch finds a sample's texels; the host picks one
// (`warp_block_index_mode` in ops/warp.py) and this entry checks its
// preconditions again.
constexpr int kFast = 0;        // conditional column wrap, unwrapped window row
constexpr int kColGeneral = 1;  // remainder column wrap, unwrapped window row
constexpr int kGeneral = 2;     // remainder column wrap, remainder window row

// One launch's row block: per plane p, `top[p]` and `bot[p]` hold `halo`
// rows and `mid[p]` and `out[p]` `block_h` rows, all of width w; the window
// of plane p is [top; mid; bot], window row r in [0, block_h + 2 halo).
struct BlockArgs {
    const float* top[kMaxPlanes];
    const float* mid[kMaxPlanes];
    const float* bot[kMaxPlanes];
    float* out[kMaxPlanes];
    const float* strength;
    int n_planes;
    float kx, ky;
    int block_h, w, h, row_origin, halo;
    int cx, cy;  // ceil(|kx| / 2), ceil(|ky| / 2): how far a sample lies from its pixel
};

// where output pixel (x, row_origin + ly) samples: the arithmetic of
// sample_at, the rows as window rows
struct BlockSample {
    float fu, fv;
    int x0, x1, r0, r1;
};

__device__ __forceinline__ int local_row(int y, int row_origin, int halo, int h) {
    const int r = (y - row_origin + halo) % h;
    return r < 0 ? r + h : r;
}

template <int MODE>
__device__ __forceinline__ BlockSample block_sample(float m, int x, int ly, const BlockArgs& a) {
    float ms = m < 0.0f ? 0.0f : (m > 1.0f ? 1.0f : m);
    if (m != m) ms = 0.5f;
    const float d = __fsub_rn(ms, 0.5f);
    const float u = __fadd_rn((float)x, __fmul_rn(a.kx, d));
    const float v = __fadd_rn((float)(a.row_origin + ly), __fmul_rn(a.ky, d));
    const float uf = clip_floor(u);
    const float vf = clip_floor(v);
    BlockSample s;
    s.fu = __fsub_rn(u, uf);
    s.fv = __fsub_rn(v, vf);
    if (MODE == kFast) {
        // kx finite and cx + 2 <= w: uf lies in [x - cx, x + cx], inside [-w, 2w)
        const int i = (int)uf;
        s.x0 = i < 0 ? i + a.w : (i >= a.w ? i - a.w : i);
    } else {
        s.x0 = wrap_index(uf, a.w);
    }
    s.x1 = s.x0 + 1 == a.w ? 0 : s.x0 + 1;
    if (MODE == kGeneral) {
        const int y0 = wrap_index(vf, a.h);
        const int y1 = y0 + 1 == a.h ? 0 : y0 + 1;
        s.r0 = local_row(y0, a.row_origin, a.halo, a.h);
        s.r1 = local_row(y1, a.row_origin, a.halo, a.h);
    } else {
        // halo >= cy + 2 and block_h + 2 halo <= h: vf lies in [y - cy, y + cy],
        // so r0 lies in [2, block_h + 2 halo - 2) and is local_row(y0), the
        // same residue mod h of a number in [0, h)
        s.r0 = (int)vf - a.row_origin + a.halo;
        s.r1 = s.r0 + 1;
    }
    return s;
}

// window row r of plane p, the segment resolved once per sample row and
// shared by every plane
struct RowRef {
    int seg;  // 0 top, 1 mid, 2 bot
    int off;  // row in that segment
};

__device__ __forceinline__ RowRef row_ref(int r, int halo, int block_h) {
    if (r < halo) return {0, r};
    if (r < halo + block_h) return {1, r - halo};
    return {2, r - halo - block_h};
}

__device__ __forceinline__ const float* row_of(const BlockArgs& a, int p, RowRef q) {
    const float* base = q.seg == 0 ? a.top[p] : (q.seg == 1 ? a.mid[p] : a.bot[p]);
    return base + (size_t)q.off * a.w;
}

__device__ __forceinline__ float lerp4(float n00, float n10, float n01, float n11, float fu,
                                       float fv) {
    const float nx0 = __fadd_rn(n00, __fmul_rn(fu, __fsub_rn(n10, n00)));
    const float nx1 = __fadd_rn(n01, __fmul_rn(fu, __fsub_rn(n11, n01)));
    return __fadd_rn(nx0, __fmul_rn(fv, __fsub_rn(nx1, nx0)));
}

// The kPx samples of one thread for every plane. INNER: every sample row
// lies in `mid` (no segment to pick).
template <int MODE, bool VEC, bool INNER>
__device__ __forceinline__ void shade_row(const BlockArgs& a, const BlockSample (&s)[kPx],
                                          int x_first, int x_step, size_t row) {
    RowRef q0[kPx], q1[kPx];
    if constexpr (!INNER) {
#pragma unroll
        for (int i = 0; i < kPx; ++i) {
            q0[i] = row_ref(s[i].r0, a.halo, a.block_h);
            q1[i] = row_ref(s[i].r1, a.halo, a.block_h);
        }
    }
#pragma unroll
    for (int p = 0; p < kMaxPlanes; ++p) {
        if (p >= a.n_planes) break;
        float o[kPx];
#pragma unroll
        for (int i = 0; i < kPx; ++i) {
            const float* r0;
            const float* r1;
            if constexpr (INNER) {
                r0 = a.mid[p] + (size_t)(s[i].r0 - a.halo) * a.w;
                r1 = r0 + a.w;
            } else {
                r0 = row_of(a, p, q0[i]);
                r1 = row_of(a, p, q1[i]);
            }
            o[i] = lerp4(__ldg(r0 + s[i].x0), __ldg(r0 + s[i].x1), __ldg(r1 + s[i].x0),
                         __ldg(r1 + s[i].x1), s[i].fu, s[i].fv);
        }
        float* dst = a.out[p] + row;
        if constexpr (VEC) {
            *reinterpret_cast<float2*>(dst + x_first) = make_float2(o[0], o[1]);
        } else {
#pragma unroll
            for (int i = 0; i < kPx; ++i) {
                if (x_first + i * x_step < a.w) dst[x_first + i * x_step] = o[i];
            }
        }
    }
}

// A block of tw / kPx x th <= 256 threads covers th rows x tw columns; a
// thread's kPx pixels of a row are adjacent, with 8-byte strength loads and
// output stores (VEC), or blockDim.x apart.
template <int MODE, bool VEC>
__global__ void __launch_bounds__(kThreads)
    warp_block_direct(const __grid_constant__ BlockArgs a) {
    const int x_first = blockIdx.x * blockDim.x * kPx + (VEC ? threadIdx.x * kPx : threadIdx.x);
    const int x_step = VEC ? 1 : blockDim.x;
    if (VEC && x_first >= a.w) return;  // w % kPx == 0: a thread's pixels are all in or all out
    for (int ly = blockIdx.y * blockDim.y + threadIdx.y; ly < a.block_h;
         ly += gridDim.y * blockDim.y) {
        const size_t row = (size_t)ly * a.w;
        float m[kPx];
        if (VEC) {
            const float2 t = __ldg(reinterpret_cast<const float2*>(a.strength + row + x_first));
            m[0] = t.x, m[1] = t.y;
        } else {
#pragma unroll
            for (int i = 0; i < kPx; ++i) {
                const int x = x_first + i * x_step;
                m[i] = x < a.w ? __ldg(a.strength + row + x) : 0.0f;
            }
        }
        BlockSample s[kPx];
#pragma unroll
        for (int i = 0; i < kPx; ++i) {
            // a pixel past the edge (not stored) samples as the last column does
            const int x = min(x_first + i * x_step, a.w - 1);
            s[i] = block_sample<MODE>(m[i], x, ly, a);
        }
        // a row's samples lie within cy rows of it, and r1 one below r0
        const bool inner = MODE != kGeneral && ly >= a.cy && ly + a.cy + 2 <= a.block_h;
        if (inner) {
            shade_row<MODE, VEC, true>(a, s, x_first, x_step, row);
        } else {
            shade_row<MODE, VEC, false>(a, s, x_first, x_step, row);
        }
    }
}

bool aligned_to(const void* p, int bytes) {
    return (reinterpret_cast<size_t>(p) & (size_t)(bytes - 1)) == 0;
}

template <int MODE>
int launch_direct(const BlockArgs& a, bool vec, int th, int tw, cudaStream_t stream) {
    const dim3 block(tw / kPx, th);
    const long long ty = ((long long)a.block_h + th - 1) / th;
    const dim3 grid((a.w + tw - 1) / tw, (unsigned)(ty < kMaxGridY ? ty : kMaxGridY));
    if (vec) {
        warp_block_direct<MODE, true><<<grid, block, 0, stream>>>(a);
    } else {
        warp_block_direct<MODE, false><<<grid, block, 0, stream>>>(a);
    }
    return (int)cudaGetLastError();
}

dim3 grid_for(int h, int w, int batch) {
    return dim3((w + kThreads - 1) / kThreads, h < kMaxGridY ? h : kMaxGridY, batch);
}

}  // namespace

// `batch` canvases: plane p of canvas b at in_p + b * in_stride_p, its strength
// at strength + b * strength_stride, its output at out_p + b * out_stride
// (floats; an input stride of 0 shares the plane or the map among canvases).
extern "C" int kanter_warp_bilinear_f32(const float* in0, const float* in1, const float* in2,
                                        const float* in3, float* out0, float* out1, float* out2,
                                        float* out3, int n_planes, const float* strength,
                                        float kx, float ky, int h, int w, int batch,
                                        long long in_stride0, long long in_stride1,
                                        long long in_stride2, long long in_stride3,
                                        long long strength_stride, long long out_stride,
                                        cudaStream_t stream) {
    if (n_planes < 1 || n_planes > kMaxPlanes || h < 1 || w < 1 || batch < 1 ||
        batch > kMaxGridZ) {
        return (int)cudaErrorInvalidValue;
    }
    const Planes planes = {{in0, in1, in2, in3},
                           {out0, out1, out2, out3},
                           {in_stride0, in_stride1, in_stride2, in_stride3}};
    if (batch > 1) {
        warp_bilinear<true><<<grid_for(h, w, batch), kThreads, 0, stream>>>(
            planes, n_planes, strength, kx, ky, h, w, strength_stride, out_stride);
    } else {
        warp_bilinear<false><<<grid_for(h, w, 1), kThreads, 0, stream>>>(
            planes, n_planes, strength, kx, ky, h, w, 0, 0);
    }
    return (int)cudaGetLastError();
}

// The block form. Per plane p: top_p and bot_p hold `halo` rows, mid_p and
// out_p `block_h` rows, all of width w; strength is the block's [block_h, w]
// map. `mode` is the index mode (kFast, kColGeneral, kGeneral); a block of
// tw / 2 x th threads covers th rows x tw columns, two pixels per thread,
// adjacent with 8-byte strength loads and output stores when vec. Returns
// cudaErrorInvalidValue for a launch whose preconditions fail.
extern "C" int kanter_warp_block_f32(const float* top0, const float* top1, const float* top2,
                                     const float* top3, const float* mid0, const float* mid1,
                                     const float* mid2, const float* mid3, const float* bot0,
                                     const float* bot1, const float* bot2, const float* bot3,
                                     float* out0, float* out1, float* out2, float* out3,
                                     int n_planes, const float* strength, float kx, float ky,
                                     int block_h, int w, int h, int row_origin, int halo,
                                     int mode, int vec, int th, int tw,
                                     cudaStream_t stream) {
    if (n_planes < 1 || n_planes > kMaxPlanes || halo < 1 || h < 1 || w < 1 || block_h < 1 ||
        th < 1 || tw < kPx || tw % kPx || (tw / kPx) * th > kThreads || mode < kFast ||
        mode > kGeneral) {
        return (int)cudaErrorInvalidValue;
    }
    BlockArgs a = {{top0, top1, top2, top3},
                   {mid0, mid1, mid2, mid3},
                   {bot0, bot1, bot2, bot3},
                   {out0, out1, out2, out3},
                   strength, n_planes, kx, ky, block_h, w, h, row_origin, halo, 0, 0};
    const float lim = 1e9f;
    const bool kx_finite = fabsf(kx) <= lim, ky_finite = fabsf(ky) <= lim;
    a.cx = kx_finite ? (int)ceilf(fabsf(kx) * 0.5f) : 0;
    a.cy = ky_finite ? (int)ceilf(fabsf(ky) * 0.5f) : 0;
    const int max_exact = 1 << 24;  // every pixel coordinate is an exact f32
    const bool row_fast = (long long)block_h + 2LL * halo <= h && h <= max_exact;
    const bool col_fast = kx_finite && a.cx + 2 <= w && w <= max_exact;
    // every mode reads only window rows: the halo covers the displacement
    if (!ky_finite || a.cy + 2 > halo || (mode != kGeneral && !row_fast) ||
        (mode == kFast && !col_fast)) {
        return (int)cudaErrorInvalidValue;
    }
    if (vec) {
        bool ok = w % kPx == 0 && aligned_to(strength, 4 * kPx);
        for (int p = 0; p < n_planes; ++p) ok = ok && aligned_to(a.out[p], 4 * kPx);
        if (!ok) return (int)cudaErrorInvalidValue;
    }
    switch (mode) {
        case kFast: return launch_direct<kFast>(a, vec, th, tw, stream);
        case kColGeneral: return launch_direct<kColGeneral>(a, vec, th, tw, stream);
        default: return launch_direct<kGeneral>(a, vec, th, tw, stream);
    }
}
