// Separable toroidal Gaussian blur of one [H, W] f32 plane, or of every
// canvas of a [B, H, W] batch in one launch, for Hopper (sm_90a).
//
// Replaces the TPU kernels of kanter_core_tpu/ops/pallas_blur.py: `_halo_call`
// (pallas_blur.py:77) and `_padded_call` (pallas_blur.py:260), dispatched by
// `blur_pallas` (pallas_blur.py:393) through `_blur_pallas_wrapped`, and, as
// the block entry, `_blur_block` (pallas_blur.py:419), which
// `_blur_pallas_sharded` (pallas_blur.py:474) runs on every shard of a
// row-sharded plane after a ring exchange of +-radius rows. Like them it
// computes exactly what kanter_core_tpu/ops/blur._blur_axis0 computes on the
// plane and then on its transpose:
//
//   vertical:   tmp[y, x] = sum_t w[t] * in [(y + t - r) mod H, x]
//   horizontal: out[y, x] = sum_t w[t] * tmp[y, (x + t - r) mod W]
//
// for t = 0 .. 2r in that order, each sum starting from 0.0f and adding every
// separately rounded product (__fmul_rn, __fadd_rn: no FMA contraction; the
// build also passes -fmad=false). Starting from the first product instead
// would turn a leading -0.0 product into -0.0 where the reference has +0.0.
// The taps are the host-computed f32 values of blur.gaussian_taps, handed
// over as a kernel parameter; they are never recomputed here.
//
// What bounds it on this card: 8 bytes per pixel from device memory (the
// plane read once, written once) against 2 * 2 * (2r + 1) float instructions
// per pixel that may not fuse, so a tap costs two instruction slots; the
// bytes bound is above the instruction bound up to 19 taps and below it from
// 21 on. The one-pixel-per-thread kernel this file held before lost both
// ways: its vertical pass made one global load and two integer remainders
// per tap (three quarters of the time at 37 taps), and the intermediate
// plane went through device memory.
//
// The design. One launch; a block of 256 threads walks over output tiles of
// th x tw pixels (the host picks th and tw per radius, `blur_tile_plan` in
// ops/blur.py), and per tile
//
//   1. stages the (th + 2r) x (tw + 2ra) input window into shared memory
//      (ra = r rounded up to 4, so that the window starts on a 16-byte
//      boundary). All wrapping happens here, by conditional add/subtract
//      (tiles whose window can pass the plane's far edge twice, i.e. planes
//      narrower or shorter than tile + radius, take the kernel instance that
//      wraps with a remainder). The copies are asynchronous (cp.async), all
//      of a thread's in flight at once: 16 bytes each where W is a multiple
//      of 4 and every source pointer is 16-byte aligned (4-byte copies cost
//      0.03 ms more at 4096^2), else 4 bytes each, so the block entry's halo
//      slices need no alignment;
//   2. runs the vertical pass from that window into a th x (tw + 2r) shared
//      tile: a thread owns one column and a strip of 8 rows and slides a
//      register window down the column, one shared load per 8 * 2 float
//      instructions, the taps read from the kernel's parameters eight at a
//      time ahead of their steps;
//   3. runs the horizontal pass from the shared tile to the output: a thread
//      owns 8 adjacent pixels of a row, slides the same window along it with
//      one 16-byte shared load per four taps, and stores 2 x 16 bytes.
//
// The inner loops hold no division and no remainder (a task index is split
// by a multiply-high with a per-block reciprocal). The intermediate never
// leaves the SM, so device memory sees the 8 bytes per pixel of the bound;
// the halo re-reads of neighbouring tiles are served by L2. Two or more
// blocks share an SM (the plan keeps a tile under half its shared memory
// where the radius allows), so one block's staging overlaps another's
// arithmetic. Every radius up to 31 (63 taps, sigma up to 10.33) and every
// plane shape takes this one kernel; per output the sequence of products and
// sums is the one above, so the result is bit-identical to the plain version
// whatever the tiling. Wider blurs (a Blur node takes sigma up to 256) keep
// the two-pass form at the end of this file: one pixel per thread through a
// scratch plane, taps in shared memory, a row walk instead of a remainder
// per tap.
//
// A batch. The dense entry takes B <= 65535 canvases in one launch, each at
// its own batch stride for the input and the output (64-bit offsets: 16
// canvases of 4096^2 floats are 1 GiB, and one more doubling of either passes
// 2^31 elements). Every canvas is blurred exactly as a single plane is. The
// persistent grid walks the tiles of every canvas in turn, so one wave of
// blocks covers the whole batch; the two-pass form carries the canvas in
// blockIdx.z, through a scratch buffer the size of the batch. This replaces
// the batching rule of `_blur_pallas_wrapped` (pallas_blur.py:552-556),
// which maps the rank-2 TPU kernel over the batch one canvas after another.
//
// The block form, `kanter_blur_block_f32`, blurs one [block_h, W] row block
// whose vertical neighbours arrive as two explicit halos: `top`, the r rows
// before the block, and `bot`, the r rows after it. It is the same kernel:
// only the source of a staged row differs (picked per row among the three
// buffers, no concatenated copy), so a sharded blur is bit-identical to the
// dense one. Bound as the dense form plus the 2 * r * W * 4 halo bytes.
//
// The C entry points launch on the caller's stream, allocate nothing and
// return cudaGetLastError() (cudaErrorInvalidValue for a tile the kernel
// does not take).

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStrip = 8;          // outputs per thread in either pass
constexpr int kMaxTaps = 63;
constexpr int kLaneCols = 8;       // staged columns per lane: tw + 2ra <= 256
constexpr int kMaxSmem = 232448;   // dynamic shared memory a block may take
constexpr int kMaxDevices = 64;
constexpr int kMaxGridZ = 65535;   // canvases per launch

struct Taps {
    float w[kMaxTaps + 1];
};

// i wrapped into [0, n). GENERAL: any i; otherwise -n <= i < 2n.
template <bool GENERAL>
__device__ __forceinline__ int wrap_index(int i, int n) {
    if (GENERAL) {
        i %= n;
        return i < 0 ? i + n : i;
    }
    if (i < 0) i += n;
    if (i >= n) i -= n;
    return i;
}

// Where a staged row comes from: row sy of the wrapped plane ...
struct PlaneRows {
    const float* in;
    int h;
    // the rows of canvas z of a batch, `stride` floats apart
    __device__ __forceinline__ PlaneRows canvas(long long z, long long stride) const {
        return {in + z * stride, h};
    }
    template <bool GENERAL>
    __device__ __forceinline__ const float* row(int sy, int w) const {
        return in + (size_t)wrap_index<GENERAL>(sy, h) * w;
    }
    // a walk down consecutive rows from sy, for the two-pass form
    __device__ __forceinline__ int first(int sy) const { return wrap_index<true>(sy, h); }
    __device__ __forceinline__ int next(int i) const { return i + 1 == h ? 0 : i + 1; }
    __device__ __forceinline__ const float* at(int i, int w) const { return in + (size_t)i * w; }
};

// ... or row sy in [-r, block_h + r) of the window [top; block; bot]. Rows
// past the window belong to outputs past the block, which are not stored.
struct WindowRows {
    const float* top;
    const float* block;
    const float* bot;
    int block_h, r;
    // one row block is one canvas
    __device__ __forceinline__ WindowRows canvas(long long, long long) const { return *this; }
    template <bool GENERAL>
    __device__ __forceinline__ const float* row(int sy, int w) const {
        sy = min(sy, block_h + r - 1);
        if (sy < 0) return top + (size_t)(sy + r) * w;
        if (sy >= block_h) return bot + (size_t)(sy - block_h) * w;
        return block + (size_t)sy * w;
    }
    __device__ __forceinline__ int first(int sy) const { return sy; }
    __device__ __forceinline__ int next(int i) const { return i + 1; }
    __device__ __forceinline__ const float* at(int i, int w) const { return row<false>(i, w); }
};

// floor(q / d) as a multiply-high, exact for q * d < 2^32 and d >= 2
__device__ __forceinline__ unsigned reciprocal(unsigned d) { return 0xFFFFFFFFu / d + 1u; }

// One step of the sliding window, s = t mod 8: every accumulator takes its
// tap-t product, then the slot of the oldest input takes the next one (read
// before the arithmetic, so that its latency hides behind it).
#define BLUR_TAP_STEP(NEXT)                                                            \
    {                                                                                  \
        const float next = (NEXT);                                                     \
        _Pragma("unroll") for (int j = 0; j < kStrip; ++j) {                           \
            acc[j] = __fadd_rn(acc[j], __fmul_rn(win[(j + s) & (kStrip - 1)], wts[s])); \
        }                                                                              \
        win[s] = next;                                                                 \
    }

// The taps t0 .. t0 + 7, read together ahead of their steps (the table is
// padded to 64, so the tail group reads past ntaps without harm).
#define BLUR_LOAD_TAPS(T0)                                                 \
    float wts[kStrip];                                                     \
    _Pragma("unroll") for (int s = 0; s < kStrip; ++s) wts[s] = taps.w[(T0) + s];

template <class Rows, bool GENERAL>
__global__ void __launch_bounds__(kThreads)
blur_tiles(const Rows batch_rows, float* __restrict__ batch_out,
           const __grid_constant__ Taps taps, const int ntaps, const int h, const int w,
           const int th, const int tw, const int tiles_x, const int ntiles, const int batch,
           const int vec_in, const int vec_out, const long long in_stride,
           const long long out_stride) {
    extern __shared__ __align__(16) float smem[];
    const int r = (ntaps - 1) >> 1;
    const int ra = (r + 3) & ~3;  // the staged window starts 16-byte aligned
    const int in_rows = th + 2 * r;
    const int cols = tw + 2 * r;
    const int staged = tw + 2 * ra;
    const int pitch = staged + 4;
    // one spare row and four spare columns take the window's last, unused load
    float* const tile = smem;                         // (in_rows + 1) x pitch
    float* const mid = smem + (in_rows + 1) * pitch;  // th x pitch
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int groups = tw / kStrip;
    const int v_tasks = (th / kStrip) * cols;
    const int h_tasks = th * groups;
    const unsigned inv_cols = reciprocal(cols);
    const unsigned inv_groups = reciprocal(groups);
    const int chunks = staged >> 2;
    const unsigned inv_chunks = reciprocal(chunks);

    // the tasks are the tiles of every canvas, canvas after canvas
    const long long tasks = (long long)ntiles * batch;
    for (long long task = blockIdx.x; task < tasks; task += gridDim.x) {
        const long long z = task / ntiles;
        const int tile_id = (int)(task - z * ntiles);
        const Rows rows = batch_rows.canvas(z, in_stride);
        float* const out = batch_out + z * out_stride;
        const int tile_y = tile_id / tiles_x;
        const int y0 = tile_y * th;
        const int x0 = (tile_id - tile_y * tiles_x) * tw;

        // 1. stage the wrapped input window, columns x0 - ra .. x0 + tw + ra:
        // asynchronous copies straight into shared memory, all of a thread's
        // share of the window in flight before it waits
        if (vec_in) {
            // 16 bytes a copy: rows are 16-byte aligned and W is a multiple
            // of 4, so a chunk never straddles the plane's edge
            for (int q = threadIdx.x; q < in_rows * chunks; q += kThreads) {
                const int i = __umulhi((unsigned)q, inv_chunks);
                const int m = q - i * chunks;
                const float* src = rows.template row<GENERAL>(y0 - r + i, w)
                                   + wrap_index<GENERAL>(x0 - ra + 4 * m, w);
                __pipeline_memcpy_async(tile + i * pitch + 4 * m, src, 4 * sizeof(float));
            }
        } else {
            int gx[kLaneCols];
#pragma unroll
            for (int c = 0; c < kLaneCols; ++c) {
                gx[c] = wrap_index<GENERAL>(x0 - ra + lane + 32 * c, w);
            }
            for (int i = warp; i < in_rows; i += kWarps) {
                const float* src = rows.template row<GENERAL>(y0 - r + i, w);
                float* dst = tile + i * pitch + lane;
#pragma unroll
                for (int c = 0; c < kLaneCols; ++c) {
                    if (lane + 32 * c < staged) {
                        __pipeline_memcpy_async(dst + 32 * c, src + gx[c], sizeof(float));
                    }
                }
            }
        }
        __pipeline_commit();
        __pipeline_wait_prior(0);
        __syncthreads();

        // 2. vertical pass: (strip of 8 rows, column) per thread
        for (int q = threadIdx.x; q < v_tasks; q += kThreads) {
            const int strip = __umulhi((unsigned)q, inv_cols);
            const int c = q - strip * cols;
            const float* col = tile + strip * kStrip * pitch + (ra - r) + c;
            float win[kStrip], acc[kStrip];
#pragma unroll
            for (int j = 0; j < kStrip; ++j) {
                win[j] = col[j * pitch];
                acc[j] = 0.0f;
            }
            int t0 = 0;
            for (; t0 + kStrip <= ntaps; t0 += kStrip) {  // whole groups of 8 taps
                BLUR_LOAD_TAPS(t0)
                col += kStrip * pitch;
#pragma unroll
                for (int s = 0; s < kStrip; ++s) BLUR_TAP_STEP(col[s * pitch])
            }
            {  // the last, partial group
                BLUR_LOAD_TAPS(t0)
                col += kStrip * pitch;
#pragma unroll
                for (int s = 0; s < kStrip; ++s) {
                    if (t0 + s < ntaps) BLUR_TAP_STEP(col[s * pitch])
                }
            }
            float* m = mid + strip * kStrip * pitch + c;
#pragma unroll
            for (int j = 0; j < kStrip; ++j) m[j * pitch] = acc[j];
        }
        __syncthreads();

        // 3. horizontal pass: (row, group of 8 adjacent pixels) per thread
        for (int q = threadIdx.x; q < h_tasks; q += kThreads) {
            const int y = __umulhi((unsigned)q, inv_groups);
            const int g = q - y * groups;
            const float4* p = reinterpret_cast<const float4*>(mid + y * pitch + g * kStrip);
            float win[kStrip], acc[kStrip];
            {
                const float4 a = p[0], b = p[1];
                win[0] = a.x; win[1] = a.y; win[2] = a.z; win[3] = a.w;
                win[4] = b.x; win[5] = b.y; win[6] = b.z; win[7] = b.w;
            }
            p += 2;
#pragma unroll
            for (int j = 0; j < kStrip; ++j) acc[j] = 0.0f;
#define BLUR_ROW_NEXT ((s & 3) == 0 ? nxt.x : (s & 3) == 1 ? nxt.y : (s & 3) == 2 ? nxt.z : nxt.w)
            int t0 = 0;
            float4 nxt;
            for (; t0 + kStrip <= ntaps; t0 += kStrip) {
                BLUR_LOAD_TAPS(t0)
#pragma unroll
                for (int s = 0; s < kStrip; ++s) {
                    if ((s & 3) == 0) nxt = *p++;
                    BLUR_TAP_STEP(BLUR_ROW_NEXT)
                }
            }
            {
                BLUR_LOAD_TAPS(t0)
#pragma unroll
                for (int s = 0; s < kStrip; ++s) {
                    if (t0 + s < ntaps) {
                        if ((s & 3) == 0) nxt = *p++;
                        BLUR_TAP_STEP(BLUR_ROW_NEXT)
                    }
                }
            }
#undef BLUR_ROW_NEXT
            const int oy = y0 + y;
            const int ox = x0 + g * kStrip;
            if (oy < h && ox < w) {
                float* o = out + (size_t)oy * w + ox;
                if (vec_out && ox + kStrip <= w) {
                    reinterpret_cast<float4*>(o)[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
                    reinterpret_cast<float4*>(o)[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
                } else {
#pragma unroll
                    for (int j = 0; j < kStrip; ++j) {
                        if (ox + j < w) o[j] = acc[j];
                    }
                }
            }
        }
        // the next tile's staging writes `tile` only, and no thread passes the
        // barrier after it before every thread has left this pass
    }
}

#undef BLUR_TAP_STEP
#undef BLUR_LOAD_TAPS

bool aligned16(const void* p) { return (reinterpret_cast<size_t>(p) & 15) == 0; }

template <class Rows, bool GENERAL>
int launch_tiles(const Rows& rows, bool aligned_in, float* out, const Taps& taps, int ntaps,
                 int h, int w, int th, int tw, size_t smem, int batch, long long in_stride,
                 long long out_stride, cudaStream_t stream) {
    auto kernel = blur_tiles<Rows, GENERAL>;
    // per device, once: the shared-memory opt-in of this instance and the SM
    // count (concurrent first calls write the same values)
    static int sms_of[kMaxDevices] = {};
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return (int)err;
    if (device < 0 || device >= kMaxDevices) return (int)cudaErrorInvalidDevice;
    if (sms_of[device] == 0) {
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
        if (err != cudaSuccess) return (int)err;
        int count = 0;
        err = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, device);
        if (err != cudaSuccess) return (int)err;
        sms_of[device] = count;
    }
    const int sms = sms_of[device];
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidValue;
    const int tiles_x = (w + tw - 1) / tw;
    const long long ntiles = (long long)tiles_x * ((h + th - 1) / th);
    if (ntiles > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
    // one wave of blocks walks the tiles of the whole batch (a grid split
    // by canvas in blockIdx.z left a partial second wave: on an H100 SXM,
    // 1.39x the time of 16 single launches at 16 x 4096^2)
    const long long resident = (long long)sms * per_sm;
    const long long tasks = ntiles * batch;
    const int grid = (int)(tasks < resident ? tasks : resident);
    // 16-byte copies and stores where every row starts on a 16-byte boundary
    // (a canvas too: the strides are multiples of 4 floats)
    const int vec_in = aligned_in && w % 4 == 0 && in_stride % 4 == 0;
    const int vec_out = aligned16(out) && w % 4 == 0 && out_stride % 4 == 0;
    kernel<<<grid, kThreads, smem, stream>>>(rows, out, taps, ntaps, h, w, th, tw, tiles_x,
                                             (int)ntiles, batch, vec_in, vec_out, in_stride,
                                             out_stride);
    return (int)cudaGetLastError();
}

// The tile the kernel takes: th and tw multiples of 8, tw at least 16, the
// staged window at most 256 columns, both shared tiles within a block's
// shared memory. Returns the bytes, or 0 for a tile it does not take.
size_t tile_smem(int ntaps, int th, int tw) {
    if (ntaps < 1 || ntaps > kMaxTaps || (ntaps & 1) == 0) return 0;
    const int r = (ntaps - 1) / 2;
    if (th < kStrip || th % kStrip || tw < 2 * kStrip || tw % kStrip) return 0;
    const int staged = tw + 2 * ((r + 3) & ~3);
    if (staged > 32 * kLaneCols) return 0;
    const int pitch = staged + 4;
    const size_t bytes = (size_t)(2 * th + 2 * r + 1) * pitch * sizeof(float);
    return bytes <= (size_t)kMaxSmem ? bytes : 0;
}

// ---- more than 63 taps: two passes through a scratch plane ----
//
// One pixel per thread, the taps staged from device memory into shared
// memory, the vertical pass straight from global memory down a walk of
// wrapped rows, the horizontal pass from a shared row segment with its wrap
// halo. Only sigmas above 10.33 come here.

constexpr int kMaxGridY = 65535;

template <class Rows>
__global__ void __launch_bounds__(kThreads)
blur_wide_vertical(const Rows batch_rows, float* __restrict__ out,
                   const float* __restrict__ taps, const int ntaps, const int h, const int w,
                   const long long in_stride) {
    extern __shared__ __align__(16) float smem[];
    const Rows rows = batch_rows.canvas(blockIdx.z, in_stride);
    out += (long long)blockIdx.z * h * w;  // the scratch: canvases packed
    for (int t = threadIdx.x; t < ntaps; t += blockDim.x) smem[t] = taps[t];
    __syncthreads();
    const int x = blockIdx.x * blockDim.x + threadIdx.x;
    if (x >= w) return;
    const int r = (ntaps - 1) / 2;
    for (int y = blockIdx.y; y < h; y += gridDim.y) {
        int i = rows.first(y - r);
        float acc = 0.0f;
        for (int t = 0; t < ntaps; ++t) {
            acc = __fadd_rn(acc, __fmul_rn(rows.at(i, w)[x], smem[t]));
            i = rows.next(i);
        }
        out[(size_t)y * w + x] = acc;
    }
}

__global__ void __launch_bounds__(kThreads)
blur_wide_horizontal(const float* __restrict__ in, float* __restrict__ out,
                     const float* __restrict__ taps, const int ntaps, const int h,
                     const int w, const long long out_stride) {
    extern __shared__ __align__(16) float smem[];
    in += (long long)blockIdx.z * h * w;
    out += (long long)blockIdx.z * out_stride;
    float* s_taps = smem;         // ntaps
    float* s_row = smem + ntaps;  // blockDim.x + 2r: the block's pixels + wrap halo
    for (int t = threadIdx.x; t < ntaps; t += blockDim.x) s_taps[t] = taps[t];
    const int r = (ntaps - 1) / 2;
    const int x0 = blockIdx.x * blockDim.x;
    const int span = blockDim.x + 2 * r;
    const int x = x0 + threadIdx.x;
    const int first = wrap_index<true>(x0 - r + (int)threadIdx.x, w);
    for (int y = blockIdx.y; y < h; y += gridDim.y) {
        const float* row = in + (size_t)y * w;
        __syncthreads();  // previous row's readers are done with s_row
        int c = first;
        for (int i = threadIdx.x; i < span; i += blockDim.x) {
            s_row[i] = row[c];
            c = (c + (int)blockDim.x) % w;
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

template <class Rows>
int launch_wide(const Rows& rows, float* scratch, float* out, const float* taps_dev, int ntaps,
                int h, int w, int batch, long long in_stride, long long out_stride,
                cudaStream_t stream) {
    if (scratch == nullptr || taps_dev == nullptr || (ntaps & 1) == 0) {
        return (int)cudaErrorInvalidValue;
    }
    const size_t smem = (size_t)(ntaps + kThreads + (ntaps - 1)) * sizeof(float);
    if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
    const dim3 grid((w + kThreads - 1) / kThreads, h < kMaxGridY ? h : kMaxGridY, batch);
    blur_wide_vertical<Rows><<<grid, kThreads, ntaps * sizeof(float), stream>>>(
        rows, scratch, taps_dev, ntaps, h, w, in_stride);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    blur_wide_horizontal<<<grid, kThreads, smem, stream>>>(scratch, out, taps_dev, ntaps, h, w,
                                                           out_stride);
    return (int)cudaGetLastError();
}

Taps taps_from_host(const float* taps_host, int ntaps) {
    Taps taps = {};
    for (int t = 0; t < ntaps; ++t) taps.w[t] = taps_host[t];
    return taps;
}

}  // namespace

// `batch` canvases, canvas b at in + b * in_stride and out + b * out_stride
// (floats). Up to 63 taps: `taps_host` points to the ntaps floats in host
// memory and th x tw is the tile; `scratch` and `taps_dev` are not read.
// Above: the two passes go through `scratch` (batch x h x w floats) with the
// taps in device memory at `taps_dev`; th and tw are not read.
extern "C" int kanter_blur_wrap_f32(const float* in, float* out, const float* taps_host,
                                    int ntaps, int h, int w, int th, int tw, float* scratch,
                                    const float* taps_dev, int batch, long long in_stride,
                                    long long out_stride, cudaStream_t stream) {
    if (h < 1 || w < 1 || ntaps < 1 || batch < 1 || batch > kMaxGridZ) {
        return (int)cudaErrorInvalidValue;
    }
    const PlaneRows rows{in, h};
    if (ntaps > kMaxTaps) {
        return launch_wide(rows, scratch, out, taps_dev, ntaps, h, w, batch, in_stride,
                           out_stride, stream);
    }
    const size_t smem = tile_smem(ntaps, th, tw);
    if (smem == 0) return (int)cudaErrorInvalidValue;
    const Taps taps = taps_from_host(taps_host, ntaps);
    const int r = (ntaps - 1) / 2;
    if (th + r > h || tw + ((r + 3) & ~3) > w) {
        return launch_tiles<PlaneRows, true>(rows, aligned16(in), out, taps, ntaps, h, w, th, tw,
                                             smem, batch, in_stride, out_stride, stream);
    }
    return launch_tiles<PlaneRows, false>(rows, aligned16(in), out, taps, ntaps, h, w, th, tw,
                                          smem, batch, in_stride, out_stride, stream);
}

// the same on a row block; top and bot hold (ntaps - 1) / 2 rows each, block
// block_h >= that many
extern "C" int kanter_blur_block_f32(const float* top, const float* block, const float* bot,
                                     float* out, const float* taps_host, int ntaps,
                                     int block_h, int w, int th, int tw, float* scratch,
                                     const float* taps_dev, cudaStream_t stream) {
    const int r = (ntaps - 1) / 2;
    if (block_h < 1 || block_h < r || w < 1 || ntaps < 1) return (int)cudaErrorInvalidValue;
    const WindowRows rows{top, block, bot, block_h, r};
    if (ntaps > kMaxTaps) {
        return launch_wide(rows, scratch, out, taps_dev, ntaps, block_h, w, 1, 0, 0, stream);
    }
    const size_t smem = tile_smem(ntaps, th, tw);
    if (smem == 0) return (int)cudaErrorInvalidValue;
    const Taps taps = taps_from_host(taps_host, ntaps);
    const bool aligned = aligned16(top) && aligned16(block) && aligned16(bot);
    if (tw + ((r + 3) & ~3) > w) {
        return launch_tiles<WindowRows, true>(rows, aligned, out, taps, ntaps, block_h, w, th, tw,
                                              smem, 1, 0, 0, stream);
    }
    return launch_tiles<WindowRows, false>(rows, aligned, out, taps, ntaps, block_h, w, th, tw,
                                           smem, 1, 0, 0, stream);
}
