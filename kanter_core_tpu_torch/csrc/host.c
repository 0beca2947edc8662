/* Host-side loops of the port's CPU path, built with the host's C compiler
 * on first use (build.host_library). Plain C interface.
 *
 * kanter_powf_array: glibc's powf over arrays (ops/exact_math.powf_glibc).
 *   The caller passes the address of libm's own `powf`, so the loop calls
 *   exactly the function the JAX package's CPU `jnp.power` reproduces, and
 *   the compiler has no call to replace with a builtin or a vector variant.
 *
 * kanter_png_unfilter: the PNG row filters undone (ops/image_io). `src`
 *   holds `rows` filtered rows of 1 + `stride` bytes (the filter type, then
 *   the row); `dst` receives `rows` rows of `stride` bytes. `bpp` is the
 *   bytes per complete pixel, at least 1. Returns the index of the first
 *   row with an unknown filter type plus one, or 0. */
#include <stddef.h>
#include <string.h>

typedef float (*powf_fn)(float, float);

void kanter_powf_array(powf_fn powf_ptr, const float *a, const float *b, float *out,
                       size_t n) {
    for (size_t i = 0; i < n; ++i) {
        out[i] = powf_ptr(a[i], b[i]);
    }
}

static unsigned char paeth(int a, int b, int c) {
    int p = a + b - c;
    int pa = p > a ? p - a : a - p;
    int pb = p > b ? p - b : b - p;
    int pc = p > c ? p - c : c - p;
    if (pa <= pb && pa <= pc) return (unsigned char)a;
    return (unsigned char)(pb <= pc ? b : c);
}

size_t kanter_png_unfilter(const unsigned char *src, unsigned char *dst, size_t rows,
                           size_t stride, size_t bpp) {
    for (size_t y = 0; y < rows; ++y) {
        const unsigned char *in = src + y * (stride + 1);
        unsigned char *out = dst + y * stride;
        const unsigned char *up = y > 0 ? out - stride : NULL;
        unsigned char type = in[0];
        ++in;
        for (size_t x = 0; x < stride; ++x) {
            int a = x >= bpp ? out[x - bpp] : 0;
            int b = up ? up[x] : 0;
            int c = (up && x >= bpp) ? up[x - bpp] : 0;
            int pred;
            switch (type) {
                case 0: pred = 0; break;
                case 1: pred = a; break;
                case 2: pred = b; break;
                case 3: pred = (a + b) >> 1; break;
                case 4: pred = paeth(a, b, c); break;
                default: return y + 1;
            }
            out[x] = (unsigned char)(in[x] + pred);
        }
    }
    return 0;
}
