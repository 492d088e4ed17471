/* The per-pixel passes of the port's image resize (`utils/resize.py`).
 *
 * The tap tables (each output column's or row's source indices and
 * weights) are O(H + W) and are formed by the numpy helpers of
 * `utils/resize.py`, so the float64-to-float32 position rule has one
 * definition; these functions only walk the pixels.  Each computes what its
 * plain numpy version computes, bit for bit:
 *
 *   resize_axis    one separable pass of "linear" or "cubic" along one axis
 *                  of a [outer, n_src, inner] array: out = t0 + t1 + ...,
 *                  each tap src * w a float32 product and the taps summed
 *                  in ascending order in float32 (`_resize_axis`); uint8
 *                  in or out (rounded half to even, saturated) as asked;
 *   resize_linear_u8
 *                  OpenCV's fixed-point bilinear of uint8 (`_linear_u8`):
 *                  the row pass exact in int64, the column pass
 *                  ((r >> 4) * w >> 16) summed and rounded off 2 bits;
 *   resize_halve   the exact-2x block mean (`_halve`), its edge rules
 *                  included.
 *
 * Arrays are C-contiguous.  Built with -ffp-contract=off: a fused
 * multiply-add would round once where numpy rounds twice.  No global state;
 * the caller gives the scratch rows.
 */

#include <math.h>
#include <stdint.h>

static inline uint8_t saturate_u8(float v) {
    float r = rintf(v); /* half to even, as np.rint */
    if (r < 0.0f) r = 0.0f;
    if (r > 255.0f) r = 255.0f;
    return (uint8_t)r;
}

/* One output line of `resize_axis`, inlined with constant types and tap
 * counts so that each case compiles to its own loop. */
static inline __attribute__((always_inline)) void axis_line(const void *src, int src_u8, void *dst,
                                                            int dst_u8, int taps, const int64_t *base,
                                                            const float *w, int64_t at, int64_t inner) {
    const uint8_t *s8 = (const uint8_t *)src;
    const float *sf = (const float *)src;
    for (int64_t i = 0; i < inner; i++) {
        float acc = (src_u8 ? (float)s8[base[0] + i] : sf[base[0] + i]) * w[0];
        for (int k = 1; k < taps; k++) {
            const float t = (src_u8 ? (float)s8[base[k] + i] : sf[base[k] + i]) * w[k];
            acc = acc + t;
        }
        if (dst_u8)
            ((uint8_t *)dst)[at + i] = saturate_u8(acc);
        else
            ((float *)dst)[at + i] = acc;
    }
}

/* out[o, d, i] = sum_k src[o, idx[d, k], i] * wts[d, k], k ascending, for
 * 2 or 4 taps.  src is uint8 when src_u8, else float32; out is uint8 when
 * dst_u8 (the float sum rounded and saturated), else float32.  Returns 0,
 * or -1 for another tap count. */
int64_t resize_axis(const void *src, int64_t src_u8, void *dst, int64_t dst_u8, int64_t outer,
                    int64_t n_src, int64_t inner, int64_t n_dst, int64_t taps, const int64_t *idx,
                    const float *wts) {
    if (taps != 2 && taps != 4) return -1;
    const int kind = (taps == 4) * 4 + (src_u8 != 0) * 2 + (dst_u8 != 0);
    int64_t base[4]; /* each tap's source line */
    for (int64_t o = 0; o < outer; o++) {
        for (int64_t d = 0; d < n_dst; d++) {
            const float *w = wts + d * taps;
            for (int64_t k = 0; k < taps; k++) base[k] = (o * n_src + idx[d * taps + k]) * inner;
            const int64_t at = (o * n_dst + d) * inner;
            switch (kind) {
            case 0: axis_line(src, 0, dst, 0, 2, base, w, at, inner); break;
            case 1: axis_line(src, 0, dst, 1, 2, base, w, at, inner); break;
            case 2: axis_line(src, 1, dst, 0, 2, base, w, at, inner); break;
            case 3: axis_line(src, 1, dst, 1, 2, base, w, at, inner); break;
            case 4: axis_line(src, 0, dst, 0, 4, base, w, at, inner); break;
            case 5: axis_line(src, 0, dst, 1, 4, base, w, at, inner); break;
            case 6: axis_line(src, 1, dst, 0, 4, base, w, at, inner); break;
            default: axis_line(src, 1, dst, 1, 4, base, w, at, inner); break;
            }
        }
    }
    return 0;
}

/* The row pass of one source row: r[x, c] = src[y, xi0, c] * xw0 +
 * src[y, xi1, c] * xw1, exact in int64. */
static void linear_row(const uint8_t *src, int64_t w, int64_t c, int64_t y, int64_t ow,
                       const int64_t *xi, const int64_t *xw, int64_t *r) {
    const uint8_t *line = src + y * w * c;
    for (int64_t x = 0; x < ow; x++) {
        const uint8_t *p0 = line + xi[2 * x] * c, *p1 = line + xi[2 * x + 1] * c;
        const int64_t w0 = xw[2 * x], w1 = xw[2 * x + 1];
        for (int64_t ch = 0; ch < c; ch++) r[x * c + ch] = (int64_t)p0[ch] * w0 + (int64_t)p1[ch] * w1;
    }
}

/* OpenCV's uint8 bilinear: src [h, w, c] -> dst [oh, ow, c], with the
 * taps of `_fixed_linear_taps` (xi, xw [ow, 2]; yi, yw [oh, 2], rows in
 * [0, h); weights in 11 bits).  rows0 and rows1 are scratch rows of ow * c
 * int64. */
void resize_linear_u8(const uint8_t *src, int64_t w, int64_t c, uint8_t *dst, int64_t oh,
                      int64_t ow, const int64_t *xi, const int64_t *xw, const int64_t *yi,
                      const int64_t *yw, int64_t *rows0, int64_t *rows1) {
    int64_t have0 = -1, have1 = -1; /* the source rows held in rows0, rows1 */
    const int64_t n = ow * c;
    for (int64_t y = 0; y < oh; y++) {
        const int64_t y0 = yi[2 * y], y1 = yi[2 * y + 1];
        if (have0 != y0) {
            if (have1 == y0) { /* the last output row's second row is this one's first */
                int64_t *t = rows0;
                rows0 = rows1;
                rows1 = t;
                have1 = have0;
                have0 = y0;
            } else {
                linear_row(src, w, c, y0, ow, xi, xw, rows0);
                have0 = y0;
            }
        }
        if (have1 != y1) {
            linear_row(src, w, c, y1, ow, xi, xw, rows1);
            have1 = y1;
        }
        const int64_t w0 = yw[2 * y], w1 = yw[2 * y + 1];
        uint8_t *out = dst + y * n;
        for (int64_t i = 0; i < n; i++) {
            const int64_t v = (((rows0[i] >> 4) * w0) >> 16) + (((rows1[i] >> 4) * w1) >> 16);
            const int64_t r = (v + 2) >> 2;
            out[i] = (uint8_t)(r < 0 ? 0 : (r > 255 ? 255 : r));
        }
    }
}

/* The mean of each 2 x 2 block: src [h, w, c] -> dst [oh, ow, c] with
 * 2 oh >= h - 1 and 2 ow >= w - 1, rows and columns past the edge clamped
 * to it.  float32: ((p00 + p01) + p10) + p11, times 0.25, in float32.
 * uint8: the int64 sum rounded half up, (s + 2) >> 2, in interior blocks;
 * rounded half to even, rint(s / 4.0), in blocks past an odd edge and, with
 * all_even, in every block. */
void resize_halve(const void *src, int64_t src_u8, int64_t h, int64_t w, int64_t c, void *dst,
                  int64_t oh, int64_t ow, int64_t all_even) {
    for (int64_t y = 0; y < oh; y++) {
        const int64_t ya = 2 * y < h - 1 ? 2 * y : h - 1, yb = 2 * y + 1 < h - 1 ? 2 * y + 1 : h - 1;
        const int edge_y = (y == oh - 1) && (2 * oh > h);
        for (int64_t x = 0; x < ow; x++) {
            const int64_t xa = 2 * x < w - 1 ? 2 * x : w - 1, xb = 2 * x + 1 < w - 1 ? 2 * x + 1 : w - 1;
            const int64_t i00 = (ya * w + xa) * c, i01 = (ya * w + xb) * c;
            const int64_t i10 = (yb * w + xa) * c, i11 = (yb * w + xb) * c;
            const int64_t o = (y * ow + x) * c;
            if (!src_u8) {
                const float *s = (const float *)src;
                float *d = (float *)dst;
                for (int64_t ch = 0; ch < c; ch++) {
                    float t = s[i00 + ch] + s[i01 + ch];
                    t = t + s[i10 + ch];
                    t = t + s[i11 + ch];
                    d[o + ch] = t * 0.25f;
                }
                continue;
            }
            const uint8_t *s = (const uint8_t *)src;
            uint8_t *d = (uint8_t *)dst;
            const int even = all_even || edge_y || ((x == ow - 1) && (2 * ow > w));
            for (int64_t ch = 0; ch < c; ch++) {
                const int64_t t = (int64_t)s[i00 + ch] + s[i01 + ch] + s[i10 + ch] + s[i11 + ch];
                d[o + ch] = (uint8_t)(even ? (int64_t)nearbyint((double)t / 4.0) : (t + 2) >> 2);
            }
        }
    }
}
