/* PNG unfiltering (PNG specification, section 9: filter types 0-4).
 *
 * The decompressed image data of a non-interlaced PNG is h rows of one
 * filter-type byte followed by row_bytes filtered bytes.  Each byte x is
 * restored from its predictor, read from a (the byte bpp to its left), b
 * (the byte above) and c (the byte above-left), all of them already
 * restored and 0 outside the image:
 *
 *   0 None     x
 *   1 Sub      x + a
 *   2 Up       x + b
 *   3 Average  x + floor((a + b) / 2)
 *   4 Paeth    x + the one of a, b, c nearest to a + b - c, ties in the
 *              order a, b, c (libpng's `pa <= pb && pa <= pc`)
 *
 * all mod 256.  A row depends on the row above, so rows are walked in
 * order; the plain version is the numpy walk of `data/png.py`.
 */

#include <stddef.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

static void unfilter_row(int type, const uint8_t *in, const uint8_t *prev,
                         uint8_t *out, int64_t n, int64_t bpp) {
    int64_t i;
    switch (type) {
    case 0:
        memcpy(out, in, (size_t)n);
        break;
    case 1:
        for (i = 0; i < bpp && i < n; i++) out[i] = in[i];
        for (; i < n; i++) out[i] = (uint8_t)(in[i] + out[i - bpp]);
        break;
    case 2:
        if (!prev) {
            memcpy(out, in, (size_t)n);
            break;
        }
        for (i = 0; i < n; i++) out[i] = (uint8_t)(in[i] + prev[i]);
        break;
    case 3:
        if (!prev) {
            for (i = 0; i < bpp && i < n; i++) out[i] = in[i];
            for (; i < n; i++) out[i] = (uint8_t)(in[i] + (out[i - bpp] >> 1));
            break;
        }
        for (i = 0; i < bpp && i < n; i++) out[i] = (uint8_t)(in[i] + (prev[i] >> 1));
        for (; i < n; i++) out[i] = (uint8_t)(in[i] + ((out[i - bpp] + prev[i]) >> 1));
        break;
    default: /* 4, Paeth */
        if (!prev) { /* b = c = 0: the predictor is a */
            for (i = 0; i < bpp && i < n; i++) out[i] = in[i];
            for (; i < n; i++) out[i] = (uint8_t)(in[i] + out[i - bpp]);
            break;
        }
        for (i = 0; i < bpp && i < n; i++) out[i] = (uint8_t)(in[i] + prev[i]); /* a = c = 0 */
        for (; i < n; i++) {
            int a = out[i - bpp], b = prev[i], c = prev[i - bpp];
            int pa = abs(b - c), pb = abs(a - c), pc = abs(a + b - 2 * c);
            /* the choice by masks, not branches: it is data-dependent */
            int take_a = -((pa <= pb) & (pa <= pc)), take_b = -(pb <= pc);
            int pred = (a & take_a) | (((b & take_b) | (c & ~take_b)) & ~take_a);
            out[i] = (uint8_t)(in[i] + pred);
        }
        break;
    }
}

/* src: h rows of (filter byte, row_bytes bytes); dst: h x row_bytes.  bpp
 * is the bytes of one pixel (1 or more).  Returns -1, or the index of the
 * first row whose filter type is above 4 (dst is filled up to that row). */
int64_t png_unfilter(const uint8_t *src, uint8_t *dst, int64_t h, int64_t row_bytes, int64_t bpp) {
    const uint8_t *prev = NULL;
    for (int64_t r = 0; r < h; r++) {
        const uint8_t *in = src + r * (row_bytes + 1);
        uint8_t *out = dst + r * row_bytes;
        if (in[0] > 4) return r;
        unfilter_row(in[0], in + 1, prev, out, row_bytes, bpp);
        prev = out;
    }
    return -1;
}
