/* The augmentor's colour conversions of uint8 RGB, as OpenCV computes them
 * (`data/augment.py`: `rgb_to_gray`, `rgb_to_hsv`, `hsv_to_rgb`, whose
 * numpy bodies are the plain versions these equal bit for bit).
 *
 *   rgb_to_gray  (9798 R + 19235 G + 3735 B + 16384) >> 15, OpenCV 5's
 *                15-bit fixed point;
 *   rgb_to_hsv   12-bit fixed point with the division tables `sdiv` and
 *                `hdiv` (given by the caller, so they have one definition);
 *                hue in [0, 180);
 *   hsv_to_rgb   float32, 1 - s·x rounded once (formed in double, as the
 *                plain version forms it); each row's pixels in blocks of 32
 *                truncated to a level, as OpenCV's vector code does, and the
 *                last W % 32 rounded half to even as its scalar code does,
 *                with v itself where s == 0.
 *
 * Arrays are C-contiguous, [n, 3] for the first two and [rows, w, 3] for
 * the third.  Built with -ffp-contract=off.  No global state.
 */

#include <math.h>
#include <stdint.h>

void rgb_to_gray(const uint8_t *rgb, uint8_t *gray, int64_t n) {
    for (int64_t i = 0; i < n; i++) {
        const int32_t r = rgb[3 * i], g = rgb[3 * i + 1], b = rgb[3 * i + 2];
        gray[i] = (uint8_t)((9798 * r + 19235 * g + 3735 * b + 16384) >> 15);
    }
}

void rgb_to_hsv(const uint8_t *rgb, uint8_t *hsv, int64_t n, const int64_t *sdiv,
                const int64_t *hdiv) {
    const int64_t half = 1 << 11;
    for (int64_t i = 0; i < n; i++) {
        const int64_t r = rgb[3 * i], g = rgb[3 * i + 1], b = rgb[3 * i + 2];
        int64_t v = b > g ? b : g, m = b < g ? b : g;
        v = v > r ? v : r;
        m = m < r ? m : r;
        const int64_t diff = v - m;
        const int64_t s = (diff * sdiv[v] + half) >> 12;
        int64_t h = v == r ? g - b : (v == g ? b - r + 2 * diff : r - g + 4 * diff);
        h = (h * hdiv[diff] + half) >> 12; /* arithmetic shift: floor, as numpy's */
        if (h < 0) h += 180;
        hsv[3 * i] = (uint8_t)h;
        hsv[3 * i + 1] = (uint8_t)s;
        hsv[3 * i + 2] = (uint8_t)v;
    }
}

/* (b, g, r) taken from tab = (v, v(1-s), v(1-s·f), v(1-s(1-f))) by sector */
static const int SECTOR[6][3] = {{1, 3, 0}, {1, 0, 2}, {3, 0, 1}, {0, 2, 1}, {0, 1, 3}, {2, 1, 0}};

static inline float clip255(float x) {
    return x < 0.0f ? 0.0f : (x > 255.0f ? 255.0f : x);
}

void hsv_to_rgb(const uint8_t *hsv, uint8_t *rgb, int64_t rows, int64_t w) {
    const float hscale = (float)(6.0 / 180.0), unit = (float)(1.0 / 255.0);
    const int64_t block_end = w - w % 32;
    for (int64_t y = 0; y < rows; y++) {
        for (int64_t x = 0; x < w; x++) {
            const int64_t i = 3 * (y * w + x);
            const float h = (float)hsv[i] * hscale;
            const float s = (float)hsv[i + 1] * unit;
            const float v = (float)hsv[i + 2] * unit;
            const float sector = floorf(h);
            const float f = h - sector;
            const double s64 = (double)s;
            float tab[4];
            tab[0] = v;
            tab[1] = v * (1.0f - s);
            tab[2] = v * (float)(1.0 - s64 * (double)f);
            tab[3] = v * (float)(1.0 - s64 * (double)(1.0f - f));
            const int *k = SECTOR[(int64_t)sector % 6];
            const float c[3] = {clip255(tab[k[2]] * 255.0f), clip255(tab[k[1]] * 255.0f),
                                clip255(tab[k[0]] * 255.0f)};
            if (x < block_end) {
                for (int ch = 0; ch < 3; ch++) rgb[i + ch] = (uint8_t)c[ch];
            } else if (s == 0.0f) {
                const uint8_t level = (uint8_t)rintf(clip255(v * 255.0f));
                for (int ch = 0; ch < 3; ch++) rgb[i + ch] = level;
            } else {
                for (int ch = 0; ch < 3; ch++) rgb[i + ch] = (uint8_t)rintf(c[ch]);
            }
        }
    }
}
