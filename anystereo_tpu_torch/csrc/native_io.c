/* The data path's native helpers, the counterpart of the JAX package's
 * `native/anystereo_native.cpp` (`data/native_io.py` of the port wraps
 * them; each status below becomes the exception that module raises):
 *
 *   pfm_header, pfm_payload
 *       a PFM file: its header (the "PF" / "Pf" line, "width height", the
 *       scale, whose sign gives the byte order), then its float32 rows,
 *       stored bottom-up, flipped while read and swapped to the host's
 *       order where the file is big-endian;
 *   scatter_resize_sparse
 *       a sparse flow map rescaled by scatter: each valid pixel (valid >=
 *       1) moves to (nearbyint(x fx), nearbyint(y fy)) where that lies
 *       strictly inside the new map, its flow scaled by (fx, fy); the last
 *       pixel of the row-major walk wins a target.  By the JAX module's
 *       rules the flow is scaled in float32 and a NaN valid counts (it is
 *       not < 1); with numpy_rules, those of its numpy fallback (and of the
 *       port's plain version), in double rounded once to float32, and a NaN
 *       valid does not count (it is not >= 1);
 *   sample_queries
 *       values[idx] and coords[idx] in one pass.
 *
 * No global state; the caller allocates every output.
 */

#include <math.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

enum {
    PFM_OK = 0,
    PFM_CANNOT_OPEN = 1,
    PFM_NOT_PFM = 2,
    PFM_MALFORMED = 3,
    PFM_NO_SCALE = 4,
    PFM_IMPLAUSIBLE = 5,
    PFM_TRUNCATED = 6,
};

#define LINE_MAX_CHARS 255

/* A line without its '\n' (at most LINE_MAX_CHARS kept, NUL-terminated);
 * its length in *len.  False at the end of the file with nothing read. */
static int read_line(FILE *f, char *buf, size_t *len) {
    int c;
    size_t n = 0;
    while ((c = fgetc(f)) != EOF) {
        if (c == '\n') {
            buf[n < LINE_MAX_CHARS ? n : LINE_MAX_CHARS] = '\0';
            *len = n;
            return 1;
        }
        if (n < LINE_MAX_CHARS) buf[n] = (char)c;
        n++;
    }
    buf[n < LINE_MAX_CHARS ? n : LINE_MAX_CHARS] = '\0';
    *len = n;
    return n > 0;
}

/* out: height, width, channels, little_endian, the payload's byte offset */
int64_t pfm_header(const char *path, int64_t *out) {
    char line[LINE_MAX_CHARS + 1];
    size_t len;
    FILE *f = fopen(path, "rb");
    if (!f) return PFM_CANNOT_OPEN;
    if (!read_line(f, line, &len) || len != 2 || line[0] != 'P' || (line[1] != 'F' && line[1] != 'f')) {
        fclose(f);
        return PFM_NOT_PFM;
    }
    const int color = line[1] == 'F';
    long width = 0, height = 0;
    if (!read_line(f, line, &len) || sscanf(line, "%ld %ld", &width, &height) != 2 || width <= 0 ||
        height <= 0) {
        fclose(f);
        return PFM_MALFORMED;
    }
    if (!read_line(f, line, &len)) {
        fclose(f);
        return PFM_NO_SCALE;
    }
    const double scale = atof(line);
    const long offset = ftell(f);
    fclose(f);
    const uint64_t ch = color ? 3 : 1;
    out[0] = height;
    out[1] = width;
    /* a corrupt header must not ask for petabytes */
    if ((uint64_t)width * (uint64_t)height * ch > (1ull << 31)) return PFM_IMPLAUSIBLE;
    out[2] = (int64_t)ch;
    out[3] = scale < 0;
    out[4] = offset;
    return PFM_OK;
}

/* The payload of a file whose header gave (h, w, ch, little, offset) into
 * out [h, w, ch], top row first: read in one call (one system call for the
 * whole payload, where a row at a time costs one a buffer's length), then
 * its rows swapped end for end in place. */
int64_t pfm_payload(const char *path, int64_t offset, int64_t h, int64_t w, int64_t ch,
                    int64_t little, float *out) {
    FILE *f = fopen(path, "rb");
    if (!f) return PFM_CANNOT_OPEN;
    const size_t row = (size_t)(w * ch), count = (size_t)h * row;
    if (fseek(f, (long)offset, SEEK_SET) != 0 || fread(out, sizeof(float), count, f) != count) {
        fclose(f);
        return PFM_TRUNCATED;
    }
    fclose(f);
    float chunk[1024];
    for (int64_t y = 0; y < h / 2; y++) {
        float *a = out + (size_t)y * row, *b = out + (size_t)(h - 1 - y) * row;
        for (size_t i = 0; i < row; i += 1024) {
            const size_t n = row - i < 1024 ? row - i : 1024;
            memcpy(chunk, a + i, n * sizeof(float));
            memcpy(a + i, b + i, n * sizeof(float));
            memcpy(b + i, chunk, n * sizeof(float));
        }
    }
    if (!little) {
        for (size_t i = 0; i < count; i++) {
            uint32_t u;
            memcpy(&u, out + i, 4);
            u = __builtin_bswap32(u);
            memcpy(out + i, &u, 4);
        }
    }
    return PFM_OK;
}

/* flow [ht, wd, 2] and valid [ht, wd] -> out_flow [ht1, wd1, 2] and
 * out_valid [ht1, wd1], both zeroed by the caller. */
void scatter_resize_sparse(const float *flow, const float *valid, int64_t ht, int64_t wd, double fx,
                           double fy, int64_t ht1, int64_t wd1, int64_t numpy_rules,
                           float *out_flow, int32_t *out_valid) {
    const float fx32 = (float)fx, fy32 = (float)fy;
    for (int64_t y = 0; y < ht; y++) {
        for (int64_t x = 0; x < wd; x++) {
            const int64_t i = y * wd + x;
            if (numpy_rules ? !(valid[i] >= 1.0f) : valid[i] < 1.0f) continue;
            const int64_t xx = (int64_t)nearbyint((double)x * fx); /* half to even, as np.round */
            const int64_t yy = (int64_t)nearbyint((double)y * fy);
            if (xx <= 0 || xx >= wd1 || yy <= 0 || yy >= ht1) continue;
            const int64_t o = yy * wd1 + xx;
            if (numpy_rules) {
                out_flow[2 * o] = (float)((double)flow[2 * i] * fx);
                out_flow[2 * o + 1] = (float)((double)flow[2 * i + 1] * fy);
            } else {
                out_flow[2 * o] = flow[2 * i] * fx32;
                out_flow[2 * o + 1] = flow[2 * i + 1] * fy32;
            }
            out_valid[o] = 1;
        }
    }
}

/* v_out[j] = values[idx[j]], c_out[j] = coords[idx[j]]; returns -1, or the
 * first j whose index is outside [0, n) (nothing past it written). */
int64_t sample_queries(const float *values, const float *coords, const int64_t *idx, int64_t n,
                       int64_t q, float *v_out, float *c_out) {
    for (int64_t j = 0; j < q; j++) {
        const int64_t i = idx[j];
        if (i < 0 || i >= n) return j;
        v_out[j] = values[i];
        c_out[2 * j] = coords[2 * i];
        c_out[2 * j + 1] = coords[2 * i + 1];
    }
    return -1;
}
