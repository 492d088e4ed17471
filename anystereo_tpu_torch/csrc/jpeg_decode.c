/* Baseline JPEG decoding that gives, bit for bit, the samples libjpeg-turbo
 * gives with its default decompression parameters (the "islow" integer
 * IDCT, fancy upsampling, RGB output), which is what
 * `np.array(PIL.Image.open(path))` returns.
 *
 * Scope: baseline and extended sequential Huffman DCT (SOF0, SOF1), 8-bit
 * samples; 1 component (gray) or 3 (YCbCr, or RGB where an Adobe marker
 * says so); sampling factors 1-2 for 3 components (4:4:4, 4:2:2, 4:2:0,
 * 4:4:0); scans interleaved or one component each; restart intervals.
 * Anything else returns JD_UNSUPPORTED; malformed or truncated data
 * returns JD_CORRUPT, with a message.  Every read is bounds-checked, and
 * all state lives in one heap block a call, so threads may decode at once.
 *
 * The arithmetic follows libjpeg's public sources:
 *   jidctint.c  jpeg_idct_islow (CONST_BITS 13, PASS1_BITS 2, the
 *               post-IDCT range-limit table of jdmaster.c)
 *   jdsample.c  h2v1_fancy_upsample, h1v2_fancy_upsample,
 *               h2v2_fancy_upsample, and the box upsamplers that replace
 *               the horizontal fancy ones for components 2 samples wide or
 *               less; jdmainct.c's context rows (the first and last sample
 *               rows of a component repeated above and below it)
 *   jdcolor.c   build_ycc_rgb_table (SCALEBITS 16), ycc_rgb_convert
 *   jdmarker.c  default colour space: JFIF marker, else Adobe transform,
 *               else component ids
 *   jdhuff.c    jpeg_make_d_derived_tbl, the DC and AC decoding.
 */

#include <limits.h>
#include <setjmp.h>
#include <stdarg.h>
#include <stddef.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

enum { JD_CORRUPT = 1, JD_UNSUPPORTED = 2, JD_NOMEM = 3 }; /* 0: decoded */

#define LOOKAHEAD 9
#define MAX_BLOCKS_IN_MCU 10

/* zigzag index -> natural index, with libjpeg's 16 guard entries for a
 * corrupt run that steps past coefficient 63 */
static const uint8_t natural_order[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

typedef struct {
    int defined;
    uint8_t bits[17];
    uint8_t vals[256];
    int32_t maxcode[18];
    int32_t valoffset[18];
    uint16_t look[1 << LOOKAHEAD]; /* (length << 8) | symbol; 0: longer code */
    /* AC tables: a code and its value bits within the lookahead, as
     * (value << 8) | (run << 4) | (code + value bits); 0: decode slowly */
    int32_t fast_ac[1 << LOOKAHEAD];
} huff_t;

typedef struct {
    int id, h, v, tq;
    int dw, dh;        /* samples of the component (downsampled size) */
    int bw, bh;        /* blocks of its plane */
    size_t stride;     /* bytes a plane row */
    uint8_t *plane;
    int coded;         /* a scan has carried it */
    int dc_pred;
    int td, ta;
} comp_t;

typedef struct {
    jmp_buf jb;
    char *msg;
    size_t msg_len;
    const uint8_t *data;
    size_t len, pos;
    int width, height, ncomp, sof;
    int hmax, vmax;
    comp_t comp[3];
    uint16_t qt[4][64]; /* natural order */
    int qt_defined[4];
    huff_t dc[4], ac[4];
    int restart_interval;
    int saw_jfif, saw_adobe, adobe_transform;
    /* entropy-coded data */
    uint64_t buf;
    int nbits;
    int marker_hit;
    int pad_bits;
    /* tables */
    uint8_t idct_limit[1024];
    int cr_r[256], cb_b[256];
    int32_t cr_g[256], cb_g[256];
    uint8_t *rows; /* scratch rows for upsampling */
} dec_t;

static void fail(dec_t *d, int code, const char *fmt, ...) {
    va_list ap;
    va_start(ap, fmt);
    if (d->msg && d->msg_len) vsnprintf(d->msg, d->msg_len, fmt, ap);
    va_end(ap);
    longjmp(d->jb, code);
}

/* ------------------------------------------------------------- markers */

static int byte_at(dec_t *d) {
    if (d->pos >= d->len) fail(d, JD_CORRUPT, "truncated JPEG data");
    return d->data[d->pos++];
}

static int u16_at(dec_t *d) {
    int hi = byte_at(d);
    return (hi << 8) | byte_at(d);
}

/* jdmarker.c next_marker: skips anything up to an 0xFF, fill bytes, and
 * stuffed zeros */
static int next_marker(dec_t *d) {
    for (;;) {
        int c = byte_at(d);
        while (c != 0xFF) c = byte_at(d);
        do c = byte_at(d); while (c == 0xFF);
        if (c != 0) return c;
    }
}

/* the body of a segment with a length field: returns its start, leaves pos
 * past it */
static const uint8_t *segment(dec_t *d, size_t *n) {
    int len = u16_at(d);
    if (len < 2) fail(d, JD_CORRUPT, "marker segment length %d", len);
    if ((size_t)(len - 2) > d->len - d->pos) fail(d, JD_CORRUPT, "truncated marker segment");
    const uint8_t *p = d->data + d->pos;
    d->pos += (size_t)(len - 2);
    *n = (size_t)(len - 2);
    return p;
}

static void read_sof(dec_t *d, int marker) {
    size_t n;
    const uint8_t *p = segment(d, &n);
    if (d->sof) fail(d, JD_CORRUPT, "more than one SOF marker");
    if (marker == 0xC2 || marker == 0xC6 || marker == 0xCA || marker == 0xCE)
        fail(d, JD_UNSUPPORTED, "progressive JPEG (SOF%d) is not supported", marker - 0xC0);
    if (marker == 0xC3 || marker == 0xC7 || marker == 0xCB || marker == 0xCF)
        fail(d, JD_UNSUPPORTED, "lossless JPEG (SOF%d) is not supported", marker - 0xC0);
    if (marker >= 0xC9)
        fail(d, JD_UNSUPPORTED, "arithmetic-coded JPEG (SOF%d) is not supported", marker - 0xC0);
    if (marker == 0xC5) fail(d, JD_UNSUPPORTED, "hierarchical JPEG (SOF5) is not supported");
    if (n < 6) fail(d, JD_CORRUPT, "SOF segment of %zu bytes", n);
    int precision = p[0];
    d->height = (p[1] << 8) | p[2];
    d->width = (p[3] << 8) | p[4];
    d->ncomp = p[5];
    if (precision != 8)
        fail(d, JD_UNSUPPORTED, "%d-bit JPEG samples are not supported (8 are)", precision);
    if (d->ncomp == 0 || d->width == 0) fail(d, JD_CORRUPT, "empty image in SOF");
    if (d->height == 0) fail(d, JD_UNSUPPORTED, "image height given by a DNL marker is not supported");
    if (d->ncomp != 1 && d->ncomp != 3)
        fail(d, JD_UNSUPPORTED, "JPEG with %d components is not supported (1 and 3 are)", d->ncomp);
    if (n != 6 + 3 * (size_t)d->ncomp) fail(d, JD_CORRUPT, "SOF segment of %zu bytes", n);
    d->hmax = d->vmax = 1;
    for (int i = 0; i < d->ncomp; i++) {
        comp_t *c = &d->comp[i];
        c->id = p[6 + 3 * i];
        c->h = p[7 + 3 * i] >> 4;
        c->v = p[7 + 3 * i] & 15;
        c->tq = p[8 + 3 * i];
        if (c->h < 1 || c->h > 4 || c->v < 1 || c->v > 4)
            fail(d, JD_CORRUPT, "sampling factors %dx%d", c->h, c->v);
        if (c->tq > 3) fail(d, JD_CORRUPT, "quantization table %d", c->tq);
        if (c->h > d->hmax) d->hmax = c->h;
        if (c->v > d->vmax) d->vmax = c->v;
    }
    if (d->ncomp == 3) {
        for (int i = 0; i < 3; i++) {
            comp_t *c = &d->comp[i];
            if (c->h > 2 || c->v > 2)
                fail(d, JD_UNSUPPORTED,
                     "sampling factors %dx%d,%dx%d,%dx%d are not supported (4:4:4, 4:2:2, 4:2:0 "
                     "and 4:4:0 are)", d->comp[0].h, d->comp[0].v, d->comp[1].h, d->comp[1].v,
                     d->comp[2].h, d->comp[2].v);
        }
    }
    d->sof = marker;
}

static void read_dqt(dec_t *d) {
    size_t n;
    const uint8_t *p = segment(d, &n);
    size_t i = 0;
    while (i < n) {
        int pq = p[i] >> 4, tq = p[i] & 15;
        i++;
        if (tq > 3 || pq > 1) fail(d, JD_CORRUPT, "DQT table %d of precision %d", tq, pq);
        size_t need = pq ? 128 : 64;
        if (n - i < need) fail(d, JD_CORRUPT, "truncated DQT segment");
        for (int k = 0; k < 64; k++) {
            int q = pq ? (p[i + 2 * k] << 8) | p[i + 2 * k + 1] : p[i + k];
            d->qt[tq][natural_order[k]] = (uint16_t)q;
        }
        d->qt_defined[tq] = 1;
        i += need;
    }
}

/* jdhuff.c jpeg_make_d_derived_tbl, with a 9-bit lookahead table */
static void derive_huff(dec_t *d, huff_t *t, int is_dc) {
    uint8_t size[257];
    int32_t code[257];
    int p = 0;
    for (int l = 1; l <= 16; l++)
        for (int i = 0; i < t->bits[l]; i++) size[p++] = (uint8_t)l;
    size[p] = 0;
    int nsym = p;
    int32_t c = 0;
    int si = size[0];
    p = 0;
    while (size[p]) {
        while (size[p] == si) code[p++] = c++;
        if (c >= ((int32_t)1 << si)) fail(d, JD_CORRUPT, "bad Huffman table");
        c <<= 1;
        si++;
    }
    p = 0;
    for (int l = 1; l <= 16; l++) {
        if (t->bits[l]) {
            t->valoffset[l] = p - code[p];
            p += t->bits[l];
            t->maxcode[l] = code[p - 1];
        } else {
            t->maxcode[l] = -1;
        }
    }
    t->valoffset[17] = 0;
    t->maxcode[17] = 0xFFFFF;
    memset(t->look, 0, sizeof(t->look));
    p = 0;
    for (int l = 1; l <= LOOKAHEAD; l++) {
        for (int i = 0; i < t->bits[l]; i++, p++) {
            int lookbits = code[p] << (LOOKAHEAD - l);
            for (int k = 0; k < (1 << (LOOKAHEAD - l)); k++)
                t->look[lookbits + k] = (uint16_t)((l << 8) | t->vals[p]);
        }
    }
    if (is_dc)
        for (int i = 0; i < nsym; i++)
            if (t->vals[i] > 15) fail(d, JD_CORRUPT, "bad DC Huffman table");
    memset(t->fast_ac, 0, sizeof(t->fast_ac));
    for (int i = 0; !is_dc && i < (1 << LOOKAHEAD); i++) {
        int e = t->look[i];
        if (!e) continue;
        int l = e >> 8, run = (e >> 4) & 15, s = e & 15;
        if (!s || l + s > LOOKAHEAD) continue;
        int v = (i >> (LOOKAHEAD - l - s)) & ((1 << s) - 1);
        v = v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
        t->fast_ac[i] = v * 256 + run * 16 + l + s;
    }
}

static void read_dht(dec_t *d) {
    size_t n;
    const uint8_t *p = segment(d, &n);
    size_t i = 0;
    while (i < n) {
        if (n - i < 17) fail(d, JD_CORRUPT, "truncated DHT segment");
        int tc = p[i] >> 4, th = p[i] & 15;
        if (tc > 1 || th > 3) fail(d, JD_CORRUPT, "DHT table class %d, id %d", tc, th);
        huff_t *t = tc ? &d->ac[th] : &d->dc[th];
        int count = 0;
        t->bits[0] = 0;
        for (int l = 1; l <= 16; l++) {
            t->bits[l] = p[i + l];
            count += p[i + l];
        }
        i += 17;
        if (count > 256 || (size_t)count > n - i) fail(d, JD_CORRUPT, "bad Huffman table");
        memset(t->vals, 0, sizeof(t->vals));
        memcpy(t->vals, p + i, (size_t)count);
        i += (size_t)count;
        derive_huff(d, t, tc == 0);
        t->defined = 1;
    }
}

static void read_app(dec_t *d, int marker) {
    size_t n;
    const uint8_t *p = segment(d, &n);
    if (marker == 0xE0 && n >= 14 && !memcmp(p, "JFIF\0", 5)) d->saw_jfif = 1;
    if (marker == 0xEE && n >= 12 && !memcmp(p, "Adobe", 5)) {
        d->saw_adobe = 1;
        d->adobe_transform = p[11];
    }
}

/* --------------------------------------------------- entropy-coded data */

static void bits_reset(dec_t *d) {
    d->buf = 0;
    d->nbits = 0;
    d->marker_hit = 0;
    d->pad_bits = 0;
}

/* fill the bit buffer to 57 bits or more; past a marker or the end of the
 * data, zeros (counted in pad_bits: a valid scan never consumes them) */
static void fill(dec_t *d) {
    while (d->nbits <= 56) {
        int c = 0;
        if (!d->marker_hit) {
            if (d->pos >= d->len) {
                d->marker_hit = 1;
            } else {
                c = d->data[d->pos];
                if (c == 0xFF) {
                    size_t q = d->pos + 1;
                    while (q < d->len && d->data[q] == 0xFF) q++;
                    if (q < d->len && d->data[q] == 0) {
                        d->pos = q + 1;
                    } else {
                        d->marker_hit = 1; /* pos stays on the marker */
                        c = 0;
                    }
                } else {
                    d->pos++;
                }
            }
        }
        if (d->marker_hit) d->pad_bits += 8;
        d->buf |= (uint64_t)c << (56 - d->nbits);
        d->nbits += 8;
    }
}

static inline int get_bits(dec_t *d, int s) {
    if (d->nbits < s) fill(d);
    int v = (int)(d->buf >> (64 - s));
    d->buf <<= s;
    d->nbits -= s;
    return v;
}

static inline int extend(int v, int s) {
    return v < (1 << (s - 1)) ? v + (int)((unsigned)-1 << s) + 1 : v;
}

static inline int huff_decode(dec_t *d, const huff_t *t) {
    if (d->nbits < 16) fill(d);
    int e = t->look[d->buf >> (64 - LOOKAHEAD)];
    if (e) {
        int l = e >> 8;
        d->buf <<= l;
        d->nbits -= l;
        return e & 0xFF;
    }
    for (int l = LOOKAHEAD + 1; l <= 16; l++) {
        int32_t code = (int32_t)(d->buf >> (64 - l));
        if (code <= t->maxcode[l]) {
            d->buf <<= l;
            d->nbits -= l;
            int idx = (int)(code + t->valoffset[l]);
            if (idx < 0 || idx > 255) break;
            return t->vals[idx];
        }
    }
    fail(d, JD_CORRUPT, "corrupt JPEG data: bad Huffman code");
    return 0;
}

/* ----------------------------------------------------------------- IDCT */

#define CONST_BITS 13
#define PASS1_BITS 2
#define FIX_0_298631336 ((int64_t)2446)
#define FIX_0_390180644 ((int64_t)3196)
#define FIX_0_541196100 ((int64_t)4433)
#define FIX_0_765366865 ((int64_t)6270)
#define FIX_0_899976223 ((int64_t)7373)
#define FIX_1_175875602 ((int64_t)9633)
#define FIX_1_501321110 ((int64_t)12299)
#define FIX_1_847759065 ((int64_t)15137)
#define FIX_1_961570560 ((int64_t)16069)
#define FIX_2_053119869 ((int64_t)16819)
#define FIX_2_562915447 ((int64_t)20995)
#define FIX_3_072711026 ((int64_t)25172)
#define DESCALE(x, n) (((x) + ((int64_t)1 << ((n) - 1))) >> (n))

/* jdmaster.c prepare_range_limit_table, the part the IDCT reads
 * (sample_range_limit + CENTERJSAMPLE, indexed by x & 1023) */
static void build_idct_limit(uint8_t t[1024]) {
    for (int i = 0; i < 128; i++) t[i] = (uint8_t)(128 + i);
    for (int i = 128; i < 512; i++) t[i] = 255;
    for (int i = 512; i < 896; i++) t[i] = 0;
    for (int i = 896; i < 1024; i++) t[i] = (uint8_t)(i - 896);
}

/* the odd part shared by both passes: in = (y7, y5, y3, y1) */
#define ODD_PART(t0, t1, t2, t3)                                  \
    do {                                                          \
        int64_t z1 = t0 + t3, z2 = t1 + t2, z3 = t0 + t2, z4 = t1 + t3; \
        int64_t z5 = (z3 + z4) * FIX_1_175875602;                 \
        t0 *= FIX_0_298631336;                                    \
        t1 *= FIX_2_053119869;                                    \
        t2 *= FIX_3_072711026;                                    \
        t3 *= FIX_1_501321110;                                    \
        z1 *= -FIX_0_899976223;                                   \
        z2 *= -FIX_2_562915447;                                   \
        z3 *= -FIX_1_961570560;                                   \
        z4 *= -FIX_0_390180644;                                   \
        z3 += z5;                                                 \
        z4 += z5;                                                 \
        t0 += z1 + z3;                                            \
        t1 += z2 + z4;                                            \
        t2 += z2 + z3;                                            \
        t3 += z1 + z4;                                            \
    } while (0)

/* jidctint.c jpeg_idct_islow: coef in natural order, q the component's
 * quantization table (as libjpeg's 16-bit ISLOW_MULT_TYPE) */
static void idct_islow(const int16_t *coef, const int16_t *q, const uint8_t *limit,
                       uint8_t *out, size_t stride) {
    int ws[64];
    for (int col = 0; col < 8; col++) {
        const int16_t *in = coef + col;
        const int16_t *qq = q + col;
        int *w = ws + col;
        if (!in[8] && !in[16] && !in[24] && !in[32] && !in[40] && !in[48] && !in[56]) {
            int dc = (int)(((int64_t)in[0] * qq[0]) * (1 << PASS1_BITS));
            for (int r = 0; r < 8; r++) w[8 * r] = dc;
            continue;
        }
        int64_t z2 = (int64_t)in[16] * qq[16], z3 = (int64_t)in[48] * qq[48];
        int64_t z1 = (z2 + z3) * FIX_0_541196100;
        int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
        int64_t tmp3 = z1 + z2 * FIX_0_765366865;
        z2 = (int64_t)in[0] * qq[0];
        z3 = (int64_t)in[32] * qq[32];
        int64_t tmp0 = (z2 + z3) * (1 << CONST_BITS);
        int64_t tmp1 = (z2 - z3) * (1 << CONST_BITS);
        int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
        int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
        tmp0 = (int64_t)in[56] * qq[56];
        tmp1 = (int64_t)in[40] * qq[40];
        tmp2 = (int64_t)in[24] * qq[24];
        tmp3 = (int64_t)in[8] * qq[8];
        ODD_PART(tmp0, tmp1, tmp2, tmp3);
        w[0] = (int)DESCALE(tmp10 + tmp3, CONST_BITS - PASS1_BITS);
        w[56] = (int)DESCALE(tmp10 - tmp3, CONST_BITS - PASS1_BITS);
        w[8] = (int)DESCALE(tmp11 + tmp2, CONST_BITS - PASS1_BITS);
        w[48] = (int)DESCALE(tmp11 - tmp2, CONST_BITS - PASS1_BITS);
        w[16] = (int)DESCALE(tmp12 + tmp1, CONST_BITS - PASS1_BITS);
        w[40] = (int)DESCALE(tmp12 - tmp1, CONST_BITS - PASS1_BITS);
        w[24] = (int)DESCALE(tmp13 + tmp0, CONST_BITS - PASS1_BITS);
        w[32] = (int)DESCALE(tmp13 - tmp0, CONST_BITS - PASS1_BITS);
    }
    for (int r = 0; r < 8; r++) {
        const int *w = ws + 8 * r;
        uint8_t *o = out + (size_t)r * stride;
        if (!w[1] && !w[2] && !w[3] && !w[4] && !w[5] && !w[6] && !w[7]) {
            uint8_t v = limit[(int)DESCALE((int64_t)w[0], PASS1_BITS + 3) & 1023];
            memset(o, v, 8);
            continue;
        }
        int64_t z2 = w[2], z3 = w[6];
        int64_t z1 = (z2 + z3) * FIX_0_541196100;
        int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
        int64_t tmp3 = z1 + z2 * FIX_0_765366865;
        int64_t tmp0 = ((int64_t)w[0] + w[4]) * (1 << CONST_BITS);
        int64_t tmp1 = ((int64_t)w[0] - w[4]) * (1 << CONST_BITS);
        int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
        int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
        tmp0 = w[7];
        tmp1 = w[5];
        tmp2 = w[3];
        tmp3 = w[1];
        ODD_PART(tmp0, tmp1, tmp2, tmp3);
        const int sh = CONST_BITS + PASS1_BITS + 3;
        o[0] = limit[(int)DESCALE(tmp10 + tmp3, sh) & 1023];
        o[7] = limit[(int)DESCALE(tmp10 - tmp3, sh) & 1023];
        o[1] = limit[(int)DESCALE(tmp11 + tmp2, sh) & 1023];
        o[6] = limit[(int)DESCALE(tmp11 - tmp2, sh) & 1023];
        o[2] = limit[(int)DESCALE(tmp12 + tmp1, sh) & 1023];
        o[5] = limit[(int)DESCALE(tmp12 - tmp1, sh) & 1023];
        o[3] = limit[(int)DESCALE(tmp13 + tmp0, sh) & 1023];
        o[4] = limit[(int)DESCALE(tmp13 - tmp0, sh) & 1023];
    }
}

/* ------------------------------------------------------------------ scans */

/* one block: Huffman-decode, dequantize, IDCT into the plane at (bx, by) */
static void decode_block(dec_t *d, comp_t *c, const int16_t *q, int bx, int by) {
    int16_t coef[64];
    memset(coef, 0, sizeof(coef));
    const huff_t *dc = &d->dc[c->td], *ac = &d->ac[c->ta];
    int s = huff_decode(d, dc);
    int diff = s ? extend(get_bits(d, s), s) : 0;
    if ((c->dc_pred >= 0 && diff > INT_MAX - c->dc_pred) ||
        (c->dc_pred < 0 && diff < INT_MIN - c->dc_pred))
        fail(d, JD_CORRUPT, "corrupt JPEG data: DC coefficient out of range");
    c->dc_pred += diff;
    coef[0] = (int16_t)c->dc_pred;
    int any_ac = 0;
    for (int k = 1; k < 64; k++) {
        if (d->nbits < 16) fill(d);
        int f = ac->fast_ac[d->buf >> (64 - LOOKAHEAD)];
        if (f) { /* code and value bits at once (the same value extend() gives) */
            int l = f & 15;
            k += (f >> 4) & 15;
            d->buf <<= l;
            d->nbits -= l;
            coef[natural_order[k]] = (int16_t)(f >> 8);
            any_ac = 1;
            continue;
        }
        int rs = huff_decode(d, ac);
        int r = rs >> 4;
        s = rs & 15;
        if (s) {
            k += r;
            int v = extend(get_bits(d, s), s);
            coef[natural_order[k]] = (int16_t)v;
            any_ac = 1;
        } else {
            if (r != 15) break;
            k += 15;
        }
    }
    uint8_t *out = c->plane + (size_t)by * 8 * c->stride + (size_t)bx * 8;
    if (!any_ac) {
        /* DC only: both passes' shortcuts, exactly */
        int dc = (int)(((int64_t)coef[0] * q[0]) * (1 << PASS1_BITS));
        uint8_t v = d->idct_limit[(int)DESCALE((int64_t)dc, PASS1_BITS + 3) & 1023];
        for (int r = 0; r < 8; r++) memset(out + (size_t)r * c->stride, v, 8);
        return;
    }
    idct_islow(coef, q, d->idct_limit, out, c->stride);
}

static comp_t *comp_by_id(dec_t *d, int id, comp_t **taken, int ntaken) {
    for (int i = 0; i < d->ncomp; i++) {
        if (d->comp[i].id != id) continue;
        int dup = 0;
        for (int j = 0; j < ntaken; j++) dup |= taken[j] == &d->comp[i];
        if (!dup) return &d->comp[i];
    }
    fail(d, JD_CORRUPT, "SOS names component %d, which the frame lacks", id);
    return NULL;
}

static void restart(dec_t *d, int *next_rst) {
    /* drop what is left of the byte-padded data, then find RSTn */
    bits_reset(d);
    int m = next_marker(d);
    if (m != 0xD0 + *next_rst)
        fail(d, JD_CORRUPT, "corrupt JPEG data: marker 0x%02X where RST%d was due", m, *next_rst);
    *next_rst = (*next_rst + 1) & 7;
}

static void read_scan(dec_t *d) {
    size_t n;
    const uint8_t *p = segment(d, &n);
    if (!d->sof) fail(d, JD_CORRUPT, "SOS before SOF");
    if (n < 1) fail(d, JD_CORRUPT, "empty SOS segment");
    int ns = p[0];
    if (ns < 1 || ns > d->ncomp || n != 4 + 2 * (size_t)ns)
        fail(d, JD_CORRUPT, "SOS segment of %zu bytes for %d components", n, ns);
    comp_t *sc[3];
    int16_t q[3][64];
    for (int i = 0; i < ns; i++) {
        comp_t *c = comp_by_id(d, p[1 + 2 * i], sc, i);
        c->td = p[2 + 2 * i] >> 4;
        c->ta = p[2 + 2 * i] & 15;
        if (c->td > 3 || c->ta > 3) fail(d, JD_CORRUPT, "SOS Huffman tables %d, %d", c->td, c->ta);
        if (!d->dc[c->td].defined || !d->ac[c->ta].defined)
            fail(d, JD_UNSUPPORTED, "scan without its Huffman tables (Motion-JPEG's implied "
                 "tables are not supported)");
        if (!d->qt_defined[c->tq]) fail(d, JD_CORRUPT, "quantization table %d is not defined", c->tq);
        for (int k = 0; k < 64; k++) q[i][k] = (int16_t)d->qt[c->tq][k];
        sc[i] = c;
    }
    int mcux, mcuy;
    if (ns == 1) {
        mcux = (sc[0]->dw + 7) / 8;
        mcuy = (sc[0]->dh + 7) / 8;
    } else {
        int blocks = 0;
        for (int i = 0; i < ns; i++) blocks += sc[i]->h * sc[i]->v;
        if (blocks > MAX_BLOCKS_IN_MCU) fail(d, JD_CORRUPT, "%d blocks an MCU", blocks);
        mcux = (d->width + 8 * d->hmax - 1) / (8 * d->hmax);
        mcuy = (d->height + 8 * d->vmax - 1) / (8 * d->vmax);
    }
    for (int i = 0; i < ns; i++) {
        sc[i]->dc_pred = 0;
        sc[i]->coded = 1;
    }
    bits_reset(d);
    int left = d->restart_interval, next_rst = 0;
    for (int my = 0; my < mcuy; my++) {
        for (int mx = 0; mx < mcux; mx++) {
            if (d->restart_interval) {
                if (left == 0) {
                    restart(d, &next_rst);
                    for (int i = 0; i < ns; i++) sc[i]->dc_pred = 0;
                    left = d->restart_interval;
                }
                left--;
            }
            if (ns == 1) {
                decode_block(d, sc[0], q[0], mx, my);
            } else {
                for (int i = 0; i < ns; i++) {
                    comp_t *c = sc[i];
                    for (int by = 0; by < c->v; by++)
                        for (int bx = 0; bx < c->h; bx++)
                            decode_block(d, c, q[i], mx * c->h + bx, my * c->v + by);
                }
            }
            if (d->pad_bits > d->nbits)
                fail(d, JD_CORRUPT, "truncated or corrupt JPEG data (the scan ends early)");
        }
    }
    bits_reset(d);
}

/* ------------------------------------------------------------ upsampling */

static inline const uint8_t *plane_row(const comp_t *c, int r) {
    if (r < 0) r = 0;
    if (r > c->dh - 1) r = c->dh - 1;
    return c->plane + (size_t)r * c->stride;
}

/* the component's samples for output row y, upsampled to (at least) the
 * output width; tmp has room for 2 * stride bytes */
static const uint8_t *comp_row(const dec_t *d, const comp_t *c, int y, uint8_t *tmp) {
    int rh = d->hmax / c->h, rv = d->vmax / c->v, dw = c->dw;
    if (rh == 1 && rv == 1) return plane_row(c, y);
    if (rh == 1) { /* h1v2_fancy_upsample */
        const uint8_t *near = plane_row(c, y >> 1);
        const uint8_t *far = plane_row(c, (y & 1) ? (y >> 1) + 1 : (y >> 1) - 1);
        int bias = (y & 1) ? 2 : 1;
        for (int x = 0; x < dw; x++) tmp[x] = (uint8_t)((near[x] * 3 + far[x] + bias) >> 2);
        return tmp;
    }
    if (rv == 1) {
        const uint8_t *in = plane_row(c, y);
        if (dw <= 2) { /* h2v1_upsample */
            for (int x = 0; x < dw; x++) tmp[2 * x] = tmp[2 * x + 1] = in[x];
            return tmp;
        }
        /* h2v1_fancy_upsample */
        tmp[0] = in[0];
        tmp[1] = (uint8_t)((in[0] * 3 + in[1] + 2) >> 2);
        for (int x = 1; x < dw - 1; x++) {
            int v = in[x] * 3;
            tmp[2 * x] = (uint8_t)((v + in[x - 1] + 1) >> 2);
            tmp[2 * x + 1] = (uint8_t)((v + in[x + 1] + 2) >> 2);
        }
        tmp[2 * dw - 2] = (uint8_t)((in[dw - 1] * 3 + in[dw - 2] + 1) >> 2);
        tmp[2 * dw - 1] = in[dw - 1];
        return tmp;
    }
    if (dw <= 2) { /* h2v2_upsample */
        const uint8_t *in = plane_row(c, y >> 1);
        for (int x = 0; x < dw; x++) tmp[2 * x] = tmp[2 * x + 1] = in[x];
        return tmp;
    }
    /* h2v2_fancy_upsample */
    const uint8_t *near = plane_row(c, y >> 1);
    const uint8_t *far = plane_row(c, (y & 1) ? (y >> 1) + 1 : (y >> 1) - 1);
    int last = near[0] * 3 + far[0], this_ = last, next = near[1] * 3 + far[1];
    tmp[0] = (uint8_t)((this_ * 4 + 8) >> 4);
    tmp[1] = (uint8_t)((this_ * 3 + next + 7) >> 4);
    for (int x = 1; x < dw - 1; x++) {
        last = this_;
        this_ = next;
        next = near[x + 1] * 3 + far[x + 1];
        tmp[2 * x] = (uint8_t)((this_ * 3 + last + 8) >> 4);
        tmp[2 * x + 1] = (uint8_t)((this_ * 3 + next + 7) >> 4);
    }
    last = this_;
    this_ = next;
    tmp[2 * dw - 2] = (uint8_t)((this_ * 3 + last + 8) >> 4);
    tmp[2 * dw - 1] = (uint8_t)((this_ * 4 + 7) >> 4);
    return tmp;
}

/* jdcolor.c build_ycc_rgb_table */
static void build_ycc_tables(dec_t *d) {
#define SCALEBITS 16
#define ONE_HALF ((int64_t)1 << (SCALEBITS - 1))
#define FIX(x) ((int64_t)((x) * (1L << SCALEBITS) + 0.5))
    for (int i = 0, x = -128; i < 256; i++, x++) {
        d->cr_r[i] = (int)((FIX(1.40200) * x + ONE_HALF) >> SCALEBITS);
        d->cb_b[i] = (int)((FIX(1.77200) * x + ONE_HALF) >> SCALEBITS);
        d->cr_g[i] = (int32_t)(-FIX(0.71414) * x);
        d->cb_g[i] = (int32_t)(-FIX(0.34414) * x + ONE_HALF);
    }
}

static inline uint8_t clamp255(int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); }

static void emit(dec_t *d, uint8_t *out) {
    size_t w = (size_t)d->width;
    if (d->ncomp == 1) {
        for (int y = 0; y < d->height; y++) memcpy(out + (size_t)y * w, plane_row(&d->comp[0], y), w);
        return;
    }
    /* jdapimin.c default_decompress_parms: a JFIF marker says YCbCr, else an
     * Adobe marker's transform (0: RGB), else the component ids 'R', 'G', 'B' */
    int ycc = d->saw_jfif ? 1
              : d->saw_adobe ? d->adobe_transform != 0
              : !(d->comp[0].id == 82 && d->comp[1].id == 71 && d->comp[2].id == 66);
    size_t room = 0;
    for (int i = 0; i < 3; i++)
        if (2 * d->comp[i].stride > room) room = 2 * d->comp[i].stride;
    for (int y = 0; y < d->height; y++) {
        const uint8_t *c0 = comp_row(d, &d->comp[0], y, d->rows);
        const uint8_t *c1 = comp_row(d, &d->comp[1], y, d->rows + room);
        const uint8_t *c2 = comp_row(d, &d->comp[2], y, d->rows + 2 * room);
        uint8_t *o = out + (size_t)y * w * 3;
        if (!ycc) {
            for (size_t x = 0; x < w; x++) {
                o[3 * x] = c0[x];
                o[3 * x + 1] = c1[x];
                o[3 * x + 2] = c2[x];
            }
            continue;
        }
        for (size_t x = 0; x < w; x++) {
            int yy = c0[x], cb = c1[x], cr = c2[x];
            o[3 * x] = clamp255(yy + d->cr_r[cr]);
            o[3 * x + 1] = clamp255(yy + ((d->cb_g[cb] + d->cr_g[cr]) >> SCALEBITS));
            o[3 * x + 2] = clamp255(yy + d->cb_b[cb]);
        }
    }
}

/* ------------------------------------------------------------- the frame */

static void alloc_planes(dec_t *d) {
    int mcux = (d->width + 8 * d->hmax - 1) / (8 * d->hmax);
    int mcuy = (d->height + 8 * d->vmax - 1) / (8 * d->vmax);
    size_t room = 0;
    for (int i = 0; i < d->ncomp; i++) {
        comp_t *c = &d->comp[i];
        if (d->ncomp == 1) c->h = c->v = d->hmax = d->vmax = 1; /* a lone component is never subsampled */
        c->dw = (int)(((int64_t)d->width * c->h + d->hmax - 1) / d->hmax);
        c->dh = (int)(((int64_t)d->height * c->v + d->vmax - 1) / d->vmax);
        c->bw = d->ncomp == 1 ? (c->dw + 7) / 8 : mcux * c->h;
        c->bh = d->ncomp == 1 ? (c->dh + 7) / 8 : mcuy * c->v;
        c->stride = (size_t)c->bw * 8;
        c->plane = malloc(c->stride * (size_t)c->bh * 8);
        if (!c->plane) fail(d, JD_NOMEM, "out of memory for a %dx%d JPEG", d->width, d->height);
        if (2 * c->stride > room) room = 2 * c->stride;
    }
    d->rows = malloc(3 * room);
    if (!d->rows) fail(d, JD_NOMEM, "out of memory for a %dx%d JPEG", d->width, d->height);
}

/* markers up to the SOF (out NULL) or, decoding into out (out_len bytes),
 * up to the EOI */
static void parse(dec_t *d, uint8_t *out, int64_t out_len) {
    int stop_at_sof = out == NULL;
    if (d->len < 2 || d->data[0] != 0xFF || d->data[1] != 0xD8) fail(d, JD_CORRUPT, "not a JPEG file");
    d->pos = 2;
    for (;;) {
        int m = next_marker(d);
        size_t n;
        if (m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xC8 && m != 0xCC) {
            read_sof(d, m);
            if (stop_at_sof) return;
            if (out_len != (int64_t)d->height * d->width * d->ncomp)
                fail(d, JD_CORRUPT, "output buffer of %lld bytes for a %dx%dx%d image",
                     (long long)out_len, d->height, d->width, d->ncomp);
            alloc_planes(d);
        } else if (m == 0xC4) {
            read_dht(d);
        } else if (m == 0xCC) {
            fail(d, JD_UNSUPPORTED, "arithmetic coding (DAC) is not supported");
        } else if (m == 0xDB) {
            read_dqt(d);
        } else if (m == 0xDD) {
            const uint8_t *p = segment(d, &n);
            if (n != 2) fail(d, JD_CORRUPT, "DRI segment of %zu bytes", n);
            d->restart_interval = (p[0] << 8) | p[1];
        } else if (m == 0xDA) {
            if (stop_at_sof) fail(d, JD_CORRUPT, "SOS before SOF");
            read_scan(d);
        } else if (m == 0xD9) {
            if (stop_at_sof || !d->sof) fail(d, JD_CORRUPT, "no SOF marker before EOI");
            for (int i = 0; i < d->ncomp; i++)
                if (!d->comp[i].coded) fail(d, JD_CORRUPT, "component %d is in no scan", d->comp[i].id);
            emit(d, out);
            return;
        } else if ((m >= 0xE0 && m <= 0xEF)) {
            read_app(d, m);
        } else if (m == 0xFE || m == 0xDC || (m >= 0xF0 && m <= 0xFD)) {
            segment(d, &n); /* COM, DNL, JPGn: skipped */
        } else if ((m >= 0xD0 && m <= 0xD7) || m == 0x01) {
            /* RSTn outside a scan, TEM: no parameters */
        } else if (m == 0xD8) {
            fail(d, JD_CORRUPT, "SOI inside the file");
        } else {
            fail(d, JD_CORRUPT, "unknown JPEG marker 0x%02X", m);
        }
    }
}

static dec_t *new_dec(const uint8_t *data, int64_t len, char *msg, int64_t msg_len) {
    dec_t *d = calloc(1, sizeof(dec_t));
    if (!d) return NULL;
    d->data = data;
    d->len = len > 0 ? (size_t)len : 0;
    d->msg = msg;
    d->msg_len = msg_len > 0 ? (size_t)msg_len : 0;
    if (d->msg_len) msg[0] = 0;
    return d;
}

static void free_dec(dec_t *d) {
    for (int i = 0; i < 3; i++) free(d->comp[i].plane);
    free(d->rows);
    free(d);
}

/* dims: height, width, components (1 or 3) */
int jpeg_info(const uint8_t *data, int64_t len, int32_t *dims, char *msg, int64_t msg_len) {
    dec_t *d = new_dec(data, len, msg, msg_len);
    if (!d) return JD_NOMEM;
    int rc = setjmp(d->jb);
    if (rc == 0) {
        parse(d, NULL, 0);
        dims[0] = d->height;
        dims[1] = d->width;
        dims[2] = d->ncomp;
    }
    free_dec(d);
    return rc;
}

/* out: height x width x components bytes (out_len of them) */
int jpeg_decode(const uint8_t *data, int64_t len, uint8_t *out, int64_t out_len, char *msg,
                int64_t msg_len) {
    dec_t *d = new_dec(data, len, msg, msg_len);
    if (!d) return JD_NOMEM;
    build_idct_limit(d->idct_limit);
    build_ycc_tables(d);
    int rc = setjmp(d->jb);
    if (rc == 0) {
        if (!out) fail(d, JD_CORRUPT, "no output buffer");
        parse(d, out, out_len);
    }
    free_dec(d);
    return rc;
}
