/* JPEG decoding that gives, bit for bit, the samples libjpeg-turbo 3.1 gives
 * with its default decompression parameters (the "islow" integer IDCT,
 * fancy upsampling, block smoothing, RGB or CMYK output), which is what
 * `np.array(PIL.Image.open(path))` returns (mode 0), or the gray OpenCV's
 * `cv2.imread(path, cv2.IMREAD_ANYDEPTH)` makes of it (mode 1).
 *
 * Scope: sequential and progressive DCT files coded with Huffman tables
 * (SOF0, SOF1, SOF2) or arithmetically (SOF9, SOF10, with DAC
 * conditioning), and lossless files (SOF3: predictors 1-7, a point
 * transform), 8-bit samples; 1 component (gray), 3 (YCbCr, or RGB where an
 * Adobe marker says so; a lossless file without a JFIF or Adobe marker is
 * RGB) or 4 (CMYK, or YCCK where an Adobe marker's transform is not 0;
 * inverted as PIL's "CMYK;I" does); sampling factors 1-4 whose ratios to
 * the largest are whole numbers (libjpeg refuses the others), at most 10
 * blocks an MCU; scans interleaved or one component each; restart
 * intervals; files without DHT segments (the standard tables).  A
 * progressive file is decoded into every block's coefficients, then
 * transformed after the EOI, its blocks smoothed where its scans leave AC
 * coefficients 1-9 unfinished (a file cut short).  What libjpeg-turbo
 * under PIL refuses returns JD_UNSUPPORTED: other precisions, hierarchical
 * and arithmetic-coded lossless files, 2 components, a height left to a
 * DNL marker, a lossless file whose colour libjpeg would have to convert;
 * malformed or truncated data returns JD_CORRUPT, with a message.  Every
 * read is bounds-checked, and all state lives in heap blocks of the call,
 * so threads may decode at once.
 *
 * The arithmetic follows libjpeg's public sources:
 *   jidctint.c  jpeg_idct_islow (CONST_BITS 13, PASS1_BITS 2, the
 *               post-IDCT range-limit table of jdmaster.c)
 *   jdsample.c  h2v1_fancy_upsample, h1v2_fancy_upsample,
 *               h2v2_fancy_upsample, the box upsamplers that replace the
 *               horizontal fancy ones for components 2 samples wide or
 *               less, and int_upsample for the other whole ratios (and for
 *               every ratio of a lossless file);
 *               jdmainct.c's context rows (the first and last sample rows
 *               of a component repeated above and below it)
 *   jdcolor.c   build_ycc_rgb_table (SCALEBITS 16), ycc_rgb_convert,
 *               ycck_cmyk_convert, grayscale_convert, rgb_gray_convert
 *   jdmarker.c  default colour space: JFIF marker, else Adobe transform,
 *               else component ids; get_dac
 *   jdhuff.c    jpeg_make_d_derived_tbl, the DC and AC decoding
 *   jdphuff.c   the progressive scans' parameter checks and their four
 *               decoders (DC first, DC refine, AC first, AC refine), EOB
 *               runs, restarts
 *   jdarith.c   the QM decoder (jaricom.c's table), the DC and AC
 *               statistics and conditioning of the sequential and the four
 *               progressive decoders, restarts
 *   jdlhuff.c, jdlossls.c, jddiffct.c  lossless: the sample differences,
 *               the predictors and their first rows, restarts by rows
 *   jdcoefct.c  smoothing_ok and decompress_smooth_data (2.1 and later:
 *               the 5x5 DC window, and the DC itself interpolated while no
 *               AC scan has come)
 *   jstdhuff.c  the standard tables for Huffman tables 0 and 1 that no DHT
 *               defines (Motion-JPEG frames leave them out)
 * and mode 1 OpenCV's grfmt_jpeg.cpp (gray output, CMYK for four
 * components) with icvCvt_CMYK2Gray_8u_C4C1R.
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
#define MAX_COMPS 4
#define SMOOTH_COEFS 10 /* jdcoefct.c SAVED_COEFS: the coefficients smoothing looks at */

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
    int maxval; /* the largest symbol: a DC table's may be 15 (16 in a lossless file) */
} huff_t;

typedef struct {
    int id, h, v, tq;
    int dw, dh;        /* samples of the component (downsampled size) */
    int bw, bh;        /* blocks of its plane */
    size_t stride;     /* bytes a plane row */
    uint8_t *plane;
    int16_t *coef;     /* progressive: bw x bh blocks of 64 coefficients */
    int16_t q[64];     /* its quantization table, latched at its first scan */
    int coded;         /* a scan has carried it (and q is latched) */
    int coef_bits[SMOOTH_COEFS]; /* progressive: the Al of the last scan of each, -1 none */
    int sv;            /* the vertical sampling factor the SOF gives (smoothing's iMCU rows) */
    int dc_pred;
    int dc_context;    /* arithmetic: the DC conditioning category's first bin */
    int td, ta;
    int32_t *diff;     /* lossless: bw x bh sample differences, then the undifferenced samples */
    int first_row;     /* lossless: its next row is predicted as a scan's first */
} comp_t;

typedef struct {
    jmp_buf jb;
    char *msg;
    size_t msg_len;
    const uint8_t *data;
    size_t len, pos;
    int width, height, ncomp, sof, progressive, arith, lossless, scans, one_scan;
    int mode; /* 0: PIL's array; 1: OpenCV's IMREAD_ANYDEPTH gray */
    int hmax, vmax;
    comp_t comp[MAX_COMPS];
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
    int eobrun; /* progressive AC scans: blocks left in the current EOB run */
    /* arithmetic decoding (jdarith.c): the C and A registers, the bit
     * counter (-16 before the first two bytes, -1 after a coding error), the
     * statistics bins of each table, and the DAC conditioning */
    int64_t ac_c, ac_a;
    int ac_ct;
    uint8_t dc_stats[16][64], ac_stats[16][256], fixed_bin[4];
    uint8_t dac_l[16], dac_u[16], dac_k[16];
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
    if (marker == 0xC5 || marker == 0xC6 || marker == 0xC7 || marker == 0xCD || marker == 0xCE ||
        marker == 0xCF)
        fail(d, JD_UNSUPPORTED, "hierarchical (differential) JPEG (SOF%d) is not supported",
             marker - 0xC0);
    if (marker == 0xCB) /* libjpeg-turbo codes lossless files with Huffman tables only */
        fail(d, JD_UNSUPPORTED, "arithmetic-coded lossless JPEG (SOF11) is not supported");
    d->progressive = marker == 0xC2 || marker == 0xCA;
    d->arith = marker >= 0xC9;
    d->lossless = marker == 0xC3;
    if (n < 6) fail(d, JD_CORRUPT, "SOF segment of %zu bytes", n);
    int precision = p[0];
    d->height = (p[1] << 8) | p[2];
    d->width = (p[3] << 8) | p[4];
    d->ncomp = p[5];
    if (precision != 8)
        fail(d, JD_UNSUPPORTED, "%d-bit JPEG samples are not supported (8 are)", precision);
    if (d->ncomp == 0 || d->width == 0) fail(d, JD_CORRUPT, "empty image in SOF");
    if (d->height == 0) fail(d, JD_UNSUPPORTED, "image height given by a DNL marker is not supported");
    if (d->ncomp != 1 && d->ncomp != 3 && d->ncomp != 4)
        fail(d, JD_UNSUPPORTED, "JPEG with %d components is not supported (1, 3 and 4 are)", d->ncomp);
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
    for (int i = 0; d->ncomp > 1 && i < d->ncomp; i++) {
        /* jdsample.c upsamples by whole ratios only (JERR_FRACT_SAMPLE_NOTIMPL) */
        comp_t *c = &d->comp[i];
        if (d->hmax % c->h || d->vmax % c->v) {
            char f[64] = "";
            for (int j = 0; j < d->ncomp; j++)
                snprintf(f + strlen(f), sizeof(f) - strlen(f), "%s%dx%d", j ? "," : "", d->comp[j].h,
                         d->comp[j].v);
            fail(d, JD_UNSUPPORTED, "sampling factors %s are not supported: libjpeg upsamples by "
                 "whole ratios only", f);
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
    t->maxval = 0; /* checked when a scan takes it as its DC table */
    for (int i = 0; i < nsym; i++)
        if (t->vals[i] > t->maxval) t->maxval = t->vals[i];
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

/* jstdhuff.c: the tables of the JPEG standard's annex K.3 (DC and AC,
 * luminance then chrominance), 16 code counts then the symbols; libjpeg
 * gives them to tables 0 and 1 that no DHT has defined when decoding
 * starts (Motion-JPEG frames leave them out) */
static const uint8_t std_dc0[28] = {
    0x00, 0x01, 0x05, 0x01, 0x01, 0x01, 0x01, 0x01, 0x01, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00,
    0x00, 0x01, 0x02, 0x03, 0x04, 0x05, 0x06, 0x07, 0x08, 0x09, 0x0a, 0x0b,
};
static const uint8_t std_dc1[28] = {
    0x00, 0x03, 0x01, 0x01, 0x01, 0x01, 0x01, 0x01, 0x01, 0x01, 0x01, 0x00, 0x00, 0x00, 0x00, 0x00,
    0x00, 0x01, 0x02, 0x03, 0x04, 0x05, 0x06, 0x07, 0x08, 0x09, 0x0a, 0x0b,
};
static const uint8_t std_ac0[178] = {
    0x00, 0x02, 0x01, 0x03, 0x03, 0x02, 0x04, 0x03, 0x05, 0x05, 0x04, 0x04, 0x00, 0x00, 0x01, 0x7d,
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61, 0x07,
    0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0,
    0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49,
    0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69,
    0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7,
    0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5,
    0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8,
    0xf9, 0xfa,
};
static const uint8_t std_ac1[178] = {
    0x00, 0x02, 0x01, 0x02, 0x04, 0x04, 0x03, 0x04, 0x07, 0x05, 0x04, 0x04, 0x00, 0x01, 0x02, 0x77,
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61, 0x71,
    0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0,
    0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48,
    0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68,
    0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5,
    0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3,
    0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8,
    0xf9, 0xfa,
};

static void set_huff(dec_t *d, huff_t *t, const uint8_t *spec, int is_dc) {
    int count = 0;
    t->bits[0] = 0;
    for (int l = 1; l <= 16; l++) count += t->bits[l] = spec[l - 1];
    memset(t->vals, 0, sizeof(t->vals));
    memcpy(t->vals, spec + 16, (size_t)count);
    derive_huff(d, t, is_dc);
    t->defined = 1;
}

/* jdhuff.c jinit_huff_decoder / jdphuff.c jinit_phuff_decoder: std_huff_tables */
static void default_huff(dec_t *d) {
    if (!d->dc[0].defined) set_huff(d, &d->dc[0], std_dc0, 1);
    if (!d->dc[1].defined) set_huff(d, &d->dc[1], std_dc1, 1);
    if (!d->ac[0].defined) set_huff(d, &d->ac[0], std_ac0, 0);
    if (!d->ac[1].defined) set_huff(d, &d->ac[1], std_ac1, 0);
}

static void read_dht(dec_t *d) {
    size_t n;
    const uint8_t *p = segment(d, &n);
    size_t i = 0;
    while (i < n) {
        if (n - i < 17) fail(d, JD_CORRUPT, "truncated DHT segment");
        int tc = p[i] >> 4, th = p[i] & 15;
        if (tc > 1 || th > 3) fail(d, JD_CORRUPT, "DHT table class %d, id %d", tc, th);
        int count = 0;
        for (int l = 1; l <= 16; l++) count += p[i + l];
        if (count > 256 || (size_t)count > n - i - 17) fail(d, JD_CORRUPT, "bad Huffman table");
        set_huff(d, tc ? &d->ac[th] : &d->dc[th], p + i + 1, tc == 0);
        i += 17 + (size_t)count;
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

/* ------------------------------------------------- arithmetic decoding */

/* jaricom.c jpeg_aritab, T.81 table D.2: (Qe << 16) | (Next_Index_MPS << 8)
 * | (Switch_MPS << 7) | Next_Index_LPS; entry 113 is the fixed estimate of
 * 0.5 that sign and refinement bits are coded with */
#define V(qe, nlps, nmps, sw) (((int32_t)(qe) << 16) | ((nmps) << 8) | ((sw) << 7) | (nlps))
static const int32_t aritab[114] = {
    V(0x5a1d, 1, 1, 1),     V(0x2586, 14, 2, 0),    V(0x1114, 16, 3, 0),    V(0x080b, 18, 4, 0),
    V(0x03d8, 20, 5, 0),    V(0x01da, 23, 6, 0),    V(0x00e5, 25, 7, 0),    V(0x006f, 28, 8, 0),
    V(0x0036, 30, 9, 0),    V(0x001a, 33, 10, 0),   V(0x000d, 35, 11, 0),   V(0x0006, 9, 12, 0),
    V(0x0003, 10, 13, 0),   V(0x0001, 12, 13, 0),   V(0x5a7f, 15, 15, 1),   V(0x3f25, 36, 16, 0),
    V(0x2cf2, 38, 17, 0),   V(0x207c, 39, 18, 0),   V(0x17b9, 40, 19, 0),   V(0x1182, 42, 20, 0),
    V(0x0cef, 43, 21, 0),   V(0x09a1, 45, 22, 0),   V(0x072f, 46, 23, 0),   V(0x055c, 48, 24, 0),
    V(0x0406, 49, 25, 0),   V(0x0303, 51, 26, 0),   V(0x0240, 52, 27, 0),   V(0x01b1, 54, 28, 0),
    V(0x0144, 56, 29, 0),   V(0x00f5, 57, 30, 0),   V(0x00b7, 59, 31, 0),   V(0x008a, 60, 32, 0),
    V(0x0068, 62, 33, 0),   V(0x004e, 63, 34, 0),   V(0x003b, 32, 35, 0),   V(0x002c, 33, 9, 0),
    V(0x5ae1, 37, 37, 1),   V(0x484c, 64, 38, 0),   V(0x3a0d, 65, 39, 0),   V(0x2ef1, 67, 40, 0),
    V(0x261f, 68, 41, 0),   V(0x1f33, 69, 42, 0),   V(0x19a8, 70, 43, 0),   V(0x1518, 72, 44, 0),
    V(0x1177, 73, 45, 0),   V(0x0e74, 74, 46, 0),   V(0x0bfb, 75, 47, 0),   V(0x09f8, 77, 48, 0),
    V(0x0861, 78, 49, 0),   V(0x0706, 79, 50, 0),   V(0x05cd, 48, 51, 0),   V(0x04de, 50, 52, 0),
    V(0x040f, 50, 53, 0),   V(0x0363, 51, 54, 0),   V(0x02d4, 52, 55, 0),   V(0x025c, 53, 56, 0),
    V(0x01f8, 54, 57, 0),   V(0x01a4, 55, 58, 0),   V(0x0160, 56, 59, 0),   V(0x0125, 57, 60, 0),
    V(0x00f6, 58, 61, 0),   V(0x00cb, 59, 62, 0),   V(0x00ab, 61, 63, 0),   V(0x008f, 61, 32, 0),
    V(0x5b12, 65, 65, 1),   V(0x4d04, 80, 66, 0),   V(0x412c, 81, 67, 0),   V(0x37d8, 82, 68, 0),
    V(0x2fe8, 83, 69, 0),   V(0x293c, 84, 70, 0),   V(0x2379, 86, 71, 0),   V(0x1edf, 87, 72, 0),
    V(0x1aa9, 87, 73, 0),   V(0x174e, 72, 74, 0),   V(0x1424, 72, 75, 0),   V(0x119c, 74, 76, 0),
    V(0x0f6b, 74, 77, 0),   V(0x0d51, 75, 78, 0),   V(0x0bb6, 77, 79, 0),   V(0x0a40, 77, 48, 0),
    V(0x5832, 80, 81, 1),   V(0x4d1c, 88, 82, 0),   V(0x438e, 89, 83, 0),   V(0x3bdd, 90, 84, 0),
    V(0x34ee, 91, 85, 0),   V(0x2eae, 92, 86, 0),   V(0x299a, 93, 87, 0),   V(0x2516, 86, 71, 0),
    V(0x5570, 88, 89, 1),   V(0x4ca9, 95, 90, 0),   V(0x44d9, 96, 91, 0),   V(0x3e22, 97, 92, 0),
    V(0x3824, 99, 93, 0),   V(0x32b4, 99, 94, 0),   V(0x2e17, 93, 86, 0),   V(0x56a8, 95, 96, 1),
    V(0x4f46, 101, 97, 0),  V(0x47e5, 102, 98, 0),  V(0x41cf, 103, 99, 0),  V(0x3c3d, 104, 100, 0),
    V(0x375e, 99, 93, 0),   V(0x5231, 105, 102, 0), V(0x4c0f, 106, 103, 0), V(0x4639, 107, 104, 0),
    V(0x415e, 103, 99, 0),  V(0x5627, 105, 106, 1), V(0x50e7, 108, 107, 0), V(0x4b85, 109, 103, 0),
    V(0x5597, 110, 109, 0), V(0x504f, 111, 107, 0), V(0x5a10, 110, 111, 1), V(0x5522, 112, 109, 0),
    V(0x59eb, 112, 111, 1), V(0x5a1d, 113, 113, 0),
};
#undef V

/* the next byte of the coded data: a stuffed 0xFF 0x00 is 0xFF; a marker
 * (or the end of the data) gives zeros from there on, pos left on it */
static int arith_byte(dec_t *d) {
    if (d->marker_hit) return 0;
    if (d->pos >= d->len) {
        d->marker_hit = 1;
        return 0;
    }
    int c = d->data[d->pos];
    if (c != 0xFF) {
        d->pos++;
        return c;
    }
    size_t q = d->pos + 1;
    while (q < d->len && d->data[q] == 0xFF) q++;
    if (q < d->len && d->data[q] == 0) {
        d->pos = q + 1;
        return 0xFF;
    }
    d->marker_hit = 1;
    return 0;
}

/* jdarith.c arith_decode: one binary decision with the estimate in *st */
static int arith_decode(dec_t *d, uint8_t *st) {
    while (d->ac_a < 0x8000) { /* renormalization and data input, D.2.6 */
        if (--d->ac_ct < 0) {
            d->ac_c = (d->ac_c << 8) | arith_byte(d);
            if ((d->ac_ct += 8) < 0 && ++d->ac_ct == 0) d->ac_a = 0x8000; /* the first two bytes */
        }
        d->ac_a <<= 1;
    }
    int sv = *st;
    int32_t qe = aritab[sv & 0x7F];
    int nl = qe & 0xFF, nm = (qe >> 8) & 0xFF;
    qe >>= 16;
    int64_t temp = d->ac_a - qe; /* decoding and estimation, D.2.4 and D.2.5 */
    d->ac_a = temp;
    temp <<= d->ac_ct;
    if (d->ac_c >= temp) {
        d->ac_c -= temp;
        if (d->ac_a < qe) { /* conditional exchange: the MPS */
            d->ac_a = qe;
            *st = (uint8_t)((sv & 0x80) ^ nm);
        } else {
            d->ac_a = qe;
            *st = (uint8_t)((sv & 0x80) ^ nl);
            sv ^= 0x80;
        }
    } else if (d->ac_a < 0x8000) {
        if (d->ac_a < qe) {
            *st = (uint8_t)((sv & 0x80) ^ nl);
            sv ^= 0x80;
        } else {
            *st = (uint8_t)((sv & 0x80) ^ nm);
        }
    }
    return sv >> 7;
}

/* the magnitude bits of a value whose category bin is st (F.24), signed */
static int arith_magnitude(dec_t *d, uint8_t *st, int m, int sign) {
    int v = m;
    st += 14;
    while (m >>= 1)
        if (arith_decode(d, st)) v |= m;
    v += 1;
    return sign ? -v : v;
}

/* jdarith.c, the DC difference of a block (F.19-F.24, the conditioning of
 * F.1.4.4.1.2) added to the component's prediction (16 bits, as libjpeg
 * keeps it); 0 after a coding error, which stops the scan's decoding */
static int arith_dc(dec_t *d, comp_t *c) {
    int tbl = c->td;
    uint8_t *st = d->dc_stats[tbl] + c->dc_context;
    if (arith_decode(d, st) == 0) {
        c->dc_context = 0;
        return 1;
    }
    int sign = arith_decode(d, st + 1);
    st += 2 + sign;
    int m = arith_decode(d, st);
    if (m) {
        st = d->dc_stats[tbl] + 20; /* X1 */
        while (arith_decode(d, st)) {
            if ((m <<= 1) == 0x8000) {
                d->ac_ct = -1; /* magnitude overflow */
                return 0;
            }
            st++;
        }
    }
    if (m < (int)((1L << d->dac_l[tbl]) >> 1))
        c->dc_context = 0;
    else if (m > (int)((1L << d->dac_u[tbl]) >> 1))
        c->dc_context = 12 + sign * 4;
    else
        c->dc_context = 4 + sign * 4;
    c->dc_pred = (c->dc_pred + arith_magnitude(d, st, m, sign)) & 0xffff;
    return 1;
}

/* jdarith.c, the AC coefficients ss-se of a block (F.20), scaled by 2^al */
static int arith_ac(dec_t *d, comp_t *c, int16_t *blk, int ss, int se, int al) {
    int tbl = c->ta;
    for (int k = ss; k <= se; k++) {
        uint8_t *st = d->ac_stats[tbl] + 3 * (k - 1);
        if (arith_decode(d, st)) break; /* EOB */
        while (arith_decode(d, st + 1) == 0) {
            st += 3;
            if (++k > se) {
                d->ac_ct = -1; /* spectral overflow */
                return 0;
            }
        }
        int sign = arith_decode(d, d->fixed_bin);
        st += 2;
        int m = arith_decode(d, st);
        if (m && arith_decode(d, st)) {
            m <<= 1;
            st = d->ac_stats[tbl] + (k <= d->dac_k[tbl] ? 189 : 217);
            while (arith_decode(d, st)) {
                if ((m <<= 1) == 0x8000) {
                    d->ac_ct = -1; /* magnitude overflow */
                    return 0;
                }
                st++;
            }
        }
        blk[natural_order[k]] = (int16_t)((unsigned)arith_magnitude(d, st, m, sign) << al);
    }
    return 1;
}

/* jdarith.c decode_mcu_AC_refine, one block */
static int arith_ac_refine(dec_t *d, comp_t *c, int16_t *blk, int ss, int se, int al) {
    int tbl = c->ta, p1 = 1 << al, m1 = -p1, kex;
    for (kex = se; kex > 0; kex--) /* the previous stage's end of block */
        if (blk[natural_order[kex]]) break;
    for (int k = ss; k <= se; k++) {
        uint8_t *st = d->ac_stats[tbl] + 3 * (k - 1);
        if (k > kex && arith_decode(d, st)) break; /* EOB */
        for (;;) {
            int16_t *t = blk + natural_order[k];
            if (*t) { /* a correction bit */
                if (arith_decode(d, st + 2)) *t = (int16_t)(*t + (*t < 0 ? m1 : p1));
                break;
            }
            if (arith_decode(d, st + 1)) { /* newly nonzero */
                *t = (int16_t)(arith_decode(d, d->fixed_bin) ? m1 : p1);
                break;
            }
            st += 3;
            if (++k > se) {
                d->ac_ct = -1; /* spectral overflow */
                return 0;
            }
        }
    }
    return 1;
}

/* jdarith.c start_pass / process_restart: the scan's statistics bins and
 * predictions set to zero, and the registers to read two bytes afresh */
static void arith_reset(dec_t *d, comp_t **sc, int ns, int ss, int ah) {
    for (int i = 0; i < ns; i++) {
        comp_t *c = sc[i];
        if (!d->progressive || (ss == 0 && ah == 0)) {
            memset(d->dc_stats[c->td], 0, sizeof(d->dc_stats[0]));
            c->dc_pred = 0;
            c->dc_context = 0;
        }
        if (!d->progressive || ss) memset(d->ac_stats[c->ta], 0, sizeof(d->ac_stats[0]));
    }
    d->ac_c = 0;
    d->ac_a = 0;
    d->ac_ct = -16;
}

/* jdmarker.c get_dac: conditioning (L, U) of DC tables 0-15, K of AC
 * tables 16-31 */
static void read_dac(dec_t *d) {
    size_t n;
    const uint8_t *p = segment(d, &n);
    if (n % 2) fail(d, JD_CORRUPT, "DAC segment of %zu bytes", n);
    for (size_t i = 0; i < n; i += 2) {
        int index = p[i], val = p[i + 1];
        if (index >= 32) fail(d, JD_CORRUPT, "DAC table index %d", index);
        if (index >= 16) {
            d->dac_k[index - 16] = (uint8_t)val;
        } else {
            if ((val & 15) > (val >> 4)) fail(d, JD_CORRUPT, "DAC value 0x%02X (L above U)", val);
            d->dac_l[index] = (uint8_t)(val & 15);
            d->dac_u[index] = (uint8_t)(val >> 4);
        }
    }
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
static void decode_block(dec_t *d, comp_t *c, int bx, int by) {
    const int16_t *q = c->q;
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

/* ------------------------------------------------------ progressive scans */

static inline int16_t *block_at(const comp_t *c, int bx, int by) {
    return c->coef + ((size_t)by * (size_t)c->bw + (size_t)bx) * 64;
}

/* jdphuff.c decode_mcu_DC_first, one block */
static void dc_first(dec_t *d, comp_t *c, int16_t *blk, int al) {
    int s = huff_decode(d, &d->dc[c->td]);
    int diff = s ? extend(get_bits(d, s), s) : 0;
    if ((c->dc_pred >= 0 && diff > INT_MAX - c->dc_pred) ||
        (c->dc_pred < 0 && diff < INT_MIN - c->dc_pred))
        fail(d, JD_CORRUPT, "corrupt JPEG data: DC coefficient out of range");
    c->dc_pred += diff;
    blk[0] = (int16_t)((unsigned)c->dc_pred << al);
}

/* jdphuff.c decode_mcu_AC_first */
static void ac_first(dec_t *d, const huff_t *ac, int16_t *blk, int ss, int se, int al) {
    if (d->eobrun > 0) { /* a block of the band of zeros */
        d->eobrun--;
        return;
    }
    for (int k = ss; k <= se; k++) {
        int rs = huff_decode(d, ac), r = rs >> 4, s = rs & 15;
        if (s) {
            k += r;
            int v = extend(get_bits(d, s), s);
            blk[natural_order[k]] = (int16_t)((unsigned)v << al);
        } else if (r == 15) {
            k += 15; /* ZRL */
        } else { /* EOBr: this block and 2^r - 1 + the next r bits more */
            d->eobrun = 1 << r;
            if (r) d->eobrun += get_bits(d, r);
            d->eobrun--;
            break;
        }
    }
}

/* jdphuff.c decode_mcu_AC_refine: a correction bit for every coefficient
 * already nonzero that the band passes, new coefficients of +-2^al placed
 * after r zeros */
static void ac_refine(dec_t *d, const huff_t *ac, int16_t *blk, int ss, int se, int al) {
    int p1 = 1 << al, m1 = -p1;
    int k = ss;
    if (d->eobrun == 0) {
        for (; k <= se; k++) {
            int rs = huff_decode(d, ac), r = rs >> 4, s = rs & 15;
            if (s) { /* a size other than 1 is libjpeg's warning, not its error */
                s = get_bits(d, 1) ? p1 : m1;
            } else if (r != 15) {
                d->eobrun = 1 << r;
                if (r) d->eobrun += get_bits(d, r);
                break; /* the rest of the block is the EOB run's */
            }
            do {
                int16_t *t = blk + natural_order[k];
                if (*t) {
                    if (get_bits(d, 1) && !(*t & p1)) *t = (int16_t)(*t + (*t >= 0 ? p1 : m1));
                } else if (--r < 0) {
                    break; /* the zero the new coefficient takes */
                }
                k++;
            } while (k <= se);
            if (s) blk[natural_order[k]] = (int16_t)s;
        }
    }
    if (d->eobrun > 0) {
        for (; k <= se; k++) {
            int16_t *t = blk + natural_order[k];
            if (*t && get_bits(d, 1) && !(*t & p1)) *t = (int16_t)(*t + (*t >= 0 ? p1 : m1));
        }
        d->eobrun--;
    }
}

/* jdphuff.c start_pass_phuff_decoder's checks (jdarith.c's are the same) */
static void check_progression(dec_t *d, comp_t **sc, int ns, int ss, int se, int ah, int al) {
    int bad = ss == 0 ? se != 0 : (ss > se || se > 63 || ns != 1);
    if ((ah && al != ah - 1) || al > 13) bad = 1;
    if (bad)
        fail(d, JD_CORRUPT, "invalid progressive scan (Ss %d, Se %d, Ah %d, Al %d)", ss, se, ah, al);
    for (int i = 0; i < ns; i++) {
        comp_t *c = sc[i];
        if (!d->arith && ss == 0 && ah == 0 && !d->dc[c->td].defined)
            fail(d, JD_CORRUPT, "scan with DC Huffman table %d, which no DHT defines", c->td);
        if (!d->arith && ss > 0 && !d->ac[c->ta].defined)
            fail(d, JD_CORRUPT, "scan with AC Huffman table %d, which no DHT defines", c->ta);
        for (int k = ss; k <= se && k < SMOOTH_COEFS; k++) c->coef_bits[k] = al;
    }
}

/* ------------------------------------------------------- lossless scans */

/* jdlhuff.c: a sample difference (H.2.2; category 16 is 32768, no bits) */
static int lossless_diff(dec_t *d, const huff_t *t) {
    int s = huff_decode(d, t);
    if (s == 0) return 0;
    if (s == 16) return 32768;
    return extend(get_bits(d, s), s);
}

/* jdlossls.c: row y of a component from its differences, in place, by
 * predictor psv (Ra left, Rb above, Rc above-left), or as a scan's (or a
 * restart's) first row: each sample from the one to its left, the first
 * from 2^(P - Pt - 1); the first sample of any other row from Rb; 16 bits */
static void undifference(comp_t *c, int y, int psv, int pt) {
    int32_t *row = c->diff + (size_t)y * (size_t)c->bw;
    int w = c->dw;
    if (c->first_row) {
        int ra = row[0] = (row[0] + (1 << (8 - pt - 1))) & 0xFFFF;
        for (int x = 1; x < w; x++) ra = row[x] = (row[x] + ra) & 0xFFFF;
        c->first_row = 0;
        return;
    }
    const int32_t *prev = row - c->bw;
    int rb = prev[0], ra = row[0] = (row[0] + rb) & 0xFFFF;
    for (int x = 1; x < w; x++) {
        int rc = rb, pred;
        rb = prev[x];
        switch (psv) {
        case 1: pred = ra; break;
        case 2: pred = rb; break;
        case 3: pred = rc; break;
        case 4: pred = ra + rb - rc; break;
        case 5: pred = ra + ((rb - rc) >> 1); break;
        case 6: pred = rb + ((ra - rc) >> 1); break;
        default: pred = (ra + rb) >> 1; break;
        }
        ra = row[x] = (row[x] + pred) & 0xFFFF;
    }
}

static int last_row_height(const comp_t *c) { return c->dh % c->v ? c->dh % c->v : c->v; }

/* jddiffct.c decompress_data: a lossless scan one iMCU row (vmax sample
 * rows) at a time, its MCU rows decoded, then its rows undifferenced and
 * shifted by the point transform (Pt) into the planes; a restart (every
 * whole number of MCU rows) makes the next row a first row */
static void lossless_scan(dec_t *d, comp_t **sc, int ns, int psv, int pt) {
    int rows = (d->height + d->vmax - 1) / d->vmax;
    int per_row = ns == 1 ? sc[0]->dw : (d->width + d->hmax - 1) / d->hmax;
    if (d->restart_interval % per_row)
        fail(d, JD_CORRUPT, "restart interval of %d MCUs in a lossless scan of %d MCUs a row (libjpeg "
             "requires whole rows)", d->restart_interval, per_row);
    int rst_rows = d->restart_interval / per_row, to_go = rst_rows, next_rst = 0;
    for (int i = 0; i < d->ncomp; i++) d->comp[i].first_row = 1;
    bits_reset(d);
    for (int ir = 0; ir < rows; ir++) {
        int mcu_rows = ns > 1 ? 1 : ir < rows - 1 ? sc[0]->v : last_row_height(sc[0]);
        for (int yo = 0; yo < mcu_rows; yo++) {
            if (d->restart_interval && to_go-- == 0) {
                restart(d, &next_rst);
                for (int i = 0; i < d->ncomp; i++) d->comp[i].first_row = 1;
                to_go = rst_rows - 1;
            }
            for (int mx = 0; mx < per_row; mx++) {
                for (int i = 0; i < ns; i++) {
                    comp_t *c = sc[i];
                    int bh = ns == 1 ? 1 : c->v, bwid = ns == 1 ? 1 : c->h;
                    for (int by = 0; by < bh; by++)
                        for (int bx = 0; bx < bwid; bx++)
                            c->diff[(size_t)(ir * c->v + yo + by) * (size_t)c->bw + (size_t)(mx * bwid + bx)] =
                                lossless_diff(d, &d->dc[c->td]);
                }
                if (d->pad_bits > d->nbits)
                    fail(d, JD_CORRUPT, "truncated or corrupt JPEG data (the scan ends early)");
            }
        }
        for (int i = 0; i < ns; i++) {
            comp_t *c = sc[i];
            int n = ir < rows - 1 ? c->v : last_row_height(c);
            for (int r = 0; r < n; r++) {
                int y = ir * c->v + r;
                undifference(c, y, psv, pt);
                const int32_t *row = c->diff + (size_t)y * (size_t)c->bw;
                uint8_t *o = c->plane + (size_t)y * c->stride;
                for (int x = 0; x < c->dw; x++) o[x] = (uint8_t)(row[x] << pt);
            }
        }
    }
    bits_reset(d);
}

/* jdapimin.c default_decompress_parms: a JFIF marker says YCbCr, else an
 * Adobe marker's transform (0: RGB), else the component ids 'R', 'G', 'B' */
static int is_ycc(const dec_t *d) {
    if (d->saw_jfif) return 1;
    if (d->saw_adobe) return d->adobe_transform != 0;
    /* libjpeg-turbo 3 takes a lossless file without either marker as RGB */
    return !d->lossless && !(d->comp[0].id == 82 && d->comp[1].id == 71 && d->comp[2].id == 66);
}

/* jdcolor.c: libjpeg converts no colour in a lossless file, so its colour
 * space must be the output's (gray, RGB or CMYK; OpenCV asks for gray, or
 * CMYK from four components) */
static void check_lossless_colour(dec_t *d) {
    int ycc = d->ncomp == 3 ? is_ycc(d) : d->ncomp == 4 && d->saw_adobe && d->adobe_transform != 0;
    if (ycc || (d->mode == 1 && d->ncomp == 3))
        fail(d, JD_UNSUPPORTED, "lossless JPEG in %s, which libjpeg would have to convert to %s, is not "
             "supported (libjpeg converts no colour in a lossless file)",
             d->ncomp == 4 ? "YCCK" : ycc ? "YCbCr" : "RGB", d->mode == 1 && d->ncomp == 3 ? "gray"
             : d->ncomp == 4 ? "CMYK" : "RGB");
}

/* ----------------------------------------------------------------- scans */

static void read_scan(dec_t *d) {
    size_t n;
    const uint8_t *p = segment(d, &n);
    if (!d->sof) fail(d, JD_CORRUPT, "SOS before SOF");
    if (n < 1) fail(d, JD_CORRUPT, "empty SOS segment");
    int ns = p[0];
    if (ns < 1 || ns > d->ncomp || n != 4 + 2 * (size_t)ns)
        fail(d, JD_CORRUPT, "SOS segment of %zu bytes for %d components", n, ns);
    if (!d->scans++) { /* jpeg_read_header's choices, at the first SOS */
        if (!d->arith) default_huff(d);
        if (d->lossless) check_lossless_colour(d);
        /* jdinput.c initial_setup: a sequential file whose first scan holds
         * every component has no other scan */
        d->one_scan = !d->progressive && ns == d->ncomp;
    } else if (d->one_scan) {
        fail(d, JD_CORRUPT, "corrupt JPEG data: a second scan in a sequential file whose first scan "
             "holds every component (libjpeg expects the EOI)");
    }
    int ss = p[1 + 2 * ns], se = p[2 + 2 * ns], ah = p[3 + 2 * ns] >> 4, al = p[3 + 2 * ns] & 15;
    /* the scan's kind: 0 DC first (or sequential), 1 DC refine, 2 AC first, 3 AC refine */
    int kind = ss == 0 ? (ah ? 1 : 0) : (ah ? 3 : 2);
    if (d->lossless && (ss < 1 || ss > 7 || se != 0 || ah != 0 || al > 7))
        fail(d, JD_CORRUPT, "invalid lossless scan (predictor %d, Se %d, Ah %d, Pt %d)", ss, se, ah, al);
    comp_t *sc[MAX_COMPS];
    for (int i = 0; i < ns; i++) {
        comp_t *c = comp_by_id(d, p[1 + 2 * i], sc, i);
        c->td = p[2 + 2 * i] >> 4;
        c->ta = p[2 + 2 * i] & 15;
        if (!d->arith) {
            if (c->td > 3 || c->ta > 3) fail(d, JD_CORRUPT, "SOS Huffman tables %d, %d", c->td, c->ta);
            int dc_used = d->lossless || kind == 0, ac_used = !d->lossless;
            if (!d->progressive && (!d->dc[c->td].defined || (ac_used && !d->ac[c->ta].defined)))
                fail(d, JD_CORRUPT, "scan with Huffman tables %d and %d, which no DHT defines", c->td, c->ta);
            if (dc_used && d->dc[c->td].defined && d->dc[c->td].maxval > (d->lossless ? 16 : 15))
                fail(d, JD_CORRUPT, "bad DC Huffman table");
        }
        if (!c->coded && !d->lossless) { /* jdinput.c latch_quant_tables: the table as the first scan finds it */
            if (!d->qt_defined[c->tq]) fail(d, JD_CORRUPT, "quantization table %d is not defined", c->tq);
            for (int k = 0; k < 64; k++) c->q[k] = (int16_t)d->qt[c->tq][k];
        }
        sc[i] = c;
    }
    int blocks = 0;
    for (int i = 0; ns > 1 && i < ns; i++) blocks += sc[i]->h * sc[i]->v;
    if (blocks > MAX_BLOCKS_IN_MCU) fail(d, JD_CORRUPT, "%d blocks an MCU", blocks);
    for (int i = 0; i < ns; i++) {
        sc[i]->dc_pred = 0;
        sc[i]->coded = 1;
    }
    if (d->lossless) {
        lossless_scan(d, sc, ns, ss, al);
        return;
    }
    if (d->progressive) check_progression(d, sc, ns, ss, se, ah, al);
    int mcux, mcuy;
    if (ns == 1) {
        mcux = (sc[0]->dw + 7) / 8;
        mcuy = (sc[0]->dh + 7) / 8;
    } else {
        mcux = (d->width + 8 * d->hmax - 1) / (8 * d->hmax);
        mcuy = (d->height + 8 * d->vmax - 1) / (8 * d->vmax);
    }
    const huff_t *ac = &d->ac[sc[0]->ta & 3];
    bits_reset(d);
    d->eobrun = 0;
    if (d->arith) arith_reset(d, sc, ns, ss, ah);
    int left = d->restart_interval, next_rst = 0;
    int16_t coef[64];
    for (int my = 0; my < mcuy; my++) {
        for (int mx = 0; mx < mcux; mx++) {
            if (d->restart_interval) {
                if (left == 0) {
                    restart(d, &next_rst);
                    for (int i = 0; i < ns; i++) sc[i]->dc_pred = 0;
                    d->eobrun = 0;
                    if (d->arith) arith_reset(d, sc, ns, ss, ah);
                    left = d->restart_interval;
                }
                left--;
            }
            for (int i = 0; i < ns; i++) {
                comp_t *c = sc[i];
                int bh = ns == 1 ? 1 : c->v, bwid = ns == 1 ? 1 : c->h;
                for (int by = 0; by < bh; by++) {
                    for (int bx = 0; bx < bwid; bx++) {
                        int x = mx * bwid + bx, y = my * bh + by;
                        if (!d->progressive && !d->arith) {
                            decode_block(d, c, x, y);
                            continue;
                        }
                        int16_t *blk = d->progressive ? block_at(c, x, y) : coef;
                        if (!d->progressive) memset(coef, 0, sizeof(coef));
                        if (d->arith && d->ac_ct == -1) {
                            /* jdarith.c: after a coding error the scan's blocks are left as
                             * they are (a sequential file's as zeros) until the next restart */
                        } else if (d->arith && !d->progressive) {
                            if (arith_dc(d, c)) {
                                coef[0] = (int16_t)c->dc_pred;
                                arith_ac(d, c, coef, 1, 63, 0);
                            }
                        } else if (d->arith) {
                            if (kind == 0) {
                                if (arith_dc(d, c)) blk[0] = (int16_t)((unsigned)c->dc_pred << al);
                            } else if (kind == 1) {
                                if (arith_decode(d, d->fixed_bin)) blk[0] = (int16_t)(blk[0] | (1 << al));
                            } else if (kind == 2) {
                                arith_ac(d, c, blk, ss, se, al);
                            } else {
                                arith_ac_refine(d, c, blk, ss, se, al);
                            }
                        } else if (kind == 0) {
                            dc_first(d, c, blk, al);
                        } else if (kind == 1) {
                            blk[0] = (int16_t)(blk[0] | (get_bits(d, 1) << al));
                        } else if (kind == 2) {
                            ac_first(d, ac, blk, ss, se, al);
                        } else {
                            ac_refine(d, ac, blk, ss, se, al);
                        }
                        if (!d->progressive)
                            idct_islow(coef, c->q, d->idct_limit,
                                       c->plane + (size_t)y * 8 * c->stride + (size_t)x * 8, c->stride);
                    }
                }
            }
            if (!d->arith && d->pad_bits > d->nbits)
                fail(d, JD_CORRUPT, "truncated or corrupt JPEG data (the scan ends early)");
        }
    }
    bits_reset(d);
}

/* ------------------------------------------------------- block smoothing */

/* jdcoefct.c smoothing_ok: libjpeg smooths a progressive file's blocks when
 * every component's DC and first nine AC quantizers are nonzero and its DC
 * is known, and some component leaves one of AC 1-9 unfinished */
static int smoothing_ok(const dec_t *d) {
    static const int qpos[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
    int useful = 0;
    for (int i = 0; i < d->ncomp; i++) {
        const comp_t *c = &d->comp[i];
        for (int k = 0; k < 10; k++)
            if (c->q[qpos[k]] == 0) return 0;
        if (c->coef_bits[0] < 0) return 0;
        for (int k = 1; k < SMOOTH_COEFS; k++) useful |= c->coef_bits[k] != 0;
    }
    return useful;
}

/* an estimate of coefficient pos from num (K.8): num / (256 Q) rounded, no
 * larger than the bits its last scan left (2^Al - 1); only where the
 * coefficient is still zero and not known exactly */
#define ESTIMATE(al, pos, q, expr)                                    \
    do {                                                              \
        int al_ = (al);                                               \
        if (al_ != 0 && ws[pos] == 0) {                               \
            int64_t num = q00 * (expr), qq = (q);                     \
            int pred = (int)(((qq << 7) + (num < 0 ? -num : num)) / (qq << 8)); \
            if (al_ > 0 && pred >= (1 << al_)) pred = (1 << al_) - 1; \
            ws[pos] = (int16_t)(num < 0 ? -pred : pred);              \
        }                                                             \
    } while (0)

/* jdcoefct.c decompress_smooth_data (libjpeg-turbo 2.1 and later): each
 * block IDCT'd from a copy whose unfinished coefficients AC01, AC10, AC20,
 * AC11, AC02 (and, while no AC scan has come, AC03, AC12, AC21, AC30 and
 * the DC) are estimated from the DCs of its 5x5 neighbourhood; the window
 * repeats the edge blocks, and its rows follow libjpeg's count of them by
 * iMCU rows (a short last iMCU row shortens every row's count) */
static void smooth_component(dec_t *d, comp_t *c) {
    int v = c->sv, vmax = d->ncomp == 1 ? c->sv : d->vmax;
    int imcu_rows = (d->height + 8 * vmax - 1) / (8 * vmax);
    int hib = (c->dh + 7) / 8, wib = (c->dw + 7) / 8, last = wib - 1;
    const int *cb = c->coef_bits;
    int change_dc = 1;
    for (int k = 1; k < SMOOTH_COEFS; k++) change_dc &= cb[k] == -1;
    int64_t q00 = c->q[0];
    int16_t ws[64];
    for (int ir = 0; ir < imcu_rows; ir++) {
        int block_rows = ir < imcu_rows - 1 ? v : (hib % v ? hib % v : v);
        int image_rows = block_rows * imcu_rows;
        for (int br = 0; br < block_rows; br++) {
            int ibr = ir * block_rows + br, row = ir * v + br;
            const int16_t *cur = block_at(c, 0, row);
            const int16_t *prev = ibr > 0 ? block_at(c, 0, row - 1) : cur;
            const int16_t *pprev = ibr > 1 ? block_at(c, 0, row - 2) : prev;
            const int16_t *next = ibr < image_rows - 1 ? block_at(c, 0, row + 1) : cur;
            const int16_t *nnext = ibr < image_rows - 2 ? block_at(c, 0, row + 2) : next;
            int DC01, DC02, DC03, DC04, DC05, DC06, DC07, DC08, DC09, DC10, DC11, DC12, DC13, DC14, DC15,
                DC16, DC17, DC18, DC19, DC20, DC21, DC22, DC23, DC24, DC25;
            DC01 = DC02 = DC03 = DC04 = DC05 = pprev[0];
            DC06 = DC07 = DC08 = DC09 = DC10 = prev[0];
            DC11 = DC12 = DC13 = DC14 = DC15 = cur[0];
            DC16 = DC17 = DC18 = DC19 = DC20 = next[0];
            DC21 = DC22 = DC23 = DC24 = DC25 = nnext[0];
            for (int bn = 0; bn <= last; bn++) {
                memcpy(ws, cur + 64 * (size_t)bn, sizeof(ws));
                if (bn == 0 && bn < last) {
                    DC04 = DC05 = pprev[64];
                    DC09 = DC10 = prev[64];
                    DC14 = DC15 = cur[64];
                    DC19 = DC20 = next[64];
                    DC24 = DC25 = nnext[64];
                }
                if (bn + 1 < last) {
                    size_t o = 64 * (size_t)(bn + 2);
                    DC05 = pprev[o];
                    DC10 = prev[o];
                    DC15 = cur[o];
                    DC20 = next[o];
                    DC25 = nnext[o];
                }
                ESTIMATE(cb[1], 1, c->q[1],
                         change_dc ? (-DC01 - DC02 + DC04 + DC05 - 3 * DC06 + 13 * DC07 - 13 * DC09 +
                                      3 * DC10 - 3 * DC11 + 38 * DC12 - 38 * DC14 + 3 * DC15 - 3 * DC16 +
                                      13 * DC17 - 13 * DC19 + 3 * DC20 - DC21 - DC22 + DC24 + DC25)
                                   : (-7 * DC11 + 50 * DC12 - 50 * DC14 + 7 * DC15));
                ESTIMATE(cb[2], 8, c->q[8],
                         change_dc ? (-DC01 - 3 * DC02 - 3 * DC03 - 3 * DC04 - DC05 - DC06 + 13 * DC07 +
                                      38 * DC08 + 13 * DC09 - DC10 + DC16 - 13 * DC17 - 38 * DC18 -
                                      13 * DC19 + DC20 + DC21 + 3 * DC22 + 3 * DC23 + 3 * DC24 + DC25)
                                   : (-7 * DC03 + 50 * DC08 - 50 * DC18 + 7 * DC23));
                ESTIMATE(cb[3], 16, c->q[16],
                         change_dc ? (DC03 + 2 * DC07 + 7 * DC08 + 2 * DC09 - 5 * DC12 - 14 * DC13 -
                                      5 * DC14 + 2 * DC17 + 7 * DC18 + 2 * DC19 + DC23)
                                   : (-DC03 + 13 * DC08 - 24 * DC13 + 13 * DC18 - DC23));
                ESTIMATE(cb[4], 9, c->q[9],
                         change_dc ? (-DC01 + DC05 + 9 * DC07 - 9 * DC09 - 9 * DC17 + 9 * DC19 + DC21 - DC25)
                                   : (DC10 + DC16 - 10 * DC17 + 10 * DC19 - DC02 - DC20 + DC22 - DC24 +
                                      DC04 - DC06 + 10 * DC07 - 10 * DC09));
                ESTIMATE(cb[5], 2, c->q[2],
                         change_dc ? (2 * DC07 - 5 * DC08 + 2 * DC09 + DC11 + 7 * DC12 - 14 * DC13 +
                                      7 * DC14 + DC15 + 2 * DC17 - 5 * DC18 + 2 * DC19)
                                   : (-DC11 + 13 * DC12 - 24 * DC13 + 13 * DC14 - DC15));
                if (change_dc) {
                    ESTIMATE(cb[6], 3, c->q[3], (DC07 - DC09 + 2 * DC12 - 2 * DC14 + DC17 - DC19));
                    ESTIMATE(cb[7], 10, c->q[10], (DC07 - 3 * DC08 + DC09 - DC17 + 3 * DC18 - DC19));
                    ESTIMATE(cb[8], 17, c->q[17], (DC07 - DC09 - 3 * DC12 + 3 * DC14 + DC17 - DC19));
                    ESTIMATE(cb[9], 24, c->q[24], (DC07 + 2 * DC08 + DC09 - DC17 - 2 * DC18 - DC19));
                    int64_t num = q00 * (-2 * DC01 - 6 * DC02 - 8 * DC03 - 6 * DC04 - 2 * DC05 - 6 * DC06 +
                                         6 * DC07 + 42 * DC08 + 6 * DC09 - 6 * DC10 - 8 * DC11 + 42 * DC12 +
                                         152 * DC13 + 42 * DC14 - 8 * DC15 - 6 * DC16 + 6 * DC17 + 42 * DC18 +
                                         6 * DC19 - 6 * DC20 - 2 * DC21 - 6 * DC22 - 8 * DC23 - 6 * DC24 -
                                         2 * DC25);
                    int pred = (int)(((q00 << 7) + (num < 0 ? -num : num)) / (q00 << 8));
                    ws[0] = (int16_t)(num < 0 ? -pred : pred);
                }
                idct_islow(ws, c->q, d->idct_limit, c->plane + (size_t)row * 8 * c->stride + (size_t)bn * 8,
                           c->stride);
                DC01 = DC02; DC02 = DC03; DC03 = DC04; DC04 = DC05;
                DC06 = DC07; DC07 = DC08; DC08 = DC09; DC09 = DC10;
                DC11 = DC12; DC12 = DC13; DC13 = DC14; DC14 = DC15;
                DC16 = DC17; DC17 = DC18; DC18 = DC19; DC19 = DC20;
                DC21 = DC22; DC22 = DC23; DC23 = DC24; DC24 = DC25;
            }
        }
    }
}
#undef ESTIMATE

/* after the EOI of a progressive file: every block transformed into the
 * planes, smoothed where libjpeg smooths */
static void idct_planes(dec_t *d) {
    int smooth = smoothing_ok(d);
    for (int i = 0; i < d->ncomp; i++) {
        comp_t *c = &d->comp[i];
        if (smooth) {
            smooth_component(d, c);
            continue;
        }
        for (int by = 0; by < (c->dh + 7) / 8; by++)
            for (int bx = 0; bx < (c->dw + 7) / 8; bx++)
                idct_islow(block_at(c, bx, by), c->q, d->idct_limit,
                           c->plane + (size_t)by * 8 * c->stride + (size_t)bx * 8, c->stride);
    }
}

/* ------------------------------------------------------------ upsampling */

static inline const uint8_t *plane_row(const comp_t *c, int r) {
    if (r < 0) r = 0;
    if (r > c->dh - 1) r = c->dh - 1;
    return c->plane + (size_t)r * c->stride;
}

/* the component's samples for output row y, upsampled to (at least) the
 * output width; tmp has room for (hmax / h) * stride bytes */
static const uint8_t *comp_row(const dec_t *d, const comp_t *c, int y, uint8_t *tmp) {
    int rh = d->hmax / c->h, rv = d->vmax / c->v, dw = c->dw;
    if (rh == 1 && rv == 1) return plane_row(c, y);
    if (rh > 2 || rv > 2 || d->lossless) {
        /* int_upsample: each sample rh x rv times (jdsample.c upsamples a
         * lossless file's components so, at any ratio) */
        const uint8_t *in = plane_row(c, y / rv);
        for (int x = 0; x < dw; x++) memset(tmp + (size_t)x * rh, in[x], (size_t)rh);
        return tmp;
    }
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

static size_t tmp_room(const dec_t *d) {
    size_t room = 0;
    for (int i = 0; i < d->ncomp; i++) {
        const comp_t *c = &d->comp[i];
        size_t need = (size_t)(d->hmax / c->h > 2 ? d->hmax / c->h : 2) * c->stride;
        if (need > room) room = need;
    }
    return room;
}

/* a four-component file's row y as libjpeg's CMYK output: jdcolor.c
 * ycck_cmyk_convert where an Adobe marker's transform is not 0, else the
 * samples as they are */
static void cmyk_row(dec_t *d, int y, uint8_t *o) {
    size_t w = (size_t)d->width, room = tmp_room(d);
    int ycck = d->saw_adobe && d->adobe_transform != 0;
    const uint8_t *c[4];
    for (int i = 0; i < 4; i++) c[i] = comp_row(d, &d->comp[i], y, d->rows + (size_t)i * room);
    for (size_t x = 0; x < w; x++) {
        if (ycck) {
            int yy = c[0][x], cb = c[1][x], cr = c[2][x];
            o[4 * x] = clamp255(255 - (yy + d->cr_r[cr]));
            o[4 * x + 1] = clamp255(255 - (yy + ((d->cb_g[cb] + d->cr_g[cr]) >> SCALEBITS)));
            o[4 * x + 2] = clamp255(255 - (yy + d->cb_b[cb]));
        } else {
            for (int i = 0; i < 3; i++) o[4 * x + i] = c[i][x];
        }
        o[4 * x + 3] = c[3][x];
    }
}

/* OpenCV's IMREAD_ANYDEPTH decode (grfmt_jpeg.cpp): libjpeg's gray output
 * (jdcolor.c grayscale_convert, the Y plane of YCbCr; rgb_gray_convert,
 * (19595 R + 38470 G + 7471 B + 2^15) >> 16, of RGB), and a four-component
 * file's CMYK through icvCvt_CMYK2Gray_8u_C4C1R (each of C, M, Y as
 * k - (255 - x) k / 256, then 4899 C + 9617 M + 1868 Y, 14 bits, rounded) */
static void emit_gray(dec_t *d, uint8_t *out) {
    size_t w = (size_t)d->width, room = tmp_room(d);
    for (int y = 0; y < d->height; y++) {
        uint8_t *o = out + (size_t)y * w;
        if (d->ncomp == 4) {
            uint8_t *cmyk = d->rows + 4 * room;
            cmyk_row(d, y, cmyk);
            for (size_t x = 0; x < w; x++) {
                int k = cmyk[4 * x + 3];
                int c = k - (((255 - cmyk[4 * x]) * k) >> 8);
                int m = k - (((255 - cmyk[4 * x + 1]) * k) >> 8);
                int yy = k - (((255 - cmyk[4 * x + 2]) * k) >> 8);
                o[x] = (uint8_t)((yy * 1868 + m * 9617 + c * 4899 + (1 << 13)) >> 14);
            }
        } else if (d->ncomp == 1 || is_ycc(d)) {
            memcpy(o, comp_row(d, &d->comp[0], y, d->rows), w);
        } else {
            const uint8_t *r = comp_row(d, &d->comp[0], y, d->rows);
            const uint8_t *g = comp_row(d, &d->comp[1], y, d->rows + room);
            const uint8_t *b = comp_row(d, &d->comp[2], y, d->rows + 2 * room);
            for (size_t x = 0; x < w; x++)
                o[x] = (uint8_t)((19595 * r[x] + 38470 * g[x] + 7471 * b[x] + 32768) >> 16);
        }
    }
}

static void emit(dec_t *d, uint8_t *out) {
    size_t w = (size_t)d->width;
    if (d->mode == 1) {
        emit_gray(d, out);
        return;
    }
    if (d->ncomp == 1) {
        for (int y = 0; y < d->height; y++) memcpy(out + (size_t)y * w, plane_row(&d->comp[0], y), w);
        return;
    }
    if (d->ncomp == 4) { /* PIL's "CMYK;I": every sample inverted */
        for (int y = 0; y < d->height; y++) {
            uint8_t *o = out + (size_t)y * w * 4;
            cmyk_row(d, y, o);
            for (size_t x = 0; x < 4 * w; x++) o[x] = (uint8_t)~o[x];
        }
        return;
    }
    int ycc = is_ycc(d);
    size_t room = tmp_room(d);
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
    int unit = d->lossless ? 1 : 8; /* a lossless file's "blocks" are its samples */
    int mcux = (d->width + unit * d->hmax - 1) / (unit * d->hmax);
    int mcuy = (d->height + unit * d->vmax - 1) / (unit * d->vmax);
    for (int i = 0; i < d->ncomp; i++) {
        comp_t *c = &d->comp[i];
        c->sv = c->v;
        if (d->ncomp == 1) c->h = c->v = d->hmax = d->vmax = 1; /* a lone component is never subsampled */
        c->dw = (int)(((int64_t)d->width * c->h + d->hmax - 1) / d->hmax);
        c->dh = (int)(((int64_t)d->height * c->v + d->vmax - 1) / d->vmax);
        c->bw = d->ncomp == 1 ? (c->dw + unit - 1) / unit : mcux * c->h;
        c->bh = d->ncomp == 1 ? (c->dh + unit - 1) / unit : mcuy * c->v;
        if (d->ncomp == 1 && d->progressive) /* libjpeg's coefficient rows: whole iMCU rows */
            c->bh = (c->bh + c->sv - 1) / c->sv * c->sv;
        c->stride = (size_t)c->bw * (size_t)unit;
        c->plane = malloc(c->stride * (size_t)c->bh * (size_t)unit);
        if (!c->plane) fail(d, JD_NOMEM, "out of memory for a %dx%d JPEG", d->width, d->height);
        if (d->progressive) { /* libjpeg zeroes a progressive file's coefficients */
            c->coef = calloc((size_t)c->bw * (size_t)c->bh * 64, sizeof(int16_t));
            if (!c->coef) fail(d, JD_NOMEM, "out of memory for a %dx%d JPEG", d->width, d->height);
        }
        if (d->lossless) {
            c->diff = calloc((size_t)c->bw * (size_t)c->bh, sizeof(int32_t));
            if (!c->diff) fail(d, JD_NOMEM, "out of memory for a %dx%d JPEG", d->width, d->height);
        }
        for (int k = 0; k < SMOOTH_COEFS; k++) c->coef_bits[k] = -1;
    }
    d->rows = malloc((size_t)d->ncomp * tmp_room(d) + 4 * (size_t)d->width);
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
            int bands = d->mode == 1 ? 1 : d->ncomp;
            if (out_len != (int64_t)d->height * d->width * bands)
                fail(d, JD_CORRUPT, "output buffer of %lld bytes for a %dx%dx%d image",
                     (long long)out_len, d->height, d->width, bands);
            alloc_planes(d);
        } else if (m == 0xC4) {
            read_dht(d);
        } else if (m == 0xCC) {
            read_dac(d);
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
            if (d->progressive) idct_planes(d);
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

static dec_t *new_dec(const uint8_t *data, int64_t len, int mode, char *msg, int64_t msg_len) {
    dec_t *d = calloc(1, sizeof(dec_t));
    if (!d) return NULL;
    d->data = data;
    d->len = len > 0 ? (size_t)len : 0;
    d->mode = mode;
    d->msg = msg;
    d->msg_len = msg_len > 0 ? (size_t)msg_len : 0;
    if (d->msg_len) msg[0] = 0;
    for (int i = 0; i < 16; i++) { /* jdmarker.c: the conditioning no DAC has set */
        d->dac_u[i] = 1;
        d->dac_k[i] = 5;
    }
    d->fixed_bin[0] = 113;
    return d;
}

static void free_dec(dec_t *d) {
    for (int i = 0; i < MAX_COMPS; i++) {
        free(d->comp[i].plane);
        free(d->comp[i].coef);
        free(d->comp[i].diff);
    }
    free(d->rows);
    free(d);
}

/* mode 0: PIL's array; 1: OpenCV's IMREAD_ANYDEPTH gray.  dims: height,
 * width, bands of that array (1, 3 or 4) */
int jpeg_info(const uint8_t *data, int64_t len, int32_t *dims, int32_t mode, char *msg, int64_t msg_len) {
    dec_t *d = new_dec(data, len, mode, msg, msg_len);
    if (!d) return JD_NOMEM;
    int rc = setjmp(d->jb);
    if (rc == 0) {
        if (mode != 0 && mode != 1) fail(d, JD_CORRUPT, "output mode %d is not 0 or 1", mode);
        parse(d, NULL, 0);
        dims[0] = d->height;
        dims[1] = d->width;
        dims[2] = mode == 1 ? 1 : d->ncomp;
    }
    free_dec(d);
    return rc;
}

/* out: height x width x bands bytes (out_len of them) */
int jpeg_decode(const uint8_t *data, int64_t len, uint8_t *out, int64_t out_len, int32_t mode, char *msg,
                int64_t msg_len) {
    dec_t *d = new_dec(data, len, mode, msg, msg_len);
    if (!d) return JD_NOMEM;
    build_idct_limit(d->idct_limit);
    build_ycc_tables(d);
    int rc = setjmp(d->jb);
    if (rc == 0) {
        if (!out) fail(d, JD_CORRUPT, "no output buffer");
        if (mode != 0 && mode != 1) fail(d, JD_CORRUPT, "output mode %d is not 0 or 1", mode);
        parse(d, out, out_len);
    }
    free_dec(d);
    return rc;
}
