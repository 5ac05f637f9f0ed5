/* A baseline / extended sequential Huffman JPEG decoder whose pixels equal
 * libjpeg-turbo's default decompression to BGR (what cv2.imread returns): host
 * code of the port's image reader (sar_yolo_tpu_torch/data/imageio.py), built
 * with the system C compiler at first use and loaded with ctypes.
 *
 * Every step is integer arithmetic, computed as libjpeg-turbo computes it:
 *   - Huffman decoding with libjpeg's handling of restart markers and of data
 *     that ends early (the rest of the segment decodes from zero bits, then
 *     stays zero: uniform grey);
 *   - the islow IDCT of jidctint.c, with its descaling and range-limit table;
 *   - the upsampling of jdsample.c: "fancy" triangular filters for h2v1, h2v2
 *     (chroma wider than 2 samples) and h1v2, with the edge columns and rows
 *     replicated; plain replication for every other integral factor;
 *   - the fixed-point YCbCr -> RGB of jdcolor.c (SCALEBITS 16); grey is
 *     replicated to three channels, and RGB (Adobe transform 0, or component
 *     ids 'R', 'G', 'B') is copied.
 * Progressive, arithmetic-coded, lossless and 12-bit files and four-component
 * images are refused with a code of their own; what libjpeg cannot decode either
 * (hierarchical frames, unknown markers) is corrupt.
 *
 * mjpeg_decode gives a Motion-JPEG video frame's pixels as cv2.VideoCapture gives
 * them through FFmpeg (avcodec 62.28, swscale 9.5, as OpenCV 5.0's wheel bundles
 * them), which are not libjpeg's. Each step below was confirmed against
 * VideoCapture: its Y plane (CAP_PROP_CONVERT_RGB off) and its BGR frame, on sizes
 * from 2x2 to 720x1280 (odd ones included) at qualities 10 to 100:
 *   - the Huffman decoding, tables and restarts are the ones above;
 *   - mjpegdec.c dequantizes into int16 with the DC predictor starting at
 *     4 << 8 = 1024 (the level shift), the DC clipped to int16;
 *   - ff_simple_idct_int16_8bit (simple_idct_template.c: W1..W7 = 22725, 21407,
 *     19266, 16383, 12873, 8867, 4520, row shift 11 with the DC-only shortcut row[0]
 *     << 3, column shift 20) into 4:2:0 planes; the x86 SIMD IDCT FFmpeg picks
 *     gives the same Y plane as its C path;
 *   - swscale's yuvj420p -> bgr24 is its SIMD yuv2rgb (the C path differs by up to
 *     2 levels): per pixel Y' = Y * 8 * 8192 >> 16 = Y, U' = U * 8 - 1024, V' the
 *     same, B = Y' + (U' * 14516 >> 16), G = Y' + (U' * -2819 >> 16) + (V' * -5850
 *     >> 16), R = Y' + (V' * 11485 >> 16), 16-bit saturating adds, then clipped to
 *     0..255; the coefficients are ff_yuv2rgb_c_init_tables' for BT.601 at full range
 *     (crv 104597 * 224 / 255, ...) in units of 2^-13; chroma is replicated over each
 *     2x2 block (no fancy upsampling).
 * Only three-component 4:2:0 frames of at least 2x2 pixels are taken (JPEG_LAYOUT
 * otherwise): OpenCV's FFmpeg writer makes no other, and frames of one row (and some
 * of one column) decode otherwise in FFmpeg.
 */
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

enum {
    JPEG_OK = 0,
    JPEG_CORRUPT = -1,
    JPEG_PROGRESSIVE = 1,
    JPEG_ARITHMETIC = 2,
    JPEG_PRECISION = 3,
    JPEG_LOSSLESS = 4,
    JPEG_COMPONENTS = 5,
    JPEG_NO_MEMORY = 7,
};

#define MAX_COMPONENTS 4 /* more are refused (JPEG_COMPONENTS) before they are stored */

typedef struct {
    uint8_t bits[17];     /* codes of each length 1..16 */
    uint8_t vals[256];
    int defined;
    int32_t maxcode[18];  /* largest code of each length; -1 where none */
    int32_t valoffset[18];
    uint16_t look[512];   /* 9-bit lookahead: (length << 8) | symbol, 0 where longer */
} huff_t;

typedef struct {
    int id, h, v, tq;
    int dw, dh;          /* downsampled size in samples */
    int bw, bh;          /* allocated blocks (the interleaved MCU grid) */
    int16_t *coef;       /* bh x bw blocks of 64 coefficients, natural order */
    int16_t q[64];       /* quantisation table latched at its first scan (libjpeg's 16-bit MULTIPLIER) */
    int latched;
    uint8_t *plane;      /* IDCT output, (8 * ceil(dh / 8)) x (8 * ceil(dw / 8)) */
    int pstride;
} comp_t;

typedef struct {
    const uint8_t *p, *end;  /* entropy-coded bytes */
    uint64_t buf;            /* left-aligned bits */
    int bits;                /* real bits in buf */
    int marker;              /* marker code that ended the data (0xD9 at the end of the file), 0 before */
    int insufficient;        /* a bit past the data was consumed in this segment */
} bitreader_t;

typedef struct {
    const uint8_t *data, *end;
    int width, height, ncomp, precision;
    int maxh, maxv;
    int restart_interval;
    int saw_jfif, saw_adobe, adobe_transform;
    uint16_t qt[4][64];
    int qt_defined[4];
    huff_t dc[4], ac[4];
    comp_t comp[MAX_COMPONENTS];
    int have_sof;
    uint8_t limit[1024];  /* the post-IDCT range-limit table */
} decoder_t;

static const int natural_order[64 + 16] = {
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, /* corrupt runs past 63 */
};

/* ------------------------------------------------------------------ markers */

static int u16(const uint8_t *p) { return (p[0] << 8) | p[1]; }

/* jdmarker.c next_marker: skip to 0xFF, swallow fill bytes and stuffed FF/00
 * pairs; returns the marker code and leaves *pos after it, or -1 at the end. */
static int next_marker(const uint8_t **pos, const uint8_t *end) {
    const uint8_t *p = *pos;
    for (;;) {
        while (p < end && *p != 0xFF) p++;
        if (p >= end) return -1;
        while (p < end && *p == 0xFF) p++;
        if (p >= end) return -1;
        if (*p != 0) {
            *pos = p + 1;
            return *p;
        }
        p++; /* FF/00: data, discarded */
    }
}

static int build_huff(huff_t *t, int is_dc) {
    int huffsize[257], huffcode[257];
    int p = 0, count = 0;
    for (int l = 1; l <= 16; l++) count += t->bits[l];
    if (count > 256) return JPEG_CORRUPT;
    for (int l = 1; l <= 16; l++)
        for (int i = 0; i < t->bits[l]; i++) huffsize[p++] = l;
    huffsize[p] = 0;
    int code = 0, si = huffsize[0];
    p = 0;
    while (huffsize[p]) {
        while (huffsize[p] == si) {
            huffcode[p++] = code;
            code++;
        }
        if (code >= (1 << si)) return JPEG_CORRUPT; /* jdhuff.c: bad Huffman table */
        code <<= 1;
        si++;
    }
    p = 0;
    for (int l = 1; l <= 16; l++) {
        if (t->bits[l]) {
            t->valoffset[l] = p - huffcode[p];
            p += t->bits[l];
            t->maxcode[l] = huffcode[p - 1];
        } else {
            t->maxcode[l] = -1;
        }
    }
    t->valoffset[17] = 0;
    t->maxcode[17] = 0xFFFFF; /* sentinel: a bad code stops at 17 bits */
    memset(t->look, 0, sizeof(t->look));
    p = 0;
    for (int l = 1; l <= 9; l++) {
        for (int i = 0; i < t->bits[l]; i++, p++) {
            int prefix = huffcode[p] << (9 - l);
            for (int j = 0; j < (1 << (9 - l)); j++)
                t->look[prefix + j] = (uint16_t)((l << 8) | t->vals[p]);
        }
    }
    if (is_dc)
        for (int i = 0; i < count; i++)
            if (t->vals[i] > 15) return JPEG_CORRUPT;
    t->defined = 1;
    return JPEG_OK;
}

/* jstdhuff.c: the tables of the standard's Annex K.3, which libjpeg-turbo uses for
 * table 0 or 1 when a scan needs a table no DHT defined (Motion-JPEG frames). */
static const uint8_t bits_dc_luminance[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
static const uint8_t val_dc_luminance[12] = {
    0x00, 0x01, 0x02, 0x03, 0x04, 0x05, 0x06, 0x07, 0x08, 0x09, 0x0a, 0x0b,
};
static const uint8_t bits_dc_chrominance[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
static const uint8_t val_dc_chrominance[12] = {
    0x00, 0x01, 0x02, 0x03, 0x04, 0x05, 0x06, 0x07, 0x08, 0x09, 0x0a, 0x0b,
};
static const uint8_t bits_ac_luminance[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 125};
static const uint8_t val_ac_luminance[162] = {
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
static const uint8_t bits_ac_chrominance[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 119};
static const uint8_t val_ac_chrominance[162] = {
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

static int std_table(huff_t *t, int is_dc, int index) {
    const uint8_t *bits, *vals;
    if (index == 0) {
        bits = is_dc ? bits_dc_luminance : bits_ac_luminance;
        vals = is_dc ? val_dc_luminance : val_ac_luminance;
    } else if (index == 1) {
        bits = is_dc ? bits_dc_chrominance : bits_ac_chrominance;
        vals = is_dc ? val_dc_chrominance : val_ac_chrominance;
    } else {
        return JPEG_CORRUPT;
    }
    int count = 0;
    for (int l = 1; l <= 16; l++) count += t->bits[l] = bits[l];
    memcpy(t->vals, vals, (size_t)count);
    return build_huff(t, is_dc);
}

static int read_sof(decoder_t *d, const uint8_t *s, int len, int marker) {
    if (d->have_sof) return JPEG_CORRUPT;
    if (marker == 0xC2 || marker == 0xCA) return JPEG_PROGRESSIVE;
    if (marker == 0xC9) return JPEG_ARITHMETIC;
    if (marker == 0xC3 || marker == 0xCB) return JPEG_LOSSLESS;
    if (marker != 0xC0 && marker != 0xC1) return JPEG_CORRUPT; /* libjpeg has no decoder */
    if (len < 6) return JPEG_CORRUPT;
    d->precision = s[0];
    d->height = u16(s + 1);
    d->width = u16(s + 3);
    d->ncomp = s[5];
    if (d->height <= 0 || d->width <= 0 || d->ncomp <= 0) return JPEG_CORRUPT;
    if (len != 6 + 3 * d->ncomp) return JPEG_CORRUPT;
    if (d->precision != 8) return JPEG_PRECISION;
    if (d->ncomp == 4) return JPEG_COMPONENTS;
    if (d->ncomp > MAX_COMPONENTS || d->ncomp == 2) return JPEG_CORRUPT; /* no BGR conversion */
    d->maxh = d->maxv = 1;
    for (int i = 0; i < d->ncomp; i++) {
        comp_t *c = &d->comp[i];
        memset(c, 0, sizeof(*c));
        c->id = s[6 + 3 * i];
        c->h = s[7 + 3 * i] >> 4;
        c->v = s[7 + 3 * i] & 15;
        c->tq = s[8 + 3 * i];
        if (c->h < 1 || c->h > 4 || c->v < 1 || c->v > 4 || c->tq > 3) return JPEG_CORRUPT;
        if (c->h > d->maxh) d->maxh = c->h;
        if (c->v > d->maxv) d->maxv = c->v;
    }
    int mcux = (d->width + 8 * d->maxh - 1) / (8 * d->maxh);
    int mcuy = (d->height + 8 * d->maxv - 1) / (8 * d->maxv);
    for (int i = 0; i < d->ncomp; i++) {
        comp_t *c = &d->comp[i];
        /* the same component twice, and sampling ratios libjpeg cannot upsample */
        for (int j = 0; j < i; j++)
            if (d->comp[j].id == c->id) return JPEG_CORRUPT;
        if (d->maxh % c->h || d->maxv % c->v) return JPEG_CORRUPT;
        c->dw = (int)(((long)d->width * c->h + d->maxh - 1) / d->maxh);
        c->dh = (int)(((long)d->height * c->v + d->maxv - 1) / d->maxv);
        c->bw = mcux * c->h;
        c->bh = mcuy * c->v;
    }
    d->have_sof = 1;
    return JPEG_OK;
}

static int read_dqt(decoder_t *d, const uint8_t *s, int len) {
    while (len > 0) {
        int pq = s[0] >> 4, tq = s[0] & 15;
        int n = pq ? 128 : 64;
        if (tq > 3 || len < 1 + n) return JPEG_CORRUPT;
        for (int i = 0; i < 64; i++)
            d->qt[tq][natural_order[i]] = (uint16_t)(pq ? u16(s + 1 + 2 * i) : s[1 + i]);
        d->qt_defined[tq] = 1;
        s += 1 + n;
        len -= 1 + n;
    }
    return JPEG_OK;
}

static int read_dht(decoder_t *d, const uint8_t *s, int len) {
    while (len > 16) {
        int index = s[0];
        int is_ac = index & 0x10;
        index &= ~0x10;
        if (index > 3) return JPEG_CORRUPT;
        huff_t *t = is_ac ? &d->ac[index] : &d->dc[index];
        int count = 0;
        t->bits[0] = 0;
        for (int l = 1; l <= 16; l++) {
            t->bits[l] = s[l];
            count += s[l];
        }
        if (count > 256 || len < 17 + count) return JPEG_CORRUPT;
        memset(t->vals, 0, sizeof(t->vals));
        memcpy(t->vals, s + 17, (size_t)count);
        int r = build_huff(t, !is_ac);
        if (r != JPEG_OK) return r;
        s += 17 + count;
        len -= 17 + count;
    }
    return len == 0 ? JPEG_OK : JPEG_CORRUPT;
}

/* -------------------------------------------------------------- bit reader */

static void fill(bitreader_t *br) {
    while (br->bits <= 56 && !br->marker) {
        if (br->p >= br->end) {
            br->marker = 0xD9; /* libjpeg's source manager inserts a fake EOI at the end */
            return;
        }
        int c = *br->p;
        if (c == 0xFF) {
            const uint8_t *q = br->p + 1;
            while (q < br->end && *q == 0xFF) q++;
            if (q >= br->end) {
                br->marker = 0xD9;
                return;
            }
            if (*q != 0) {
                br->marker = *q; /* left unread: br->p stays on its first FF */
                return;
            }
            br->p = q + 1; /* FF (FF...) 00: one FF data byte */
        } else {
            br->p++;
        }
        br->buf |= (uint64_t)c << (56 - br->bits);
        br->bits += 8;
    }
}

/* Drops n bits; past the data they are zeros, and the segment is marked short. */
static void drop(bitreader_t *br, int n) {
    if (n > br->bits) {
        br->insufficient = 1;
        br->bits = 0;
    } else {
        br->bits -= n;
    }
    br->buf <<= n;
}

static int get_bits(bitreader_t *br, int n) {
    if (br->bits < n) fill(br);
    int v = (int)(br->buf >> (64 - n));
    drop(br, n);
    return v;
}

static int huff_decode(bitreader_t *br, const huff_t *t) {
    if (br->bits < 17) fill(br);
    int look = t->look[br->buf >> 55];
    if (look) {
        drop(br, look >> 8);
        return look & 0xFF;
    }
    int l = 10;
    int32_t code = (int32_t)(br->buf >> 54);
    while (code > t->maxcode[l]) {
        l++;
        code = (int32_t)(br->buf >> (64 - l));
    }
    drop(br, l);
    if (l > 16) return 0; /* jdhuff.c: a bad code decodes as 0 */
    return t->vals[(code + t->valoffset[l]) & 0xFF];
}

static int extend(int r, int s) { return r < (1 << (s - 1)) ? r + (int)((~0u << s) + 1) : r; }

/* Like next_marker, from *pos; leaves *pos on the marker's first FF and *after
 * past its code. -1 at the end of the data. */
static int find_marker(const uint8_t **pos, const uint8_t *end, const uint8_t **after) {
    const uint8_t *p = *pos;
    for (;;) {
        while (p < end && *p != 0xFF) p++;
        const uint8_t *ff = p;
        while (p < end && *p == 0xFF) p++;
        if (p >= end) return -1;
        if (*p != 0) {
            *pos = ff;
            *after = p + 1;
            return *p;
        }
        p++;
    }
}

/* jdhuff.c process_restart: jdmarker.c read_restart_marker and
 * jpeg_resync_to_restart on the marker after the interval's data. */
static void restart(bitreader_t *br, int *next_rst) {
    const uint8_t *ff = br->p, *after = br->end;
    br->buf = 0;
    br->bits = 0;
    int m = find_marker(&ff, br->end, &after);
    if (m < 0) {
        m = 0xD9;
        ff = after = br->end;
    }
    int desired = *next_rst;
    for (;;) {
        int action;
        if (m < 0xC0) action = 2;
        else if (m < 0xD0 || m > 0xD7) action = 3;
        else if (m == 0xD0 + ((desired + 1) & 7) || m == 0xD0 + ((desired + 2) & 7)) action = 3;
        else if (m == 0xD0 + ((desired - 1) & 7) || m == 0xD0 + ((desired - 2) & 7)) action = 2;
        else action = 1;
        if (action == 1) { /* swallow it: decoding resumes after it */
            br->marker = 0;
            br->p = after;
            br->insufficient = 0;
            break;
        }
        if (action == 3) { /* left unread: the interval decodes as empty */
            br->marker = m;
            br->p = ff;
            break;
        }
        ff = after;
        m = find_marker(&ff, br->end, &after);
        if (m < 0) {
            m = 0xD9;
            ff = after = br->end;
        }
    }
    *next_rst = (desired + 1) & 7;
}

/* --------------------------------------------------------------------- scan */

static int decode_block(bitreader_t *br, int16_t *blk, const huff_t *dc, const huff_t *ac, int *pred) {
    int s = huff_decode(br, dc);
    if (s) s = extend(get_bits(br, s), s);
    *pred += s;
    blk[0] = (int16_t)*pred;
    for (int k = 1; k < 64; k++) {
        int rs = huff_decode(br, ac);
        int r = rs >> 4;
        s = rs & 15;
        if (s) {
            k += r;
            blk[natural_order[k]] = (int16_t)extend(get_bits(br, s), s);
        } else {
            if (r != 15) break;
            k += 15;
        }
    }
    return 0;
}

/* One scan from s (just after the SOS segment); returns the position after its
 * entropy-coded data (on the next marker's first FF), or NULL on a bad header. */
static const uint8_t *decode_scan(decoder_t *d, const uint8_t *hdr, int len, const uint8_t *s, int *err) {
    int ns = len > 0 ? hdr[0] : 0;
    comp_t *sc[4];
    int dct[4], act[4], pred[4] = {0, 0, 0, 0};
    *err = JPEG_CORRUPT;
    if (ns < 1 || ns > 4 || len != 4 + 2 * ns || !d->have_sof) return NULL;
    for (int i = 0; i < d->ncomp; i++) {
        comp_t *c = &d->comp[i];
        if (!c->coef) c->coef = (int16_t *)calloc((size_t)c->bw * c->bh * 64, sizeof(int16_t));
        if (!c->coef) {
            *err = JPEG_NO_MEMORY;
            return NULL;
        }
    }
    for (int i = 0; i < ns; i++) {
        int id = hdr[1 + 2 * i], tables = hdr[2 + 2 * i];
        sc[i] = NULL;
        for (int j = 0; j < d->ncomp; j++)
            if (d->comp[j].id == id) sc[i] = &d->comp[j];
        if (!sc[i]) return NULL;
        for (int j = 0; j < i; j++)
            if (sc[j] == sc[i]) return NULL;
        dct[i] = tables >> 4;
        act[i] = tables & 15;
        if (dct[i] > 3 || act[i] > 3) return NULL;
        if (!d->dc[dct[i]].defined && std_table(&d->dc[dct[i]], 1, dct[i]) != JPEG_OK) return NULL;
        if (!d->ac[act[i]].defined && std_table(&d->ac[act[i]], 0, act[i]) != JPEG_OK) return NULL;
        if (!sc[i]->latched) {
            if (!d->qt_defined[sc[i]->tq]) return NULL;
            for (int k = 0; k < 64; k++) sc[i]->q[k] = (int16_t)d->qt[sc[i]->tq][k];
            sc[i]->latched = 1;
        }
    }
    int mcux, mcuy;
    if (ns == 1) {
        mcux = (sc[0]->dw + 7) / 8;
        mcuy = (sc[0]->dh + 7) / 8;
    } else {
        mcux = (d->width + 8 * d->maxh - 1) / (8 * d->maxh);
        mcuy = (d->height + 8 * d->maxv - 1) / (8 * d->maxv);
    }
    bitreader_t br = {s, d->end, 0, 0, 0, 0};
    int restarts_to_go = d->restart_interval, next_rst = 0;
    for (int my = 0; my < mcuy; my++) {
        for (int mx = 0; mx < mcux; mx++) {
            if (d->restart_interval) {
                if (restarts_to_go == 0) {
                    restart(&br, &next_rst);
                    for (int i = 0; i < ns; i++) pred[i] = 0;
                    restarts_to_go = d->restart_interval;
                }
            }
            if (!br.insufficient) {
                for (int i = 0; i < ns; i++) {
                    comp_t *c = sc[i];
                    int bh = ns == 1 ? 1 : c->v, bw = ns == 1 ? 1 : c->h;
                    for (int v = 0; v < bh; v++)
                        for (int h = 0; h < bw; h++) {
                            int by = my * bh + v, bx = mx * bw + h;
                            decode_block(&br, c->coef + ((size_t)by * c->bw + bx) * 64,
                                         &d->dc[dct[i]], &d->ac[act[i]], &pred[i]);
                        }
                }
            }
            if (d->restart_interval) restarts_to_go--;
        }
    }
    *err = JPEG_OK;
    return br.p; /* on the marker that ended the data, or before it */
}

/* --------------------------------------------------------------------- IDCT */

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

/* jdmaster.c prepare_range_limit_table, the post-IDCT part: index v & 1023 holds
 * v + 128 clamped to 0..255 for v in -512..511, and wraps beyond. */
static void init_limit(uint8_t *idct_limit) {
    for (int x = 0; x < 1024; x++) {
        int v;
        if (x < 128) v = x + 128;
        else if (x < 512) v = 255;
        else if (x < 896) v = 0;
        else v = x - 896;
        idct_limit[x] = (uint8_t)v;
    }
}

/* jidctint.c jpeg_idct_islow */
static void idct_islow(const int16_t *in, const int16_t *q, uint8_t *out, int stride,
                       const uint8_t *idct_limit) {
    int ws[64];
    for (int c = 0; c < 8; c++) {
        const int16_t *ip = in + c;
        const int16_t *qp = q + c;
        int *wp = ws + c;
        if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] && !ip[56]) {
            int dc = (int)((int64_t)ip[0] * qp[0] * (1 << PASS1_BITS));
            for (int r = 0; r < 8; r++) wp[8 * r] = dc;
            continue;
        }
        int64_t z1, z2, z3, z4, z5, t0, t1, t2, t3, t10, t11, t12, t13;
        z2 = (int64_t)ip[16] * qp[16];
        z3 = (int64_t)ip[48] * qp[48];
        z1 = (z2 + z3) * FIX_0_541196100;
        t2 = z1 + z3 * (-FIX_1_847759065);
        t3 = z1 + z2 * FIX_0_765366865;
        z2 = (int64_t)ip[0] * qp[0];
        z3 = (int64_t)ip[32] * qp[32];
        t0 = (z2 + z3) * ((int64_t)1 << CONST_BITS);
        t1 = (z2 - z3) * ((int64_t)1 << CONST_BITS);
        t10 = t0 + t3;
        t13 = t0 - t3;
        t11 = t1 + t2;
        t12 = t1 - t2;
        t0 = (int64_t)ip[56] * qp[56];
        t1 = (int64_t)ip[40] * qp[40];
        t2 = (int64_t)ip[24] * qp[24];
        t3 = (int64_t)ip[8] * qp[8];
        z1 = t0 + t3;
        z2 = t1 + t2;
        z3 = t0 + t2;
        z4 = t1 + t3;
        z5 = (z3 + z4) * FIX_1_175875602;
        t0 = t0 * FIX_0_298631336;
        t1 = t1 * FIX_2_053119869;
        t2 = t2 * FIX_3_072711026;
        t3 = t3 * FIX_1_501321110;
        z1 = z1 * (-FIX_0_899976223);
        z2 = z2 * (-FIX_2_562915447);
        z3 = z3 * (-FIX_1_961570560);
        z4 = z4 * (-FIX_0_390180644);
        z3 += z5;
        z4 += z5;
        t0 += z1 + z3;
        t1 += z2 + z4;
        t2 += z2 + z3;
        t3 += z1 + z4;
        wp[0] = (int)DESCALE(t10 + t3, CONST_BITS - PASS1_BITS);
        wp[56] = (int)DESCALE(t10 - t3, CONST_BITS - PASS1_BITS);
        wp[8] = (int)DESCALE(t11 + t2, CONST_BITS - PASS1_BITS);
        wp[48] = (int)DESCALE(t11 - t2, CONST_BITS - PASS1_BITS);
        wp[16] = (int)DESCALE(t12 + t1, CONST_BITS - PASS1_BITS);
        wp[40] = (int)DESCALE(t12 - t1, CONST_BITS - PASS1_BITS);
        wp[24] = (int)DESCALE(t13 + t0, CONST_BITS - PASS1_BITS);
        wp[32] = (int)DESCALE(t13 - t0, CONST_BITS - PASS1_BITS);
    }
    for (int r = 0; r < 8; r++) {
        const int *wp = ws + 8 * r;
        uint8_t *op = out + (size_t)r * stride;
        if (!wp[1] && !wp[2] && !wp[3] && !wp[4] && !wp[5] && !wp[6] && !wp[7]) {
            uint8_t v = idct_limit[(int)DESCALE((int64_t)wp[0], PASS1_BITS + 3) & 1023];
            memset(op, v, 8);
            continue;
        }
        int64_t z1, z2, z3, z4, z5, t0, t1, t2, t3, t10, t11, t12, t13;
        z2 = wp[2];
        z3 = wp[6];
        z1 = (z2 + z3) * FIX_0_541196100;
        t2 = z1 + z3 * (-FIX_1_847759065);
        t3 = z1 + z2 * FIX_0_765366865;
        t0 = ((int64_t)wp[0] + wp[4]) * ((int64_t)1 << CONST_BITS);
        t1 = ((int64_t)wp[0] - wp[4]) * ((int64_t)1 << CONST_BITS);
        t10 = t0 + t3;
        t13 = t0 - t3;
        t11 = t1 + t2;
        t12 = t1 - t2;
        t0 = wp[7];
        t1 = wp[5];
        t2 = wp[3];
        t3 = wp[1];
        z1 = t0 + t3;
        z2 = t1 + t2;
        z3 = t0 + t2;
        z4 = t1 + t3;
        z5 = (z3 + z4) * FIX_1_175875602;
        t0 = t0 * FIX_0_298631336;
        t1 = t1 * FIX_2_053119869;
        t2 = t2 * FIX_3_072711026;
        t3 = t3 * FIX_1_501321110;
        z1 = z1 * (-FIX_0_899976223);
        z2 = z2 * (-FIX_2_562915447);
        z3 = z3 * (-FIX_1_961570560);
        z4 = z4 * (-FIX_0_390180644);
        z3 += z5;
        z4 += z5;
        t0 += z1 + z3;
        t1 += z2 + z4;
        t2 += z2 + z3;
        t3 += z1 + z4;
        const int n = CONST_BITS + PASS1_BITS + 3;
        op[0] = idct_limit[(int)DESCALE(t10 + t3, n) & 1023];
        op[7] = idct_limit[(int)DESCALE(t10 - t3, n) & 1023];
        op[1] = idct_limit[(int)DESCALE(t11 + t2, n) & 1023];
        op[6] = idct_limit[(int)DESCALE(t11 - t2, n) & 1023];
        op[2] = idct_limit[(int)DESCALE(t12 + t1, n) & 1023];
        op[5] = idct_limit[(int)DESCALE(t12 - t1, n) & 1023];
        op[3] = idct_limit[(int)DESCALE(t13 + t0, n) & 1023];
        op[4] = idct_limit[(int)DESCALE(t13 - t0, n) & 1023];
    }
}

/* ---------------------------------------------------------------- upsample */

static int clampi(int x, int lo, int hi) { return x < lo ? lo : (x > hi ? hi : x); }

/* The component's samples at full resolution, H x W (jdsample.c's choice of method). */
static void upsample(const decoder_t *d, const comp_t *c, uint8_t *out) {
    const int W = d->width, H = d->height;
    const int hexp = d->maxh / c->h, vexp = d->maxv / c->v;
    const uint8_t *in = c->plane;
    const int st = c->pstride, dw = c->dw, dh = c->dh;
    uint8_t *row = (uint8_t *)malloc((size_t)2 * dw + 2);
    if (hexp == 1 && vexp == 1) {
        for (int y = 0; y < H; y++) memcpy(out + (size_t)y * W, in + (size_t)y * st, (size_t)W);
    } else if (hexp == 2 && vexp == 1 && dw > 2) { /* h2v1_fancy_upsample */
        for (int y = 0; y < H; y++) {
            const uint8_t *ip = in + (size_t)y * st;
            uint8_t *op = row;
            op[0] = ip[0];
            op[1] = (uint8_t)((ip[0] * 3 + ip[1] + 2) >> 2);
            for (int i = 1; i < dw - 1; i++) {
                int v = ip[i] * 3;
                op[2 * i] = (uint8_t)((v + ip[i - 1] + 1) >> 2);
                op[2 * i + 1] = (uint8_t)((v + ip[i + 1] + 2) >> 2);
            }
            op[2 * dw - 2] = (uint8_t)((ip[dw - 1] * 3 + ip[dw - 2] + 1) >> 2);
            op[2 * dw - 1] = ip[dw - 1];
            memcpy(out + (size_t)y * W, row, (size_t)W);
        }
    } else if (hexp == 2 && vexp == 2 && dw > 2) { /* h2v2_fancy_upsample */
        for (int y = 0; y < H; y++) {
            int r = y >> 1, v = y & 1;
            const uint8_t *i0 = in + (size_t)r * st;
            const uint8_t *i1 = in + (size_t)clampi(v ? r + 1 : r - 1, 0, dh - 1) * st;
            uint8_t *op = row;
            int this_ = i0[0] * 3 + i1[0], next = i0[1] * 3 + i1[1], last;
            op[0] = (uint8_t)((this_ * 4 + 8) >> 4);
            op[1] = (uint8_t)((this_ * 3 + next + 7) >> 4);
            last = this_;
            this_ = next;
            for (int i = 1; i < dw - 1; i++) {
                next = i0[i + 1] * 3 + i1[i + 1];
                op[2 * i] = (uint8_t)((this_ * 3 + last + 8) >> 4);
                op[2 * i + 1] = (uint8_t)((this_ * 3 + next + 7) >> 4);
                last = this_;
                this_ = next;
            }
            op[2 * dw - 2] = (uint8_t)((this_ * 3 + last + 8) >> 4);
            op[2 * dw - 1] = (uint8_t)((this_ * 4 + 7) >> 4);
            memcpy(out + (size_t)y * W, row, (size_t)W);
        }
    } else if (hexp == 1 && vexp == 2) { /* h1v2_fancy_upsample */
        for (int y = 0; y < H; y++) {
            int r = y >> 1, v = y & 1, bias = v ? 2 : 1;
            const uint8_t *i0 = in + (size_t)r * st;
            const uint8_t *i1 = in + (size_t)clampi(v ? r + 1 : r - 1, 0, dh - 1) * st;
            uint8_t *op = out + (size_t)y * W;
            for (int x = 0; x < W; x++) op[x] = (uint8_t)((i0[x] * 3 + i1[x] + bias) >> 2);
        }
    } else { /* h2v1_upsample, h2v2_upsample, int_upsample: replication */
        for (int y = 0; y < H; y++) {
            const uint8_t *ip = in + (size_t)(y / vexp) * st;
            uint8_t *op = out + (size_t)y * W;
            for (int x = 0; x < W; x++) op[x] = ip[x / hexp];
        }
    }
    free(row);
}

/* ------------------------------------------------------------------- colour */

#define SCALEBITS 16
#define ONE_HALF ((int64_t)1 << (SCALEBITS - 1))
#define FIX(x) ((int64_t)((x) * (1L << SCALEBITS) + 0.5))

static void ycc_to_bgr(const uint8_t *Y, const uint8_t *Cb, const uint8_t *Cr, uint8_t *out, size_t n) {
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    for (int i = 0, x = -128; i < 256; i++, x++) {
        cr_r[i] = (int)((FIX(1.40200) * x + ONE_HALF) >> SCALEBITS);
        cb_b[i] = (int)((FIX(1.77200) * x + ONE_HALF) >> SCALEBITS);
        cr_g[i] = (-FIX(0.71414)) * x;
        cb_g[i] = (-FIX(0.34414)) * x + ONE_HALF;
    }
    for (size_t i = 0; i < n; i++) {
        int y = Y[i], cb = Cb[i], cr = Cr[i];
        out[3 * i + 2] = (uint8_t)clampi(y + cr_r[cr], 0, 255);
        out[3 * i + 1] = (uint8_t)clampi(y + (int)((cb_g[cb] + cr_g[cr]) >> SCALEBITS), 0, 255);
        out[3 * i + 0] = (uint8_t)clampi(y + cb_b[cb], 0, 255);
    }
}

/* -------------------------------------------------------------- entry points */

static void release(decoder_t *d) {
    for (int i = 0; i < MAX_COMPONENTS; i++) {
        free(d->comp[i].coef);
        free(d->comp[i].plane);
        d->comp[i].coef = NULL;
        d->comp[i].plane = NULL;
    }
}

/* Reads the markers up to the first scan's header (header_only) or through the scans. */
static int parse(decoder_t *d, int header_only) {
    const uint8_t *p = d->data;
    int scans = 0;
    if (d->end - p < 2 || p[0] != 0xFF || p[1] != 0xD8) return JPEG_CORRUPT;
    p += 2;
    for (;;) {
        int m = next_marker(&p, d->end);
        if (m < 0) return scans ? JPEG_OK : JPEG_CORRUPT; /* the file ends: libjpeg's fake EOI */
        if (m == 0xD9) return scans ? JPEG_OK : JPEG_CORRUPT;
        if ((m >= 0xD0 && m <= 0xD7) || m == 0x01) continue; /* no parameters */
        /* jdmarker.c read_markers: a second SOI and markers it does not know are errors */
        if (m == 0xD8 || m < 0xC0 || m == 0xDE || m == 0xDF || (m >= 0xF0 && m <= 0xFD))
            return JPEG_CORRUPT;
        /* A segment cut off by the end of the file reads on into libjpeg's fake EOI
         * markers (FF D9 FF D9 ...), as its stdio source manager supplies them. */
        uint8_t *padded = NULL;
        const uint8_t *seg = p;
        int len = d->end - p >= 2 ? u16(p) : (d->end - p == 1 ? (p[0] << 8) | 0xFF : 0xFFD9);
        if (len < 2) return scans ? JPEG_OK : JPEG_CORRUPT;
        if (d->end - p < len) {
            long have = d->end - p;
            padded = (uint8_t *)malloc((size_t)len);
            if (!padded) return JPEG_NO_MEMORY;
            memcpy(padded, p, (size_t)have);
            for (long i = have; i < len; i++) padded[i] = (i - have) % 2 ? 0xD9 : 0xFF;
            seg = padded;
            p = d->end;
        } else {
            p += len;
        }
        const uint8_t *s = seg + 2;
        int n = len - 2, r = JPEG_OK;
        if (m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xCC) {
            r = read_sof(d, s, n, m);
        } else if (m == 0xC4) {
            r = read_dht(d, s, n);
        } else if (m == 0xCC) {
            r = JPEG_ARITHMETIC; /* DAC: arithmetic conditioning */
        } else if (m == 0xDB) {
            r = read_dqt(d, s, n);
        } else if (m == 0xDD) {
            if (n < 2) r = JPEG_CORRUPT;
            else d->restart_interval = u16(s);
        } else if (m == 0xE0) {
            if (n >= 14 && !memcmp(s, "JFIF\0", 5)) d->saw_jfif = 1;
        } else if (m == 0xEE) {
            if (n >= 12 && !memcmp(s, "Adobe", 5)) {
                d->saw_adobe = 1;
                d->adobe_transform = s[11];
            }
        } else if (m == 0xDA) {
            /* jpeg_read_header reads up to the first scan's header */
            int ns = n > 0 ? s[0] : 0;
            if (header_only) {
                free(padded);
                return d->have_sof && ns >= 1 && n == 4 + 2 * ns ? JPEG_OK : JPEG_CORRUPT;
            }
            p = decode_scan(d, s, n, p, &r);
            if (!p) {
                free(padded);
                return r;
            }
            /* a first scan of every component is the whole image: libjpeg decodes it in
             * one pass and OpenCV keeps the pixels whatever follows */
            if (++scans == 1 && ns == d->ncomp) {
                free(padded);
                return JPEG_OK;
            }
        }
        free(padded);
        if (r != JPEG_OK) return r;
    }
}

int jpeg_header(const uint8_t *data, long n, int *height, int *width) {
    decoder_t *d = (decoder_t *)calloc(1, sizeof(decoder_t));
    if (!d) return JPEG_NO_MEMORY;
    d->data = data;
    d->end = data + n;
    int r = parse(d, 1);
    if (r == JPEG_OK && !d->have_sof) r = JPEG_CORRUPT;
    *height = d->height;
    *width = d->width;
    release(d);
    free(d);
    return r;
}

/* out: height x width x 3 BGR bytes (the size jpeg_header reported). */
int jpeg_decode(const uint8_t *data, long n, uint8_t *out) {
    decoder_t *d = (decoder_t *)calloc(1, sizeof(decoder_t));
    if (!d) return JPEG_NO_MEMORY;
    d->data = data;
    d->end = data + n;
    init_limit(d->limit);
    int r = parse(d, 0);
    const size_t npx = (size_t)d->width * d->height;
    uint8_t *full[3] = {NULL, NULL, NULL};
    if (r != JPEG_OK) goto done;
    for (int i = 0; i < d->ncomp; i++) {
        comp_t *c = &d->comp[i];
        int nbx = (c->dw + 7) / 8, nby = (c->dh + 7) / 8;
        c->pstride = 8 * nbx;
        c->plane = (uint8_t *)malloc((size_t)c->pstride * 8 * nby);
        full[i] = (uint8_t *)malloc(npx);
        if (!c->plane || !full[i]) {
            r = JPEG_NO_MEMORY;
            goto done;
        }
                for (int by = 0; by < nby; by++)
            for (int bx = 0; bx < nbx; bx++)
                idct_islow(c->coef + ((size_t)by * c->bw + bx) * 64, c->q,
                           c->plane + (size_t)8 * by * c->pstride + 8 * bx, c->pstride, d->limit);
        upsample(d, c, full[i]);
    }
    if (d->ncomp == 1) {
        for (size_t i = 0; i < npx; i++) out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = full[0][i];
    } else {
        int rgb;
        if (d->saw_jfif) rgb = 0;
        else if (d->saw_adobe) rgb = d->adobe_transform == 0;
        else rgb = d->comp[0].id == 82 && d->comp[1].id == 71 && d->comp[2].id == 66;
        if (rgb) {
            for (size_t i = 0; i < npx; i++) {
                out[3 * i] = full[2][i];
                out[3 * i + 1] = full[1][i];
                out[3 * i + 2] = full[0][i];
            }
        } else {
            ycc_to_bgr(full[0], full[1], full[2], out, npx);
        }
    }
done:
    for (int i = 0; i < 3; i++) free(full[i]);
    release(d);
    free(d);
    return r;
}

/* ------------------------------------------------- FFmpeg's MJPEG video path */

enum { JPEG_LAYOUT = 6 }; /* a video frame that is not three-component 4:2:0 */

#define W1 22725
#define W2 21407
#define W3 19266
#define W4 16383
#define W5 12873
#define W6 8867
#define W7 4520
#define ROW_SHIFT 11
#define COL_SHIFT 20

/* simple_idct_template.c idctRowCondDC (8-bit, extra_shift 0): the results are
 * stored back into the int16 block, as FFmpeg stores them. */
static void simple_idct_row(int16_t *row) {
    if (!(row[1] | row[2] | row[3] | row[4] | row[5] | row[6] | row[7])) {
        int16_t dc = (int16_t)(uint16_t)((unsigned)row[0] << 3);
        for (int i = 0; i < 8; i++) row[i] = dc;
        return;
    }
    uint32_t a0, a1, a2, a3, b0, b1, b2, b3;
    a0 = (uint32_t)(W4 * row[0]) + (1u << (ROW_SHIFT - 1));
    a1 = a0;
    a2 = a0;
    a3 = a0;
    a0 += (uint32_t)(W2 * row[2]);
    a1 += (uint32_t)(W6 * row[2]);
    a2 -= (uint32_t)(W6 * row[2]);
    a3 -= (uint32_t)(W2 * row[2]);
    b0 = (uint32_t)(W1 * row[1]) + (uint32_t)(W3 * row[3]);
    b1 = (uint32_t)(W3 * row[1]) + (uint32_t)(-W7 * row[3]);
    b2 = (uint32_t)(W5 * row[1]) + (uint32_t)(-W1 * row[3]);
    b3 = (uint32_t)(W7 * row[1]) + (uint32_t)(-W5 * row[3]);
    a0 += (uint32_t)(W4 * row[4] + W6 * row[6]);
    a1 += (uint32_t)(-W4 * row[4] - W2 * row[6]);
    a2 += (uint32_t)(-W4 * row[4] + W2 * row[6]);
    a3 += (uint32_t)(W4 * row[4] - W6 * row[6]);
    b0 += (uint32_t)(W5 * row[5]) + (uint32_t)(W7 * row[7]);
    b1 += (uint32_t)(-W1 * row[5]) + (uint32_t)(-W5 * row[7]);
    b2 += (uint32_t)(W7 * row[5]) + (uint32_t)(W3 * row[7]);
    b3 += (uint32_t)(W3 * row[5]) + (uint32_t)(-W1 * row[7]);
    row[0] = (int16_t)((int32_t)(a0 + b0) >> ROW_SHIFT);
    row[7] = (int16_t)((int32_t)(a0 - b0) >> ROW_SHIFT);
    row[1] = (int16_t)((int32_t)(a1 + b1) >> ROW_SHIFT);
    row[6] = (int16_t)((int32_t)(a1 - b1) >> ROW_SHIFT);
    row[2] = (int16_t)((int32_t)(a2 + b2) >> ROW_SHIFT);
    row[5] = (int16_t)((int32_t)(a2 - b2) >> ROW_SHIFT);
    row[3] = (int16_t)((int32_t)(a3 + b3) >> ROW_SHIFT);
    row[4] = (int16_t)((int32_t)(a3 - b3) >> ROW_SHIFT);
}

static uint8_t clip_pixel(int32_t x) { return (uint8_t)(x < 0 ? 0 : (x > 255 ? 255 : x)); }

/* simple_idct_template.c idctSparseColPut */
static void simple_idct_col_put(const int16_t *col, uint8_t *dest, int stride) {
    uint32_t a0, a1, a2, a3, b0, b1, b2, b3;
    a0 = (uint32_t)(W4 * (col[0] + ((1 << (COL_SHIFT - 1)) / W4)));
    a1 = a0;
    a2 = a0;
    a3 = a0;
    a0 += (uint32_t)(W2 * col[16]);
    a1 += (uint32_t)(W6 * col[16]);
    a2 += (uint32_t)(-W6 * col[16]);
    a3 += (uint32_t)(-W2 * col[16]);
    b0 = (uint32_t)(W1 * col[8]) + (uint32_t)(W3 * col[24]);
    b1 = (uint32_t)(W3 * col[8]) + (uint32_t)(-W7 * col[24]);
    b2 = (uint32_t)(W5 * col[8]) + (uint32_t)(-W1 * col[24]);
    b3 = (uint32_t)(W7 * col[8]) + (uint32_t)(-W5 * col[24]);
    a0 += (uint32_t)(W4 * col[32]);
    a1 += (uint32_t)(-W4 * col[32]);
    a2 += (uint32_t)(-W4 * col[32]);
    a3 += (uint32_t)(W4 * col[32]);
    b0 += (uint32_t)(W5 * col[40]);
    b1 += (uint32_t)(-W1 * col[40]);
    b2 += (uint32_t)(W7 * col[40]);
    b3 += (uint32_t)(W3 * col[40]);
    a0 += (uint32_t)(W6 * col[48]);
    a1 += (uint32_t)(-W2 * col[48]);
    a2 += (uint32_t)(W2 * col[48]);
    a3 += (uint32_t)(-W6 * col[48]);
    b0 += (uint32_t)(W7 * col[56]);
    b1 += (uint32_t)(-W5 * col[56]);
    b2 += (uint32_t)(W3 * col[56]);
    b3 += (uint32_t)(-W1 * col[56]);
    dest[0 * stride] = clip_pixel((int32_t)(a0 + b0) >> COL_SHIFT);
    dest[1 * stride] = clip_pixel((int32_t)(a1 + b1) >> COL_SHIFT);
    dest[2 * stride] = clip_pixel((int32_t)(a2 + b2) >> COL_SHIFT);
    dest[3 * stride] = clip_pixel((int32_t)(a3 + b3) >> COL_SHIFT);
    dest[4 * stride] = clip_pixel((int32_t)(a3 - b3) >> COL_SHIFT);
    dest[5 * stride] = clip_pixel((int32_t)(a2 - b2) >> COL_SHIFT);
    dest[6 * stride] = clip_pixel((int32_t)(a1 - b1) >> COL_SHIFT);
    dest[7 * stride] = clip_pixel((int32_t)(a0 - b0) >> COL_SHIFT);
}

/* mjpegdec.c decode_block's dequantisation (int16 products, the DC clipped), then
 * ff_simple_idct_put_int16_8bit. */
static void simple_idct_put(const int16_t *coef, const int16_t *q, uint8_t *out, int stride) {
    int16_t blk[64];
    int32_t dc = 1024 + (int32_t)coef[0] * q[0]; /* last_dc starts at 4 << 8 */
    blk[0] = (int16_t)(dc < -32768 ? -32768 : (dc > 32767 ? 32767 : dc));
    for (int k = 1; k < 64; k++) blk[k] = (int16_t)(uint16_t)((int32_t)coef[k] * q[k]);
    for (int r = 0; r < 8; r++) simple_idct_row(blk + 8 * r);
    for (int c = 0; c < 8; c++) simple_idct_col_put(blk + c, out + c, stride);
}

static int16_t sat16(int32_t x) { return (int16_t)(x < -32768 ? -32768 : (x > 32767 ? 32767 : x)); }
static int16_t mulhw(int16_t a, int16_t b) { return (int16_t)(((int32_t)a * b) >> 16); }

/* A three-component 4:2:0 frame as FFmpeg decodes it and swscale's SIMD yuv2rgb
 * converts it (the file's header): out is height x width x 3 BGR bytes. */
int mjpeg_decode(const uint8_t *data, long n, uint8_t *out) {
    decoder_t *d = (decoder_t *)calloc(1, sizeof(decoder_t));
    if (!d) return JPEG_NO_MEMORY;
    d->data = data;
    d->end = data + n;
    int r = parse(d, 0);
    const int W = d->width, H = d->height;
    if (r != JPEG_OK) goto done;
    if (d->ncomp != 3 || d->comp[0].h != 2 || d->comp[0].v != 2 || d->comp[1].h != 1 ||
        d->comp[1].v != 1 || d->comp[2].h != 1 || d->comp[2].v != 1 || W < 2 || H < 2) {
        r = JPEG_LAYOUT;
        goto done;
    }
    for (int i = 0; i < 3; i++) {
        comp_t *c = &d->comp[i];
        c->pstride = 8 * c->bw;
        c->plane = (uint8_t *)malloc((size_t)c->pstride * 8 * c->bh);
        if (!c->plane) {
            r = JPEG_NO_MEMORY;
            goto done;
        }
        for (int by = 0; by < c->bh; by++)
            for (int bx = 0; bx < c->bw; bx++)
                simple_idct_put(c->coef + ((size_t)by * c->bw + bx) * 64, c->q,
                                c->plane + (size_t)8 * by * c->pstride + 8 * bx, c->pstride);
    }
    /* ff_yuv2rgb_c_init_tables for full range, ITU-R BT.601, default contrast and
     * saturation: Y' = Y * 8, U' = U * 8 - 1024, coefficients in units of 2^-13 */
    const int16_t ycoef = 8192, vr = 11485, ub = 14516, ug = -2819, vg = -5850;
    for (int y = 0; y < H; y++) {
        const uint8_t *py = d->comp[0].plane + (size_t)y * d->comp[0].pstride;
        const uint8_t *pu = d->comp[1].plane + (size_t)(y >> 1) * d->comp[1].pstride;
        const uint8_t *pv = d->comp[2].plane + (size_t)(y >> 1) * d->comp[2].pstride;
        uint8_t *op = out + (size_t)y * W * 3;
        for (int x = 0; x < W; x++) {
            int16_t Y = mulhw((int16_t)(py[x] << 3), ycoef);
            int16_t U = sat16((pu[x >> 1] << 3) - 1024), V = sat16((pv[x >> 1] << 3) - 1024);
            int16_t cg = sat16(mulhw(U, ug) + mulhw(V, vg));
            op[3 * x + 0] = clip_pixel(sat16(Y + mulhw(U, ub)));
            op[3 * x + 1] = clip_pixel(sat16(Y + cg));
            op[3 * x + 2] = clip_pixel(sat16(Y + mulhw(V, vr)));
        }
    }
done:
    release(d);
    free(d);
    return r;
}
