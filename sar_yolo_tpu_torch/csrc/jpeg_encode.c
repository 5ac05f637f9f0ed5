/* Baseline JPEG encoder: host code of the port's image writer
 * (sar_yolo_tpu_torch/data/imageio.py, encode_jpeg), built with the system C compiler
 * at first use and loaded with ctypes.
 *
 * It writes the bytes that libjpeg-turbo writes for OpenCV's imencode(".jpg") with its
 * defaults, at any quality:
 *   - SOI, a JFIF 1.01 APP0 (density 1:1, no unit, no thumbnail), one DQT marker per
 *     table, SOF0, one DHT marker per table, SOS, the entropy-coded data, EOI;
 *   - three components (Y, Cb, Cr; ids 1-3) sampled 2x2, 1x1, 1x1 from BGR input, or one
 *     component (id 1) from gray input;
 *   - jccolor.c's fixed-point BGR -> YCbCr (16 fraction bits, its rounding constants);
 *   - jcsample.c's h2v2_downsample (bias 1, 2, 1, 2, ... along a row) after the right
 *     edge is replicated to whole chroma blocks; rows under the image repeat its last row;
 *   - jccoefct.c's dummy blocks where the MCU grid passes the last block of a component:
 *     all AC zero, the DC of the block before;
 *   - jfdctint.c's islow forward DCT, then jcdctmgr.c's quantization by the reciprocal
 *     of 8 x the table entry (compute_reciprocal with 16-bit DCT elements, as the SIMD
 *     build computes it);
 *   - jcparam.c's quality scaling of the Annex K tables (baseline: entries at most 255)
 *     and the Annex K Huffman tables, no restart markers, byte stuffing after 0xFF, and
 *     the last byte padded with one bits.
 */
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

static const int natural_order[64] = {
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

static const int std_luminance_quant[64] = {
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};

static const int std_chrominance_quant[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

static const uint8_t dc_luminance_bits[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
static const uint8_t dc_luminance_val[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
static const uint8_t dc_chrominance_bits[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
static const uint8_t dc_chrominance_val[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
static const uint8_t ac_luminance_bits[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
static const uint8_t ac_luminance_val[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61,
    0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52,
    0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25,
    0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64,
    0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83,
    0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99,
    0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3,
    0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8,
    0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
static const uint8_t ac_chrominance_bits[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
static const uint8_t ac_chrominance_val[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61,
    0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33,
    0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18,
    0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63,
    0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a,
    0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97,
    0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca,
    0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7,
    0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

typedef struct {
    uint16_t code[256];
    uint8_t size[256];
} huff_table;

typedef struct {
    uint16_t recip[64], corr[64];
    int shift[64];
    int quantval[64]; /* natural order */
} quant_table;

typedef struct {
    uint8_t *out;
    long pos, cap;
    uint64_t acc; /* bits not yet written, right aligned */
    int nacc;
    int overflow;
} writer;

static void put_byte(writer *w, int b) {
    if (w->pos < w->cap)
        w->out[w->pos] = (uint8_t)b;
    else
        w->overflow = 1;
    w->pos++;
}

static void put_bits(writer *w, unsigned code, int size) {
    w->acc = (w->acc << size) | (code & ((1u << size) - 1));
    w->nacc += size;
    while (w->nacc >= 8) {
        int b = (int)((w->acc >> (w->nacc - 8)) & 0xFF);
        put_byte(w, b);
        if (b == 0xFF)
            put_byte(w, 0);
        w->nacc -= 8;
    }
}

static void flush_bits(writer *w) {
    if (w->nacc > 0)
        put_bits(w, 0x7F, 8 - w->nacc);
    w->acc = 0;
    w->nacc = 0;
}

static void put_marker(writer *w, int marker, int length) {
    put_byte(w, 0xFF);
    put_byte(w, marker);
    put_byte(w, length >> 8);
    put_byte(w, length & 0xFF);
}

static void make_huff(huff_table *t, const uint8_t *bits, const uint8_t *val) {
    unsigned code = 0;
    int k = 0;
    memset(t, 0, sizeof(*t));
    for (int len = 1; len <= 16; len++) {
        for (int i = 0; i < bits[len]; i++, k++) {
            t->code[val[k]] = (uint16_t)code++;
            t->size[val[k]] = (uint8_t)len;
        }
        code <<= 1;
    }
}

static int flss(unsigned v) { return v ? 32 - __builtin_clz(v) : 0; }

static void make_quant(quant_table *q, const int *basic, int scale) {
    for (int i = 0; i < 64; i++) {
        long temp = ((long)basic[i] * scale + 50L) / 100L;
        if (temp <= 0L)
            temp = 1L;
        if (temp > 255L)
            temp = 255L;
        q->quantval[i] = (int)temp;
        /* compute_reciprocal of the islow divisor, DCT elements of 16 bits */
        unsigned divisor = (unsigned)temp << 3;
        int b = flss(divisor) - 1;
        int r = 16 + b;
        uint32_t fq = (uint32_t)(((uint64_t)1 << r) / divisor);
        uint32_t fr = (uint32_t)(((uint64_t)1 << r) % divisor);
        unsigned c = divisor / 2;
        if (fr == 0) {
            fq >>= 1;
            r--;
        } else if (fr <= divisor / 2U) {
            c++;
        } else {
            fq++;
        }
        q->recip[i] = (uint16_t)fq;
        q->corr[i] = (uint16_t)c;
        q->shift[i] = r - 16;
    }
}

#define CONST_BITS 13
#define PASS1_BITS 2
#define DESCALE(x, n) (((x) + ((int32_t)1 << ((n)-1))) >> (n))
#define FIX_0_298631336 ((int32_t)2446)
#define FIX_0_390180644 ((int32_t)3196)
#define FIX_0_541196100 ((int32_t)4433)
#define FIX_0_765366865 ((int32_t)6270)
#define FIX_0_899976223 ((int32_t)7373)
#define FIX_1_175875602 ((int32_t)9633)
#define FIX_1_501321110 ((int32_t)12299)
#define FIX_1_847759065 ((int32_t)15137)
#define FIX_1_961570560 ((int32_t)16069)
#define FIX_2_053119869 ((int32_t)16819)
#define FIX_2_562915447 ((int32_t)20995)
#define FIX_3_072711026 ((int32_t)25172)

/* jfdctint.c: the islow forward DCT, output scaled up by 8 (every intermediate of 8-bit
 * samples fits 32 bits, as libjpeg's own 32-bit builds rely on) */
static void fdct_islow(int32_t *data) {
    int32_t tmp0, tmp1, tmp2, tmp3, tmp4, tmp5, tmp6, tmp7, tmp10, tmp11, tmp12, tmp13;
    int32_t z1, z2, z3, z4, z5;
    int32_t *p = data;
    for (int ctr = 0; ctr < 8; ctr++, p += 8) {
        tmp0 = p[0] + p[7];
        tmp7 = p[0] - p[7];
        tmp1 = p[1] + p[6];
        tmp6 = p[1] - p[6];
        tmp2 = p[2] + p[5];
        tmp5 = p[2] - p[5];
        tmp3 = p[3] + p[4];
        tmp4 = p[3] - p[4];
        tmp10 = tmp0 + tmp3;
        tmp13 = tmp0 - tmp3;
        tmp11 = tmp1 + tmp2;
        tmp12 = tmp1 - tmp2;
        p[0] = (tmp10 + tmp11) * (1 << PASS1_BITS);
        p[4] = (tmp10 - tmp11) * (1 << PASS1_BITS);
        z1 = (tmp12 + tmp13) * FIX_0_541196100;
        p[2] = (int32_t)DESCALE(z1 + tmp13 * FIX_0_765366865, CONST_BITS - PASS1_BITS);
        p[6] = (int32_t)DESCALE(z1 + tmp12 * (-FIX_1_847759065), CONST_BITS - PASS1_BITS);
        z1 = tmp4 + tmp7;
        z2 = tmp5 + tmp6;
        z3 = tmp4 + tmp6;
        z4 = tmp5 + tmp7;
        z5 = (z3 + z4) * FIX_1_175875602;
        tmp4 = tmp4 * FIX_0_298631336;
        tmp5 = tmp5 * FIX_2_053119869;
        tmp6 = tmp6 * FIX_3_072711026;
        tmp7 = tmp7 * FIX_1_501321110;
        z1 = z1 * (-FIX_0_899976223);
        z2 = z2 * (-FIX_2_562915447);
        z3 = z3 * (-FIX_1_961570560);
        z4 = z4 * (-FIX_0_390180644);
        z3 += z5;
        z4 += z5;
        p[7] = (int32_t)DESCALE(tmp4 + z1 + z3, CONST_BITS - PASS1_BITS);
        p[5] = (int32_t)DESCALE(tmp5 + z2 + z4, CONST_BITS - PASS1_BITS);
        p[3] = (int32_t)DESCALE(tmp6 + z2 + z3, CONST_BITS - PASS1_BITS);
        p[1] = (int32_t)DESCALE(tmp7 + z1 + z4, CONST_BITS - PASS1_BITS);
    }
    p = data;
    for (int ctr = 0; ctr < 8; ctr++, p++) {
        tmp0 = p[0] + p[56];
        tmp7 = p[0] - p[56];
        tmp1 = p[8] + p[48];
        tmp6 = p[8] - p[48];
        tmp2 = p[16] + p[40];
        tmp5 = p[16] - p[40];
        tmp3 = p[24] + p[32];
        tmp4 = p[24] - p[32];
        tmp10 = tmp0 + tmp3;
        tmp13 = tmp0 - tmp3;
        tmp11 = tmp1 + tmp2;
        tmp12 = tmp1 - tmp2;
        p[0] = (int32_t)DESCALE(tmp10 + tmp11, PASS1_BITS);
        p[32] = (int32_t)DESCALE(tmp10 - tmp11, PASS1_BITS);
        z1 = (tmp12 + tmp13) * FIX_0_541196100;
        p[16] = (int32_t)DESCALE(z1 + tmp13 * FIX_0_765366865, CONST_BITS + PASS1_BITS);
        p[48] = (int32_t)DESCALE(z1 + tmp12 * (-FIX_1_847759065), CONST_BITS + PASS1_BITS);
        z1 = tmp4 + tmp7;
        z2 = tmp5 + tmp6;
        z3 = tmp4 + tmp6;
        z4 = tmp5 + tmp7;
        z5 = (z3 + z4) * FIX_1_175875602;
        tmp4 = tmp4 * FIX_0_298631336;
        tmp5 = tmp5 * FIX_2_053119869;
        tmp6 = tmp6 * FIX_3_072711026;
        tmp7 = tmp7 * FIX_1_501321110;
        z1 = z1 * (-FIX_0_899976223);
        z2 = z2 * (-FIX_2_562915447);
        z3 = z3 * (-FIX_1_961570560);
        z4 = z4 * (-FIX_0_390180644);
        z3 += z5;
        z4 += z5;
        p[56] = (int32_t)DESCALE(tmp4 + z1 + z3, CONST_BITS + PASS1_BITS);
        p[40] = (int32_t)DESCALE(tmp5 + z2 + z4, CONST_BITS + PASS1_BITS);
        p[24] = (int32_t)DESCALE(tmp6 + z2 + z3, CONST_BITS + PASS1_BITS);
        p[8] = (int32_t)DESCALE(tmp7 + z1 + z4, CONST_BITS + PASS1_BITS);
    }
}

/* One block of a plane (stride pixels a row) at (by, bx) in blocks: DCT and quantize. */
static void forward_block(const uint8_t *plane, long stride, long by, long bx,
                          const quant_table *q, int16_t *coef) {
    int32_t ws[64];
    const uint8_t *src = plane + by * 8 * stride + bx * 8;
    for (int y = 0; y < 8; y++)
        for (int x = 0; x < 8; x++)
            ws[y * 8 + x] = (int32_t)src[y * stride + x] - 128;
    fdct_islow(ws);
    for (int i = 0; i < 64; i++) {
        int32_t t = ws[i];
        int neg = t < 0;
        if (neg)
            t = -t;
        uint32_t product = (uint32_t)(t + q->corr[i]) * q->recip[i];
        t = (int32_t)(product >> (q->shift[i] + 16));
        coef[i] = (int16_t)(neg ? -t : t);
    }
}

static void encode_block(writer *w, const int16_t *coef, int *last_dc, const huff_table *dc,
                         const huff_table *ac) {
    int temp = coef[0] - *last_dc, temp2 = temp;
    *last_dc = coef[0];
    if (temp < 0) {
        temp = -temp;
        temp2--;
    }
    int nbits = flss((unsigned)temp);
    put_bits(w, dc->code[nbits], dc->size[nbits]);
    if (nbits)
        put_bits(w, (unsigned)temp2, nbits);
    int r = 0;
    for (int k = 1; k < 64; k++) {
        temp = coef[natural_order[k]];
        if (temp == 0) {
            r++;
            continue;
        }
        while (r > 15) {
            put_bits(w, ac->code[0xF0], ac->size[0xF0]);
            r -= 16;
        }
        temp2 = temp;
        if (temp < 0) {
            temp = -temp;
            temp2--;
        }
        nbits = flss((unsigned)temp);
        int i = (r << 4) + nbits;
        put_bits(w, ac->code[i], ac->size[i]);
        put_bits(w, (unsigned)temp2, nbits);
        r = 0;
    }
    if (r > 0)
        put_bits(w, ac->code[0], ac->size[0]);
}

static void put_dqt(writer *w, int index, const quant_table *q) {
    put_marker(w, 0xDB, 67);
    put_byte(w, index);
    for (int i = 0; i < 64; i++)
        put_byte(w, q->quantval[natural_order[i]]);
}

static void put_dht(writer *w, int index, const uint8_t *bits, const uint8_t *val) {
    int n = 0;
    for (int i = 1; i <= 16; i++)
        n += bits[i];
    put_marker(w, 0xC4, 2 + 1 + 16 + n);
    put_byte(w, index);
    for (int i = 1; i <= 16; i++)
        put_byte(w, bits[i]);
    for (int i = 0; i < n; i++)
        put_byte(w, val[i]);
}

/* A component plane of (rows x cols) samples from a (h x w) source plane read through
 * get(y, x), its right columns and bottom rows repeating the last ones. */
static uint8_t *padded(long rows, long cols) { return (uint8_t *)malloc((size_t)(rows * cols)); }

#define FIX16(x) ((int32_t)((x) * 65536.0 + 0.5))

/* img: h x w x channels uint8 (BGR for 3 channels), rows contiguous. out: cap bytes.
 * Returns the file's length; more than cap where out was too small (nothing valid
 * written then); -1 for bad arguments, -2 out of memory. */
long jpeg_encode(const uint8_t *img, int h, int w, int channels, int quality, uint8_t *out,
                 long cap) {
    if (h < 1 || w < 1 || h > 65535 || w > 65535 || (channels != 1 && channels != 3))
        return -1;
    if (quality <= 0)
        quality = 1;
    if (quality > 100)
        quality = 100;
    int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
    quant_table qt[2];
    huff_table dc[2], ac[2];
    make_quant(&qt[0], std_luminance_quant, scale);
    make_quant(&qt[1], std_chrominance_quant, scale);
    make_huff(&dc[0], dc_luminance_bits, dc_luminance_val);
    make_huff(&ac[0], ac_luminance_bits, ac_luminance_val);
    make_huff(&dc[1], dc_chrominance_bits, dc_chrominance_val);
    make_huff(&ac[1], ac_chrominance_bits, ac_chrominance_val);

    writer wr = {out, 0, cap, 0, 0, 0};
    writer *wp = &wr;
    static const uint8_t jfif[16] = {0xFF, 0xD8, 0xFF, 0xE0, 0x00, 0x10, 'J', 'F',
                                     'I', 'F', 0x00, 0x01, 0x01, 0x00, 0x00, 0x01};
    for (int i = 0; i < 16; i++)
        put_byte(wp, jfif[i]);
    put_byte(wp, 0x00);
    put_byte(wp, 0x01);
    put_byte(wp, 0x00);
    put_byte(wp, 0x00);
    int nc = channels == 3 ? 3 : 1;
    put_dqt(wp, 0, &qt[0]);
    if (nc == 3)
        put_dqt(wp, 1, &qt[1]);
    put_marker(wp, 0xC0, 8 + 3 * nc);
    put_byte(wp, 8);
    put_byte(wp, h >> 8);
    put_byte(wp, h & 0xFF);
    put_byte(wp, w >> 8);
    put_byte(wp, w & 0xFF);
    put_byte(wp, nc);
    for (int c = 0; c < nc; c++) {
        put_byte(wp, c + 1);
        put_byte(wp, (nc == 3 && c == 0) ? 0x22 : 0x11);
        put_byte(wp, c ? 1 : 0);
    }
    put_dht(wp, 0x00, dc_luminance_bits, dc_luminance_val);
    put_dht(wp, 0x10, ac_luminance_bits, ac_luminance_val);
    if (nc == 3) {
        put_dht(wp, 0x01, dc_chrominance_bits, dc_chrominance_val);
        put_dht(wp, 0x11, ac_chrominance_bits, ac_chrominance_val);
    }
    put_marker(wp, 0xDA, 6 + 2 * nc);
    put_byte(wp, nc);
    for (int c = 0; c < nc; c++) {
        put_byte(wp, c + 1);
        put_byte(wp, c ? 0x11 : 0x00);
    }
    put_byte(wp, 0);
    put_byte(wp, 63);
    put_byte(wp, 0);

    int16_t coef[64];
    if (nc == 1) {
        long bw = (w + 7) / 8, bh = (h + 7) / 8, cols = bw * 8, rows = bh * 8;
        uint8_t *y = padded(rows, cols);
        if (!y)
            return -2;
        for (long r = 0; r < rows; r++) {
            const uint8_t *src = img + (r < h ? r : h - 1) * (long)w;
            memcpy(y + r * cols, src, (size_t)w);
            memset(y + r * cols + w, src[w - 1], (size_t)(cols - w));
        }
        int last = 0;
        for (long by = 0; by < bh; by++)
            for (long bx = 0; bx < bw; bx++) {
                forward_block(y, cols, by, bx, &qt[0], coef);
                encode_block(wp, coef, &last, &dc[0], &ac[0]);
            }
        free(y);
    } else {
        /* Y: ceil(w/8) blocks wide, ceil(h/8) high; chroma ceil(w/16) x ceil(h/16) blocks;
         * the MCU grid is ceil(w/16) x ceil(h/16). */
        long ybw = (w + 7) / 8, ybh = (h + 7) / 8, mcux = (w + 15) / 16, mcuy = (h + 15) / 16;
        long ycols = ybw * 8, yrows = mcuy * 16, ccols = mcux * 8, crows = mcuy * 8;
        long fcols = mcux * 16, frows = (h + 1) / 2 * 2; /* full-resolution chroma */
        uint8_t *yp = padded(yrows, ycols), *cb = padded(crows, ccols), *cr = padded(crows, ccols);
        uint8_t *fcb = padded(2, fcols), *fcr = padded(2, fcols);
        if (!yp || !cb || !cr || !fcb || !fcr) {
            free(yp);
            free(cb);
            free(cr);
            free(fcb);
            free(fcr);
            return -2;
        }
        int32_t ry[256], gy[256], by_[256], rcb[256], gcb[256], bcb[256], gcr[256], bcr[256];
        for (int i = 0; i < 256; i++) {
            ry[i] = FIX16(0.29900) * i;
            gy[i] = FIX16(0.58700) * i;
            by_[i] = FIX16(0.11400) * i + (1 << 15);
            rcb[i] = -FIX16(0.16874) * i;
            gcb[i] = -FIX16(0.33126) * i;
            bcb[i] = FIX16(0.50000) * i + (128 << 16) + (1 << 15) - 1; /* also R's Cr term */
            gcr[i] = -FIX16(0.41869) * i;
            bcr[i] = -FIX16(0.08131) * i;
        }
        for (long r2 = 0; r2 < frows; r2 += 2) {
            for (int k = 0; k < 2; k++) {
                long r = r2 + k;
                const uint8_t *src = img + (r < h ? r : h - 1) * (long)w * 3;
                uint8_t *yrow = yp + r * ycols, *brow = fcb + k * fcols, *rrow = fcr + k * fcols;
                for (long x = 0; x < w; x++) {
                    int b = src[3 * x], g = src[3 * x + 1], rr = src[3 * x + 2];
                    yrow[x] = (uint8_t)((ry[rr] + gy[g] + by_[b]) >> 16);
                    brow[x] = (uint8_t)((rcb[rr] + gcb[g] + bcb[b]) >> 16);
                    rrow[x] = (uint8_t)((bcb[rr] + gcr[g] + bcr[b]) >> 16);
                }
                memset(yrow + w, yrow[w - 1], (size_t)(ycols - w));
                memset(brow + w, brow[w - 1], (size_t)(fcols - w));
                memset(rrow + w, rrow[w - 1], (size_t)(fcols - w));
            }
            uint8_t *ob = cb + r2 / 2 * ccols, *orr = cr + r2 / 2 * ccols;
            for (long x = 0; x < ccols; x++) {
                int bias = 1 + (int)(x & 1);
                ob[x] = (uint8_t)((fcb[2 * x] + fcb[2 * x + 1] + fcb[fcols + 2 * x] +
                                   fcb[fcols + 2 * x + 1] + bias) >> 2);
                orr[x] = (uint8_t)((fcr[2 * x] + fcr[2 * x + 1] + fcr[fcols + 2 * x] +
                                    fcr[fcols + 2 * x + 1] + bias) >> 2);
            }
        }
        for (long r = frows; r < yrows; r++)
            memcpy(yp + r * ycols, yp + (frows - 1) * ycols, (size_t)ycols);
        for (long r = frows / 2; r < crows; r++) {
            memcpy(cb + r * ccols, cb + (frows / 2 - 1) * ccols, (size_t)ccols);
            memcpy(cr + r * ccols, cr + (frows / 2 - 1) * ccols, (size_t)ccols);
        }
        int last[3] = {0, 0, 0};
        int16_t blk[4][64];
        for (long my = 0; my < mcuy; my++)
            for (long mx = 0; mx < mcux; mx++) {
                for (int k = 0; k < 4; k++) {
                    long yy = my * 2 + k / 2, xx = mx * 2 + k % 2;
                    if (yy >= ybh) /* a row of dummy blocks: the DC of the block before */
                        memset(blk[k], 0, sizeof(blk[k])), blk[k][0] = blk[1][0];
                    else if (xx >= ybw)
                        memset(blk[k], 0, sizeof(blk[k])), blk[k][0] = blk[k - 1][0];
                    else
                        forward_block(yp, ycols, yy, xx, &qt[0], blk[k]);
                    encode_block(wp, blk[k], &last[0], &dc[0], &ac[0]);
                }
                forward_block(cb, ccols, my, mx, &qt[1], coef);
                encode_block(wp, coef, &last[1], &dc[1], &ac[1]);
                forward_block(cr, ccols, my, mx, &qt[1], coef);
                encode_block(wp, coef, &last[2], &dc[1], &ac[1]);
            }
        free(yp);
        free(cb);
        free(cr);
        free(fcb);
        free(fcr);
    }
    flush_bits(wp);
    put_byte(wp, 0xFF);
    put_byte(wp, 0xD9);
    return wr.pos;
}
