/* Host image codec of the PyTorch port: PNG unfiltering, JPEG decoding
 * (every mode libjpeg-turbo decodes at 8 bits), baseline JPEG encoding
 * and OpenEXR decoding, behind a plain C interface that utils/image.py
 * loads with ctypes.
 *
 * PNG: zlib inflation stays in Python; png_unfilter undoes the per-row
 * filters 0-4 (and the Adam7 interlace) of the inflated stream.
 *
 * JPEG decoding follows libjpeg(-turbo)'s default path so that the
 * samples equal what it gives: every scan's entropy-coded data lands in
 * one int16 coefficient block per 8x8 block of each component, by
 * Huffman decoding (jdhuff.c for sequential scans, jdphuff.c's four
 * progressive scan kinds: DC first, DC refinement, AC first and AC
 * refinement, with EOB runs) or by the QM arithmetic decoder (jdarith.c:
 * sequential and the same four progressive kinds, DAC conditioning,
 * statistics reset at every restart); after the last scan each block is
 * dequantised by the table latched at its component's first scan and
 * goes through the integer "islow" IDCT (jidctint.c), then "fancy"
 * triangle upsampling of 2h1v, 2h2v and 1h2v (4:4:0) chroma (jdsample.c,
 * with the first and last sample rows repeated as context) and
 * replication for other ratios.  Lossless files (SOF3, jdlhuff.c,
 * jddiffct.c, jdlossls.c) decode Huffman-coded differences against the
 * seven predictors and the point transform, with replication
 * upsampling.  Three components are YCbCr or RGB by jdapimin.c's rule
 * (JFIF, then an Adobe transform, then the component ids) and go
 * through jdcolor.c's fixed-point YCbCr->RGB; four are CMYK or YCCK
 * (Adobe transform), given inverted as Pillow reads them.  8-bit files of
 * 1, 3 or 4 components (SOF0, SOF1, SOF2, SOF3, SOF9, SOF10; interleaved
 * or not; restart intervals; tables redefined between scans).
 * Arithmetic-coded lossless (SOF11), hierarchical and 12- or 16-bit
 * files, lossless files in YCbCr or YCCK, lossless restart intervals
 * that are not whole MCU rows and MCUs of more than 10 blocks are
 * refused with the mode's name, as libjpeg-turbo refuses them.
 *
 * JPEG encoding: baseline, 4:2:0 (or one gray component), the Annex K
 * quantisation tables scaled by libjpeg's quality rule and the Annex K
 * Huffman tables; a float DCT with rounding to the nearest level.
 *
 * OpenEXR: single-part scanline files (the OpenEXR file layout: magic and
 * version, header attributes, offset table, chunks of y, size and data),
 * HALF (widened exactly) or FLOAT channels R,G,B[,A] or Y, compressed
 * NO, RLE, ZIPS or ZIP (zlib, then OpenEXR's byte predictor and the
 * de-interleave of the two halves).  Other compressions, UINT or
 * subsampled channels, and tiled, multi-part, deep or long-name files are
 * refused with the mode's name.
 */
#include <math.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <zlib.h>

/* ------------------------------------------------------------------ PNG */

static const int ADAM7[7][4] = {  /* x0, y0, dx, dy */
    {0, 0, 8, 8}, {4, 0, 8, 8}, {0, 4, 4, 8}, {2, 0, 4, 4},
    {0, 2, 2, 4}, {1, 0, 2, 2}, {0, 1, 1, 2}};

static int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  return pb <= pc ? b : c;
}

/* Unfilter `h` rows of `rowbytes` bytes in place order: src holds each row
 * behind its filter byte; dst receives the rows back to back.  bpp: bytes
 * per complete pixel (at least 1).  Returns bytes of src consumed, or -1. */
static long unfilter_rows(const uint8_t *src, size_t src_len, uint8_t *dst,
                          long rowbytes, long h, int bpp) {
  size_t need = (size_t)h * (size_t)(rowbytes + 1);
  if (need > src_len) return -1;
  for (long y = 0; y < h; y++) {
    const uint8_t *in = src + y * (rowbytes + 1);
    uint8_t *out = dst + y * rowbytes;
    const uint8_t *up = y ? out - rowbytes : NULL;
    int f = in[0];
    in++;
    switch (f) {
      case 0:
        memcpy(out, in, rowbytes);
        break;
      case 1:
        for (long i = 0; i < rowbytes; i++)
          out[i] = in[i] + (i >= bpp ? out[i - bpp] : 0);
        break;
      case 2:
        for (long i = 0; i < rowbytes; i++) out[i] = in[i] + (up ? up[i] : 0);
        break;
      case 3:
        for (long i = 0; i < rowbytes; i++) {
          int a = i >= bpp ? out[i - bpp] : 0, b = up ? up[i] : 0;
          out[i] = in[i] + ((a + b) >> 1);
        }
        break;
      case 4:
        for (long i = 0; i < rowbytes; i++) {
          int a = i >= bpp ? out[i - bpp] : 0, b = up ? up[i] : 0;
          int c = (up && i >= bpp) ? up[i - bpp] : 0;
          out[i] = in[i] + paeth(a, b, c);
        }
        break;
      default:
        return -1;
    }
  }
  return (long)need;
}

static long png_rowbytes(long w, int bits) { return (w * bits + 7) / 8; }

/* src: the inflated IDAT stream; dst: h rows of png_rowbytes(w, bits)
 * bytes, the image's samples as the PNG packs them (big-endian 16-bit
 * samples, sub-byte samples MSB first).  bits: bits per pixel (bit depth x
 * channels).  Returns 0, or -1 on a short stream or an unknown filter. */
int png_unfilter(const uint8_t *src, size_t src_len, uint8_t *dst, int w,
                 int h, int bits, int interlace) {
  int bpp = bits >= 8 ? bits / 8 : 1;
  long rb = png_rowbytes(w, bits);
  if (!interlace)
    return unfilter_rows(src, src_len, dst, rb, h, bpp) < 0 ? -1 : 0;
  memset(dst, 0, (size_t)rb * h);
  size_t off = 0;
  uint8_t *tmp = NULL;
  for (int p = 0; p < 7; p++) {
    int x0 = ADAM7[p][0], y0 = ADAM7[p][1], dx = ADAM7[p][2],
        dy = ADAM7[p][3];
    long pw = w > x0 ? (w - x0 + dx - 1) / dx : 0;
    long ph = h > y0 ? (h - y0 + dy - 1) / dy : 0;
    if (!pw || !ph) continue;
    long prb = png_rowbytes(pw, bits);
    uint8_t *t = realloc(tmp, (size_t)prb * ph);
    if (!t) {
      free(tmp);
      return -1;
    }
    tmp = t;
    long used = unfilter_rows(src + off, src_len - off, tmp, prb, ph, bpp);
    if (used < 0) {
      free(tmp);
      return -1;
    }
    off += used;
    for (long py = 0; py < ph; py++) {
      uint8_t *row = dst + (y0 + py * dy) * rb;
      const uint8_t *prow = tmp + py * prb;
      for (long px = 0; px < pw; px++) {
        long x = x0 + px * dx;
        if (bits >= 8) {
          memcpy(row + x * bpp, prow + px * bpp, bpp);
        } else {
          int per = 8 / bits, mask = (1 << bits) - 1;
          int v = (prow[px / per] >> ((per - 1 - px % per) * bits)) & mask;
          row[x / per] |= v << ((per - 1 - x % per) * bits);
        }
      }
    }
  }
  free(tmp);
  return 0;
}

/* ------------------------------------------------------- JPEG: common */

static const uint8_t ZIGZAG[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

/* libjpeg's jpeg_natural_order with its 16 guard entries: a corrupt run
 * past coefficient 63 lands on 63 */
static int natural(int k) { return k < 64 ? ZIGZAG[k] : 63; }

/* ----------------------------------------------------- JPEG: decoding */

typedef struct {
  uint8_t bits[17];
  uint8_t vals[256];
  int maxcode[18], valptr[17], mincode[17];
  uint16_t fast[512]; /* 9-bit lookahead: (length << 8) | symbol, 0 = slow */
  int defined;
} Huff;

typedef struct {
  int id, h, v, tq;
  int bw, bh;         /* blocks (lossless: samples) per row and column of
                         the padded plane */
  int dw, dh;         /* downsampled size (libjpeg's downsampled_width) */
  int stride;         /* bytes per row of plane: bw*8 (lossless: bw) */
  uint8_t *plane;     /* bw*8 x bh*8 samples (lossless: bw x bh) */
  int16_t *coef;      /* bw x bh blocks of 64 coefficients, natural order */
  uint16_t q[64];     /* the table latched at the component's first scan */
  int latched;
  int pred, td, ta;
  int dc_context;     /* arithmetic: the previous DC difference's class */
} Comp;

typedef struct {
  const uint8_t *p, *end;
  uint32_t buf;
  int cnt, marker;
} Bits;

typedef struct {
  int w, h, nc, hmax, vmax, mcux, mcuy, restart, adobe, adobe_transform;
  int jfif, have_frame, progressive, arith, lossless, scans;
  Comp comp[4];
  uint16_t q[4][64]; /* natural order */
  Huff dc[4], ac[4];
  uint8_t dc_L[16], dc_U[16], ac_K[16]; /* DAC conditioning (arithmetic) */
  char *err;
  int errlen;
} Jpeg;

static int fail(Jpeg *j, const char *msg) {
  if (j->err && j->errlen > 0) snprintf(j->err, j->errlen, "%s", msg);
  return -1;
}

static void build_huff(Huff *t) {
  int code = 0, k = 0;
  memset(t->fast, 0, sizeof t->fast);
  for (int l = 1; l <= 16; l++) {
    t->valptr[l] = k;
    t->mincode[l] = code;
    for (int i = 0; i < t->bits[l]; i++, k++, code++) {
      if (l <= 9) {
        int lo = code << (9 - l), hi = (code + 1) << (9 - l);
        for (int c = lo; c < hi && c < 512; c++)
          t->fast[c] = (uint16_t)((l << 8) | t->vals[k]);
      }
    }
    t->maxcode[l] = t->bits[l] ? code - 1 : -1;
    code <<= 1;
  }
  t->maxcode[17] = 0x7fffffff;
  t->defined = 1;
}

static void fill(Bits *b) {
  while (b->cnt <= 24) {
    uint32_t c = 0;
    if (!b->marker && b->p < b->end) {
      c = *b->p;
      if (c == 0xFF) {
        uint32_t c2 = b->p + 1 < b->end ? b->p[1] : 0xD9;
        if (c2 == 0) {
          b->p += 2;
        } else {
          b->marker = 1; /* feed zeros from here, as libjpeg does */
          c = 0;
        }
      } else {
        b->p++;
      }
    }
    b->buf |= c << (24 - b->cnt);
    b->cnt += 8;
  }
}

static inline int get_bits(Bits *b, int n) {
  if (!n) return 0;
  fill(b);
  int v = (int)(b->buf >> (32 - n));
  b->buf <<= n;
  b->cnt -= n;
  return v;
}

static inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

static inline int huff_decode(Bits *b, const Huff *t) {
  fill(b);
  int e = t->fast[b->buf >> 23];
  if (e) {
    int l = e >> 8;
    b->buf <<= l;
    b->cnt -= l;
    return e & 255;
  }
  int code = 0;
  for (int l = 1; l <= 16; l++) {
    code = (code << 1) | (int)(b->buf >> 31);
    b->buf <<= 1;
    b->cnt--;
    if (code <= t->maxcode[l])
      return t->vals[t->valptr[l] + code - t->mincode[l]];
  }
  return 0; /* corrupt code: treat as EOB / zero difference */
}

/* jidctint.c (libjpeg 6b, as libjpeg-turbo keeps it) */
#define CONST_BITS 13
#define PASS1_BITS 2
#define DESCALE(x, n) (((x) + ((int64_t)1 << ((n)-1))) >> (n))
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

static uint8_t IDCT_LIMIT[1024]; /* range_limit + CENTERJSAMPLE, & 1023 */
static uint8_t CLAMP[768];       /* sample_range_limit over [-256, 511] */

static void init_tables(void) {
  static int done = 0;
  if (done) return;
  for (int i = 0; i < 1024; i++) {
    int v;
    if (i < 128) v = i + 128;
    else if (i < 512) v = 255;
    else if (i < 896) v = 0;
    else v = i - 896;
    IDCT_LIMIT[i] = (uint8_t)v;
  }
  for (int i = 0; i < 768; i++) {
    int v = i - 256;
    CLAMP[i] = (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v);
  }
  done = 1;
}

static void idct_islow(const int *coef, uint8_t *out, int stride) {
  int64_t ws[64];
  for (int c = 0; c < 8; c++) {
    const int *in = coef + c;
    int64_t *w = ws + c;
    if (!in[8] && !in[16] && !in[24] && !in[32] && !in[40] && !in[48] &&
        !in[56]) {
      int64_t dc = (int64_t)in[0] * (1 << PASS1_BITS);
      for (int k = 0; k < 8; k++) w[8 * k] = dc;
      continue;
    }
    int64_t z1, z2, z3, z4, z5, tmp0, tmp1, tmp2, tmp3, tmp10, tmp11, tmp12,
        tmp13;
    z2 = in[16];
    z3 = in[48];
    z1 = (z2 + z3) * FIX_0_541196100;
    tmp2 = z1 + z3 * -FIX_1_847759065;
    tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = in[0];
    z3 = in[32];
    tmp0 = (z2 + z3) * (1 << CONST_BITS);
    tmp1 = (z2 - z3) * (1 << CONST_BITS);
    tmp10 = tmp0 + tmp3;
    tmp13 = tmp0 - tmp3;
    tmp11 = tmp1 + tmp2;
    tmp12 = tmp1 - tmp2;
    tmp0 = in[56];
    tmp1 = in[40];
    tmp2 = in[24];
    tmp3 = in[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    z4 = tmp1 + tmp3;
    z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    w[0] = DESCALE(tmp10 + tmp3, CONST_BITS - PASS1_BITS);
    w[56] = DESCALE(tmp10 - tmp3, CONST_BITS - PASS1_BITS);
    w[8] = DESCALE(tmp11 + tmp2, CONST_BITS - PASS1_BITS);
    w[48] = DESCALE(tmp11 - tmp2, CONST_BITS - PASS1_BITS);
    w[16] = DESCALE(tmp12 + tmp1, CONST_BITS - PASS1_BITS);
    w[40] = DESCALE(tmp12 - tmp1, CONST_BITS - PASS1_BITS);
    w[24] = DESCALE(tmp13 + tmp0, CONST_BITS - PASS1_BITS);
    w[32] = DESCALE(tmp13 - tmp0, CONST_BITS - PASS1_BITS);
  }
  for (int r = 0; r < 8; r++) {
    const int64_t *w = ws + 8 * r;
    uint8_t *o = out + r * stride;
    int64_t z1, z2, z3, z4, z5, tmp0, tmp1, tmp2, tmp3, tmp10, tmp11, tmp12,
        tmp13;
    z2 = w[2];
    z3 = w[6];
    z1 = (z2 + z3) * FIX_0_541196100;
    tmp2 = z1 + z3 * -FIX_1_847759065;
    tmp3 = z1 + z2 * FIX_0_765366865;
    tmp0 = (w[0] + w[4]) * (1 << CONST_BITS);
    tmp1 = (w[0] - w[4]) * (1 << CONST_BITS);
    tmp10 = tmp0 + tmp3;
    tmp13 = tmp0 - tmp3;
    tmp11 = tmp1 + tmp2;
    tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    z4 = tmp1 + tmp3;
    z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int n = CONST_BITS + PASS1_BITS + 3;
    o[0] = IDCT_LIMIT[(int)DESCALE(tmp10 + tmp3, n) & 1023];
    o[7] = IDCT_LIMIT[(int)DESCALE(tmp10 - tmp3, n) & 1023];
    o[1] = IDCT_LIMIT[(int)DESCALE(tmp11 + tmp2, n) & 1023];
    o[6] = IDCT_LIMIT[(int)DESCALE(tmp11 - tmp2, n) & 1023];
    o[2] = IDCT_LIMIT[(int)DESCALE(tmp12 + tmp1, n) & 1023];
    o[5] = IDCT_LIMIT[(int)DESCALE(tmp12 - tmp1, n) & 1023];
    o[3] = IDCT_LIMIT[(int)DESCALE(tmp13 + tmp0, n) & 1023];
    o[4] = IDCT_LIMIT[(int)DESCALE(tmp13 - tmp0, n) & 1023];
  }
}

static int u16(const uint8_t *p) { return (p[0] << 8) | p[1]; }

static int parse_frame(Jpeg *j, const uint8_t *p, int len) {
  if (j->have_frame) return fail(j, "JPEG with two frame headers");
  if (len < 6) return fail(j, "short SOF segment");
  if (p[0] != 8) {
    char msg[64];
    snprintf(msg, sizeof msg, "%d-bit JPEG samples", p[0]);
    return fail(j, msg);
  }
  j->h = u16(p + 1);
  j->w = u16(p + 3);
  j->nc = p[5];
  if (!j->w || !j->h) return fail(j, "JPEG with a zero dimension (DNL)");
  if (j->nc != 1 && j->nc != 3 && j->nc != 4) {
    char msg[64];
    snprintf(msg, sizeof msg, "%d-component JPEG", j->nc);
    return fail(j, msg);
  }
  if (len < 6 + 3 * j->nc) return fail(j, "short SOF segment");
  j->hmax = j->vmax = 1;
  for (int i = 0; i < j->nc; i++) {
    Comp *c = &j->comp[i];
    c->id = p[6 + 3 * i];
    c->h = p[7 + 3 * i] >> 4;
    c->v = p[7 + 3 * i] & 15;
    c->tq = p[8 + 3 * i] & 3;
    if (c->h < 1 || c->h > 4 || c->v < 1 || c->v > 4)
      return fail(j, "bad JPEG sampling factors");
    if (c->h > j->hmax) j->hmax = c->h;
    if (c->v > j->vmax) j->vmax = c->v;
  }
  /* a lossless data unit is one sample, a DCT one an 8x8 block */
  int unit = j->lossless ? 1 : 8;
  j->mcux = (j->w + unit * j->hmax - 1) / (unit * j->hmax);
  j->mcuy = (j->h + unit * j->vmax - 1) / (unit * j->vmax);
  for (int i = 0; i < j->nc; i++) {
    Comp *c = &j->comp[i];
    c->bw = j->mcux * c->h;
    c->bh = j->mcuy * c->v;
    c->dw = (int)(((long)j->w * c->h + j->hmax - 1) / j->hmax);
    c->dh = (int)(((long)j->h * c->v + j->vmax - 1) / j->vmax);
    c->stride = c->bw * unit;
    c->plane = calloc((size_t)c->stride * c->bh * unit, 1);
    if (!j->lossless)
      c->coef = calloc((size_t)c->bw * c->bh * 64, sizeof(int16_t));
    if (!c->plane || (!j->lossless && !c->coef))
      return fail(j, "out of memory");
  }
  j->have_frame = 1;
  return 0;
}

static int parse_dqt(Jpeg *j, const uint8_t *p, int len) {
  while (len > 0) {
    int pq = p[0] >> 4, tq = p[0] & 3;
    int n = pq ? 129 : 65;
    if (len < n) return fail(j, "short DQT segment");
    for (int i = 0; i < 64; i++)
      j->q[tq][ZIGZAG[i]] = pq ? u16(p + 1 + 2 * i) : p[1 + i];
    p += n;
    len -= n;
  }
  return 0;
}

static int parse_dht(Jpeg *j, const uint8_t *p, int len) {
  while (len > 0) {
    if (len < 17) return fail(j, "short DHT segment");
    int tc = p[0] >> 4, th = p[0] & 3, n = 0;
    Huff *t = tc ? &j->ac[th] : &j->dc[th];
    t->bits[0] = 0;
    for (int i = 1; i <= 16; i++) n += t->bits[i] = p[i];
    if (n > 256 || len < 17 + n) return fail(j, "bad DHT segment");
    memcpy(t->vals, p + 17, n);
    build_huff(t);
    p += 17 + n;
    len -= 17 + n;
  }
  return 0;
}

/* The scan's successive-approximation parameters (Ss..Se, Ah, Al) and
 * the EOB run that AC scans carry from block to block. */
typedef struct {
  int ss, se, ah, al, eobrun;
} Scan;

/* A sequential block (jdhuff.c decode_mcu): DC difference, then AC
 * run/size pairs up to EOB. */
static void block_seq(Jpeg *j, Bits *b, Comp *c, int16_t *blk) {
  int t = huff_decode(b, &j->dc[c->td]);
  c->pred += t ? extend(get_bits(b, t), t) : 0;
  blk[0] = (int16_t)c->pred;
  const Huff *ac = &j->ac[c->ta];
  for (int k = 1; k < 64; k++) {
    int rs = huff_decode(b, ac), r = rs >> 4, s = rs & 15;
    if (s) {
      k += r;
      blk[natural(k)] = (int16_t)extend(get_bits(b, s), s);
    } else {
      if (r != 15) break;
      k += 15;
    }
  }
}

/* jdphuff.c decode_mcu_DC_first and decode_mcu_DC_refine */
static void block_dc(Jpeg *j, Bits *b, Comp *c, int16_t *blk,
                     const Scan *sc) {
  if (sc->ah) {
    if (get_bits(b, 1)) blk[0] |= (int16_t)(1 << sc->al);
    return;
  }
  int t = huff_decode(b, &j->dc[c->td]);
  c->pred += t ? extend(get_bits(b, t), t) : 0;
  blk[0] = (int16_t)((unsigned)c->pred << sc->al);
}

/* jdphuff.c decode_mcu_AC_first: the band Ss..Se at point transform Al;
 * an EOBn symbol ends this block and the next EOBRUN - 1. */
static void block_ac_first(Jpeg *j, Bits *b, Comp *c, int16_t *blk,
                           Scan *sc) {
  if (sc->eobrun > 0) {
    sc->eobrun--;
    return;
  }
  const Huff *ac = &j->ac[c->ta];
  for (int k = sc->ss; k <= sc->se; k++) {
    int rs = huff_decode(b, ac), r = rs >> 4, s = rs & 15;
    if (s) {
      k += r;
      blk[natural(k)] = (int16_t)((unsigned)extend(get_bits(b, s), s)
                                  << sc->al);
    } else if (r == 15) {
      k += 15;
    } else {
      sc->eobrun = (1 << r) - 1 + (r ? get_bits(b, r) : 0);
      break;
    }
  }
}

/* One correction bit for a coefficient already nonzero: if set, and the
 * bit at p1 is not yet in the magnitude, move it away from zero by p1. */
static void refine_bit(Bits *b, int16_t *v, int p1) {
  if (get_bits(b, 1) && !(*v & p1)) *v += (int16_t)(*v >= 0 ? p1 : -p1);
}

/* jdphuff.c decode_mcu_AC_refine: correction bits for the band's nonzero
 * coefficients, and new coefficients of magnitude 1 << Al placed after
 * `r` zero-history coefficients; within an EOB run only correction bits
 * are read. */
static void block_ac_refine(Jpeg *j, Bits *b, Comp *c, int16_t *blk,
                            Scan *sc) {
  int p1 = 1 << sc->al, k = sc->ss;
  const Huff *ac = &j->ac[c->ta];
  if (sc->eobrun == 0) {
    for (; k <= sc->se; k++) {
      int rs = huff_decode(b, ac), r = rs >> 4, s = rs & 15;
      if (s) {
        s = get_bits(b, 1) ? p1 : -p1;
      } else if (r != 15) {
        sc->eobrun = (1 << r) + (r ? get_bits(b, r) : 0);
        break;
      }
      do {
        int16_t *v = blk + natural(k);
        if (*v) {
          refine_bit(b, v, p1);
        } else if (--r < 0) {
          break;
        }
        k++;
      } while (k <= sc->se);
      if (s) blk[natural(k)] = (int16_t)s;
    }
  }
  if (sc->eobrun > 0) {
    for (; k <= sc->se; k++) {
      int16_t *v = blk + natural(k);
      if (*v) refine_bit(b, v, p1);
    }
    sc->eobrun--;
  }
}

static void decode_block(Jpeg *j, Bits *b, Comp *c, int16_t *blk,
                         Scan *sc) {
  if (!j->progressive) block_seq(j, b, c, blk);
  else if (sc->ss == 0) block_dc(j, b, c, blk, sc);
  else if (sc->ah) block_ac_refine(j, b, c, blk, sc);
  else block_ac_first(j, b, c, blk, sc);
}

/* ------------------------------------------- JPEG: arithmetic decoding */

/* T.81 Table D.2: Qe, Next_Index_LPS, Next_Index_MPS, Switch_MPS; entry
 * 113 is jdarith.c's fixed probability 0.5 state, never updated. */
static const uint16_t QE[114][4] = {
    {0x5a1d, 1, 1, 1},     {0x2586, 14, 2, 0},    {0x1114, 16, 3, 0},
    {0x080b, 18, 4, 0},    {0x03d8, 20, 5, 0},    {0x01da, 23, 6, 0},
    {0x00e5, 25, 7, 0},    {0x006f, 28, 8, 0},    {0x0036, 30, 9, 0},
    {0x001a, 33, 10, 0},   {0x000d, 35, 11, 0},   {0x0006, 9, 12, 0},
    {0x0003, 10, 13, 0},   {0x0001, 12, 13, 0},   {0x5a7f, 15, 15, 1},
    {0x3f25, 36, 16, 0},   {0x2cf2, 38, 17, 0},   {0x207c, 39, 18, 0},
    {0x17b9, 40, 19, 0},   {0x1182, 42, 20, 0},   {0x0cef, 43, 21, 0},
    {0x09a1, 45, 22, 0},   {0x072f, 46, 23, 0},   {0x055c, 48, 24, 0},
    {0x0406, 49, 25, 0},   {0x0303, 51, 26, 0},   {0x0240, 52, 27, 0},
    {0x01b1, 54, 28, 0},   {0x0144, 56, 29, 0},   {0x00f5, 57, 30, 0},
    {0x00b7, 59, 31, 0},   {0x008a, 60, 32, 0},   {0x0068, 62, 33, 0},
    {0x004e, 63, 34, 0},   {0x003b, 32, 35, 0},   {0x002c, 33, 9, 0},
    {0x5ae1, 37, 37, 1},   {0x484c, 64, 38, 0},   {0x3a0d, 65, 39, 0},
    {0x2ef1, 67, 40, 0},   {0x261f, 68, 41, 0},   {0x1f33, 69, 42, 0},
    {0x19a8, 70, 43, 0},   {0x1518, 72, 44, 0},   {0x1177, 73, 45, 0},
    {0x0e74, 74, 46, 0},   {0x0bfb, 75, 47, 0},   {0x09f8, 77, 48, 0},
    {0x0861, 78, 49, 0},   {0x0706, 79, 50, 0},   {0x05cd, 48, 51, 0},
    {0x04de, 50, 52, 0},   {0x040f, 50, 53, 0},   {0x0363, 51, 54, 0},
    {0x02d4, 52, 55, 0},   {0x025c, 53, 56, 0},   {0x01f8, 54, 57, 0},
    {0x01a4, 55, 58, 0},   {0x0160, 56, 59, 0},   {0x0125, 57, 60, 0},
    {0x00f6, 58, 61, 0},   {0x00cb, 59, 62, 0},   {0x00ab, 61, 63, 0},
    {0x008f, 61, 32, 0},   {0x5b12, 65, 65, 1},   {0x4d04, 80, 66, 0},
    {0x412c, 81, 67, 0},   {0x37d8, 82, 68, 0},   {0x2fe8, 83, 69, 0},
    {0x293c, 84, 70, 0},   {0x2379, 86, 71, 0},   {0x1edf, 87, 72, 0},
    {0x1aa9, 87, 73, 0},   {0x174e, 72, 74, 0},   {0x1424, 72, 75, 0},
    {0x119c, 74, 76, 0},   {0x0f6b, 74, 77, 0},   {0x0d51, 75, 78, 0},
    {0x0bb6, 77, 79, 0},   {0x0a40, 77, 48, 0},   {0x5832, 80, 81, 1},
    {0x4d1c, 88, 82, 0},   {0x438e, 89, 83, 0},   {0x3bdd, 90, 84, 0},
    {0x34ee, 91, 85, 0},   {0x2eae, 92, 86, 0},   {0x299a, 93, 87, 0},
    {0x2516, 86, 71, 0},   {0x5570, 88, 89, 1},   {0x4ca9, 95, 90, 0},
    {0x44d9, 96, 91, 0},   {0x3e22, 97, 92, 0},   {0x3824, 99, 93, 0},
    {0x32b4, 99, 94, 0},   {0x2e17, 93, 86, 0},   {0x56a8, 95, 96, 1},
    {0x4f46, 101, 97, 0},  {0x47e5, 102, 98, 0},  {0x41cf, 103, 99, 0},
    {0x3c3d, 104, 100, 0}, {0x375e, 99, 93, 0},   {0x5231, 105, 102, 0},
    {0x4c0f, 106, 103, 0}, {0x4639, 107, 104, 0}, {0x415e, 103, 99, 0},
    {0x5627, 105, 106, 1}, {0x50e7, 108, 107, 0}, {0x4b85, 109, 103, 0},
    {0x5597, 110, 109, 0}, {0x504f, 111, 107, 0}, {0x5a10, 110, 111, 1},
    {0x5522, 112, 109, 0}, {0x59eb, 112, 111, 1}, {0x5a1d, 113, 113, 0}};

/* jdarith.c's decoder state: the C and A registers, the bit counter
 * (-16 before the first two bytes; -1 once a code went bad, after which
 * the scan's remaining blocks are left as they are), and the statistics
 * bins (bit 7 the MPS, bits 0-6 the state) of each table number. */
typedef struct {
  const uint8_t *p, *end;
  long c, a;
  int ct, marker;
  uint8_t dc_stats[16][64], ac_stats[16][256], fixed;
} Arith;

/* The next byte of entropy-coded data: a stuffed 0xFF 0x00 gives 0xFF;
 * from a marker on, zeros (T.81 D.2.6 and jdarith.c). */
static int arith_byte(Arith *d) {
  if (d->marker || d->p >= d->end) return 0;
  int data = *d->p++;
  if (data != 0xFF) return data;
  while (d->p < d->end && *d->p == 0xFF) d->p++;
  if (d->p < d->end && *d->p == 0) {
    d->p++;
    return 0xFF;
  }
  d->marker = 1;
  d->p--; /* left on the 0xFF before the marker code */
  return 0;
}

/* jdarith.c arith_decode: one binary decision in bin st (D.2.2-D.2.6,
 * with the estimation of Table D.2) */
static int arith_decode(Arith *d, uint8_t *st) {
  while (d->a < 0x8000) {
    if (--d->ct < 0) {
      d->c = (d->c << 8) | arith_byte(d);
      if ((d->ct += 8) < 0 && ++d->ct == 0) d->a = 0x8000;
    }
    d->a <<= 1;
  }
  int sv = *st;
  const uint16_t *q = QE[sv & 0x7F];
  long qe = q[0], temp = d->a - qe;
  int nl = q[1] | (q[3] << 7), nm = q[2];
  d->a = temp;
  temp <<= d->ct;
  if (d->c >= temp) {
    d->c -= temp;
    if (d->a < qe) {
      d->a = qe;
      *st = (uint8_t)((sv & 0x80) ^ nm);
    } else {
      d->a = qe;
      *st = (uint8_t)((sv & 0x80) ^ nl);
      sv ^= 0x80;
    }
  } else if (d->a < 0x8000) {
    if (d->a < qe) {
      *st = (uint8_t)((sv & 0x80) ^ nl);
      sv ^= 0x80;
    } else {
      *st = (uint8_t)((sv & 0x80) ^ nm);
    }
  }
  return sv >> 7;
}

/* Figures F.19-F.24: a DC difference in the component's conditioning
 * class, which it then updates (F.1.4.4.1.2 with DAC's L and U) */
static int arith_dc_diff(Jpeg *j, Arith *d, Comp *c) {
  uint8_t *stats = d->dc_stats[c->td], *st = stats + c->dc_context;
  if (!arith_decode(d, st)) {
    c->dc_context = 0;
    return 0;
  }
  int sign = arith_decode(d, st + 1), m, v;
  st += 2 + sign;
  if ((m = arith_decode(d, st)) != 0) {
    st = stats + 20;
    while (arith_decode(d, st)) {
      if ((m <<= 1) == 0x8000) {
        d->ct = -1; /* magnitude overflow */
        return 0;
      }
      st++;
    }
  }
  if (m < ((1 << j->dc_L[c->td]) >> 1)) c->dc_context = 0;
  else if (m > ((1 << j->dc_U[c->td]) >> 1)) c->dc_context = 12 + sign * 4;
  else c->dc_context = 4 + sign * 4;
  v = m;
  st += 14;
  while (m >>= 1)
    if (arith_decode(d, st)) v |= m;
  v += 1;
  return sign ? -v : v;
}

/* Figures F.21-F.24 for the nonzero AC coefficient at band index k, st
 * at its bin S0: the sign in the fixed bin, then the magnitude */
static int arith_ac_value(Arith *d, uint8_t *stats, uint8_t *st, int k,
                          int kx) {
  int sign = arith_decode(d, &d->fixed), m, v;
  st += 2;
  if ((m = arith_decode(d, st)) != 0 && arith_decode(d, st)) {
    m <<= 1;
    st = stats + (k <= kx ? 189 : 217);
    while (arith_decode(d, st)) {
      if ((m <<= 1) == 0x8000) {
        d->ct = -1; /* magnitude overflow */
        return 0;
      }
      st++;
    }
  }
  v = m;
  st += 14;
  while (m >>= 1)
    if (arith_decode(d, st)) v |= m;
  v += 1;
  return sign ? -v : v;
}

/* jdarith.c decode_mcu (sequential) and decode_mcu_DC_first: the DC
 * difference; then, sequential, the AC coefficients up to EOB */
static void ablock_seq(Jpeg *j, Arith *d, Comp *c, int16_t *blk,
                       const Scan *sc) {
  int diff = arith_dc_diff(j, d, c);
  if (d->ct == -1) return;
  c->pred = (c->pred + diff) & 0xffff;
  blk[0] = (int16_t)((unsigned)c->pred << sc->al);
  if (j->progressive) return;
  uint8_t *stats = d->ac_stats[c->ta];
  int k = 0;
  do {
    uint8_t *st = stats + 3 * k;
    if (arith_decode(d, st)) break; /* EOB */
    for (;;) {
      k++;
      if (arith_decode(d, st + 1)) break;
      st += 3;
      if (k >= 63) {
        d->ct = -1; /* spectral overflow */
        return;
      }
    }
    int v = arith_ac_value(d, stats, st, k, j->ac_K[c->ta]);
    if (d->ct == -1) return;
    blk[natural(k)] = (int16_t)v;
  } while (k < 63);
}

/* jdarith.c decode_mcu_AC_first: the band Ss..Se at point transform Al */
static void ablock_ac_first(Jpeg *j, Arith *d, Comp *c, int16_t *blk,
                            const Scan *sc) {
  uint8_t *stats = d->ac_stats[c->ta];
  for (int k = sc->ss; k <= sc->se; k++) {
    uint8_t *st = stats + 3 * (k - 1);
    if (arith_decode(d, st)) break; /* EOB */
    while (!arith_decode(d, st + 1)) {
      st += 3;
      if (++k > sc->se) {
        d->ct = -1; /* spectral overflow */
        return;
      }
    }
    int v = arith_ac_value(d, stats, st, k, j->ac_K[c->ta]);
    if (d->ct == -1) return;
    blk[natural(k)] = (int16_t)((unsigned)v << sc->al);
  }
}

/* jdarith.c decode_mcu_AC_refine: past the previous stage's last
 * nonzero coefficient an EOB decision comes first; a coefficient already
 * nonzero takes a correction bit, a new one +-(1 << Al) */
static void ablock_ac_refine(Arith *d, Comp *c, int16_t *blk,
                             const Scan *sc) {
  uint8_t *stats = d->ac_stats[c->ta];
  int p1 = 1 << sc->al, m1 = -p1, kex;
  for (kex = sc->se; kex > 0; kex--)
    if (blk[natural(kex)]) break;
  for (int k = sc->ss; k <= sc->se; k++) {
    uint8_t *st = stats + 3 * (k - 1);
    if (k > kex && arith_decode(d, st)) break; /* EOB */
    for (;;) {
      int16_t *v = blk + natural(k);
      if (*v) {
        if (arith_decode(d, st + 2)) *v += (int16_t)(*v < 0 ? m1 : p1);
        break;
      }
      if (arith_decode(d, st + 1)) {
        *v = (int16_t)(arith_decode(d, &d->fixed) ? m1 : p1);
        break;
      }
      st += 3;
      if (++k > sc->se) {
        d->ct = -1; /* spectral overflow */
        return;
      }
    }
  }
}

static void arith_block(Jpeg *j, Arith *d, Comp *c, int16_t *blk,
                        const Scan *sc) {
  if (d->ct == -1) return;
  if (!j->progressive || (sc->ss == 0 && !sc->ah))
    ablock_seq(j, d, c, blk, sc);
  else if (sc->ss == 0) {
    if (arith_decode(d, &d->fixed)) blk[0] |= (int16_t)(1 << sc->al);
  } else if (sc->ah) {
    ablock_ac_refine(d, c, blk, sc);
  } else {
    ablock_ac_first(j, d, c, blk, sc);
  }
}

/* jdarith.c start_pass and process_restart: the scan's statistics bins
 * cleared, DC predictions and contexts zeroed, the registers reset */
static void arith_reset(Jpeg *j, Arith *d, Comp **sc, int ns,
                        const Scan *scan) {
  for (int i = 0; i < ns; i++) {
    if (!j->progressive || (scan->ss == 0 && scan->ah == 0)) {
      memset(d->dc_stats[sc[i]->td], 0, 64);
      sc[i]->pred = 0;
      sc[i]->dc_context = 0;
    }
    if (!j->progressive || scan->ss)
      memset(d->ac_stats[sc[i]->ta], 0, 256);
  }
  d->c = 0;
  d->a = 0;
  d->ct = -16;
  d->marker = 0;
}

/* Find the next marker at or after p (skipping fill bytes). */
static const uint8_t *next_marker(const uint8_t *p, const uint8_t *end) {
  while (p + 1 < end) {
    if (p[0] == 0xFF && p[1] != 0 && p[1] != 0xFF) return p;
    p++;
  }
  return end;
}

/* Past the restart marker that ends an interval (jdmarker.c
 * read_restart_marker: any data left before it is skipped). */
static const uint8_t *past_restart(const uint8_t *p, const uint8_t *end) {
  const uint8_t *m = next_marker(p, end);
  if (m + 1 < end && m[1] >= 0xD0 && m[1] <= 0xD7) m += 2;
  return m;
}

/* The lossless predictor of H.1.2.1 (jdlossls.c): on the first row of
 * the scan or of a restart interval the left neighbour, 2^(P - Pt - 1)
 * in the first column; elsewhere the one above in the first column and
 * predictor `sel` of a (left), b (above) and c (above left). */
static int lossless_predict(const int *cur, const int *prev, int x,
                            int first, int sel, int init) {
  if (first) return x ? cur[x - 1] : init;
  int b = prev[x];
  if (!x) return b;
  int a = cur[x - 1], c = prev[x - 1];
  switch (sel) {
    case 1: return a;
    case 2: return b;
    case 3: return c;
    case 4: return a + b - c;
    case 5: return a + ((b - c) >> 1);
    case 6: return b + ((a - c) >> 1);
    default: return (a + b) >> 1;
  }
}

/* jdlhuff.c decode_mcus, jddiffct.c and jdlossls.c: one lossless scan.
 * Each sample's Huffman-coded difference (category 16: 32768) lands at
 * its MCU position; then each component's rows are undifferenced
 * (modulo 2^16) over its downsampled width, the predictors restarting
 * with every restart interval, and scaled up by the point transform. */
static const uint8_t *decode_lossless_scan(Jpeg *j, Comp **sc, int ns,
                                           const Scan *scan,
                                           const uint8_t *p,
                                           const uint8_t *end) {
  long per_row = ns == 1 ? sc[0]->dw : j->mcux;
  long rows = ns == 1 ? sc[0]->dh : j->mcuy;
  int sel = scan->ss, pt = scan->al;
  if (sel < 1 || sel > 7 || scan->se || scan->ah || pt > 7) {
    fail(j, "bad lossless scan parameters");
    return NULL;
  }
  if (j->restart % per_row) {
    char msg[128];
    snprintf(msg, sizeof msg, "lossless JPEG with a restart interval of %d "
             "MCUs, not whole MCU rows of %ld", j->restart, per_row);
    fail(j, msg);
    return NULL;
  }
  int *diff[4] = {0}, *rowbuf = NULL, ok = 1;
  for (int i = 0; i < ns; i++) {
    if (sc[i]->td > 3 || !j->dc[sc[i]->td].defined) {
      fail(j, "scan uses an undefined Huffman table");
      ok = 0;
    } else if (!(diff[i] = calloc((size_t)sc[i]->bw * sc[i]->bh,
                                  sizeof(int)))) {
      fail(j, "out of memory");
      ok = 0;
    }
  }
  Bits b = {p, end, 0, 0, 0};
  for (long u = 0; ok && u < per_row * rows; u++) {
    if (j->restart && u && u % j->restart == 0) {
      b.p = past_restart(b.p, end);
      b.buf = 0;
      b.cnt = 0;
      b.marker = 0;
    }
    long mx = u % per_row, my = u / per_row;
    for (int i = 0; i < ns; i++) {
      Comp *c = sc[i];
      int hh = ns == 1 ? 1 : c->h, vv = ns == 1 ? 1 : c->v;
      for (int v = 0; v < vv; v++)
        for (int h = 0; h < hh; h++) {
          int s = huff_decode(&b, &j->dc[c->td]);
          int d = s == 16 ? 32768 : s ? extend(get_bits(&b, s), s) : 0;
          diff[i][(my * vv + v) * c->bw + mx * hh + h] = d;
        }
    }
  }
  long interval_rows = j->restart ? j->restart / per_row : 0;
  for (int i = 0; ok && i < ns; i++) {
    Comp *c = sc[i];
    long vrows = ns == 1 ? 1 : c->v;
    rowbuf = realloc(rowbuf, sizeof(int) * 2 * (size_t)c->dw);
    if (!rowbuf) {
      fail(j, "out of memory");
      ok = 0;
      break;
    }
    int *cur = rowbuf, *prev = rowbuf + c->dw;
    for (long y = 0; y < c->dh; y++) {
      int first = y == 0 || (interval_rows &&
                             y % (interval_rows * vrows) == 0);
      const int *dr = diff[i] + y * c->bw;
      uint8_t *o = c->plane + y * c->stride;
      for (int x = 0; x < c->dw; x++) {
        cur[x] = (dr[x] + lossless_predict(cur, prev, x, first, sel,
                                           1 << (7 - pt))) & 0xFFFF;
        o[x] = (uint8_t)(cur[x] << pt);
      }
      int *t = cur;
      cur = prev;
      prev = t;
    }
  }
  free(rowbuf);
  for (int i = 0; i < ns; i++) free(diff[i]);
  return ok ? next_marker(b.p, end) : NULL;
}

static const uint8_t *decode_scan(Jpeg *j, const uint8_t *p, int len,
                                  const uint8_t *end) {
  int ns = p[0];
  Comp *sc[4];
  if (ns < 1 || ns > 4 || len < 4 + 2 * ns) {
    fail(j, "bad SOS segment");
    return NULL;
  }
  Scan scan = {p[1 + 2 * ns], p[2 + 2 * ns], p[3 + 2 * ns] >> 4,
               p[3 + 2 * ns] & 15, 0};
  int dc_scan = !j->progressive || scan.ss == 0;
  int ac_scan = !j->progressive || scan.ss > 0;
  if (j->progressive &&
      (scan.se > 63 || scan.al > 13 || (scan.ss == 0 && scan.se != 0) ||
       (scan.ss > 0 && (scan.se < scan.ss || ns != 1)))) {
    fail(j, "bad progressive scan parameters");
    return NULL;
  }
  int mcu_blocks = 0;
  for (int i = 0; i < ns; i++) {
    int id = p[1 + 2 * i], k;
    for (k = 0; k < j->nc && j->comp[k].id != id; k++) {
    }
    if (k == j->nc) {
      fail(j, "SOS names an unknown component");
      return NULL;
    }
    sc[i] = &j->comp[k];
    mcu_blocks += sc[i]->h * sc[i]->v;
    if (ns > 1 && mcu_blocks > 10) { /* jdinput.c D_MAX_BLOCKS_IN_MCU */
      fail(j, "JPEG scan of more than 10 blocks an MCU");
      return NULL;
    }
    sc[i]->td = p[2 + 2 * i] >> 4;
    sc[i]->ta = p[2 + 2 * i] & 15;
    sc[i]->pred = 0;
    if (j->lossless) continue;
    if (!sc[i]->latched) {
      memcpy(sc[i]->q, j->q[sc[i]->tq], sizeof sc[i]->q);
      sc[i]->latched = 1;
    }
    int need_dc = dc_scan && !(j->progressive && scan.ah);
    if (!j->arith && (sc[i]->td > 3 || sc[i]->ta > 3 ||
                      (need_dc && !j->dc[sc[i]->td].defined) ||
                      (ac_scan && !j->ac[sc[i]->ta].defined))) {
      fail(j, "scan uses an undefined Huffman table");
      return NULL;
    }
  }
  if (j->lossless) return decode_lossless_scan(j, sc, ns, &scan, p + len, end);
  Bits b = {p + len, end, 0, 0, 0};
  Arith d;
  if (j->arith) {
    d.p = p + len;
    d.end = end;
    d.fixed = 113;
    arith_reset(j, &d, sc, ns, &scan);
  }
  long units, ux;
  if (ns == 1) {
    Comp *c = sc[0];
    ux = (c->dw + 7) / 8;
    units = ux * ((c->dh + 7) / 8);
  } else {
    ux = j->mcux;
    units = (long)j->mcux * j->mcuy;
  }
  for (long u = 0; u < units; u++) {
    if (j->restart && u && u % j->restart == 0) {
      if (j->arith) {
        d.p = past_restart(d.p, end);
        arith_reset(j, &d, sc, ns, &scan);
      } else {
        b.p = past_restart(b.p, end);
        b.buf = 0;
        b.cnt = 0;
        b.marker = 0;
        scan.eobrun = 0;
        for (int i = 0; i < ns; i++) sc[i]->pred = 0;
      }
    }
    long mx = u % ux, my = u / ux;
    for (int i = 0; i < ns; i++) {
      Comp *c = sc[i];
      int hh = ns == 1 ? 1 : c->h, vv = ns == 1 ? 1 : c->v;
      for (int v = 0; v < vv; v++)
        for (int h = 0; h < hh; h++) {
          long by = my * vv + v, bx = mx * hh + h;
          int16_t *blk = c->coef + (by * c->bw + bx) * 64;
          if (j->arith) arith_block(j, &d, c, blk, &scan);
          else decode_block(j, &b, c, blk, &scan);
        }
    }
  }
  return next_marker(j->arith ? d.p : b.p, end);
}

/* Every block of every component, dequantised and through the IDCT into
 * its sample plane. */
static void idct_planes(Jpeg *j) {
  int coef[64];
  for (int i = 0; i < j->nc; i++) {
    Comp *c = &j->comp[i];
    int stride = c->bw * 8;
    for (long by = 0; by < c->bh; by++)
      for (long bx = 0; bx < c->bw; bx++) {
        const int16_t *blk = c->coef + (by * c->bw + bx) * 64;
        for (int k = 0; k < 64; k++) coef[k] = blk[k] * c->q[k];
        idct_islow(coef, c->plane + by * 8 * stride + bx * 8, stride);
      }
  }
}

/* Parse up to the first SOS (header only) or through EOI (decode). */
static int run(Jpeg *j, const uint8_t *data, size_t size, int decode) {
  const uint8_t *p = data, *end = data + size;
  init_tables();
  if (size < 4 || p[0] != 0xFF || p[1] != 0xD8) return fail(j, "not a JPEG");
  p += 2;
  for (int t = 0; t < 16; t++) { /* jdmarker.c's DAC defaults */
    j->dc_L[t] = 0;
    j->dc_U[t] = 1;
    j->ac_K[t] = 5;
  }
  while (p < end) {
    p = next_marker(p, end);
    if (p + 1 >= end) break;
    int m = p[1];
    p += 2;
    if (m == 0xD9) break;                       /* EOI */
    if (m >= 0xD0 && m <= 0xD7) continue;       /* stray RST */
    if (p + 2 > end) return fail(j, "truncated JPEG");
    int len = u16(p) - 2;
    const uint8_t *seg = p + 2;
    if (seg + len > end) return fail(j, "truncated JPEG segment");
    p = seg + len;
    switch (m) {
      case 0xC0:
      case 0xC1:
      case 0xC2:
      case 0xC3:
      case 0xC9:
      case 0xCA:
        j->progressive = m == 0xC2 || m == 0xCA;
        j->arith = m >= 0xC9;
        j->lossless = m == 0xC3;
        if (parse_frame(j, seg, len)) return -1;
        break;
      case 0xCB: /* libjpeg-turbo has no arithmetic lossless decoder */
        return fail(j, "arithmetic-coded lossless JPEG");
      case 0xC5:
      case 0xC6:
      case 0xC7:
      case 0xCD:
      case 0xCE:
      case 0xCF:
        return fail(j, "hierarchical JPEG");
      case 0xC4:
        if (parse_dht(j, seg, len)) return -1;
        break;
      case 0xCC: /* DAC: jdmarker.c get_dac */
        for (int i = 0; i + 1 < len; i += 2) {
          int tb = seg[i], val = seg[i + 1];
          if (tb >= 32) return fail(j, "bad DAC segment");
          if (tb >= 16) {
            j->ac_K[tb - 16] = (uint8_t)val;
          } else {
            j->dc_L[tb] = (uint8_t)(val & 15);
            j->dc_U[tb] = (uint8_t)(val >> 4);
            if (j->dc_L[tb] > j->dc_U[tb]) return fail(j, "bad DAC segment");
          }
        }
        break;
      case 0xDB:
        if (parse_dqt(j, seg, len)) return -1;
        break;
      case 0xDD:
        if (len < 2) return fail(j, "short DRI segment");
        j->restart = u16(seg);
        break;
      /* jdmarker.c examine_app0 / examine_app14: a JFIF APP0 of 14 bytes
       * or more, an Adobe APP14 of 12 or more; only those before the
       * first scan count (jpeg_read_header fixes the colour space) */
      case 0xE0:
        if (!j->scans && len >= 14 && !memcmp(seg, "JFIF", 5)) j->jfif = 1;
        break;
      case 0xEE:
        if (!j->scans && len >= 12 && !memcmp(seg, "Adobe", 5)) {
          j->adobe = 1;
          j->adobe_transform = seg[11];
        }
        break;
      case 0xDA:
        if (!j->have_frame) return fail(j, "SOS before SOF");
        if (!decode) return 0;
        p = decode_scan(j, seg, len, end);
        if (!p) return -1;
        j->scans++;
        break;
      default:
        break; /* APPn, COM, DNL... */
    }
  }
  if (!j->have_frame) return fail(j, "JPEG without a frame header");
  if (decode && !j->scans) return fail(j, "JPEG without a scan");
  if (decode && !j->lossless) idct_planes(j);
  return 0;
}

static void free_jpeg(Jpeg *j) {
  for (int i = 0; i < 4; i++) {
    free(j->comp[i].plane);
    free(j->comp[i].coef);
  }
}

/* jdsample.c's upsamplers on one component, into a w x h plane: the
 * "fancy" triangle filters for 2h1v and 2h2v chroma more than 2 samples
 * wide and for 1h2v (4:4:0) chroma of any width; replication for every
 * other integral ratio, and for all of them in lossless files (whose
 * data unit of one sample turns fancy upsampling off).  Rows past the
 * component's last real row, and the row above its first, repeat the
 * nearest real row (jdmainct.c's context rows). */
static int upsample(const Jpeg *j, const Comp *c, uint8_t *out) {
  int W = j->w, H = j->h, sx = j->hmax / c->h, sy = j->vmax / c->v;
  int stride = c->stride, dw = c->dw, dh = c->dh, fancy = !j->lossless;
  if (j->hmax % c->h || j->vmax % c->v)
    return -1;
  uint8_t *row = malloc((size_t)dw * 2 + 16);
  int *cs = malloc(sizeof(int) * (dw + 2));
  if (!row || !cs) {
    free(row);
    free(cs);
    return -1;
  }
  for (int y = 0; y < H; y++) {
    uint8_t *o = out + (size_t)y * W;
    /* the nearest input row and the next nearest (above for an even
       output row, below for an odd one), clamped to the real rows */
    int iy = y >> 1, ny = (y & 1) ? iy + 1 : iy - 1;
    if (iy > dh - 1) iy = dh - 1;
    if (ny < 0) ny = 0;
    if (ny > dh - 1) ny = dh - 1;
    if (sx == 1 && sy == 1) {
      memcpy(o, c->plane + (size_t)y * stride, W);
    } else if (fancy && sx == 2 && sy == 1 && dw > 2) {
      const uint8_t *in = c->plane + (size_t)y * stride;
      row[0] = in[0];
      row[1] = (uint8_t)((in[0] * 3 + in[1] + 2) >> 2);
      for (int i = 1; i < dw - 1; i++) {
        int v = in[i] * 3;
        row[2 * i] = (uint8_t)((v + in[i - 1] + 1) >> 2);
        row[2 * i + 1] = (uint8_t)((v + in[i + 1] + 2) >> 2);
      }
      row[2 * dw - 2] = (uint8_t)((in[dw - 1] * 3 + in[dw - 2] + 1) >> 2);
      row[2 * dw - 1] = in[dw - 1];
      memcpy(o, row, W);
    } else if (fancy && sx == 1 && sy == 2) {
      /* h1v2_fancy_upsample: 3/4 nearest + 1/4 next nearest, bias 1
         above and 2 below */
      const uint8_t *i0 = c->plane + (size_t)iy * stride;
      const uint8_t *i1 = c->plane + (size_t)ny * stride;
      int bias = (y & 1) ? 2 : 1;
      for (int x = 0; x < W; x++)
        o[x] = (uint8_t)((i0[x] * 3 + i1[x] + bias) >> 2);
    } else if (fancy && sx == 2 && sy == 2 && dw > 2) {
      const uint8_t *i0 = c->plane + (size_t)iy * stride;
      const uint8_t *i1 = c->plane + (size_t)ny * stride;
      for (int i = 0; i < dw; i++) cs[i] = i0[i] * 3 + i1[i];
      row[0] = (uint8_t)((cs[0] * 4 + 8) >> 4);
      row[1] = (uint8_t)((cs[0] * 3 + cs[1] + 7) >> 4);
      for (int i = 1; i < dw - 1; i++) {
        row[2 * i] = (uint8_t)((cs[i] * 3 + cs[i - 1] + 8) >> 4);
        row[2 * i + 1] = (uint8_t)((cs[i] * 3 + cs[i + 1] + 7) >> 4);
      }
      row[2 * dw - 2] = (uint8_t)((cs[dw - 1] * 3 + cs[dw - 2] + 8) >> 4);
      row[2 * dw - 1] = (uint8_t)((cs[dw - 1] * 4 + 7) >> 4);
      memcpy(o, row, W);
    } else {
      /* replication (jdsample.c's int_upsample, and h2v1 / h2v2 on
         narrow components or without fancy upsampling) */
      int ry = y / sy;
      if (ry > dh - 1) ry = dh - 1;
      const uint8_t *in = c->plane + (size_t)ry * stride;
      for (int x = 0; x < W; x++) o[x] = in[x / sx];
    }
  }
  free(row);
  free(cs);
  return 0;
}

/* Returns 0 and the image's width, height and component count (1, 3 or
 * 4), or -1 with a message in err. */
int jpeg_info(const uint8_t *data, size_t size, int *w, int *h, int *nc,
              char *err, int errlen) {
  Jpeg j;
  memset(&j, 0, sizeof j);
  j.err = err;
  j.errlen = errlen;
  int rc = run(&j, data, size, 0);
  free_jpeg(&j);
  if (rc) return -1;
  *w = j.w;
  *h = j.h;
  *nc = j.nc;
  return 0;
}

/* jdapimin.c default_decompress_parms: whether three components hold
 * YCbCr.  A JFIF marker means YCbCr; otherwise an Adobe marker's
 * transform 0 means RGB and any other YCbCr; otherwise component ids 1,
 * 2, 3 mean YCbCr and 'R', 'G', 'B' RGB, and other ids YCbCr (RGB in a
 * lossless file). */
static int is_ycc(const Jpeg *j) {
  if (j->jfif) return 1;
  if (j->adobe) return j->adobe_transform != 0;
  int c0 = j->comp[0].id, c1 = j->comp[1].id, c2 = j->comp[2].id;
  if (c0 == 1 && c1 == 2 && c2 == 3) return !j->lossless;
  if (c0 == 'R' && c1 == 'G' && c2 == 'B') return 0;
  return !j->lossless;
}

/* jdcolor.c: SCALEBITS 16, tables over x = sample - 128 */
static int CR_R[256], CB_B[256];
static int64_t CR_G[256], CB_G[256];

static void init_ycc_tables(void) {
  static int init = 0;
  if (init) return;
  const int64_t one_half = (int64_t)1 << 15;
  const int64_t f1402 = (int64_t)(1.40200 * 65536 + 0.5);
  const int64_t f1772 = (int64_t)(1.77200 * 65536 + 0.5);
  const int64_t f0714 = (int64_t)(0.71414 * 65536 + 0.5);
  const int64_t f0344 = (int64_t)(0.34414 * 65536 + 0.5);
  for (int i = 0; i < 256; i++) {
    int64_t x = i - 128;
    CR_R[i] = (int)((f1402 * x + one_half) >> 16);
    CB_B[i] = (int)((f1772 * x + one_half) >> 16);
    CR_G[i] = -f0714 * x;
    CB_G[i] = -f0344 * x + one_half;
  }
  init = 1;
}

/* Decodes into out (h x w x nc uint8, nc from jpeg_info): gray for one
 * component; RGB for three (YCbCr converted as is_ycc says; a lossless
 * file in YCbCr is refused, as libjpeg-turbo does no colour conversion
 * in lossless mode); for four, the CMYK samples as Pillow gives them,
 * inverted (its "CMYK;I" rawmode, Adobe's convention), YCCK (Adobe
 * transform other than 0) converted to CMYK first (jdcolor.c
 * ycck_cmyk_convert: C, M, Y = 255 - R, G, B of the YCbCr part, K as
 * stored). */
int jpeg_decode(const uint8_t *data, size_t size, uint8_t *out, char *err,
                int errlen) {
  Jpeg j;
  memset(&j, 0, sizeof j);
  j.err = err;
  j.errlen = errlen;
  if (run(&j, data, size, 1)) {
    free_jpeg(&j);
    return -1;
  }
  size_t n = (size_t)j.w * j.h;
  int nc = j.nc;
  if (nc == 1) {
    for (int y = 0; y < j.h; y++)
      memcpy(out + (size_t)y * j.w, j.comp[0].plane + (size_t)y *
             j.comp[0].stride, j.w);
    free_jpeg(&j);
    return 0;
  }
  /* 4 components: YCCK unless an Adobe marker says transform 0 or there
     is none (jdapimin.c) */
  int ycc = nc == 3 ? is_ycc(&j) : (j.adobe && j.adobe_transform != 0);
  if (ycc && j.lossless) {
    free_jpeg(&j);
    return fail(&j, nc == 3 ? "lossless JPEG in YCbCr (no colour "
                              "conversion in lossless mode)"
                            : "lossless JPEG in YCCK (no colour "
                              "conversion in lossless mode)");
  }
  uint8_t *full = malloc(n * nc);
  if (!full) {
    free_jpeg(&j);
    return fail(&j, "out of memory");
  }
  for (int i = 0; i < nc; i++)
    if (upsample(&j, &j.comp[i], full + i * n)) {
      free(full);
      free_jpeg(&j);
      return fail(&j, "unsupported JPEG sampling factors");
    }
  init_ycc_tables();
  const uint8_t *c0 = full, *c1 = full + n, *c2 = full + 2 * n;
  if (nc == 3 && !ycc) {
    for (size_t i = 0; i < n; i++) {
      out[3 * i] = c0[i];
      out[3 * i + 1] = c1[i];
      out[3 * i + 2] = c2[i];
    }
  } else if (nc == 3) {
    for (size_t i = 0; i < n; i++) {
      int y = c0[i], cb = c1[i], cr = c2[i];
      out[3 * i] = CLAMP[256 + y + CR_R[cr]];
      out[3 * i + 1] = CLAMP[256 + y + (int)((CB_G[cb] + CR_G[cr]) >> 16)];
      out[3 * i + 2] = CLAMP[256 + y + CB_B[cb]];
    }
  } else {
    /* CMYK inverted, as Pillow reads it.  YCCK's C, M, Y are
       range_limit[255 - (y + ...)], 255 minus the clamped R, G, B, so
       inverted they are R, G, B. */
    const uint8_t *c3 = full + 3 * n;
    for (size_t i = 0; i < n; i++) {
      if (ycc) {
        int y = c0[i], cb = c1[i], cr = c2[i];
        out[4 * i] = CLAMP[256 + y + CR_R[cr]];
        out[4 * i + 1] =
            CLAMP[256 + y + (int)((CB_G[cb] + CR_G[cr]) >> 16)];
        out[4 * i + 2] = CLAMP[256 + y + CB_B[cb]];
      } else {
        out[4 * i] = (uint8_t)(255 - c0[i]);
        out[4 * i + 1] = (uint8_t)(255 - c1[i]);
        out[4 * i + 2] = (uint8_t)(255 - c2[i]);
      }
      out[4 * i + 3] = (uint8_t)(255 - c3[i]);
    }
  }
  free(full);
  free_jpeg(&j);
  return 0;
}

/* ----------------------------------------------------- JPEG: encoding */

static const uint8_t STD_LUMA_Q[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
static const uint8_t STD_CHROMA_Q[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

static const uint8_t DC_L_BITS[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1,
                                      1, 0, 0, 0, 0, 0, 0, 0};
static const uint8_t DC_L_VALS[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
static const uint8_t DC_C_BITS[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1,
                                      1, 1, 1, 0, 0, 0, 0, 0};
static const uint8_t DC_C_VALS[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
static const uint8_t AC_L_BITS[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3,
                                      5, 5, 4, 4, 0, 0, 1, 0x7d};
static const uint8_t AC_L_VALS[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
static const uint8_t AC_C_BITS[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4,
                                      7, 5, 4, 4, 0, 1, 2, 0x77};
static const uint8_t AC_C_VALS[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

typedef struct {
  uint16_t code[256];
  uint8_t len[256];
} Codes;

typedef struct {
  uint8_t *out;
  size_t n, cap;
  uint32_t buf;
  int cnt, overflow;
} Writer;

static void put_byte(Writer *w, int b) {
  if (w->n < w->cap) w->out[w->n++] = (uint8_t)b;
  else w->overflow = 1;
}

static void put_bits(Writer *w, uint32_t v, int n) {
  for (int i = n - 1; i >= 0; i--) {
    w->buf = (w->buf << 1) | ((v >> i) & 1);
    if (++w->cnt == 8) {
      put_byte(w, w->buf);
      if (w->buf == 0xFF) put_byte(w, 0);
      w->buf = 0;
      w->cnt = 0;
    }
  }
}

static void make_codes(const uint8_t *bits, const uint8_t *vals,
                       Codes *c) {
  int code = 0, k = 0;
  memset(c, 0, sizeof *c);
  for (int l = 1; l <= 16; l++) {
    for (int i = 0; i < bits[l]; i++, k++) {
      c->code[vals[k]] = (uint16_t)code++;
      c->len[vals[k]] = (uint8_t)l;
    }
    code <<= 1;
  }
}

static void put_marker_seg(Writer *w, int m, const uint8_t *seg, int len) {
  put_byte(w, 0xFF);
  put_byte(w, m);
  put_byte(w, (len + 2) >> 8);
  put_byte(w, (len + 2) & 255);
  for (int i = 0; i < len; i++) put_byte(w, seg[i]);
}

static void put_dht(Writer *w, int cls, int id, const uint8_t *bits,
                    const uint8_t *vals) {
  uint8_t seg[17 + 256];
  int n = 0;
  seg[0] = (uint8_t)((cls << 4) | id);
  for (int i = 1; i <= 16; i++) n += seg[i] = bits[i];
  memcpy(seg + 17, vals, n);
  put_marker_seg(w, 0xC4, seg, 17 + n);
}

static int nbits(int v) {
  int n = 0;
  v = abs(v);
  while (v) {
    n++;
    v >>= 1;
  }
  return n;
}

static void encode_block(Writer *w, const float *blk, const uint8_t *qzig,
                         int *pred, const Codes *dc, const Codes *ac) {
  static float cosv[8][8];
  static int init = 0;
  if (!init) {
    for (int x = 0; x < 8; x++)
      for (int u = 0; u < 8; u++)
        cosv[x][u] = (float)(cos((2 * x + 1) * u * 3.14159265358979323846 / 16) *
                             (u ? 0.5 : 0.5 / sqrt(2.0)));
    init = 1;
  }
  float tmp[64], F[64];
  for (int y = 0; y < 8; y++)
    for (int u = 0; u < 8; u++) {
      float s = 0;
      for (int x = 0; x < 8; x++) s += blk[y * 8 + x] * cosv[x][u];
      tmp[y * 8 + u] = s;
    }
  for (int v = 0; v < 8; v++)
    for (int u = 0; u < 8; u++) {
      float s = 0;
      for (int y = 0; y < 8; y++) s += tmp[y * 8 + u] * cosv[y][v];
      F[v * 8 + u] = s;
    }
  int q[64];
  for (int k = 0; k < 64; k++) {
    float v = F[ZIGZAG[k]] / qzig[k];
    q[k] = (int)lrintf(v);
  }
  int diff = q[0] - *pred;
  *pred = q[0];
  int s = nbits(diff);
  put_bits(w, dc->code[s], dc->len[s]);
  if (s) put_bits(w, diff < 0 ? diff + (1 << s) - 1 : diff, s);
  int run = 0;
  for (int k = 1; k < 64; k++) {
    if (!q[k]) {
      run++;
      continue;
    }
    while (run > 15) {
      put_bits(w, ac->code[0xF0], ac->len[0xF0]);
      run -= 16;
    }
    s = nbits(q[k]);
    int rs = (run << 4) | s;
    put_bits(w, ac->code[rs], ac->len[rs]);
    put_bits(w, q[k] < 0 ? q[k] + (1 << s) - 1 : q[k], s);
    run = 0;
  }
  if (run) put_bits(w, ac->code[0], ac->len[0]);
}

static void scale_q(const uint8_t *base, int quality, uint8_t *qzig) {
  if (quality < 1) quality = 1;
  if (quality > 100) quality = 100;
  int scale = quality < 50 ? 5000 / quality : 200 - 2 * quality;
  for (int k = 0; k < 64; k++) {
    int v = (base[ZIGZAG[k]] * scale + 50) / 100;
    qzig[k] = (uint8_t)(v < 1 ? 1 : v > 255 ? 255 : v);
  }
}

/* Encodes an h x w x nc uint8 image (nc 3: RGB, written as 4:2:0 YCbCr;
 * nc 1: gray) into out.  Returns the byte count, or 0 if cap is too
 * small. */
size_t jpeg_encode(const uint8_t *img, int w, int h, int nc, int quality,
                   uint8_t *out, size_t cap) {
  Writer wr = {out, 0, cap, 0, 0, 0};
  uint8_t ql[64], qc[64];
  scale_q(STD_LUMA_Q, quality, ql);
  scale_q(STD_CHROMA_Q, quality, qc);
  Codes dcl, dcc, acl, acc;
  make_codes(DC_L_BITS, DC_L_VALS, &dcl);
  make_codes(DC_C_BITS, DC_C_VALS, &dcc);
  make_codes(AC_L_BITS, AC_L_VALS, &acl);
  make_codes(AC_C_BITS, AC_C_VALS, &acc);

  put_byte(&wr, 0xFF);
  put_byte(&wr, 0xD8);
  static const uint8_t jfif[14] = {'J', 'F', 'I', 'F', 0, 1, 1, 0,
                                   0,   1,   0,   1,   0, 0};
  put_marker_seg(&wr, 0xE0, jfif, 14);
  uint8_t dqt[65];
  dqt[0] = 0;
  memcpy(dqt + 1, ql, 64);
  put_marker_seg(&wr, 0xDB, dqt, 65);
  if (nc == 3) {
    dqt[0] = 1;
    memcpy(dqt + 1, qc, 64);
    put_marker_seg(&wr, 0xDB, dqt, 65);
  }
  uint8_t sof[15] = {8, (uint8_t)(h >> 8), (uint8_t)h, (uint8_t)(w >> 8),
                     (uint8_t)w, (uint8_t)nc};
  if (nc == 3) {
    uint8_t c[9] = {1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1};
    memcpy(sof + 6, c, 9);
  } else {
    uint8_t c[3] = {1, 0x11, 0};
    memcpy(sof + 6, c, 3);
  }
  put_marker_seg(&wr, 0xC0, sof, 6 + 3 * nc);
  put_dht(&wr, 0, 0, DC_L_BITS, DC_L_VALS);
  put_dht(&wr, 1, 0, AC_L_BITS, AC_L_VALS);
  if (nc == 3) {
    put_dht(&wr, 0, 1, DC_C_BITS, DC_C_VALS);
    put_dht(&wr, 1, 1, AC_C_BITS, AC_C_VALS);
    uint8_t sos[10] = {3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0};
    put_marker_seg(&wr, 0xDA, sos, 10);
  } else {
    uint8_t sos[6] = {1, 1, 0x00, 0, 63, 0};
    put_marker_seg(&wr, 0xDA, sos, 6);
  }

  int m = nc == 3 ? 16 : 8;
  int mx = (w + m - 1) / m, my = (h + m - 1) / m;
  int pred[3] = {0, 0, 0};
  float Y[256], cb[64], cr[64], blk[64];
  for (int by = 0; by < my; by++)
    for (int bx = 0; bx < mx; bx++) {
      float Cb4[256], Cr4[256];
      for (int yy = 0; yy < m; yy++)
        for (int xx = 0; xx < m; xx++) {
          int x = bx * m + xx, y = by * m + yy;
          if (x >= w) x = w - 1;
          if (y >= h) y = h - 1;
          const uint8_t *px = img + ((size_t)y * w + x) * nc;
          int i = yy * m + xx;
          if (nc == 1) {
            Y[i] = px[0] - 128.0f;
          } else {
            float r = px[0], g = px[1], b = px[2];
            Y[i] = 0.299f * r + 0.587f * g + 0.114f * b - 128.0f;
            Cb4[i] = -0.168736f * r - 0.331264f * g + 0.5f * b;
            Cr4[i] = 0.5f * r - 0.418688f * g - 0.081312f * b;
          }
        }
      for (int sy = 0; sy < m / 8; sy++)
        for (int sx = 0; sx < m / 8; sx++) {
          for (int k = 0; k < 64; k++)
            blk[k] = Y[(sy * 8 + k / 8) * m + sx * 8 + k % 8];
          encode_block(&wr, blk, ql, &pred[0], &dcl, &acl);
        }
      if (nc == 3) {
        for (int k = 0; k < 64; k++) {
          int y0 = 2 * (k / 8), x0 = 2 * (k % 8);
          cb[k] = 0.25f * (Cb4[y0 * 16 + x0] + Cb4[y0 * 16 + x0 + 1] +
                           Cb4[(y0 + 1) * 16 + x0] +
                           Cb4[(y0 + 1) * 16 + x0 + 1]);
          cr[k] = 0.25f * (Cr4[y0 * 16 + x0] + Cr4[y0 * 16 + x0 + 1] +
                           Cr4[(y0 + 1) * 16 + x0] +
                           Cr4[(y0 + 1) * 16 + x0 + 1]);
        }
        encode_block(&wr, cb, qc, &pred[1], &dcc, &acc);
        encode_block(&wr, cr, qc, &pred[2], &dcc, &acc);
      }
    }
  if (wr.cnt) put_bits(&wr, 0x7F, 8 - wr.cnt); /* pad with ones */
  put_byte(&wr, 0xFF);
  put_byte(&wr, 0xD9);
  return wr.overflow ? 0 : wr.n;
}

/* ------------------------------------------------------------- OpenEXR */

enum { EXR_UINT, EXR_HALF, EXR_FLOAT };
enum { EXR_NO, EXR_RLE, EXR_ZIPS, EXR_ZIP };
#define EXR_MAX_CHANNELS 64

static const char *const EXR_COMPRESSION[] = {
    "NO", "RLE", "ZIPS", "ZIP", "PIZ", "PXR24", "B44", "B44A", "DWAA",
    "DWAB"};

typedef struct {
  char name[256];
  int type, xs, ys;
} ExrChannel;

typedef struct {
  const uint8_t *data;
  size_t size;
  int nch, compression, have;  /* have: bit mask of required attributes */
  ExrChannel ch[EXR_MAX_CHANNELS];
  int xmin, ymin, xmax, ymax, w, h;
  int slot[EXR_MAX_CHANNELS];  /* output channel of each file channel */
  int nc;                      /* 4 (RGBA), 3 (RGB) or 1 (Y) */
  size_t table;                /* offset of the line offset table */
  char *err;
  int errlen;
} Exr;

static int exr_fail(Exr *e, const char *msg) {
  if (e->err && e->errlen > 0) snprintf(e->err, e->errlen, "%s", msg);
  return -1;
}

static int32_t le32(const uint8_t *p) {
  return (int32_t)((uint32_t)p[0] | (uint32_t)p[1] << 8 |
                   (uint32_t)p[2] << 16 | (uint32_t)p[3] << 24);
}

static uint64_t le64(const uint8_t *p) {
  return (uint64_t)(uint32_t)le32(p) | (uint64_t)(uint32_t)le32(p + 4) << 32;
}

/* A NUL-terminated string of at most `cap` bytes at data[*pos]; its
 * length, or -1 if it runs past the end. */
static int exr_string(const Exr *e, size_t *pos, const char **s, int cap) {
  size_t p = *pos;
  while (p < e->size && e->data[p] && p - *pos < (size_t)cap) p++;
  if (p >= e->size || e->data[p]) return -1;
  *s = (const char *)e->data + *pos;
  int n = (int)(p - *pos);
  *pos = p + 1;
  return n;
}

static int exr_channels(Exr *e, const uint8_t *v, int size) {
  int p = 0;
  while (p < size && v[p]) {
    int n = 0;
    while (p + n < size && v[p + n]) n++;
    if (p + n + 17 > size) return exr_fail(e, "corrupt OpenEXR channel list");
    if (e->nch == EXR_MAX_CHANNELS)
      return exr_fail(e, "OpenEXR with more than 64 channels");
    ExrChannel *c = &e->ch[e->nch++];
    memcpy(c->name, v + p, n < 255 ? n : 255);
    c->name[n < 255 ? n : 255] = 0;
    p += n + 1;
    c->type = le32(v + p);
    c->xs = le32(v + p + 8);
    c->ys = le32(v + p + 12);
    p += 16;
  }
  return 0;
}

/* Header and channel checks; fills e's window, channels and slots. */
static int exr_header(Exr *e) {
  char msg[512];
  const uint8_t *d = e->data;
  if (e->size < 8 || le32(d) != 20000630)
    return exr_fail(e, "not an OpenEXR file");
  uint32_t version = (uint32_t)le32(d + 4);
  if ((version & 0xff) != 2) {
    snprintf(msg, sizeof msg, "OpenEXR file format version %u",
             version & 0xff);
    return exr_fail(e, msg);
  }
  if (version & 0x1000) return exr_fail(e, "multi-part OpenEXR");
  if (version & 0x800) return exr_fail(e, "deep OpenEXR (non-image parts)");
  if (version & 0x200) return exr_fail(e, "tiled OpenEXR");
  if (version & 0x400) return exr_fail(e, "long-name OpenEXR");
  if (version & ~0x1effu) {
    snprintf(msg, sizeof msg, "OpenEXR version flags 0x%x", version >> 8);
    return exr_fail(e, msg);
  }
  size_t pos = 8;
  e->compression = -1;
  for (;;) {
    const char *name, *type;
    int n = exr_string(e, &pos, &name, 31);
    if (n < 0) return exr_fail(e, "corrupt OpenEXR header");
    if (n == 0) break;
    if (exr_string(e, &pos, &type, 31) < 0 || pos + 4 > e->size)
      return exr_fail(e, "corrupt OpenEXR header");
    int32_t size = le32(d + pos);
    pos += 4;
    if (size < 0 || pos + (size_t)size > e->size)
      return exr_fail(e, "corrupt OpenEXR header");
    const uint8_t *v = d + pos;
    pos += size;
    if (!strcmp(name, "channels") && !strcmp(type, "chlist")) {
      if (exr_channels(e, v, size)) return -1;
      e->have |= 1;
    } else if (!strcmp(name, "compression") && size == 1) {
      e->compression = v[0];
      e->have |= 2;
    } else if (!strcmp(name, "dataWindow") && size == 16) {
      e->xmin = le32(v);
      e->ymin = le32(v + 4);
      e->xmax = le32(v + 8);
      e->ymax = le32(v + 12);
      e->have |= 4;
    } else if (!strcmp(name, "displayWindow") && size == 16) {
      e->have |= 8;
    } else if (!strcmp(name, "lineOrder") && size == 1) {
      if (v[0] > 2) return exr_fail(e, "unknown OpenEXR line order");
      e->have |= 16;
    } else if (!strcmp(name, "type") && !strcmp(type, "string") &&
               !(size == 13 && !memcmp(v, "scanlineimage", 13))) {
      snprintf(msg, sizeof msg, "OpenEXR part type %.*s",
               size < 64 ? size : 64, (const char *)v);
      return exr_fail(e, msg);
    }
  }
  if (e->have != 31)
    return exr_fail(e, "OpenEXR header without channels, compression, "
                       "dataWindow, displayWindow or lineOrder");
  if (e->compression > EXR_ZIP) {
    if (e->compression <= 9)
      snprintf(msg, sizeof msg, "%s-compressed OpenEXR",
               EXR_COMPRESSION[e->compression]);
    else
      snprintf(msg, sizeof msg, "OpenEXR compression %d", e->compression);
    return exr_fail(e, msg);
  }
  if ((long)e->xmax - e->xmin < 0 || (long)e->ymax - e->ymin < 0 ||
      (long)e->xmax - e->xmin >= (1 << 20) ||
      (long)e->ymax - e->ymin >= (1 << 20))
    return exr_fail(e, "OpenEXR data window out of range");
  e->w = e->xmax - e->xmin + 1;
  e->h = e->ymax - e->ymin + 1;
  e->table = pos;
  /* which of R, G, B, A, Y the file holds, and where each goes */
  int seen[5] = {0, 0, 0, 0, 0};
  int other = 0;
  for (int i = 0; i < e->nch; i++) {
    const ExrChannel *c = &e->ch[i];
    static const char *const names[5] = {"R", "G", "B", "A", "Y"};
    int k;
    for (k = 0; k < 5 && strcmp(c->name, names[k]); k++) {
    }
    if (k < 5 && !seen[k]) {
      seen[k] = 1;
      e->slot[i] = k == 4 ? 0 : k;
    } else {
      other = 1;
    }
    if (c->type != EXR_HALF && c->type != EXR_FLOAT) {
      snprintf(msg, sizeof msg, "OpenEXR channel %s of pixel type %s",
               c->name, c->type == EXR_UINT ? "UINT" : "unknown");
      return exr_fail(e, msg);
    }
    if (c->xs != 1 || c->ys != 1) {
      snprintf(msg, sizeof msg, "subsampled OpenEXR channel %s (%d x %d)",
               c->name, c->xs, c->ys);
      return exr_fail(e, msg);
    }
  }
  int rgb = seen[0] && seen[1] && seen[2];
  if (!other && rgb && !seen[4]) e->nc = seen[3] ? 4 : 3;
  else if (!other && e->nch == 1 && seen[4]) e->nc = 1;
  else {
    int n = snprintf(msg, sizeof msg, "OpenEXR channels ");
    for (int i = 0; i < e->nch && n < (int)sizeof msg - 1; i++)
      n += snprintf(msg + n, sizeof msg - n, "%s%s", i ? "," : "",
                    e->ch[i].name);
    if (n < (int)sizeof msg - 1)
      snprintf(msg + n, sizeof msg - n, ": only R,G,B[,A] or Y are read");
    return exr_fail(e, msg);
  }
  return 0;
}

/* OpenEXR's RLE: a negative count byte -n is followed by n literal bytes,
 * a count byte n >= 0 by one byte repeated n + 1 times.  Returns the bytes
 * written, or -1 if they would exceed cap. */
static long exr_unrle(const uint8_t *in, long n, uint8_t *out, long cap) {
  long o = 0;
  while (n > 0) {
    int c = (int8_t)*in++;
    n--;
    if (c < 0) {
      if (-c > n || o - c > cap) return -1;
      memcpy(out + o, in, -c);
      o -= c;
      in -= c;
      n += c;
    } else {
      if (n < 1 || o + c + 1 > cap) return -1;
      memset(out + o, *in, c + 1);
      o += c + 1;
      in++;
      n--;
    }
  }
  return o;
}

/* The ZIP and RLE filters' inverse: undo the byte predictor
 * (t[i] += t[i-1] - 128), then interleave the two halves back. */
static void exr_unpredict(uint8_t *t, uint8_t *out, size_t n) {
  for (size_t i = 1; i < n; i++) t[i] = (uint8_t)(t[i - 1] + t[i] - 128);
  const uint8_t *t1 = t, *t2 = t + (n + 1) / 2;
  for (size_t i = 0; i < n; i++) out[i] = i & 1 ? *t2++ : *t1++;
}

static float half_to_float(uint16_t h) {
  uint32_t s = (uint32_t)(h & 0x8000) << 16, e = (h >> 10) & 31,
           m = h & 0x3ff, bits;
  if (e == 31) {
    bits = s | 0x7f800000u | m << 13;
  } else if (e) {
    bits = s | (e + 112) << 23 | m << 13;
  } else if (m) {             /* subnormal: normalise the mantissa */
    e = 113;
    while (!(m & 0x400)) {
      m <<= 1;
      e--;
    }
    bits = s | e << 23 | (m & 0x3ff) << 13;
  } else {
    bits = s;
  }
  float f;
  memcpy(&f, &bits, 4);
  return f;
}

/* Returns 0 and the data window's width and height and the channel count
 * (4 for R,G,B,A, 3 for R,G,B, 1 for Y), or -1 with a message in err. */
int exr_info(const uint8_t *data, size_t size, int *w, int *h, int *nc,
             char *err, int errlen) {
  Exr e;
  memset(&e, 0, sizeof e);
  e.data = data;
  e.size = size;
  e.err = err;
  e.errlen = errlen;
  if (exr_header(&e)) return -1;
  *w = e.w;
  *h = e.h;
  *nc = e.nc;
  return 0;
}

/* Decodes into out (h x w x nc float32, as exr_info gives them): R, G, B,
 * A in that order, or Y.  Every scanline must be present. */
int exr_decode(const uint8_t *data, size_t size, float *out, char *err,
               int errlen) {
  Exr e;
  memset(&e, 0, sizeof e);
  e.data = data;
  e.size = size;
  e.err = err;
  e.errlen = errlen;
  if (exr_header(&e)) return -1;
  int lpc = e.compression == EXR_ZIP ? 16 : 1;   /* lines a chunk */
  long nchunks = (e.h + lpc - 1) / lpc;
  size_t line_bytes = 0;
  for (int i = 0; i < e.nch; i++)
    line_bytes += (size_t)e.w * (e.ch[i].type == EXR_HALF ? 2 : 4);
  if (e.table + 8 * (size_t)nchunks > size)
    return exr_fail(&e, "truncated OpenEXR offset table");
  size_t cap = line_bytes * lpc;
  uint8_t *raw = malloc(cap), *tmp = malloc(cap);
  uint8_t *done = calloc(nchunks, 1);
  int rc = 0;
  if (!raw || !tmp || !done) {
    rc = exr_fail(&e, "out of memory");
    goto out;
  }
  for (long c = 0; c < nchunks; c++) {
    uint64_t off = le64(data + e.table + 8 * c);
    if (off > size || size - off < 8) {
      rc = exr_fail(&e, "OpenEXR chunk offset out of the file");
      goto out;
    }
    int32_t y = le32(data + off), n = le32(data + off + 4);
    long ly = (long)y - e.ymin;
    if (ly < 0 || ly >= e.h || ly % lpc || done[ly / lpc] || n < 0 ||
        (uint64_t)n > size - off - 8) {
      rc = exr_fail(&e, "corrupt OpenEXR chunk");
      goto out;
    }
    done[ly / lpc] = 1;
    int lines = e.h - ly < lpc ? (int)(e.h - ly) : lpc;
    size_t want = line_bytes * lines;
    const uint8_t *src = data + off + 8;
    if ((size_t)n == want) {           /* stored as is */
      memcpy(raw, src, want);
    } else if (e.compression == EXR_NO || (size_t)n > want) {
      rc = exr_fail(&e, "corrupt OpenEXR chunk size");
      goto out;
    } else {
      long got;
      if (e.compression == EXR_RLE) {
        got = exr_unrle(src, n, tmp, (long)want);
      } else {
        uLongf len = want;
        got = uncompress(tmp, &len, src, n) == Z_OK ? (long)len : -1;
      }
      if (got != (long)want) {
        rc = exr_fail(&e, "corrupt OpenEXR compressed chunk");
        goto out;
      }
      exr_unpredict(tmp, raw, want);
    }
    const uint8_t *p = raw;
    for (int l = 0; l < lines; l++) {
      float *row = out + (size_t)(ly + l) * e.w * e.nc;
      for (int i = 0; i < e.nch; i++) {
        float *o = row + e.slot[i];
        if (e.ch[i].type == EXR_HALF) {
          for (int x = 0; x < e.w; x++, p += 2)
            o[(size_t)x * e.nc] =
                half_to_float((uint16_t)(p[0] | p[1] << 8));
        } else {
          for (int x = 0; x < e.w; x++, p += 4) {
            int32_t bits = le32(p);
            memcpy(o + (size_t)x * e.nc, &bits, 4);
          }
        }
      }
    }
  }
out:
  free(raw);
  free(tmp);
  free(done);
  return rc;
}
