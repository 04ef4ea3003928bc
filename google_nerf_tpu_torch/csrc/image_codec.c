/* Host image codec of the PyTorch port: PNG unfiltering, baseline JPEG
 * decoding and baseline JPEG encoding, behind a plain C interface that
 * utils/image.py loads with ctypes.
 *
 * PNG: zlib inflation stays in Python; png_unfilter undoes the per-row
 * filters 0-4 (and the Adam7 interlace) of the inflated stream.
 *
 * JPEG decoding follows libjpeg(-turbo)'s default path so that the
 * samples equal what it gives: the integer "islow" IDCT (jidctint.c),
 * "fancy" triangle upsampling of 2h1v and 2h2v chroma (jdsample.c, with
 * the first and last sample rows repeated as context) and the fixed-point
 * YCbCr->RGB conversion of jdcolor.c.  Sequential Huffman scans only
 * (SOF0/SOF1, 8-bit, 1 or 3 components, interleaved or not, restart
 * intervals); progressive, lossless, hierarchical, arithmetic-coded and
 * 12-bit files are refused with the mode's name.
 *
 * JPEG encoding: baseline, 4:2:0 (or one gray component), the Annex K
 * quantisation tables scaled by libjpeg's quality rule and the Annex K
 * Huffman tables; a float DCT with rounding to the nearest level.
 */
#include <math.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

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
  int bw, bh;         /* blocks per row and column of the padded plane */
  int dw, dh;         /* downsampled size (libjpeg's downsampled_width) */
  uint8_t *plane;     /* bw*8 x bh*8 samples */
  int pred, td, ta;
} Comp;

typedef struct {
  const uint8_t *p, *end;
  uint32_t buf;
  int cnt, marker;
} Bits;

typedef struct {
  int w, h, nc, hmax, vmax, mcux, mcuy, restart, adobe, adobe_transform;
  int jfif, have_frame;
  Comp comp[4];
  uint16_t q[4][64]; /* natural order */
  Huff dc[4], ac[4];
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
  if (j->nc != 1 && j->nc != 3) {
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
  j->mcux = (j->w + 8 * j->hmax - 1) / (8 * j->hmax);
  j->mcuy = (j->h + 8 * j->vmax - 1) / (8 * j->vmax);
  for (int i = 0; i < j->nc; i++) {
    Comp *c = &j->comp[i];
    c->bw = j->mcux * c->h;
    c->bh = j->mcuy * c->v;
    c->dw = (int)(((long)j->w * c->h + j->hmax - 1) / j->hmax);
    c->dh = (int)(((long)j->h * c->v + j->vmax - 1) / j->vmax);
    c->plane = calloc((size_t)c->bw * 8 * c->bh * 8, 1);
    if (!c->plane) return fail(j, "out of memory");
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

static int decode_block(Jpeg *j, Bits *b, Comp *c, uint8_t *out,
                        int stride) {
  int coef[64];
  const uint16_t *q = j->q[c->tq];
  memset(coef, 0, sizeof coef);
  int t = huff_decode(b, &j->dc[c->td]);
  int diff = t ? extend(get_bits(b, t), t) : 0;
  c->pred += diff;
  coef[0] = c->pred * q[0];
  const Huff *ac = &j->ac[c->ta];
  for (int k = 1; k < 64; k++) {
    int rs = huff_decode(b, ac), r = rs >> 4, s = rs & 15;
    if (s) {
      k += r;
      int z = natural(k);
      coef[z] = extend(get_bits(b, s), s) * q[z];
    } else {
      if (r != 15) break;
      k += 15;
    }
  }
  idct_islow(coef, out, stride);
  return 0;
}

/* Find the next marker at or after p (skipping fill bytes). */
static const uint8_t *next_marker(const uint8_t *p, const uint8_t *end) {
  while (p + 1 < end) {
    if (p[0] == 0xFF && p[1] != 0 && p[1] != 0xFF) return p;
    p++;
  }
  return end;
}

static const uint8_t *decode_scan(Jpeg *j, const uint8_t *p, int len,
                                  const uint8_t *end) {
  int ns = p[0];
  Comp *sc[4];
  if (ns < 1 || ns > 4 || len < 4 + 2 * ns) {
    fail(j, "bad SOS segment");
    return NULL;
  }
  for (int i = 0; i < ns; i++) {
    int id = p[1 + 2 * i], k;
    for (k = 0; k < j->nc && j->comp[k].id != id; k++) {
    }
    if (k == j->nc) {
      fail(j, "SOS names an unknown component");
      return NULL;
    }
    sc[i] = &j->comp[k];
    sc[i]->td = p[2 + 2 * i] >> 4;
    sc[i]->ta = p[2 + 2 * i] & 15;
    sc[i]->pred = 0;
    if (sc[i]->td > 3 || sc[i]->ta > 3 || !j->dc[sc[i]->td].defined ||
        !j->ac[sc[i]->ta].defined) {
      fail(j, "scan uses an undefined Huffman table");
      return NULL;
    }
  }
  Bits b = {p + len, end, 0, 0, 0};
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
      const uint8_t *m = next_marker(b.p, end);
      if (m + 1 < end && m[1] >= 0xD0 && m[1] <= 0xD7) m += 2;
      b.p = m;
      b.buf = 0;
      b.cnt = 0;
      b.marker = 0;
      for (int i = 0; i < ns; i++) sc[i]->pred = 0;
    }
    long mx = u % ux, my = u / ux;
    if (ns == 1) {
      Comp *c = sc[0];
      int stride = c->bw * 8;
      decode_block(j, &b, c, c->plane + (my * 8) * stride + mx * 8, stride);
      continue;
    }
    for (int i = 0; i < ns; i++) {
      Comp *c = sc[i];
      int stride = c->bw * 8;
      for (int v = 0; v < c->v; v++)
        for (int h = 0; h < c->h; h++) {
          long by = my * c->v + v, bx = mx * c->h + h;
          decode_block(j, &b, c, c->plane + (by * 8) * stride + bx * 8,
                       stride);
        }
    }
  }
  return next_marker(b.p, end);
}

/* Parse up to the first SOS (header only) or through EOI (decode). */
static int run(Jpeg *j, const uint8_t *data, size_t size, int decode) {
  const uint8_t *p = data, *end = data + size;
  init_tables();
  if (size < 4 || p[0] != 0xFF || p[1] != 0xD8) return fail(j, "not a JPEG");
  p += 2;
  int scans = 0;
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
        if (parse_frame(j, seg, len)) return -1;
        break;
      case 0xC2:
      case 0xC6:
        return fail(j, "progressive JPEG");
      case 0xC3:
      case 0xC7:
        return fail(j, "lossless JPEG");
      case 0xC5:
        return fail(j, "hierarchical JPEG");
      case 0xC9:
      case 0xCA:
      case 0xCB:
      case 0xCD:
      case 0xCE:
      case 0xCF:
        return fail(j, "arithmetic-coded JPEG");
      case 0xC4:
        if (parse_dht(j, seg, len)) return -1;
        break;
      case 0xDB:
        if (parse_dqt(j, seg, len)) return -1;
        break;
      case 0xDD:
        if (len < 2) return fail(j, "short DRI segment");
        j->restart = u16(seg);
        break;
      case 0xE0:
        if (len >= 5 && !memcmp(seg, "JFIF", 5)) j->jfif = 1;
        break;
      case 0xEE:
        if (len >= 12 && !memcmp(seg, "Adobe", 5)) {
          j->adobe = 1;
          j->adobe_transform = seg[11];
        }
        break;
      case 0xDA:
        if (!j->have_frame) return fail(j, "SOS before SOF");
        if (!decode) return 0;
        p = decode_scan(j, seg, len, end);
        if (!p) return -1;
        scans++;
        break;
      default:
        break; /* APPn, COM, DNL... */
    }
  }
  if (!j->have_frame) return fail(j, "JPEG without a frame header");
  if (decode && !scans) return fail(j, "JPEG without a scan");
  return 0;
}

static void free_jpeg(Jpeg *j) {
  for (int i = 0; i < 4; i++) free(j->comp[i].plane);
}

/* jdsample.c's fancy upsamplers on one component, into a w x h plane.
 * Rows past the component's last real row, and the row above its first,
 * repeat the nearest real row (jdmainct.c's context rows). */
static int upsample(const Jpeg *j, const Comp *c, uint8_t *out) {
  int W = j->w, H = j->h, sx = j->hmax / c->h, sy = j->vmax / c->v;
  int stride = c->bw * 8, dw = c->dw, dh = c->dh;
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
    if (sx == 1 && sy == 1) {
      memcpy(o, c->plane + (size_t)y * stride, W);
    } else if (sx == 2 && sy == 1 && dw > 2) {
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
    } else if (sx == 2 && sy == 2 && dw > 2) {
      int iy = y >> 1, ny = (y & 1) ? iy + 1 : iy - 1;
      if (iy > dh - 1) iy = dh - 1;
      if (ny < 0) ny = 0;
      if (ny > dh - 1) ny = dh - 1;
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
      /* box replication (jdsample.c's int_upsample / h2v1 and h2v2 on
         narrow components) */
      int iy = y / sy;
      if (iy > dh - 1) iy = dh - 1;
      const uint8_t *in = c->plane + (size_t)iy * stride;
      for (int x = 0; x < W; x++) o[x] = in[x / sx];
    }
  }
  free(row);
  free(cs);
  return 0;
}

/* Returns 0 and the image's width, height and component count (1 or 3),
 * or -1 with a message in err. */
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

/* Decodes into out (h x w x nc uint8, nc from jpeg_info): RGB for three
 * components (YCbCr converted unless an Adobe marker says RGB or the
 * component ids are 'R', 'G', 'B'), gray for one. */
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
  if (j.nc == 1) {
    for (int y = 0; y < j.h; y++)
      memcpy(out + (size_t)y * j.w,
             j.comp[0].plane + (size_t)y * j.comp[0].bw * 8, j.w);
    free_jpeg(&j);
    return 0;
  }
  uint8_t *full = malloc(n * 3);
  if (!full) {
    free_jpeg(&j);
    return fail(&j, "out of memory");
  }
  for (int i = 0; i < 3; i++)
    if (upsample(&j, &j.comp[i], full + i * n)) {
      free(full);
      free_jpeg(&j);
      return fail(&j, "unsupported JPEG sampling factors");
    }
  int rgb = (j.adobe && j.adobe_transform == 0) ||
            (!j.jfif && !j.adobe && j.comp[0].id == 'R' &&
             j.comp[1].id == 'G' && j.comp[2].id == 'B');
  const uint8_t *Y = full, *Cb = full + n, *Cr = full + 2 * n;
  if (rgb) {
    for (size_t i = 0; i < n; i++) {
      out[3 * i] = Y[i];
      out[3 * i + 1] = Cb[i];
      out[3 * i + 2] = Cr[i];
    }
  } else {
    /* jdcolor.c: SCALEBITS 16, tables over x = sample - 128 */
    static int cr_r[256], cb_b[256];
    static int64_t cr_g[256], cb_g[256];
    static int init = 0;
    if (!init) {
      const int64_t one_half = (int64_t)1 << 15;
      const int64_t f1402 = (int64_t)(1.40200 * 65536 + 0.5);
      const int64_t f1772 = (int64_t)(1.77200 * 65536 + 0.5);
      const int64_t f0714 = (int64_t)(0.71414 * 65536 + 0.5);
      const int64_t f0344 = (int64_t)(0.34414 * 65536 + 0.5);
      for (int i = 0; i < 256; i++) {
        int64_t x = i - 128;
        cr_r[i] = (int)((f1402 * x + one_half) >> 16);
        cb_b[i] = (int)((f1772 * x + one_half) >> 16);
        cr_g[i] = -f0714 * x;
        cb_g[i] = -f0344 * x + one_half;
      }
      init = 1;
    }
    for (size_t i = 0; i < n; i++) {
      int y = Y[i], cb = Cb[i], cr = Cr[i];
      out[3 * i] = CLAMP[256 + y + cr_r[cr]];
      out[3 * i + 1] = CLAMP[256 + y + (int)((cb_g[cb] + cr_g[cr]) >> 16)];
      out[3 * i + 2] = CLAMP[256 + y + cb_b[cb]];
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
