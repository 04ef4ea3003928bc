/* Entropy coders of the JPEG fixture writer (tools/jpeg_fixture.py),
 * behind a plain C interface loaded with ctypes.  Each function codes one
 * scan of quantised coefficients (or, lossless, of samples) and returns
 * the scan's bytes with their restart markers; the Python side lays out
 * the markers around them.
 *
 *   fx_huff_scan: Huffman sequential and the four progressive scan kinds
 *     (ITU-T T.81 Annex F and G.1.2; no EOB runs: each block that ends
 *     early carries its own EOB, with the AC refinement's correction
 *     bits buffered behind the next symbol as G.1.2.3 asks);
 *   fx_arith_scan: arithmetic sequential and progressive (Annex D's QM
 *     coder with F.1.4's and G.1.3's contexts and the DAC conditioning
 *     L, U and Kx);
 *   fx_lossless_scan: lossless Huffman (Annex H: predictors 1-7, the
 *     point transform, the first-row and first-column rules restarted
 *     at every restart interval).
 *
 * It shares no code with the reader (csrc/image_codec.c): a file it
 * writes that an independent decoder reads as intended checks the reader
 * against the standard rather than against this writer.
 */
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

static const uint8_t ZZ[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

/* ---------------------------------------------------------- byte sink */

typedef struct {
  uint8_t *out;
  size_t n, cap;
  int overflow;
  uint32_t acc; /* Huffman bit accumulator */
  int nacc;
} Sink;

static void put(Sink *s, int b) {
  if (s->n < s->cap) s->out[s->n++] = (uint8_t)b;
  else s->overflow = 1;
}

static void put_bits(Sink *s, uint32_t v, int n) {
  for (int i = n - 1; i >= 0; i--) {
    s->acc = ((s->acc << 1) | ((v >> i) & 1)) & 255;
    if (++s->nacc == 8) {
      put(s, (int)s->acc);
      if (s->acc == 0xFF) put(s, 0);
      s->acc = 0;
      s->nacc = 0;
    }
  }
}

static void flush_bits(Sink *s) {
  if (s->nacc) put_bits(s, 0x7F, 8 - s->nacc); /* pad with ones */
}

static void put_rst(Sink *s, int n) {
  put(s, 0xFF);
  put(s, 0xD0 + (n & 7));
}

static int nbits(int v) {
  int n = 0;
  if (v < 0) v = -v;
  while (v) {
    n++;
    v >>= 1;
  }
  return n;
}

/* ------------------------------------------------------- scan layout */

/* One component of a scan: its coefficient blocks (bh x bw x 64 int16,
 * natural order), sampling factors, the blocks of its non-interleaved
 * scan (uw x uh) and its table numbers. */
typedef struct {
  int16_t *coef;
  int bw, h, v, uw, uh, td, ta;
} Comp;

typedef void (*BlockFn)(void *ctx, int ci, int16_t *blk);
typedef void (*RestartFn)(void *ctx, int n);

/* Every block of the scan in order (MCUs of the interleaved scan, or the
 * single component's blocks in raster order), with rst called before
 * each restart interval after the first. */
static void walk(int ns, Comp *c, int mcux, int mcuy, int restart,
                 BlockFn fn, RestartFn rst, void *ctx) {
  long ux = ns == 1 ? c[0].uw : mcux;
  long units = ns == 1 ? ux * c[0].uh : (long)mcux * mcuy;
  for (long u = 0; u < units; u++) {
    if (restart && u && u % restart == 0) rst(ctx, (int)(u / restart - 1));
    long mx = u % ux, my = u / ux;
    if (ns == 1) {
      fn(ctx, 0, c[0].coef + (my * c[0].bw + mx) * 64);
      continue;
    }
    for (int i = 0; i < ns; i++)
      for (int v = 0; v < c[i].v; v++)
        for (int h = 0; h < c[i].h; h++)
          fn(ctx, i,
             c[i].coef +
                 ((my * c[i].v + v) * c[i].bw + mx * c[i].h + h) * 64);
  }
}

static void read_comps(int ns, void **coef, const int *geom, Comp *c) {
  for (int i = 0; i < ns; i++) {
    const int *g = geom + 7 * i;
    c[i].coef = (int16_t *)coef[i];
    c[i].bw = g[0];
    c[i].h = g[1];
    c[i].v = g[2];
    c[i].uw = g[3];
    c[i].uh = g[4];
    c[i].td = g[5];
    c[i].ta = g[6];
  }
}

/* ------------------------------------------------------------ Huffman */

typedef struct {
  uint16_t code[256];
  uint8_t len[256];
} Codes;

/* tab: bits[1..16] then the values (a DHT body without its class byte) */
static void make_codes(const uint8_t *tab, Codes *c) {
  int code = 0, k = 0;
  memset(c, 0, sizeof *c);
  for (int l = 1; l <= 16; l++) {
    for (int i = 0; i < tab[l - 1]; i++, k++) {
      c->code[tab[16 + k]] = (uint16_t)code++;
      c->len[tab[16 + k]] = (uint8_t)l;
    }
    code <<= 1;
  }
}

typedef struct {
  Sink s;
  Comp *c;
  Codes dc[4], ac[4]; /* by table number */
  int pred[4];
  int progressive, ss, se, ah, al;
} Huff;

static void sym(Huff *e, const Codes *t, int v) {
  put_bits(&e->s, t->code[v], t->len[v]);
}

/* a value of category s: its low s bits, negative values as v - 1 */
static void put_value(Huff *e, int v, int s) {
  if (s) put_bits(&e->s, (uint32_t)(v < 0 ? v - 1 : v) & ((1u << s) - 1), s);
}

static void huff_dc(Huff *e, int ci, int value) {
  int diff = value - e->pred[ci], s = nbits(diff);
  e->pred[ci] = value;
  sym(e, &e->dc[e->c[ci].td], s);
  put_value(e, diff, s);
}

/* AC coefficients k0..k1 of blk at point transform al (magnitudes
 * shifted toward zero), ZRL before a long run, EOB after the last */
static void huff_ac(Huff *e, const Codes *t, const int16_t *blk, int k0,
                    int k1, int al) {
  int run = 0;
  for (int k = k0; k <= k1; k++) {
    int v = blk[ZZ[k]], m = (v < 0 ? -v : v) >> al;
    if (!m) {
      run++;
      continue;
    }
    while (run > 15) {
      sym(e, t, 0xF0);
      run -= 16;
    }
    int s = nbits(m);
    sym(e, t, (run << 4) | s);
    put_value(e, v < 0 ? -m : m, s);
    run = 0;
  }
  if (run) sym(e, t, 0x00);
}

/* G.1.2.3: the refinement of band ss..se from Ah to Al = Ah - 1 */
static void huff_ac_refine(Huff *e, const Codes *t, const int16_t *blk) {
  int absv[64], eob = 0, r = 0, nbr = 0;
  uint8_t br[64];
  for (int k = e->ss; k <= e->se; k++) {
    int v = blk[ZZ[k]];
    absv[k] = (v < 0 ? -v : v) >> e->al;
    if (absv[k] == 1) eob = k;
  }
  for (int k = e->ss; k <= e->se; k++) {
    int m = absv[k];
    if (!m) {
      r++;
      continue;
    }
    while (r > 15 && k <= eob) {
      sym(e, t, 0xF0);
      r -= 16;
      for (int i = 0; i < nbr; i++) put_bits(&e->s, br[i], 1);
      nbr = 0;
    }
    if (m > 1) {
      br[nbr++] = (uint8_t)(m & 1);
      continue;
    }
    sym(e, t, (r << 4) | 1);
    put_bits(&e->s, blk[ZZ[k]] < 0 ? 0 : 1, 1);
    for (int i = 0; i < nbr; i++) put_bits(&e->s, br[i], 1);
    nbr = 0;
    r = 0;
  }
  if (r > 0 || nbr > 0) {
    sym(e, t, 0x00);
    for (int i = 0; i < nbr; i++) put_bits(&e->s, br[i], 1);
  }
}

static void huff_block(void *ctx, int ci, int16_t *blk) {
  Huff *e = ctx;
  const Codes *ac = &e->ac[e->c[ci].ta];
  if (!e->progressive) {
    huff_dc(e, ci, blk[0]);
    huff_ac(e, ac, blk, 1, 63, 0);
  } else if (e->ss == 0 && !e->ah) {
    huff_dc(e, ci, blk[0] >> e->al);
  } else if (e->ss == 0) {
    put_bits(&e->s, (blk[0] >> e->al) & 1, 1);
  } else if (!e->ah) {
    huff_ac(e, ac, blk, e->ss, e->se, e->al);
  } else {
    huff_ac_refine(e, ac, blk);
  }
}

static void huff_restart(void *ctx, int n) {
  Huff *e = ctx;
  flush_bits(&e->s);
  put_rst(&e->s, n);
  memset(e->pred, 0, sizeof e->pred);
}

/* One Huffman scan of ns components.  geom: ns x (bw, h, v, uw, uh, td,
 * ta); dc, ac: 4 tables of 272 bytes each (bits[1..16], values), by
 * table number.  Returns the byte count, or 0 if cap is too small. */
size_t fx_huff_scan(int progressive, int ns, void **coef, const int *geom,
                    int mcux, int mcuy, int ss, int se, int ah, int al,
                    int restart, const uint8_t *dc, const uint8_t *ac,
                    uint8_t *out, size_t cap) {
  Comp c[4];
  Huff e;
  memset(&e, 0, sizeof e);
  read_comps(ns, coef, geom, c);
  e.s.out = out;
  e.s.cap = cap;
  e.c = c;
  for (int t = 0; t < 4; t++) {
    make_codes(dc + 272 * t, &e.dc[t]);
    make_codes(ac + 272 * t, &e.ac[t]);
  }
  e.progressive = progressive;
  e.ss = ss;
  e.se = se;
  e.ah = ah;
  e.al = al;
  walk(ns, c, mcux, mcuy, restart, huff_block, huff_restart, &e);
  flush_bits(&e.s);
  return e.s.overflow ? 0 : e.s.n;
}

/* --------------------------------------------------------- arithmetic */

/* T.81 Table D.2: Qe, Next_Index_LPS, Next_Index_MPS, Switch_MPS; entry
 * 113 is the fixed probability 0.5 state (never updated). */
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

/* A statistics bin: bit 7 the MPS, bits 0-6 the state index. */
typedef struct {
  Sink s;
  Comp *c;
  long creg, areg, buffer;
  int ct, sc, zc;
  uint8_t dc_stats[16][64], ac_stats[16][256], fixed;
  int last_dc[4], dc_context[4];
  int L[16], U[16], K[16];
  int ns, progressive, ss, se, ah, al;
} Arith;

static void emit_pending(Arith *e) {
  while (e->zc) {
    put(&e->s, 0);
    e->zc--;
  }
}

/* D.1.6's byte output with carry propagation over stacked 0xFF bytes */
static void byte_out(Arith *e, long temp) {
  if (temp > 0xFF) {
    if (e->buffer >= 0) {
      emit_pending(e);
      put(&e->s, (int)(e->buffer + 1));
      if (e->buffer + 1 == 0xFF) put(&e->s, 0);
    }
    e->zc += e->sc;
    e->sc = 0;
    e->buffer = temp & 0xFF;
  } else if (temp == 0xFF) {
    e->sc++;
  } else {
    if (e->buffer == 0) {
      e->zc++;
    } else if (e->buffer >= 0) {
      emit_pending(e);
      put(&e->s, (int)e->buffer);
    }
    if (e->sc) {
      emit_pending(e);
      for (; e->sc; e->sc--) {
        put(&e->s, 0xFF);
        put(&e->s, 0);
      }
    }
    e->buffer = temp & 0xFF;
  }
}

/* D.1.2-D.1.6: code decision `val` in bin st */
static void aenc(Arith *e, uint8_t *st, int val) {
  int sv = *st;
  const uint16_t *q = QE[sv & 0x7F];
  long qe = q[0];
  e->areg -= qe;
  if (val != (sv >> 7)) {
    if (e->areg >= qe) {
      e->creg += e->areg;
      e->areg = qe;
    }
    *st = (uint8_t)((sv & 0x80) ^ (q[1] | (q[3] << 7)));
  } else {
    if (e->areg >= 0x8000) return;
    if (e->areg < qe) {
      e->creg += e->areg;
      e->areg = qe;
    }
    *st = (uint8_t)((sv & 0x80) | q[2]);
  }
  do {
    e->areg <<= 1;
    e->creg <<= 1;
    if (--e->ct == 0) {
      byte_out(e, e->creg >> 19);
      e->creg &= 0x7FFFF;
      e->ct += 8;
    }
  } while (e->areg < 0x8000);
}

static void arith_init(Arith *e) {
  e->creg = 0;
  e->areg = 0x10000;
  e->sc = e->zc = 0;
  e->ct = 11;
  e->buffer = -1;
}

/* D.1.8: the final bytes, with trailing zero bytes left out */
static void arith_flush(Arith *e) {
  long temp = (e->areg - 1 + e->creg) & 0xFFFF0000L;
  e->creg = temp < e->creg ? temp + 0x8000 : temp;
  e->creg <<= e->ct;
  if (e->creg & 0xF8000000L) {
    if (e->buffer >= 0) {
      emit_pending(e);
      put(&e->s, (int)(e->buffer + 1));
      if (e->buffer + 1 == 0xFF) put(&e->s, 0);
    }
    e->zc += e->sc;
    e->sc = 0;
  } else {
    if (e->buffer == 0) {
      e->zc++;
    } else if (e->buffer >= 0) {
      emit_pending(e);
      put(&e->s, (int)e->buffer);
    }
    if (e->sc) {
      emit_pending(e);
      for (; e->sc; e->sc--) {
        put(&e->s, 0xFF);
        put(&e->s, 0);
      }
    }
  }
  if (e->creg & 0x7FFF800L) {
    emit_pending(e);
    put(&e->s, (int)((e->creg >> 19) & 0xFF));
    if (((e->creg >> 19) & 0xFF) == 0xFF) put(&e->s, 0);
    if (e->creg & 0x7F800L) {
      put(&e->s, (int)((e->creg >> 11) & 0xFF));
      if (((e->creg >> 11) & 0xFF) == 0xFF) put(&e->s, 0);
    }
  }
}

static int dc_scan(const Arith *e) {
  return !e->progressive || (e->ss == 0 && e->ah == 0);
}

static int ac_scan(const Arith *e) { return !e->progressive || e->se; }

static void reset_stats(Arith *e, int ns) {
  for (int i = 0; i < ns; i++) {
    if (dc_scan(e)) {
      memset(e->dc_stats[e->c[i].td], 0, 64);
      e->last_dc[i] = 0;
      e->dc_context[i] = 0;
    }
    if (ac_scan(e)) memset(e->ac_stats[e->c[i].ta], 0, 256);
  }
}

/* F.1.4.4.1 and Figures F.4, F.6-F.9: one DC value against the
 * prediction, with the conditioning of the previous difference */
static void arith_dc(Arith *e, int ci, int m) {
  int tbl = e->c[ci].td, v = m - e->last_dc[ci];
  uint8_t *st = e->dc_stats[tbl] + e->dc_context[ci];
  if (v == 0) {
    aenc(e, st, 0);
    e->dc_context[ci] = 0;
    return;
  }
  e->last_dc[ci] = m;
  aenc(e, st, 1);
  if (v > 0) {
    aenc(e, st + 1, 0);
    st += 2;
    e->dc_context[ci] = 4;
  } else {
    v = -v;
    aenc(e, st + 1, 1);
    st += 3;
    e->dc_context[ci] = 8;
  }
  int mag = 0;
  if ((v -= 1)) {
    aenc(e, st, 1);
    mag = 1;
    int v2 = v;
    st = e->dc_stats[tbl] + 20;
    while (v2 >>= 1) {
      aenc(e, st, 1);
      mag <<= 1;
      st++;
    }
  }
  aenc(e, st, 0);
  if (mag < ((1 << e->L[tbl]) >> 1)) e->dc_context[ci] = 0;
  else if (mag > ((1 << e->U[tbl]) >> 1)) e->dc_context[ci] += 8;
  st += 14;
  while (mag >>= 1) aenc(e, st, (mag & v) ? 1 : 0);
}

/* the magnitude |v| - 1 of a nonzero AC coefficient at band index k,
 * st at its S0 + 2 */
static void arith_ac_mag(Arith *e, int tbl, uint8_t *st, int k, int v) {
  int mag = 0;
  if ((v -= 1)) {
    aenc(e, st, 1);
    mag = 1;
    int v2 = v;
    if (v2 >>= 1) {
      aenc(e, st, 1);
      mag <<= 1;
      st = e->ac_stats[tbl] + (k <= e->K[tbl] ? 189 : 217);
      while (v2 >>= 1) {
        aenc(e, st, 1);
        mag <<= 1;
        st++;
      }
    }
  }
  aenc(e, st, 0);
  st += 14;
  while (mag >>= 1) aenc(e, st, (mag & v) ? 1 : 0);
}

/* Figure F.5 over coefficients ss..se at point transform al */
static void arith_ac(Arith *e, int tbl, const int16_t *blk, int ss, int se,
                     int al) {
  int ke, k;
  for (ke = se; ke >= ss; ke--) {
    int v = blk[ZZ[ke]];
    if (((v < 0 ? -v : v) >> al)) break;
  }
  for (k = ss; k <= ke; k++) {
    uint8_t *st = e->ac_stats[tbl] + 3 * (k - 1);
    aenc(e, st, 0);
    int v, m;
    for (;;) {
      v = blk[ZZ[k]];
      m = (v < 0 ? -v : v) >> al;
      if (m) break;
      aenc(e, st + 1, 0);
      st += 3;
      k++;
    }
    aenc(e, st + 1, 1);
    aenc(e, &e->fixed, v < 0);
    arith_ac_mag(e, tbl, st + 2, k, m);
  }
  if (k <= se) aenc(e, e->ac_stats[tbl] + 3 * (k - 1), 1);
}

/* Figure G.10: the refinement of band ss..se from Ah to Al */
static void arith_ac_refine(Arith *e, int tbl, const int16_t *blk) {
  int ke, kex, k;
  for (ke = e->se; ke > 0; ke--) {
    int v = blk[ZZ[ke]];
    if (((v < 0 ? -v : v) >> e->al)) break;
  }
  for (kex = ke; kex > 0; kex--) {
    int v = blk[ZZ[kex]];
    if (((v < 0 ? -v : v) >> e->ah)) break;
  }
  for (k = e->ss; k <= ke; k++) {
    uint8_t *st = e->ac_stats[tbl] + 3 * (k - 1);
    if (k > kex) aenc(e, st, 0);
    for (;;) {
      int v = blk[ZZ[k]], m = (v < 0 ? -v : v) >> e->al;
      if (m) {
        if (m >> 1) {
          aenc(e, st + 2, m & 1);
        } else {
          aenc(e, st + 1, 1);
          aenc(e, &e->fixed, v < 0);
        }
        break;
      }
      aenc(e, st + 1, 0);
      st += 3;
      k++;
    }
  }
  if (k <= e->se) aenc(e, e->ac_stats[tbl] + 3 * (k - 1), 1);
}

static void arith_block(void *ctx, int ci, int16_t *blk) {
  Arith *e = ctx;
  int ta = e->c[ci].ta;
  if (!e->progressive) {
    arith_dc(e, ci, blk[0]);
    arith_ac(e, ta, blk, 1, 63, 0);
  } else if (e->ss == 0 && !e->ah) {
    arith_dc(e, ci, blk[0] >> e->al);
  } else if (e->ss == 0) {
    aenc(e, &e->fixed, (blk[0] >> e->al) & 1);
  } else if (!e->ah) {
    arith_ac(e, ta, blk, e->ss, e->se, e->al);
  } else {
    arith_ac_refine(e, ta, blk);
  }
}

static void arith_restart(void *ctx, int n) {
  Arith *e = ctx;
  arith_flush(e);
  put_rst(&e->s, n);
  reset_stats(e, e->ns);
  arith_init(e);
}

/* One arithmetic-coded scan.  geom as fx_huff_scan's; luk: 16 x (L, U,
 * Kx), the DAC conditioning of each table number.  Returns the byte
 * count, or 0 if cap is too small. */
size_t fx_arith_scan(int progressive, int ns, void **coef, const int *geom,
                     int mcux, int mcuy, int ss, int se, int ah, int al,
                     int restart, const int *luk, uint8_t *out,
                     size_t cap) {
  Comp c[4];
  Arith *e = calloc(1, sizeof *e);
  if (!e) return 0;
  read_comps(ns, coef, geom, c);
  e->s.out = out;
  e->s.cap = cap;
  e->c = c;
  for (int t = 0; t < 16; t++) {
    e->L[t] = luk[3 * t];
    e->U[t] = luk[3 * t + 1];
    e->K[t] = luk[3 * t + 2];
  }
  e->fixed = 113;
  e->progressive = progressive;
  e->ss = ss;
  e->se = se;
  e->ah = ah;
  e->al = al;
  e->ns = ns;
  reset_stats(e, ns);
  arith_init(e);
  walk(ns, c, mcux, mcuy, restart, arith_block, arith_restart, e);
  arith_flush(e);
  size_t n = e->s.overflow ? 0 : e->s.n;
  free(e);
  return n;
}

/* ----------------------------------------------------------- lossless */

/* H.1.2.1's prediction of sample (x, y) of a plane of width w, the
 * first row of the scan or of a restart interval `first` */
static int predict(const int *p, int w, int x, int y, int first, int sel,
                   int init) {
  if (first) return x ? p[(long)y * w + x - 1] : init;
  int b = p[(long)(y - 1) * w + x];
  if (!x) return b;
  int a = p[(long)y * w + x - 1], c = p[(long)(y - 1) * w + x - 1];
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

/* One lossless Huffman scan of ns components.  planes: each component's
 * dh x dw uint8 samples; geom: ns x (dw, dh, h, v, td); dc: 4 tables of
 * 272 bytes; sel: the predictor (1-7); pt: the point transform; restart:
 * MCUs a restart interval (a whole number of MCU rows).  MCU positions
 * past a component's samples carry zero differences.  Returns the byte
 * count, or 0 if cap is too small or memory runs out. */
size_t fx_lossless_scan(int ns, void **planes, const int *geom, int mcux,
                        int mcuy, int sel, int pt, int restart,
                        const uint8_t *dc, uint8_t *out, size_t cap) {
  Sink s = {out, 0, cap, 0, 0, 0};
  Codes codes[4];
  int *diff[4] = {0}, ok = 1;
  for (int t = 0; t < 4; t++) make_codes(dc + 272 * t, &codes[t]);
  long per_row = ns == 1 ? geom[0] : mcux;
  long rows_per_interval = restart ? restart / per_row : 0;
  for (int i = 0; i < ns; i++) {
    const int *g = geom + 5 * i;
    int w = g[0], h = g[1], vrows = ns == 1 ? 1 : g[3];
    const uint8_t *src = planes[i];
    int *p = malloc(sizeof(int) * (size_t)w * h);
    diff[i] = malloc(sizeof(int) * (size_t)w * h);
    if (!p || !diff[i]) {
      free(p);
      ok = 0;
      break;
    }
    for (long k = 0; k < (long)w * h; k++) p[k] = src[k] >> pt;
    for (int y = 0; y < h; y++) {
      int first = y == 0 || (rows_per_interval &&
                             y % (rows_per_interval * vrows) == 0);
      for (int x = 0; x < w; x++)
        diff[i][(long)y * w + x] =
            p[(long)y * w + x] -
            predict(p, w, x, y, first, sel, 1 << (8 - pt - 1));
    }
    free(p);
  }
  if (ok) {
    long units = ns == 1 ? per_row * geom[1] : (long)mcux * mcuy;
    for (long u = 0; u < units; u++) {
      if (restart && u && u % restart == 0) {
        flush_bits(&s);
        put_rst(&s, (int)(u / restart - 1));
      }
      long mx = u % per_row, my = u / per_row;
      for (int i = 0; i < ns; i++) {
        const int *g = geom + 5 * i;
        int hh = ns == 1 ? 1 : g[2], vv = ns == 1 ? 1 : g[3];
        for (int v = 0; v < vv; v++)
          for (int h = 0; h < hh; h++) {
            long x = mx * hh + h, y = my * vv + v;
            int d = x < g[0] && y < g[1] ? diff[i][y * g[0] + x] : 0;
            int sz = nbits(d);
            put_bits(&s, codes[g[4]].code[sz], codes[g[4]].len[sz]);
            if (sz)
              put_bits(&s, (uint32_t)(d < 0 ? d - 1 : d) & ((1u << sz) - 1),
                       sz);
          }
      }
    }
    flush_bits(&s);
  }
  for (int i = 0; i < ns; i++) free(diff[i]);
  return ok && !s.overflow ? s.n : 0;
}
