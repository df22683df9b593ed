/* Host-side image codec of the port: baseline JPEG decode as libjpeg
 * (libjpeg-turbo) decodes it by default, and PNG row unfiltering.
 *
 * JPEG: sequential Huffman frames (SOF0/SOF1) of 8-bit precision with one
 * or three components, interleaved or not, with or without restart
 * intervals. The arithmetic is libjpeg's, term for term:
 *   - dequantization into JCOEF (short) coefficients, the accurate
 *     integer IDCT `jpeg_idct_islow` (CONST_BITS 13, PASS1_BITS 2) and its
 *     post-IDCT range limit table;
 *   - `do_fancy_upsampling`: triangular h2v1, h2v2 and h1v2 filters (edge
 *     samples replicated, as the first/last column cases and the context
 *     rows do), plain replication for a chroma plane of at most two samples
 *     a row and for every other integral factor (`int_upsample`),
 *     `fullsize` at 1:1;
 *   - `ycc_rgb_convert` with its 16-bit fixed-point tables; one component
 *     (grey) is replicated to RGB.
 * Progressive, lossless, hierarchical and arithmetic-coded frames, other
 * precisions, 2 or 4 components, a 3-component frame that libjpeg takes
 * as RGB (an Adobe marker with transform 0, or component ids 'R', 'G',
 * 'B' with no JFIF or Adobe marker), non-integral sampling factors and a
 * height given by a DNL marker are refused with a code, and so is every
 * stream that is truncated or corrupt: where libjpeg would warn and fill
 * with zeros, this decoder stops. No input can make it read or write out
 * of bounds.
 *
 * PNG: the five row filters (None, Sub, Up, Average, Paeth) of a
 * non-interlaced image; inflating and pixel unpacking are the caller's.
 *
 * Resizes: the accumulation loops of OpenCV's uint8 INTER_AREA (table
 * form) and INTER_CUBIC resizes, over tables the caller computes
 * (preprocess/imgproc.py). They are the only floating point here: float32
 * products and sums in OpenCV's order, each rounded on its own (built with
 * -ffp-contract=off, so no multiply-add is fused), rounded half to even.
 *
 * Plain C11; loaded with ctypes, so a call runs without Python's
 * interpreter lock.
 */

#include <stddef.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

enum {
  CODEC_OK = 0,
  ERR_CORRUPT = -1,
  ERR_TRUNCATED = -2,
  ERR_PROGRESSIVE = -3,
  ERR_ARITHMETIC = -4,
  ERR_PRECISION = -5,
  ERR_COMPONENTS = -6,
  ERR_SAMPLING = -7,
  ERR_NOMEM = -8,
  ERR_FRAME = -9,      /* lossless, hierarchical, DNL */
  ERR_TOO_LARGE = -10,
  ERR_BAD_ARGS = -11,
  ERR_RGB = -12
};

#define MAX_PIXELS ((int64_t)1 << 28)

/* ------------------------------------------------------------------ */
/* JPEG: tables                                                        */
/* ------------------------------------------------------------------ */

/* Zigzag index -> natural index, with libjpeg's 16 extra entries that
 * catch a run past the end of a corrupt block. */
static const int natural_order[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

#define FAST_BITS 9

typedef struct {
  int defined;
  uint8_t huffval[256];
  int nsym;
  int32_t maxcode[18];   /* largest code of length k, -1 if none */
  int32_t valoffset[18]; /* huffval index of the first code of length k */
  uint16_t fast[1 << FAST_BITS]; /* (length << 8) | symbol, 0 = slow */
} huff_table;

typedef struct {
  int id, h, v, tq;
  int td, ta;          /* tables of the current scan */
  int pred;            /* DC predictor */
  int bw, bh;          /* plane size in blocks */
  int dw, dh;          /* downsampled width and height (real samples) */
  uint8_t *plane;      /* bw*8 x bh*8 samples */
  int decoded;
} component;

typedef struct {
  const uint8_t *data;
  size_t n, pos;
  int width, height, ncomp, max_h, max_v, mcus_x, mcus_y;
  int frame_seen, restart_interval, saw_jfif, saw_adobe, adobe_transform;
  component comp[3];
  int16_t quant[4][64]; /* natural order */
  int quant_defined[4];
  huff_table dc[4], ac[4];
} jpeg_state;

static inline uint8_t clamp255(int x) {
  return (uint8_t)(x < 0 ? 0 : (x > 255 ? 255 : x));
}

/* Post-IDCT range limit: libjpeg's range_limit table (x + 128 clamped,
 * with the wrap of its 1024-entry index x & 1023), computed in place so
 * no global table is filled lazily under concurrent decodes. */
static inline uint8_t idct_limit(int64_t x) {
  return clamp255((int)((x + 512) & 1023) - 384);
}

/* ------------------------------------------------------------------ */
/* JPEG: marker segments                                               */
/* ------------------------------------------------------------------ */

static int read_u16(const jpeg_state *s, size_t at, int *out) {
  if (at + 2 > s->n) return ERR_TRUNCATED;
  *out = (s->data[at] << 8) | s->data[at + 1];
  return CODEC_OK;
}

/* Finds the next marker at or after s->pos (skipping garbage and fill
 * bytes, as libjpeg's next_marker does); leaves s->pos after it. */
static int next_marker(jpeg_state *s, int *marker) {
  for (;;) {
    while (s->pos < s->n && s->data[s->pos] != 0xFF) s->pos++;
    while (s->pos < s->n && s->data[s->pos] == 0xFF) s->pos++;
    if (s->pos >= s->n) return ERR_TRUNCATED;
    int c = s->data[s->pos++];
    if (c != 0) {
      *marker = c;
      return CODEC_OK;
    }
  }
}

static int build_huff(huff_table *t, const uint8_t counts[16],
                      const uint8_t *vals, int is_dc) {
  int nsym = 0;
  for (int k = 0; k < 16; k++) nsym += counts[k];
  if (nsym > 256) return ERR_CORRUPT;
  memcpy(t->huffval, vals, (size_t)nsym);
  t->nsym = nsym;
  if (is_dc)
    for (int i = 0; i < nsym; i++)
      if (vals[i] > 15) return ERR_CORRUPT;
  memset(t->fast, 0, sizeof t->fast);
  int32_t code = 0;
  int p = 0;
  for (int len = 1; len <= 16; len++) {
    int cnt = counts[len - 1];
    if (cnt) {
      /* Every code must fit in its length and none may be all ones
       * (libjpeg's JERR_BAD_HUFF_TABLE): checked before the fast table
       * is filled, so an oversubscribed table writes nothing. */
      if (code + cnt >= (1 << len)) return ERR_CORRUPT;
      t->valoffset[len] = p - code;
      for (int i = 0; i < cnt; i++, p++, code++) {
        if (len <= FAST_BITS) {
          int shift = FAST_BITS - len;
          for (int j = 0; j < (1 << shift); j++)
            t->fast[(code << shift) | j] =
                (uint16_t)((len << 8) | t->huffval[p]);
        }
      }
      t->maxcode[len] = code - 1;
    } else {
      t->valoffset[len] = 0;
      t->maxcode[len] = -1;
    }
    code <<= 1;
  }
  t->maxcode[17] = 0x7FFFFFFF; /* sentinel */
  t->defined = 1;
  return CODEC_OK;
}

static int parse_dqt(jpeg_state *s, size_t at, int len) {
  size_t end = at + (size_t)len;
  at += 2;
  while (at < end) {
    int pq = s->data[at] >> 4, tq = s->data[at] & 15;
    at++;
    if (tq > 3 || pq > 1) return ERR_CORRUPT;
    size_t need = pq ? 128 : 64;
    if (at + need > end) return ERR_CORRUPT;
    for (int k = 0; k < 64; k++) {
      int v = pq ? (s->data[at + 2 * k] << 8) | s->data[at + 2 * k + 1]
                 : s->data[at + k];
      s->quant[tq][natural_order[k]] = (int16_t)v;
    }
    s->quant_defined[tq] = 1;
    at += need;
  }
  return CODEC_OK;
}

static int parse_dht(jpeg_state *s, size_t at, int len) {
  size_t end = at + (size_t)len;
  at += 2;
  while (at < end) {
    if (at + 17 > end) return ERR_CORRUPT;
    int tc = s->data[at] >> 4, th = s->data[at] & 15;
    if (tc > 1 || th > 3) return ERR_CORRUPT;
    const uint8_t *counts = s->data + at + 1;
    int nsym = 0;
    for (int k = 0; k < 16; k++) nsym += counts[k];
    at += 17;
    if (at + (size_t)nsym > end || nsym > 256) return ERR_CORRUPT;
    int rc = build_huff(tc ? &s->ac[th] : &s->dc[th], counts, s->data + at,
                        tc == 0);
    if (rc) return rc;
    at += (size_t)nsym;
  }
  return CODEC_OK;
}

static int parse_sof(jpeg_state *s, size_t at, int len) {
  if (s->frame_seen) return ERR_CORRUPT;
  if (len < 8) return ERR_CORRUPT;
  const uint8_t *d = s->data + at + 2;
  if (d[0] != 8) return ERR_PRECISION;
  s->height = (d[1] << 8) | d[2];
  s->width = (d[3] << 8) | d[4];
  s->ncomp = d[5];
  if (s->height == 0) return ERR_FRAME; /* DNL */
  if (s->width == 0) return ERR_CORRUPT;
  if (s->ncomp != 1 && s->ncomp != 3) return ERR_COMPONENTS;
  if (len < 8 + 3 * s->ncomp) return ERR_CORRUPT;
  if ((int64_t)s->width * s->height > MAX_PIXELS) return ERR_TOO_LARGE;
  s->max_h = s->max_v = 1;
  for (int c = 0; c < s->ncomp; c++) {
    component *cp = &s->comp[c];
    cp->id = d[6 + 3 * c];
    cp->h = d[7 + 3 * c] >> 4;
    cp->v = d[7 + 3 * c] & 15;
    cp->tq = d[8 + 3 * c];
    if (cp->h < 1 || cp->h > 4 || cp->v < 1 || cp->v > 4 || cp->tq > 3)
      return ERR_CORRUPT;
    if (cp->h > s->max_h) s->max_h = cp->h;
    if (cp->v > s->max_v) s->max_v = cp->v;
  }
  for (int c = 0; c < s->ncomp; c++) {
    component *cp = &s->comp[c];
    if (s->max_h % cp->h || s->max_v % cp->v) return ERR_SAMPLING;
    for (int c2 = 0; c2 < c; c2++)
      if (s->comp[c2].id == cp->id) return ERR_CORRUPT;
  }
  s->mcus_x = (s->width + 8 * s->max_h - 1) / (8 * s->max_h);
  s->mcus_y = (s->height + 8 * s->max_v - 1) / (8 * s->max_v);
  for (int c = 0; c < s->ncomp; c++) {
    component *cp = &s->comp[c];
    cp->bw = s->mcus_x * cp->h;
    cp->bh = s->mcus_y * cp->v;
    cp->dw = (int)(((int64_t)s->width * cp->h + s->max_h - 1) / s->max_h);
    cp->dh = (int)(((int64_t)s->height * cp->v + s->max_v - 1) / s->max_v);
    cp->plane = NULL;
    cp->decoded = 0;
  }
  s->frame_seen = 1;
  return CODEC_OK;
}

/* ------------------------------------------------------------------ */
/* JPEG: entropy decoding                                              */
/* ------------------------------------------------------------------ */

typedef struct {
  const uint8_t *data;
  size_t n, pos;
  uint64_t buf;   /* bits, MSB first */
  int nbits;      /* bits in buf */
  int nreal;      /* of those, bits that came from the stream */
  int at_marker;  /* the reader stopped at a marker (pos at its 0xFF) */
} bit_reader;

static void fill(bit_reader *br) {
  while (br->nbits <= 56) {
    int byte = 0, real = 0;
    if (!br->at_marker && br->pos < br->n) {
      int b = br->data[br->pos];
      if (b != 0xFF) {
        byte = b;
        real = 1;
        br->pos++;
      } else {
        size_t q = br->pos + 1;
        while (q < br->n && br->data[q] == 0xFF) q++;
        if (q < br->n && br->data[q] == 0) {
          byte = 0xFF;
          real = 1;
          br->pos = q + 1;
        } else {
          br->at_marker = 1; /* pos stays on the first 0xFF */
        }
      }
    }
    br->buf |= (uint64_t)byte << (56 - br->nbits);
    br->nbits += 8;
    if (real) br->nreal += 8;
  }
}

/* Consume n bits (n <= 16); fails if they run past the stream's data. */
static inline int consume(bit_reader *br, int n) {
  if (n > br->nreal) return ERR_TRUNCATED;
  br->buf <<= n;
  br->nbits -= n;
  br->nreal -= n;
  return CODEC_OK;
}

static inline int get_bits(bit_reader *br, int n, int *out) {
  if (n == 0) {
    *out = 0;
    return CODEC_OK;
  }
  if (br->nbits < n) fill(br);
  *out = (int)(br->buf >> (64 - n));
  return consume(br, n);
}

static inline int decode_sym(bit_reader *br, const huff_table *t, int *sym) {
  if (br->nbits < 16) fill(br);
  unsigned look = (unsigned)(br->buf >> (64 - FAST_BITS));
  unsigned e = t->fast[look];
  if (e) {
    *sym = e & 0xFF;
    return consume(br, (int)(e >> 8));
  }
  for (int len = FAST_BITS + 1; len <= 16; len++) {
    int32_t code = (int32_t)(br->buf >> (64 - len));
    if (code <= t->maxcode[len]) {
      int idx = code + t->valoffset[len];
      if (idx < 0 || idx >= t->nsym) return ERR_CORRUPT;
      *sym = t->huffval[idx];
      return consume(br, len);
    }
  }
  return ERR_CORRUPT;
}

static inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

/* ------------------------------------------------------------------ */
/* JPEG: jpeg_idct_islow                                               */
/* ------------------------------------------------------------------ */

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
#define DESCALE(x, n) (((x) + ((int64_t)1 << ((n)-1))) >> (n))

static void idct_islow(const int16_t coef[64], const int16_t q[64],
                       uint8_t *out, int stride) {
  int ws[64];
  int64_t tmp0, tmp1, tmp2, tmp3, tmp10, tmp11, tmp12, tmp13;
  int64_t z1, z2, z3, z4, z5;

  for (int c = 0; c < 8; c++) {
    const int16_t *in = coef + c;
    const int16_t *qt = q + c;
    int *w = ws + c;
    if (in[8] == 0 && in[16] == 0 && in[24] == 0 && in[32] == 0 &&
        in[40] == 0 && in[48] == 0 && in[56] == 0) {
      int dc = (int)((int64_t)in[0] * qt[0] * (1 << PASS1_BITS));
      for (int r = 0; r < 8; r++) w[8 * r] = dc;
      continue;
    }
    z2 = (int64_t)in[16] * qt[16];
    z3 = (int64_t)in[48] * qt[48];
    z1 = (z2 + z3) * FIX_0_541196100;
    tmp2 = z1 + z3 * (-FIX_1_847759065);
    tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = (int64_t)in[0] * qt[0];
    z3 = (int64_t)in[32] * qt[32];
    tmp0 = (z2 + z3) * ((int64_t)1 << CONST_BITS);
    tmp1 = (z2 - z3) * ((int64_t)1 << CONST_BITS);
    tmp10 = tmp0 + tmp3;
    tmp13 = tmp0 - tmp3;
    tmp11 = tmp1 + tmp2;
    tmp12 = tmp1 - tmp2;

    tmp0 = (int64_t)in[56] * qt[56];
    tmp1 = (int64_t)in[40] * qt[40];
    tmp2 = (int64_t)in[24] * qt[24];
    tmp3 = (int64_t)in[8] * qt[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    z4 = tmp1 + tmp3;
    z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 = tmp0 * FIX_0_298631336;
    tmp1 = tmp1 * FIX_2_053119869;
    tmp2 = tmp2 * FIX_3_072711026;
    tmp3 = tmp3 * FIX_1_501321110;
    z1 = z1 * (-FIX_0_899976223);
    z2 = z2 * (-FIX_2_562915447);
    z3 = z3 * (-FIX_1_961570560);
    z4 = z4 * (-FIX_0_390180644);
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;

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
    if (w[1] == 0 && w[2] == 0 && w[3] == 0 && w[4] == 0 && w[5] == 0 &&
        w[6] == 0 && w[7] == 0) {
      uint8_t dc = idct_limit(DESCALE((int64_t)w[0], PASS1_BITS + 3));
      for (int c = 0; c < 8; c++) o[c] = dc;
      continue;
    }
    z2 = w[2];
    z3 = w[6];
    z1 = (z2 + z3) * FIX_0_541196100;
    tmp2 = z1 + z3 * (-FIX_1_847759065);
    tmp3 = z1 + z2 * FIX_0_765366865;
    tmp0 = ((int64_t)w[0] + w[4]) * ((int64_t)1 << CONST_BITS);
    tmp1 = ((int64_t)w[0] - w[4]) * ((int64_t)1 << CONST_BITS);
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
    tmp0 = tmp0 * FIX_0_298631336;
    tmp1 = tmp1 * FIX_2_053119869;
    tmp2 = tmp2 * FIX_3_072711026;
    tmp3 = tmp3 * FIX_1_501321110;
    z1 = z1 * (-FIX_0_899976223);
    z2 = z2 * (-FIX_2_562915447);
    z3 = z3 * (-FIX_1_961570560);
    z4 = z4 * (-FIX_0_390180644);
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;

#define OUT(x) idct_limit(DESCALE((x), CONST_BITS + PASS1_BITS + 3))
    o[0] = OUT(tmp10 + tmp3);
    o[7] = OUT(tmp10 - tmp3);
    o[1] = OUT(tmp11 + tmp2);
    o[6] = OUT(tmp11 - tmp2);
    o[2] = OUT(tmp12 + tmp1);
    o[5] = OUT(tmp12 - tmp1);
    o[3] = OUT(tmp13 + tmp0);
    o[4] = OUT(tmp13 - tmp0);
#undef OUT
  }
}

/* ------------------------------------------------------------------ */
/* JPEG: scans                                                         */
/* ------------------------------------------------------------------ */

static int decode_block(bit_reader *br, component *cp, const huff_table *dc,
                        const huff_table *ac, const int16_t *q, int bx,
                        int by) {
  int16_t coef[64];
  int s, v, rc;
  memset(coef, 0, sizeof coef);
  if ((rc = decode_sym(br, dc, &s))) return rc;
  if (s) {
    if ((rc = get_bits(br, s, &v))) return rc;
    s = extend(v, s);
  }
  int64_t pred = (int64_t)cp->pred + s;
  if (pred > INT32_MAX || pred < INT32_MIN) return ERR_CORRUPT;
  cp->pred = (int)pred;
  coef[0] = (int16_t)cp->pred;
  for (int k = 1; k < 64; k++) {
    int rs;
    if ((rc = decode_sym(br, ac, &rs))) return rc;
    int r = rs >> 4;
    s = rs & 15;
    if (s) {
      k += r;
      if ((rc = get_bits(br, s, &v))) return rc;
      coef[natural_order[k]] = (int16_t)extend(v, s);
    } else {
      if (r != 15) break;
      k += 15;
    }
  }
  size_t stride = (size_t)cp->bw * 8;
  idct_islow(coef, q,
             cp->plane + (size_t)by * 8 * stride + (size_t)bx * 8,
             (int)stride);
  return CODEC_OK;
}

static void reset_reader(bit_reader *br, const jpeg_state *s, size_t pos) {
  br->data = s->data;
  br->n = s->n;
  br->pos = pos;
  br->buf = 0;
  br->nbits = br->nreal = 0;
  br->at_marker = 0;
}

static int decode_scan(jpeg_state *s, size_t at, int len) {
  if (!s->frame_seen || len < 3) return ERR_CORRUPT;
  const uint8_t *d = s->data + at + 2;
  int ns = d[0];
  if (ns < 1 || ns > s->ncomp || len != 6 + 2 * ns) return ERR_CORRUPT;
  component *sc[3];
  for (int i = 0; i < ns; i++) {
    component *cp = NULL;
    for (int c = 0; c < s->ncomp; c++)
      if (s->comp[c].id == d[1 + 2 * i]) cp = &s->comp[c];
    if (cp == NULL || cp->decoded) return ERR_CORRUPT;
    for (int j = 0; j < i; j++)
      if (sc[j] == cp) return ERR_CORRUPT;
    cp->td = d[2 + 2 * i] >> 4;
    cp->ta = d[2 + 2 * i] & 15;
    if (cp->td > 3 || cp->ta > 3 || !s->dc[cp->td].defined ||
        !s->ac[cp->ta].defined || !s->quant_defined[cp->tq])
      return ERR_CORRUPT;
    if (cp->plane == NULL) {
      cp->plane = calloc((size_t)cp->bw * 8 * (size_t)cp->bh * 8, 1);
      if (cp->plane == NULL) return ERR_NOMEM;
    }
    cp->pred = 0;
    sc[i] = cp;
  }
  int per_row, rows;
  if (ns == 1) {
    per_row = (sc[0]->dw + 7) / 8;
    rows = (sc[0]->dh + 7) / 8;
  } else {
    per_row = s->mcus_x;
    rows = s->mcus_y;
  }
  bit_reader br;
  reset_reader(&br, s, at + (size_t)len);
  int64_t total = (int64_t)per_row * rows;
  int next_rst = 0, rc;
  for (int64_t m = 0; m < total; m++) {
    if (s->restart_interval && m > 0 && m % s->restart_interval == 0) {
      /* The rest of the byte is padding; the RSTn marker comes next. */
      s->pos = br.pos;
      int marker;
      if ((rc = next_marker(s, &marker))) return rc;
      if (marker != 0xD0 + next_rst) return ERR_CORRUPT;
      next_rst = (next_rst + 1) & 7;
      for (int i = 0; i < ns; i++) sc[i]->pred = 0;
      reset_reader(&br, s, s->pos);
    }
    int mx = (int)(m % per_row), my = (int)(m / per_row);
    for (int i = 0; i < ns; i++) {
      component *cp = sc[i];
      const huff_table *dc = &s->dc[cp->td], *ac = &s->ac[cp->ta];
      const int16_t *q = s->quant[cp->tq];
      if (ns == 1) {
        if ((rc = decode_block(&br, cp, dc, ac, q, mx, my))) return rc;
        continue;
      }
      for (int v = 0; v < cp->v; v++)
        for (int h = 0; h < cp->h; h++)
          if ((rc = decode_block(&br, cp, dc, ac, q, mx * cp->h + h,
                                 my * cp->v + v)))
            return rc;
    }
  }
  for (int i = 0; i < ns; i++) sc[i]->decoded = 1;
  s->pos = br.pos;
  return CODEC_OK;
}

/* ------------------------------------------------------------------ */
/* JPEG: upsampling and colour conversion                              */
/* ------------------------------------------------------------------ */

/* One component at full resolution, W x H, as libjpeg's default
 * (fancy) upsampler produces it. */
static void upsample(const jpeg_state *s, const component *cp, uint8_t *out) {
  const int W = s->width, H = s->height;
  const int hexp = s->max_h / cp->h, vexp = s->max_v / cp->v;
  const size_t stride = (size_t)cp->bw * 8;
  const uint8_t *pl = cp->plane;
  const int dw = cp->dw, dh = cp->dh;
  if (hexp == 1 && vexp == 1) {
    for (int y = 0; y < H; y++)
      memcpy(out + (size_t)y * W, pl + (size_t)y * stride, (size_t)W);
  } else if (hexp == 2 && vexp == 1 && dw > 2) {
    for (int y = 0; y < H; y++) {
      const uint8_t *in = pl + (size_t)y * stride;
      uint8_t *o = out + (size_t)y * W;
      for (int x = 0; x < W; x++) {
        int i = x >> 1;
        o[x] = (x & 1)
                   ? (uint8_t)((in[i] * 3 + in[i + 1 < dw ? i + 1 : dw - 1] +
                                2) >> 2)
                   : (uint8_t)((in[i] * 3 + in[i > 0 ? i - 1 : 0] + 1) >> 2);
      }
    }
  } else if (hexp == 1 && vexp == 2) {
    for (int y = 0; y < H; y++) {
      int near = y >> 1, far = (y & 1) ? near + 1 : near - 1;
      if (far < 0) far = 0;
      if (far > dh - 1) far = dh - 1;
      int bias = (y & 1) ? 2 : 1;
      const uint8_t *a = pl + (size_t)near * stride, *b = pl + (size_t)far * stride;
      uint8_t *o = out + (size_t)y * W;
      for (int x = 0; x < W; x++) o[x] = (uint8_t)((a[x] * 3 + b[x] + bias) >> 2);
    }
  } else if (hexp == 2 && vexp == 2 && dw > 2) {
    int *colsum = malloc(sizeof(int) * (size_t)dw);
    if (colsum == NULL) return; /* caller checked the allocation budget */
    for (int y = 0; y < H; y++) {
      int near = y >> 1, far = (y & 1) ? near + 1 : near - 1;
      if (far < 0) far = 0;
      if (far > dh - 1) far = dh - 1;
      const uint8_t *a = pl + (size_t)near * stride, *b = pl + (size_t)far * stride;
      for (int i = 0; i < dw; i++) colsum[i] = a[i] * 3 + b[i];
      uint8_t *o = out + (size_t)y * W;
      for (int x = 0; x < W; x++) {
        int i = x >> 1;
        o[x] = (x & 1)
                   ? (uint8_t)((colsum[i] * 3 + colsum[i + 1 < dw ? i + 1 : dw - 1] +
                                7) >> 4)
                   : (uint8_t)((colsum[i] * 3 + colsum[i > 0 ? i - 1 : 0] + 8) >> 4);
      }
    }
    free(colsum);
  } else {
    for (int y = 0; y < H; y++) {
      const uint8_t *in = pl + (size_t)(y / vexp) * stride;
      uint8_t *o = out + (size_t)y * W;
      for (int x = 0; x < W; x++) o[x] = in[x / hexp];
    }
  }
}

static int convert(const jpeg_state *s, uint8_t *rgb) {
  const size_t npix = (size_t)s->width * s->height;
  uint8_t *planes[3] = {NULL, NULL, NULL};
  int rc = CODEC_OK;
  for (int c = 0; c < s->ncomp; c++) {
    planes[c] = malloc(npix);
    if (planes[c] == NULL) {
      rc = ERR_NOMEM;
      goto done;
    }
    upsample(s, &s->comp[c], planes[c]);
  }
  if (s->ncomp == 1) {
    for (size_t i = 0; i < npix; i++)
      rgb[3 * i] = rgb[3 * i + 1] = rgb[3 * i + 2] = planes[0][i];
    goto done;
  }
  /* ycc_rgb_convert's tables (SCALEBITS 16). */
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  for (int i = 0; i < 256; i++) {
    int64_t x = i - 128;
    cr_r[i] = (int)((91881 * x + 32768) >> 16);
    cb_b[i] = (int)((116130 * x + 32768) >> 16);
    cr_g[i] = -46802 * x;
    cb_g[i] = -22554 * x + 32768;
  }
  for (size_t i = 0; i < npix; i++) {
    int y = planes[0][i], cb = planes[1][i], cr = planes[2][i];
    rgb[3 * i] = clamp255(y + cr_r[cr]);
    rgb[3 * i + 1] = clamp255(y + (int)((cb_g[cb] + cr_g[cr]) >> 16));
    rgb[3 * i + 2] = clamp255(y + cb_b[cb]);
  }
done:
  for (int c = 0; c < 3; c++) free(planes[c]);
  return rc;
}

/* ------------------------------------------------------------------ */
/* JPEG: the marker loop and the entry points                          */
/* ------------------------------------------------------------------ */

static int all_decoded(const jpeg_state *s) {
  if (!s->frame_seen) return 0;
  for (int c = 0; c < s->ncomp; c++)
    if (!s->comp[c].decoded) return 0;
  return 1;
}

static int run(jpeg_state *s, int header_only) {
  if (s->n < 4 || s->data[0] != 0xFF || s->data[1] != 0xD8)
    return ERR_CORRUPT;
  s->pos = 2;
  for (;;) {
    int m, len, rc;
    if ((rc = next_marker(s, &m))) {
      /* No EOI: accepted once every component is decoded. */
      return (!header_only && all_decoded(s)) ? CODEC_OK : rc;
    }
    if (m == 0xD9) break;
    if ((m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;
    size_t at = s->pos;
    if (read_u16(s, at, &len)) return ERR_TRUNCATED;
    if (len < 2 || at + (size_t)len > s->n) return ERR_TRUNCATED;
    switch (m) {
      case 0xC0:
      case 0xC1:
        if ((rc = parse_sof(s, at, len))) return rc;
        if (header_only) return CODEC_OK;
        break;
      case 0xC2:
        return ERR_PROGRESSIVE;
      case 0xC3: case 0xC5: case 0xC6: case 0xC7:
        return ERR_FRAME;
      case 0xC9: case 0xCA: case 0xCB: case 0xCC:
      case 0xCD: case 0xCE: case 0xCF:
        return ERR_ARITHMETIC;
      case 0xC4:
        if ((rc = parse_dht(s, at, len))) return rc;
        break;
      case 0xDB:
        if ((rc = parse_dqt(s, at, len))) return rc;
        break;
      case 0xDD:
        if (len != 4) return ERR_CORRUPT;
        s->restart_interval = (s->data[at + 2] << 8) | s->data[at + 3];
        break;
      case 0xDC:
        return ERR_FRAME;
      case 0xDA:
        if (header_only) return ERR_CORRUPT; /* a scan before any frame */
        if ((rc = decode_scan(s, at, len))) return rc;
        continue;
      case 0xE0:
        if (len - 2 >= 14 && memcmp(s->data + at + 2, "JFIF\0", 5) == 0)
          s->saw_jfif = 1;
        break;
      case 0xEE:
        if (len - 2 >= 12 && memcmp(s->data + at + 2, "Adobe", 5) == 0) {
          s->saw_adobe = 1;
          s->adobe_transform = s->data[at + 2 + 11];
        }
        break;
      default:
        break;
    }
    s->pos = at + (size_t)len;
  }
  if (header_only) return ERR_CORRUPT;
  return all_decoded(s) ? CODEC_OK : ERR_TRUNCATED;
}

static void release(jpeg_state *s) {
  for (int c = 0; c < 3; c++) {
    free(s->comp[c].plane);
    s->comp[c].plane = NULL;
  }
}

/* The frame's width and height (the first SOF), or an error code. */
int jpeg_header(const uint8_t *data, size_t n, int *width, int *height) {
  if (data == NULL || width == NULL || height == NULL) return ERR_BAD_ARGS;
  jpeg_state *s = calloc(1, sizeof *s);
  if (s == NULL) return ERR_NOMEM;
  s->data = data;
  s->n = n;
  int rc = run(s, 1);
  if (rc == CODEC_OK) {
    *width = s->width;
    *height = s->height;
  }
  release(s);
  free(s);
  return rc;
}

/* Decodes into out, uint8 RGB [height, width, 3]; width and height must
 * be the frame's (jpeg_header). */
int jpeg_decode(const uint8_t *data, size_t n, uint8_t *out, int width,
                int height) {
  if (data == NULL || out == NULL) return ERR_BAD_ARGS;
  jpeg_state *s = calloc(1, sizeof *s);
  if (s == NULL) return ERR_NOMEM;
  s->data = data;
  s->n = n;
  int rc = run(s, 0);
  if (rc == CODEC_OK && (s->width != width || s->height != height))
    rc = ERR_BAD_ARGS;
  /* libjpeg's colour space of a 3-component frame: RGB, not YCbCr. */
  if (rc == CODEC_OK && s->ncomp == 3 && !s->saw_jfif &&
      (s->saw_adobe ? s->adobe_transform == 0
                    : (s->comp[0].id == 82 && s->comp[1].id == 71 &&
                       s->comp[2].id == 66)))
    rc = ERR_RGB;
  if (rc == CODEC_OK) rc = convert(s, out);
  release(s);
  free(s);
  return rc;
}

/* ------------------------------------------------------------------ */
/* PNG row filters                                                     */
/* ------------------------------------------------------------------ */

/* src: height rows of (filter byte, rowbytes bytes); out: height x
 * rowbytes. bpp: bytes per complete pixel, rounded up to 1. */
int png_unfilter(const uint8_t *src, size_t n, uint32_t height,
                 size_t rowbytes, uint32_t bpp, uint8_t *out) {
  if (src == NULL || out == NULL || bpp < 1 || bpp > 8 || rowbytes == 0)
    return ERR_BAD_ARGS;
  if (n < (size_t)height * (rowbytes + 1)) return ERR_TRUNCATED;
  const uint8_t *prev = NULL;
  for (uint32_t y = 0; y < height; y++) {
    int ft = src[0];
    const uint8_t *in = src + 1;
    uint8_t *o = out + (size_t)y * rowbytes;
    switch (ft) {
      case 0:
        memcpy(o, in, rowbytes);
        break;
      case 1:
        for (size_t i = 0; i < rowbytes; i++)
          o[i] = (uint8_t)(in[i] + (i >= bpp ? o[i - bpp] : 0));
        break;
      case 2:
        for (size_t i = 0; i < rowbytes; i++)
          o[i] = (uint8_t)(in[i] + (prev ? prev[i] : 0));
        break;
      case 3:
        for (size_t i = 0; i < rowbytes; i++) {
          int a = i >= bpp ? o[i - bpp] : 0, b = prev ? prev[i] : 0;
          o[i] = (uint8_t)(in[i] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (size_t i = 0; i < rowbytes; i++) {
          int a = i >= bpp ? o[i - bpp] : 0, b = prev ? prev[i] : 0;
          int c = (prev && i >= bpp) ? prev[i - bpp] : 0;
          int pa = abs(b - c), pb = abs(a - c), pc = abs(a + b - 2 * c);
          int p = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          o[i] = (uint8_t)(in[i] + p);
        }
        break;
      default:
        return ERR_CORRUPT;
    }
    prev = o;
    src += rowbytes + 1;
  }
  return CODEC_OK;
}

/* ------------------------------------------------------------------ */
/* Resizes (OpenCV's uint8 INTER_AREA table form and INTER_CUBIC)      */
/* ------------------------------------------------------------------ */

/* saturate_cast<uchar>(float): round half to even, clamp to [0, 255]. */
static inline uint8_t round_u8(float x) {
  if (!(x > 0.0f)) return 0; /* negatives (and NaN) round or clamp to 0 */
  if (x >= 255.5f) return 255;
  int i = (int)x;
  float frac = x - (float)i;
  if (frac > 0.5f || (frac == 0.5f && (i & 1))) i++;
  return (uint8_t)(i > 255 ? 255 : i);
}

/* ResizeArea_Invoker: for each output row, each contributing source row
 * is accumulated across into buf (buf += src * alpha, table order), and
 * acc += beta * buf down. Tables: [out, k] index, weight, used. */
int resize_area_table(const uint8_t *src, int h, int w, int c,
                      const int32_t *xi, const float *xw, const uint8_t *xu,
                      int kx, const int32_t *yi, const float *yw,
                      const uint8_t *yu, int ky, int out_h, int out_w,
                      uint8_t *out) {
  if (src == NULL || out == NULL || c < 1 || c > 4 || h < 1 || w < 1)
    return ERR_BAD_ARGS;
  size_t n = (size_t)out_w * c;
  float *buf = malloc(sizeof(float) * n), *acc = malloc(sizeof(float) * n);
  if (buf == NULL || acc == NULL) {
    free(buf);
    free(acc);
    return ERR_NOMEM;
  }
  for (int dy = 0; dy < out_h; dy++) {
    memset(acc, 0, sizeof(float) * n);
    for (int j = 0; j < ky; j++) {
      size_t t = (size_t)dy * ky + j;
      if (!yu[t]) continue;
      int sy = yi[t];
      if (sy < 0 || sy >= h) continue;
      const uint8_t *row = src + (size_t)sy * w * c;
      memset(buf, 0, sizeof(float) * n);
      for (int dx = 0; dx < out_w; dx++) {
        float *b = buf + (size_t)dx * c;
        for (int k = 0; k < kx; k++) {
          size_t e = (size_t)dx * kx + k;
          if (!xu[e] || xi[e] < 0 || xi[e] >= w) continue;
          const uint8_t *px = row + (size_t)xi[e] * c;
          float alpha = xw[e];
          for (int ch = 0; ch < c; ch++) b[ch] = b[ch] + (float)px[ch] * alpha;
        }
      }
      float beta = yw[t];
      for (size_t i = 0; i < n; i++) acc[i] = acc[i] + buf[i] * beta;
    }
    uint8_t *o = out + (size_t)dy * n;
    for (size_t i = 0; i < n; i++) o[i] = round_u8(acc[i]);
  }
  free(buf);
  free(acc);
  return CODEC_OK;
}

/* resizeGeneric_ with HResizeCubic and VResizeCubic for uint8: 4 taps
 * of clamped indices xi/yi and int coefficients xc/yc ([out, 4]); the
 * first n_vec values of each output row (out_w * c of them) are summed
 * in float32 as OpenCV's SIMD lanes sum them, the rest in integers. */
int resize_cubic_u8(const uint8_t *src, int h, int w, int c,
                    const int32_t *xi, const int32_t *xc, const int32_t *yi,
                    const int32_t *yc, int out_h, int out_w, int n_vec,
                    uint8_t *out) {
  if (src == NULL || out == NULL || c < 1 || c > 4 || h < 1 || w < 1)
    return ERR_BAD_ARGS;
  size_t n = (size_t)out_w * c;
  /* The horizontal pass of each source row, once, when first needed. */
  int32_t *across = malloc(sizeof(int32_t) * (size_t)h * n);
  uint8_t *done = calloc((size_t)h, 1);
  if (across == NULL || done == NULL) {
    free(across);
    free(done);
    return ERR_NOMEM;
  }
  const float scale = 1.0f / (2048.0f * 2048.0f);
  for (int dy = 0; dy < out_h; dy++) {
    const int32_t *r[4];
    for (int k = 0; k < 4; k++) {
      int sy = yi[4 * dy + k];
      if (sy < 0) sy = 0;
      if (sy > h - 1) sy = h - 1;
      int32_t *dst = across + (size_t)sy * n;
      r[k] = dst;
      if (done[sy]) continue;
      done[sy] = 1;
      const uint8_t *row = src + (size_t)sy * w * c;
      for (int dx = 0; dx < out_w; dx++) {
        for (int ch = 0; ch < c; ch++) {
          int32_t v = 0;
          for (int j = 0; j < 4; j++) {
            int sx = xi[4 * dx + j];
            if (sx < 0) sx = 0;
            if (sx > w - 1) sx = w - 1;
            v += (int32_t)row[(size_t)sx * c + ch] * xc[4 * dx + j];
          }
          dst[(size_t)dx * c + ch] = v;
        }
      }
    }
    const int32_t *b = yc + 4 * dy;
    const float b0 = (float)b[0] * scale, b1 = (float)b[1] * scale,
                b2 = (float)b[2] * scale, b3 = (float)b[3] * scale;
    uint8_t *o = out + (size_t)dy * n;
    for (size_t x = 0; x < n; x++) {
      const int32_t s0 = r[0][x], s1 = r[1][x], s2 = r[2][x], s3 = r[3][x];
      if ((int64_t)x < n_vec) {
        float a = (float)s3 * b3;
        a = (float)s2 * b2 + a;
        a = (float)s1 * b1 + a;
        a = (float)s0 * b0 + a;
        o[x] = round_u8(a);
      } else {
        int64_t v = (int64_t)s0 * b[0] + (int64_t)s1 * b[1] +
                    (int64_t)s2 * b[2] + (int64_t)s3 * b[3];
        int64_t r = (v + (1 << 21)) >> 22;
        o[x] = (uint8_t)(r < 0 ? 0 : (r > 255 ? 255 : r));
      }
    }
  }
  free(across);
  free(done);
  return CODEC_OK;
}
