/* Host-side image codec of the port: baseline JPEG decode as libjpeg
 * (libjpeg-turbo) decodes it by default, baseline JPEG encode as
 * cv2.imencode encodes it (see "JPEG: the baseline encoder"), PNG row
 * unfiltering, and the TIFF strip and tile unpacking of libtiff (LZW,
 * PackBits, the horizontal predictor).
 *
 * JPEG: sequential and progressive Huffman frames (SOF0/SOF1/SOF2) of
 * 8-bit precision with one or three components, interleaved or not, with
 * or without restart intervals. The arithmetic is libjpeg's, term for
 * term:
 *   - a progressive frame's coefficients gathered over its scans as
 *     jdphuff.c does (DC first and refine, AC first with end-of-band runs
 *     and AC refine; spectral selection and successive approximation),
 *     each component's quantization table latched at its first scan
 *     (latch_quant_tables), then the same IDCT as a sequential frame;
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
 * Lossless, hierarchical and arithmetic-coded frames, other
 * precisions, 2 or 4 components, a 3-component frame that libjpeg takes
 * as RGB (an Adobe marker with transform 0, or component ids 'R', 'G',
 * 'B' with no JFIF or Adobe marker), non-integral sampling factors and a
 * height given by a DNL marker are refused with a code, and so is every
 * stream that is truncated or corrupt: where libjpeg would warn and fill
 * with zeros, this decoder stops. A progressive stream whose first ten
 * coefficients are not refined to full precision by its last scan is
 * refused too: libjpeg smooths such blocks (jdcoefct.c,
 * decompress_smooth_data), and a complete stream never needs it. So is
 * a bogus progression (a refinement before its first scan), where
 * libjpeg warns. No input can make it read or write out of bounds.
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
  /* -3, a progressive frame, is decoded since the progressive path. */
  ERR_ARITHMETIC = -4,
  ERR_PRECISION = -5,
  ERR_COMPONENTS = -6,
  ERR_SAMPLING = -7,
  ERR_NOMEM = -8,
  ERR_FRAME = -9,      /* lossless, hierarchical, DNL */
  ERR_TOO_LARGE = -10,
  ERR_BAD_ARGS = -11,
  ERR_RGB = -12,
  ERR_SMOOTHING = -13  /* progressive, coefficients 1-9 not all refined */
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
  int16_t qt[64];      /* the quantization table latched at its first scan */
  int q_latched;
  int16_t *coef;       /* progressive: bw*bh blocks of 64 (natural order) */
  int coef_bits[64];   /* progressive: Al of the last scan of each, or -1 */
} component;

typedef struct {
  const uint8_t *data;
  size_t n, pos;
  int width, height, ncomp, max_h, max_v, mcus_x, mcus_y;
  int frame_seen, restart_interval, saw_jfif, saw_adobe, adobe_transform;
  int progressive, saw_eoi;
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
    cp->coef = NULL;
    cp->q_latched = 0;
    for (int k = 0; k < 64; k++) cp->coef_bits[k] = -1;
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
                        const huff_table *ac, int bx, int by) {
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
  idct_islow(coef, cp->qt,
             cp->plane + (size_t)by * 8 * stride + (size_t)bx * 8,
             (int)stride);
  return CODEC_OK;
}

/* A progressive scan's parameters and its end-of-band run (jdphuff.c's
 * Ss, Se, Ah, Al and EOBRUN). */
typedef struct {
  int ss, se, ah, al;
  unsigned eobrun;
} prog_scan;

/* (JCOEF) LEFT_SHIFT(v, al): the shift of the bits, kept to 16. */
static inline int16_t shifted(int v, int al) {
  return (int16_t)(uint16_t)((unsigned)v << al);
}

/* One block of a progressive scan into its coefficients: decode_mcu_DC_
 * first, decode_mcu_DC_refine, decode_mcu_AC_first or decode_mcu_AC_
 * refine of libjpeg's jdphuff.c. Where libjpeg warns (a refinement
 * symbol of another size than 1) this stops. */
static int decode_block_prog(bit_reader *br, component *cp,
                             const huff_table *dc, const huff_table *ac,
                             prog_scan *ps, int16_t *blk) {
  int s, v, r, rc;
  if (ps->ss == 0) {
    if (ps->ah == 0) {
      if ((rc = decode_sym(br, dc, &s))) return rc;
      if (s) {
        if ((rc = get_bits(br, s, &v))) return rc;
        s = extend(v, s);
      }
      int64_t pred = (int64_t)cp->pred + s;
      if (pred > INT32_MAX || pred < INT32_MIN) return ERR_CORRUPT;
      cp->pred = (int)pred;
      blk[0] = shifted(cp->pred, ps->al);
    } else {
      if ((rc = get_bits(br, 1, &v))) return rc;
      if (v) blk[0] = (int16_t)(blk[0] | (1 << ps->al));
    }
    return CODEC_OK;
  }
  if (ps->ah == 0) {
    if (ps->eobrun > 0) {
      ps->eobrun--;
      return CODEC_OK;
    }
    for (int k = ps->ss; k <= ps->se; k++) {
      if ((rc = decode_sym(br, ac, &s))) return rc;
      r = s >> 4;
      s &= 15;
      if (s) {
        k += r;
        if ((rc = get_bits(br, s, &v))) return rc;
        blk[natural_order[k]] = shifted(extend(v, s), ps->al);
      } else if (r == 15) {
        k += 15;
      } else {
        ps->eobrun = 1u << r;
        if (r) {
          if ((rc = get_bits(br, r, &v))) return rc;
          ps->eobrun += (unsigned)v;
        }
        ps->eobrun--;
        break;
      }
    }
    return CODEC_OK;
  }
  /* AC refinement. */
  const int p1 = 1 << ps->al, m1 = -(1 << ps->al);
  int k = ps->ss;
  if (ps->eobrun == 0) {
    for (; k <= ps->se; k++) {
      if ((rc = decode_sym(br, ac, &s))) return rc;
      r = s >> 4;
      s &= 15;
      if (s) {
        if (s != 1) return ERR_CORRUPT;
        if ((rc = get_bits(br, 1, &v))) return rc;
        s = v ? p1 : m1;
      } else if (r != 15) {
        ps->eobrun = 1u << r;
        if (r) {
          if ((rc = get_bits(br, r, &v))) return rc;
          ps->eobrun += (unsigned)v;
        }
        break;
      }
      /* Past the nonzero coefficients (a correction bit each) and r
       * zero ones, to the zero one the new value goes to. */
      do {
        int16_t *c = blk + natural_order[k];
        if (*c != 0) {
          if ((rc = get_bits(br, 1, &v))) return rc;
          if (v && (*c & p1) == 0)
            *c = (int16_t)(*c >= 0 ? *c + p1 : *c + m1);
        } else if (--r < 0) {
          break;
        }
        k++;
      } while (k <= ps->se);
      if (s) blk[natural_order[k]] = (int16_t)s;
    }
  }
  if (ps->eobrun > 0) {
    /* The end of the band: a correction bit for every nonzero
     * coefficient left. */
    for (; k <= ps->se; k++) {
      int16_t *c = blk + natural_order[k];
      if (*c != 0) {
        if ((rc = get_bits(br, 1, &v))) return rc;
        if (v && (*c & p1) == 0)
          *c = (int16_t)(*c >= 0 ? *c + p1 : *c + m1);
      }
    }
    ps->eobrun--;
  }
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

/* A progressive scan's parameters checked as start_pass_phuff_decoder
 * checks them (its errors and its bogus-progression warnings both
 * refuse), and each component's coef_bits moved on. */
static int start_prog_scan(component **sc, int ns, const prog_scan *ps) {
  int dc = ps->ss == 0;
  if (dc ? ps->se != 0 : (ps->ss > ps->se || ps->se > 63 || ns != 1))
    return ERR_CORRUPT;
  if (ps->ah != 0 && ps->al != ps->ah - 1) return ERR_CORRUPT;
  if (ps->al > 13) return ERR_CORRUPT;
  for (int i = 0; i < ns; i++) {
    int *bits = sc[i]->coef_bits;
    if (!dc && bits[0] < 0) return ERR_CORRUPT;
    for (int k = ps->ss; k <= ps->se; k++) {
      if (ps->ah != (bits[k] < 0 ? 0 : bits[k])) return ERR_CORRUPT;
      bits[k] = ps->al;
    }
  }
  return CODEC_OK;
}

static int decode_scan(jpeg_state *s, size_t at, int len) {
  if (!s->frame_seen || len < 3) return ERR_CORRUPT;
  const uint8_t *d = s->data + at + 2;
  int ns = d[0];
  if (ns < 1 || ns > s->ncomp || len != 6 + 2 * ns) return ERR_CORRUPT;
  prog_scan ps = {d[1 + 2 * ns], d[2 + 2 * ns], d[3 + 2 * ns] >> 4,
                  d[3 + 2 * ns] & 15, 0};
  /* Which tables the scan reads: a sequential scan both; a progressive
   * one the DC table in a first DC scan, the AC table in an AC scan. */
  int need_dc = !s->progressive || (ps.ss == 0 && ps.ah == 0);
  int need_ac = !s->progressive || ps.ss != 0;
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
    if (cp->td > 3 || cp->ta > 3 || (need_dc && !s->dc[cp->td].defined) ||
        (need_ac && !s->ac[cp->ta].defined))
      return ERR_CORRUPT;
    if (!cp->q_latched) {
      if (!s->quant_defined[cp->tq]) return ERR_CORRUPT;
      memcpy(cp->qt, s->quant[cp->tq], sizeof cp->qt);
      cp->q_latched = 1;
    }
    if (s->progressive && cp->coef == NULL) {
      cp->coef = calloc((size_t)cp->bw * cp->bh * 64, sizeof(int16_t));
      if (cp->coef == NULL) return ERR_NOMEM;
    }
    if (!s->progressive && cp->plane == NULL) {
      cp->plane = calloc((size_t)cp->bw * 8 * (size_t)cp->bh * 8, 1);
      if (cp->plane == NULL) return ERR_NOMEM;
    }
    cp->pred = 0;
    sc[i] = cp;
  }
  int rc;
  if (s->progressive && (rc = start_prog_scan(sc, ns, &ps))) return rc;
  int per_row, rows;
  if (ns == 1) {
    /* A lone component's scan covers its own blocks, not the MCU rows'
     * padding. */
    per_row = (sc[0]->dw + 7) / 8;
    rows = (sc[0]->dh + 7) / 8;
  } else {
    per_row = s->mcus_x;
    rows = s->mcus_y;
  }
  bit_reader br;
  reset_reader(&br, s, at + (size_t)len);
  int64_t total = (int64_t)per_row * rows;
  int next_rst = 0;
  for (int64_t m = 0; m < total; m++) {
    if (s->restart_interval && m > 0 && m % s->restart_interval == 0) {
      /* The rest of the byte is padding; the RSTn marker comes next. */
      s->pos = br.pos;
      int marker;
      if ((rc = next_marker(s, &marker))) return rc;
      if (marker != 0xD0 + next_rst) return ERR_CORRUPT;
      next_rst = (next_rst + 1) & 7;
      for (int i = 0; i < ns; i++) sc[i]->pred = 0;
      ps.eobrun = 0;
      reset_reader(&br, s, s->pos);
    }
    int mx = (int)(m % per_row), my = (int)(m / per_row);
    for (int i = 0; i < ns; i++) {
      component *cp = sc[i];
      const huff_table *dc = &s->dc[cp->td], *ac = &s->ac[cp->ta];
      int hb = ns == 1 ? 1 : cp->h, vb = ns == 1 ? 1 : cp->v;
      for (int v = 0; v < vb; v++)
        for (int h = 0; h < hb; h++) {
          int bx = mx * hb + h, by = my * vb + v;
          rc = s->progressive
                   ? decode_block_prog(
                         &br, cp, dc, ac, &ps,
                         cp->coef + ((size_t)by * cp->bw + bx) * 64)
                   : decode_block(&br, cp, dc, ac, bx, by);
          if (rc) return rc;
        }
    }
  }
  if (!s->progressive)
    for (int i = 0; i < ns; i++) sc[i]->decoded = 1;
  s->pos = br.pos;
  return CODEC_OK;
}

/* After a progressive frame's last scan: refuse what libjpeg would fill
 * or smooth, then each component's blocks through the IDCT. */
static int finish_progressive(jpeg_state *s) {
  for (int c = 0; c < s->ncomp; c++) {
    const int *bits = s->comp[c].coef_bits;
    if (bits[0] < 0) return ERR_TRUNCATED;
    /* Without EOI the stream may have been cut between scans: taken only
     * when every coefficient is complete. */
    for (int k = 0; k < 64 && !s->saw_eoi; k++)
      if (bits[k] != 0) return ERR_TRUNCATED;
    /* smoothing_ok: a coefficient of 1-9 still short of full precision
     * (or never sent) makes libjpeg smooth the blocks. */
    for (int k = 1; k < 10; k++)
      if (bits[k] != 0) return ERR_SMOOTHING;
  }
  for (int c = 0; c < s->ncomp; c++) {
    component *cp = &s->comp[c];
    const size_t stride = (size_t)cp->bw * 8;
    cp->plane = malloc(stride * (size_t)cp->bh * 8);
    if (cp->plane == NULL) return ERR_NOMEM;
    for (int by = 0; by < cp->bh; by++)
      for (int bx = 0; bx < cp->bw; bx++)
        idct_islow(cp->coef + ((size_t)by * cp->bw + bx) * 64, cp->qt,
                   cp->plane + (size_t)by * 8 * stride + (size_t)bx * 8,
                   (int)stride);
  }
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
    if (s->progressive ? s->comp[c].coef_bits[0] < 0
                       : !s->comp[c].decoded)
      return 0;
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
    if (m == 0xD9) {
      s->saw_eoi = 1;
      break;
    }
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
        if ((rc = parse_sof(s, at, len))) return rc;
        s->progressive = 1;
        if (header_only) return CODEC_OK;
        break;
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
    free(s->comp[c].coef);
    s->comp[c].coef = NULL;
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
  if (rc == CODEC_OK && s->progressive) rc = finish_progressive(s);
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

/* ------------------------------------------------------------------ */
/* JPEG: the baseline encoder                                          */
/* ------------------------------------------------------------------ */

/* What libjpeg (libjpeg-turbo) writes for an RGB image after
 * jpeg_set_defaults and jpeg_set_quality(quality, force_baseline=TRUE),
 * as cv2.imencode(".jpg") calls it: JFIF APP0, one DQT per table, SOF0 of
 * three components at 4:2:0, the four standard Huffman tables, one
 * interleaved scan, no restart markers, no optimized tables. The
 * arithmetic is libjpeg's, term for term:
 *   - rgb_ycc_convert's 16-bit fixed point (the Cb/Cr rounding fudge of
 *     0.5 - epsilon included);
 *   - the prep controller's edge padding: the last column replicated to
 *     the components' block width (for chroma, at full resolution before
 *     downsampling), the last row to an even row count, then the last
 *     output row to the iMCU height;
 *   - h2v2_downsample: the mean of each 2x2 cell with the bias 1, 2, 1, 2
 *     along each row;
 *   - the accurate integer FDCT jpeg_fdct_islow (CONST_BITS 13,
 *     PASS1_BITS 2, outputs scaled by 8);
 *   - libjpeg-turbo's quantization by reciprocal multiplication
 *     (compute_reciprocal of each divisor q * 8);
 *   - the coefficient controller's dummy blocks past the image's block
 *     width and height: zero AC, the DC of the block before them in the
 *     MCU;
 *   - encode_one_block with the standard tables, 0xFF bytes stuffed, the
 *     last byte filled with ones. */

static const uint8_t std_quant[2][64] = {
    {16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
     14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
     18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
     49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99},
    {17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
     24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
     99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
     99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99}};

/* Code counts by length: DC luma, AC luma, DC chroma, AC chroma. */
static const uint8_t std_bits[4][16] = {
    {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0},
    {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d},
    {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0},
    {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77}};

static const uint8_t std_dc_vals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};

static const uint8_t std_ac_luma_vals[162] = {
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

static const uint8_t std_ac_chroma_vals[162] = {
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
  uint8_t size[256];
} huff_code;

static void make_codes(const uint8_t bits[16], const uint8_t *vals,
                       huff_code *t) {
  memset(t, 0, sizeof *t);
  int code = 0, k = 0;
  for (int len = 1; len <= 16; len++) {
    for (int i = 0; i < bits[len - 1]; i++, k++) {
      t->code[vals[k]] = (uint16_t)code++;
      t->size[vals[k]] = (uint8_t)len;
    }
    code <<= 1;
  }
}

typedef struct {
  uint8_t *out;
  size_t cap, n;
  uint64_t acc; /* pending bits, the newest lowest */
  int nbits;
  int overflow;
} bit_writer;

static inline void put_byte(bit_writer *w, uint8_t b) {
  if (w->n < w->cap)
    w->out[w->n++] = b;
  else
    w->overflow = 1;
}

static void put_bytes(bit_writer *w, const uint8_t *b, size_t n) {
  for (size_t i = 0; i < n; i++) put_byte(w, b[i]);
}

static inline void put_bits(bit_writer *w, uint32_t bits, int n) {
  w->acc = (w->acc << n) | (bits & ((1u << n) - 1u));
  w->nbits += n;
  while (w->nbits >= 8) {
    uint8_t b = (uint8_t)(w->acc >> (w->nbits - 8));
    put_byte(w, b);
    if (b == 0xFF) put_byte(w, 0);
    w->nbits -= 8;
  }
}

/* Quantization by reciprocal: libjpeg-turbo's compute_reciprocal for a
 * divisor of at least 2 (here q * 8). */
typedef struct {
  uint32_t recip[64], corr[64];
  int shift[64];
} divisors;

static void make_divisors(const uint8_t q[64], divisors *dv) {
  for (int i = 0; i < 64; i++) {
    uint32_t d = (uint32_t)q[i] << 3;
    int b = 0;
    while ((d >> (b + 1)) != 0) b++;
    int r = 16 + b;
    uint32_t fq = (1u << r) / d, fr = (1u << r) % d, c = d / 2;
    if (fr == 0) {
      fq >>= 1;
      r--;
    } else if (fr <= d / 2) {
      c++;
    } else {
      fq++;
    }
    dv->recip[i] = fq;
    dv->corr[i] = c;
    dv->shift[i] = r;
  }
}

#define FDESCALE(x, n) (((x) + ((int64_t)1 << ((n)-1))) >> (n))

/* jpeg_fdct_islow in place on samples centred on 0. */
static void fdct_islow(int32_t *data) {
  int64_t tmp0, tmp1, tmp2, tmp3, tmp4, tmp5, tmp6, tmp7;
  int64_t tmp10, tmp11, tmp12, tmp13, z1, z2, z3, z4, z5;
  for (int pass = 0; pass < 2; pass++) {
    /* Pass 0 runs along rows, pass 1 along columns. */
    const int step = pass ? 8 : 1, next = pass ? 1 : 8;
    const int shift = pass ? 13 + 2 : 13 - 2;
    int32_t *p = data;
    for (int k = 0; k < 8; k++, p += next) {
      tmp0 = p[0] + p[7 * step];
      tmp7 = p[0] - p[7 * step];
      tmp1 = p[step] + p[6 * step];
      tmp6 = p[step] - p[6 * step];
      tmp2 = p[2 * step] + p[5 * step];
      tmp5 = p[2 * step] - p[5 * step];
      tmp3 = p[3 * step] + p[4 * step];
      tmp4 = p[3 * step] - p[4 * step];
      tmp10 = tmp0 + tmp3;
      tmp13 = tmp0 - tmp3;
      tmp11 = tmp1 + tmp2;
      tmp12 = tmp1 - tmp2;
      if (pass) {
        p[0] = (int32_t)FDESCALE(tmp10 + tmp11, 2);
        p[4 * step] = (int32_t)FDESCALE(tmp10 - tmp11, 2);
      } else {
        p[0] = (int32_t)((tmp10 + tmp11) * 4);
        p[4 * step] = (int32_t)((tmp10 - tmp11) * 4);
      }
      z1 = (tmp12 + tmp13) * 4433;
      p[2 * step] = (int32_t)FDESCALE(z1 + tmp13 * 6270, shift);
      p[6 * step] = (int32_t)FDESCALE(z1 + tmp12 * -15137, shift);
      z1 = tmp4 + tmp7;
      z2 = tmp5 + tmp6;
      z3 = tmp4 + tmp6;
      z4 = tmp5 + tmp7;
      z5 = (z3 + z4) * 9633;
      tmp4 = tmp4 * 2446;
      tmp5 = tmp5 * 16819;
      tmp6 = tmp6 * 25172;
      tmp7 = tmp7 * 12299;
      z1 = z1 * -7373;
      z2 = z2 * -20995;
      z3 = z3 * -16069;
      z4 = z4 * -3196;
      z3 += z5;
      z4 += z5;
      p[7 * step] = (int32_t)FDESCALE(tmp4 + z1 + z3, shift);
      p[5 * step] = (int32_t)FDESCALE(tmp5 + z2 + z4, shift);
      p[3 * step] = (int32_t)FDESCALE(tmp6 + z2 + z3, shift);
      p[step] = (int32_t)FDESCALE(tmp7 + z1 + z4, shift);
    }
  }
}

/* One 8x8 block of a plane: centre, FDCT, quantize (natural order). */
static void forward_block(const uint8_t *plane, size_t stride,
                          const divisors *dv, int16_t out[64]) {
  int32_t ws[64];
  for (int r = 0; r < 8; r++)
    for (int c = 0; c < 8; c++)
      ws[r * 8 + c] = (int32_t)plane[(size_t)r * stride + (size_t)c] - 128;
  fdct_islow(ws);
  for (int i = 0; i < 64; i++) {
    int32_t t = ws[i];
    uint32_t a = (uint32_t)(t < 0 ? -t : t);
    uint32_t q = (uint32_t)(((uint64_t)(a + dv->corr[i]) * dv->recip[i]) >>
                            dv->shift[i]);
    out[i] = (int16_t)(t < 0 ? -(int32_t)q : (int32_t)q);
  }
}

static void encode_block(bit_writer *w, const int16_t blk[64], int *last_dc,
                         const huff_code *dc, const huff_code *ac) {
  int temp = blk[0] - *last_dc, temp2 = temp;
  *last_dc = blk[0];
  if (temp < 0) {
    temp = -temp;
    temp2--;
  }
  int nbits = 0;
  while (temp) {
    nbits++;
    temp >>= 1;
  }
  put_bits(w, dc->code[nbits], dc->size[nbits]);
  if (nbits) put_bits(w, (uint32_t)temp2, nbits);
  int run = 0;
  for (int k = 1; k < 64; k++) {
    temp = blk[natural_order[k]];
    if (temp == 0) {
      run++;
      continue;
    }
    while (run > 15) {
      put_bits(w, ac->code[0xF0], ac->size[0xF0]);
      run -= 16;
    }
    temp2 = temp;
    if (temp < 0) {
      temp = -temp;
      temp2--;
    }
    nbits = 1;
    while ((temp >>= 1)) nbits++;
    int sym = (run << 4) + nbits;
    put_bits(w, ac->code[sym], ac->size[sym]);
    put_bits(w, (uint32_t)temp2, nbits);
    run = 0;
  }
  if (run > 0) put_bits(w, ac->code[0], ac->size[0]);
}

static void put_marker_u16(bit_writer *w, int marker, int length) {
  uint8_t b[4] = {0xFF, (uint8_t)marker, (uint8_t)(length >> 8),
                  (uint8_t)length};
  put_bytes(w, b, 4);
}

/* The headers libjpeg's write_file_header, write_frame_header and
 * write_scan_header emit for this encoder's one configuration. */
static void write_headers(bit_writer *w, const uint8_t qt[2][64], int width,
                          int height) {
  static const uint8_t jfif[18] = {0xFF, 0xD8, 0xFF, 0xE0, 0, 16,  'J',
                                   'F',  'I',  'F',  0,    1, 1,   0,
                                   0,    1,    0,    1};
  put_bytes(w, jfif, sizeof jfif);
  put_bytes(w, (const uint8_t[2]){0, 0}, 2);
  for (int t = 0; t < 2; t++) {
    put_marker_u16(w, 0xDB, 67);
    put_byte(w, (uint8_t)t);
    for (int k = 0; k < 64; k++) put_byte(w, qt[t][natural_order[k]]);
  }
  put_marker_u16(w, 0xC0, 17);
  const uint8_t sof[15] = {8,    (uint8_t)(height >> 8), (uint8_t)height,
                           (uint8_t)(width >> 8), (uint8_t)width, 3,
                           1,    0x22, 0, 2, 0x11, 1, 3, 0x11, 1};
  put_bytes(w, sof, sizeof sof);
  for (int t = 0; t < 4; t++) {
    const uint8_t *vals = (t & 1) ? (t == 1 ? std_ac_luma_vals
                                            : std_ac_chroma_vals)
                                  : std_dc_vals;
    int nsym = 0;
    for (int k = 0; k < 16; k++) nsym += std_bits[t][k];
    put_marker_u16(w, 0xC4, 2 + 1 + 16 + nsym);
    put_byte(w, (uint8_t)(((t & 1) << 4) | (t >> 1)));
    put_bytes(w, std_bits[t], 16);
    put_bytes(w, vals, (size_t)nsym);
  }
  static const uint8_t sos[14] = {0xFF, 0xDA, 0, 12, 3, 1,    0x00,
                                  2,    0x11, 3, 0x11, 0, 0x3F, 0};
  put_bytes(w, sos, sizeof sos);
}

/* The most bytes jpeg_encode can write for a width x height image. */
size_t jpeg_encode_bound(int width, int height) {
  if (width <= 0 || height <= 0) return 0;
  size_t mcus = (size_t)((width + 15) / 16) * (size_t)((height + 15) / 16);
  /* 6 blocks an MCU; a block is at most 16 + 11 bits of DC and 63 AC
   * symbols of at most 16 + 10 bits: under 216 bytes, twice that with
   * every byte stuffed. */
  return 1024 + mcus * 6 * 432;
}

/* Encodes rgb, uint8 [height, width, 3], into out (cap bytes, at least
 * jpeg_encode_bound); *written gets the stream's length. */
int jpeg_encode(const uint8_t *rgb, int width, int height, int quality,
                uint8_t *out, size_t cap, size_t *written) {
  if (rgb == NULL || out == NULL || written == NULL || width <= 0 ||
      height <= 0 || width > 65535 || height > 65535)
    return ERR_BAD_ARGS;
  if ((int64_t)width * height > MAX_PIXELS) return ERR_TOO_LARGE;
  if (quality <= 0) quality = 1;
  if (quality > 100) quality = 100;
  const int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  uint8_t qt[2][64];
  divisors dv[2];
  for (int t = 0; t < 2; t++) {
    for (int i = 0; i < 64; i++) {
      long v = ((long)std_quant[t][i] * scale + 50L) / 100L;
      qt[t][i] = (uint8_t)(v <= 0 ? 1 : (v > 255 ? 255 : v));
    }
    make_divisors(qt[t], &dv[t]);
  }
  huff_code dc[2], ac[2];
  make_codes(std_bits[0], std_dc_vals, &dc[0]);
  make_codes(std_bits[1], std_ac_luma_vals, &ac[0]);
  make_codes(std_bits[2], std_dc_vals, &dc[1]);
  make_codes(std_bits[3], std_ac_chroma_vals, &ac[1]);

  const int mx = (width + 15) / 16, my = (height + 15) / 16;
  const int wb = (width + 7) / 8, hb = (height + 7) / 8; /* luma blocks */
  const size_t pw = (size_t)mx * 16, ph = (size_t)my * 16;
  const size_t cw = (size_t)mx * 8, ch = (size_t)my * 8;
  const size_t h2 = (size_t)height + (height & 1);
  uint8_t *luma = malloc(pw * ph);
  uint8_t *full = malloc(2 * pw * h2); /* Cb, Cr at full resolution */
  uint8_t *chroma = malloc(2 * cw * ch);
  if (luma == NULL || full == NULL || chroma == NULL) {
    free(luma);
    free(full);
    free(chroma);
    return ERR_NOMEM;
  }
  /* Colour conversion, right edges replicated: luma to its block width,
   * chroma (at full resolution) to twice its block width. */
  for (size_t y = 0; y < (size_t)height; y++) {
    const uint8_t *px = rgb + y * (size_t)width * 3;
    uint8_t *yr = luma + y * pw, *cb = full + y * pw,
            *cr = full + (h2 + y) * pw;
    for (size_t x = 0; x < (size_t)width; x++, px += 3) {
      const int32_t r = px[0], g = px[1], b = px[2];
      yr[x] = (uint8_t)((19595 * r + 38470 * g + 7471 * b + 32768) >> 16);
      cb[x] = (uint8_t)((-11059 * r - 21709 * g + 32768 * b +
                         (128 << 16) + 32767) >> 16);
      cr[x] = (uint8_t)((32768 * r - 27439 * g - 5329 * b + (128 << 16) +
                         32767) >> 16);
    }
    for (size_t x = (size_t)width; x < pw; x++) {
      yr[x] = yr[width - 1];
      cb[x] = cb[width - 1];
      cr[x] = cr[width - 1];
    }
  }
  for (size_t y = (size_t)height; y < ph; y++)
    memcpy(luma + y * pw, luma + (size_t)(height - 1) * pw, pw);
  if (height & 1)
    for (int c = 0; c < 2; c++)
      memcpy(full + (c * h2 + (size_t)height) * pw,
             full + (c * h2 + (size_t)height - 1) * pw, pw);
  /* h2v2 downsampling, then the last chroma row to the iMCU height. */
  for (int c = 0; c < 2; c++) {
    uint8_t *plane = chroma + (size_t)c * cw * ch;
    for (size_t y = 0; y < h2 / 2; y++) {
      const uint8_t *i0 = full + (c * h2 + 2 * y) * pw, *i1 = i0 + pw;
      uint8_t *o = plane + y * cw;
      int bias = 1;
      for (size_t x = 0; x < cw; x++, i0 += 2, i1 += 2) {
        o[x] = (uint8_t)((i0[0] + i0[1] + i1[0] + i1[1] + bias) >> 2);
        bias ^= 3;
      }
    }
    for (size_t y = h2 / 2; y < ch; y++)
      memcpy(plane + y * cw, plane + (h2 / 2 - 1) * cw, cw);
  }
  free(full);

  bit_writer w = {out, cap, 0, 0, 0, 0};
  write_headers(&w, (const uint8_t(*)[64])qt, width, height);
  int last[3] = {0, 0, 0};
  int16_t blk[6][64];
  for (int my_i = 0; my_i < my; my_i++) {
    for (int mx_i = 0; mx_i < mx; mx_i++) {
      for (int b = 0; b < 4; b++) {
        const int by = 2 * my_i + (b >> 1), bx = 2 * mx_i + (b & 1);
        if (by >= hb || bx >= wb) {
          memset(blk[b], 0, sizeof blk[b]);
          blk[b][0] = blk[b - 1][0];
        } else {
          forward_block(luma + (size_t)by * 8 * pw + (size_t)bx * 8, pw,
                        &dv[0], blk[b]);
        }
      }
      for (int c = 0; c < 2; c++)
        forward_block(chroma + (size_t)c * cw * ch +
                          (size_t)my_i * 8 * cw + (size_t)mx_i * 8,
                      cw, &dv[1], blk[4 + c]);
      for (int b = 0; b < 4; b++)
        encode_block(&w, blk[b], &last[0], &dc[0], &ac[0]);
      encode_block(&w, blk[4], &last[1], &dc[1], &ac[1]);
      encode_block(&w, blk[5], &last[2], &dc[1], &ac[1]);
    }
  }
  free(luma);
  free(chroma);
  if (w.nbits > 0) put_bits(&w, 0x7F, 7);
  put_bytes(&w, (const uint8_t[2]){0xFF, 0xD9}, 2);
  if (w.overflow) return ERR_BAD_ARGS;
  *written = w.n;
  return CODEC_OK;
}

/* ------------------------------------------------------------------ */
/* TIFF: LZW and PackBits unpacking, the horizontal predictor          */
/* ------------------------------------------------------------------ */

/* The strip or tile decoders of libtiff that data/tiff.py needs, each
 * filling exactly `need` bytes or failing: where libtiff would decode a
 * damaged chunk in part (and leave the rest of the image zero), these
 * stop. */

#define LZW_CLEAR 256
#define LZW_EOI 257
#define LZW_FIRST 258
#define LZW_CSIZE (4095 + 1024) /* libtiff's CSIZE: MAXCODE(12) + 1024 */

/* New-style TIFF LZW as libtiff's LZWDecode reads it: MSB-first codes of
 * 9 to 12 bits, the width growing once the next free entry reaches
 * 2^bits - 1 (one early), a stream that starts with Clear; an undefined
 * code is an error, and the data's end stands for EOI. A string that
 * overruns the output is cut, as libtiff cuts it. */
int tiff_lzw_decode(const uint8_t *src, size_t n, uint8_t *out,
                    size_t need) {
  if ((src == NULL && n) || (out == NULL && need)) return ERR_BAD_ARGS;
  uint16_t *prefix = malloc(LZW_CSIZE * sizeof *prefix);
  uint16_t *length = calloc(LZW_CSIZE, sizeof *length);
  uint8_t *first = malloc(LZW_CSIZE), *last = malloc(LZW_CSIZE);
  if (prefix == NULL || length == NULL || first == NULL || last == NULL) {
    free(prefix);
    free(length);
    free(first);
    free(last);
    return ERR_NOMEM;
  }
  for (int i = 0; i < 256; i++) {
    length[i] = 1;
    first[i] = last[i] = (uint8_t)i;
  }
  const uint64_t total = (uint64_t)n * 8;
  uint64_t bit = 0;
  int nbits = 9, free_ent = LZW_FIRST, old = -1, rc = CODEC_OK;
  size_t o = 0;
#define LZW_NEXT(code)                                              \
  do {                                                              \
    if (bit + (uint64_t)nbits > total) {                            \
      (code) = LZW_EOI;                                             \
    } else {                                                        \
      int v_ = 0;                                                   \
      for (int k_ = 0; k_ < nbits; k_++, bit++)                     \
        v_ = (v_ << 1) | ((src[bit >> 3] >> (7 - (bit & 7))) & 1); \
      (code) = v_;                                                  \
    }                                                               \
  } while (0)
  while (o < need) {
    int code;
    LZW_NEXT(code);
    if (code == LZW_EOI) break;
    if (code == LZW_CLEAR) {
      do {
        free_ent = LZW_FIRST;
        nbits = 9;
        memset(length + LZW_FIRST, 0,
               (LZW_CSIZE - LZW_FIRST) * sizeof *length);
        LZW_NEXT(code);
      } while (code == LZW_CLEAR);
      if (code == LZW_EOI) break;
      if (code > LZW_CLEAR) {
        rc = ERR_CORRUPT;
        break;
      }
      out[o++] = (uint8_t)code;
      old = code;
      continue;
    }
    if (old < 0 || free_ent >= LZW_CSIZE) {
      rc = ERR_CORRUPT;
      break;
    }
    prefix[free_ent] = (uint16_t)old;
    first[free_ent] = first[old];
    length[free_ent] = (uint16_t)(length[old] + 1);
    last[free_ent] = code < free_ent ? first[code] : first[old];
    if (++free_ent > (1 << nbits) - 2 && nbits < 12) nbits++;
    old = code;
    const size_t len = length[code];
    if (len == 0) {
      rc = ERR_CORRUPT;
      break;
    }
    const size_t room = need - o;
    int c = code;
    for (size_t k = len; k-- > 0;) {
      if (k < room) out[o + k] = last[c];
      c = prefix[c];
    }
    o += len < room ? len : room;
  }
#undef LZW_NEXT
  free(prefix);
  free(length);
  free(first);
  free(last);
  if (rc == CODEC_OK && o < need) rc = ERR_TRUNCATED;
  return rc;
}

/* PackBits as libtiff's PackBitsDecode reads it: a run or a literal that
 * overruns the output is cut, -128 is a no-op. */
int tiff_packbits_decode(const uint8_t *src, size_t n, uint8_t *out,
                         size_t need) {
  if ((src == NULL && n) || (out == NULL && need)) return ERR_BAD_ARGS;
  size_t i = 0, o = 0;
  while (i < n && o < need) {
    int h = (int8_t)src[i++];
    if (h == -128) continue;
    if (h < 0) {
      size_t run = (size_t)(1 - h);
      if (i >= n) break;
      if (run > need - o) run = need - o;
      memset(out + o, src[i++], run);
      o += run;
    } else {
      size_t lit = (size_t)h + 1;
      if (lit > need - o) lit = need - o;
      if (lit > n - i) break;
      memcpy(out + o, src + i, lit);
      o += lit;
      i += lit;
    }
  }
  return o < need ? ERR_TRUNCATED : CODEC_OK;
}

/* Undoes Predictor 2 (horizontal differencing) in place on rows of
 * row_samples samples of 1 or 2 bytes (native order): each sample adds
 * the one `stride` samples before it, modulo 2^bits. */
int tiff_unpredict(uint8_t *buf, size_t rows, size_t row_samples,
                   uint32_t stride, uint32_t bytes) {
  if (buf == NULL || stride == 0 || (bytes != 1 && bytes != 2) ||
      row_samples % stride)
    return ERR_BAD_ARGS;
  for (size_t r = 0; r < rows; r++) {
    if (bytes == 1) {
      uint8_t *p = buf + r * row_samples;
      for (size_t i = stride; i < row_samples; i++)
        p[i] = (uint8_t)(p[i] + p[i - stride]);
    } else {
      uint8_t *p = buf + r * row_samples * 2;
      for (size_t i = stride; i < row_samples; i++) {
        uint16_t a, b;
        memcpy(&a, p + 2 * i, 2);
        memcpy(&b, p + 2 * (i - stride), 2);
        a = (uint16_t)(a + b);
        memcpy(p + 2 * i, &a, 2);
      }
    }
  }
  return CODEC_OK;
}
