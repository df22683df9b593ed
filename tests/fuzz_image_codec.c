/* Mutation harness for the host codec of
 * jama16_retina_tpu_torch/ops/csrc/image_codec.c, built with the codec
 * under -fsanitize=address,undefined (tests/test_torch_jpeg.py,
 * tests/test_torch_tiff.py), so any read or write out of bounds aborts
 * the run.
 *
 *   fuzz_image_codec ITERATIONS FILE... [lzw:FILE]... [packbits:FILE]...
 *
 * A plain FILE is a JPEG. Each is decoded whole, cut at many lengths,
 * with 1-8 random bytes changed (half of them in the headers), with codes
 * moved between the lengths of each Huffman table (the symbol count kept,
 * so the segment still parses and the table may be oversubscribed), and
 * with each header byte set in turn to a few extreme values. A file
 * prefixed lzw: or packbits: is a TIFF strip in that packing, unpacked
 * into outputs shorter and longer than it holds, whole, cut and mutated;
 * random LZW code streams (codes past the table among them) follow. Then
 * the encoder encodes random images of 1-48 x 1-48 pixels at qualities
 * -5 to 110 into buffers of exactly jpeg_encode_bound bytes, and into
 * ones too small, and the predictor runs over exact-size buffers. Every
 * input is copied into a buffer of exactly its size. Prints
 * "OK <decoded> <refused>". */
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

int jpeg_header(const uint8_t *data, size_t n, int *width, int *height);
int jpeg_decode(const uint8_t *data, size_t n, uint8_t *out, int width,
                int height);
int tiff_lzw_decode(const uint8_t *src, size_t n, uint8_t *out, size_t need);
int tiff_packbits_decode(const uint8_t *src, size_t n, uint8_t *out,
                         size_t need);
int tiff_unpredict(uint8_t *buf, size_t rows, size_t row_samples,
                   uint32_t stride, uint32_t bytes);
size_t jpeg_encode_bound(int width, int height);
int jpeg_encode(const uint8_t *rgb, int width, int height, int quality,
                uint8_t *out, size_t cap, size_t *written);

static uint64_t state = 88172645463325252ull;
static long n_ok = 0, n_refused = 0;

static uint64_t rnd(void) {
  state ^= state << 13;
  state ^= state >> 7;
  state ^= state << 17;
  return state;
}

static void decode(const uint8_t *d, size_t n) {
  uint8_t *copy = malloc(n ? n : 1);
  memcpy(copy, d, n);
  int w, h, rc = jpeg_header(copy, n, &w, &h);
  if (rc == 0 && (long)w * h <= 4000000) {
    uint8_t *out = malloc((size_t)w * h * 3);
    rc = jpeg_decode(copy, n, out, w, h);
    free(out);
  }
  if (rc) n_refused++;
  else n_ok++;
  free(copy);
}

static void unpack(int lzw, const uint8_t *d, size_t n, size_t need) {
  uint8_t *copy = malloc(n ? n : 1), *out = malloc(need ? need : 1);
  memcpy(copy, d, n);
  int rc = lzw ? tiff_lzw_decode(copy, n, out, need)
               : tiff_packbits_decode(copy, n, out, need);
  if (rc) n_refused++;
  else n_ok++;
  free(copy);
  free(out);
}

static void fuzz_chunk(int lzw, const uint8_t *d, long n, int iters) {
  uint8_t *m = malloc(n ? n : 1);
  const size_t needs[] = {0, 1, 7, (size_t)n, (size_t)n * 3, 65536};
  for (size_t k = 0; k < sizeof needs / sizeof needs[0]; k++)
    unpack(lzw, d, n, needs[k]);
  for (long cut = 0; cut < n; cut += n > 2000 ? n / 200 : 1)
    unpack(lzw, d, cut, 4096);
  for (int it = 0; it < iters; it++) {
    memcpy(m, d, n);
    for (int j = 0, k = 1 + rnd() % 8; j < k && n; j++)
      m[rnd() % n] = rnd();
    unpack(lzw, m, n, 1 + rnd() % 20000);
  }
  free(m);
}

/* LZW streams of random codes after a Clear: widths grow as the decoder
 * grows them, so most codes land past the table's end. */
static void fuzz_lzw_codes(int iters) {
  uint8_t buf[512];
  for (int it = 0; it < iters; it++) {
    memset(buf, 0, sizeof buf);
    size_t bit = 0;
    int nbits = 9, entries = 258;
    for (int c = 0; c < 300 && bit + 12 < sizeof buf * 8; c++) {
      int code = c == 0 ? 256 : (int)(rnd() % (rnd() & 1 ? 4096 : 300));
      for (int b = nbits - 1; b >= 0; b--, bit++)
        if ((code >> b) & 1) buf[bit >> 3] |= (uint8_t)(0x80 >> (bit & 7));
      if (c > 0 && ++entries > (1 << nbits) - 2 && nbits < 12) nbits++;
    }
    unpack(1, buf, (bit + 7) / 8, 1 + rnd() % 4000);
  }
}

static void fuzz_encoder(int iters) {
  for (int it = 0; it < iters; it++) {
    int w = 1 + rnd() % 48, h = 1 + rnd() % 48, q = (int)(rnd() % 116) - 5;
    size_t n = (size_t)w * h * 3, bound = jpeg_encode_bound(w, h), wrote;
    uint8_t *rgb = malloc(n), *out = malloc(bound);
    for (size_t i = 0; i < n; i++) rgb[i] = (it & 1) ? rnd() : (i * 7) >> 4;
    int rc = jpeg_encode(rgb, w, h, q, out, bound, &wrote);
    if (rc != 0 || wrote > bound) abort();
    n_ok++;
    size_t small = wrote / 2;
    uint8_t *tight = malloc(small ? small : 1);
    if (jpeg_encode(rgb, w, h, q, tight, small, &wrote) == 0) abort();
    n_refused++;
    free(tight);
    free(rgb);
    free(out);
  }
}

static void fuzz_predictor(int iters) {
  for (int it = 0; it < iters; it++) {
    uint32_t bytes = 1 + rnd() % 2, stride = 1 + rnd() % 4;
    size_t rows = rnd() % 5, per = rnd() % 40;
    size_t n = rows * per * bytes;
    uint8_t *buf = malloc(n ? n : 1);
    for (size_t i = 0; i < n; i++) buf[i] = rnd();
    if (tiff_unpredict(buf, rows, per, stride, bytes)) n_refused++;
    else n_ok++;
    free(buf);
  }
}

int main(int argc, char **argv) {
  if (argc < 3) return 2;
  int iters = atoi(argv[1]);
  for (int a = 2; a < argc; a++) {
    int lzw = strncmp(argv[a], "lzw:", 4) == 0;
    int packbits = strncmp(argv[a], "packbits:", 9) == 0;
    const char *path = argv[a] + (lzw ? 4 : packbits ? 9 : 0);
    FILE *f = fopen(path, "rb");
    if (f == NULL) return 2;
    fseek(f, 0, SEEK_END);
    long n = ftell(f);
    fseek(f, 0, SEEK_SET);
    uint8_t *d = malloc(n), *m = malloc(n);
    if (fread(d, 1, n, f) != (size_t)n) return 2;
    fclose(f);
    if (lzw || packbits) {
      fuzz_chunk(lzw, d, n, iters);
      free(m);
      free(d);
      continue;
    }
    long head = n < 700 ? n : 700;
    decode(d, n);
    for (long cut = 0; cut < n; cut += n > 4000 ? n / 400 : 1) decode(d, cut);
    for (int it = 0; it < iters; it++) {
      memcpy(m, d, n);
      for (int j = 0, k = 1 + rnd() % 8; j < k; j++) {
        long at = (rnd() & 1) ? (long)(rnd() % head) : (long)(rnd() % n);
        switch (rnd() % 3) {
          case 0: m[at] ^= 1 << (rnd() % 8); break;
          case 1: m[at] = rnd(); break;
          default: m[at] = (rnd() & 1) ? 0xFF : 0; break;
        }
      }
      decode(m, n);
      decode(m, rnd() % n);
    }
    for (long p = 0; p + 21 < n; p++) {
      if (d[p] != 0xFF || d[p + 1] != 0xC4) continue;
      for (int it = 0; it < iters; it++) {
        memcpy(m, d, n);
        uint8_t *count = m + p + 5;
        int to = rnd() % 16, from = rnd() % 16;
        int k = 1 + rnd() % (count[from] ? count[from] : 1);
        if (count[from] < k || count[to] + k > 255) continue;
        count[to] += k;
        count[from] -= k;
        decode(m, n);
      }
    }
    static const uint8_t values[] = {0, 1, 2, 0x10, 0x7F, 0x80, 0xFE, 0xFF};
    for (long at = 0; at < head; at++)
      for (size_t v = 0; v < sizeof values; v++) {
        memcpy(m, d, n);
        m[at] = values[v];
        decode(m, n);
      }
    free(m);
    free(d);
  }
  fuzz_lzw_codes(iters);
  fuzz_encoder(iters / 4 + 1);
  fuzz_predictor(iters);
  printf("OK %ld %ld\n", n_ok, n_refused);
  return 0;
}
