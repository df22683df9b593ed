/* Mutation harness for the JPEG decoder of
 * jama16_retina_tpu_torch/ops/csrc/image_codec.c, built with the codec
 * under -fsanitize=address,undefined (tests/test_torch_jpeg.py), so any
 * read or write out of bounds aborts the run.
 *
 *   fuzz_image_codec ITERATIONS FILE...
 *
 * Each file is decoded whole, cut at many lengths, with 1-8 random bytes
 * changed (half of them in the headers), with codes moved between the
 * lengths of each Huffman table (the symbol count kept, so the segment
 * still parses and the table may be oversubscribed), and with each header
 * byte set in turn to a few extreme values. Every input is copied into a
 * buffer of exactly its size. Prints "OK <decoded> <refused>". */
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

int jpeg_header(const uint8_t *data, size_t n, int *width, int *height);
int jpeg_decode(const uint8_t *data, size_t n, uint8_t *out, int width,
                int height);

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

int main(int argc, char **argv) {
  if (argc < 3) return 2;
  int iters = atoi(argv[1]);
  for (int a = 2; a < argc; a++) {
    FILE *f = fopen(argv[a], "rb");
    if (f == NULL) return 2;
    fseek(f, 0, SEEK_END);
    long n = ftell(f);
    fseek(f, 0, SEEK_SET);
    uint8_t *d = malloc(n), *m = malloc(n);
    if (fread(d, 1, n, f) != (size_t)n) return 2;
    fclose(f);
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
  printf("OK %ld %ld\n", n_ok, n_refused);
  return 0;
}
