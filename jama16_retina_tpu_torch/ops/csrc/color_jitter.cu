// Colour jitter for Hopper (sm_90a): kernels B1 and B2 of the port.
//
// B1 replaces jama16_retina_tpu/ops/pallas_augment.py::fused_color_jitter
// (_kernel :40, pallas_call :74). Per image b and pixel:
//   x_k   = u8_k * scale - 1                      (scale = float32(1/127.5))
//   out_c = clip(((A[c,0]*x_r + A[c,1]*x_g) + A[c,2]*x_b) + o[c], -1, 1)
// uint8 NHWC in, float32 NHWC out, A [B,3,3] and o [B,3] float32.
//
// B2 replaces pallas_augment.py::fused_normalize_color_jitter
// (_fused_kernel :148, pallas_call :230): the same map, with the per-image
// channel means formed on the device:
//   mean_k = float32(sum_k) * inv - 1            (inv = float32(1/(P*127.5)))
//   o_k    = mean_k * (1 - c) + bright
//   off_c  = (M[c,0]*o_r + M[c,1]*o_g) + M[c,2]*o_b
//   out_c  = clip(c * ((M[c,0]*x_r + M[c,1]*x_g) + M[c,2]*x_b) + off_c, -1, 1)
//
// Bound: memory. Per pixel 3 bytes in and 12 bytes out against 9
// multiply-adds, far below the card's ridge point. At the train batch
// [32, 299, 299, 3] that is 42.9 MB, 12.8 us at the H100 SXM's published
// 3.35 TB/s (700 W power limit). B2 reads the bytes twice (a sum pass,
// then the apply pass): 51.5 MB, 15.4 us.
//
// Design: the interleaved NHWC bytes are read where they lie, so the TPU
// wrapper's transpose to [B, 3, P], its pad to 8192-pixel chunks and its
// transpose back (a TPU lane-tiling choice) do not exist here. One thread
// takes one pixel at a time (3 byte loads, 3 float stores), grid =
// (pixel tiles, image), a grid-stride loop over the image's pixels.
//
// The TPU's B2 relies on the grid running in order: phase 0 of an image
// fills a VMEM accumulator before phase 1 reads it. A CUDA grid has no
// order, so B2 is two kernels on one stream. The sum kernel is B4's
// (serve_preprocess.cu): 384 threads and a stride that is a multiple of 3
// keep each thread on one channel; 32-bit sums per thread, a warp shuffle,
// one 64-bit atomicAdd per block and channel; the sums are exact, where
// the TPU summed in float32 (inexact past 2^24; a 299x299 channel reaches
// 2.3e7). The apply kernel then forms the means and offsets per block.
//
// No FMA is contracted: __fmul_rn / __fadd_rn keep one rounding per
// operation in the plain PyTorch version's order (ops/color_jitter.py),
// so the card's rows are bitwise the plain version's.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPixelsPerThread = 4;
constexpr int kSumThreads = 384;  // a multiple of 3: one channel per thread
constexpr int kSumWarps = kSumThreads / 32;
constexpr int kSumItemsPerThread = 8;

__device__ __forceinline__ float clip1(float v) {
  return fminf(fmaxf(v, -1.0f), 1.0f);
}

__device__ __forceinline__ float norm(uint8_t v, float scale) {
  return __fadd_rn(__fmul_rn((float)v, scale), -1.0f);
}

// ((m0*r + m1*g) + m2*b), one rounding per operation.
__device__ __forceinline__ float row(const float* m, float r, float g,
                                     float b) {
  return __fadd_rn(__fadd_rn(__fmul_rn(m[0], r), __fmul_rn(m[1], g)),
                   __fmul_rn(m[2], b));
}

__global__ void __launch_bounds__(kThreads)
color_jitter_kernel(const uint8_t* __restrict__ x,
                    const float* __restrict__ affine,
                    const float* __restrict__ offset,
                    float* __restrict__ out, long long n_pixels,
                    float scale) {
  const long long image = blockIdx.y;
  float a[9], o[3];
#pragma unroll
  for (int k = 0; k < 9; ++k) a[k] = affine[image * 9 + k];
#pragma unroll
  for (int c = 0; c < 3; ++c) o[c] = offset[image * 3 + c];
  const uint8_t* xb = x + image * n_pixels * 3;
  float* ob = out + image * n_pixels * 3;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long p = (long long)blockIdx.x * kThreads + threadIdx.x;
       p < n_pixels; p += stride) {
    const float r = norm(xb[3 * p], scale);
    const float g = norm(xb[3 * p + 1], scale);
    const float b = norm(xb[3 * p + 2], scale);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      ob[3 * p + c] = clip1(__fadd_rn(row(a + 3 * c, r, g, b), o[c]));
    }
  }
}

__device__ __forceinline__ unsigned warp_sum(unsigned v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, offset);
  }
  return v;
}

__global__ void __launch_bounds__(kSumThreads)
channel_sums_kernel(const uint8_t* __restrict__ x,
                    unsigned long long* __restrict__ sums,
                    long long n_elems) {
  const long long image = blockIdx.y;
  const uint8_t* xb = x + image * n_elems;
  const long long first = (long long)blockIdx.x * kSumThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kSumThreads;
  unsigned sum = 0;
  for (long long e = first; e < n_elems; e += stride) sum += xb[e];
  // The stride is a multiple of 3: every byte this thread read is of
  // channel first % 3.
  const int channel = (int)(first % 3);
  const unsigned part[3] = {channel == 0 ? sum : 0u, channel == 1 ? sum : 0u,
                            channel == 2 ? sum : 0u};
  __shared__ unsigned long long warp_part[kSumWarps][3];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const unsigned v = warp_sum(part[k]);
    if (lane == 0) warp_part[warp][k] = v;
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    unsigned long long total = 0;
#pragma unroll
    for (int w = 0; w < kSumWarps; ++w) total += warp_part[w][threadIdx.x];
    if (total) atomicAdd(&sums[image * 3 + threadIdx.x], total);
  }
}

__global__ void __launch_bounds__(kThreads)
normalize_color_jitter_kernel(const uint8_t* __restrict__ x,
                              const float* __restrict__ m_chroma,
                              const float* __restrict__ contrast,
                              const float* __restrict__ brightness,
                              const long long* __restrict__ sums,
                              float* __restrict__ out, long long n_pixels,
                              float inv, float scale) {
  const long long image = blockIdx.y;
  float m[9], off[3];
#pragma unroll
  for (int k = 0; k < 9; ++k) m[k] = m_chroma[image * 9 + k];
  const float c = contrast[image];
  const float one_minus_c = __fadd_rn(1.0f, -c);
  const float bright = brightness[image];
  float o_pre[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float mean =
        __fadd_rn(__fmul_rn(__ll2float_rn(sums[image * 3 + k]), inv), -1.0f);
    o_pre[k] = __fadd_rn(__fmul_rn(mean, one_minus_c), bright);
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) off[k] = row(m + 3 * k, o_pre[0], o_pre[1],
                                           o_pre[2]);
  const uint8_t* xb = x + image * n_pixels * 3;
  float* ob = out + image * n_pixels * 3;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long p = (long long)blockIdx.x * kThreads + threadIdx.x;
       p < n_pixels; p += stride) {
    const float r = norm(xb[3 * p], scale);
    const float g = norm(xb[3 * p + 1], scale);
    const float b = norm(xb[3 * p + 2], scale);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      ob[3 * p + k] =
          clip1(__fadd_rn(__fmul_rn(c, row(m + 3 * k, r, g, b)), off[k]));
    }
  }
}

bool bad_shape(int batch, long long n_pixels) {
  return batch <= 0 || batch > 65535 || n_pixels <= 0;
}

dim3 pixel_grid(int batch, long long n_pixels) {
  const long long per_block = (long long)kThreads * kPixelsPerThread;
  const long long blocks = (n_pixels + per_block - 1) / per_block;
  return dim3((unsigned)blocks, (unsigned)batch);
}

}  // namespace

// B1. Launches on `stream`; returns cudaGetLastError() (0 on success).
// x: uint8 [batch, n_pixels, 3]; affine: float32 [batch, 3, 3]; offset:
// float32 [batch, 3]; out: float32 [batch, n_pixels, 3].
extern "C" int color_jitter_launch(const void* x, const void* affine,
                                   const void* offset, void* out, int batch,
                                   long long n_pixels, float scale,
                                   void* stream) {
  if (bad_shape(batch, n_pixels)) return (int)cudaErrorInvalidValue;
  color_jitter_kernel<<<pixel_grid(batch, n_pixels), kThreads, 0,
                        (cudaStream_t)stream>>>(
      static_cast<const uint8_t*>(x), static_cast<const float*>(affine),
      static_cast<const float*>(offset), static_cast<float*>(out), n_pixels,
      scale);
  return (int)cudaGetLastError();
}

// B2. Two kernels on `stream`: exact channel sums into `sums` (int64
// [batch, 3], zeroed by the caller), then the apply pass. m_chroma:
// float32 [batch, 3, 3]; contrast, brightness: float32 [batch].
extern "C" int normalize_color_jitter_launch(
    const void* x, const void* m_chroma, const void* contrast,
    const void* brightness, void* sums, void* out, int batch,
    long long n_pixels, float inv, float scale, void* stream) {
  if (bad_shape(batch, n_pixels)) return (int)cudaErrorInvalidValue;
  const long long n_elems = 3 * n_pixels;
  const long long per_block = (long long)kSumThreads * kSumItemsPerThread;
  const dim3 sum_grid((unsigned)((n_elems + per_block - 1) / per_block),
                      (unsigned)batch);
  channel_sums_kernel<<<sum_grid, kSumThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const uint8_t*>(x), static_cast<unsigned long long*>(sums),
      n_elems);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  normalize_color_jitter_kernel<<<pixel_grid(batch, n_pixels), kThreads, 0,
                                  (cudaStream_t)stream>>>(
      static_cast<const uint8_t*>(x), static_cast<const float*>(m_chroma),
      static_cast<const float*>(contrast),
      static_cast<const float*>(brightness),
      static_cast<const long long*>(sums), static_cast<float*>(out), n_pixels,
      inv, scale);
  return (int)cudaGetLastError();
}
