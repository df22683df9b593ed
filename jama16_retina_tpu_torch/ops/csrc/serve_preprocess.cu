// Fused serve preprocess for Hopper (sm_90a).
//
// Replaces the TPU kernel jama16_retina_tpu/ops/pallas_serve.py::
// fused_serve_preprocess (_serve_kernel :50, pallas_call :120). One pass
// over a uint8 NHWC batch [B, H, W, 3] writes
//   out[b, h, w, c] = u8 * scale - 1   (scale = float32(1/127.5)), NHWC f32
// and adds each image's raw sums [sum_r, sum_g, sum_b, sum of squares over
// all channels] into sums[b, 0:4] (int64, zeroed by the caller). A float64
// host epilogue (ops/serve_preprocess.py::stats_from_sums) turns the sums
// into mean_r/g/b and std.
//
// Bound: memory. The work is B*P*3 bytes read plus B*P*3*4 bytes written
// (P = H*W) against ~4 integer and 2 float operations per byte, far below
// the card's ridge point. At B=8, 299x299 that is 10.7 MB, about 3.2 us
// at the H100 SXM's published 3.35 TB/s (700 W power limit).
//
// Design, against that bound: one pass, reading the interleaved NHWC bytes
// where they lie and writing NHWC float32 directly, so there is no
// transpose and no pad copy (the TPU kernel's channels-first [B, 3, P_pad]
// layout was a lane-tiling choice). Grid = (pixel tiles, image). A block
// has 384 threads, a multiple of 3, and every thread steps through its
// image's bytes with a stride of gridDim.x * 384, so each thread only ever
// sees one channel and keeps one channel sum and one sum of squares.
//
// The TPU kernel summed in float32 in grid order. A CUDA grid has no
// order, and at 299x299 a channel sum reaches 255 * 89401 ~ 2.3e7 and the
// sum of squares ~1.7e10, both past 2^24 where float32 sums are inexact.
// So the sums here are integers: 32-bit per thread (at most 8 bytes per
// thread, <= 8 * 255^2), a warp-shuffle then shared-memory reduction per
// block, and one 64-bit atomicAdd per block and statistic. The result is
// exact and the same on every run.
//
// nvcc contracts x * scale - 1 into an FMA by default; __fmul_rn and
// __fadd_rn forbid that, so the rows are bitwise those of the plain
// PyTorch version (two rounded operations).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 384;  // a multiple of 3: see the note above
constexpr int kWarps = kThreads / 32;
constexpr int kItemsPerThread = 8;

__device__ __forceinline__ unsigned warp_sum(unsigned v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, offset);
  }
  return v;
}

__global__ void __launch_bounds__(kThreads)
serve_preprocess_kernel(const uint8_t* __restrict__ x,
                        float* __restrict__ out,
                        unsigned long long* __restrict__ sums,
                        long long n_elems, float scale) {
  const long long image = blockIdx.y;
  const uint8_t* xb = x + image * n_elems;
  float* ob = out + image * n_elems;
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kThreads;

  unsigned sum = 0, sumsq = 0;
  for (long long e = first; e < n_elems; e += stride) {
    const unsigned v = xb[e];
    sum += v;
    sumsq += v * v;
    ob[e] = __fadd_rn(__fmul_rn((float)v, scale), -1.0f);
  }

  // The stride is a multiple of 3, so every byte this thread read is of
  // channel first % 3.
  const int channel = (int)(first % 3);
  const unsigned part[4] = {channel == 0 ? sum : 0u, channel == 1 ? sum : 0u,
                            channel == 2 ? sum : 0u, sumsq};
  __shared__ unsigned long long warp_part[kWarps][4];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const unsigned v = warp_sum(part[k]);
    if (lane == 0) warp_part[warp][k] = v;
  }
  __syncthreads();
  if (threadIdx.x < 4) {
    unsigned long long total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += warp_part[w][threadIdx.x];
    if (total) atomicAdd(&sums[image * 4 + threadIdx.x], total);
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// x: uint8 [batch, n_pixels, 3]; out: float32, same shape; sums: int64
// [batch, 4], zeroed by the caller.
extern "C" int serve_preprocess_launch(const void* x, void* out, void* sums,
                                       int batch, long long n_pixels,
                                       float scale, void* stream) {
  if (batch <= 0 || batch > 65535 || n_pixels <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const long long n_elems = 3 * n_pixels;
  const long long per_block = (long long)kThreads * kItemsPerThread;
  const long long blocks = (n_elems + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, (unsigned)batch);
  serve_preprocess_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const uint8_t*>(x), static_cast<float*>(out),
      static_cast<unsigned long long*>(sums), n_elems, scale);
  return (int)cudaGetLastError();
}
