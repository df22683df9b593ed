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
// 3.35 TB/s (700 W power limit).
//
// B1: the interleaved NHWC bytes are read where they lie, so the TPU
// wrapper's transpose to [B, 3, P], its pad to 8192-pixel chunks and its
// transpose back (a TPU lane-tiling choice) do not exist here. One thread
// takes one pixel at a time (3 byte loads, 3 float stores), grid =
// (pixel tiles, image), a grid-stride loop over the image's pixels.
//
// B2 needs every byte of an image summed before any output of that image
// is written. The TPU kernel gets that from its grid running in order
// (phase 0 fills a VMEM accumulator, phase 1 reads it). A CUDA grid has no
// order, so B2 has two routes, chosen by image size in the wrapper
// (ops/color_jitter.py::_b2_plan), never on a failure:
//
// - Single pass (every preset: 299 px and 64 px). One thread block cluster
//   per image, one launch, the bytes read from device memory once. Each of
//   the C blocks of a cluster takes a slice of the image's bytes (a
//   multiple of 12 bytes, so it starts on a pixel and on channel 0; the
//   last slice takes the remainder). Phase 0: one thread copies the
//   slice's 16-byte-aligned middle into shared memory with one TMA bulk
//   copy (cp.async.bulk, completion on an mbarrier) while the others load
//   the unaligned head and tail bytes (an image of 3*P bytes starts
//   unaligned when P is odd) and zero the padding around them; then 32-bit
//   word loads from shared memory give exact per-thread channel sums, a
//   warp shuffle and a shared-memory step give the block's three 64-bit
//   partials. The cluster barrier stands in for the TPU's grid order:
//   after it every block reads the C partials through distributed shared
//   memory in rank order, so all blocks hold the same exact sums, with no
//   global atomics, no sums tensor and no fill. Phase 1 writes the slice's
//   outputs from the bytes in shared memory, one float4 per thread and
//   step, consecutive threads on consecutive 16 bytes, aligned on the
//   batch's flat index (up to 3 scalar floats peeled at each end of a
//   slice). A float4 spans at most 2 pixels; 384 threads step 1536 floats,
//   a multiple of 3, so a thread's channel phase and coefficient rows stay
//   fixed over its loop. A second cluster barrier keeps every block alive
//   until its peers have read its partials. Shared memory per block: a
//   256-byte header plus the slice rounded out for alignment; at C = 8 a
//   299x299 image is 8 slices of 33,528 bytes (33,824 bytes of shared
//   memory a block, 256 blocks for the train batch).
// - Two pass, for an image larger than C blocks' shared memory (about
//   1.86 MB, 786x786 px, at C = 8): an exact channel-sum kernel (B4's: 384
//   threads, a stride that is a multiple of 3 keeps each thread on one
//   channel, 64-bit atomicAdd per block into a zeroed int64 [B, 3]), then
//   an apply kernel that reads the bytes again (51.5 MB at the train
//   batch, 15.4 us) and forms the means and offsets per block.
//
// The sums are exact integers on both routes, where the TPU summed in
// float32 (inexact past 2^24; a 299x299 channel reaches 2.3e7). No FMA is
// contracted: __fmul_rn / __fadd_rn keep one rounding per operation in the
// plain PyTorch version's order (ops/color_jitter.py), so the card's rows
// are bitwise the plain version's.

#include <climits>
#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kPixelsPerThread = 4;
constexpr int kSumThreads = 384;  // a multiple of 3: one channel per thread
constexpr int kSumWarps = kSumThreads / 32;
constexpr int kSumItemsPerThread = 8;
// B2's single-pass route. 384 threads: a multiple of 3 (see the header).
constexpr int kClusterThreads = 384;
constexpr int kClusterWarps = kClusterThreads / 32;
constexpr int kMaxCluster = 16;
// Dynamic shared memory of a block: [0, 8) the bulk copy's mbarrier,
// [8, 32) the block's channel partials (u64, read by its peers), [32, 56)
// the image's sums (u64), [64, 64 + 12 * kClusterWarps) the warp partials
// (u32 [warp][channel]); the slice's bytes from kHeaderBytes on.
constexpr int kHeaderBytes = 256;

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

// --- B2, single-pass route: one thread block cluster per image ---------

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbarrier_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                   shared_addr(bar)),
               "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbarrier_expect_tx(uint64_t* bar,
                                                   unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          shared_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbarrier_wait(uint64_t* bar,
                                              unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(shared_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// TMA bulk copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) from device memory into this block's shared memory.
__device__ __forceinline__ void bulk_copy_to_shared(void* dst, const void* src,
                                                    unsigned bytes,
                                                    uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(shared_addr(dst)),
      "l"(src), "r"(bytes), "r"(shared_addr(bar))
      : "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// u8 * scale - 1 with two roundings, as norm(); float(v) is formed exactly
// as (2^23 + v) - 2^23 from the bits, two full-rate operations where an
// integer-to-float conversion runs at a quarter of the rate.
__device__ __forceinline__ float norm_bits(unsigned v, float scale) {
  const float fv = __fadd_rn(__uint_as_float(0x4B000000u | v), -8388608.0f);
  return __fadd_rn(__fmul_rn(fv, scale), -1.0f);
}

// One output: clip(c * ((m0*r + m1*g) + m2*b) + off, -1, 1).
__device__ __forceinline__ float jitter(const float* m, float c, float off,
                                        float r, float g, float b) {
  return clip1(__fadd_rn(__fmul_rn(c, row(m, r, g, b)), off));
}

// Grid = batch * C blocks in clusters of C (one cluster per image), 384
// threads, shared memory as laid out at kHeaderBytes. Block `rank` of an
// image takes its bytes [rank * slice_bytes, +slice_bytes) clipped to the
// image; out is 16-byte aligned.
__global__ void __launch_bounds__(kClusterThreads)
normalize_color_jitter_cluster_kernel(const uint8_t* __restrict__ x,
                                      const float* __restrict__ m_chroma,
                                      const float* __restrict__ contrast,
                                      const float* __restrict__ brightness,
                                      float* __restrict__ out,
                                      long long n_elems, int slice_bytes,
                                      float inv, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  unsigned long long* partial =
      reinterpret_cast<unsigned long long*>(smem + 8);
  unsigned long long* image_sums =
      reinterpret_cast<unsigned long long*>(smem + 32);
  unsigned* warp_part = reinterpret_cast<unsigned*>(smem + 64);
  unsigned char* data = smem + kHeaderBytes;

  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const unsigned n_ranks = cluster.num_blocks();
  const long long image = blockIdx.x / n_ranks;
  const int tid = threadIdx.x;

  // The slice, as flat indices of the batch's bytes (= of its floats).
  const long long lo = min((long long)rank * slice_bytes, n_elems);
  const long long hi = min(lo + slice_bytes, n_elems);
  const int len = (int)(hi - lo);
  const long long f_lo = image * n_elems + lo;
  const long long f_hi = image * n_elems + hi;

  // Phase 0: shared byte s holds device byte a0 + s, where a0 is the
  // slice's first byte rounded down to 16; the slice lies at [d0, d0 +
  // len) and [0, d0) and [d0 + len, end) are zeros, end rounded up to 12.
  const uintptr_t first = reinterpret_cast<uintptr_t>(x + f_lo);
  const uint8_t* a0 = reinterpret_cast<const uint8_t*>(first & ~uintptr_t(15));
  const int d0 = (int)(first & 15);
  const int end = (d0 + len + 11) / 12 * 12;
  int mid_lo = (d0 + 15) & ~15;  // the aligned middle, one bulk copy
  int mid_hi = (d0 + len) & ~15;
  if (mid_hi <= mid_lo) mid_lo = mid_hi = end;  // none: threads load all
  if (tid == 0) mbarrier_init(bar, 1);
  __syncthreads();
  if (tid == 0) {
    const unsigned bytes = (unsigned)(mid_hi - mid_lo);
    mbarrier_expect_tx(bar, bytes);
    if (bytes) bulk_copy_to_shared(data + mid_lo, a0 + mid_lo, bytes, bar);
  }
  const int n_edge = mid_lo + (end - mid_hi);
  for (int i = tid; i < n_edge; i += kClusterThreads) {
    const int s = i < mid_lo ? i : mid_hi + (i - mid_lo);
    data[s] = (s >= d0 && s < d0 + len) ? a0[s] : (unsigned char)0;
  }
  mbarrier_wait(bar, 0);
  __syncthreads();

  // Exact sums by position mod 3, 12 bytes (3 words) a step; the slice
  // starts on channel 0 at position d0, so channel k is position class
  // (k + d0) % 3.
  unsigned acc0 = 0, acc1 = 0, acc2 = 0;
  const uint32_t* words = reinterpret_cast<const uint32_t*>(data);
  for (int k = tid; k < end / 12; k += kClusterThreads) {
    const uint32_t w0 = words[3 * k], w1 = words[3 * k + 1],
                   w2 = words[3 * k + 2];
    acc0 += (w0 & 0xffu) + (w0 >> 24) + ((w1 >> 16) & 0xffu) +
            ((w2 >> 8) & 0xffu);
    acc1 += ((w0 >> 8) & 0xffu) + (w1 & 0xffu) + (w1 >> 24) +
            ((w2 >> 16) & 0xffu);
    acc2 += ((w0 >> 16) & 0xffu) + ((w1 >> 8) & 0xffu) + (w2 & 0xffu) +
            (w2 >> 24);
  }
  const int shift = d0 % 3;
  const unsigned part[3] = {
      shift == 0 ? acc0 : (shift == 1 ? acc1 : acc2),
      shift == 0 ? acc1 : (shift == 1 ? acc2 : acc0),
      shift == 0 ? acc2 : (shift == 1 ? acc0 : acc1)};
  const int lane = tid & 31;
  const int warp = tid >> 5;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const unsigned v = warp_sum(part[k]);
    if (lane == 0) warp_part[warp * 3 + k] = v;
  }
  __syncthreads();
  if (tid < 3) {
    unsigned long long total = 0;
#pragma unroll
    for (int w = 0; w < kClusterWarps; ++w) total += warp_part[w * 3 + tid];
    partial[tid] = total;
  }
  // Every block's partials are written: sum them in rank order.
  cluster.sync();
  if (tid < 3) {
    unsigned long long total = 0;
    for (unsigned q = 0; q < n_ranks; ++q) {
      total += cluster.map_shared_rank(partial, q)[tid];
    }
    image_sums[tid] = total;
  }
  cluster_arrive();  // this block is done reading its peers' memory
  __syncthreads();

  const float c = contrast[image];
  const float one_minus_c = __fadd_rn(1.0f, -c);
  const float bright = brightness[image];
  float o_pre[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float mean = __fadd_rn(
        __fmul_rn(__ll2float_rn((long long)image_sums[k]), inv), -1.0f);
    o_pre[k] = __fadd_rn(__fmul_rn(mean, one_minus_c), bright);
  }
  const float* mb = m_chroma + image * 9;

  // Phase 1: floats [f_lo, f_hi) of the batch. float4s on the flat index
  // [4 q_lo, 4 q_hi); the up to 3 + 3 floats outside them one a thread.
  const long long q_lo = (f_lo + 3) >> 2;
  const long long q_hi = f_hi >> 2;
  const long long head_end = min(4 * q_lo, f_hi);
  const long long tail_begin = max(4 * q_hi, head_end);
  const int n_head = (int)(head_end - f_lo);
  const int n_tail = (int)(f_hi - tail_begin);
  if (tid < n_head + n_tail) {
    const long long f = tid < n_head ? f_lo + tid : tail_begin + (tid - n_head);
    const int at = (int)(f - f_lo);
    const int ch = at % 3;
    const unsigned char* px = data + d0 + at - ch;
    const float* m = mb + 3 * ch;
    out[f] = jitter(m, c, row(m, o_pre[0], o_pre[1], o_pre[2]),
                    norm_bits(px[0], scale), norm_bits(px[1], scale),
                    norm_bits(px[2], scale));
  }
  const long long q_first = q_lo + tid;
  if (q_first < q_hi) {
    // Element e of a float4 is channel (j0 + e) % 3 of pixel (j0 + e) / 3
    // of the two pixels from the float4's first one.
    const int j0 = (int)((4 * q_first - f_lo) % 3);
    const float* m0 = mb + 3 * j0;
    const float* m1 = mb + 3 * ((j0 + 1) % 3);
    const float* m2 = mb + 3 * ((j0 + 2) % 3);
    const float r0[3] = {m0[0], m0[1], m0[2]};
    const float r1[3] = {m1[0], m1[1], m1[2]};
    const float r2[3] = {m2[0], m2[1], m2[2]};
    const float off0 = row(r0, o_pre[0], o_pre[1], o_pre[2]);
    const float off1 = row(r1, o_pre[0], o_pre[1], o_pre[2]);
    const float off2 = row(r2, o_pre[0], o_pre[1], o_pre[2]);
    const bool e1_next = j0 == 2;
    const bool e2_next = j0 >= 1;
    float4* out4 = reinterpret_cast<float4*>(out);
    for (long long q = q_first; q < q_hi; q += kClusterThreads) {
      const unsigned char* px = data + d0 + (int)(4 * q - f_lo) - j0;
      const float ar = norm_bits(px[0], scale), ag = norm_bits(px[1], scale),
                  ab = norm_bits(px[2], scale);
      const float br = norm_bits(px[3], scale), bg = norm_bits(px[4], scale),
                  bb = norm_bits(px[5], scale);
      float4 v;
      v.x = jitter(r0, c, off0, ar, ag, ab);
      v.y = jitter(r1, c, off1, e1_next ? br : ar, e1_next ? bg : ag,
                   e1_next ? bb : ab);
      v.z = jitter(r2, c, off2, e2_next ? br : ar, e2_next ? bg : ag,
                   e2_next ? bb : ab);
      v.w = jitter(r0, c, off0, br, bg, bb);
      out4[q] = v;
    }
  }
  cluster_wait();  // no block leaves while a peer may still read it
}

// Bytes of dynamic shared memory a block of the single-pass route needs
// for a slice of `slice_bytes` (ops/color_jitter.py::_b2_plan mirrors it):
// the header, then up to 15 bytes of head alignment and 11 of padding to
// a 12-byte step, rounded up to 16.
long long cluster_shared_bytes(long long slice_bytes) {
  return kHeaderBytes + (slice_bytes + 26 + 15) / 16 * 16;
}

// The single-pass kernel's launch configuration for clusters of `cluster`
// blocks; sets the kernel attributes that size needs.
cudaError_t cluster_config(int cluster, int shared_bytes, unsigned blocks,
                           cudaStream_t stream, cudaLaunchAttribute* attr,
                           cudaLaunchConfig_t* cfg) {
  cudaError_t err = cudaSuccess;
  if (shared_bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(normalize_color_jitter_cluster_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               shared_bytes);
    if (err != cudaSuccess) return err;
  }
  if (cluster > 8) {
    err = cudaFuncSetAttribute(normalize_color_jitter_cluster_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
    if (err != cudaSuccess) return err;
  }
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(blocks);
  cfg->blockDim = dim3(kClusterThreads);
  cfg->dynamicSmemBytes = (size_t)shared_bytes;
  cfg->stream = stream;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
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

// B2. Launches on `stream`; returns a CUDA error code (0 on success).
// m_chroma: float32 [batch, 3, 3]; contrast, brightness: float32 [batch];
// out: float32 [batch, n_pixels, 3], 16-byte aligned.
// cluster > 0: the single-pass route, one launch of batch * cluster blocks
// in clusters of `cluster`, each taking `slice_bytes` (a multiple of 12,
// cluster * slice_bytes >= 3 * n_pixels) with `shared_bytes` of dynamic
// shared memory; `sums` is not used. cluster == 0: the two-pass route,
// exact channel sums into `sums` (int64 [batch, 3], zeroed by the
// caller), then the apply kernel.
extern "C" int normalize_color_jitter_launch(
    const void* x, const void* m_chroma, const void* contrast,
    const void* brightness, void* sums, void* out, int batch,
    long long n_pixels, float inv, float scale, int cluster, int slice_bytes,
    int shared_bytes, void* stream) {
  const long long n_elems = 3 * n_pixels;
  if (cluster != 0) {
    if (batch <= 0 || n_pixels <= 0 || cluster < 1 || cluster > kMaxCluster ||
        slice_bytes <= 0 || slice_bytes % 12 != 0 ||
        (long long)slice_bytes * cluster < n_elems ||
        shared_bytes < cluster_shared_bytes(slice_bytes) ||
        (long long)batch * cluster > INT_MAX ||
        reinterpret_cast<uintptr_t>(out) % 16 != 0) {
      return (int)cudaErrorInvalidValue;
    }
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg;
    cudaError_t err =
        cluster_config(cluster, shared_bytes, (unsigned)(batch * cluster),
                       (cudaStream_t)stream, &attr, &cfg);
    if (err != cudaSuccess) return (int)err;
    err = cudaLaunchKernelEx(
        &cfg, normalize_color_jitter_cluster_kernel,
        static_cast<const uint8_t*>(x), static_cast<const float*>(m_chroma),
        static_cast<const float*>(contrast),
        static_cast<const float*>(brightness), static_cast<float*>(out),
        n_elems, slice_bytes, inv, scale);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
  }
  if (bad_shape(batch, n_pixels)) return (int)cudaErrorInvalidValue;
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

// How many clusters of `cluster` single-pass blocks with `shared_bytes`
// each the card can hold at once (cudaOccupancyMaxActiveClusters), into
// *count; returns a CUDA error code.
extern "C" int normalize_color_jitter_max_clusters(int cluster,
                                                   int shared_bytes,
                                                   int* count) {
  if (cluster < 1 || cluster > kMaxCluster) return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  cudaError_t err = cluster_config(cluster, shared_bytes, (unsigned)cluster,
                                   nullptr, &attr, &cfg);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveClusters(
      count, (const void*)normalize_color_jitter_cluster_kernel, &cfg);
}
