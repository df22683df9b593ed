// AdamW update for Hopper (sm_90a): kernel B3 of the port.
//
// Replaces the TPU kernel jama16_retina_tpu/ops/pallas_opt.py::
// fused_adamw_update (_adamw_kernel :44, _leaf_update :65, pallas_call :80).
// Per element of every parameter leaf, one rounding per operation:
//   mu' = b1 * mu + (1 - b1) * g
//   nu' = b2 * nu + ((1 - b2) * g) * g
//   u   = (mu' * c1) / (sqrt(nu' * c2) + eps)
//   u   = u + wd * p                    (leaves flagged for decay)
//   p'  = p - lr * u
// with [lr, c1, c2] read from a float32 device 3-vector, so the launch
// carries no per-step host value.
//
// Bound: memory. Per element 16 bytes in (p, g, mu, nu) and 12 bytes out
// (p, mu, nu) against ~12 floating-point operations. For Inception-v3 with
// the aux head (196 leaves, 24,327,970 elements) that is 681 MB, 0.203 ms
// at the H100 SXM's published 3.35 TB/s (700 W power limit).
//
// Design: the TPU launches one pallas_call per leaf, each padded to
// (rows, 128) lanes. Here one launch covers up to kMaxLeaves leaves: the
// leaf table (each leaf's four pointers, its size, its first block and
// its decay flag) is passed by value as a __grid_constant__ kernel
// parameter (48 bytes a leaf, 19.2 KB for 400 of the 32 KB that CUDA 12.1+
// allows on sm_70 and later), so no table lives in device memory and a
// step copies nothing to the card before the launch. Each block updates
// one chunk of `chunk` elements of one leaf; it finds its leaf by a binary
// search over the first blocks, a uniform read of the constant bank. So
// small leaves (the 96 BN biases) cost a block each rather than a launch
// each, and no padding is made. Updates are in place.
//
// No FMA is contracted: __fmul_rn / __fadd_rn / __fdiv_rn / __fsqrt_rn
// keep the plain PyTorch version's roundings (ops/adamw.py), so the card
// agrees with it bit for bit.

#include <cstdint>
#include <cstring>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLeaves = 400;

struct Leaf {
  long long p, g, mu, nu, n;
  int first_block, decay;
};

struct LeafTable {
  int n_leaves;
  Leaf leaf[kMaxLeaves];
};

__global__ void __launch_bounds__(kThreads)
adamw_kernel(const __grid_constant__ LeafTable table,
             const float* __restrict__ scalars, float b1, float one_minus_b1,
             float b2, float one_minus_b2, float eps, float wd, int chunk) {
  const int block = blockIdx.x;
  int lo = 0, hi = table.n_leaves - 1;  // last leaf with first_block <= block
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (table.leaf[mid].first_block <= block) lo = mid; else hi = mid - 1;
  }
  const Leaf& leaf = table.leaf[lo];
  float* p = reinterpret_cast<float*>(leaf.p);
  const float* g = reinterpret_cast<const float*>(leaf.g);
  float* mu = reinterpret_cast<float*>(leaf.mu);
  float* nu = reinterpret_cast<float*>(leaf.nu);
  const float lr = scalars[0], c1 = scalars[1], c2 = scalars[2];
  const long long start = (long long)(block - leaf.first_block) * chunk;
  const long long end = min(start + (long long)chunk, leaf.n);
  for (long long i = start + threadIdx.x; i < end; i += kThreads) {
    const float gi = g[i];
    const float pi = p[i];
    const float m = __fadd_rn(__fmul_rn(mu[i], b1), __fmul_rn(gi, one_minus_b1));
    const float v =
        __fadd_rn(__fmul_rn(nu[i], b2), __fmul_rn(__fmul_rn(gi, one_minus_b2), gi));
    float u = __fdiv_rn(__fmul_rn(m, c1),
                        __fadd_rn(__fsqrt_rn(__fmul_rn(v, c2)), eps));
    if (leaf.decay) u = __fadd_rn(u, __fmul_rn(wd, pi));
    p[i] = __fadd_rn(pi, -__fmul_rn(lr, u));
    mu[i] = m;
    nu[i] = v;
  }
}

}  // namespace

// Most leaves one launch takes; the caller splits longer lists.
extern "C" int adamw_max_leaves() { return kMaxLeaves; }

// Launches on `stream`; returns cudaGetLastError() (0 on success).
// leaves: host array of n_leaves 48-byte rows (p, g, mu, nu pointers and
// size as int64, then first block and decay flag as int32), copied into
// the launch's parameters, so the caller may free it on return;
// n_blocks: total chunks; scalars: device float32 [3] (lr, c1, c2).
extern "C" int adamw_launch(const void* leaves, int n_leaves, int n_blocks,
                            const void* scalars, float b1,
                            float one_minus_b1, float b2, float one_minus_b2,
                            float eps, float wd, int chunk, void* stream) {
  if (n_leaves <= 0 || n_leaves > kMaxLeaves || n_blocks <= 0 || chunk <= 0)
    return (int)cudaErrorInvalidValue;
  static_assert(sizeof(Leaf) == 48, "Leaf must match the host rows");
  LeafTable table;
  table.n_leaves = n_leaves;
  memcpy(table.leaf, leaves, sizeof(Leaf) * n_leaves);
  adamw_kernel<<<n_blocks, kThreads, 0, (cudaStream_t)stream>>>(
      table, static_cast<const float*>(scalars), b1, one_minus_b1, b2,
      one_minus_b2, eps, wd, chunk);
  return (int)cudaGetLastError();
}
