// Banded gather-sum (K1) and banded dot (K2) for Hopper (sm_90a).
//
// K1 replaces erc_tpu/ops/pallas/banded.py::banded_gather_sum:
//     out[b, v, :] = sum_k coef[b, v, k] * src[b, v + off_k, :]
// K2 replaces erc_tpu/ops/pallas/banded.py::banded_dot:
//     out[b, v, k] = a[b, v, :] . b[b, v + off_k, :]
// Taps whose source row v + off_k lies outside [0, L) contribute 0.
//
// Both are memory- and launch-bound.  At COGMEN's serving shape (B = 32,
// L = 112, D = 100, K = 11) K1 moves about 3 MB, under a microsecond at
// 3.35 TB/s, for about 8 MFLOP, so the launch costs more than the work.
// The design keeps each input read from device memory about once:
//   K1: one block per (row tile of TV targets, column tile of TD features,
//       b).  The block stages source rows [v0 + minoff, v0 + TV + maxoff)
//       (zero rows outside [0, L)) and its [TV, K] coef tile in shared
//       memory; threads run over (row, d) and sum the K taps in f32
//       registers, in tap order.
//   K2: one warp per (b, v).  The warp loads a[b, v, :] into shared memory
//       once, dots it with each in-range source row and reduces with warp
//       shuffles; lane 0 writes the tap (0 out of range).
// Offsets are arbitrary ints (any K <= kMaxTaps, no centred band assumed).
// Inputs are f32 with unit stride in the last dim; batch and row strides are
// passed, so strided views are read in place.  Each entry point launches on
// the caller's stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kMaxTaps = 64;

struct Taps {
  int n;
  int minoff;
  int maxoff;
  int off[kMaxTaps];
};

constexpr int kGatherTV = 32;     // target rows per K1 block
constexpr int kGatherTD = 128;    // feature columns per K1 block (at most)
constexpr int kGatherThreads = 256;
constexpr int kDotWarps = 8;      // (b, v) rows per K2 block

__global__ void banded_gather_sum_kernel(
    const float* __restrict__ coef, long long c_sb, long long c_sl,
    const float* __restrict__ src, long long s_sb, long long s_sl,
    float* __restrict__ out, int L, int D, int TD, Taps taps) {
  extern __shared__ float smem[];
  const int K = taps.n;
  const int rows = kGatherTV + taps.maxoff - taps.minoff;
  float* slab = smem;                 // [rows, TD]
  float* cf = smem + rows * TD;       // [kGatherTV, K]
  const int b = blockIdx.z;
  const int v0 = blockIdx.x * kGatherTV;
  const int d0 = blockIdx.y * TD;
  const int td = min(TD, D - d0);

  const float* srcb = src + b * s_sb + d0;
  for (int i = threadIdx.x; i < rows * td; i += blockDim.x) {
    const int r = i / td, d = i - r * td;
    const long long u = (long long)v0 + taps.minoff + r;
    slab[r * TD + d] = (u >= 0 && u < L) ? srcb[u * s_sl + d] : 0.f;
  }
  const float* coefb = coef + b * c_sb;
  for (int i = threadIdx.x; i < kGatherTV * K; i += blockDim.x) {
    const int r = i / K, k = i - r * K;
    const int v = v0 + r;
    cf[i] = (v < L) ? coefb[(long long)v * c_sl + k] : 0.f;
  }
  __syncthreads();

  float* outb = out + (long long)b * L * D + d0;
  for (int i = threadIdx.x; i < kGatherTV * td; i += blockDim.x) {
    const int r = i / td, d = i - r * td;
    const int v = v0 + r;
    if (v >= L) break;  // i only grows, so every later row is past L too
    float acc = 0.f;
    for (int k = 0; k < K; ++k)
      acc += cf[r * K + k] * slab[(r + taps.off[k] - taps.minoff) * TD + d];
    outb[(long long)v * D + d] = acc;
  }
}

__global__ void banded_dot_kernel(
    const float* __restrict__ a, long long a_sb, long long a_sl,
    const float* __restrict__ bm, long long b_sb, long long b_sl,
    float* __restrict__ out, int B, int L, int D, Taps taps) {
  extern __shared__ float arows[];  // [kDotWarps, D]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kDotWarps + warp;
  if (row >= (long long)B * L) return;  // whole warp leaves together
  const int b = (int)(row / L), v = (int)(row - (long long)b * L);
  float* arow = arows + warp * D;
  const float* ap = a + b * a_sb + v * a_sl;
  for (int d = lane; d < D; d += 32) arow[d] = ap[d];
  __syncwarp();

  const int K = taps.n;
  for (int k = 0; k < K; ++k) {
    const int u = v + taps.off[k];
    float s = 0.f;
    if (u >= 0 && u < L) {  // uniform across the warp
      const float* bp = bm + b * b_sb + (long long)u * b_sl;
      for (int d = lane; d < D; d += 32) s += arow[d] * bp[d];
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    }
    if (lane == 0) out[row * K + k] = s;
  }
}

bool make_taps(const int* offsets, int K, Taps* t) {
  if (K < 1 || K > kMaxTaps) return false;
  t->n = K;
  t->minoff = offsets[0];
  t->maxoff = offsets[0];
  for (int k = 0; k < K; ++k) {
    t->off[k] = offsets[k];
    if (offsets[k] < t->minoff) t->minoff = offsets[k];
    if (offsets[k] > t->maxoff) t->maxoff = offsets[k];
  }
  return true;
}

cudaError_t set_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

extern "C" {

// Dynamic shared memory (bytes) one K1 block needs, for the wrapper's check.
long long erc_banded_gather_sum_smem(int D, int span, int K) {
  const int TD = D < kGatherTD ? D : kGatherTD;
  return (long long)((kGatherTV + span) * TD + kGatherTV * K) * sizeof(float);
}

int erc_banded_gather_sum(const float* coef, long long c_sb, long long c_sl,
                          const float* src, long long s_sb, long long s_sl,
                          float* out, int B, int L, int D,
                          const int* offsets, int K, void* stream) {
  Taps taps;
  if (!make_taps(offsets, K, &taps) || B < 1 || L < 1 || D < 1 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const int TD = D < kGatherTD ? D : kGatherTD;
  const size_t smem = (size_t)erc_banded_gather_sum_smem(D, taps.maxoff - taps.minoff, K);
  cudaError_t err = set_smem((const void*)banded_gather_sum_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((L + kGatherTV - 1) / kGatherTV, (D + TD - 1) / TD, B);
  banded_gather_sum_kernel<<<grid, kGatherThreads, smem, (cudaStream_t)stream>>>(
      coef, c_sb, c_sl, src, s_sb, s_sl, out, L, D, TD, taps);
  return (int)cudaGetLastError();
}

int erc_banded_dot(const float* a, long long a_sb, long long a_sl,
                   const float* b, long long b_sb, long long b_sl,
                   float* out, int B, int L, int D,
                   const int* offsets, int K, void* stream) {
  Taps taps;
  if (!make_taps(offsets, K, &taps) || B < 1 || L < 1 || D < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)kDotWarps * D * sizeof(float);
  cudaError_t err = set_smem((const void*)banded_dot_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const long long rows = (long long)B * L;
  const unsigned blocks = (unsigned)((rows + kDotWarps - 1) / kDotWarps);
  banded_dot_kernel<<<blocks, kDotWarps * 32, smem, (cudaStream_t)stream>>>(
      a, a_sb, a_sl, b, b_sb, b_sl, out, B, L, D, taps);
  return (int)cudaGetLastError();
}

const char* erc_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
