// Banded gather-sum (K1) and banded dot (K2) for Hopper (sm_90a).
//
// K1 replaces erc_tpu/ops/pallas/banded.py::banded_gather_sum
// (_banded_fwd_pallas):
//     out[b, v, :] = sum_k coef[b, v, k] * src[b, v + off_k, :]
// K2 replaces erc_tpu/ops/pallas/banded.py::banded_dot (_dot_kernel):
//     out[b, v, k] = a[b, v, :] . b[b, v + off_k, :]
// Taps whose source row v + off_k lies outside [0, L) contribute 0.
//
// Bound on the H100: bytes.  At COGMEN's serving shape (B = 32, L = 112,
// D = 100, K = 11) each kernel must move 3.0 MB, 0.9 us at 3.35 TB/s, for
// 7.9 MFLOP; at B = 256, 24.2 MB and 7.2 us.  A first design (one block per
// row tile staging its slab in shared memory, a warp per row looping over
// taps) was latency chains: a staging loop of ~17 dependent load/store trips
// before a barrier, and per tap a load and a shuffle reduction before the
// next tap's load.  This design has no shared memory and no barrier:
//   K1: one thread per (b, v, 4 columns) (1 column in the 4-byte variant).
//       The tap count is a template parameter for the counts the models use
//       (5, 6, 11, 21), so the tap loop is unrolled and no tap's 16-byte
//       source load or 4-byte coef load waits on another tap's; rows re-read
//       by neighbouring targets hit L1.  Taps are summed in tap order with
//       the product and the sum each rounded, as the plain version does, so
//       the two agree bit for bit.
//   K2: one warp per (b, v), lanes over 4-column slots; all K taps' loads are
//       issued at once into K partial sums per lane, and the K sums are
//       reduced together by halving exchanges (K padded to a power of two P:
//       P - 1 + log2(32 / P) shuffles in all, 16 at K = 11, instead of 5 per
//       tap); lane groups then write the K results in one store.
// Other tap counts (1..kMaxTaps) run the same code in batches of kChunk taps.
// Offsets are arbitrary ints; no centred band is assumed.
//
// Each kernel has two instantiations: VEC = 4 reads rows with 16-byte loads
// (D % 4 == 0, base and batch/row strides multiples of 4 floats: the
// wrapper decides, and the entry points refuse a misaligned request), VEC = 1
// reads 4 bytes at a time.  coef stays on 4-byte loads: its rows are 5, 6 or
// 11 floats.  Inputs are f32 with unit stride in the last dim; batch and row
// strides are passed, so strided views are read in place.  Thread and row
// indices are 32-bit (more than 2^31 - 1 elements are refused).  Each entry
// point launches on the caller's stream, does not synchronise, and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxTaps = 64;
constexpr int kChunk = 8;            // taps per batch of loads for another tap count
constexpr int kGatherThreads = 128;  // K1 block
constexpr int kDotWarps = 8;         // K2: (b, v) rows per block, one warp each

struct Taps {
  int n;
  int off[kMaxTaps];
};

template <int VEC> struct V;

template <> struct V<1> {
  using T = float;
  static __device__ __forceinline__ T zero() { return 0.f; }
  static __device__ __forceinline__ T ldg(const float* p) { return __ldg(p); }
  static __device__ __forceinline__ void st(float* p, T x) { *p = x; }
  // acc + w * x with the product and the sum each rounded, as the plain version does
  static __device__ __forceinline__ T madd(float w, T x, T acc) { return __fadd_rn(acc, __fmul_rn(w, x)); }
  static __device__ __forceinline__ float dot(T a, T b, float acc) { return fmaf(a, b, acc); }
};

template <> struct V<4> {
  using T = float4;
  static __device__ __forceinline__ T zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  static __device__ __forceinline__ T ldg(const float* p) { return __ldg(reinterpret_cast<const float4*>(p)); }
  static __device__ __forceinline__ void st(float* p, T x) { *reinterpret_cast<float4*>(p) = x; }
  static __device__ __forceinline__ T madd(float w, T x, T acc) {
    return make_float4(__fadd_rn(acc.x, __fmul_rn(w, x.x)), __fadd_rn(acc.y, __fmul_rn(w, x.y)),
                       __fadd_rn(acc.z, __fmul_rn(w, x.z)), __fadd_rn(acc.w, __fmul_rn(w, x.w)));
  }
  static __device__ __forceinline__ float dot(T a, T b, float acc) {
    acc = fmaf(a.x, b.x, acc);
    acc = fmaf(a.y, b.y, acc);
    acc = fmaf(a.z, b.z, acc);
    return fmaf(a.w, b.w, acc);
  }
};

// Offset of tap k; a k past the last tap reads a valid slot, and its load is
// predicated off.
__device__ __forceinline__ int tap_off(const Taps& t, int k) { return t.off[k < kMaxTaps ? k : 0]; }

template <int VEC, int KT>  // KT: the tap count, or 0 for any count in batches of kChunk
__global__ void __launch_bounds__(kGatherThreads) banded_gather_sum_kernel(
    const float* __restrict__ coef, long long c_sb, long long c_sl,
    const float* __restrict__ src, long long s_sb, long long s_sl,
    float* __restrict__ out, int B, int L, int D, Taps taps) {
  using Vt = V<VEC>;
  using T = typename Vt::T;
  const int DV = D / VEC;
  const unsigned i = blockIdx.x * kGatherThreads + threadIdx.x;  // unsigned: the last block may pass 2^31
  if (i >= (unsigned)(B * L * DV)) return;
  const int row = (int)(i / DV), c = (int)i - row * DV;
  const int b = row / L, v = row - b * L;
  const float* cp = coef + b * c_sb + v * c_sl;
  const float* sp = src + b * s_sb + c * VEC;
  const int K = KT > 0 ? KT : taps.n;
  constexpr int CH = KT > 0 ? KT : kChunk;
  T acc = Vt::zero();
  for (int k0 = 0; k0 < K; k0 += CH) {
    T x[CH];
    float w[CH];
#pragma unroll
    for (int j = 0; j < CH; ++j) {  // no load waits on another
      const int k = k0 + j;
      const bool tap = KT > 0 || k < K;
      const int u = v + tap_off(taps, k);
      x[j] = (tap && u >= 0 && u < L) ? Vt::ldg(sp + u * s_sl) : Vt::zero();
      w[j] = tap ? __ldg(cp + k) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < CH; ++j)
      if (KT > 0 || k0 + j < K) acc = Vt::madd(w[j], x[j], acc);
  }
  Vt::st(out + (long long)row * D + c * VEC, acc);
}

__host__ __device__ constexpr int pow2ceil(int n) { return n <= 1 ? 1 : 2 * pow2ceil((n + 1) / 2); }

// Sums N values over the warp's lanes by halving exchanges: at step S
// (16, 8, ...) lanes with bit S set keep the upper half of v[0, N), the
// others the lower half, and each adds its partner's copy of the half it
// keeps.  After log2(N) steps v[0] of lane l holds value l / (32 / N) summed
// over the lanes that differ from l in bits 4 down to log2(32 / N).
template <int N, int S>
__device__ __forceinline__ void fold(float* v, int lane) {
  if constexpr (N > 1) {
    const bool hi = lane & S;
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float send = hi ? v[i] : v[i + N / 2];
      const float keep = hi ? v[i + N / 2] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, S);
    }
    fold<N / 2, S / 2>(v, lane);
  }
}

template <int VEC, int KT>  // KT: the tap count, or 0 for any count in batches of kChunk
__global__ void __launch_bounds__(kDotWarps * 32) banded_dot_kernel(
    const float* __restrict__ a, long long a_sb, long long a_sl,
    const float* __restrict__ bm, long long b_sb, long long b_sl,
    float* __restrict__ out, int B, int L, int D, Taps taps) {
  using Vt = V<VEC>;
  using T = typename Vt::T;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned urow = blockIdx.x * kDotWarps + warp;  // unsigned: the last block may pass 2^31
  if (urow >= (unsigned)(B * L)) return;  // whole warp leaves together
  const int row = (int)urow;
  const int b = row / L, v = row - b * L;
  const int DV = D / VEC;
  const float* ap = a + b * a_sb + v * a_sl;
  const float* bp = bm + b * b_sb;
  const int K = KT > 0 ? KT : taps.n;
  constexpr int CH = KT > 0 ? KT : kChunk;
  constexpr int P = pow2ceil(CH);  // sums reduced together, zero-padded to a power of two
  constexpr int G = 32 / P;        // lanes that end up holding the same sum
  float* orow = out + (long long)row * K;
  for (int k0 = 0; k0 < K; k0 += CH) {
    float part[P];
#pragma unroll
    for (int j = 0; j < P; ++j) part[j] = 0.f;
    for (int s = lane; s < DV; s += 32) {
      const T av = Vt::ldg(ap + s * VEC);
      T bv[CH];
#pragma unroll
      for (int j = 0; j < CH; ++j) {  // no load waits on another
        const int k = k0 + j;
        const int u = v + tap_off(taps, k);
        bv[j] = ((KT > 0 || k < K) && u >= 0 && u < L) ? Vt::ldg(bp + u * b_sl + s * VEC) : Vt::zero();
      }
#pragma unroll
      for (int j = 0; j < CH; ++j) part[j] = Vt::dot(av, bv[j], part[j]);
    }
    fold<P, 16>(part, lane);
    float sum = part[0];
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    const int j = lane / G;
    if (lane % G == 0 && j < CH && k0 + j < K) orow[k0 + j] = sum;
  }
}

struct Args {
  const float* x;
  long long x_sb, x_sl;
  const float* y;
  long long y_sb, y_sl;
  float* out;
  int B, L, D;
  Taps taps;
  cudaStream_t stream;
};

template <int VEC, int KT> struct Gather {
  static void launch(const Args& g) {
    const int threads = g.B * g.L * (g.D / VEC);
    banded_gather_sum_kernel<VEC, KT><<<(threads - 1) / kGatherThreads + 1, kGatherThreads, 0,
                                        g.stream>>>(g.x, g.x_sb, g.x_sl, g.y, g.y_sb, g.y_sl, g.out, g.B,
                                                    g.L, g.D, g.taps);
  }
};

template <int VEC, int KT> struct Dot {
  static void launch(const Args& g) {
    banded_dot_kernel<VEC, KT><<<(g.B * g.L - 1) / kDotWarps + 1, kDotWarps * 32, 0, g.stream>>>(
        g.x, g.x_sb, g.x_sl, g.y, g.y_sb, g.y_sl, g.out, g.B, g.L, g.D, g.taps);
  }
};

// The tap counts the models use (the RGCN's sub-bands 5 and 6, COGMEN's 11,
// DialogueGCN's 21) each get their own instantiation: one batch of loads.
template <int VEC, template <int, int> class Kernel>
int launch(const Args& g) {
  switch (g.taps.n) {
    case 5: Kernel<VEC, 5>::launch(g); break;
    case 6: Kernel<VEC, 6>::launch(g); break;
    case 11: Kernel<VEC, 11>::launch(g); break;
    case 21: Kernel<VEC, 21>::launch(g); break;
    default: Kernel<VEC, 0>::launch(g);
  }
  return (int)cudaGetLastError();
}

bool aligned16(const float* p, long long sb, long long sl, int B, int L) {
  return ((uintptr_t)p & 15) == 0 && (B == 1 || sb % 4 == 0) && (L == 1 || sl % 4 == 0);
}

// Fills g; cudaErrorInvalidValue for a tap count or a size the kernels do not take.
int prepare(Args* g, const float* x, long long x_sb, long long x_sl, const float* y, long long y_sb,
            long long y_sl, float* out, int B, int L, int D, const int* offsets, int K, void* stream) {
  if (K < 1 || K > kMaxTaps || B < 1 || L < 1 || D < 1 || (long long)B * L * D > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  *g = Args{x, x_sb, x_sl, y, y_sb, y_sl, out, B, L, D, {K, {}}, (cudaStream_t)stream};
  for (int k = 0; k < K; ++k) g->taps.off[k] = offsets[k];
  return 0;
}

}  // namespace

extern "C" {

// vec4 = 1 takes the 16-byte instantiation; it is refused
// (cudaErrorMisalignedAddress) unless D % 4 == 0 and src's and out's bases
// and strides are multiples of 4 floats.
int erc_banded_gather_sum(const float* coef, long long c_sb, long long c_sl,
                          const float* src, long long s_sb, long long s_sl,
                          float* out, int B, int L, int D,
                          const int* offsets, int K, int vec4, void* stream) {
  Args g;
  const int err = prepare(&g, coef, c_sb, c_sl, src, s_sb, s_sl, out, B, L, D, offsets, K, stream);
  if (err) return err;
  if (!vec4) return launch<1, Gather>(g);
  if (D % 4 || !aligned16(src, s_sb, s_sl, B, L) || ((uintptr_t)out & 15))
    return (int)cudaErrorMisalignedAddress;
  return launch<4, Gather>(g);
}

// vec4 as above, for a and b.
int erc_banded_dot(const float* a, long long a_sb, long long a_sl,
                   const float* b, long long b_sb, long long b_sl,
                   float* out, int B, int L, int D,
                   const int* offsets, int K, int vec4, void* stream) {
  Args g;
  const int err = prepare(&g, a, a_sb, a_sl, b, b_sb, b_sl, out, B, L, D, offsets, K, stream);
  if (err) return err;
  if (!vec4) return launch<1, Dot>(g);
  if (D % 4 || !aligned16(a, a_sb, a_sl, B, L) || !aligned16(b, b_sb, b_sl, B, L))
    return (int)cudaErrorMisalignedAddress;
  return launch<4, Dot>(g);
}

const char* erc_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
