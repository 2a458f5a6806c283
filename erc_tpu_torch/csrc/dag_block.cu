// DAG-ERC's within-block recurrence (K3) for Hopper (sm_90a).
//
// Replaces erc_tpu/ops/pallas/dag_block.py::dag_block (the forward,
// _fwd_kernel via _dag_block_all).  For one block of C positions of one DAG
// layer and each batch row, position c in order:
//   lw_j  = q_c + K_j + am_cj                      (j < C; unwritten K_j = 0)
//   e_j   = exp(lw_j - max lw);  e0_j = e_j sm_cj;  e1_j = e_j - e0_j
//   m     = max(mp_c, max lw);   sp = exp(mp_c - m);  sw = exp(max lw - m)
//   M     = (num01_c sp + sw sum_j (e0_j V0_j + e1_j V1_j)) / (den_c sp + sw sum_j e_j)
//           (0 at global position 0: flag && c == 0)
//   h1    = GRU(x = xc_c, h = M) + GRU(x = M, h = h_c), per-gate weights
//   V0_c  = h1 Wr0T,  V1_c = h1 Wr1T,  K_c = h1 . wk
// and, for training, the gate projections hpc = M Whc + bhc and
// xpp = M Wip + bip (the residuals _fwd_kernel stores, dag_block.py:171-175)
// when their pointers are given; the backward (K4, dag_block_bwd.cu) reads
// them instead of redoing those products.
// Masks are additive finite numbers (-1e30, float32 min): no -inf, so a row
// with no predecessor falls back to a finite uniform softmax, as in JAX.
//
// What bounds it.  At DAG-ERC's serving shape (B = 32, C = 16, D = 300)
// a launch reads about 10 MB and does about 0.75 GFLOP: eight D x D
// products per (row, position), in an order the recurrence fixes.  The
// weights (2 x [3, D, D] + 2 x [D, D], 2.9 MB) do not fit in shared memory,
// as they fit in the TPU's VMEM, so this simple kernel streams them from L2
// at every position.
// Design: one thread block per 2 batch rows (each weight element loaded
// once per position serves both from registers), or per row where the
// block's buffers for 2 rows do not fit in shared memory; the block's live
// V0/V1 rows, keys, M and h1 stay in shared memory.  Threads run over the
// output column d and read the [k, d] weight rows coalesced.  Each position
// is four phases between __syncthreads(): (1) logits, max and sums, one warp
// per row; (2) M; (3) the six gate products, both GRUs, h1 and the key's
// partial sums; (4) the two output products and the key.
//
// Inputs are f32.  The [B, C, ...] tensors (enum Tensor) have contiguous
// [b, c] slices and free batch and position strides, so the block's rows of
// [B, L, D] buffers are read and written in place.  The residuals hpc and
// xpp [B, C, 3, D] are optional: a null pointer skips them (serving).  The
// entry point launches on the caller's stream, does not synchronise, and
// returns cudaGetLastError().

#include <cfloat>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxWarps = kMaxThreads / 32;

enum Tensor { kQ, kXC, kHP, kH, kNum, kDen, kMP, kAM, kSM, kH1, kV0, kV1, kKW, kHPC, kXPP, kTensors };

}  // namespace

// Mirrored by _DagArgs in erc_tpu_torch/ops/kernels/dag_block.py.
struct DagArgs {
  float* ptr[kTensors];      // q [B,C], xc/hp [B,C,3,D], h/num [B,C,D], den/mp [B,C],
                             // am/sm [B,C,C]; outputs h1/v0/v1 [B,C,D], kw [B,C];
                             // residuals hpc/xpp [B,C,3,D] or null
  long long sb[kTensors];    // batch strides (elements)
  long long sc[kTensors];    // position strides (elements)
  const float* whc;          // [3, D, D]: node GRU hidden weights, [k, d] rows
  const float* bhc;          // [3, D]
  const float* wip;          // [3, D, D]: proxy GRU input weights, [k, d] rows
  const float* bip;          // [3, D]
  const float* wr0;          // [D, D]
  const float* wr1;          // [D, D]
  const float* wk;           // [D]
  int B, C, D, flag;
};

namespace {

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <int R>
__global__ void __launch_bounds__(kMaxThreads) dag_block_kernel(const DagArgs a) {
  extern __shared__ float smem[];
  const int C = a.C, D = a.D;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, nwarps = nt >> 5;
  float* v0 = smem;              // [R][C][D] the block's V0 rows (0 until written)
  float* v1 = v0 + R * C * D;    // [R][C][D]
  float* mv = v1 + R * C * D;    // [R][D]    M of the current position
  float* hv = mv + R * D;        // [R][D]    h1 of the current position
  float* kw = hv + R * D;        // [R][C]    the block's keys
  float* e0 = kw + R * C;        // [R][C]    logits, then e * sm
  float* e1 = e0 + R * C;        // [R][C]    e - e0
  float* st = e1 + R * C;        // [R][4]    sp, sw, den
  float* red = st + R * 4;       // [R][kMaxWarps] per-warp partial keys

  const int row0 = blockIdx.x * R;
  // rows past B repeat row B-1's reads and write nothing
  auto at = [&](int t, int r, int c) {
    const long long b = min(row0 + r, a.B - 1);
    return a.ptr[t] + b * a.sb[t] + (long long)c * a.sc[t];
  };
  auto live = [&](int r) { return row0 + r < a.B; };

  for (int i = tid; i < 2 * R * C * D; i += nt) v0[i] = 0.f;  // v0 and v1
  for (int i = tid; i < R * C; i += nt) kw[i] = 0.f;
  __syncthreads();

  for (int c = 0; c < C; ++c) {
    // (1) logits over the block's columns, their max and sums: a warp per row
    for (int r = warp; r < R; r += nwarps) {
      const float q = *at(kQ, r, c);
      const float* am = at(kAM, r, c);
      const float* sm = at(kSM, r, c);
      float mx = -FLT_MAX;
      for (int j = lane; j < C; j += 32) {
        const float l = (q + kw[r * C + j]) + am[j];
        e0[r * C + j] = l;
        mx = fmaxf(mx, l);
      }
      mx = warp_max(mx);
      float dn = 0.f;
      for (int j = lane; j < C; j += 32) {
        const float e = expf(e0[r * C + j] - mx);
        const float es = e * sm[j];
        e0[r * C + j] = es;
        e1[r * C + j] = e - es;
        dn += e;
      }
      dn = warp_sum(dn);
      if (lane == 0) {
        const float mp = *at(kMP, r, c);
        const float m = fmaxf(mp, mx);
        const float sp = expf(mp - m), sw = expf(mx - m);
        st[r * 4 + 0] = sp;
        st[r * 4 + 1] = sw;
        st[r * 4 + 2] = *at(kDen, r, c) * sp + dn * sw;
      }
    }
    __syncthreads();

    // (2) M; the columns j >= c hold zero values and add nothing
    const bool zero_m = c == 0 && a.flag;
    for (int i = tid; i < R * D; i += nt) {
      const int r = i / D, d = i - r * D;
      float m = 0.f;
      if (!zero_m) {
        const float* v0r = v0 + r * C * D + d;
        const float* v1r = v1 + r * C * D + d;
        float nw = 0.f;
        for (int j = 0; j < c; ++j) nw += e0[r * C + j] * v0r[j * D] + e1[r * C + j] * v1r[j * D];
        m = (at(kNum, r, c)[d] * st[r * 4] + nw * st[r * 4 + 1]) / st[r * 4 + 2];
      }
      mv[i] = m;
    }
    __syncthreads();

    // (3) the six gate products of M, both GRUs, h1, the key's partial sums
    float kpart[R];
#pragma unroll
    for (int r = 0; r < R; ++r) kpart[r] = 0.f;
    for (int d = tid; d < D; d += nt) {
      float acc[6][R];
#pragma unroll
      for (int g = 0; g < 6; ++g)
#pragma unroll
        for (int r = 0; r < R; ++r) acc[g][r] = 0.f;
      const float* wh = a.whc + d;
      const float* wi = a.wip + d;
      const long long DD = (long long)D * D;
#pragma unroll 4
      for (int k = 0; k < D; ++k) {
        const long long o = (long long)k * D;
        const float w[6] = {__ldg(wh + o), __ldg(wh + DD + o), __ldg(wh + 2 * DD + o),
                            __ldg(wi + o), __ldg(wi + DD + o), __ldg(wi + 2 * DD + o)};
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float m = mv[r * D + k];
#pragma unroll
          for (int g = 0; g < 6; ++g) acc[g][r] = fmaf(m, w[g], acc[g][r]);
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float* xc = at(kXC, r, c);
        const float* hp = at(kHP, r, c);
        const float hr = acc[0][r] + a.bhc[d], hz = acc[1][r] + a.bhc[D + d],
                    hn = acc[2][r] + a.bhc[2 * D + d];
        const float xr = acc[3][r] + a.bip[d], xz = acc[4][r] + a.bip[D + d],
                    xn = acc[5][r] + a.bip[2 * D + d];
        if (a.ptr[kHPC] != nullptr && live(r)) {
          float* hpc = at(kHPC, r, c);
          float* xpp = at(kXPP, r, c);
          hpc[d] = hr;
          hpc[D + d] = hz;
          hpc[2 * D + d] = hn;
          xpp[d] = xr;
          xpp[D + d] = xz;
          xpp[2 * D + d] = xn;
        }
        const float r1 = sigmoid(xc[d] + hr), z1 = sigmoid(xc[D + d] + hz);
        const float n1 = tanhf(xc[2 * D + d] + r1 * hn);
        const float node = (1.f - z1) * n1 + z1 * mv[r * D + d];
        const float r2 = sigmoid(xr + hp[d]), z2 = sigmoid(xz + hp[D + d]);
        const float n2 = tanhf(xn + r2 * hp[2 * D + d]);
        const float proxy = (1.f - z2) * n2 + z2 * at(kH, r, c)[d];
        const float h = node + proxy;
        hv[r * D + d] = h;
        if (live(r)) at(kH1, r, c)[d] = h;
        kpart[r] = fmaf(h, a.wk[d], kpart[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float s = warp_sum(kpart[r]);
      if (lane == 0) red[r * kMaxWarps + warp] = s;
    }
    __syncthreads();

    // (4) V0 = h1 Wr0T and V1 = h1 Wr1T into the block's rows; the key
    for (int d = tid; d < D; d += nt) {
      float acc0[R], acc1[R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc0[r] = acc1[r] = 0.f;
#pragma unroll 4
      for (int k = 0; k < D; ++k) {
        const long long o = (long long)k * D + d;
        const float w0 = __ldg(a.wr0 + o), w1 = __ldg(a.wr1 + o);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float h = hv[r * D + k];
          acc0[r] = fmaf(h, w0, acc0[r]);
          acc1[r] = fmaf(h, w1, acc1[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        v0[(r * C + c) * D + d] = acc0[r];
        v1[(r * C + c) * D + d] = acc1[r];
        if (live(r)) {
          at(kV0, r, c)[d] = acc0[r];
          at(kV1, r, c)[d] = acc1[r];
        }
      }
    }
    if (tid < R) {
      float s = 0.f;
      for (int w = 0; w < nwarps; ++w) s += red[tid * kMaxWarps + w];
      kw[tid * C + c] = s;
      if (live(tid)) *at(kKW, tid, c) = s;
    }
    __syncthreads();
  }
}

long long smem_floats(int rows, int C, int D) {
  return 2LL * rows * C * D + 2LL * rows * D + 3LL * rows * C + 4LL * rows +
         (long long)rows * kMaxWarps;
}

template <int R>
cudaError_t launch(const DagArgs& a, int threads, size_t smem, cudaStream_t stream) {
  // raise the kernel's shared-memory limit once per size, so that launches
  // captured into a CUDA graph after a first call make no attribute call
  static size_t allowed = 48 * 1024;
  if (smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        (const void*)dag_block_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    allowed = smem;
  }
  dag_block_kernel<R><<<(a.B + R - 1) / R, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory (bytes) one block of `rows` rows needs, for the wrapper's check.
long long erc_dag_block_smem(int rows, int C, int D) {
  return smem_floats(rows, C, D) * (long long)sizeof(float);
}

// rows: batch rows per thread block, 2, or 1 where 2 do not fit (the wrapper picks).
int erc_dag_block(const DagArgs* args, int rows, void* stream) {
  const DagArgs& a = *args;
  if (a.B < 1 || a.C < 1 || a.D < 1) return (int)cudaErrorInvalidValue;
  const int warps = (a.D + 31) / 32;
  const int threads = 32 * (warps < kMaxWarps ? warps : kMaxWarps);
  const size_t smem = (size_t)erc_dag_block_smem(rows, a.C, a.D);
  const cudaStream_t s = (cudaStream_t)stream;
  switch (rows) {
    case 1: return (int)launch<1>(a, threads, smem, s);
    case 2: return (int)launch<2>(a, threads, smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* erc_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
