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
// weights (2 x [3, D, D] + 2 x [D, D], 2.9 MB) fit in the TPU's VMEM but
// not in one block's 227 KB of shared memory, and the work per position is
// a few hundred thousand FMAs per row: far too little to fill 132 SMs unless
// the weights of every position are spread over many SMs.
//
// Two variants, chosen by shape alone (plan() in ops/kernels/dag_block.py):
//
// "cluster" (D up to 320 in f32).  A cluster of 16 thread blocks carries R
// batch rows.  Block `rank` owns the output columns [rank w, rank w + w) of
// all eight matrices (w = ceil(D / 16) rounded up to a multiple of 4, so that
// slice rows copy 16 bytes at a time: 20 at D = 300, rank 15 owning none) and
// copies that slice (8 D w floats, 192 KB at D = 300) into shared memory once
// per launch; at every position the SM then reads its weights from shared
// memory, and the card's SMs share the products: 7 clusters of 16 blocks
// cover B = 32 at R = 5.  Per position: (1) every block computes the logits,
// max and sums of its rows from the keys, which it holds whole; (2) each
// block computes M for its own columns and stores them into every block's
// full M (distributed shared memory), then a cluster barrier; (3) the six
// gate products of its columns, reading its weight slice once for all R
// rows, then both GRUs, its columns of h1 and the residuals, h1 stored into
// every block as in (2), then a cluster barrier; (4) the key h1 . wk from
// the full h1 (the same sum in every block), and V0/V1 of its columns.
// Products put threads over (4 columns, k sub-range) with the R rows in
// registers: four k sub-ranges in a warp meet by shuffles, the warps' by a
// sum in shared memory, in a fixed order, so repeats agree bit for bit.
// What bounds it now: the shared-memory reads of each position's products
// (every weight float once a position, M and h1 once per k sub-range and
// row), then the two cluster barriers and the latency of each phase's
// device-memory reads; g_phase_cycles records where a position's cycles go.
//
// "stream" (larger D, whose slice does not fit).  One thread block per 2
// batch rows (each weight element loaded once per position serves both from
// registers), or per row where 2 rows' buffers do not fit in shared memory;
// the weights stream from L2 at every position, one 4-byte load per weight,
// so it waits on L2 latency.  The block's live V0/V1 rows, keys, M and h1
// stay in shared memory.  Threads run over the output column d and read the
// [k, d] weight rows coalesced.  Each position is four phases between
// __syncthreads(): (1) logits, max and sums, one warp per row; (2) M; (3) the
// six gate products, both GRUs, h1 and the key's partial sums; (4) the two
// output products and the key.
//
// Inputs are f32.  The [B, C, ...] tensors (enum Tensor) have contiguous
// [b, c] slices and free batch and position strides, so the block's rows of
// [B, L, D] buffers are read and written in place.  The residuals hpc and
// xpp [B, C, 3, D] are optional: a null pointer skips them (serving).  The
// entry point checks the plan it is given against shared memory, launches
// on the caller's stream, does not synchronise, and returns the cudaError.

#include <cfloat>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "dag_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxWarps = kMaxThreads / 32;

// the cluster variant
constexpr int kClusterThreads = 256;
constexpr int kClusterWarps = kClusterThreads / 32;
constexpr int kMaxClusterRows = 8;
// per row, the partial products of the warps' k ranges: (warps / octets)
// ranges of at most 32 octets' worth of columns each, so at most 32 floats a warp
constexpr int kRedPerRow = 32 * kClusterWarps;
constexpr int kPhaseStamps = 13;

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

// ------------------------------------------------------------------ stream variant
template <int R>
__global__ void __launch_bounds__(kMaxThreads) dag_block_stream_kernel(const DagArgs a) {
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

// ------------------------------------------------------------------ cluster variant
// Shared-memory layout of one block of the cluster variant, offsets in floats.
struct ClusterLayout {
  long long P6, P2;  // row lengths of the gate and output slices (6w, 2w rounded up to 4)
  long long wg, wo, red, mf, hf, v0, v1, kw, e0, e1, st, bias, wk, total;
  __host__ __device__ ClusterLayout(int R, int C, int D, int w) {
    P6 = round4(6 * w);
    P2 = round4(2 * w);
    wg = 0;                              // [D][P6] Whc r|z|n, Wip r|z|n, columns of this block
    wo = wg + (long long)D * P6;         // [D][P2] Wr0T | Wr1T
    red = wo + (long long)D * P2;        // [S][R][P] partial products of the warps' k ranges
    mf = red + (long long)kRedPerRow * R;  // [R][D] M, every column
    hf = mf + (long long)R * D;          // [R][D] h1, every column
    v0 = hf + (long long)R * D;          // [R][C][w] V0 of this block's columns
    v1 = v0 + (long long)R * C * w;      // [R][C][w]
    kw = v1 + (long long)R * C * w;      // [R][C] keys
    e0 = kw + (long long)R * C;          // [R][C]
    e1 = e0 + (long long)R * C;          // [R][C]
    st = e1 + (long long)R * C;          // [R][4] sp, sw, den
    bias = st + 4LL * R;                 // [6w] bhc | bip of this block's columns
    wk = bias + 6LL * w;                 // [D] wk, every column
    total = wk + D;
  }
};

// dst[k][j] (row length P) = gate g's column col0 + c of row k, j = g w + c,
// for c < nc; 0 elsewhere.  Each thread keeps one j (4 where w, D and the
// bases allow 16-byte copies) and steps over k.
template <int NG>
__device__ __forceinline__ void load_slice(float* dst, int P, int D, int w, int col0, int nc,
                                           const float* const (&src)[NG]) {
  bool wide = w % 4 == 0 && D % 4 == 0;
#pragma unroll
  for (int g = 0; g < NG; ++g) wide = wide && reinterpret_cast<unsigned long long>(src[g]) % 16 == 0;
  const int V = wide ? 4 : 1, Q = P / V, per = kClusterThreads / Q, tid = threadIdx.x;
  if (tid >= per * Q) return;
  const int j = (tid % Q) * V, g = j / w, c = j - g * w;
  const bool valid = g < NG && c < nc;
  const float* s = valid ? src[g] + col0 + c : nullptr;
  for (int k = tid / Q; k < D; k += per) {
    float* d = dst + (long long)k * P + j;
    if (!valid) {
      for (int e = 0; e < V; ++e) d[e] = 0.f;
    } else if (wide) {
      cp_async16(d, s + (long long)k * D);
    } else {
      cp_async4(d, s + (long long)k * D);
    }
  }
}

// The k ranges of a product with P columns: warps cover octets of float4
// column groups, and split D into 4 sub-ranges per warp times `ranges`.
struct Split {
  int G, octets, ranges;
  __device__ __forceinline__ explicit Split(int P)
      : G(P >> 2), octets(((P >> 2) + 7) >> 3), ranges(kClusterWarps / (((P >> 2) + 7) >> 3)) {}
};

// red[s][r][j] = sum over warp range s of x[r][k] W[k][j], k in [0, D), for
// the R rows of x [R][D] and every column j < P of W [D][P].
template <int R>
__device__ __forceinline__ void matvec(const float* __restrict__ W, int P, const float* __restrict__ x,
                                       int D, float* __restrict__ red) {
  const Split sp(P);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int s = warp / sp.octets;
  if (s >= sp.ranges) return;  // warp-uniform
  const int g = (warp - s * sp.octets) * 8 + (lane & 7);
  const int nsub = 4 * sp.ranges, sub = 4 * s + (lane >> 3);
  const int k0 = sub * D / nsub, k1 = (sub + 1) * D / nsub;
  float acc[R][4];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
  if (g < sp.G) {
    const float4* w4 = reinterpret_cast<const float4*>(W) + g;
#pragma unroll 4
    for (int k = k0; k < k1; ++k) {
      const float4 wv = w4[k * sp.G];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float xv = x[r * D + k];
        acc[r][0] = fmaf(xv, wv.x, acc[r][0]);
        acc[r][1] = fmaf(xv, wv.y, acc[r][1]);
        acc[r][2] = fmaf(xv, wv.z, acc[r][2]);
        acc[r][3] = fmaf(xv, wv.w, acc[r][3]);
      }
    }
  }
  // the warp's four sub-ranges: lanes 8 and 16 apart
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[r][e] += __shfl_xor_sync(0xffffffffu, acc[r][e], 8);
      acc[r][e] += __shfl_xor_sync(0xffffffffu, acc[r][e], 16);
    }
  if (lane < 8 && g < sp.G) {
#pragma unroll
    for (int r = 0; r < R; ++r)
      reinterpret_cast<float4*>(red + (long long)(s * R + r) * P)[g] =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  }
}

// column j of row r of a product whose ranges matvec left in red
__device__ __forceinline__ float red_sum(const float* red, int P, int R, int r, int j) {
  const Split sp(P);
  float v = 0.f;
  for (int s = 0; s < sp.ranges; ++s) v += red[(long long)(s * R + r) * P + j];
  return v;
}

// Cycle stamps (clock64) of thread 0 of the first block at the phases of
// position C / 2, and of the launch's start, weight load and end: read by
// erc_dag_block_phase_cycles, so that a timing run can see where a position's
// time goes.  One predicated store per phase.
__device__ long long g_phase_cycles[kPhaseStamps];

template <int R>
__global__ void __launch_bounds__(kClusterThreads, 1) dag_block_cluster_kernel(const DagArgs a, const int w) {
  extern __shared__ __align__(16) float csmem[];
  float* smem = csmem;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int C = a.C, D = a.D;
  const ClusterLayout lay(R, C, D, w);
  const int P6 = (int)lay.P6, P2 = (int)lay.P2;
  float* wg = smem + lay.wg;
  float* wo = smem + lay.wo;
  float* red = smem + lay.red;
  float* mf = smem + lay.mf;
  float* hf = smem + lay.hf;
  float* v0 = smem + lay.v0;
  float* v1 = smem + lay.v1;
  float* kw = smem + lay.kw;
  float* e0 = smem + lay.e0;
  float* e1 = smem + lay.e1;
  float* st = smem + lay.st;
  float* bias = smem + lay.bias;
  float* wk = smem + lay.wk;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int col0 = rank * w, nc = max(0, min(w, D - col0));
  const bool stamps = blockIdx.x == 0 && tid == 0;
  auto stamp = [&](int i) {
    if (stamps) g_phase_cycles[i] = clock64();
  };
  stamp(0);

  const int row0 = (blockIdx.x / kClusterBlocks) * R;
  // rows past B repeat row B-1's reads and write nothing
  auto at = [&](int t, int r, int c) {
    const long long b = min(row0 + r, a.B - 1);
    return a.ptr[t] + b * a.sb[t] + (long long)c * a.sc[t];
  };
  auto live = [&](int r) { return row0 + r < a.B; };
  // this block's weight slices, once per launch
  {
    const long long DD = (long long)D * D;
    const float* const gates[6] = {a.whc, a.whc + DD, a.whc + 2 * DD, a.wip, a.wip + DD, a.wip + 2 * DD};
    const float* const outs[2] = {a.wr0, a.wr1};
    load_slice<6>(wg, P6, D, w, col0, nc, gates);
    load_slice<2>(wo, P2, D, w, col0, nc, outs);
    for (int j = tid; j < 6 * w; j += kClusterThreads) {
      const int g = j / w, c = j - g * w;
      if (c < nc) cp_async4(bias + j, (g < 3 ? a.bhc + g * D : a.bip + (g - 3) * D) + col0 + c);
      else bias[j] = 0.f;
    }
    for (int d = tid; d < D; d += kClusterThreads) cp_async4(wk + d, a.wk + d);
    cp_async_wait_all();
  }
  for (int i = tid; i < R * C; i += kClusterThreads) kw[i] = 0.f;
  stamp(1);
  // every block of the cluster is running, and its slices loaded, before any
  // block stores into another's shared memory
  cluster.sync();
  stamp(2);

  // this thread's (row, own column) in phases (2) to (4): R nc <= 256
  const bool mine = tid < R * nc;
  const int r_me = mine ? tid / nc : 0, c_me = mine ? tid - r_me * nc : 0, d_me = col0 + c_me;
  const bool write_me = mine && live(r_me);

  for (int c = 0; c < C; ++c) {
    const bool mid = c == C / 2;
    // the per-row inputs of this thread's column, read ahead of phase (1)
    float num = 0.f, xc[3] = {0.f, 0.f, 0.f}, hp[3] = {0.f, 0.f, 0.f}, hprev = 0.f;
    if (mine) {
      num = at(kNum, r_me, c)[d_me];
      const float* xcp = at(kXC, r_me, c);
      const float* hpp = at(kHP, r_me, c);
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        xc[g] = xcp[g * D + d_me];
        hp[g] = hpp[g * D + d_me];
      }
      hprev = at(kH, r_me, c)[d_me];
    }
    if (mid) stamp(3);

    // (1) logits over the block's columns, their max and sums: a warp per row
    if (warp < R) {
      const int r = warp;
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
    if (mid) stamp(4);

    // (2) M of this block's columns, into every block's full M
    if (mine) {
      const int r = r_me;
      float m = 0.f;
      if (!(c == 0 && a.flag)) {
        float nw = 0.f;
        for (int j = 0; j < c; ++j)
          nw += e0[r * C + j] * v0[(r * C + j) * w + c_me] + e1[r * C + j] * v1[(r * C + j) * w + c_me];
        m = (num * st[r * 4] + nw * st[r * 4 + 1]) / st[r * 4 + 2];
      }
      const int o = r * D + d_me;
      mf[o] = m;
      for (int q = 1; q < kClusterBlocks; ++q)
        cluster.map_shared_rank(mf, (rank + q) % kClusterBlocks)[o] = m;
    }
    if (mid) stamp(5);
    cluster.sync();
    if (mid) stamp(6);

    // (3) the six gate products of this block's columns, both GRUs, h1
    matvec<R>(wg, P6, mf, D, red);
    __syncthreads();
    if (mid) stamp(7);
    if (mine) {
      const int r = r_me, cc = c_me, d = d_me;
      const float hr = red_sum(red, P6, R, r, cc) + bias[cc];
      const float hz = red_sum(red, P6, R, r, w + cc) + bias[w + cc];
      const float hn = red_sum(red, P6, R, r, 2 * w + cc) + bias[2 * w + cc];
      const float xr = red_sum(red, P6, R, r, 3 * w + cc) + bias[3 * w + cc];
      const float xz = red_sum(red, P6, R, r, 4 * w + cc) + bias[4 * w + cc];
      const float xn = red_sum(red, P6, R, r, 5 * w + cc) + bias[5 * w + cc];
      if (a.ptr[kHPC] != nullptr && write_me) {
        float* hpc = at(kHPC, r, c);
        float* xpp = at(kXPP, r, c);
        hpc[d] = hr;
        hpc[D + d] = hz;
        hpc[2 * D + d] = hn;
        xpp[d] = xr;
        xpp[D + d] = xz;
        xpp[2 * D + d] = xn;
      }
      const float r1 = sigmoid(xc[0] + hr), z1 = sigmoid(xc[1] + hz);
      const float n1 = tanhf(xc[2] + r1 * hn);
      const float node = (1.f - z1) * n1 + z1 * mf[r * D + d];
      const float r2 = sigmoid(xr + hp[0]), z2 = sigmoid(xz + hp[1]);
      const float n2 = tanhf(xn + r2 * hp[2]);
      const float proxy = (1.f - z2) * n2 + z2 * hprev;
      const float h = node + proxy;
      const int o = r * D + d;
      hf[o] = h;
      for (int q = 1; q < kClusterBlocks; ++q)
        cluster.map_shared_rank(hf, (rank + q) % kClusterBlocks)[o] = h;
      if (write_me) at(kH1, r, c)[d] = h;
    }
    if (mid) stamp(8);
    cluster.sync();
    if (mid) stamp(9);

    // (4) the key h1 . wk over every column, by the last R warps (the same
    // sum in every block); V0, V1 of this block's columns
    if (warp >= kClusterWarps - R) {
      const int r = warp - (kClusterWarps - R);
      float s = 0.f;
      for (int d = lane; d < D; d += 32) s = fmaf(hf[r * D + d], wk[d], s);
      s = warp_sum(s);
      if (lane == 0) {
        kw[r * C + c] = s;
        if (rank == 0 && live(r)) *at(kKW, r, c) = s;
      }
    }
    matvec<R>(wo, P2, hf, D, red);
    __syncthreads();
    if (mid) stamp(10);
    if (mine) {
      const float x0 = red_sum(red, P2, R, r_me, c_me), x1 = red_sum(red, P2, R, r_me, w + c_me);
      v0[(r_me * C + c) * w + c_me] = x0;
      v1[(r_me * C + c) * w + c_me] = x1;
      if (write_me) {
        at(kV0, r_me, c)[d_me] = x0;
        at(kV1, r_me, c)[d_me] = x1;
      }
    }
    __syncthreads();
    if (mid) stamp(11);
  }
  stamp(12);
  // No block reads or writes another's shared memory after the last cluster
  // barrier, so each may exit on its own.
}

// ------------------------------------------------------------------ launch
long long stream_smem_floats(int rows, int C, int D) {
  return 2LL * rows * C * D + 2LL * rows * D + 3LL * rows * C + 4LL * rows +
         (long long)rows * kMaxWarps;
}

// Whether the cluster variant takes (rows, C, D) with `cols` columns per block.
bool cluster_ok(int rows, int C, int D, int cols) {
  return rows >= 1 && rows <= kMaxClusterRows && cols >= 1 && (long long)cols * kClusterBlocks >= D &&
         round4(6 * cols) <= 4 * 8 * kClusterWarps && rows * cols <= kClusterThreads &&
         ClusterLayout(rows, C, D, cols).total * (long long)sizeof(float) <= kMaxSmem;
}

template <int R>
cudaError_t launch_stream(const DagArgs& a, size_t smem, cudaStream_t stream) {
  static size_t allowed = 48 * 1024;
  const cudaError_t err = allow_smem(dag_block_stream_kernel<R>, smem, allowed);
  if (err != cudaSuccess) return err;
  const int warps = (a.D + 31) / 32;
  const int threads = 32 * (warps < kMaxWarps ? warps : kMaxWarps);
  dag_block_stream_kernel<R><<<(a.B + R - 1) / R, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

// The cluster kernel of R rows, its attributes set for `smem` bytes (16
// blocks a cluster is a non-portable size); with `max_clusters`, the number
// of its clusters the card holds at once, else a launch of `clusters`.
template <int R>
cudaError_t cluster_call(const DagArgs* a, int cols, int clusters, size_t smem, cudaStream_t stream,
                         int* max_clusters) {
  static size_t allowed = 48 * 1024;
  static bool nonportable = false;
  auto kernel = dag_block_cluster_kernel<R>;
  cudaError_t err = allow_cluster(kernel, nonportable);
  if (err == cudaSuccess) err = allow_smem(kernel, smem, allowed);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(max_clusters ? 1 : clusters, kClusterThreads, smem, stream, &attr);
  if (max_clusters) return cudaOccupancyMaxActiveClusters(max_clusters, (const void*)kernel, &cfg);
  err = cudaLaunchKernelEx(&cfg, kernel, *a, cols);
  return err != cudaSuccess ? err : cudaGetLastError();
}

cudaError_t cluster_dispatch(const DagArgs* a, int rows, int cols, int clusters, size_t smem,
                             cudaStream_t stream, int* max_clusters) {
  switch (rows) {
    case 1: return cluster_call<1>(a, cols, clusters, smem, stream, max_clusters);
    case 2: return cluster_call<2>(a, cols, clusters, smem, stream, max_clusters);
    case 3: return cluster_call<3>(a, cols, clusters, smem, stream, max_clusters);
    case 4: return cluster_call<4>(a, cols, clusters, smem, stream, max_clusters);
    case 5: return cluster_call<5>(a, cols, clusters, smem, stream, max_clusters);
    case 6: return cluster_call<6>(a, cols, clusters, smem, stream, max_clusters);
    case 7: return cluster_call<7>(a, cols, clusters, smem, stream, max_clusters);
    case 8: return cluster_call<8>(a, cols, clusters, smem, stream, max_clusters);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory (bytes) one block needs: variant 0 (stream) with
// `rows` rows a block, variant 1 (cluster) with `rows` rows a cluster and
// `cols` columns a block; mirrored by stream_smem and cluster_smem in
// ops/kernels/dag_block.py.
long long erc_dag_block_smem(int variant, int rows, int C, int D, int cols) {
  const long long floats =
      variant == kStream ? stream_smem_floats(rows, C, D) : ClusterLayout(rows, C, D, cols).total;
  return floats * (long long)sizeof(float);
}

// The number of clusters of the cluster variant (rows, C, D, cols) that the
// current device holds at once (cudaOccupancyMaxActiveClusters), in *n.
int erc_dag_block_max_clusters(int rows, int C, int D, int cols, int* n) {
  if (!cluster_ok(rows, C, D, cols)) return (int)cudaErrorInvalidValue;
  return (int)cluster_dispatch(nullptr, rows, cols, 0, (size_t)erc_dag_block_smem(kCluster, rows, C, D, cols),
                               nullptr, n);
}

// One launch of K3 by the wrapper's plan: variant 0 (stream, `rows` 1 or 2
// rows a block; `n` and `cols` unused) or 1 (cluster: `n` clusters of 16
// blocks, `rows` rows a cluster, `cols` columns a block).  A plan that does
// not cover B or does not fit in shared memory is refused.
int erc_dag_block(const DagArgs* args, int variant, int rows, int n, int cols, void* stream) {
  const DagArgs& a = *args;
  if (a.B < 1 || a.C < 1 || a.D < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = (size_t)erc_dag_block_smem(variant, rows, a.C, a.D, cols);
  if (variant == kCluster) {
    if (!cluster_ok(rows, a.C, a.D, cols) || n < 1 || (long long)n * rows < a.B) return (int)cudaErrorInvalidValue;
    return (int)cluster_dispatch(&a, rows, cols, n, smem, s, nullptr);
  }
  if (variant != kStream || (long long)smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  switch (rows) {
    case 1: return (int)launch_stream<1>(a, smem, s);
    case 2: return (int)launch_stream<2>(a, smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The cluster kernel's kPhaseStamps cycle stamps of its latest launch (see
// g_phase_cycles), into out[kPhaseStamps]; synchronises with the device.
int erc_dag_block_phase_cycles(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_phase_cycles, sizeof(g_phase_cycles));
}

const char* erc_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
