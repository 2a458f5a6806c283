// The backward of DAG-ERC's within-block recurrence (K4) for Hopper (sm_90a).
//
// Replaces erc_tpu/ops/pallas/dag_block.py::_dag_block_bwd (_bwd_kernel and
// _gru_bwd, pallas_call at dag_block.py:369).  Two kernels, launched one
// after the other on the caller's stream:
//
// 1. The sweep, over the positions c = C-1 .. 0 of each batch row:
//    - recompute position c's attention from the FINAL keys and values of
//      the block (K3's outputs kw, v0, v1), as _bwd_kernel does: columns
//      j >= c carry an additive -1e30 mask, so their weights underflow to 0
//      except on a row with no predecessor (the gradient contract of
//      dag_block.py:27-33: such a row is flag-gated or has zero cotangents);
//    - recompute the gates from K3's residuals hpc and xpp (no products);
//    - g  = dh1_c + dV0_c Wr0 + dV1_c Wr1 + dK_c wk       (3 mat-vecs)
//    - the two GRUs' backward; dM += dhpc Whcᵀ + dxpp Wipᵀ   (6 mat-vecs)
//    - the backward of the running-max merge with honest partials, of the
//      softmax (ties of the max split evenly), and the cotangents the
//      earlier positions' keys and values receive: dV0_j, dV1_j, dK_j.
//    It writes the per-position gradients and, for the second kernel, the
//    stashes M, dhpc, dxpp [B, C, (3,) D] and the final dV0, dV1, dK.
// 2. The weight gradients (dag_block.py:285-304): eight [D, N] x [N, D]
//    contractions over the N = B·C (row, position) pairs, the bias sums and
//    dwk, as a shared-memory tiled reduction.  Each output element is summed
//    by one thread in a fixed order: no atomics, so runs repeat bit for bit.
//
// What bounds it.  At DAG-ERC's training shape (B = 16, C = 16, D = 300) the
// sweep does 9 D x D mat-vecs per (row, position), in an order the
// recurrence fixes, and the contractions 8 D x D x B·C products: about
// 0.75 GFLOP together, 11 µs at the card's float32 rate.  The weights
// (2 x [3D, D] + 2 x [D, D], 2.9 MB) do not fit in one block's shared memory.
// The sweep reads every weight in torch's own layout (w_hh, w_ih, Wr0, Wr1 as
// the model registers them): its products contract over the forward's output
// index, the rows of those matrices.
//
// The sweep has three variants, chosen by shape alone (bwd_plan() in
// ops/kernels/dag_block.py):
//
// "cluster" (D up to 320 in f32).  A cluster of 16 thread blocks carries R
// batch rows.  Block `rank` owns the index slice S = [rank w, rank w + w)
// (w = cluster_cols(D), 20 at D = 300, rank 15 owning none) and copies rows S
// of the eight weight panels (Wr0, Wr1, the three gates of w_hh and of w_ih)
// into shared memory once per launch: 8 w D floats, 192 KB at D = 300.  It
// keeps, per row, the final V0/V1 and the running dV0/dV1 of its own columns
// (4 C w floats) and the C keys, dK and softmax arrays whole.  The transposed
// products are reductions over S: every block multiplies its own rows for all
// D outputs and sends each block the outputs of that block's slice
// (distributed shared memory, one float4 per store); each block adds the 16
// partials in rank order 0..15.  No atomics, and every block sums the merged
// scalars in the same order, so repeats agree bit for bit.  Position c:
//   (1) logits, max and sums over the C columns from the keys (the same in
//       every block);  the block's partial of g from dV0_c, dV1_c of its
//       rows, scattered;  exchange E1: the g partials;
//   (2) nw and M of its columns (M stashed, never exchanged);
//   (3) g of its columns = dh1 + the 16 partials + dK_c wk, both GRUs'
//       backward, and its partial of dM from the six gate cotangents,
//       scattered;  exchange E2: the dM partials;
//   (4) dM of its columns = node dh + the 16 partials; dnum01, dnw; dV0/dV1
//       of its columns updated; the partial merge sums (dM.M, dnum.num01,
//       dnum.nw) and the partial dots dnw.V0_j, dnw.V1_j for every j, 3 + 2C
//       floats a row, sent to every block;  exchange E3: the partial sums;
//   (5) the merge's and the softmax's backward from the 16 partials in rank
//       order, the same in every block: dK updated everywhere, dq, dden_p
//       and dmp written by rank 0.
// Phases (1) and (5) of a row run on the last R warps, beside the column
// phases on the first warps.  Each exchange needs a cluster barrier between
// its stores and its reads, but E3 of position c and E1 of position c - 1
// share one: dV0/dV1 of position c - 1 are final once (4) of position c has
// run, so its g partial is sent with the partial sums of c, and (5) of c
// runs beside (2) of c - 1.  Two cluster barriers a position, X(c) and B(c):
//   X(c) | (5) of c+1, (2) and (3) of c, dM partials scattered | B(c) |
//   (4) of c, (1) of c-1, partial sums of c and g partial of c-1 scattered |
//   X(c-1) | ...
// Each receive buffer is next written only after the barrier that follows
// its last read: the g partials of c are read in (3), before B(c), and
// written for c-1 after B(c); the dM partials of c are read in (4), before
// X(c-1), and written for c-1 after X(c-1); the partial sums of c are read
// in (5) of c, before B(c-1), and written for c-1 after B(c-1).  The per-position
// arrays (logits, weights, mask, merge scalars) are double-buffered by the
// parity of the position, since (1) of c-1 runs while (4) of c still reads
// those of c.  No block touches another's shared memory after the last
// barrier, so each may exit on its own.  Products put a warp over 8 float4
// column groups (32 outputs) with its four lane octets splitting the
// contraction, the R rows in registers, the octets summed by shuffles; 10
// warps cover D <= 320.  What bounds it: the shared-memory reads of the
// products (every weight float once a position), the two cluster barriers,
// the partial sums' remote stores and the serial column phases;
// g_bwd_phase_cycles records where a position's cycles go.
//
// "stream" (larger D, whose slices do not fit).  One thread block per 2
// batch rows (each weight element loaded once per position serves both), or
// per row where 2 rows' buffers do not fit in shared memory; the weights
// stream from L2 at every position, one 4-byte load each, so it waits on L2
// latency.  A row's final V0/V1 and running dV0/dV1 (4·C·D floats) stay in
// shared memory.  Threads run over the output column, reading the weight
// rows coalesced.  Each position is six phases between __syncthreads(): (1)
// logits, max and sums, a warp per row; (2) M and the attention's weighted
// values; (3) g and both GRUs' backward; (4) dM and the merge's partial sums;
// (5) the merge's scalars, the dot products of dnw with every V0_j/V1_j, and
// the dV0/dV1 updates; (6) the softmax backward, dq and dK, a warp per row.
//
// "global" (blocks whose stream buffers do not fit in shared memory either:
// C >= 75 at D = 300, where K3 still runs).  The stream kernel with one row a
// block, its whole layout (the final V0/V1 and running dV0/dV1, 4·C·D floats
// a row, and the rest) placed in a device-memory workspace that the wrapper
// allocates, one slice a block, instead of in shared memory.  Same arithmetic
// in the same order; __syncthreads() orders the block's device-memory
// accesses as it does its shared ones.  It reads and updates the C·D buffers
// from L1/L2 at every position, so it is far slower than the stream variant.
//
// Inputs are f32.  The [B, C, ...] tensors (enum Tensor) have contiguous
// [b, c] slices and free batch and position strides.  The entry points
// check the plan they are given against shared memory, launch on the
// caller's stream, do not synchronise, and return the cudaError.

#include <cfloat>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "dag_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kTile = 32;          // weight-gradient tile: 32 x 32 outputs
constexpr int kTileThreads = 256;  // 8 rows of 32 threads, 4 outputs each

// the cluster variant
constexpr int kClusterThreads = 320;  // 10 warps: 32 outputs each of a product, D <= 320
constexpr int kClusterWarps = kClusterThreads / 32;
constexpr int kMaxClusterRows = 8;
constexpr int kPhaseStamps = 13;

enum Tensor {
  kQ, kXC, kHP, kH, kNum, kDen, kMP, kAM, kSM,  // K3's inputs
  kV0F, kV1F, kKWF, kHPC, kXPP,                 // K3's outputs and residuals
  kDH1, kDV0, kDV1, kDKW,                       // cotangents of h1, V0w, V1w, Kw
  kDQ, kDXC, kDHP, kDH, kDNum, kDDen, kDMP,     // gradients
  kMS, kDHPC, kDXPP, kDV0S, kDV1S, kDKWS,       // stashes for the weight gradients
  kTensors
};

}  // namespace

// Mirrored by _DagBwdArgs in erc_tpu_torch/ops/kernels/dag_block.py.
struct DagBwdArgs {
  float* ptr[kTensors];      // [B,C] q/den/mp/kwf/dkw/dq/dden/dmp/dkws, [B,C,C] am/sm,
                             // [B,C,3,D] xc/hp/hpc/xpp/dxc/dhp/dhpc/dxpp, the rest [B,C,D]
  long long sb[kTensors];    // batch strides (elements)
  long long sc[kTensors];    // position strides (elements)
  const float* whh;          // [3D, D] node GRU w_hh, torch layout
  const float* wih;          // [3D, D] proxy GRU w_ih, torch layout
  const float* wr0;          // [D, D] torch layout: V0 = h1 Wr0ᵀ
  const float* wr1;          // [D, D]
  const float* wk;           // [D]
  int B, C, D, flag;
  float* ws;                 // the global variant's workspace: stream_smem_floats(1, C, D) a block
};

constexpr int kProducts = 8;

// Mirrored by _WgradArgs in erc_tpu_torch/ops/kernels/dag_block.py.
// Product z: out[z][i][j] = sum_n a[z][n*lda + i] b[z][n*ldb + j], [D, D].
// Its extra row of tiles, where vout[z] is given: vout[z][j] =
// sum_n (w[z] ? w[z][n] : 1) x[z][n*ldx + j].
struct WgradArgs {
  const float* a[kProducts];
  const float* b[kProducts];
  float* out[kProducts];
  long long lda[kProducts], ldb[kProducts];
  const float* x[kProducts];
  const float* w[kProducts];
  float* vout[kProducts];
  long long ldx[kProducts];
  int N, D;
};

namespace {

// _gru_bwd: the cotangent g of h' = (1 - z) n + z h, n = tanh(xn + r hn_proj).
struct GruBwd {
  float dr, dz, dn, dhn, dh;  // pre-activation gate cotangents, d hn_proj, d h
};

__device__ __forceinline__ GruBwd gru_bwd(float g, float hn_proj, float h, float r, float z,
                                          float n) {
  GruBwd o;
  const float dn = g * (1.f - z);
  o.dh = g * z;
  o.dn = dn * (1.f - n * n);
  o.dhn = o.dn * r;
  o.dz = g * (h - n) * z * (1.f - z);
  const float dr = o.dn * hn_proj;
  o.dr = dr * r * (1.f - r);
  return o;
}

constexpr int kStats = 8;  // per row: max, sum e, sp, sw, den, d sum e / mp, d max / den_p, (spare)

// ------------------------------------------------------------------ stream variant
// The floats of the stream variant's layout for `rows` rows a block.
__host__ __device__ inline long long stream_smem_floats(int rows, int C, int D) {
  return 4LL * rows * C * D + 10LL * rows * D + 8LL * rows * C + (long long)rows * kStats +
         3LL * rows * kMaxWarps;
}

// WS: the layout lies in the workspace a.ws (the global variant), else in shared memory.
template <int R, bool WS>
__global__ void __launch_bounds__(kMaxThreads) dag_block_bwd_stream_kernel(const DagBwdArgs a) {
  extern __shared__ float smem[];
  const int C = a.C, D = a.D;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, nwarps = nt >> 5;
  float* v0 = WS ? a.ws + blockIdx.x * stream_smem_floats(R, C, D) : smem;  // [R][C][D] final V0 rows
  float* v1 = v0 + R * C * D;    // [R][C][D] final V1
  float* dv0 = v1 + R * C * D;   // [R][C][D] running dV0
  float* dv1 = dv0 + R * C * D;  // [R][C][D] running dV1
  float* mv = dv1 + R * C * D;   // [R][D]    M of the current position
  float* nw = mv + R * D;        // [R][D]    its attention's weighted values
  float* dnw = nw + R * D;       // [R][D]    their cotangent
  float* dmh = dnw + R * D;      // [R][D]    dM from the node GRU's hidden input
  float* dg = dmh + R * D;       // [R][6][D] dhpc (r, z, n) then dxpp (r, z, n)
  float* kw = dg + 6 * R * D;    // [R][C]    final keys
  float* dkw = kw + R * C;       // [R][C]    running dK
  float* lw = dkw + R * C;       // [R][C]    logits
  float* ew = lw + R * C;        // [R][C]    exp(logit - max)
  float* e0 = ew + R * C;        // [R][C]    ew * sm
  float* dl = e0 + R * C;        // [R][C]    d logits
  float* dot0 = dl + R * C;      // [R][C]    dnw . V0_j
  float* dot1 = dot0 + R * C;    // [R][C]    dnw . V1_j
  float* st = dot1 + R * C;      // [R][kStats]
  float* red = st + R * kStats;  // [R][3][kMaxWarps] per-warp partial sums

  const int row0 = blockIdx.x * R;
  // rows past B repeat row B-1's reads and write nothing
  auto at = [&](int t, int r, int c) {
    const long long b = min(row0 + r, a.B - 1);
    return a.ptr[t] + b * a.sb[t] + (long long)c * a.sc[t];
  };
  auto live = [&](int r) { return row0 + r < a.B; };

  for (int i = tid; i < R * C * D; i += nt) {
    const int r = i / (C * D), rest = i - r * C * D, c = rest / D, d = rest - c * D;
    v0[i] = at(kV0F, r, c)[d];
    v1[i] = at(kV1F, r, c)[d];
    dv0[i] = at(kDV0, r, c)[d];
    dv1[i] = at(kDV1, r, c)[d];
  }
  for (int i = tid; i < R * C; i += nt) {
    const int r = i / C, c = i - r * C;
    kw[i] = *at(kKWF, r, c);
    dkw[i] = *at(kDKW, r, c);
  }
  __syncthreads();

  for (int c = C - 1; c >= 0; --c) {
    const bool zero_m = c == 0 && a.flag;
    // (1) logits over all the block's columns, their max and sums: a warp per row
    for (int r = warp; r < R; r += nwarps) {
      const float q = *at(kQ, r, c);
      const float* am = at(kAM, r, c);
      const float* sm = at(kSM, r, c);
      float mx = -FLT_MAX;
      for (int j = lane; j < C; j += 32) {
        const float l = (q + kw[r * C + j]) + am[j];
        lw[r * C + j] = l;
        mx = fmaxf(mx, l);
      }
      mx = warp_max(mx);
      float sum = 0.f;
      for (int j = lane; j < C; j += 32) {
        const float e = expf(lw[r * C + j] - mx);
        ew[r * C + j] = e;
        e0[r * C + j] = e * sm[j];
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float mp = *at(kMP, r, c);
        const float m = fmaxf(mp, mx);
        const float sp = expf(mp - m), sw = expf(mx - m);
        float* s = st + r * kStats;
        s[0] = mx;
        s[1] = sum;
        s[2] = sp;
        s[3] = sw;
        s[4] = *at(kDen, r, c) * sp + sum * sw;
      }
    }
    __syncthreads();

    // (2) the weighted values and M, from the final rows
    for (int i = tid; i < R * D; i += nt) {
      const int r = i / D, d = i - r * D;
      const float* v0r = v0 + r * C * D + d;
      const float* v1r = v1 + r * C * D + d;
      float n0 = 0.f, n1 = 0.f;
      for (int j = 0; j < C; ++j) {
        const float e = ew[r * C + j], es = e0[r * C + j];
        n0 = fmaf(es, v0r[j * D], n0);
        n1 = fmaf(e - es, v1r[j * D], n1);
      }
      const float n = n0 + n1;
      const float* s = st + r * kStats;
      const float m = zero_m ? 0.f : (at(kNum, r, c)[d] * s[2] + n * s[3]) / s[4];
      nw[i] = n;
      mv[i] = m;
      if (live(r)) at(kMS, r, c)[d] = m;
    }
    __syncthreads();

    // (3) g = dh1 + dV0 Wr0 + dV1 Wr1 + dK wk, then both GRUs' backward
    for (int k = tid; k < D; k += nt) {
      float acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        const long long w = (long long)d * D + k;
        const float w0 = __ldg(a.wr0 + w), w1 = __ldg(a.wr1 + w);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int o = (r * C + c) * D + d;
          acc[r] = fmaf(dv1[o], w1, fmaf(dv0[o], w0, acc[r]));
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float g = at(kDH1, r, c)[k] + acc[r] + dkw[r * C + c] * a.wk[k];
        const float* xc = at(kXC, r, c);
        const float* hp = at(kHP, r, c);
        const float* hpc = at(kHPC, r, c);
        const float* xpp = at(kXPP, r, c);
        const float r1 = sigmoid(xc[k] + hpc[k]), z1 = sigmoid(xc[D + k] + hpc[D + k]);
        const float n1 = tanhf(xc[2 * D + k] + r1 * hpc[2 * D + k]);
        const float r2 = sigmoid(xpp[k] + hp[k]), z2 = sigmoid(xpp[D + k] + hp[D + k]);
        const float n2 = tanhf(xpp[2 * D + k] + r2 * hp[2 * D + k]);
        const GruBwd node = gru_bwd(g, hpc[2 * D + k], mv[r * D + k], r1, z1, n1);
        const GruBwd proxy = gru_bwd(g, hp[2 * D + k], at(kH, r, c)[k], r2, z2, n2);
        float* dgr = dg + r * 6 * D + k;
        dgr[0] = node.dr;
        dgr[D] = node.dz;
        dgr[2 * D] = node.dhn;
        dgr[3 * D] = proxy.dr;
        dgr[4 * D] = proxy.dz;
        dgr[5 * D] = proxy.dn;
        dmh[r * D + k] = node.dh;
        if (live(r)) {
          float* dxc = at(kDXC, r, c);
          float* dhp = at(kDHP, r, c);
          float* dhpc = at(kDHPC, r, c);
          float* dxpp = at(kDXPP, r, c);
          dxc[k] = node.dr;
          dxc[D + k] = node.dz;
          dxc[2 * D + k] = node.dn;
          dhpc[k] = node.dr;
          dhpc[D + k] = node.dz;
          dhpc[2 * D + k] = node.dhn;
          dxpp[k] = proxy.dr;
          dxpp[D + k] = proxy.dz;
          dxpp[2 * D + k] = proxy.dn;
          dhp[k] = proxy.dr;
          dhp[D + k] = proxy.dz;
          dhp[2 * D + k] = proxy.dhn;
          at(kDH, r, c)[k] = proxy.dh;
        }
      }
    }
    __syncthreads();

    // (4) dM = node dh + dhpc Whcᵀ + dxpp Wipᵀ; dnum01 and the merge's partial sums
    float part[R][3];
#pragma unroll
    for (int r = 0; r < R; ++r) part[r][0] = part[r][1] = part[r][2] = 0.f;
    for (int k = tid; k < D; k += nt) {
      float acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = 0.f;
      const long long DD = (long long)D * D;
#pragma unroll 2
      for (int d = 0; d < D; ++d) {
        const long long o = (long long)d * D + k;
        const float w[6] = {__ldg(a.whh + o), __ldg(a.whh + DD + o), __ldg(a.whh + 2 * DD + o),
                            __ldg(a.wih + o), __ldg(a.wih + DD + o), __ldg(a.wih + 2 * DD + o)};
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float* dgr = dg + r * 6 * D + d;
#pragma unroll
          for (int g = 0; g < 6; ++g) acc[r] = fmaf(dgr[g * D], w[g], acc[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float dm = zero_m ? 0.f : dmh[r * D + k] + acc[r];
        const float* s = st + r * kStats;
        const float dnum = dm / s[4];
        const float num = at(kNum, r, c)[k];
        if (live(r)) at(kDNum, r, c)[k] = dnum * s[2];
        dnw[r * D + k] = dnum * s[3];
        part[r][0] = fmaf(dm, mv[r * D + k], part[r][0]);
        part[r][1] = fmaf(dnum, num, part[r][1]);
        part[r][2] = fmaf(dnum, nw[r * D + k], part[r][2]);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        const float s = warp_sum(part[r][p]);
        if (lane == 0) red[(r * 3 + p) * kMaxWarps + warp] = s;
      }
    __syncthreads();

    // (5) the merge's scalars (a thread per row); dnw . V0_j and dnw . V1_j
    // (a warp per (row, column)); dV0_j += e0_j dnw, dV1_j += (e_j - e0_j) dnw
    if (tid < R) {
      const int r = tid;
      float sums[3];
      for (int p = 0; p < 3; ++p) {
        float s = 0.f;
        for (int w = 0; w < nwarps; ++w) s += red[(r * 3 + p) * kMaxWarps + w];
        sums[p] = s;
      }
      float* s = st + r * kStats;
      const float mw = s[0], sum = s[1], sp = s[2], sw = s[3], den = s[4];
      const float dden = -sums[0] / den;
      const float dsp = sums[1] + dden * *at(kDen, r, c);
      const float dsw = sums[2] + dden * sum;
      const float mp_ge = *at(kMP, r, c) >= mw ? 1.f : 0.f;
      s[5] = dden * sw;                                            // d sum e
      s[6] = mp_ge * (dsw * sw) + (1.f - mp_ge) * (-dsp * sp);    // d max
      if (live(r)) {
        *at(kDDen, r, c) = dden * sp;
        *at(kDMP, r, c) = mp_ge * (-dsw * sw) + (1.f - mp_ge) * (dsp * sp);
      }
    }
    for (int p = warp; p < R * C; p += nwarps) {
      const int r = p / C, j = p - r * C;
      const float* dn = dnw + r * D;
      const float* v0j = v0 + (r * C + j) * D;
      const float* v1j = v1 + (r * C + j) * D;
      float s0 = 0.f, s1 = 0.f;
      for (int d = lane; d < D; d += 32) {
        s0 = fmaf(dn[d], v0j[d], s0);
        s1 = fmaf(dn[d], v1j[d], s1);
      }
      s0 = warp_sum(s0);
      s1 = warp_sum(s1);
      if (lane == 0) {
        dot0[p] = s0;
        dot1[p] = s1;
      }
    }
    for (int i = tid; i < R * C * D; i += nt) {
      const int r = i / (C * D), rest = i - r * C * D, j = rest / D, d = rest - j * D;
      const float dn = dnw[r * D + d], es = e0[r * C + j];
      dv0[i] = fmaf(es, dn, dv0[i]);
      dv1[i] = fmaf(ew[r * C + j] - es, dn, dv1[i]);
    }
    __syncthreads();

    // (6) the softmax backward, dq and dK: a warp per row
    for (int r = warp; r < R; r += nwarps) {
      const float* sm = at(kSM, r, c);
      const float* s = st + r * kStats;
      const float mw = s[0], dsum = s[5];
      float sdl = 0.f, nmax = 0.f;
      for (int j = lane; j < C; j += 32) {
        const float dew = dot0[r * C + j] * sm[j] + dot1[r * C + j] * (1.f - sm[j]) + dsum;
        const float d = dew * ew[r * C + j];
        dl[r * C + j] = d;
        sdl += d;
        nmax += lw[r * C + j] == mw ? 1.f : 0.f;
      }
      sdl = warp_sum(sdl);
      nmax = warp_sum(nmax);
      const float share = (s[6] - sdl) / fmaxf(nmax, 1.f);  // ties of the max split evenly
      float dq = 0.f;
      for (int j = lane; j < C; j += 32) {
        const float d = dl[r * C + j] + (lw[r * C + j] == mw ? 1.f : 0.f) * share;
        dq += d;
        dkw[r * C + j] += d;
      }
      dq = warp_sum(dq);
      if (lane == 0 && live(r)) *at(kDQ, r, c) = dq;
    }
    __syncthreads();
  }

  for (int i = tid; i < R * C * D; i += nt) {
    const int r = i / (C * D), rest = i - r * C * D, c = rest / D, d = rest - c * D;
    if (live(r)) {
      at(kDV0S, r, c)[d] = dv0[i];
      at(kDV1S, r, c)[d] = dv1[i];
    }
  }
  for (int i = tid; i < R * C; i += nt) {
    const int r = i / C, c = i - r * C;
    if (live(r)) *at(kDKWS, r, c) = dkw[i];
  }
}

// Tiles (blockIdx.x, blockIdx.y) of product blockIdx.z; the extra row of
// tiles (blockIdx.y == number of tiles) computes the product's vector sum.
__global__ void __launch_bounds__(kTileThreads) dag_block_wgrad_kernel(const WgradArgs a) {
  __shared__ float as[kTile][kTile + 1];
  __shared__ float bs[kTile][kTile + 1];
  const int z = blockIdx.z, N = a.N, D = a.D;
  const int tx = threadIdx.x & (kTile - 1), ty = threadIdx.x / kTile;  // ty in 0..7
  constexpr int kRows = kTileThreads / kTile;
  const int j = blockIdx.x * kTile + tx;
  const int tiles = (D + kTile - 1) / kTile;

  if ((int)blockIdx.y == tiles) {
    if (a.vout[z] == nullptr) return;
    float s = 0.f;
    if (j < D)
      for (int n = ty; n < N; n += kRows)
        s = fmaf(a.w[z] ? a.w[z][n] : 1.f, a.x[z][n * a.ldx[z] + j], s);
    as[ty][tx] = s;
    __syncthreads();
    if (ty == 0 && j < D) {
      float t = 0.f;
      for (int y = 0; y < kRows; ++y) t += as[y][tx];
      a.vout[z][j] = t;
    }
    return;
  }

  const int i0 = blockIdx.y * kTile;
  float acc[kTile / kRows];
#pragma unroll
  for (int q = 0; q < kTile / kRows; ++q) acc[q] = 0.f;
  for (int n0 = 0; n0 < N; n0 += kTile) {
#pragma unroll
    for (int q = 0; q < kTile / kRows; ++q) {
      const int nn = ty + kRows * q, n = n0 + nn;
      const bool in_n = n < N;
      as[nn][tx] = in_n && i0 + tx < D ? a.a[z][n * a.lda[z] + i0 + tx] : 0.f;
      bs[nn][tx] = in_n && j < D ? a.b[z][n * a.ldb[z] + j] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int nn = 0; nn < kTile; ++nn) {
      const float bv = bs[nn][tx];
#pragma unroll
      for (int q = 0; q < kTile / kRows; ++q) acc[q] = fmaf(as[nn][ty + kRows * q], bv, acc[q]);
    }
    __syncthreads();
  }
  if (j < D)
#pragma unroll
    for (int q = 0; q < kTile / kRows; ++q) {
      const int i = i0 + ty + kRows * q;
      if (i < D) a.out[z][(long long)i * D + j] = acc[q];
    }
}


// ------------------------------------------------------------------ cluster variant
// Shared-memory layout of one block of the cluster variant, offsets in floats.
struct BwdLayout {
  long long Dp, GA;  // weight row length (D rounded up to 4), gathered floats a row (3 + 2C)
  long long wt, wk, vf, dv, xg, rg, rm, ga, dnw, pt, kw, dk, dl, lw, ew, e0, sm, st, total;
  __host__ __device__ BwdLayout(int R, int C, int D, int w) {
    Dp = round4(D);
    GA = 3 + 2LL * C;
    const long long RC = (long long)R * C;
    wt = 0;                               // [8w][Dp] rows S of Wr0, Wr1, w_hh r|z|n, w_ih r|z|n
    wk = wt + 8LL * w * Dp;               // [w]  wk[S]
    vf = wk + w;                          // [R][C][2w] final V0 | V1 of this block's columns
    dv = vf + 2 * RC * w;                 // [R][C][2w] running dV0 | dV1
    xg = dv + 2 * RC * w;                 // [R][6w] dhpc r|z|n, dxpp r|z|n of this block's columns
    rg = xg + 6LL * R * w;                // [16][R][w] each block's partial of g for these columns
    rm = rg + 16LL * R * w;               // [16][R][w] each block's partial of dM
    ga = rm + 16LL * R * w;               // [16][R][GA] each block's partial merge sums and dots
    dnw = ga + 16LL * R * GA;             // [R][w]
    pt = dnw + (long long)R * w;          // [R][3][w] terms of the partial merge sums
    kw = pt + 3LL * R * w;                // [R][C] final keys
    dk = kw + RC;                         // [R][C] running dK
    dl = dk + RC;                         // [R][C] d logits
    lw = dl + RC;                         // [2][R][C] logits, by the parity of the position
    ew = lw + 2 * RC;                     // [2][R][C] exp(logit - max)
    e0 = ew + 2 * RC;                     // [2][R][C] ew * sm
    sm = e0 + 2 * RC;                     // [2][R][C] the speaker mask of the position
    st = sm + 2 * RC;                     // [2][R][kStats] max, sum e, sp, sw, den, mp, den_p
    total = st + 2LL * R * kStats;
  }
};

// acc[r][e] = sum over i < n of x[r xs + i] W[i Dp + 4 gi + e]: the warp's four
// lane octets (sub = lane >> 3) each take a quarter of i, then meet by
// shuffles, so every octet holds the same bits of the whole sum.
template <int R>
__device__ __forceinline__ void tproduct(const float* __restrict__ W, int Dp, int n, const float* __restrict__ x,
                                         int xs, int gi, int sub, float (&acc)[R][4]) {
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
  if (4 * gi < Dp) {
    const int G = Dp >> 2, i0 = sub * n / 4, i1 = (sub + 1) * n / 4;
    const float4* w4 = reinterpret_cast<const float4*>(W) + gi;
#pragma unroll 4
    for (int i = i0; i < i1; ++i) {
      const float4 wv = w4[i * G];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float xv = x[r * xs + i];
        acc[r][0] = fmaf(xv, wv.x, acc[r][0]);
        acc[r][1] = fmaf(xv, wv.y, acc[r][1]);
        acc[r][2] = fmaf(xv, wv.z, acc[r][2]);
        acc[r][3] = fmaf(xv, wv.w, acc[r][3]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[r][e] += __shfl_xor_sync(0xffffffffu, acc[r][e], 8);
      acc[r][e] += __shfl_xor_sync(0xffffffffu, acc[r][e], 16);
    }
}

// Send outputs 4 gi .. 4 gi + 3 of acc to the block q that owns them, into
// its buf[rank][r][4 gi - q w ..] (w % 4 == 0, so a group never straddles two
// blocks); octet `sub` sends the rows r = sub (mod 4).
template <int R>
__device__ __forceinline__ void scatter(cg::cluster_group& cluster, float* buf, int rank, int w, int D, int gi,
                                        int sub, float (&acc)[R][4]) {
  const int k = 4 * gi;
  if (k >= D) return;
  const int q = k / w;
  float* dst = cluster.map_shared_rank(buf, q) + k - q * w;
#pragma unroll
  for (int r = 0; r < R; ++r)
    if ((r & 3) == sub)
      *reinterpret_cast<float4*>(dst + (rank * R + r) * w) = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
}

// Cycle stamps (clock64) of thread 0 of the first block at the phases of
// position C / 2, and of the launch's start, weight load and end: read by
// erc_dag_block_bwd_phase_cycles, so that a timing run can see where a
// position's time goes.  One predicated store per phase.
__device__ long long g_bwd_phase_cycles[kPhaseStamps];

// one thread's inputs of its (row, column) at a position
struct ColumnInputs {
  float dh1, num, h, xc[3], hp[3], hpc[3], xpp[3];
};

template <int R>
__global__ void __launch_bounds__(kClusterThreads, 1) dag_block_bwd_cluster_kernel(const DagBwdArgs a, const int w) {
  extern __shared__ __align__(16) float csmem[];
  float* smem = csmem;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int C = a.C, D = a.D, RC = R * C;
  const BwdLayout lay(R, C, D, w);
  const int Dp = (int)lay.Dp, GA = (int)lay.GA, W2 = 2 * w;
  float* wt = smem + lay.wt;
  float* wk = smem + lay.wk;
  float* vf = smem + lay.vf;
  float* dv = smem + lay.dv;
  float* xg = smem + lay.xg;
  float* rg = smem + lay.rg;
  float* rm = smem + lay.rm;
  float* ga = smem + lay.ga;
  float* dnw = smem + lay.dnw;
  float* pt = smem + lay.pt;
  float* kw = smem + lay.kw;
  float* dk = smem + lay.dk;
  float* dl = smem + lay.dl;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int col0 = rank * w, nc = max(0, min(w, D - col0));
  const bool stamps = blockIdx.x == 0 && tid == 0;
  auto stamp = [&](int i) {
    if (stamps) g_bwd_phase_cycles[i] = clock64();
  };
  stamp(0);

  const int row0 = (blockIdx.x / kClusterBlocks) * R;
  // rows past B repeat row B-1's reads and write nothing
  auto at = [&](int t, int r, int c) {
    const long long b = min(row0 + r, a.B - 1);
    return a.ptr[t] + b * a.sb[t] + (long long)c * a.sc[t];
  };
  auto live = [&](int r) { return row0 + r < a.B; };

  // this block's weight rows, once per launch: each thread keeps one column
  // group (16 bytes where D and the bases allow) and steps over the rows
  {
    const long long DD = (long long)D * D;
    auto panel = [&](int p) {
      return p == 0 ? a.wr0 : p == 1 ? a.wr1 : (p < 5 ? a.whh : a.wih) + (long long)((p - 2) % 3) * DD;
    };
    bool wide = D % 4 == 0;
    for (int p = 0; p < 8; ++p) wide = wide && reinterpret_cast<unsigned long long>(panel(p)) % 16 == 0;
    const int V = wide ? 4 : 1, Q = Dp / V, per = kClusterThreads / Q;
    if (tid < per * Q) {
      const int k = (tid % Q) * V;
      int row = tid / Q, p = row / w, i = row - p * w;
      for (; row < 8 * w; row += per) {
        float* dst = wt + (long long)row * Dp + k;
        if (i < nc && k < D) {
          const float* src = panel(p) + (long long)(col0 + i) * D + k;
          if (wide) cp_async16(dst, src);
          else cp_async4(dst, src);
        } else {
          for (int e = 0; e < V; ++e) dst[e] = 0.f;
        }
        for (i += per; i >= w; i -= w) ++p;
      }
    }
    for (int i = tid; i < w; i += kClusterThreads) wk[i] = i < nc ? a.wk[col0 + i] : 0.f;
    cp_async_wait_all();
  }
  // the rows' final values and cotangents of this block's columns (0 past D)
  for (int i = tid; i < RC * w; i += kClusterThreads) {
    const int r = i / (C * w), rest = i - r * C * w, j = rest / w, cc = rest - j * w;
    const long long o = ((long long)r * C + j) * W2 + cc;
    const bool ok = cc < nc;
    const int d = col0 + cc;
    vf[o] = ok ? at(kV0F, r, j)[d] : 0.f;
    vf[o + w] = ok ? at(kV1F, r, j)[d] : 0.f;
    dv[o] = ok ? at(kDV0, r, j)[d] : 0.f;
    dv[o + w] = ok ? at(kDV1, r, j)[d] : 0.f;
  }
  for (int i = tid; i < RC; i += kClusterThreads) {
    const int r = i / C, j = i - r * C;
    kw[i] = *at(kKWF, r, j);
    dk[i] = *at(kDKW, r, j);
  }
  for (int i = tid; i < 6 * R * w; i += kClusterThreads) xg[i] = 0.f;  // columns past nc stay 0
  stamp(1);
  // every block of the cluster is running before any block stores into another's shared memory
  cluster.sync();
  stamp(2);

  // this thread's (row, own column) in the column phases: R nc <= kClusterThreads
  const bool mine = tid < R * nc;
  const int r_me = mine ? tid / nc : 0, c_me = mine ? tid - r_me * nc : 0, d_me = col0 + c_me;
  const bool write_me = mine && live(r_me);
  // this thread's column group and contraction quarter in the products
  const int gi = warp * 8 + (lane & 7), sub = lane >> 3;
  // the last R warps take a row each in the row phases (1) and (5), beside the column phases
  const int rw = warp - (kClusterWarps - R);
  // the per-position arrays of position c
  auto lw = [&](int c) { return smem + lay.lw + (c & 1) * RC; };
  auto ew = [&](int c) { return smem + lay.ew + (c & 1) * RC; };
  auto e0 = [&](int c) { return smem + lay.e0 + (c & 1) * RC; };
  auto sm = [&](int c) { return smem + lay.sm + (c & 1) * RC; };
  auto st = [&](int c, int r) { return smem + lay.st + ((c & 1) * R + r) * kStats; };

  auto load_inputs = [&](int c) {
    ColumnInputs in = {};
    if (mine) {
      in.dh1 = at(kDH1, r_me, c)[d_me];
      in.num = at(kNum, r_me, c)[d_me];
      in.h = at(kH, r_me, c)[d_me];
      const float* xcp = at(kXC, r_me, c);
      const float* hpp = at(kHP, r_me, c);
      const float* hpcp = at(kHPC, r_me, c);
      const float* xppp = at(kXPP, r_me, c);
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        in.xc[g] = xcp[g * D + d_me];
        in.hp[g] = hpp[g * D + d_me];
        in.hpc[g] = hpcp[g * D + d_me];
        in.xpp[g] = xppp[g * D + d_me];
      }
    }
    return in;
  };
  // (1) logits over all C columns of position c, their max and sums: the
  // same values in every block
  auto logits = [&](int c) {
    if (rw < 0) return;
    const int r = rw;
    const float q = *at(kQ, r, c);
    const float* am = at(kAM, r, c);
    const float* smr = at(kSM, r, c);
    float* L = lw(c) + r * C;
    float* E = ew(c) + r * C;
    float* E0 = e0(c) + r * C;
    float* S = sm(c) + r * C;
    float mx = -FLT_MAX;
    for (int j = lane; j < C; j += 32) {
      const float l = (q + kw[r * C + j]) + am[j];
      L[j] = l;
      mx = fmaxf(mx, l);
    }
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < C; j += 32) {
      const float e = expf(L[j] - mx), s = smr[j];
      E[j] = e;
      E0[j] = e * s;
      S[j] = s;
      sum += e;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      const float mp = *at(kMP, r, c), den_p = *at(kDen, r, c);
      const float m = fmaxf(mp, mx);
      const float sp = expf(mp - m), sw = expf(mx - m);
      float* s = st(c, r);
      s[0] = mx;
      s[1] = sum;
      s[2] = sp;
      s[3] = sw;
      s[4] = den_p * sp + sum * sw;
      s[5] = mp;
      s[6] = den_p;
    }
  };
  // this block's partial of g = dV0_c Wr0 + dV1_c Wr1 over its rows, to every block
  auto g_partial = [&](int c) {
    float acc[R][4];
    tproduct<R>(wt, Dp, W2, dv + (long long)c * W2, C * W2, gi, sub, acc);
    scatter<R>(cluster, rg, rank, w, D, gi, sub, acc);
  };
  // (5) the merge's and the softmax's backward of position c, dq and dK: the
  // 16 blocks' partials added in rank order, the same in every block
  auto softmax_bwd = [&](int c) {
    if (rw < 0) return;
    const int r = rw;
    const float* gr = ga + r * GA;
    const long long qs = (long long)R * GA;  // from one block's partials to the next
    float sums[3];
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      float s = 0.f;
      for (int q = 0; q < kClusterBlocks; ++q) s += gr[q * qs + p];
      sums[p] = s;
    }
    const float* s = st(c, r);
    const float mw = s[0], sum = s[1], sp = s[2], sw = s[3], den = s[4], mp = s[5], den_p = s[6];
    const float dden = -sums[0] / den;
    const float dsp = sums[1] + dden * den_p;
    const float dsw = sums[2] + dden * sum;
    const float mp_ge = mp >= mw ? 1.f : 0.f;
    const float dsum = dden * sw;
    const float dmax = mp_ge * (dsw * sw) + (1.f - mp_ge) * (-dsp * sp);
    if (rank == 0 && lane == 0 && live(r)) {
      *at(kDDen, r, c) = dden * sp;
      *at(kDMP, r, c) = mp_ge * (-dsw * sw) + (1.f - mp_ge) * (dsp * sp);
    }
    const float* L = lw(c) + r * C;
    const float* E = ew(c) + r * C;
    const float* S = sm(c) + r * C;
    float sdl = 0.f, nmax = 0.f;
    for (int j = lane; j < C; j += 32) {
      float d0 = 0.f, d1 = 0.f;
      for (int q = 0; q < kClusterBlocks; ++q) {
        d0 += gr[q * qs + 3 + j];
        d1 += gr[q * qs + 3 + C + j];
      }
      const float dew = d0 * S[j] + d1 * (1.f - S[j]) + dsum;
      const float d = dew * E[j];
      dl[r * C + j] = d;
      sdl += d;
      nmax += L[j] == mw ? 1.f : 0.f;
    }
    sdl = warp_sum(sdl);
    nmax = warp_sum(nmax);
    const float share = (dmax - sdl) / fmaxf(nmax, 1.f);  // ties of the max split evenly
    float dq = 0.f;
    for (int j = lane; j < C; j += 32) {
      const float d = dl[r * C + j] + (L[j] == mw ? 1.f : 0.f) * share;
      dq += d;
      dk[r * C + j] += d;
    }
    dq = warp_sum(dq);
    if (rank == 0 && lane == 0 && live(r)) *at(kDQ, r, c) = dq;
  };

  ColumnInputs in = load_inputs(C - 1);
  logits(C - 1);
  g_partial(C - 1);
  cluster.sync();  // X(C - 1): the g partials of position C - 1 are here

  for (int c = C - 1; c >= 0; --c) {
    const bool mid = c == C / 2, zero_m = c == 0 && a.flag;
    if (mid) stamp(3);
    // (5) of position c + 1, beside (2) of position c: nw and M of this
    // block's columns (M stashed, never exchanged)
    if (c + 1 < C) softmax_bwd(c + 1);
    float mval = 0.f, nwv = 0.f;
    if (mine) {
      const int r = r_me;
      const float* v = vf + (long long)r * C * W2 + c_me;
      const float* E = ew(c) + r * C;
      const float* E0 = e0(c) + r * C;
      float n0 = 0.f, n1 = 0.f;
      for (int j = 0; j < C; ++j) {
        const float e = E[j], es = E0[j];
        n0 = fmaf(es, v[j * W2], n0);
        n1 = fmaf(e - es, v[j * W2 + w], n1);
      }
      nwv = n0 + n1;
      const float* s = st(c, r);
      mval = zero_m ? 0.f : (in.num * s[2] + nwv * s[3]) / s[4];
      if (write_me) at(kMS, r, c)[d_me] = mval;
    }
    __syncthreads();
    if (mid) stamp(4);

    // (3) g of this block's columns, then both GRUs' backward
    float dmh = 0.f;
    if (mine) {
      const int r = r_me, cc = c_me, d = d_me;
      float s = 0.f;
      for (int q = 0; q < kClusterBlocks; ++q) s += rg[(q * R + r) * w + cc];
      const float g = in.dh1 + s + dk[r * C + c] * wk[cc];
      const float r1 = sigmoid(in.xc[0] + in.hpc[0]), z1 = sigmoid(in.xc[1] + in.hpc[1]);
      const float n1 = tanhf(in.xc[2] + r1 * in.hpc[2]);
      const float r2 = sigmoid(in.xpp[0] + in.hp[0]), z2 = sigmoid(in.xpp[1] + in.hp[1]);
      const float n2 = tanhf(in.xpp[2] + r2 * in.hp[2]);
      const GruBwd node = gru_bwd(g, in.hpc[2], mval, r1, z1, n1);
      const GruBwd proxy = gru_bwd(g, in.hp[2], in.h, r2, z2, n2);
      float* x = xg + r * 6 * w + cc;
      x[0] = node.dr;
      x[w] = node.dz;
      x[2 * w] = node.dhn;
      x[3 * w] = proxy.dr;
      x[4 * w] = proxy.dz;
      x[5 * w] = proxy.dn;
      dmh = node.dh;
      if (write_me) {
        float* dxc = at(kDXC, r, c);
        float* dhp = at(kDHP, r, c);
        float* dhpc = at(kDHPC, r, c);
        float* dxpp = at(kDXPP, r, c);
        dxc[d] = node.dr;
        dxc[D + d] = node.dz;
        dxc[2 * D + d] = node.dn;
        dhpc[d] = node.dr;
        dhpc[D + d] = node.dz;
        dhpc[2 * D + d] = node.dhn;
        dxpp[d] = proxy.dr;
        dxpp[D + d] = proxy.dz;
        dxpp[2 * D + d] = proxy.dn;
        dhp[d] = proxy.dr;
        dhp[D + d] = proxy.dz;
        dhp[2 * D + d] = proxy.dhn;
        at(kDH, r, c)[d] = proxy.dh;
      }
    }
    __syncthreads();
    if (mid) stamp(5);
    // this block's partial of dM = dhpc w_hh + dxpp w_ih over its rows, to every block
    {
      float acc[R][4];
      tproduct<R>(wt + (long long)W2 * Dp, Dp, 6 * w, xg, 6 * w, gi, sub, acc);
      scatter<R>(cluster, rm, rank, w, D, gi, sub, acc);
    }
    const ColumnInputs next = c > 0 ? load_inputs(c - 1) : ColumnInputs{};
    if (mid) stamp(6);
    cluster.sync();  // B(c): every block's partial of dM is here
    if (mid) stamp(7);

    // (4) dM of this block's columns (0 at global position 0), dnum01, dnw
    // and the terms of the merge's sums, beside (1) of position c - 1
    if (mine) {
      const int r = r_me, cc = c_me;
      float s = 0.f;
      for (int q = 0; q < kClusterBlocks; ++q) s += rm[(q * R + r) * w + cc];
      const float dm = zero_m ? 0.f : dmh + s;
      const float* sts = st(c, r);
      const float dnum = dm / sts[4];
      if (write_me) at(kDNum, r, c)[d_me] = dnum * sts[2];
      const float dn = dnum * sts[3];
      dnw[r * w + cc] = dn;
      float* t = pt + r * 3 * w + cc;
      t[0] = dm * mval;
      t[w] = dnum * in.num;
      t[2 * w] = dnum * nwv;
    }
    if (c > 0) logits(c - 1);
    __syncthreads();
    if (mid) stamp(8);
    // the partial sums over this block's columns, sent to every block: the
    // merge's three, then dnw . V0_j and dnw . V1_j for every j
    for (int t = tid; t < R * GA; t += kClusterThreads) {
      const int r = t / GA, p = t - r * GA;
      float s = 0.f;
      if (p < 3) {
        const float* x = pt + (r * 3 + p) * w;
        for (int i = 0; i < nc; ++i) s += x[i];
      } else {
        const int which = (p - 3) / C, j = p - 3 - which * C;
        const float* v = vf + ((long long)r * C + j) * W2 + which * w;
        const float* dn = dnw + r * w;
        for (int i = 0; i < nc; ++i) s = fmaf(dn[i], v[i], s);
      }
      for (int q = 0; q < kClusterBlocks; ++q)
        cluster.map_shared_rank(ga, (rank + q) % kClusterBlocks)[(rank * R + r) * GA + p] = s;
    }
    // dV0_j += e0_j dnw, dV1_j += (e_j - e0_j) dnw on this block's columns
    for (int i = tid; i < RC * nc; i += kClusterThreads) {
      const int r = i / (C * nc), rest = i - r * C * nc, j = rest / nc, cc = rest - j * nc;
      const float dn = dnw[r * w + cc], e = ew(c)[r * C + j], es = e0(c)[r * C + j];
      float* o = dv + ((long long)r * C + j) * W2 + cc;
      o[0] = fmaf(es, dn, o[0]);
      o[w] = fmaf(e - es, dn, o[w]);
    }
    __syncthreads();
    if (mid) stamp(9);
    if (c > 0) g_partial(c - 1);
    if (mid) stamp(10);
    cluster.sync();  // X(c - 1): every block's partial sums of c and partial of g of c - 1 are here
    if (mid) stamp(11);
    in = next;
  }
  softmax_bwd(0);
  __syncthreads();
  stamp(12);

  for (int i = tid; i < RC * nc; i += kClusterThreads) {
    const int r = i / (C * nc), rest = i - r * C * nc, j = rest / nc, cc = rest - j * nc;
    if (live(r)) {
      const long long o = ((long long)r * C + j) * W2 + cc;
      at(kDV0S, r, j)[col0 + cc] = dv[o];
      at(kDV1S, r, j)[col0 + cc] = dv[o + w];
    }
  }
  if (rank == 0)
    for (int i = tid; i < RC; i += kClusterThreads) {
      const int r = i / C, j = i - r * C;
      if (live(r)) *at(kDKWS, r, j) = dk[i];
    }
}

// ------------------------------------------------------------------ launch

// Whether the cluster variant takes (rows, C, D) with `cols` columns a block.
bool cluster_ok(int rows, int C, int D, int cols) {
  return rows >= 1 && rows <= kMaxClusterRows && cols >= 4 && cols % 4 == 0 &&
         (long long)cols * kClusterBlocks >= D && (round4(D) / 4 + 7) / 8 <= kClusterWarps &&
         rows * cols <= kClusterThreads && BwdLayout(rows, C, D, cols).total * (long long)sizeof(float) <= kMaxSmem;
}

template <int R, bool WS>
cudaError_t launch_stream(const DagBwdArgs& a, size_t smem, cudaStream_t stream) {
  static size_t allowed = 48 * 1024;
  const cudaError_t err = allow_smem(dag_block_bwd_stream_kernel<R, WS>, smem, allowed);
  if (err != cudaSuccess) return err;
  const int warps = (a.D + 31) / 32;
  const int threads = 32 * (warps < kMaxWarps ? warps : kMaxWarps);
  dag_block_bwd_stream_kernel<R, WS><<<(a.B + R - 1) / R, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

// The cluster kernel of R rows, its attributes set for `smem` bytes (16
// blocks a cluster is a non-portable size); with `max_clusters`, the number
// of its clusters the card holds at once, else a launch of `clusters`.
template <int R>
cudaError_t cluster_call(const DagBwdArgs* a, int cols, int clusters, size_t smem, cudaStream_t stream,
                         int* max_clusters) {
  static size_t allowed = 48 * 1024;
  static bool nonportable = false;
  auto kernel = dag_block_bwd_cluster_kernel<R>;
  cudaError_t err = allow_cluster(kernel, nonportable);
  if (err == cudaSuccess) err = allow_smem(kernel, smem, allowed);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(max_clusters ? 1 : clusters, kClusterThreads, smem, stream, &attr);
  if (max_clusters) return cudaOccupancyMaxActiveClusters(max_clusters, (const void*)kernel, &cfg);
  err = cudaLaunchKernelEx(&cfg, kernel, *a, cols);
  return err != cudaSuccess ? err : cudaGetLastError();
}

cudaError_t cluster_dispatch(const DagBwdArgs* a, int rows, int cols, int clusters, size_t smem,
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

// Dynamic shared memory (bytes) one block of the sweep needs: variant 0
// (stream) with `rows` rows a block, variant 1 (cluster) with `rows` rows a
// cluster and `cols` columns a block, variant 2 (global) none (its layout
// takes as many bytes of its workspace a block as the stream variant's of
// shared memory); mirrored by bwd_stream_smem and bwd_cluster_smem in
// ops/kernels/dag_block.py.
long long erc_dag_block_bwd_smem(int variant, int rows, int C, int D, int cols) {
  if (variant == kGlobal) return 0;
  const long long floats =
      variant == kStream ? stream_smem_floats(rows, C, D) : BwdLayout(rows, C, D, cols).total;
  return floats * (long long)sizeof(float);
}

// The number of clusters of the cluster variant (rows, C, D, cols) that the
// current device holds at once (cudaOccupancyMaxActiveClusters), in *n.
int erc_dag_block_bwd_max_clusters(int rows, int C, int D, int cols, int* n) {
  if (!cluster_ok(rows, C, D, cols)) return (int)cudaErrorInvalidValue;
  return (int)cluster_dispatch(nullptr, rows, cols, 0, (size_t)erc_dag_block_bwd_smem(kCluster, rows, C, D, cols),
                               nullptr, n);
}

// The sweep by the wrapper's plan: variant 0 (stream, `rows` 1 or 2 rows a
// block; `n` and `cols` unused), 1 (cluster: `n` clusters of 16 blocks,
// `rows` rows a cluster, `cols` columns a block) or 2 (global: one row a
// block, `n` = B blocks, args->ws holding stream_smem_floats(1, C, D) floats
// for each of them).  A plan that does not cover B, does not fit in shared
// memory or names other than B global blocks (whose workspace the wrapper
// sized by `n`) is refused.
int erc_dag_block_bwd_sweep(const DagBwdArgs* args, int variant, int rows, int n, int cols, void* stream) {
  const DagBwdArgs& a = *args;
  if (a.B < 1 || a.C < 1 || a.D < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = (size_t)erc_dag_block_bwd_smem(variant, rows, a.C, a.D, cols);
  if (variant == kCluster) {
    if (!cluster_ok(rows, a.C, a.D, cols) || n < 1 || (long long)n * rows < a.B) return (int)cudaErrorInvalidValue;
    return (int)cluster_dispatch(&a, rows, cols, n, smem, s, nullptr);
  }
  if (variant == kGlobal) {
    if (rows != 1 || n != a.B || a.ws == nullptr) return (int)cudaErrorInvalidValue;
    return (int)launch_stream<1, true>(a, 0, s);
  }
  if (variant != kStream || (long long)smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  switch (rows) {
    case 1: return (int)launch_stream<1, false>(a, smem, s);
    case 2: return (int)launch_stream<2, false>(a, smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The weight gradients: kProducts [D, D] products and their vector sums.
int erc_dag_block_bwd_wgrad(const WgradArgs* args, void* stream) {
  const WgradArgs& a = *args;
  if (a.N < 1 || a.D < 1) return (int)cudaErrorInvalidValue;
  const int tiles = (a.D + kTile - 1) / kTile;
  const dim3 grid(tiles, tiles + 1, kProducts);
  dag_block_wgrad_kernel<<<grid, kTileThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// The cluster sweep's kPhaseStamps cycle stamps of its latest launch (see
// g_bwd_phase_cycles), into out[kPhaseStamps]; synchronises with the device.
int erc_dag_block_bwd_phase_cycles(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_bwd_phase_cycles, sizeof(g_bwd_phase_cycles));
}

const char* erc_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
