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
// 0.4 GFLOP together, 6 µs at the card's float32 rate.  As in K3, the
// weights (2 x [3D, D] + 2 x [D, D], 2.9 MB) do not fit in shared memory,
// so the sweep streams them from L2 at every position: it is latency-bound.
// Design: one thread block per 2 batch rows (each weight element loaded
// once per position serves both), or per row where 2 rows' buffers do not
// fit in shared memory.  A row's final V0/V1 and running dV0/dV1 (4·C·D
// floats) stay in shared memory.  K3 reads [k, d] weight rows with threads
// over the output column d; the sweep contracts over the other index, so it
// reads the weights in torch's own layout (w_hh, w_ih, Wr0, Wr1 as the model
// registers them), again coalesced with threads over the output column.
// Each position is six phases between __syncthreads(): (1) logits, max and
// sums, a warp per row; (2) M and the attention's weighted values; (3) g
// and both GRUs' backward; (4) dM and the merge's partial sums; (5) the
// merge's scalars, the dot products of dnw with every V0_j/V1_j, and the
// dV0/dV1 updates; (6) the softmax backward, dq and dK, a warp per row.
//
// Inputs are f32.  The [B, C, ...] tensors (enum Tensor) have contiguous
// [b, c] slices and free batch and position strides.  The entry points
// launch on the caller's stream, do not synchronise, and return
// cudaGetLastError().

#include <cfloat>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kTile = 32;          // weight-gradient tile: 32 x 32 outputs
constexpr int kTileThreads = 256;  // 8 rows of 32 threads, 4 outputs each

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

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

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

constexpr int kStats = 8;  // per row: max, sum e, sp, sw, den, d sum e, d max, (spare)

template <int R>
__global__ void __launch_bounds__(kMaxThreads) dag_block_bwd_kernel(const DagBwdArgs a) {
  extern __shared__ float smem[];
  const int C = a.C, D = a.D;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, nwarps = nt >> 5;
  float* v0 = smem;              // [R][C][D] the block's final V0 rows
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

long long smem_floats(int rows, int C, int D) {
  return 4LL * rows * C * D + 10LL * rows * D + 8LL * rows * C + (long long)rows * kStats +
         3LL * rows * kMaxWarps;
}

template <int R>
cudaError_t launch(const DagBwdArgs& a, int threads, size_t smem, cudaStream_t stream) {
  // raise the kernel's shared-memory limit once per size, so that launches
  // captured into a CUDA graph after a first call make no attribute call
  static size_t allowed = 48 * 1024;
  if (smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        (const void*)dag_block_bwd_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    allowed = smem;
  }
  dag_block_bwd_kernel<R><<<(a.B + R - 1) / R, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory (bytes) the sweep needs for `rows` rows, for the wrapper's check.
long long erc_dag_block_bwd_smem(int rows, int C, int D) {
  return smem_floats(rows, C, D) * (long long)sizeof(float);
}

// The sweep; rows: batch rows per thread block, 2, or 1 where 2 do not fit.
int erc_dag_block_bwd_sweep(const DagBwdArgs* args, int rows, void* stream) {
  const DagBwdArgs& a = *args;
  if (a.B < 1 || a.C < 1 || a.D < 1) return (int)cudaErrorInvalidValue;
  const int warps = (a.D + 31) / 32;
  const int threads = 32 * (warps < kMaxWarps ? warps : kMaxWarps);
  const size_t smem = (size_t)erc_dag_block_bwd_smem(rows, a.C, a.D);
  const cudaStream_t s = (cudaStream_t)stream;
  switch (rows) {
    case 1: return (int)launch<1>(a, threads, smem, s);
    case 2: return (int)launch<2>(a, threads, smem, s);
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

const char* erc_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
