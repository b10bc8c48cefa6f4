// GRU recurrence backward for one bidirectional layer, CUDA C++ for sm_90a.
//
// Replaces the TPU kernels roko_tpu/models/pallas_gru.py::_bwd_kernel_v3
// (time-only grid) and ::_bwd_kernel (batch-blocked v2 grid). Both sweep
// each direction's time backwards and, per step, recompute the gates from
// the stored previous state h_prev, then
//
//   hp  = h_prev W_hh[s] + b_hh[s]
//   r = sigmoid(x_r + hp_r), z = sigmoid(x_z + hp_z), n = tanh(x_n + r hp_n)
//   dh += dy
//   dz = dh (h_prev - n) z (1 - z)
//   dn = dh (1 - z) (1 - n^2)
//   dr = dn hp_n r (1 - r)                    (hp_n carries its bias b_hn)
//   dxp = [dr, dz, dn],  dhp = [dr, dz, dn r]
//   dh <- dh z + dhp W_hh[s]^T
//   dW_hh[s] += h_prev^T dhp,  db_hh[s] += sum over rows of dhp
//
// Layout is the port's natural one: xp [B, T, S*3H], the forward's output
// out [B, T, S*H] and its gradient dy [B, T, S*H] in; dxp [B, T, S*3H],
// dW_hh [S, H, 3H] and db_hh [S, 3H] out. Direction 0 walks t = T-1 .. 0
// with h_prev = out[t-1]; direction 1 walks t = 0 .. T-1 with
// h_prev = out[t+1]; h_prev is zero at each direction's first step. The
// TPU's stacked time-major slabs, batch padding and time-block boundary
// rows (hs_bound) have no counterpart: a block reads out[t -/+ 1] directly.
//
// Design. A recurrence kernel, then a weight-gradient pass, launched back
// to back on one stream.
//
// (a) The recurrence: one block per (direction, tile of ROWS batch rows)
//     runs the whole reverse time loop, thread j owning hidden unit j for
//     all ROWS rows, dh in registers. Rows never interact, and each row
//     sums over k and c in the same order whatever ROWS is, so the outputs
//     are bitwise the same for every ROWS. Two variants, chosen by the
//     wrapper from H alone (resident for H <= RES_MAX_H):
//
//     resident (gru_bwd_rec_resident_kernel<ROWS>): the block copies
//     W_hh[s] [H, 3H] into shared memory once, rows padded to 3H + 4
//     floats. The forward product hp = h_prev W reads column j (thread j
//     reads W[k][j], W[k][H+j], W[k][2H+j]: neighbouring words, no bank
//     conflict); the transposed product dhp W^T reads row j as float4
//     (the row stride is 4 mod 32 words, so the 8 threads of a quarter
//     warp fall on disjoint banks). One copy serves both products. The
//     wrapper picks ROWS in {1, 2, 4, 8} so that the grid is one wave of
//     blocks (one block fits an SM): 128 blocks at B = 128, S = 2.
//     xp[t], dy[t] and h_prev = out[t -/+ 1] do not depend on the carried
//     dh, so the next step's are loaded into registers while this step
//     computes. h_prev and dhp live in double-buffered shared memory,
//     which leaves ONE barrier a step: it publishes this step's dhp (read
//     by every thread's transposed product) and the next step's h_prev
//     (read by every thread's hp product). A buffer is rewritten only two
//     steps after it was read, and every reader has passed the barrier
//     between.
//
//     streaming (gru_bwd_rec_kernel): for H > RES_MAX_H, where W_hh[s]
//     does not fit in shared memory, ROWS = 8 and each step streams W_hh
//     from L2 through __ldg for both products (row j of W as float4 for
//     the transposed one), with h_prev and dhp staged in shared memory and
//     three barriers a step.
//
// (b) gru_bwd_dw_kernel + gru_bwd_reduce_kernel: the TPU accumulates
//     dW_hh and db_hh in output blocks that stay resident across its
//     *serial* grid. CUDA blocks run at the same time, so (b) reduces
//     without float atomics, in a fixed order: the B*T rows are cut into
//     NSPLIT contiguous ranges; each block owns one (direction, range,
//     64 x 64 tile of dW) and sums its rows in order, 16 at a time, into a
//     partial, loading the next 16 rows while it sums these; the reduce
//     kernel then adds the NSPLIT partials in split order. NSPLIT is a
//     function of the shapes alone, so two runs give the same bits.
//
// Bound on an H100 SXM (67 TFLOP/s f32 without tensor cores, 3.35 TB/s):
// at the train shape B = 128, T = 90, H = 128, S = 2 the three step
// products (hp, dhp W^T, h_prev^T dhp) are 3 * 2*T*S*B*H*3H = 6.79 GFLOP
// (0.101 ms), against about 100 MB of xp, out, dy and dxp (0.03 ms), so
// operations bound it, before the serial dependence over 90 steps is
// counted. In (a) that dependence rules: only S * ceil(B/ROWS) blocks can
// work, one per SM, and each step's products wait on the previous step's
// dh. With W resident, a step of the resident variant is set by the SM's
// shared-memory bandwidth (128 B a clock): the 128 threads read all of W
// once for each product (384 conflict-free 4-byte and 96 16-byte reads a
// thread, 3 K clocks) plus the broadcast reads of h_prev and dhp, about
// 4 K clocks, some 0.2 ms over 90 steps before the barrier's cost. On an
// H100 SXM at 700 W (a) takes 0.42 ms there, about twice that: with one
// warp per scheduler little of the shared-memory latency is hidden (four
// partial sums a row in the transposed product, which shorten its FMA
// chains, were no faster). (b) takes 0.14 ms. No tensor cores: TF32 would
// not hold the 1e-4 tolerance against the f32 loop.
//
// f32 throughout, expf/tanhf, no fast math.

#include <cuda_runtime.h>

namespace {

constexpr int STREAM_ROWS = 8;   // batch rows per block, streaming variant
constexpr int MAX_THREADS = 512; // hidden sizes up to 512
constexpr int RES_MAX_H = 128;   // widest hidden size of the resident variant
constexpr int W_PAD = 4;         // floats of padding after each resident W row
constexpr int TK = 64;           // dW tile rows (hidden unit k) in (b)
constexpr int TC = 64;           // dW tile columns (gate column c) in (b)
constexpr int TN = 16;           // rows of B*T staged per pass in (b)
constexpr int DW_THREADS = 256;  // (TK / 4) * (TC / 4)

__device__ __forceinline__ float sigmoid_f32(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// dh <- dh z + dhp W^T, rounded after the product and after the sum as the
// plain loop rounds it (no fused multiply-add)
__device__ __forceinline__ float carry(float dhr, float zg, float dhp_wt) {
  return __fadd_rn(__fmul_rn(dhr, zg), dhp_wt);
}

// Bytes of dynamic shared memory of the resident variant: W_hh[s] with
// padded rows, and double-buffered h_prev [ROWS][H] and dhp [ROWS][3H].
// fused_gru.py::bwd_plan mirrors this formula.
constexpr size_t resident_smem_bytes(int H, int rows) {
  return sizeof(float) * ((size_t)H * (3 * H + W_PAD) + 2 * (size_t)rows * 4 * H);
}

// The per-row gate arithmetic of one step, shared by both variants. In:
// x_r, x_z, x_n, the products a_r, a_z, a_n of h_prev with W's three
// column blocks (biases not yet added), h_prev, and dhr = dh + dy. Out:
// dr, dz, dn (dxp), dnr = dn r (dhp's third block) and z.
__device__ __forceinline__ void gate_grads(float xr, float xz, float xn, float ar,
                                           float az, float an, float br, float bz,
                                           float bn, float hprev, float dhr,
                                           float& dr, float& dz, float& dn,
                                           float& dnr, float& zg) {
  const float rg = sigmoid_f32(xr + (ar + br));
  zg = sigmoid_f32(xz + (az + bz));
  const float hpn = an + bn;
  const float ng = tanhf(xn + rg * hpn);
  dz = dhr * (hprev - ng) * zg * (1.f - zg);
  dn = dhr * (1.f - zg) * (1.f - ng * ng);
  dr = dn * hpn * rg * (1.f - rg);
  dnr = dn * rg;
}

template <int ROWS>
__global__ void __launch_bounds__(RES_MAX_H, 1)
gru_bwd_rec_resident_kernel(const float* __restrict__ xp,    // [B, T, S*3H]
                            const float* __restrict__ out,   // [B, T, S*H]
                            const float* __restrict__ dy,    // [B, T, S*H]
                            const float* __restrict__ w_hh,  // [S, H, 3H]
                            const float* __restrict__ b_hh,  // [S, 3H]
                            float* __restrict__ dxp,         // [B, T, S*3H]
                            float* __restrict__ dhp,         // [B, T, S*3H]
                            int B, int T, int H, int S) {
  extern __shared__ float4 smem[];
  const int H3 = 3 * H;
  const int WS = H3 + W_PAD;                     // row stride of w_s
  float* w_s = reinterpret_cast<float*>(smem);   // [H][WS] W_hh[s]
  float* h_s = w_s + (size_t)H * WS;             // [2][ROWS][H] h_prev
  float* d_s = h_s + 2 * ROWS * H;               // [2][ROWS][3H] dhp

  const int s = blockIdx.y;
  const int row0 = blockIdx.x * ROWS;
  const int j = threadIdx.x;
  const bool active = j < H;
  const bool walks_up = (s == 1);  // direction 1 walks t upwards
  const size_t x_row = (size_t)T * S * H3;  // xp / dxp / dhp stride of a row
  const size_t o_row = (size_t)T * S * H;   // out / dy stride of a row

  // W_hh[s] into shared memory, once per launch
  {
    const float4* wg = reinterpret_cast<const float4*>(w_hh + (size_t)s * H * H3);
    const int q3 = H3 / 4;
    for (int e = threadIdx.x; e < H * q3; e += blockDim.x) {
      const int k = e / q3;
      *reinterpret_cast<float4*>(w_s + (size_t)k * WS + 4 * (e - k * q3)) = __ldg(wg + e);
    }
  }

  float br = 0.f, bz = 0.f, bn = 0.f;
  if (active) {
    br = b_hh[s * H3 + j];
    bz = b_hh[s * H3 + H + j];
    bn = b_hh[s * H3 + 2 * H + j];
  }

  // a step's inputs for this thread's unit: x_r, x_z, x_n, dy, h_prev
  auto load = [&](int step, float (&xr)[ROWS], float (&xz)[ROWS], float (&xn)[ROWS],
                  float (&g)[ROWS], float (&hv)[ROWS]) {
    const int t = walks_up ? step : T - 1 - step;
    const int tp = walks_up ? t + 1 : t - 1;
    const bool has_prev = tp >= 0 && tp < T;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      xr[r] = xz[r] = xn[r] = g[r] = hv[r] = 0.f;
      if (active && row0 + r < B) {
        const float* x = xp + (row0 + r) * x_row + (size_t)t * S * H3 + s * H3;
        xr[r] = x[j];
        xz[r] = x[H + j];
        xn[r] = x[2 * H + j];
        const size_t o = (row0 + r) * o_row + s * H + j;
        g[r] = dy[o + (size_t)t * S * H];
        if (has_prev) hv[r] = out[o + (size_t)tp * S * H];
      }
    }
  };

  float dh[ROWS];
  float cxr[ROWS], cxz[ROWS], cxn[ROWS], cg[ROWS], ch[ROWS];  // this step's
  float nxr[ROWS], nxz[ROWS], nxn[ROWS], ng[ROWS], nh[ROWS];  // the next step's
  load(0, cxr, cxz, cxn, cg, ch);
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    dh[r] = 0.f;
    if (active) h_s[r * H + j] = ch[r];
  }
  __syncthreads();  // w_s and the first h_prev

  for (int step = 0; step < T; ++step) {
    const int cur = step & 1;
    const float* hc = h_s + cur * ROWS * H;
    float* dc = d_s + cur * ROWS * H3;
    const int t = walks_up ? step : T - 1 - step;
    // the next step's inputs are in flight while this step computes
    if (step + 1 < T) load(step + 1, nxr, nxz, nxn, ng, nh);

    float dhr[ROWS], zg[ROWS];
    if (active) {
      float ar[ROWS], az[ROWS], an[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) ar[r] = az[r] = an[r] = 0.f;
#pragma unroll 2
      for (int k = 0; k < H; k += 4) {
        float wr[4], wz[4], wn[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float* wk = w_s + (k + q) * WS;
          wr[q] = wk[j];
          wz[q] = wk[H + j];
          wn[q] = wk[2 * H + j];
        }
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const float4 h4 = *reinterpret_cast<const float4*>(hc + r * H + k);
          ar[r] = fmaf(h4.x, wr[0], ar[r]);
          az[r] = fmaf(h4.x, wz[0], az[r]);
          an[r] = fmaf(h4.x, wn[0], an[r]);
          ar[r] = fmaf(h4.y, wr[1], ar[r]);
          az[r] = fmaf(h4.y, wz[1], az[r]);
          an[r] = fmaf(h4.y, wn[1], an[r]);
          ar[r] = fmaf(h4.z, wr[2], ar[r]);
          az[r] = fmaf(h4.z, wz[2], az[r]);
          an[r] = fmaf(h4.z, wn[2], an[r]);
          ar[r] = fmaf(h4.w, wr[3], ar[r]);
          az[r] = fmaf(h4.w, wz[3], az[r]);
          an[r] = fmaf(h4.w, wn[3], an[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        float dr, dz, dn, dnr;
        dhr[r] = dh[r] + cg[r];
        gate_grads(cxr[r], cxz[r], cxn[r], ar[r], az[r], an[r], br, bz, bn, ch[r], dhr[r],
                   dr, dz, dn, dnr, zg[r]);
        dc[r * H3 + j] = dr;
        dc[r * H3 + H + j] = dz;
        dc[r * H3 + 2 * H + j] = dnr;
        if (row0 + r < B) {
          const size_t o = (row0 + r) * x_row + (size_t)t * S * H3 + s * H3;
          dxp[o + j] = dr;
          dxp[o + H + j] = dz;
          dxp[o + 2 * H + j] = dn;
          dhp[o + j] = dr;
          dhp[o + H + j] = dz;
          dhp[o + 2 * H + j] = dnr;
        }
      }
      if (step + 1 < T) {
        float* hn = h_s + (cur ^ 1) * ROWS * H;
#pragma unroll
        for (int r = 0; r < ROWS; ++r) hn[r * H + j] = nh[r];
      }
    }
    // the step's one barrier: dhp of this step and h_prev of the next are
    // complete. The buffers written before it were last read two steps
    // ago, before the previous barrier.
    __syncthreads();

    if (active) {
      float acc[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) acc[r] = 0.f;
      const float* wj = w_s + j * WS;  // row j of W: W^T's column j
#pragma unroll 4
      for (int c = 0; c < H3; c += 4) {
        const float4 w4 = *reinterpret_cast<const float4*>(wj + c);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const float4 d4 = *reinterpret_cast<const float4*>(dc + r * H3 + c);
          acc[r] = fmaf(d4.x, w4.x, acc[r]);
          acc[r] = fmaf(d4.y, w4.y, acc[r]);
          acc[r] = fmaf(d4.z, w4.z, acc[r]);
          acc[r] = fmaf(d4.w, w4.w, acc[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        dh[r] = carry(dhr[r], zg[r], acc[r]);
        cxr[r] = nxr[r];
        cxz[r] = nxz[r];
        cxn[r] = nxn[r];
        cg[r] = ng[r];
        ch[r] = nh[r];
      }
    }
  }
}

__global__ void __launch_bounds__(MAX_THREADS)
gru_bwd_rec_kernel(const float* __restrict__ xp,    // [B, T, S*3H]
                   const float* __restrict__ out,   // [B, T, S*H]
                   const float* __restrict__ dy,    // [B, T, S*H]
                   const float* __restrict__ w_hh,  // [S, H, 3H]
                   const float* __restrict__ b_hh,  // [S, 3H]
                   float* __restrict__ dxp,         // [B, T, S*3H]
                   float* __restrict__ dhp,         // [B, T, S*3H]
                   int B, int T, int H, int S) {
  constexpr int ROWS = STREAM_ROWS;
  extern __shared__ float4 smem[];
  const int H3 = 3 * H;
  float* h_s = reinterpret_cast<float*>(smem);  // [ROWS][H] h_prev
  float* d_s = h_s + ROWS * H;                   // [ROWS][3H] dhp

  const int s = blockIdx.y;
  const int row0 = blockIdx.x * ROWS;
  const int j = threadIdx.x;
  const bool active = j < H;
  const bool walks_up = (s == 1);  // direction 1 walks t upwards
  const float* W = w_hh + (size_t)s * H * H3;
  const size_t x_row = (size_t)T * S * H3;  // xp / dxp / dhp stride of a row
  const size_t o_row = (size_t)T * S * H;   // out / dy stride of a row

  float br = 0.f, bz = 0.f, bn = 0.f;
  if (active) {
    br = b_hh[s * H3 + j];
    bz = b_hh[s * H3 + H + j];
    bn = b_hh[s * H3 + 2 * H + j];
  }
  float dh[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) dh[r] = 0.f;

  for (int step = 0; step < T; ++step) {
    const int t = walks_up ? step : T - 1 - step;
    const int tp = walks_up ? t + 1 : t - 1;
    const bool has_prev = tp >= 0 && tp < T;

    // stage h_prev of the tile
    if (active) {
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        float v = 0.f;
        if (has_prev && row0 + r < B) {
          v = out[(row0 + r) * o_row + (size_t)tp * S * H + s * H + j];
        }
        h_s[r * H + j] = v;
      }
    }
    __syncthreads();

    float dhr[ROWS], zg[ROWS];
    if (active) {
      float xr[ROWS], xz[ROWS], xn[ROWS], g[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        xr[r] = xz[r] = xn[r] = g[r] = 0.f;
        if (row0 + r < B) {
          const float* x = xp + (row0 + r) * x_row + (size_t)t * S * H3 + s * H3;
          xr[r] = x[j];
          xz[r] = x[H + j];
          xn[r] = x[2 * H + j];
          g[r] = dy[(row0 + r) * o_row + (size_t)t * S * H + s * H + j];
        }
      }
      float ar[ROWS], az[ROWS], an[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) ar[r] = az[r] = an[r] = 0.f;
      for (int k = 0; k < H; k += 4) {
        float wr[4], wz[4], wn[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float* wk = W + (size_t)(k + q) * H3;
          wr[q] = __ldg(wk + j);
          wz[q] = __ldg(wk + H + j);
          wn[q] = __ldg(wk + 2 * H + j);
        }
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const float4 h4 = *reinterpret_cast<const float4*>(h_s + r * H + k);
          ar[r] = fmaf(h4.x, wr[0], ar[r]);
          az[r] = fmaf(h4.x, wz[0], az[r]);
          an[r] = fmaf(h4.x, wn[0], an[r]);
          ar[r] = fmaf(h4.y, wr[1], ar[r]);
          az[r] = fmaf(h4.y, wz[1], az[r]);
          an[r] = fmaf(h4.y, wn[1], an[r]);
          ar[r] = fmaf(h4.z, wr[2], ar[r]);
          az[r] = fmaf(h4.z, wz[2], az[r]);
          an[r] = fmaf(h4.z, wn[2], an[r]);
          ar[r] = fmaf(h4.w, wr[3], ar[r]);
          az[r] = fmaf(h4.w, wz[3], az[r]);
          an[r] = fmaf(h4.w, wn[3], an[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        float dr, dz, dn, dnr;
        dhr[r] = dh[r] + g[r];
        gate_grads(xr[r], xz[r], xn[r], ar[r], az[r], an[r], br, bz, bn, h_s[r * H + j],
                   dhr[r], dr, dz, dn, dnr, zg[r]);
        d_s[r * H3 + j] = dr;
        d_s[r * H3 + H + j] = dz;
        d_s[r * H3 + 2 * H + j] = dnr;
        if (row0 + r < B) {
          const size_t o = (row0 + r) * x_row + (size_t)t * S * H3 + s * H3;
          dxp[o + j] = dr;
          dxp[o + H + j] = dz;
          dxp[o + 2 * H + j] = dn;
          dhp[o + j] = dr;
          dhp[o + H + j] = dz;
          dhp[o + 2 * H + j] = dnr;
        }
      }
    }
    __syncthreads();  // d_s complete

    if (active) {
      float acc[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) acc[r] = 0.f;
      const float* wj = W + (size_t)j * H3;  // row j of W: W^T's column j
      for (int c = 0; c < H3; c += 4) {
        const float4 w4 = __ldg(reinterpret_cast<const float4*>(wj + c));
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const float4 d4 = *reinterpret_cast<const float4*>(d_s + r * H3 + c);
          acc[r] = fmaf(d4.x, w4.x, acc[r]);
          acc[r] = fmaf(d4.y, w4.y, acc[r]);
          acc[r] = fmaf(d4.z, w4.z, acc[r]);
          acc[r] = fmaf(d4.w, w4.w, acc[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) dh[r] = carry(dhr[r], zg[r], acc[r]);
    }
    __syncthreads();  // every read of h_s and d_s is done before the next step
  }
}

// h_prev of row n = b*T + t of direction s (zero at the direction's start)
__device__ __forceinline__ float h_prev_at(const float* __restrict__ out, int n,
                                           int k, int s, int T, int H, int S) {
  const int b = n / T;
  const int t = n - b * T;
  const int tp = (s == 1) ? t + 1 : t - 1;
  if (tp < 0 || tp >= T) return 0.f;
  return out[((size_t)b * T + tp) * S * H + s * H + k];
}

// One block: direction s = blockIdx.z % S, split p = blockIdx.z / S, and the
// dW tile (k0, c0). Sums rows [n0, n1) of h_prev^T dhp in order into
// part_w[p, s]; the k-tile-0 blocks also sum dhp's columns into part_b[p, s].
__global__ void __launch_bounds__(DW_THREADS)
gru_bwd_dw_kernel(const float* __restrict__ out,  // [B, T, S*H]
                  const float* __restrict__ dhp,  // [B, T, S*3H]
                  float* __restrict__ part_w,     // [NSPLIT, S, H, 3H]
                  float* __restrict__ part_b,     // [NSPLIT, S, 3H]
                  int B, int T, int H, int S, int nsplit) {
  __shared__ __align__(16) float hs[TN][TK];
  __shared__ __align__(16) float ds[TN][TC];
  const int H3 = 3 * H;
  const int s = blockIdx.z % S;
  const int p = blockIdx.z / S;
  const int k0 = blockIdx.y * TK;
  const int c0 = blockIdx.x * TC;
  const int N = B * T;
  const int per = (N + nsplit - 1) / nsplit;
  const int n0 = p * per;
  const int n1 = min(N, n0 + per);
  const int tid = threadIdx.x;
  const int tx = tid % (TC / 4);  // 4 columns each
  const int ty = tid / (TC / 4);  // 4 rows each
  const bool bias_block = blockIdx.y == 0;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[i][q] = 0.f;
  float bsum = 0.f;

  // a pass stages TN rows of h_prev (TK columns) and of dhp (TC columns);
  // each thread loads PER values of each into registers, the next pass's
  // while this one computes
  static_assert(TK == TC, "one index serves both staged tiles");
  constexpr int PER = TN * TK / DW_THREADS;
  float hv[PER], dv[PER];
  auto stage = [&](int nb) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int e = tid + i * DW_THREADS;
      const int nn = e / TK, kk = e % TK;
      const int n = nb + nn;
      hv[i] = (n < n1 && k0 + kk < H) ? h_prev_at(out, n, k0 + kk, s, T, H, S) : 0.f;
      dv[i] = (n < n1 && c0 + kk < H3) ? dhp[(size_t)n * S * H3 + s * H3 + c0 + kk] : 0.f;
    }
  };
  if (n0 < n1) stage(n0);
  for (int nb = n0; nb < n1; nb += TN) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int e = tid + i * DW_THREADS;
      hs[e / TK][e % TK] = hv[i];
      ds[e / TC][e % TC] = dv[i];
    }
    __syncthreads();
    if (nb + TN < n1) stage(nb + TN);  // in flight while this pass computes
    // the pass's TN rows are summed on their own, then added to the running
    // sums: a blocked sum, whose rounding error grows with TN + rows / TN
    // instead of with the rows of the split
    float pass[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) pass[i][q] = 0.f;
#pragma unroll
    for (int nn = 0; nn < TN; ++nn) {
      const float4 a4 = *reinterpret_cast<const float4*>(&hs[nn][ty * 4]);
      const float4 b4 = *reinterpret_cast<const float4*>(&ds[nn][tx * 4]);
      const float a[4] = {a4.x, a4.y, a4.z, a4.w};
      const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) pass[i][q] = fmaf(a[i], b[q], pass[i][q]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][q] += pass[i][q];
    if (bias_block && tid < TC) {
      float pb = 0.f;
      for (int nn = 0; nn < TN; ++nn) pb += ds[nn][tid];
      bsum += pb;
    }
    __syncthreads();
  }

  float* pw = part_w + ((size_t)p * S + s) * H * H3;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + ty * 4 + i;
    if (k >= H) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = c0 + tx * 4 + q;
      if (c < H3) pw[(size_t)k * H3 + c] = acc[i][q];
    }
  }
  if (bias_block && tid < TC && c0 + tid < H3) {
    part_b[((size_t)p * S + s) * H3 + c0 + tid] = bsum;
  }
}

// dW = sum over splits of part_w, db likewise, in split order.
__global__ void gru_bwd_reduce_kernel(const float* __restrict__ part_w,
                                      const float* __restrict__ part_b,
                                      float* __restrict__ dw,
                                      float* __restrict__ db,
                                      int n_w, int n_b, int nsplit) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n_w) {
    float v = 0.f;
    for (int p = 0; p < nsplit; ++p) v += part_w[(size_t)p * n_w + i];
    dw[i] = v;
  }
  if (i < n_b) {
    float v = 0.f;
    for (int p = 0; p < nsplit; ++p) v += part_b[(size_t)p * n_b + i];
    db[i] = v;
  }
}

// Sets the kernel's dynamic shared-memory limit when it needs more than
// the default 48 KB, then launches it; returns the first CUDA error.
template <typename Kernel>
cudaError_t launch_rec(Kernel kernel, dim3 grid, int threads, size_t smem,
                       cudaStream_t st, const float* xp, const float* out,
                       const float* dy, const float* w_hh, const float* b_hh,
                       float* dxp, float* dhp, int B, int T, int H, int S) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, threads, smem, st>>>(xp, out, dy, w_hh, b_hh, dxp, dhp, B, T, H, S);
  return cudaGetLastError();
}

template <int ROWS>
cudaError_t launch_resident(cudaStream_t st, const float* xp, const float* out,
                            const float* dy, const float* w_hh, const float* b_hh,
                            float* dxp, float* dhp, int B, int T, int H, int S) {
  return launch_rec(gru_bwd_rec_resident_kernel<ROWS>, dim3((B + ROWS - 1) / ROWS, S),
                    ((H + 31) / 32) * 32, resident_smem_bytes(H, ROWS), st, xp, out, dy,
                    w_hh, b_hh, dxp, dhp, B, T, H, S);
}

}  // namespace

extern "C" {

// Launches the recurrence (the resident variant when `resident` is
// non-zero, with `rows` in {1, 2, 4, 8} batch rows a block; else the
// streaming one, which takes rows == 8), then the weight-gradient pass,
// on `stream`; returns the first CUDA error as an int (0 = launched).
// Shapes are checked by the Python wrapper: S in {1, 2}, H a multiple of
// 4 and at most MAX_THREADS (RES_MAX_H for the resident variant), B and T
// positive, nsplit >= 1, every tensor contiguous float32, w_hh 16-byte
// aligned.
int roko_gru_bwd(const float* xp, const float* out, const float* dy,
                 const float* w_hh, const float* b_hh,
                 float* dxp, float* dhp, float* part_w, float* part_b,
                 float* dw, float* db, int B, int T, int H, int S, int nsplit,
                 int rows, int resident, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
  if (resident) {
    if (H > RES_MAX_H) return static_cast<int>(cudaErrorInvalidValue);
    switch (rows) {
      case 1: e = launch_resident<1>(st, xp, out, dy, w_hh, b_hh, dxp, dhp, B, T, H, S); break;
      case 2: e = launch_resident<2>(st, xp, out, dy, w_hh, b_hh, dxp, dhp, B, T, H, S); break;
      case 4: e = launch_resident<4>(st, xp, out, dy, w_hh, b_hh, dxp, dhp, B, T, H, S); break;
      case 8: e = launch_resident<8>(st, xp, out, dy, w_hh, b_hh, dxp, dhp, B, T, H, S); break;
      default: break;
    }
  } else if (rows == STREAM_ROWS) {
    e = launch_rec(gru_bwd_rec_kernel, dim3((B + STREAM_ROWS - 1) / STREAM_ROWS, S),
                   ((H + 31) / 32) * 32, (size_t)STREAM_ROWS * 4 * H * sizeof(float), st,
                   xp, out, dy, w_hh, b_hh, dxp, dhp, B, T, H, S);
  }
  if (e != cudaSuccess) return static_cast<int>(e);

  const dim3 grid((3 * H + TC - 1) / TC, (H + TK - 1) / TK, S * nsplit);
  gru_bwd_dw_kernel<<<grid, DW_THREADS, 0, st>>>(out, dhp, part_w, part_b, B,
                                                 T, H, S, nsplit);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  const int n_w = S * H * 3 * H;
  const int n_b = S * 3 * H;
  gru_bwd_reduce_kernel<<<(n_w + 255) / 256, 256, 0, st>>>(part_w, part_b, dw,
                                                           db, n_w, n_b, nsplit);
  return static_cast<int>(cudaGetLastError());
}

const char* roko_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
