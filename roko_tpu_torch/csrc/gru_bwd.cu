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
// Design. Two kernels, launched back to back on one stream.
//
// (a) gru_bwd_rec_kernel: like gru_fwd, one block per (direction, tile of
//     ROWS batch rows) runs the whole reverse time loop, thread j owning
//     hidden unit j for all ROWS rows. dh stays in registers. Each step
//     stages the tile's h_prev in shared memory, recomputes hp (W_hh read
//     coalesced along j), writes dxp and dhp to global memory and dhp to
//     shared memory, and then forms dhp W_hh^T from a transposed copy
//     W_hh^T [S, 3H, H] that the wrapper makes, so that thread j reads
//     W^T[c][j] coalesced too. Rows past B are masked, never stored.
//
// (b) gru_bwd_dw_kernel + gru_bwd_reduce_kernel: the TPU accumulates
//     dW_hh and db_hh in output blocks that stay resident across its
//     *serial* grid. CUDA blocks run at the same time, so (b) reduces
//     without float atomics, in a fixed order: the B*T rows are cut into
//     NSPLIT contiguous ranges; each block owns one (direction, range,
//     64 x 64 tile of dW) and sums its rows in order into a partial; the
//     reduce kernel then adds the NSPLIT partials in split order. NSPLIT
//     is a function of the shapes alone, so two runs give the same bits.
//
// Bound on an H100 SXM (67 TFLOP/s f32 without tensor cores, 3.35 TB/s):
// at the train shape B = 128, T = 90, H = 128, S = 2 the three step
// products (hp, dhp W^T, h_prev^T dhp) are 3 * 2*T*S*B*H*3H = 6.79 GFLOP
// (0.101 ms), against about 100 MB of xp, out, dy and dxp (0.03 ms), so
// operations bound it, before the serial dependence over 90 steps is
// counted. No tensor cores, TMA or shared-memory-resident weights yet.
//
// f32 throughout, expf/tanhf, no fast math.

#include <cuda_runtime.h>

namespace {

constexpr int ROWS = 8;          // batch rows per block in (a)
constexpr int MAX_THREADS = 512; // hidden sizes up to 512
constexpr int TK = 64;           // dW tile rows (hidden unit k) in (b)
constexpr int TC = 64;           // dW tile columns (gate column c) in (b)
constexpr int TN = 16;           // rows of B*T staged per pass in (b)
constexpr int DW_THREADS = 256;  // (TK / 4) * (TC / 4)

__device__ __forceinline__ float sigmoid_f32(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__global__ void __launch_bounds__(MAX_THREADS)
gru_bwd_rec_kernel(const float* __restrict__ xp,    // [B, T, S*3H]
                   const float* __restrict__ out,   // [B, T, S*H]
                   const float* __restrict__ dy,    // [B, T, S*H]
                   const float* __restrict__ w_hh,  // [S, H, 3H]
                   const float* __restrict__ w_t,   // [S, 3H, H]
                   const float* __restrict__ b_hh,  // [S, 3H]
                   float* __restrict__ dxp,         // [B, T, S*3H]
                   float* __restrict__ dhp,         // [B, T, S*3H]
                   int B, int T, int H, int S) {
  extern __shared__ float4 smem[];
  const int H3 = 3 * H;
  float* h_s = reinterpret_cast<float*>(smem);  // [ROWS][H] h_prev
  float* d_s = h_s + ROWS * H;                   // [ROWS][3H] dhp

  const int s = blockIdx.y;
  const int row0 = blockIdx.x * ROWS;
  const int j = threadIdx.x;
  const bool active = j < H;
  const bool reverse_sweep_up = (s == 1);  // direction 1 walks t upwards
  const float* W = w_hh + (size_t)s * H * H3;
  const float* WT = w_t + (size_t)s * H3 * H;
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
    const int t = reverse_sweep_up ? step : T - 1 - step;
    const int tp = reverse_sweep_up ? t + 1 : t - 1;
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
        const float rg = sigmoid_f32(xr[r] + (ar[r] + br));
        const float zg = sigmoid_f32(xz[r] + (az[r] + bz));
        const float hpn = an[r] + bn;
        const float ng = tanhf(xn[r] + rg * hpn);
        const float hprev = h_s[r * H + j];
        const float dhr = dh[r] + g[r];
        const float dz = dhr * (hprev - ng) * zg * (1.f - zg);
        const float dn = dhr * (1.f - zg) * (1.f - ng * ng);
        const float dr = dn * hpn * rg * (1.f - rg);
        const float dnr = dn * rg;
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
        dh[r] = dhr * zg;
      }
    }
    __syncthreads();  // d_s complete

    if (active) {
      float acc[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) acc[r] = 0.f;
      for (int c = 0; c < H3; c += 4) {
        float w[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) w[q] = __ldg(WT + (size_t)(c + q) * H + j);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const float4 d4 = *reinterpret_cast<const float4*>(d_s + r * H3 + c);
          acc[r] = fmaf(d4.x, w[0], acc[r]);
          acc[r] = fmaf(d4.y, w[1], acc[r]);
          acc[r] = fmaf(d4.z, w[2], acc[r]);
          acc[r] = fmaf(d4.w, w[3], acc[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) dh[r] += acc[r];
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
  __shared__ float hs[TN][TK];
  __shared__ float ds[TN][TC];
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

  for (int nb = n0; nb < n1; nb += TN) {
    for (int e = tid; e < TN * TK; e += DW_THREADS) {
      const int nn = e / TK, kk = e % TK;
      const int n = nb + nn, k = k0 + kk;
      hs[nn][kk] = (n < n1 && k < H) ? h_prev_at(out, n, k, s, T, H, S) : 0.f;
    }
    for (int e = tid; e < TN * TC; e += DW_THREADS) {
      const int nn = e / TC, cc = e % TC;
      const int n = nb + nn, c = c0 + cc;
      ds[nn][cc] = (n < n1 && c < H3) ? dhp[(size_t)n * S * H3 + s * H3 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int nn = 0; nn < TN; ++nn) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = hs[nn][ty * 4 + i];
#pragma unroll
      for (int q = 0; q < 4; ++q) b[q] = ds[nn][tx * 4 + q];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][q] = fmaf(a[i], b[q], acc[i][q]);
    }
    if (bias_block && tid < TC) {
      for (int nn = 0; nn < TN; ++nn) bsum += ds[nn][tid];
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

}  // namespace

extern "C" {

// Launches the three kernels on `stream`; returns the first CUDA error as
// an int (0 = launched). Shapes are checked by the Python wrapper: S in
// {1, 2}, H a multiple of 4 and at most MAX_THREADS, B and T positive,
// nsplit >= 1, every tensor contiguous float32.
int roko_gru_bwd(const float* xp, const float* out, const float* dy,
                 const float* w_hh, const float* w_t, const float* b_hh,
                 float* dxp, float* dhp, float* part_w, float* part_b,
                 float* dw, float* db, int B, int T, int H, int S, int nsplit,
                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = ((H + 31) / 32) * 32;
  const size_t smem = (size_t)ROWS * 4 * H * sizeof(float);  // h_prev + dhp
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        gru_bwd_rec_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  gru_bwd_rec_kernel<<<dim3((B + ROWS - 1) / ROWS, S), threads, smem, st>>>(
      xp, out, dy, w_hh, w_t, b_hh, dxp, dhp, B, T, H, S);
  cudaError_t e = cudaGetLastError();
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
