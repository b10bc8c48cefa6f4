// GRU recurrence forward for one bidirectional layer, CUDA C++ for sm_90a.
//
// Replaces the TPU kernels roko_tpu/models/pallas_gru.py::_fwd_kernel_v3
// (time-only grid) and ::_fwd_kernel (batch-blocked v2 grid). Both compute,
// per direction s and step t, from h_0 = 0:
//
//   hp = h W_hh[s] + b_hh[s]                 (f32 accumulate)
//   r  = sigmoid(x_r + hp_r)
//   z  = sigmoid(x_z + hp_z)
//   n  = tanh(x_n + r * hp_n)                (hidden bias inside the reset product)
//   h' = (1 - z) n + z h
//
// where x = xp[b, t, s*3H : (s+1)*3H] is the hoisted input projection. The
// backward direction (s = 1) walks t = T-1 .. 0 by index.
//
// Design. The TPU walks its grid in order and carries h across grid steps
// in VMEM scratch. CUDA blocks run in no order, so each block here owns one
// (direction, tile of batch rows) and runs the whole time loop itself, with
// the tile's h in shared memory as f32, double-buffered, so one
// __syncthreads a step. Blocks never need each other's state. A thread owns
// hidden unit j for its rows and keeps three accumulators a row for the
// r/z/n columns j, H+j, 2H+j, summed over k = 0 .. H-1 in that order with
// fmaf, the bias added as x + (acc + b); the gate update rounds every
// product and sum on its own, as the plain loop does. Rows never interact,
// so the output does not depend on how rows are cut into blocks. Rows
// beyond B are masked, not padded. The layout is the natural one from the
// input GEMM: xp [B, T, S*3H] in, out [B, T, S*H] (= fwd ++ bwd on the
// feature axis). Two variants, chosen by the wrapper from H alone
// (resident for H <= RES_MAX_H):
//
//   resident (gru_fwd_resident_kernel): the block copies W_hh[s] [H, 3H]
//   into dynamic shared memory once, rows padded to 3H + 4 floats (thread
//   j reads W[k][j], W[k][H+j], W[k][2H+j]: neighbouring words, no bank
//   conflict), so no step reads W from L2. The wrapper picks the rows a
//   block, 1, 2, 4 or 8, as the fewest that keep the grid one wave of
//   blocks (one block fills an SM's shared memory): 128 blocks at B = 512
//   (8 rows) and at B = 128 (2 rows), S = 2, where 8 rows a block left 100
//   of 132 SMs idle at B = 128. A step's time is set by latency: with one
//   warp a scheduler, a step cost about 1.3 us plus 0.56 us a row, the
//   per-row part 2.4x the row's FMA instructions. So from 4 rows up the
//   block runs two thread groups of half the rows each, two warps a
//   scheduler, sharing the one copy of W (15 % faster at 8 rows; below 4
//   rows the second reading of W costs more than it hides). The next
//   step's xp does not depend on h, so it is loaded into registers while a
//   step computes.
//
//   streaming (gru_fwd_kernel): for H > RES_MAX_H, where W_hh[s] does not
//   fit in shared memory, 8 rows a block, and each step reads W_hh through
//   __ldg from L2.
//
// Bound on an H100 SXM (67 TFLOP/s f32 without tensor cores, 3.35 TB/s):
// per layer at T = 90, H = 128, S = 2 the step products are
// 2*T*(S*B)*H*3H: 9.06 GFLOP (0.135 ms) at B = 512 and 2.26 GFLOP
// (0.034 ms) at B = 128, against 189 MB and 47 MB of xp and out (0.056 and
// 0.014 ms), so operations bound it, before the serial dependence over the
// 90 steps is counted.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py --fwd-only,
// PERF.md section 6): 0.45-0.46 ms at B = 512 and 0.22 ms at B = 128,
// where 8 rows a block with W read from L2 took 1.09-1.11 ms at both;
// cuDNN's forward of the same layer, input product included, 1.77-1.81
// and 0.48-0.49 ms.
//
// f32 throughout, expf/tanhf, no fast math. No tensor cores: TF32 would
// not hold the 1e-4 tolerance against the f32 loop.

#include <cuda_runtime.h>

namespace {

constexpr int STREAM_ROWS = 8;   // batch rows per block, streaming variant
constexpr int MAX_THREADS = 512; // hidden sizes up to 512
constexpr int RES_MAX_H = 128;   // widest hidden size of the resident variant
constexpr int W_PAD = 4;         // floats of padding after each resident W row

// Bytes of dynamic shared memory of the resident variant: W_hh[s] with
// padded rows and the double-buffered h [2][rows][H] of the block's rows.
// fused_gru.py::fwd_plan mirrors this formula.
constexpr size_t resident_smem_bytes(int H, int rows) {
  return sizeof(float) * ((size_t)H * (3 * H + W_PAD) + 2 * (size_t)rows * H);
}

// Thread groups of a resident block with `rows` batch rows: two from 4
// rows up, each taking half the rows, so that two warps a scheduler hide
// each other's latency; one below, where reading W twice would cost more.
// fused_gru.py::fwd_plan mirrors this rule.
constexpr int resident_groups(int rows) { return rows >= 4 ? 2 : 1; }

__device__ __forceinline__ float sigmoid_f32(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// A block of GROUPS thread groups of ROWS batch rows each; all groups
// share the block's one copy of W_hh[s].
template <int ROWS, int GROUPS>
__global__ void __launch_bounds__(GROUPS * RES_MAX_H, 1)
gru_fwd_resident_kernel(const float* __restrict__ xp,    // [B, T, S*3H]
                        const float* __restrict__ w_hh,  // [S, H, 3H]
                        const float* __restrict__ b_hh,  // [S, 3H]
                        float* __restrict__ out,         // [B, T, S*H]
                        int B, int T, int H, int S) {
  extern __shared__ float4 smem[];
  const int H3 = 3 * H;
  const int WS = H3 + W_PAD;                     // row stride of w_s
  constexpr int BLOCK_ROWS = GROUPS * ROWS;
  float* w_s = reinterpret_cast<float*>(smem);   // [H][WS] W_hh[s]
  float* h_all = w_s + (size_t)H * WS;           // [2][BLOCK_ROWS][H] h
  const int group_threads = blockDim.x / GROUPS;
  const int g = threadIdx.x / group_threads;
  float* h_s = h_all + g * ROWS * H;             // group g's rows of h

  const int s = blockIdx.y;
  const int row0 = blockIdx.x * BLOCK_ROWS + g * ROWS;
  const int j = threadIdx.x - g * group_threads;
  const bool active = j < H;
  const bool reverse = (s == 1);
  const size_t x_row = (size_t)T * S * H3;  // xp stride of one batch row
  const size_t o_row = (size_t)T * S * H;   // out stride of one batch row

  // W_hh[s] into shared memory, once per launch
  {
    const float4* wg = reinterpret_cast<const float4*>(w_hh + (size_t)s * H * H3);
    const int q3 = H3 / 4;
    for (int e = threadIdx.x; e < H * q3; e += blockDim.x) {
      const int k = e / q3;
      *reinterpret_cast<float4*>(w_s + (size_t)k * WS + 4 * (e - k * q3)) = __ldg(wg + e);
    }
  }
  for (int i = threadIdx.x; i < BLOCK_ROWS * H; i += blockDim.x) h_all[i] = 0.f;

  float br = 0.f, bz = 0.f, bn = 0.f;
  if (active) {
    br = b_hh[s * H3 + j];
    bz = b_hh[s * H3 + H + j];
    bn = b_hh[s * H3 + 2 * H + j];
  }

  // a step's input projections for this thread's unit
  auto load = [&](int step, float (&xr)[ROWS], float (&xz)[ROWS], float (&xn)[ROWS]) {
    const int t = reverse ? T - 1 - step : step;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      xr[r] = xz[r] = xn[r] = 0.f;
      if (active && row0 + r < B) {
        const float* x = xp + (row0 + r) * x_row + (size_t)t * S * H3 + s * H3;
        xr[r] = x[j];
        xz[r] = x[H + j];
        xn[r] = x[2 * H + j];
      }
    }
  };

  float h[ROWS];                                  // this thread's unit of h
  float cxr[ROWS], cxz[ROWS], cxn[ROWS];          // this step's inputs
  float nxr[ROWS], nxz[ROWS], nxn[ROWS];          // the next step's
  load(0, cxr, cxz, cxn);
#pragma unroll
  for (int r = 0; r < ROWS; ++r) h[r] = 0.f;
  __syncthreads();  // w_s and h_0

  for (int step = 0; step < T; ++step) {
    const int cur = step & 1;
    const float* hc = h_s + cur * BLOCK_ROWS * H;
    float* hn = h_s + (cur ^ 1) * BLOCK_ROWS * H;
    const int t = reverse ? T - 1 - step : step;
    // the next step's inputs are in flight while this step computes
    if (step + 1 < T) load(step + 1, nxr, nxz, nxn);

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
        const float rg = sigmoid_f32(cxr[r] + (ar[r] + br));
        const float zg = sigmoid_f32(cxz[r] + (az[r] + bz));
        // every product and sum rounded on its own, as the plain loop
        // rounds them: a fused multiply-add the compiler chose per
        // instantiation would make the bits depend on ROWS
        const float ng = tanhf(__fadd_rn(cxn[r], __fmul_rn(rg, an[r] + bn)));
        h[r] = __fadd_rn(__fmul_rn(1.f - zg, ng), __fmul_rn(zg, h[r]));
        hn[r * H + j] = h[r];
        if (row0 + r < B) {
          out[(row0 + r) * o_row + (size_t)t * S * H + s * H + j] = h[r];
        }
      }
    }
    // the step's one barrier: the next h is complete, and every read of
    // this step's h is done before a thread of the next step rewrites it
    __syncthreads();
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      cxr[r] = nxr[r];
      cxz[r] = nxz[r];
      cxn[r] = nxn[r];
    }
  }
}

__global__ void __launch_bounds__(MAX_THREADS)
gru_fwd_kernel(const float* __restrict__ xp,    // [B, T, S*3H]
               const float* __restrict__ w_hh,  // [S, H, 3H]
               const float* __restrict__ b_hh,  // [S, 3H]
               float* __restrict__ out,         // [B, T, S*H]
               int B, int T, int H, int S) {
  constexpr int ROWS = STREAM_ROWS;
  extern __shared__ float4 smem[];
  float* h_buf = reinterpret_cast<float*>(smem);  // [2][ROWS][H]

  const int s = blockIdx.y;
  const int row0 = blockIdx.x * ROWS;
  const int j = threadIdx.x;
  const bool active = j < H;
  const int H3 = 3 * H;
  const bool reverse = (s == 1);
  const float* W = w_hh + (size_t)s * H * H3;
  const size_t x_row = (size_t)T * S * H3;  // xp stride of one batch row
  const size_t o_row = (size_t)T * S * H;   // out stride of one batch row

  float br = 0.f, bz = 0.f, bn = 0.f;
  if (active) {
    br = b_hh[s * H3 + j];
    bz = b_hh[s * H3 + H + j];
    bn = b_hh[s * H3 + 2 * H + j];
  }
  for (int i = threadIdx.x; i < ROWS * H; i += blockDim.x) h_buf[i] = 0.f;
  __syncthreads();

  int cur = 0;
  for (int step = 0; step < T; ++step) {
    const int t = reverse ? T - 1 - step : step;
    const float* h_cur = h_buf + cur * ROWS * H;
    float* h_next = h_buf + (cur ^ 1) * ROWS * H;
    if (active) {
      // this step's input projections; independent of the matmul below, so
      // their latency overlaps it
      float xr[ROWS], xz[ROWS], xn[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        xr[r] = xz[r] = xn[r] = 0.f;
        if (row0 + r < B) {
          const float* x = xp + (row0 + r) * x_row + (size_t)t * S * H3 + s * H3;
          xr[r] = x[j];
          xz[r] = x[H + j];
          xn[r] = x[2 * H + j];
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
          const float4 h4 = *reinterpret_cast<const float4*>(h_cur + r * H + k);
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
        const float ng = tanhf(xn[r] + rg * (an[r] + bn));
        const float h_new = (1.f - zg) * ng + zg * h_cur[r * H + j];
        h_next[r * H + j] = h_new;
        if (row0 + r < B) {
          out[(row0 + r) * o_row + (size_t)t * S * H + s * H + j] = h_new;
        }
      }
    }
    // h_next is complete and every read of h_cur is done
    __syncthreads();
    cur ^= 1;
  }
}

// Sets the kernel's dynamic shared-memory limit when it needs more than
// the default 48 KB, then launches it; returns the first CUDA error.
template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, int threads, size_t smem, cudaStream_t st,
                   const float* xp, const float* w_hh, const float* b_hh, float* out,
                   int B, int T, int H, int S) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, threads, smem, st>>>(xp, w_hh, b_hh, out, B, T, H, S);
  return cudaGetLastError();
}

template <int ROWS>
cudaError_t launch_resident(cudaStream_t st, const float* xp, const float* w_hh,
                            const float* b_hh, float* out, int B, int T, int H, int S) {
  constexpr int GROUPS = resident_groups(ROWS);
  return launch(gru_fwd_resident_kernel<ROWS / GROUPS, GROUPS>, dim3((B + ROWS - 1) / ROWS, S),
                GROUPS * (((H + 31) / 32) * 32), resident_smem_bytes(H, ROWS), st, xp, w_hh,
                b_hh, out, B, T, H, S);
}

}  // namespace

extern "C" {

// Launches the recurrence on `stream` (the resident variant when `resident`
// is non-zero, with `rows` in {1, 2, 4, 8} batch rows a block; else the
// streaming one, which takes rows == 8); returns the first CUDA error as an
// int (0 = launched). Shapes are checked by the Python wrapper: S in
// {1, 2}, H a multiple of 4 and at most MAX_THREADS (RES_MAX_H for the
// resident variant), B and T positive, every tensor contiguous float32,
// w_hh 16-byte aligned.
int roko_gru_fwd(const float* xp, const float* w_hh, const float* b_hh,
                 float* out, int B, int T, int H, int S, int rows, int resident,
                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
  if (resident) {
    if (H > RES_MAX_H) return static_cast<int>(cudaErrorInvalidValue);
    switch (rows) {
      case 1: e = launch_resident<1>(st, xp, w_hh, b_hh, out, B, T, H, S); break;
      case 2: e = launch_resident<2>(st, xp, w_hh, b_hh, out, B, T, H, S); break;
      case 4: e = launch_resident<4>(st, xp, w_hh, b_hh, out, B, T, H, S); break;
      case 8: e = launch_resident<8>(st, xp, w_hh, b_hh, out, B, T, H, S); break;
      default: break;
    }
  } else if (rows == STREAM_ROWS) {
    e = launch(gru_fwd_kernel, dim3((B + STREAM_ROWS - 1) / STREAM_ROWS, S),
               ((H + 31) / 32) * 32, 2 * STREAM_ROWS * (size_t)H * sizeof(float), st, xp,
               w_hh, b_hh, out, B, T, H, S);
  }
  return static_cast<int>(e);
}

const char* roko_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
