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
// (direction, tile of ROWS batch rows) and runs the whole time loop itself,
// with the tile's h in shared memory as f32 (double-buffered, so one
// __syncthreads per step). Blocks never need each other's state. Thread j
// owns hidden unit j for all ROWS rows and keeps 3*ROWS accumulators for the
// r/z/n columns j, H+j, 2H+j. W_hh is read coalesced from global memory and
// stays cache-resident (192 KiB f32 per direction at H = 128). Rows beyond B
// are masked, not padded. The layout is the natural one from the input GEMM:
// xp [B, T, S*3H] in, out [B, T, S*H] (= fwd ++ bwd on the feature axis).
//
// Bound on an H100 SXM (67 TFLOP/s f32 without tensor cores, 3.35 TB/s):
// per layer at B = 512, T = 90, H = 128, S = 2 the step matmuls are
// 2*T*(S*B)*H*3H = 9.06 GFLOP (0.135 ms), and xp + out move 189 MB
// (0.056 ms), so the kernel is bound by operations, before the serial
// dependence over the 90 steps is counted. This first version keeps W_hh in
// global memory and uses no tensor cores; shared-memory-resident weights,
// wgmma, TMA or clusters are later work.

#include <cuda_runtime.h>

namespace {

constexpr int ROWS = 8;          // batch rows per block
constexpr int MAX_THREADS = 512; // hidden sizes up to 512

__device__ __forceinline__ float sigmoid_f32(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__global__ void __launch_bounds__(MAX_THREADS)
gru_fwd_kernel(const float* __restrict__ xp,    // [B, T, S*3H]
               const float* __restrict__ w_hh,  // [S, H, 3H]
               const float* __restrict__ b_hh,  // [S, 3H]
               float* __restrict__ out,         // [B, T, S*H]
               int B, int T, int H, int S) {
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

}  // namespace

extern "C" {

// Launches the recurrence on `stream`; returns cudaGetLastError() as an int
// (0 = launched). Shapes are checked by the Python wrapper: S in {1, 2},
// H a multiple of 4 and at most MAX_THREADS, B and T positive.
int roko_gru_fwd(const float* xp, const float* w_hh, const float* b_hh,
                 float* out, int B, int T, int H, int S, void* stream) {
  const int threads = ((H + 31) / 32) * 32;
  const dim3 grid((B + ROWS - 1) / ROWS, S);
  const size_t smem = 2 * ROWS * (size_t)H * sizeof(float);
  gru_fwd_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      xp, w_hh, b_hh, out, B, T, H, S);
  return static_cast<int>(cudaGetLastError());
}

const char* roko_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
