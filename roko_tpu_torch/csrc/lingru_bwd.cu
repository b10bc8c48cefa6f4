// lingru scan backward for one bidirectional layer, CUDA C++ for sm_90a.
//
// Replaces the TPU kernel roko_tpu/models/pallas_lingru.py::_bwd_kernel
// (called from _run_bwd). With a = 1 - z and h_t = a_t h_{t-1} + z_t c_t,
// the gradient carried into step t from the steps after it is
// e_{t+1}, where e_t = a_t (e_{t+1} + dy_t) and e past the last step is 0.
// Walking each direction's time backwards, per (b, s, j):
//
//   z = sigmoid(p_z), c = tanh(p_c)           (recomputed from p)
//   g  = dy_t + e                             (total gradient into h_t)
//   da = g h_{t-1},  dz = g c - da,  dc = g z
//   dp_t = [dz z (1 - z), dc (1 - c^2)]
//   e <- (1 - z) g
//
// Layout is the port's natural one: p [B, T, 4H], the forward's output
// h [B, T, 2H] and its gradient dy [B, T, 2H] in; dp [B, T, 4H] out.
// Direction 0 walks t = T-1 .. 0 with h_{t-1} = h[b, t-1]; direction 1 walks
// t = 0 .. T-1 with its previous state h[b, t+1]; it is zero at each
// direction's first step.
//
// Design. As in lingru_fwd.cu, one thread owns one (b, s, j), j fastest for
// coalesced loads and stores, and walks the whole reverse time loop with e
// in an f32 register. The TPU version runs a suffix scan over VMEM time
// blocks, carries e across its serial grid in scratch, and streams one
// boundary row of h per block (hb) for h_{t-1} at the block's edge. None of
// that has a counterpart: the previous state is read from the stored
// forward output directly. No weight gradient is summed here (dw4 and db4
// come from the projection's matrix products outside), so there is no
// reduction across threads, and each output is a fixed sequence of f32
// operations: two launches give the same bits.
//
// Bound on an H100 SXM (3.35 TB/s): at the train shape B = 128, T = 90,
// H = 128 it reads p, h and dy (47.2 MB) and writes dp (23.6 MB): 0.021 ms,
// bytes-bound. 32k threads walk 90 dependent steps, so latency, not bytes,
// sets the time of this first version.
//
// f32 throughout, expf/tanhf, no fast math.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;

__device__ __forceinline__ float sigmoid_f32(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__global__ void __launch_bounds__(THREADS)
lingru_bwd_kernel(const float* __restrict__ p,   // [B, T, 4H]
                  const float* __restrict__ h,   // [B, T, 2H]
                  const float* __restrict__ dy,  // [B, T, 2H]
                  float* __restrict__ dp,        // [B, T, 4H]
                  int B, int T, int H) {
  const long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= (long long)B * 2 * H) return;
  const int j = (int)(idx % H);
  const int s = (int)((idx / H) % 2);
  const long long b = idx / (2 * H);

  const long long p_step = 4LL * H;
  const long long h_step = 2LL * H;
  // reverse kernel time: direction 0 from t = T-1 down, direction 1 from 0 up
  const int t0 = s ? 0 : T - 1;
  const long long dir = s ? 1 : -1;
  const long long p_off = (b * T + t0) * p_step + (long long)s * 2 * H + j;
  const long long h_off = (b * T + t0) * h_step + (long long)s * H + j;
  const float* pz = p + p_off;
  float* dpz = dp + p_off;
  const float* hp = h + h_off;
  const float* g_in = dy + h_off;

  float e = 0.f;
#pragma unroll 4
  for (int k = 0; k < T; ++k) {
    const float z = sigmoid_f32(__ldg(pz));
    const float c = tanhf(__ldg(pz + H));
    // the direction's previous state is the walk's next step; the walk's
    // last step is the direction's first, with h_0 = 0
    const float h_prev = (k < T - 1) ? __ldg(hp + dir * h_step) : 0.f;
    const float g = __ldg(g_in) + e;
    const float da = g * h_prev;
    const float dz = g * c - da;
    const float dc = g * z;
    dpz[0] = dz * (z * (1.f - z));
    dpz[H] = dc * (1.f - c * c);
    e = (1.f - z) * g;
    pz += dir * p_step;
    dpz += dir * p_step;
    hp += dir * h_step;
    g_in += dir * h_step;
  }
}

}  // namespace

extern "C" {

// Launches the backward scan on `stream`; returns cudaGetLastError() as an
// int (0 = launched). Shapes are checked by the Python wrapper: B, T and H
// positive.
int roko_lingru_bwd(const float* p, const float* h, const float* dy, float* dp,
                    int B, int T, int H, void* stream) {
  const long long n = (long long)B * 2 * H;
  const unsigned blocks = (unsigned)((n + THREADS - 1) / THREADS);
  lingru_bwd_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      p, h, dy, dp, B, T, H);
  return static_cast<int>(cudaGetLastError());
}

const char* roko_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
