// lingru scan forward for one bidirectional layer, CUDA C++ for sm_90a.
//
// Replaces the TPU kernel roko_tpu/models/pallas_lingru.py::_fwd_kernel
// (called from _run_fwd). Per direction s, batch row b and channel j, from
// h_0 = 0:
//
//   z_t = sigmoid(p_z),  c_t = tanh(p_c)
//   h_t = (1 - z_t) h_{t-1} + z_t c_t
//
// where p_z = p[b, t, s*2H + j] and p_c = p[b, t, s*2H + H + j] are the
// hoisted gate projections (p = x @ w4 + b4, computed outside). Direction 1
// walks t = T-1 .. 0 by index. Output h [B, T, 2H] = fwd ++ bwd on the
// feature axis, the layer's output as it stands.
//
// Design. The recurrence is elementwise: channels never talk to each other.
// The TPU version stacks both directions as rows of a time-major slab, runs
// an in-block Hillis-Steele scan over a VMEM time block and carries the
// block's last h across its serial time grid in scratch. Here one thread
// owns one (b, s, j) and walks all T steps itself, h in an f32 register, so
// there is no carry between blocks, no scan across threads, no flip and no
// row padding. j is the fastest index, so a warp's loads of p_z, p_c and its
// stores of h touch consecutive addresses. The loads of a step do not
// depend on h, so the unrolled loop starts them ahead of the chain of
// dependent FMAs.
//
// Bound on an H100 SXM (3.35 TB/s): at the inference shape B = 512, T = 90,
// H = 128 the kernel reads p (94.4 MB) and writes h (47.2 MB): 0.042 ms,
// bytes-bound (about eight operations an element). At the train batch of 128
// only 32k threads run, a quarter of what the card holds, so the latency of
// the 90 dependent steps, not the bytes, sets the time.
//
// f32 throughout, expf/tanhf, no fast math.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;

__device__ __forceinline__ float sigmoid_f32(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__global__ void __launch_bounds__(THREADS)
lingru_fwd_kernel(const float* __restrict__ p,  // [B, T, 4H]
                  float* __restrict__ h,        // [B, T, 2H]
                  int B, int T, int H) {
  const long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= (long long)B * 2 * H) return;
  const int j = (int)(idx % H);
  const int s = (int)((idx / H) % 2);
  const long long b = idx / (2 * H);

  const long long p_step = 4LL * H;  // one time step of p
  const long long h_step = 2LL * H;  // one time step of h
  const int t0 = s ? T - 1 : 0;
  const long long dir = s ? -1 : 1;
  const float* pz = p + (b * T + t0) * p_step + (long long)s * 2 * H + j;
  float* out = h + (b * T + t0) * h_step + (long long)s * H + j;

  float hv = 0.f;
#pragma unroll 4
  for (int k = 0; k < T; ++k) {
    const float z = sigmoid_f32(__ldg(pz));
    const float c = tanhf(__ldg(pz + H));
    hv = (1.f - z) * hv + z * c;
    *out = hv;
    pz += dir * p_step;
    out += dir * h_step;
  }
}

}  // namespace

extern "C" {

// Launches the scan on `stream`; returns cudaGetLastError() as an int
// (0 = launched). Shapes are checked by the Python wrapper: B, T and H
// positive.
int roko_lingru_fwd(const float* p, float* h, int B, int T, int H, void* stream) {
  const long long n = (long long)B * 2 * H;
  const unsigned blocks = (unsigned)((n + THREADS - 1) / THREADS);
  lingru_fwd_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(p, h, B, T, H);
  return static_cast<int>(cudaGetLastError());
}

const char* roko_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
