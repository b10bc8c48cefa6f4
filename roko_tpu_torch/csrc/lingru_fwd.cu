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
// block's last h across its serial time grid in scratch. Here a channel's
// walk stays one thread's serial loop, h in an f32 register, so there is no
// carry between blocks, no scan across threads, no flip and no row
// padding. Only one multiply-add a step depends on h; the gates do not.
// Reading p_z and p_c straight from device memory, one thread a channel
// kept about one step's loads in flight. Two variants, chosen by
// fused_lingru.scan_plan:
//
//   staged (lingru_fwd_staged_kernel<K>): a block owns one (b, s, tile of
//   up to TILE channels). A step of the tile is two contiguous runs of the
//   tile's width (p_z, p_c), so a ring of `stages` slots of K steps in
//   shared memory is filled by asynchronous bulk copies (bulk_ring.cuh),
//   started by the lanes of warp 0 and counted off one mbarrier a slot:
//   stages - 1 time tiles are in flight while the block works on one.
//   Three gate threads a channel turn a tile's p_z, p_c into 1 - z and z c
//   (the transcendental part, parallel over steps) in one of two gate
//   buffers; one chain thread a channel then walks the tile's K steps from
//   the buffer, one fused multiply-add a step, writing h straight to device
//   memory, coalesced across the tile, while the gate threads work on the
//   next tile. One __syncthreads a tile hands a gate buffer over and frees
//   the tile's ring slot for the tile `stages` ahead. Needs H % 4 == 0 and
//   16-byte-aligned tensors (the copies' alignment) and at least K steps.
//
//   streaming (lingru_fwd_kernel): 128 threads a block over (b, s, j), j
//   fastest, loads through __ldg: the first version, kept for the shapes
//   the staged one does not take.
//
// Both run fwd_gates and the same pinned multiply-add, so the two variants
// and every (K, stages) give the same bits.
//
// Bound on an H100 SXM (3.35 TB/s): the kernel reads p and writes h, 12
// bytes an element against about eight operations, so bytes bound it: at
// the inference shape B = 512, T = 90, H = 128, 94.4 MB read and 47.2 MB
// written, 0.042 ms; at the train batch B = 128, 0.011 ms.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py
// --lingru-only, device time in a trace, PERF.md section 6), 16 steps x 3
// stages: 0.071 ms at B = 512 (60 % of the bound) and 0.019 ms at B = 128
// (56 %), where the first version took 0.078 and 0.051-0.052. At B = 512
// the gate threads' arithmetic (some 70 instructions an element for expf,
// the reciprocal and tanhf) keeps it from the bytes' bound.
//
// f32 throughout, expf/tanhf, no fast math.

#include <cuda_runtime.h>

#include "bulk_ring.cuh"

namespace {

constexpr int STREAM_THREADS = 128;  // threads a block, streaming variant
constexpr int TILE = 128;            // channels a block, staged variant
constexpr int GATE_GROUPS = 3;       // gate threads per chain thread, staged variant
constexpr int MAX_STAGES = 8;        // deepest ring
constexpr int RUNS = 2;              // ring runs a step: p_z, p_c
constexpr int GATES = 2;             // gate buffer rows a step: 1 - z, z c
constexpr int MAX_DEVICES = 64;      // devices whose shared-memory opt-in is remembered

__device__ __forceinline__ float sigmoid_f32(float x) {
  return __frcp_rn(__fadd_rn(1.0f, expf(-x)));  // = 1 / (1 + e^-x), correctly rounded
}

// A step's terms that do not depend on h: (a, b) = (1 - z, z c), so that
// h' = __fmaf_rn(a, h, b).
__device__ __forceinline__ float2 fwd_gates(float pz, float pc) {
  const float z = sigmoid_f32(pz);
  return make_float2(__fsub_rn(1.f, z), __fmul_rn(z, tanhf(pc)));
}

// No __launch_bounds__: with them ptxas spilled 4 bytes around the
// reciprocal's slow-path call; without, it neither spills nor runs slower.
__global__ void
lingru_fwd_kernel(const float* __restrict__ p,  // [B, T, 4H]
                  float* __restrict__ h,        // [B, T, 2H]
                  int B, int T, int H) {
  const long long idx = (long long)blockIdx.x * STREAM_THREADS + threadIdx.x;
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
    const float2 ab = fwd_gates(__ldg(pz), __ldg(pz + H));
    hv = __fmaf_rn(ab.x, hv, ab.y);
    *out = hv;
    pz += dir * p_step;
    out += dir * h_step;
  }
}

template <int K>
__global__ void __launch_bounds__((1 + GATE_GROUPS) * TILE, 2)
lingru_fwd_staged_kernel(const float* __restrict__ p,  // [B, T, 4H]
                         float* __restrict__ h,        // [B, T, 2H]
                         int T, int H, int stages) {
  // ring[slot][run][i][c]: run `run` of walk step gK + i of the tile in the
  // slot; then gates[buf][row][i][c] for tiles g with g % 2 == buf
  extern __shared__ __align__(16) float ring[];
  __shared__ __align__(8) uint64_t full[MAX_STAGES];

  const int tiles = (H + TILE - 1) / TILE;
  const int w = min(H, TILE);  // a ring row's floats
  const int c0 = (blockIdx.x % tiles) * TILE;
  const int width = min(TILE, H - c0);
  const int s = (blockIdx.x / tiles) % 2;
  const long long b = blockIdx.x / (2 * tiles);
  const int chain_threads = (w + 31) / 32 * 32;
  const bool chain = threadIdx.x < chain_threads;  // else a gate thread
  const int lane = threadIdx.x % 32;

  const long long p_step = 4LL * H;
  const long long h_step = 2LL * H;
  // walk step k is time t0 + dir * k: direction 0 from 0 up, 1 from T-1 down
  const int t0 = s ? T - 1 : 0;
  const int dir = s ? -1 : 1;
  const float* p_tile = p + b * T * p_step + (long long)s * 2 * H + c0;
  float* h_tile = h + b * T * h_step + (long long)s * H + c0;
  const int n_tiles = (T + K - 1) / K;
  const uint32_t run_bytes = 4u * width;
  const int slot_floats = RUNS * K * w;
  float* const gates = ring + stages * slot_floats;

  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) bulk::init(&full[i], 1);
    bulk::init_fence();
  }
  __syncthreads();

  // warp 0: copy time tile g into its slot
  auto fill = [&](int g) {
    const int slot = g % stages;
    const int k0 = g * K;
    const int steps = min(K, T - k0);
    const uint32_t bar = bulk::smem_addr(&full[slot]);
    if (lane == 0) bulk::arrive_expect(bar, RUNS * steps * run_bytes);
    __syncwarp();
    const float* dst = ring + slot * slot_floats;
    for (int r = lane; r < RUNS * steps; r += 32) {
      const int i = r / RUNS, run = r % RUNS;
      const float* src = p_tile + (long long)(t0 + dir * (k0 + i)) * p_step + run * H;
      bulk::copy(bulk::smem_addr(dst + (run * K + i) * w), src, run_bytes, bar);
    }
  };

  if (threadIdx.x < 32) {
    for (int g = 0; g < min(stages, n_tiles); ++g) fill(g);
  }
  float hv = 0.f;
  for (int g = 0; g < n_tiles; ++g) {
    if (!chain) {
      // gate threads: the tile's (1 - z, z c) out of the ring into
      // gates[g % 2], one (step, channel) at a time
      const int slot = g % stages;
      bulk::wait(bulk::smem_addr(&full[slot]), (g / stages) & 1);
      const float* src = ring + slot * slot_floats;
      float* dst = gates + (g % 2) * GATES * K * w;
      const int n = min(K, T - g * K) * width;
      for (int q = threadIdx.x - chain_threads; q < n; q += GATE_GROUPS * chain_threads) {
        const int at = q / width * w + q % width;
        const float2 ab = fwd_gates(src[at], src[K * w + at]);
        dst[at] = ab.x;
        dst[K * w + at] = ab.y;
      }
    }
    // the gates of tile g are in; the chain is done with tile g - 1, so
    // gates[(g + 1) % 2] and the ring slot of tile g are free
    __syncthreads();
    if (chain) {
      if (threadIdx.x < 32 && g + stages < n_tiles) fill(g + stages);
      const float* src = gates + (g % 2) * GATES * K * w + threadIdx.x;
      const int k0 = g * K;
      const int steps = min(K, T - k0);
      float* out = h_tile + (long long)(t0 + dir * k0) * h_step + threadIdx.x;
      const long long out_step = dir * h_step;
      if (threadIdx.x < width) {
        if (steps == K) {
#pragma unroll
          for (int i = 0; i < K; ++i) {
            hv = __fmaf_rn(src[i * w], hv, src[(K + i) * w]);
            out[i * out_step] = hv;
          }
        } else {
          for (int i = 0; i < steps; ++i) {
            hv = __fmaf_rn(src[i * w], hv, src[(K + i) * w]);
            out[i * out_step] = hv;
          }
        }
      }
    }
  }
}

template <int K>
cudaError_t launch_staged(const float* p, float* h, int B, int T, int H, int stages,
                          cudaStream_t stream) {
  const int w = H < TILE ? H : TILE;
  const int tiles = (H + TILE - 1) / TILE;
  const int threads = (1 + GATE_GROUPS) * ((w + 31) / 32 * 32);
  const size_t smem = sizeof(float) * (size_t)K * w * (stages * RUNS + 2 * GATES);
  // opt in to the block's dynamic shared memory once a device and size (the
  // default limit, 48 KB, counts the static barriers too)
  static size_t opted[MAX_DEVICES] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= MAX_DEVICES || opted[device] < smem) {
    err = cudaFuncSetAttribute(lingru_fwd_staged_kernel<K>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    if (device < MAX_DEVICES) opted[device] = smem;
  }
  lingru_fwd_staged_kernel<K><<<(unsigned)(B * 2 * tiles), threads, smem, stream>>>(
      p, h, T, H, stages);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the scan on `stream`; returns a CUDA error code as an int (0 =
// launched). steps = 0 runs the streaming variant; else the staged one with
// `steps` in {4, 8, 16} steps a time tile and `stages` in 2..8 slots
// (fused_lingru.scan_plan's choice). Shapes, H % 4 and alignment are
// checked by the Python wrapper.
int roko_lingru_fwd(const float* p, float* h, int B, int T, int H, int steps, int stages,
                    void* stream_ptr) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (steps == 0) {
    const long long n = (long long)B * 2 * H;
    const unsigned blocks = (unsigned)((n + STREAM_THREADS - 1) / STREAM_THREADS);
    lingru_fwd_kernel<<<blocks, STREAM_THREADS, 0, stream>>>(p, h, B, T, H);
    return static_cast<int>(cudaGetLastError());
  }
  if (stages < 2 || stages > MAX_STAGES) return static_cast<int>(cudaErrorInvalidValue);
  switch (steps) {
    case 4: return static_cast<int>(launch_staged<4>(p, h, B, T, H, stages, stream));
    case 8: return static_cast<int>(launch_staged<8>(p, h, B, T, H, stages, stream));
    case 16: return static_cast<int>(launch_staged<16>(p, h, B, T, H, stages, stream));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* roko_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
