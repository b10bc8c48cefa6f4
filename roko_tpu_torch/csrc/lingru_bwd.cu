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
// Design. A channel's walk is serial only in e: two operations a step.
// The rest of a step (the gates, dp) does not depend on e. Reading p_z,
// p_c, h_{t-1} and dy straight from device memory, one thread a channel
// kept about one step's loads in flight, 0.94 us a step. Two variants,
// chosen by fused_lingru.scan_plan:
//
//   staged (lingru_bwd_staged_kernel<K>): a block owns one (b, s, tile of
//   up to TILE channels). A step of the tile is four contiguous runs of the
//   tile's width (p_z, p_c, h_{t-1}, dy), so a ring of `stages` slots of K
//   steps in shared memory is filled by asynchronous bulk copies
//   (bulk_ring.cuh), started by the lanes of warp 0 and counted off one
//   mbarrier a slot: stages - 1 time tiles are in flight while the block
//   works on one. h_{t-1} is staged one step ahead of the other runs (slot
//   row i of tile g holds the h of walk step gK + i + 1), where the TPU
//   kernel streamed a boundary row hb. The block's threads split the work:
//   three gate threads a channel turn a tile's p_z, p_c into z, c (the
//   transcendental part, parallel over steps) and copy h_{t-1} and dy
//   beside them into one of two gate buffers; one chain thread a channel
//   then walks the tile's K steps from the buffer, carrying e and writing
//   dp straight to device memory, coalesced across the tile, while the
//   gate threads work on the next tile. One __syncthreads a tile hands a
//   gate buffer over and frees the tile's ring slot for the tile `stages`
//   ahead. Needs H % 4 == 0 and 16-byte-aligned tensors (the copies'
//   alignment) and at least K steps.
//
//   streaming (lingru_bwd_kernel): 128 threads a block over (b, s, j), j
//   fastest, loads through __ldg: the first version, kept for the shapes
//   the staged one does not take.
//
// Both compute z and c the same way and run bwd_chain, every product and
// sum rounded on its own, so the two variants and every (K, stages) give
// the same bits, and two launches too (no reduction across threads: dw4
// and db4 come from the projection's matrix products outside).
//
// Bound on an H100 SXM (3.35 TB/s): at the train shape B = 128, T = 90,
// H = 128 the kernel reads p, h and dy (47.2 MB) and writes dp (23.6 MB):
// 0.021 ms, bytes-bound (about twenty operations an element).
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py
// --lingru-only, device time in a trace, PERF.md section 6): 0.030 ms at
// B = 128 (71 % of the bound), where the first version took 0.079-0.082;
// 0.115 ms at B = 512 (bound 0.085), where it took 0.124. The same work
// with one thread a channel walking straight from the ring took 0.036-0.041
// ms at B = 128: each step's gate arithmetic is a chain of some 70 dependent
// instructions, and with 8 warps an SM that latency, not the bytes, set
// the time.
//
// f32 throughout, expf/tanhf, no fast math.

#include <cuda_runtime.h>

#include "bulk_ring.cuh"

namespace {

constexpr int STREAM_THREADS = 128;  // threads a block, streaming variant
constexpr int TILE = 128;            // channels a block, staged variant
constexpr int GATE_GROUPS = 3;       // gate threads per chain thread, staged variant
constexpr int MAX_STAGES = 8;        // deepest ring
constexpr int RUNS = 4;              // ring runs a step: p_z, p_c, h_{t-1}, dy
constexpr int GATES = 4;             // gate buffer rows a step: z, c, h_{t-1}, dy
constexpr int MAX_DEVICES = 64;      // devices whose shared-memory opt-in is remembered

__device__ __forceinline__ float sigmoid_f32(float x) {
  return __frcp_rn(__fadd_rn(1.0f, expf(-x)));  // = 1 / (1 + e^-x), correctly rounded
}

// The part of a reverse step that needs the carry: from the gates z and c,
// the previous state and dy, update e, write dp_c and return dp_z.
__device__ __forceinline__ float bwd_chain(float z, float c, float h_prev, float dy,
                                           float& e, float& dpc) {
  const float a = __fsub_rn(1.f, z);
  const float g = __fadd_rn(dy, e);
  const float da = __fmul_rn(g, h_prev);
  const float dz = __fsub_rn(__fmul_rn(g, c), da);
  const float dc = __fmul_rn(g, z);
  dpc = __fmul_rn(dc, __fsub_rn(1.f, __fmul_rn(c, c)));
  e = __fmul_rn(a, g);
  return __fmul_rn(dz, __fmul_rn(z, a));
}

__global__ void __launch_bounds__(STREAM_THREADS)
lingru_bwd_kernel(const float* __restrict__ p,   // [B, T, 4H]
                  const float* __restrict__ h,   // [B, T, 2H]
                  const float* __restrict__ dy,  // [B, T, 2H]
                  float* __restrict__ dp,        // [B, T, 4H]
                  int B, int T, int H) {
  const long long idx = (long long)blockIdx.x * STREAM_THREADS + threadIdx.x;
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
    // the direction's previous state is the walk's next step; the walk's
    // last step is the direction's first, with h_0 = 0
    const float h_prev = (k < T - 1) ? __ldg(hp + dir * h_step) : 0.f;
    float dpc;
    dpz[0] = bwd_chain(sigmoid_f32(__ldg(pz)), tanhf(__ldg(pz + H)), h_prev, __ldg(g_in), e,
                       dpc);
    dpz[H] = dpc;
    pz += dir * p_step;
    dpz += dir * p_step;
    hp += dir * h_step;
    g_in += dir * h_step;
  }
}

template <int K>
__global__ void __launch_bounds__((1 + GATE_GROUPS) * TILE, 2)
lingru_bwd_staged_kernel(const float* __restrict__ p,   // [B, T, 4H]
                         const float* __restrict__ h,   // [B, T, 2H]
                         const float* __restrict__ dy,  // [B, T, 2H]
                         float* __restrict__ dp,        // [B, T, 4H]
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
  // walk step k is time t0 + dir * k: direction 0 from T-1 down, 1 from 0 up
  const int t0 = s ? 0 : T - 1;
  const int dir = s ? 1 : -1;
  const float* p_tile = p + b * T * p_step + (long long)s * 2 * H + c0;
  const float* h_tile = h + b * T * h_step + (long long)s * H + c0;
  const float* dy_tile = dy + b * T * h_step + (long long)s * H + c0;
  float* dp_tile = dp + b * T * p_step + (long long)s * 2 * H + c0;
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
    const int h_runs = min(steps, T - 1 - k0);  // steps with a previous state
    const uint32_t bar = bulk::smem_addr(&full[slot]);
    if (lane == 0) bulk::arrive_expect(bar, (3 * steps + h_runs) * run_bytes);
    __syncwarp();
    const float* dst = ring + slot * slot_floats;
    for (int r = lane; r < RUNS * steps; r += 32) {
      const int i = r / RUNS, run = r % RUNS;
      const int k = k0 + i;
      const long long t = t0 + dir * k;
      const float* src;
      if (run == 0) {
        src = p_tile + t * p_step;
      } else if (run == 1) {
        src = p_tile + t * p_step + H;
      } else if (run == 2) {
        if (k + 1 >= T) continue;
        src = h_tile + (t + dir) * h_step;
      } else {
        src = dy_tile + t * h_step;
      }
      bulk::copy(bulk::smem_addr(dst + (run * K + i) * w), src, run_bytes, bar);
    }
  };

  if (threadIdx.x < 32) {
    for (int g = 0; g < min(stages, n_tiles); ++g) fill(g);
  }
  float e = 0.f;
  for (int g = 0; g < n_tiles; ++g) {
    if (!chain) {
      // gate threads: the tile's gates, with h_{t-1} and dy beside them, out
      // of the ring into gates[g % 2], one (step, channel) at a time
      const int slot = g % stages;
      bulk::wait(bulk::smem_addr(&full[slot]), (g / stages) & 1);
      const float* src = ring + slot * slot_floats;
      float* dst = gates + (g % 2) * GATES * K * w;
      const int k0 = g * K;
      const int n = min(K, T - k0) * width;
      for (int q = threadIdx.x - chain_threads; q < n; q += GATE_GROUPS * chain_threads) {
        const int i = q / width, c = q % width;
        const int at = i * w + c;
        dst[at] = sigmoid_f32(src[at]);
        dst[K * w + at] = tanhf(src[K * w + at]);
        dst[2 * K * w + at] = k0 + i + 1 < T ? src[2 * K * w + at] : 0.f;
        dst[3 * K * w + at] = src[3 * K * w + at];
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
      float* out = dp_tile + (long long)(t0 + dir * k0) * p_step + threadIdx.x;
      const long long out_step = dir * p_step;
      if (threadIdx.x < width) {
        if (steps == K) {
#pragma unroll
          for (int i = 0; i < K; ++i) {
            float dpc;
            out[i * out_step] = bwd_chain(src[i * w], src[(K + i) * w], src[(2 * K + i) * w],
                                          src[(3 * K + i) * w], e, dpc);
            out[i * out_step + H] = dpc;
          }
        } else {
          for (int i = 0; i < steps; ++i) {
            float dpc;
            out[i * out_step] = bwd_chain(src[i * w], src[(K + i) * w], src[(2 * K + i) * w],
                                          src[(3 * K + i) * w], e, dpc);
            out[i * out_step + H] = dpc;
          }
        }
      }
    }
  }
}

template <int K>
cudaError_t launch_staged(const float* p, const float* h, const float* dy, float* dp,
                          int B, int T, int H, int stages, cudaStream_t stream) {
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
    err = cudaFuncSetAttribute(lingru_bwd_staged_kernel<K>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    if (device < MAX_DEVICES) opted[device] = smem;
  }
  lingru_bwd_staged_kernel<K><<<(unsigned)(B * 2 * tiles), threads, smem, stream>>>(
      p, h, dy, dp, T, H, stages);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the backward scan on `stream`; returns a CUDA error code as an
// int (0 = launched). steps = 0 runs the streaming variant; else the staged
// one with `steps` in {4, 8, 16} steps a time tile and `stages` in 2..8
// slots (fused_lingru.scan_plan's choice). Shapes, H % 4 and alignment are
// checked by the Python wrapper.
int roko_lingru_bwd(const float* p, const float* h, const float* dy, float* dp,
                    int B, int T, int H, int steps, int stages, void* stream_ptr) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (steps == 0) {
    const long long n = (long long)B * 2 * H;
    const unsigned blocks = (unsigned)((n + STREAM_THREADS - 1) / STREAM_THREADS);
    lingru_bwd_kernel<<<blocks, STREAM_THREADS, 0, stream>>>(p, h, dy, dp, B, T, H);
    return static_cast<int>(cudaGetLastError());
  }
  if (stages < 2 || stages > MAX_STAGES) return static_cast<int>(cudaErrorInvalidValue);
  switch (steps) {
    case 4: return static_cast<int>(launch_staged<4>(p, h, dy, dp, B, T, H, stages, stream));
    case 8: return static_cast<int>(launch_staged<8>(p, h, dy, dp, B, T, H, stages, stream));
    case 16: return static_cast<int>(launch_staged<16>(p, h, dy, dp, B, T, H, stages, stream));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* roko_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
