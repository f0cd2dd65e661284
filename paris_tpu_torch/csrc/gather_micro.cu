// Gather micro-benchmarks for NVIDIA Hopper (sm_90a).
//
// Replaces the two Pallas micro-benchmark kernels of the repository:
//   K3a  benchmarks/gather_micro.py:make_kernel   (launched by run, :86)
//   K3b  benchmarks/gather_micro2.py:make_kernel  (launched by run, :82)
// They time, in isolation, the gather idioms with which a backprojection
// kernel samples its projections.  Each kernel computes one (64, 128) int32
// tile: for r in 0..63, with c = r % 8 and x = idx ^ r, it adds one gather
// per element to an accumulator.  The modes and what they add are listed in
// paris_tpu_torch/benchmarks/gather_micro.py and gather_micro2.py, whose
// plain PyTorch versions compute the same tiles.
//
// The grid is `blocks` thread blocks, standing for the Pallas grid's steps.
// Every block computes the whole tile (1024 threads x 8 elements: a warp
// holds 32 neighbouring columns of one row) and stores it to its own slice
// out[blockIdx.x], so the compiler cannot predict a store and sink the work.
// Each mode is its own kernel, with the window height S a template
// parameter, so the select ladder unrolls as the Pallas loop does.  As in
// the Pallas kernel, the ladder runs over the window's rows outside the
// elements, so a thread reads each row once per rep.  The 64 reps are a
// loop, not unrolled as the Pallas loop is: with the reps unrolled (all 64,
// or 8 or 16 at a time) ptxas hoisted the loads of later reps, ran out of
// registers and spilled up to 9 KB a thread in most modes, and the spills,
// not the idioms, set the times.  So c = r % 8, and K3b's static window
// r % 16, are computed from the loop counter: no memory read, unlike
// k0[r].  Window indices read from k0 are clamped into the table, as XLA
// clamps a dynamic slice; remainders are floored, as jnp.remainder is.
//
// What bounds it on this card: load-issue rate and the sectors each warp
// request touches.  The tables (512 KiB for K3a, 4 MiB for K3b) stay in
// device memory, read with __ldg, and live in the 50 MB L2 after the first
// pass; K3a's (8, 64, 128) working set does not fit a block's 227 KB of
// shared memory, so a shared-memory variant would measure another thing.
//   lane      a warp's 32 threads gather from one 512 B row (<= 16 sectors);
//   sublane   they read up to 32 rows 512 B apart (<= 32 sectors);
//   select    S coalesced row reads (4 sectors each) per rep, shared by the
//             thread's 8 elements, plus S compares per element: no gather.
// The design does nothing to hide these costs: measuring them is the point.

#include <cuda_runtime.h>

namespace {

constexpr int REPS = 64;                     // gathers per element
constexpr int C = 8;                         // tables, rep r reads table r % C
constexpr int K = 16;                        // windows per table (K3b)
constexpr int ROWS = 64, COLS = 128;         // the tile
constexpr int TILE = ROWS * COLS;
constexpr int THREADS = 1024;
constexpr int ROW_STEP = THREADS / COLS;     // rows apart of a thread's elements
constexpr int PER_THREAD = TILE / THREADS;   // elements of one thread

// K3a modes, in the order of gather_micro.MODES.
enum { GM1_EMPTY, GM1_LANE, GM1_LANE2, GM1_SUBLANE, GM1_SELECT };
// K3b modes, in the order of gather_micro2.MODES.
enum { GM2_EMPTY, GM2_STATIC_READ, GM2_DYN_READ, GM2_STATIC_TAKE,
       GM2_DYN_TAKE, GM2_DYN_TAKE2, GM2_CHAIN_TAKE2, GM2_CHAIN_ONLY };

// jnp.remainder by a positive S: in [0, S) for every x.
template <int S>
__device__ __forceinline__ int floor_mod(int x) {
  const int m = x % S;
  return m < 0 ? m + S : m;
}

__device__ __forceinline__ int window(int k) { return min(max(k, 0), K - 1); }

// One rep of K3a: acc[k] += the mode's gather for the thread's elements
// (rows i0 + ROW_STEP k, column j) of table t = tab[r % C].
template <int MODE, int S>
__device__ __forceinline__ void rep_k3a(const int* t, int r, int i0, int j,
                                        const int (&x0)[PER_THREAD],
                                        int (&acc)[PER_THREAD]) {
  if constexpr (MODE == GM1_SELECT) {
    int m[PER_THREAD], g[PER_THREAD];
#pragma unroll
    for (int k = 0; k < PER_THREAD; ++k) {
      m[k] = floor_mod<S>(x0[k] ^ r);
      g[k] = 0;
    }
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int v = __ldg(t + s * COLS + j);
#pragma unroll
      for (int k = 0; k < PER_THREAD; ++k) g[k] = (m[k] == s) ? v : g[k];
    }
#pragma unroll
    for (int k = 0; k < PER_THREAD; ++k) acc[k] += g[k];
  } else {
#pragma unroll
    for (int k = 0; k < PER_THREAD; ++k) {
      const int i = i0 + ROW_STEP * k;
      const int x = x0[k] ^ r;
      if constexpr (MODE == GM1_EMPTY) {
        acc[k] += x;
      } else if constexpr (MODE == GM1_LANE) {
        acc[k] += __ldg(t + i * COLS + (x & 127));
      } else if constexpr (MODE == GM1_LANE2) {
        const int g0 = __ldg(t + i * COLS + (x & 127));
        const int g1 = __ldg(t + (64 + i) * COLS + (x & 127));
        acc[k] += ((x & 255) >> 7) == 1 ? g1 : g0;
      } else {
        acc[k] += __ldg(t + floor_mod<S>(x) * COLS + j);
      }
    }
  }
}

// K3a.  tab (C, 128, 128), idx (64, 128), out (blocks, 64, 128); int32.
template <int MODE, int S>
__global__ void __launch_bounds__(THREADS)
gather_micro_kernel(const int* __restrict__ tab, const int* __restrict__ idx,
                    int* __restrict__ out) {
  const int j = threadIdx.x % COLS;
  const int i0 = threadIdx.x / COLS;
  int x0[PER_THREAD], acc[PER_THREAD];
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    x0[k] = __ldg(idx + (i0 + ROW_STEP * k) * COLS + j);
    acc[k] = 0;
  }
#pragma unroll 1
  for (int r = 0; r < REPS; ++r)
    rep_k3a<MODE, S>(tab + (r % C) * 128 * COLS, r, i0, j, x0, acc);
  int* o = out + (size_t)blockIdx.x * TILE;
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) o[(i0 + ROW_STEP * k) * COLS + j] = acc[k];
}

// One rep of K3b on table tc = tab[r % C]; rk = r % K.
template <int MODE>
__device__ __forceinline__ void rep_k3b(const int* tc, const int* k0, int r,
                                        int rk, int i0, int j,
                                        const int (&x0)[PER_THREAD],
                                        int (&acc)[PER_THREAD]) {
  int kw = rk, kw2 = 0, kk = 0;     // the rep's windows tab[c, kw], tab[c, kw2]
  if constexpr (MODE == GM2_DYN_READ || MODE == GM2_DYN_TAKE ||
                MODE == GM2_DYN_TAKE2) {
    const int kr = __ldg(k0 + r);
    kw = window(kr);
    kw2 = window(kr + 2);
  } else if constexpr (MODE == GM2_CHAIN_TAKE2 || MODE == GM2_CHAIN_ONLY) {
    // the scalar chain of gather_micro2.py:54-60, rounded step by step
    // (never contracted into an FMA) as the f32 ops of the plain version
    const int kr0 = __ldg(k0 + r);
    const float s0 = (float)kr0;
    const float s1 = (float)__ldg(k0 + (r + 1) % REPS);
    const float a = fminf(fminf(__fmul_rn(s0, 1.01f), __fmul_rn(s0, 1.02f)),
                          fminf(__fmul_rn(s1, 1.01f), __fmul_rn(s1, 1.02f)));
    const float b = __fsub_rn(__fmul_rn(__fsub_rn(a, 3.0f), 0.25f), 0.5f);
    const int kr = ((int)floorf(b) - 1) >> 6;
    kk = min(max(kr + kr0, 0), K - 3);
    kw = kk;
    kw2 = kk + 2;
  }
  const int* t0 = tc + kw * TILE;
  const int* t1 = tc + kw2 * TILE;
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    const int i = i0 + ROW_STEP * k;
    const int x = x0[k] ^ r;
    const int w = x & 127;
    if constexpr (MODE == GM2_EMPTY) {
      acc[k] += x;
    } else if constexpr (MODE == GM2_STATIC_READ || MODE == GM2_DYN_READ) {
      acc[k] += __ldg(t0 + i * COLS + j) + x;
    } else if constexpr (MODE == GM2_STATIC_TAKE || MODE == GM2_DYN_TAKE) {
      acc[k] += __ldg(t0 + i * COLS + w);
    } else if constexpr (MODE == GM2_DYN_TAKE2) {
      const int g0 = __ldg(t0 + i * COLS + w);
      const int g1 = __ldg(t1 + i * COLS + w);
      acc[k] += ((x & 255) >> 7) == 1 ? g1 : g0;
    } else if constexpr (MODE == GM2_CHAIN_ONLY) {
      acc[k] += x + kk;
    } else {
      const int relv = x - 64 * kk;
      const int g0 = __ldg(t0 + i * COLS + (relv & 127));
      const int g1 = __ldg(t1 + i * COLS + (relv & 127));
      acc[k] += (relv >> 7) == 1 ? g1 : g0;
    }
  }
}

// K3b.  k0 (64,), tab (C, K, 64, 128), idx (64, 128), out (blocks, 64, 128);
// int32.
template <int MODE>
__global__ void __launch_bounds__(THREADS)
gather_micro2_kernel(const int* __restrict__ k0, const int* __restrict__ tab,
                     const int* __restrict__ idx, int* __restrict__ out) {
  const int j = threadIdx.x % COLS;
  const int i0 = threadIdx.x / COLS;
  int x0[PER_THREAD], acc[PER_THREAD];
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    x0[k] = __ldg(idx + (i0 + ROW_STEP * k) * COLS + j);
    acc[k] = 0;
  }
#pragma unroll 1
  for (int r = 0; r < REPS; ++r)
    rep_k3b<MODE>(tab + (r % C) * K * TILE, k0, r, r % K, i0, j, x0, acc);
  int* o = out + (size_t)blockIdx.x * TILE;
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) o[(i0 + ROW_STEP * k) * COLS + j] = acc[k];
}

template <typename Kernel, typename... Args>
void launch(Kernel kernel, int blocks, cudaStream_t s, Args... args) {
  kernel<<<blocks, THREADS, 0, s>>>(args...);
}

}  // namespace

// Launches one K3a kernel on `stream`.  Returns cudaGetLastError() after
// the launch (0 = launched), or cudaErrorInvalidValue for a mode, S or
// block count that has no kernel.
extern "C" int paris_gm1_launch(int device, void* stream, int mode, int S,
                                const int* tab, const int* idx, int* out,
                                int blocks) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (blocks < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int key = mode * 1000 + ((mode == GM1_SUBLANE || mode == GM1_SELECT) ? S : 0);
  switch (key) {
    case GM1_EMPTY * 1000: launch(gather_micro_kernel<GM1_EMPTY, 1>, blocks, s, tab, idx, out); break;
    case GM1_LANE * 1000: launch(gather_micro_kernel<GM1_LANE, 1>, blocks, s, tab, idx, out); break;
    case GM1_LANE2 * 1000: launch(gather_micro_kernel<GM1_LANE2, 1>, blocks, s, tab, idx, out); break;
    case GM1_SUBLANE * 1000 + 8: launch(gather_micro_kernel<GM1_SUBLANE, 8>, blocks, s, tab, idx, out); break;
    case GM1_SUBLANE * 1000 + 16: launch(gather_micro_kernel<GM1_SUBLANE, 16>, blocks, s, tab, idx, out); break;
    case GM1_SUBLANE * 1000 + 32: launch(gather_micro_kernel<GM1_SUBLANE, 32>, blocks, s, tab, idx, out); break;
    case GM1_SELECT * 1000 + 8: launch(gather_micro_kernel<GM1_SELECT, 8>, blocks, s, tab, idx, out); break;
    case GM1_SELECT * 1000 + 16: launch(gather_micro_kernel<GM1_SELECT, 16>, blocks, s, tab, idx, out); break;
    case GM1_SELECT * 1000 + 24: launch(gather_micro_kernel<GM1_SELECT, 24>, blocks, s, tab, idx, out); break;
    case GM1_SELECT * 1000 + 32: launch(gather_micro_kernel<GM1_SELECT, 32>, blocks, s, tab, idx, out); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Launches one K3b kernel on `stream`; returns as paris_gm1_launch does.
extern "C" int paris_gm2_launch(int device, void* stream, int mode,
                                const int* k0, const int* tab, const int* idx,
                                int* out, int blocks) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (blocks < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case GM2_EMPTY: launch(gather_micro2_kernel<GM2_EMPTY>, blocks, s, k0, tab, idx, out); break;
    case GM2_STATIC_READ: launch(gather_micro2_kernel<GM2_STATIC_READ>, blocks, s, k0, tab, idx, out); break;
    case GM2_DYN_READ: launch(gather_micro2_kernel<GM2_DYN_READ>, blocks, s, k0, tab, idx, out); break;
    case GM2_STATIC_TAKE: launch(gather_micro2_kernel<GM2_STATIC_TAKE>, blocks, s, k0, tab, idx, out); break;
    case GM2_DYN_TAKE: launch(gather_micro2_kernel<GM2_DYN_TAKE>, blocks, s, k0, tab, idx, out); break;
    case GM2_DYN_TAKE2: launch(gather_micro2_kernel<GM2_DYN_TAKE2>, blocks, s, k0, tab, idx, out); break;
    case GM2_CHAIN_TAKE2: launch(gather_micro2_kernel<GM2_CHAIN_TAKE2>, blocks, s, k0, tab, idx, out); break;
    case GM2_CHAIN_ONLY: launch(gather_micro2_kernel<GM2_CHAIN_ONLY>, blocks, s, k0, tab, idx, out); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* paris_gm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
