// Gather micro-benchmarks for NVIDIA Hopper (sm_90a).
//
// Replaces the two Pallas micro-benchmark kernels of the repository:
//   K3a  benchmarks/gather_micro.py:make_kernel   (launched by run, :86)
//   K3b  benchmarks/gather_micro2.py:make_kernel  (launched by run, :82)
// They time, in isolation, the ways in which a backprojection kernel can
// sample a projection row.  A tile is (64, 128) int32: for r in 0..63, with
// c = r % 8 and x = idx ^ r, one gather per element is added to an
// accumulator.  The modes and what they add are listed in
// paris_tpu_torch/benchmarks/gather_micro.py and gather_micro2.py, whose
// plain PyTorch versions compute the same tiles; a launch computes `blocks`
// tiles (the Pallas grid's steps), each into its own slice of `out`, so the
// compiler cannot predict a store and sink the work.
//
// The TPU kernels hold their tables in on-chip memory for the whole grid and
// so time a gather from on-chip memory.  These do the same on the H100:
// inside the 64 reps every table word comes from shared memory.
//
//  * Row-band blocks.  A thread block owns R rows of one tile, so the CUDA
//    grid is blocks x 64 / R thread blocks.  A thread owns PER elements of
//    one column, G = blockDim.x / 128 rows apart (R = G x PER); a warp holds
//    32 neighbouring columns of one row.  R and the bytes of dynamic shared
//    memory come from the host's planner (plan_band, plan_ring), and the
//    launchers refuse a pair that is not what the kernel needs.
//  * K3a, tables resident.  lane reads only row i of a table, lane2 rows i
//    and 64 + i, so a block stages rows [i0, i0 + R) (and 64 + the same) of
//    the 8 tables; sublane and select read rows 0..S-1 whatever the row, so
//    a block stages those S rows of the 8 tables whole.  The copies are
//    cp.async (16 B), one group per table, all started before the reps; rep r
//    < 8 waits for table r only, so the first reps overlap the later
//    tables' copies.
//  * K3b, a ring of windows.  The window of rep r is known only from k0.
//    The block first computes every rep's window pair into shared memory
//    (the static r % 16, the clamped k0[r] and k0[r] + 2, or the f32 scalar
//    chain), which takes the dependent scalar load out of the rep loop, as
//    the TPU's scalar prefetch does.  Then a ring of NS stages: while rep r
//    gathers from its stage, the bands of reps r+1 .. r+NS-1 are in flight
//    (cp.async groups, one barrier per rep).
//  * One load per gather.  lane2, dyn_take2 and chain_take2 pick one of two
//    rows by a bit of x; the two bands lie R x 128 words apart in shared
//    memory, so the pick is part of the address and one load replaces two
//    loads and a select.  The result is the same for every int32 x.
//  * The reps stay a loop (K3a's first 8 are peeled for the per-table
//    waits; K3b's is unrolled by twice the ring's NS, so a rep's stage and
//    table are known when compiled), so c = r % 8 comes from the counter.
//    Unrolled whole, ptxas moved loads ahead and spilled.
//  * The values are the plain version's for every int32 input.  Window
//    indices read from k0 are clamped into the table, as XLA clamps a
//    dynamic slice; remainders are floored, as jnp.remainder is; sums that
//    can leave int32 wrap, as they do in the plain version.
//
// What bounds it on this card.  The shared-memory data path moves 32 words
// a clock an SM.  A lane gather's bank is its column & 31, so random columns
// collide (about 3 ways for 32 lanes) and a warp's load takes that many
// passes: that bounds lane and lane2.  sublane reads one column per lane
// whatever the row, and select reads rows, so both are conflict-free; they
// are bound by their int32 instructions (select by its S compares per
// element), which an SM runs at 64 lanes a clock.  K3b copies as many words
// from L2 into shared memory per rep as it gathers, so the L2-to-SM rate
// bounds it.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int REPS = 64;                     // gathers per element
constexpr int C = 8;                         // tables, rep r reads table r % C
constexpr int K = 16;                        // windows per table (K3b)
constexpr int ROWS = 64, COLS = 128;         // the tile
constexpr int TILE = ROWS * COLS;
constexpr int TAB_ROWS = 128;                // rows of a K3a table
constexpr int MAX_THREADS = 1024;
constexpr int NS = 4;                        // stages of K3b's window ring
constexpr int PER_K3B = 4;                   // elements of a K3b thread
constexpr int UNROLL_K3B = 2 * NS;           // reps of K3b's loop body

// K3a modes, in the order of gather_micro.MODES.
enum { GM1_EMPTY, GM1_LANE, GM1_LANE2, GM1_SUBLANE, GM1_SELECT };
// K3b modes, in the order of gather_micro2.MODES.
enum { GM2_EMPTY, GM2_STATIC_READ, GM2_DYN_READ, GM2_STATIC_TAKE,
       GM2_DYN_TAKE, GM2_DYN_TAKE2, GM2_CHAIN_TAKE2, GM2_CHAIN_ONLY };

// Elements of a K3a thread.  select shares each row read among them.
__host__ __device__ constexpr int per_k3a(int mode) {
  return mode == GM1_SELECT ? 8 : 4;
}

// Threads of the largest K3a block.  select's ladder over 8 elements needs
// more than the 64 registers a thread of a 1024-thread block can have.
__host__ __device__ constexpr int max_threads_k3a(int mode) {
  return mode == GM1_SELECT ? 512 : MAX_THREADS;
}

// Bands of a window that a K3b rep gathers from.
__host__ __device__ constexpr int windows_k3b(int mode) {
  return (mode == GM2_EMPTY || mode == GM2_CHAIN_ONLY) ? 0
       : (mode == GM2_DYN_TAKE2 || mode == GM2_CHAIN_TAKE2) ? 2 : 1;
}

// Words of shared memory of a K3a block of R rows, or -1 for no kernel.
__host__ __device__ constexpr int words_k3a(int mode, int S, int R) {
  return mode == GM1_EMPTY ? 0
       : mode == GM1_LANE ? C * R * COLS
       : mode == GM1_LANE2 ? 2 * C * R * COLS
       : (mode == GM1_SUBLANE || mode == GM1_SELECT) ? C * S * COLS : -1;
}

// jnp.remainder by a positive S: in [0, S) for every x.  For a power of
// two that is the low bits of x, negative or not.
template <int S>
__device__ __forceinline__ int floor_mod(int x) {
  if constexpr ((S & (S - 1)) == 0) {
    return x & (S - 1);
  } else {
    const int m = x % S;
    return m < 0 ? m + S : m;
  }
}

__device__ __forceinline__ int window(int k) { return min(max(k, 0), K - 1); }

// a + b as int32 arithmetic that wraps
__device__ __forceinline__ int wrap_add(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

// Starts the block's copy of `words` ints (a multiple of 4; both sides 16-B
// aligned) into shared memory; the caller commits the group.
__device__ __forceinline__ void copy_async(int* dst, const int* src,
                                           int words) {
  for (int q = threadIdx.x * 4; q < words; q += blockDim.x * 4)
    __pipeline_memcpy_async(dst + q, src + q, 16);
}

// One rep of K3a: acc[k] += the mode's gather for the thread's elements
// (local rows g + G k, column j) from t, table r % C in shared memory;
// `band` = R x 128, the words between lane2's two row bands.
template <int MODE, int S, int PER>
__device__ __forceinline__ void rep_k3a(const int* t, int r, int g, int G,
                                        int j, int band,
                                        const int (&x0)[PER],
                                        int (&acc)[PER]) {
  if constexpr (MODE == GM1_SELECT) {
    int m[PER], v[PER];
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      m[k] = floor_mod<S>(x0[k] ^ r);
      v[k] = 0;
    }
    // eight rows at a time: unrolled whole, ptxas loads all S rows ahead
    // of the compares and spills at S = 32
#pragma unroll 8
    for (int s = 0; s < S; ++s) {
      const int row = t[s * COLS + j];
#pragma unroll
      for (int k = 0; k < PER; ++k) v[k] = (m[k] == s) ? row : v[k];
    }
#pragma unroll
    for (int k = 0; k < PER; ++k) acc[k] += v[k];
  } else {
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int i = g + G * k;
      const int x = x0[k] ^ r;
      if constexpr (MODE == GM1_EMPTY) {
        acc[k] += x;
      } else if constexpr (MODE == GM1_LANE) {
        acc[k] += t[i * COLS + (x & 127)];
      } else if constexpr (MODE == GM1_LANE2) {
        acc[k] += t[((x >> 7) & 1) * band + i * COLS + (x & 127)];
      } else {
        acc[k] += t[floor_mod<S>(x) * COLS + j];
      }
    }
  }
}

// K3a.  tab (C, 128, 128), idx (64, 128), out (tiles, 64, 128); int32.
// Block b computes rows [i0, i0 + R) of tile b / (64 / R).
template <int MODE, int S>
__global__ void __launch_bounds__(max_threads_k3a(MODE))
gm1_kernel(const int* __restrict__ tab, const int* __restrict__ idx,
           int* __restrict__ out, int R) {
  constexpr int PER = per_k3a(MODE);
  extern __shared__ __align__(16) int sm[];
  const int G = blockDim.x / COLS;
  const int bands = ROWS / R;
  const int i0 = (blockIdx.x % bands) * R;
  const int j = threadIdx.x % COLS, g = threadIdx.x / COLS;
  const int band = R * COLS;
  const int tab_words = words_k3a(MODE, S, R) / C;
  if constexpr (MODE != GM1_EMPTY) {
    for (int c = 0; c < C; ++c) {
      const int* t = tab + c * TAB_ROWS * COLS;
      int* d = sm + c * tab_words;
      if constexpr (MODE == GM1_LANE || MODE == GM1_LANE2) {
        copy_async(d, t + i0 * COLS, band);
        if constexpr (MODE == GM1_LANE2)
          copy_async(d + band, t + (ROWS + i0) * COLS, band);
      } else {
        copy_async(d, t, S * COLS);
      }
      __pipeline_commit();
    }
  }
  int x0[PER], acc[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    x0[k] = __ldg(idx + (i0 + g + G * k) * COLS + j);
    acc[k] = 0;
  }
  // the first C reps: table r has landed once all but the C-1-r groups
  // committed after it are done
#pragma unroll
  for (int r = 0; r < C; ++r) {
    if constexpr (MODE != GM1_EMPTY) {
      __pipeline_wait_prior(C - 1 - r);
      __syncthreads();
    }
    rep_k3a<MODE, S, PER>(sm + r * tab_words, r, g, G, j, band, x0, acc);
  }
#pragma unroll 1
  for (int r = C; r < REPS; ++r)
    rep_k3a<MODE, S, PER>(sm + (r % C) * tab_words, r, g, G, j, band, x0,
                          acc);
  int* o = out + (size_t)(blockIdx.x / bands) * TILE + i0 * COLS;
#pragma unroll
  for (int k = 0; k < PER; ++k) o[(g + G * k) * COLS + j] = acc[k];
}

// The windows of every rep into win[0][r], win[1][r] (chain modes: kk and
// kk + 2), by the block's first REPS threads.
template <int MODE>
__device__ __forceinline__ void rep_windows(const int* __restrict__ k0,
                                            int (*win)[REPS]) {
  const int r = threadIdx.x;
  if (r >= REPS) return;
  int w0 = r % K, w1 = r % K;
  if constexpr (MODE == GM2_DYN_READ || MODE == GM2_DYN_TAKE ||
                MODE == GM2_DYN_TAKE2) {
    const int kr = __ldg(k0 + r);
    w0 = window(kr);
    w1 = window(wrap_add(kr, 2));
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
    w0 = min(max(wrap_add(kr, kr0), 0), K - 3);
    w1 = w0 + 2;
  }
  win[0][r] = w0;
  win[1][r] = w1;
}

// Starts the copies of rep r's window bands (rows [i0, i0 + R) of
// tab[r % C, win[.][r]]) into the ring's stage r % NS, and commits the
// group (an empty one past the last rep, so the waits count alike).
template <int NWIN>
__device__ __forceinline__ void start_windows(int* sm,
                                              const int* __restrict__ tab,
                                              int (*win)[REPS], int r,
                                              int i0, int band) {
  if (r < REPS) {
    const int* tc = tab + ((size_t)(r % C) * K * ROWS + i0) * COLS;
    int* d = sm + (r % NS) * NWIN * band;
    copy_async(d, tc + win[0][r] * TILE, band);
    if constexpr (NWIN == 2) copy_async(d + band, tc + win[1][r] * TILE, band);
  }
  __pipeline_commit();
}

// K3b.  k0 (64,), tab (C, K, 64, 128), idx (64, 128), out (tiles, 64, 128);
// int32.  Block b computes rows [i0, i0 + R) of tile b / (64 / R).
template <int MODE>
__global__ void __launch_bounds__(MAX_THREADS)
gm2_kernel(const int* __restrict__ k0, const int* __restrict__ tab,
           const int* __restrict__ idx, int* __restrict__ out, int R) {
  constexpr int PER = PER_K3B;
  constexpr int NWIN = windows_k3b(MODE);
  extern __shared__ __align__(16) int sm[];
  __shared__ int win[2][REPS];
  const int G = blockDim.x / COLS;
  const int bands = ROWS / R;
  const int i0 = (blockIdx.x % bands) * R;
  const int j = threadIdx.x % COLS, g = threadIdx.x / COLS;
  const int band = R * COLS;
  rep_windows<MODE>(k0, win);
  __syncthreads();
  if constexpr (NWIN > 0) {
    for (int r = 0; r < NS - 1; ++r)
      start_windows<NWIN>(sm, tab, win, r, i0, band);
  }
  int x0[PER], acc[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    x0[k] = __ldg(idx + (i0 + g + G * k) * COLS + j);
    acc[k] = 0;
  }
#pragma unroll UNROLL_K3B
  for (int r = 0; r < REPS; ++r) {
    if constexpr (NWIN > 0) {
      // rep r's group is done once at most NS - 2 later ones are pending;
      // past the barrier every thread has also left rep r - 1, whose stage
      // rep r + NS - 1 now takes
      __pipeline_wait_prior(NS - 2);
      __syncthreads();
      start_windows<NWIN>(sm, tab, win, r + NS - 1, i0, band);
    }
    const int* st = sm + (r % NS) * NWIN * band;
    const int kk = win[0][r];
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int i = g + G * k;
      const int x = x0[k] ^ r;
      if constexpr (MODE == GM2_EMPTY) {
        acc[k] += x;
      } else if constexpr (MODE == GM2_STATIC_READ || MODE == GM2_DYN_READ) {
        acc[k] += st[i * COLS + j] + x;
      } else if constexpr (MODE == GM2_STATIC_TAKE || MODE == GM2_DYN_TAKE) {
        acc[k] += st[i * COLS + (x & 127)];
      } else if constexpr (MODE == GM2_DYN_TAKE2) {
        acc[k] += st[((x >> 7) & 1) * band + i * COLS + (x & 127)];
      } else if constexpr (MODE == GM2_CHAIN_ONLY) {
        acc[k] += x + kk;
      } else {
        const int relv = wrap_add(x, -64 * kk);
        acc[k] += st[((relv >> 7) == 1 ? band : 0) + i * COLS + (relv & 127)];
      }
    }
  }
  int* o = out + (size_t)(blockIdx.x / bands) * TILE + i0 * COLS;
#pragma unroll
  for (int k = 0; k < PER; ++k) o[(g + G * k) * COLS + j] = acc[k];
}

// The K3a kernel of (mode, S), or null if none.
const void* gm1_kernel_for(int mode, int S) {
  switch (mode) {
    case GM1_EMPTY: return (const void*)gm1_kernel<GM1_EMPTY, 1>;
    case GM1_LANE: return (const void*)gm1_kernel<GM1_LANE, 1>;
    case GM1_LANE2: return (const void*)gm1_kernel<GM1_LANE2, 1>;
    case GM1_SUBLANE:
      switch (S) {
        case 8: return (const void*)gm1_kernel<GM1_SUBLANE, 8>;
        case 16: return (const void*)gm1_kernel<GM1_SUBLANE, 16>;
        case 32: return (const void*)gm1_kernel<GM1_SUBLANE, 32>;
      }
      return nullptr;
    case GM1_SELECT:
      switch (S) {
        case 8: return (const void*)gm1_kernel<GM1_SELECT, 8>;
        case 16: return (const void*)gm1_kernel<GM1_SELECT, 16>;
        case 24: return (const void*)gm1_kernel<GM1_SELECT, 24>;
        case 32: return (const void*)gm1_kernel<GM1_SELECT, 32>;
      }
      return nullptr;
  }
  return nullptr;
}

// The K3b kernel of a mode, or null if none.
const void* gm2_kernel_for(int mode) {
  switch (mode) {
    case GM2_EMPTY: return (const void*)gm2_kernel<GM2_EMPTY>;
    case GM2_STATIC_READ: return (const void*)gm2_kernel<GM2_STATIC_READ>;
    case GM2_DYN_READ: return (const void*)gm2_kernel<GM2_DYN_READ>;
    case GM2_STATIC_TAKE: return (const void*)gm2_kernel<GM2_STATIC_TAKE>;
    case GM2_DYN_TAKE: return (const void*)gm2_kernel<GM2_DYN_TAKE>;
    case GM2_DYN_TAKE2: return (const void*)gm2_kernel<GM2_DYN_TAKE2>;
    case GM2_CHAIN_TAKE2: return (const void*)gm2_kernel<GM2_CHAIN_TAKE2>;
    case GM2_CHAIN_ONLY: return (const void*)gm2_kernel<GM2_CHAIN_ONLY>;
  }
  return nullptr;
}

// Is (R, smem) a band plan of a kernel with `per` elements a thread and at
// most `max_threads` threads that needs `need` bytes?
bool plan_ok(int R, int per, int max_threads, int smem, int need) {
  return R >= per && R <= ROWS && ROWS % R == 0 && R % per == 0 &&
         R / per * COLS <= max_threads && need >= 0 && smem == need;
}

// Resident blocks per SM of `fn` at the plan, or a negative CUDA error code.
int blocks_per_sm(const void* fn, int threads, int smem) {
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return -(int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads,
                                                      smem);
  return err == cudaSuccess ? blocks : -(int)err;
}

// Launches `fn` on `tiles` tiles in bands of R rows.  A kernel may use more
// than 48 KB of dynamic shared memory only once its attribute says so.
int launch(const void* fn, int tiles, int R, int per, int smem,
           cudaStream_t s, void** args) {
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernel(fn, dim3(tiles * (ROWS / R)), dim3(R / per * COLS),
                         args, (size_t)smem, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// Bytes of dynamic shared memory a K3a block of R rows needs (-1: no such
// kernel), the elements of one of its threads, and the same for K3b.
extern "C" int paris_gm1_smem(int mode, int S, int R) {
  if (gm1_kernel_for(mode, S) == nullptr) return -1;
  return 4 * words_k3a(mode, S, R);
}
extern "C" int paris_gm1_per(int mode) { return per_k3a(mode); }
extern "C" int paris_gm1_max_threads(int mode) {
  return max_threads_k3a(mode);
}
extern "C" int paris_gm2_smem(int mode, int R) {
  if (gm2_kernel_for(mode) == nullptr) return -1;
  return 4 * NS * windows_k3b(mode) * R * COLS;
}
extern "C" int paris_gm2_per() { return PER_K3B; }
extern "C" int paris_gm_ring() { return NS; }

// Resident blocks per SM of a K3a / K3b kernel at a band plan
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or a negative CUDA error
// code.
extern "C" int paris_gm1_blocks_per_sm(int device, int mode, int S, int R,
                                       int smem) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return -(int)err;
  const void* fn = gm1_kernel_for(mode, S);
  if (fn == nullptr || !plan_ok(R, per_k3a(mode), max_threads_k3a(mode),
                                smem, 4 * words_k3a(mode, S, R)))
    return -(int)cudaErrorInvalidValue;
  return blocks_per_sm(fn, R / per_k3a(mode) * COLS, smem);
}
extern "C" int paris_gm2_blocks_per_sm(int device, int mode, int R,
                                       int smem) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return -(int)err;
  const void* fn = gm2_kernel_for(mode);
  if (fn == nullptr ||
      !plan_ok(R, PER_K3B, MAX_THREADS, smem, paris_gm2_smem(mode, R)))
    return -(int)cudaErrorInvalidValue;
  return blocks_per_sm(fn, R / PER_K3B * COLS, smem);
}

// Launches one K3a kernel on `stream`: `blocks` tiles in bands of R rows
// with `smem` bytes of dynamic shared memory.  Returns 0 once launched, the
// CUDA error of a launch the card refuses, or cudaErrorInvalidValue for a
// mode, S or block count that has no kernel and for an (R, smem) that is
// not what the kernel needs.
extern "C" int paris_gm1_launch(int device, void* stream, int mode, int S,
                                const int* tab, const int* idx, int* out,
                                int blocks, int R, int smem) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const void* fn = gm1_kernel_for(mode, S);
  if (fn == nullptr || blocks < 1 ||
      !plan_ok(R, per_k3a(mode), max_threads_k3a(mode), smem,
               4 * words_k3a(mode, S, R)))
    return (int)cudaErrorInvalidValue;
  void* args[] = {&tab, &idx, &out, &R};
  return launch(fn, blocks, R, per_k3a(mode), smem,
                static_cast<cudaStream_t>(stream), args);
}

// Launches one K3b kernel on `stream`; returns as paris_gm1_launch does.
extern "C" int paris_gm2_launch(int device, void* stream, int mode,
                                const int* k0, const int* tab, const int* idx,
                                int* out, int blocks, int R, int smem) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const void* fn = gm2_kernel_for(mode);
  if (fn == nullptr || blocks < 1 ||
      !plan_ok(R, PER_K3B, MAX_THREADS, smem, paris_gm2_smem(mode, R)))
    return (int)cudaErrorInvalidValue;
  void* args[] = {&k0, &tab, &idx, &out, &R};
  return launch(fn, blocks, R, PER_K3B, smem,
                static_cast<cudaStream_t>(stream), args);
}

extern "C" const char* paris_gm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
