// Voxel-driven FDK backprojection for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel paris_tpu/ops/backprojection_pallas.py:_bp_kernel
// (launched by backproject_chunk_pallas_yxz).  Same contract: for each voxel
// of a (dz, ny, nx) z-block at global index (rx1 + x, ry1 + y, z0 + z),
//   s = x cos + y sin,  t = -x sin + y cos,  f = d_sd / (s + d_so)
//   h = (t f - h_min) / l_px_row - 1/2,  v = (z f - v_min) / l_px_col - 1/2
//   vol += sum_c 1/2 (d_so / (s + d_so))^2 * bilinear(P_c, v, h)
// where the bilinear sample is 0 when any corner is off the detector, and a
// voxel with s + d_so <= 1e-3 |d_so| adds 0.  The plain version of this
// kernel is paris_tpu_torch/ops/backprojection_torch.py.
//
// What bounds it on this card: per voxel update about 15 f32 operations
// (the v coordinate, the bilinear lerp, the weight and the add) and four
// taps (two horizontally adjacent pixels in each of two detector rows); the
// volume is read and written once per chunk of C projections, which
// amortises its bytes C-fold.  So the bound is arithmetic (about 2 ms for a
// (512, 1024, 1024) block at C = 16 on the card's 67 TFLOP/s), and what the
// kernel must do is keep the issue slots busy: the taps must not stall.
//
// What the design does about that.  One thread owns one (x, y) column and
// ZR consecutive z slices, accumulated in registers; a block is 32 (x) by
// BY (y) threads by ZR slices.  Per angle the z-invariant work (s, t, the
// source clamp, the magnification, the FDK weight, the h tap and its
// fraction) is done once for the ZR slices.
//  * Footprint tiles.  The detector pixels a block reads for one angle lie
//    in a small rectangle (about 40 x 24 pixels at the 1024-class geometry).
//    In a prologue one thread per angle bounds it from the block's corners
//    (corner_footprint).  The rectangle is then copied into shared memory,
//    and every tap reads shared memory with a 32-bit offset.
//  * Asynchronous copies.  The copies are cp.async (16 B, through the
//    cuda_pipeline primitives) into a ring of NS tiles: while angle c
//    accumulates, the tiles of angles c+1 .. c+NS-1 are in flight.  Where a
//    row's bytes are not 16-B aligned (n_row * sizeof(T) % 16 != 0), the
//    block copies element by element instead, synchronously.
//  * A branch-free z step.  The detector-border test on v becomes a 0/1
//    factor on the weight, and the tap row is clamped into the tile, so the
//    ZR slices' loads issue back to back.
//  * An interior z step.  v grows with z, so where the first and the last
//    slice of a thread's ZR are on the detector and in the tile, every
//    slice is: that z step drops the factor and the clamps.
//  * A register budget: __launch_bounds__(threads, 4), 64 registers at
//    256 threads, so four blocks share an SM.
//  * No ring fits.  Where no block shape's ring fits the shared memory (a
//    volume reaching close to the source, voxels many detector pixels
//    wide), the COPY_GLOBAL instantiation stages nothing: its taps read the
//    band in global memory through L1, as the first, untiled kernel did,
//    with the same z steps.
// The wrapper (ops/backprojection_cuda.py) bounds the tile of every (block,
// angle) on the host from the geometry, picks the largest block shape whose
// ring fits the shared memory (else COPY_GLOBAL), and passes the tile's
// pitch and height; the kernel clamps every copy and tap into them.
//
// Numerics are those of the first, untiled kernel: the coordinates that
// decide a floor or the border test (s, t, f, h, v) are computed with
// explicitly rounded intrinsics (__fmul_rn, __fadd_rn, __fsub_rn,
// __frcp_rn), which nvcc never contracts into an FMA.  They round like the
// separate tensor operations of the plain version, so both pick the same
// taps and differ only by the rounding of the lerp, which is written as
// before.
//
// Projections arrive as (C, vp, n_row) contiguous, float (exact mode) or
// bf16 (fast mode, widened to f32 per tap); the accumulator is (dz, ny, nx)
// contiguous with x minor and is updated in place.
//
// Detector-row band (the Pallas kernel's offs[3], backprojection_pallas.py:
// 386, :546-555): the vp rows of a frame are detector rows [v_lo, v_lo + vp).
// The border test still runs on the whole detector (0 <= floor(v) <=
// n_col - 2); the tap row floor(v) - v_lo is clamped into [0, vp - 2], so a
// band that misses a block reads wrong rows of the buffer but never outside
// it.  v_lo = 0, vp = n_col is the unbanded kernel.

#include <cfloat>
#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int BX = 32;     // threads along x: one warp per row of y
constexpr int NS = 3;      // tiles in the ring
constexpr int VEC = 16;    // bytes per asynchronous copy

// How a launch's taps reach the projections: staged into the ring element
// by element or by cp.async, or read from global memory (no ring fits).
constexpr int COPY_ELEMENT = 0, COPY_ASYNC = 1, COPY_GLOBAL = 2;

struct BpParams {
  int C, n_col, n_row, vp, v_lo;
  int dz, ny, nx;
  int rx1, ry1, z0;
  float off_x, off_y, off_z;
  float l_vx_x, l_vx_y, l_vx_z;
  float d_so, d_sd, safe_min;
  float h_min, inv_lpr, inv_lpc, vb;
  int pitch, tile_h;       // tile row pitch and height, in elements / rows
  int by;                  // the block's rows of y
};

__device__ __forceinline__ float widen(float q) { return q; }
__device__ __forceinline__ float widen(__nv_bfloat16 q) {
  return __bfloat162float(q);
}
__device__ __forceinline__ float ldg(const float* q) { return __ldg(q); }
__device__ __forceinline__ float ldg(const __nv_bfloat16* q) {
  return __bfloat162float(
      __ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(q))));
}

// The per-angle, z-invariant quantities of one column.
struct Angle {
  bool ok;          // in front of the source and on the detector in h
  int h0;           // left tap column
  float fh, w, fscale;
};

__device__ __forceinline__ Angle angle_of(const BpParams& p, float xm,
                                          float ym, float sn, float cs) {
  Angle a;
  const float s = __fadd_rn(__fmul_rn(xm, cs), __fmul_rn(ym, sn));
  const float t = __fadd_rn(__fmul_rn(-xm, sn), __fmul_rn(ym, cs));
  const float denom = __fadd_rn(s, p.d_so);
  const bool front = denom > p.safe_min;          // not at or behind the source
  const float inv = __frcp_rn(denom);
  const float factor = __fmul_rn(inv, p.d_sd);
  const float u = __fmul_rn(inv, p.d_so);
  a.w = 0.5f * (u * u);
  const float h = __fsub_rn(
      __fmul_rn(__fsub_rn(__fmul_rn(t, factor), p.h_min), p.inv_lpr), 0.5f);
  const float h0f = floorf(h);
  a.ok = front && h0f >= 0.f && h0f <= (float)(p.n_row - 2);
  a.h0 = (int)h0f;
  a.fh = __fsub_rn(h, h0f);
  a.fscale = __fmul_rn(factor, p.inv_lpc);
  return a;
}

// Footprint of one angle: the first tile column (aligned down for the
// copies), the first band row, and the tile's width and height.
struct Footprint { int col0, row0, width, height; };

// The footprint of one angle on a block whose voxels span x0 .., y0 ..
// and nz slices from z-block slice zb, as (first tile column, first band
// row, width, height).  The projection of a box lies in the hull of its
// corners' projections (h and v are linear-fractional in x, y, z while
// every voxel is in front of the source), so the corner voxels' h and v,
// widened by one pixel for the float32 rounding of the others, bound every
// tap: columns floor(h) .. +1 and band rows floor(v) - v_lo .. +1, clamped
// as the taps are.  A corner at or behind the source takes the whole band.
// The width is aligned for the copies and, like the height, clamped into
// the planned tile (a no-op where the host's bound holds).
__device__ int4 corner_footprint(const BpParams& p, int x0, int y0, int zb,
                                 int nz, float sn, float cs, int align) {
  float h_min = FLT_MAX, h_max = -FLT_MAX, v_min = FLT_MAX, v_max = -FLT_MAX;
  bool front = true;
  const int xs[2] = {x0, min(x0 + BX - 1, p.nx - 1)};
  const int zs[2] = {zb, zb + nz - 1};
  for (int iy = 0; iy < 2; ++iy) {
    const int y = iy ? min(y0 + p.by - 1, p.ny - 1) : y0;
    const float ym = __fadd_rn(__fmul_rn((float)(p.ry1 + y), p.l_vx_y),
                               p.off_y);
    for (int ix = 0; ix < 2; ++ix) {
      const float xm = __fadd_rn(__fmul_rn((float)(p.rx1 + xs[ix]), p.l_vx_x),
                                 p.off_x);
      const float s = __fadd_rn(__fmul_rn(xm, cs), __fmul_rn(ym, sn));
      const float t = __fadd_rn(__fmul_rn(-xm, sn), __fmul_rn(ym, cs));
      const float denom = __fadd_rn(s, p.d_so);
      front = front && denom > p.safe_min;
      const float factor = __fmul_rn(__frcp_rn(denom), p.d_sd);
      const float h = __fsub_rn(
          __fmul_rn(__fsub_rn(__fmul_rn(t, factor), p.h_min), p.inv_lpr),
          0.5f);
      h_min = fminf(h_min, h);
      h_max = fmaxf(h_max, h);
      const float fscale = __fmul_rn(factor, p.inv_lpc);
      for (int iz = 0; iz < 2; ++iz) {
        const float zm = __fadd_rn(
            __fmul_rn((float)(p.z0 + zs[iz]), p.l_vx_z), p.off_z);
        const float v = __fadd_rn(__fmul_rn(zm, fscale), p.vb);
        v_min = fminf(v_min, v);
        v_max = fmaxf(v_max, v);
      }
    }
  }
  int c_lo = 0, c_hi = p.n_row - 2, r_lo = 0, r_hi = p.vp - 2;
  if (front) {
    const float hl = floorf(h_min) - 1.f, hh = floorf(h_max) + 1.f;
    if (hh < 0.f || hl > (float)(p.n_row - 2)) {
      return make_int4(0, 0, 0, 0);        // no voxel is on the detector
    }
    c_lo = max((int)hl, 0);
    c_hi = min((int)hh, p.n_row - 2);
    r_lo = min(max((int)fmaxf(floorf(v_min) - 1.f, -1.f) - p.v_lo, 0),
               p.vp - 2);
    r_hi = min(max((int)fminf(floorf(v_max) + 1.f, (float)p.n_col) - p.v_lo,
                   0), p.vp - 2);
  }
  const int col0 = c_lo & ~(align - 1);
  const int width = min((c_hi + 2 - col0 + align - 1) & ~(align - 1),
                        p.pitch);
  return make_int4(col0, r_lo, width, min(r_hi + 2 - r_lo, p.tile_h));
}

// The four taps of one voxel at tile offset i: (h, h+1) in the upper row
// and in the lower row.
struct Quad { float q11, q21, q12, q22; };

template <bool GLOBAL, typename T>
__device__ __forceinline__ Quad taps(const T* tile, int i, int pitch) {
  if constexpr (GLOBAL) {
    return Quad{ldg(tile + i), ldg(tile + i + 1), ldg(tile + i + pitch),
                ldg(tile + i + pitch + 1)};
  } else {
    return Quad{widen(tile[i]), widen(tile[i + 1]), widen(tile[i + pitch]),
                widen(tile[i + pitch + 1])};
  }
}

template <typename T, int COPY>
__device__ __forceinline__ void stage(const BpParams& p, const T* frame,
                                      const Footprint& fp, T* tile, int tid,
                                      int nthreads) {
  const T* src = frame + (size_t)fp.row0 * p.n_row + fp.col0;
  if constexpr (COPY == COPY_ASYNC) {
    constexpr int E = VEC / sizeof(T);            // elements per copy
    const int per_row = fp.width / E;
    const int n = fp.height * per_row;
    for (int i = tid; i < n; i += nthreads) {
      const int r = i / per_row, j = (i - r * per_row) * E;
      __pipeline_memcpy_async(tile + r * p.pitch + j,
                              src + (size_t)r * p.n_row + j, VEC);
    }
  } else {
    const int n = fp.height * fp.width;
    for (int i = tid; i < n; i += nthreads) {
      const int r = i / fp.width, j = i - r * fp.width;
      tile[r * p.pitch + j] = src[(size_t)r * p.n_row + j];
    }
  }
}

template <typename T, int BY, int ZR, int COPY>
__global__ void __launch_bounds__(BX * BY, 4)
bp_kernel(float* __restrict__ vol, const T* __restrict__ proj,
          const float* __restrict__ sinp, const float* __restrict__ cosp,
          const BpParams p) {
  constexpr bool GLOBAL = COPY == COPY_GLOBAL;
  extern __shared__ __align__(16) unsigned char smem[];
  int4* fps = reinterpret_cast<int4*>(smem);                   // C of them
  const int head = (16 * p.C + 127) & ~127;
  T* tiles = reinterpret_cast<T*>(smem + head);
  const int tile_elems = p.tile_h * p.pitch;

  const int tid = threadIdx.y * BX + threadIdx.x;
  constexpr int NT = BX * BY;
  const int x = blockIdx.x * BX + threadIdx.x;
  const int y = blockIdx.y * BY + threadIdx.y;
  const int zb = blockIdx.z * ZR;
  const bool active = x < p.nx && y < p.ny;
  const int nz = min(ZR, p.dz - zb);
  const size_t plane = (size_t)p.ny * p.nx;
  float* col = vol + (size_t)zb * plane + (size_t)y * p.nx + x;

  float acc[ZR];
  float zm[ZR];
#pragma unroll
  for (int k = 0; k < ZR; ++k) {
    acc[k] = (active && k < nz) ? col[k * plane] : 0.f;
    zm[k] = __fadd_rn(__fmul_rn((float)(p.z0 + zb + k), p.l_vx_z), p.off_z);
  }
  const float xm = __fadd_rn(__fmul_rn((float)(p.rx1 + x), p.l_vx_x), p.off_x);
  const float ym = __fadd_rn(__fmul_rn((float)(p.ry1 + y), p.l_vx_y), p.off_y);
  const size_t frame = (size_t)p.vp * p.n_row;
  const float v_last = (float)(p.n_col - 2);   // last valid upper tap

  // The footprint of angle c; without a ring, the whole band.
  auto footprint = [&](int c) {
    if constexpr (GLOBAL) return Footprint{0, 0, p.n_row, p.vp};
    const int4 r = fps[c];
    return Footprint{r.x, r.y, r.z, r.w};
  };
  if constexpr (!GLOBAL) {
    // -- prologue: the footprint of every angle, from the block's corners -
    constexpr int ALIGN = COPY == COPY_ASYNC ? VEC / (int)sizeof(T) : 1;
    for (int c = tid; c < p.C; c += NT) {
      fps[c] = corner_footprint(p, blockIdx.x * BX, blockIdx.y * BY, zb, nz,
                                __ldg(sinp + c), __ldg(cosp + c), ALIGN);
    }
    __syncthreads();
    for (int c = 0; c < NS - 1; ++c) {      // NS - 1 groups, some empty
      if (c < p.C) {
        stage<T, COPY>(p, proj + c * frame, footprint(c),
                       tiles + c * tile_elems, tid, NT);
      }
      __pipeline_commit();
    }
  }

  // -- main loop: accumulate angle c while angles c+1 .. c+NS-1 land.  One
  // barrier per angle: it shows angle c's tile landed for every thread, and
  // that every thread is done with angle c-1, whose slot is staged next. ---
  for (int c = 0; c < p.C; ++c) {
    const T* tile;
    if constexpr (GLOBAL) {
      tile = proj + c * frame;
    } else {
      __pipeline_wait_prior(NS - 2);
      __syncthreads();
      const int ahead = c + NS - 1;
      if (ahead < p.C) {
        stage<T, COPY>(p, proj + ahead * frame, footprint(ahead),
                       tiles + (ahead % NS) * tile_elems, tid, NT);
      }
      __pipeline_commit();
      tile = tiles + (c % NS) * tile_elems;
    }
    const Footprint fp = footprint(c);
    const Angle a = angle_of(p, xm, ym, __ldg(sinp + c), __ldg(cosp + c));
    if (!(active && a.ok)) continue;
    const int tc = min(max(a.h0 - fp.col0, 0), p.pitch - 2);
    const int row_base = p.v_lo + fp.row0;         // detector row of tile row 0
    const int row_max = fp.height - 2;
    // v grows with z, so when the first and the last of the ZR slices are on
    // the detector and inside the tile, all are: no border factor, no clamp.
    const int ra = (int)floorf(__fadd_rn(__fmul_rn(zm[0], a.fscale), p.vb));
    const int rb = (int)floorf(
        __fadd_rn(__fmul_rn(zm[ZR - 1], a.fscale), p.vb));
    const int r_lo = min(ra, rb), r_hi = max(ra, rb);
    if (r_lo >= 0 && r_hi <= p.n_col - 2 && r_lo >= row_base &&
        r_hi - row_base <= row_max) {
      const int base = tc - row_base * p.pitch;
#pragma unroll
      for (int k = 0; k < ZR; ++k) {
        const float v = __fadd_rn(__fmul_rn(zm[k], a.fscale), p.vb);
        const float v0f = floorf(v);
        const float fv = __fsub_rn(v, v0f);
        const Quad q = taps<GLOBAL>(tile, (int)v0f * p.pitch + base, p.pitch);
        const float top = q.q11 * (1.f - a.fh) + q.q21 * a.fh;
        const float bot = q.q12 * (1.f - a.fh) + q.q22 * a.fh;
        acc[k] += a.w * (top * (1.f - fv) + bot * fv);
      }
      continue;
    }
#pragma unroll
    for (int k = 0; k < ZR; ++k) {
      const float v = __fadd_rn(__fmul_rn(zm[k], a.fscale), p.vb);
      const float v0f = floorf(v);
      const float wk = a.w * (v0f >= 0.f && v0f <= v_last ? 1.f : 0.f);
      const float fv = __fsub_rn(v, v0f);
      const int tr = min(max((int)v0f - row_base, 0), row_max);
      const Quad q = taps<GLOBAL>(tile, tr * p.pitch + tc, p.pitch);
      const float top = q.q11 * (1.f - a.fh) + q.q21 * a.fh;
      const float bot = q.q12 * (1.f - a.fh) + q.q22 * a.fh;
      acc[k] += wk * (top * (1.f - fv) + bot * fv);
    }
  }
  if (!active) return;
#pragma unroll
  for (int k = 0; k < ZR; ++k) {
    if (k < nz) col[k * plane] = acc[k];
  }
}

// The compiled kernels: block shape (BY, ZR) x projection type x copy mode;
// COPY_GLOBAL only with the largest shape, which the planner gives it.
struct Shape { int by, zr; };
constexpr Shape SHAPES[] = {{8, 16}, {4, 8}};
constexpr int N_SHAPES = sizeof(SHAPES) / sizeof(SHAPES[0]);

template <typename T, int BY, int ZR>
const void* staged(int copy) {
  if (copy == COPY_ASYNC) {
    return (const void*)bp_kernel<T, BY, ZR, COPY_ASYNC>;
  }
  if (copy == COPY_ELEMENT) {
    return (const void*)bp_kernel<T, BY, ZR, COPY_ELEMENT>;
  }
  return nullptr;
}

// The kernel of (shape, projection type, copy mode), or null if none.
const void* kernel_for(int shape, int bf16, int copy) {
  if (copy == COPY_GLOBAL) {
    if (shape != 0) return nullptr;
    return bf16 ? (const void*)bp_kernel<__nv_bfloat16, 8, 16, COPY_GLOBAL>
                : (const void*)bp_kernel<float, 8, 16, COPY_GLOBAL>;
  }
  if (shape == 0) {
    return bf16 ? staged<__nv_bfloat16, 8, 16>(copy)
                : staged<float, 8, 16>(copy);
  }
  if (shape == 1) {
    return bf16 ? staged<__nv_bfloat16, 4, 8>(copy)
                : staged<float, 4, 8>(copy);
  }
  return nullptr;
}

}  // namespace

// The block shapes, largest first: writes (BX, BY, ZR) of shape i into
// out[3 i .. 3 i + 2] for i < n, returns the number of shapes.
extern "C" int paris_bp_shapes(int* out, int n) {
  for (int i = 0; i < N_SHAPES && i < n; ++i) {
    out[3 * i] = BX;
    out[3 * i + 1] = SHAPES[i].by;
    out[3 * i + 2] = SHAPES[i].zr;
  }
  return N_SHAPES;
}

// Tiles in the ring; a staged launch needs
// roundup(16 C, 128) + NS * tile_h * pitch * sizeof(T) bytes of shared
// memory, a COPY_GLOBAL launch none.
extern "C" int paris_bp_ring() { return NS; }

// Resident blocks per SM of one kernel at `smem` bytes of dynamic shared
// memory (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or a negative
// CUDA error code.
extern "C" int paris_bp_blocks_per_sm(int device, int shape, int proj_bf16,
                                      int copy, int smem) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return -(int)err;
  const void* fn = kernel_for(shape, proj_bf16, copy);
  if (fn == nullptr) return -(int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return -(int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, fn, BX * SHAPES[shape].by, smem);
  return err == cudaSuccess ? blocks : -(int)err;
}

// Launches one backprojection of C projections (vp detector rows from v_lo)
// into the accumulator on `stream`, with block shape `shape`, copy mode
// `copy` (COPY_ASYNC needs n_row * sizeof(T) and the projection pointer
// 16-B aligned), a ring of tiles of tile_h rows of `pitch` elements (for
// COPY_GLOBAL: pitch n_row, tile_h vp) and `smem` bytes of dynamic shared
// memory.  Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int paris_bp_launch(
    int device, void* stream, float* vol, const void* proj, int proj_bf16,
    const float* sinp, const float* cosp,
    int C, int n_col, int n_row, int vp, int v_lo, int dz, int ny, int nx,
    int rx1, int ry1, int z0,
    float off_x, float off_y, float off_z,
    float l_vx_x, float l_vx_y, float l_vx_z,
    float d_so, float d_sd, float safe_min,
    float h_min, float inv_lpr, float inv_lpc, float vb,
    int shape, int copy, int pitch, int tile_h, int smem) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const void* fn = kernel_for(shape, proj_bf16, copy);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  const BpParams p{C, n_col, n_row, vp, v_lo, dz, ny, nx, rx1, ry1, z0,
                   off_x, off_y, off_z, l_vx_x, l_vx_y, l_vx_z,
                   d_so, d_sd, safe_min, h_min, inv_lpr, inv_lpc, vb,
                   pitch, tile_h, SHAPES[shape].by};
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return (int)err;
  const int by = SHAPES[shape].by, zr = SHAPES[shape].zr;
  const dim3 block(BX, by, 1);
  const dim3 grid((nx + BX - 1) / BX, (ny + by - 1) / by, (dz + zr - 1) / zr);
  void* args[] = {&vol, &proj, &sinp, &cosp, const_cast<BpParams*>(&p)};
  err = cudaLaunchKernel(fn, grid, block, args, (size_t)smem,
                         static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" const char* paris_bp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
