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
// kernel must do is keep the issue slots busy: the taps must not stall, and
// each update must issue few instructions beyond its arithmetic.
//
// What the design does about that.  One thread owns one (x, y) column and
// ZR consecutive z slices, accumulated in registers; a block is 32 (x) by
// BY (y) threads by ZR slices.  Per angle the z-invariant work (s, t, the
// source clamp, the magnification, the FDK weight, the h tap and its
// fraction) is done once for the ZR slices.
//  * Footprint tiles.  The detector pixels a block reads for one angle lie
//    in a small rectangle (about 40 x 24 pixels at the 1024-class geometry).
//    In a prologue one thread per angle bounds it from the block's corners
//    (corner_footprint).  The rectangle is then copied into a tile of the
//    projections' type in shared memory, and every tap reads shared memory.
//    The wrapper plans the tile's pitch from the footprint's width, rounded
//    up to 128 B where the ring still fits, so rows lie a multiple of 32
//    banks apart.
//  * Copies.  Rows go by cp.async (16 B, the cuda_pipeline primitives)
//    into a ring of NS tiles: while angle c accumulates, the tiles of
//    angles c+1 .. c+NS-1 are in flight.  Where a row's bytes are not 16-B
//    aligned, the block copies element by element, synchronously.  A power
//    of two of threads shares a tile row, each keeping one column and
//    striding over the rows: no division per copy.  bf16 taps (fast mode)
//    are widened as they are read, which is exact.
//  * An interior z step with no conversion.  v grows with z, so where the
//    first and the last slice of a thread's ZR are on the detector and in
//    the tile, every slice is.  There 0 <= v < 2^22, and floor(v) is a
//    round-down add of 1.5 * 2^23 (the float's bits less 0x4B400000 are
//    the tap row), so the update issues no FRND or F2I: the row goes into
//    the one multiply-add that makes the upper taps' address, and the lower
//    taps are a pitch further.  Tiles of FAST_PITCH (64) elements, the
//    pitch of footprints up to 64 columns wide, have a kernel of their own
//    in which that pitch is a constant: the row is one shift-add and the
//    lower taps sit at an immediate offset, one instruction less an update.
//    SASS (cuobjdump -sass, sm_90a, shape 0, cp.async, FAST_PITCH): 17
//    instructions per interior update in float32 (FMUL, FADD for v;
//    FADD.RM, FADD, FADD for the floor and fv; LEA; 4 LDS; 7 for the lerps
//    and the accumulate), 21 in bf16 (4 widenings).
//  * A branch-free border z step for the rest.  The detector-border test
//    on v becomes a 0/1 factor on the weight, and the tap row is clamped
//    into the tile, so the ZR slices' loads issue back to back.  A last z
//    group of fewer than ZR slices repeats the block's last slice, so it
//    takes the interior step too.
//  * Taps in groups.  Both z steps load the taps of eight slices before
//    their lerps (accumulate), so that 32 loads are in flight together:
//    global taps, which wait on L1 and L2, take 30-47 % less time so, and
//    shared ones 1-8 %.
//  * A register budget: __launch_bounds__(threads, 4), 64 registers at
//    256 threads, so four blocks share an SM.
//  * No ring fits.  Where no block shape's ring fits the shared memory (a
//    volume reaching close to the source, voxels many detector pixels
//    wide), the COPY_GLOBAL instantiation stages nothing: its taps read the
//    band in global memory through L1, as the first, untiled kernel did,
//    with the same z steps.
// What bounds the z step now (scratch builds timed against this one):
// its four shared-memory loads and the lerps (with one load an update and
// the lerps folded away it runs 20 % faster; conflict-free addresses do
// not help), then the per-angle work spread over ZR updates (the angle's
// coordinates, the copies, the barrier).
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
// taps and differ only by the rounding of the lerp, written as a + f (b - a)
// with explicit FMAs (__fmaf_rn), so that every instantiation rounds it
// alike: one instruction an update less than the plain version's
// a (1 - f) + b f.
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

// 1.5 * 2^23: for 0 <= x < 2^22, x + ROUND rounded down is floor(x) + ROUND
// exactly, and its bits are FLOOR_BITS + floor(x).  The wrapper refuses a
// detector of more than 2^22 pixels a side, so every h and v that takes a
// tap lies in that range.
constexpr float ROUND = 12582912.0f;
constexpr unsigned FLOOR_BITS = 0x4B400000u;

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
  int lanes_lg;            // log2 of the threads sharing a tile row's copies
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
  // 0 <= floor(h) <= n_row - 2, i.e. 0 <= h < n_row - 1 (false for NaN);
  // there floor(h) comes from the round-down add, with no conversion
  a.ok = front && h >= 0.f && h < (float)(p.n_row - 1);
  const float sh = __fadd_rd(h, ROUND);
  a.h0 = (int)(__float_as_uint(sh) - FLOOR_BITS);
  a.fh = __fsub_rn(h, __fsub_rn(sh, ROUND));
  a.fscale = __fmul_rn(factor, p.inv_lpc);
  return a;
}

// Footprint of one angle: the first tile column (aligned down for the
// copies), the first band row, the tile's width and height, and the range
// [v_in, v_out) of v over which a slice takes the interior z step: its
// upper tap row is on the detector and in the tile.
struct __align__(16) Footprint {
  int col0, row0, width, height;
  float v_in, v_out;
};

__device__ __forceinline__ Footprint make_footprint(const BpParams& p,
                                                    int col0, int row0,
                                                    int width, int height) {
  const int base = p.v_lo + row0;      // detector row of tile row 0
  const int top = min(p.n_col - 2, base + height - 2);
  return Footprint{col0, row0, width, height, (float)max(base, 0),
                   (float)(top + 1)};
}

// The footprint of one angle on a block whose voxels span x0 .., y0 ..
// and nz slices from z-block slice zb.  The projection of a box lies in the
// hull of its corners' projections (h and v are linear-fractional in x, y,
// z while every voxel is in front of the source), so the corner voxels' h
// and v, widened by one pixel for the float32 rounding of the others, bound
// every tap: columns floor(h) .. +1 and band rows floor(v) - v_lo .. +1,
// clamped as the taps are.  A corner at or behind the source takes the
// whole band.  The width is aligned for the copies and, like the height,
// clamped into the planned tile (a no-op where the host's bound holds).
__device__ Footprint corner_footprint(const BpParams& p, int x0, int y0,
                                      int zb, int nz, float sn, float cs,
                                      int align) {
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
      return make_footprint(p, 0, 0, 0, 0);    // no voxel is on the detector
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
  return make_footprint(p, col0, r_lo, width,
                        min(r_hi + 2 - r_lo, p.tile_h));
}

// The four taps of one update: (h, h+1) in its upper row and in the row
// below.  Staged taps read the tile at a byte offset from the start of the
// block's shared memory, the lower row a pitch of bytes further; global
// taps read the band, at an element offset.
struct Quad { float q11, q21, q12, q22; };

template <typename T, int P>
struct SharedTaps {
  static constexpr unsigned col = sizeof(T);          // bytes
  unsigned pitch_bytes;                                // used where P == 0
  const unsigned char* base;
  __device__ __forceinline__ unsigned row() const {
    return P ? sizeof(T) * P : pitch_bytes;
  }
  __device__ __forceinline__ Quad operator()(unsigned off) const {
    const T* q = reinterpret_cast<const T*>(base + off);
    const T* l = reinterpret_cast<const T*>(base + off + row());
    return Quad{widen(q[0]), widen(q[1]), widen(l[0]), widen(l[1])};
  }
};

template <typename T>
struct GlobalTaps {
  static constexpr unsigned col = 1u;                 // elements
  unsigned n_row;
  const T* base;
  __device__ __forceinline__ unsigned row() const { return n_row; }
  __device__ __forceinline__ Quad operator()(unsigned off) const {
    const T* q = base + off;
    return Quad{ldg(q), ldg(q + 1), ldg(q + n_row), ldg(q + n_row + 1)};
  }
};

// acc + w * bilinear(q; fh, fv), each lerp as a + f (b - a)
__device__ __forceinline__ float update(float acc, const Quad& q, float fh,
                                        float fv, float w) {
  const float top = __fmaf_rn(fh, __fsub_rn(q.q21, q.q11), q.q11);
  const float bot = __fmaf_rn(fh, __fsub_rn(q.q22, q.q12), q.q12);
  return __fmaf_rn(w, __fmaf_rn(fv, __fsub_rn(bot, top), top), acc);
}

// Calls f(r, j) for the copies of a footprint, E elements each: rows
// r < height, columns j < width, j a multiple of E.  2^lanes_lg threads
// share a tile row (the wrapper's choice, from the pitch); each keeps its
// column and strides over the rows, so a copy costs no division, and the
// row loop is unrolled, so that a thread's copies issue back to back.
template <int E, int NT, typename F>
__device__ __forceinline__ void for_each_copy(const BpParams& p,
                                              const Footprint& fp, int tid,
                                              F&& f) {
  const int lanes = 1 << p.lanes_lg, rows = NT >> p.lanes_lg;
  for (int j = (tid & (lanes - 1)) * E; j < fp.width; j += lanes * E) {
#pragma unroll 4
    for (int r = tid >> p.lanes_lg; r < fp.height; r += rows) f(r, j);
  }
}

// Stages one angle's footprint into a tile of `pitch` elements: cp.async
// of 16 B, or element by element.  The footprint is taken by value: read
// through a reference into shared memory, which the copies write, it
// would be read again after every copy, and wait for it.
template <typename T, int NT, int COPY>
__device__ __forceinline__ void stage(const BpParams& p, const T* frame,
                                      const Footprint fp, T* tile, int pitch,
                                      int tid) {
  const T* src = frame + (size_t)fp.row0 * p.n_row + fp.col0;
  if constexpr (COPY == COPY_ASYNC) {
    for_each_copy<VEC / (int)sizeof(T), NT>(p, fp, tid, [&](int r, int j) {
      __pipeline_memcpy_async(tile + r * pitch + j,
                              src + (size_t)r * p.n_row + j, VEC);
    });
  } else {
    for_each_copy<1, NT>(p, fp, tid, [&](int r, int j) {
      tile[r * pitch + j] = src[(size_t)r * p.n_row + j];
    });
  }
}

// Accumulates the ZR updates of one column and angle.  slice(k, off, fv,
// w) gives slice k's tap offset, row fraction and weight.  The taps are
// loaded eight slices at a time before their lerps, so that a group's
// loads are in flight together (global taps are latency-bound, and shared
// ones gain too).
template <int ZR, typename Taps, typename Slice>
__device__ __forceinline__ void accumulate(float (&acc)[ZR],
                                           const Taps& taps, float fh,
                                           Slice&& slice) {
  constexpr int G = ZR < 8 ? ZR : 8;
#pragma unroll
  for (int g = 0; g < ZR; g += G) {
    Quad q[G];
    float fv[G], w[G];
#pragma unroll
    for (int k = 0; k < G; ++k) {
      unsigned off;
      slice(g + k, off, fv[k], w[k]);
      q[k] = taps(off);
    }
#pragma unroll
    for (int k = 0; k < G; ++k) {
      acc[g + k] = update(acc[g + k], q[k], fh, fv[k], w[k]);
    }
  }
}

// The z steps of one column and angle, over its ZR slices.  `col` is the
// offset of the angle's tap column in tile row 0, `row_base` the detector
// row of tile row 0, `row_max` the last tile row an upper tap may take.
//
// Interior: every slice's v lies in [v_in, v_out), so floor(v) is the
// round-down add's, the tap row its bits less FLOOR_BITS, folded into the
// one multiply-add that makes the tap offset.
template <int ZR, typename Taps>
__device__ __forceinline__ void z_interior(float (&acc)[ZR],
                                           const float (&zm)[ZR],
                                           const Angle& a, float vb,
                                           const Taps& taps, unsigned col,
                                           int row_base) {
  // opaque to the compiler, which would otherwise take the row back out
  // of it and pay a subtraction per update
  const unsigned row = taps.row();
  unsigned base;
  asm("mov.b32 %0, %1;" : "=r"(base)
      : "r"(col - (unsigned)row_base * row - FLOOR_BITS * row));
  accumulate(acc, taps, a.fh,
             [&](int k, unsigned& off, float& fv, float& w) {
    const float v = __fadd_rn(__fmul_rn(zm[k], a.fscale), vb);
    const float s = __fadd_rd(v, ROUND);
    fv = __fsub_rn(v, __fsub_rn(s, ROUND));
    off = __float_as_uint(s) * row + base;
    w = a.w;
  });
}

// Border: some slice is off the detector or outside the tile.  The border
// test on v is a 0/1 factor on the weight, the tap row is clamped into the
// tile, so the ZR slices' loads still issue back to back.
template <int ZR, typename Taps>
__device__ __forceinline__ void z_border(float (&acc)[ZR],
                                         const float (&zm)[ZR],
                                         const Angle& a, const BpParams& p,
                                         const Taps& taps, unsigned col,
                                         int row_base, int row_max) {
  const float v_last = (float)(p.n_col - 2);   // last valid upper tap
  accumulate(acc, taps, a.fh,
             [&](int k, unsigned& off, float& fv, float& w) {
    const float v = __fadd_rn(__fmul_rn(zm[k], a.fscale), p.vb);
    const float v0f = floorf(v);
    w = a.w * (v0f >= 0.f && v0f <= v_last ? 1.f : 0.f);
    fv = __fsub_rn(v, v0f);
    const int tr = min(max((int)v0f - row_base, 0), row_max);
    off = (unsigned)tr * taps.row() + col;
  });
}

template <int ZR, typename Taps>
__device__ __forceinline__ void z_steps(float (&acc)[ZR],
                                        const float (&zm)[ZR],
                                        const Angle& a, const BpParams& p,
                                        const Footprint& fp, const Taps& taps,
                                        unsigned origin, int tc) {
  const unsigned col = origin + (unsigned)tc * taps.col;
  const int row_base = p.v_lo + fp.row0;
  // v grows with z, so when the first and the last of the ZR slices are in
  // [v_in, v_out), all are
  const float va = __fadd_rn(__fmul_rn(zm[0], a.fscale), p.vb);
  const float vz = __fadd_rn(__fmul_rn(zm[ZR - 1], a.fscale), p.vb);
  if (fminf(va, vz) >= fp.v_in && fmaxf(va, vz) < fp.v_out) {
    z_interior(acc, zm, a, p.vb, taps, col, row_base);
  } else {
    z_border(acc, zm, a, p, taps, col, row_base, fp.height - 2);
  }
}

// One thread per (x, y) column and ZR slices; tiles of pitch P, or of the
// launch's pitch where P is 0.
template <typename T, int BY, int ZR, int P, int COPY>
__global__ void __launch_bounds__(BX * BY, 4)
bp_kernel(float* __restrict__ vol, const T* __restrict__ proj,
          const float* __restrict__ sinp, const float* __restrict__ cosp,
          const BpParams p) {
  constexpr bool GLOBAL = COPY == COPY_GLOBAL;
  constexpr int NT = BX * BY;
  extern __shared__ __align__(16) unsigned char smem[];
  Footprint* fps = reinterpret_cast<Footprint*>(smem);          // C of them
  const unsigned head = (sizeof(Footprint) * p.C + 127) & ~127u;
  T* tiles = reinterpret_cast<T*>(smem + head);
  const int pitch = P ? P : p.pitch;
  const int tile_elems = p.tile_h * pitch;
  const unsigned tile_bytes = sizeof(T) * tile_elems;

  const int tid = threadIdx.y * BX + threadIdx.x;
  const int x = blockIdx.x * BX + threadIdx.x;
  const int y = blockIdx.y * BY + threadIdx.y;
  const int zb = blockIdx.z * ZR;
  const bool active = x < p.nx && y < p.ny;
  const int nz = min(ZR, p.dz - zb);
  const size_t plane = (size_t)p.ny * p.nx;
  float* col = vol + (size_t)zb * plane + (size_t)y * p.nx + x;

  // slices past the block's end (a last z group of nz < ZR) repeat its
  // last slice, so that they read the taps its footprint holds and take
  // the interior z step with it; they are never written back
  float acc[ZR];
  float zm[ZR];
#pragma unroll
  for (int k = 0; k < ZR; ++k) {
    acc[k] = (active && k < nz) ? col[k * plane] : 0.f;
    zm[k] = __fadd_rn(__fmul_rn((float)(p.z0 + min(zb + k, p.dz - 1)),
                                p.l_vx_z), p.off_z);
  }
  const float xm = __fadd_rn(__fmul_rn((float)(p.rx1 + x), p.l_vx_x), p.off_x);
  const float ym = __fadd_rn(__fmul_rn((float)(p.ry1 + y), p.l_vx_y), p.off_y);
  const size_t frame = (size_t)p.vp * p.n_row;

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
        stage<T, NT, COPY>(p, proj + c * frame, fps[c],
                           tiles + c * tile_elems, pitch, tid);
      }
      __pipeline_commit();
    }
  }

  // -- main loop: accumulate angle c while angles c+1 .. c+NS-1 land.  One
  // barrier per angle: it shows angle c's tile landed for every thread, and
  // that every thread is done with angle c-1, whose slot is staged next. ---
  for (int c = 0; c < p.C; ++c) {
    Footprint fp;
    unsigned origin = 0;                   // tile offset in shared memory
    if constexpr (GLOBAL) {
      fp = make_footprint(p, 0, 0, p.n_row, p.vp);    // the whole band
    } else {
      __pipeline_wait_prior(NS - 2);
      __syncthreads();
      fp = fps[c];
      const int next = c + NS - 1;
      if (next < p.C) {
        stage<T, NT, COPY>(p, proj + next * frame, fps[next],
                           tiles + (next % NS) * tile_elems, pitch, tid);
      }
      __pipeline_commit();
      origin = head + (c % NS) * tile_bytes;
    }
    const Angle a = angle_of(p, xm, ym, __ldg(sinp + c), __ldg(cosp + c));
    if (active && a.ok) {
      if constexpr (GLOBAL) {
        const int tc = min(max(a.h0, 0), p.n_row - 2);
        z_steps(acc, zm, a, p, fp,
                GlobalTaps<T>{(unsigned)p.n_row, proj + c * frame}, 0u, tc);
      } else {
        const int tc = min(max(a.h0 - fp.col0, 0), pitch - 2);
        z_steps(acc, zm, a, p, fp,
                SharedTaps<T, P>{(unsigned)(sizeof(T) * pitch), smem}, origin,
                tc);
      }
    }
  }
  if (!active) return;
  // the stores' addresses, taken afresh: kept from the loads, they would
  // hold registers through the loop
  size_t step = plane;
  asm volatile("" : "+l"(step));
#pragma unroll
  for (int k = 0; k < ZR; ++k) {
    if (k < nz) col[k * step] = acc[k];
  }
}

// The compiled kernels: block shape (BY, ZR) x projection type x copy mode,
// at the launch's tile pitch; COPY_GLOBAL only with the largest shape,
// which the planner gives it.  The largest shape's cp.async kernel is also
// compiled for tiles of FAST_PITCH elements, the pitch the planner gives
// footprints of up to 64 columns (the 1024- and 2048-class geometries):
// there the tap row is one shift-add and the lower taps sit at an
// immediate offset from the upper ones.
struct Shape { int by, zr; };
constexpr Shape SHAPES[] = {{8, 16}, {4, 8}};
constexpr int N_SHAPES = sizeof(SHAPES) / sizeof(SHAPES[0]);
constexpr int FAST_PITCH = 64;

template <typename T, int BY, int ZR>
const void* staged(int copy, int pitch) {
  if (copy == COPY_ASYNC) {
    if constexpr (BY == SHAPES[0].by && ZR == SHAPES[0].zr) {
      if (pitch == FAST_PITCH) {
        return (const void*)bp_kernel<T, BY, ZR, FAST_PITCH, COPY_ASYNC>;
      }
    }
    return (const void*)bp_kernel<T, BY, ZR, 0, COPY_ASYNC>;
  }
  if (copy == COPY_ELEMENT) {
    return (const void*)bp_kernel<T, BY, ZR, 0, COPY_ELEMENT>;
  }
  return nullptr;
}

// The kernel of (shape, projection type, copy mode, tile pitch), or null
// if none.
const void* kernel_for(int shape, int bf16, int copy, int pitch) {
  if (copy == COPY_GLOBAL) {
    if (shape != 0) return nullptr;
    return bf16 ? (const void*)bp_kernel<__nv_bfloat16, 8, 16, 0, COPY_GLOBAL>
                : (const void*)bp_kernel<float, 8, 16, 0, COPY_GLOBAL>;
  }
  if (shape == 0) {
    return bf16 ? staged<__nv_bfloat16, 8, 16>(copy, pitch)
                : staged<float, 8, 16>(copy, pitch);
  }
  if (shape == 1) {
    return bf16 ? staged<__nv_bfloat16, 4, 8>(copy, pitch)
                : staged<float, 4, 8>(copy, pitch);
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
// roundup(32 C, 128) + NS * tile_h * pitch * sizeof(T) bytes of shared
// memory, a COPY_GLOBAL launch none.
extern "C" int paris_bp_ring() { return NS; }

// Resident blocks per SM of one kernel at `smem` bytes of dynamic shared
// memory (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or a negative
// CUDA error code.  The kernel at the launch's pitch stands for the one at
// FAST_PITCH: both are held to 64 registers by their launch bounds.
extern "C" int paris_bp_blocks_per_sm(int device, int shape, int proj_bf16,
                                      int copy, int smem) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return -(int)err;
  const void* fn = kernel_for(shape, proj_bf16, copy, 0);
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
// `copy` (COPY_ASYNC needs n_row * sizeof(T), pitch * sizeof(T) and the
// projection pointer 16-B aligned), a ring of tiles of tile_h rows of
// `pitch` elements (for COPY_GLOBAL: pitch n_row, tile_h vp) and `smem`
// bytes of dynamic shared memory.  Returns cudaErrorInvalidValue for a
// pitch that breaks the copies' alignment, else cudaGetLastError() after
// the launch (0 = launched).
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
  const void* fn = kernel_for(shape, proj_bf16, copy, pitch);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  const int by = SHAPES[shape].by, zr = SHAPES[shape].zr;
  const int esize = proj_bf16 ? 2 : 4;
  if (copy == COPY_ASYNC && pitch * esize % VEC != 0) {
    return (int)cudaErrorInvalidValue;
  }
  // copies per tile row, and the power of two of threads that share them
  const int per_row = copy == COPY_ASYNC ? pitch * esize / VEC : pitch;
  int lanes_lg = 0;
  while ((1 << lanes_lg) < per_row && (1 << lanes_lg) < BX * by) ++lanes_lg;
  const BpParams p{C, n_col, n_row, vp, v_lo, dz, ny, nx, rx1, ry1, z0,
                   off_x, off_y, off_z, l_vx_x, l_vx_y, l_vx_z,
                   d_so, d_sd, safe_min, h_min, inv_lpr, inv_lpc, vb,
                   pitch, tile_h, by, lanes_lg};
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return (int)err;
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
