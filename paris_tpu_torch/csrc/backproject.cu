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
// What bounds it on this card: per voxel update about 20 f32 operations
// (the v coordinate, its floor and border test, the tap address and the
// bilinear lerp), four gathered taps (two horizontally adjacent pixels in
// each of two detector rows), and 8 B of volume traffic (one f32 read, one
// write) per chunk of C projections.  The volume bytes are amortised C-fold,
// so the kernel is bound by the issue rate of the gathers and the lerp
// arithmetic, not by device memory.
//
// What the design does about that: one thread owns one (x, y) column and ZR
// consecutive z slices, accumulated in registers; a block is 32 (x) by 8 (y)
// threads.  Per angle the z-invariant work (s, t, the source clamp, the
// magnification scaled to detector rows, the FDK weight, the h tap and its
// fraction) is done once and reused for the ZR slices, so a z step costs two
// f32 operations for v, a floor, four read-only (__ldg) taps and the lerp.
// The volume is read once and written once per chunk.  The 32 threads of a
// warp hold neighbouring x, so their taps fall on neighbouring pixels of the
// same two detector rows and coalesce; successive z steps of one thread walk
// down a detector column, which keeps the rows in L1 and L2.
//
// The coordinates that decide a floor or the border test (s, t, f, h, v) are
// computed with explicitly rounded intrinsics (__fmul_rn, __fadd_rn,
// __fsub_rn, __frcp_rn), which nvcc never contracts into an FMA.  They round
// like the separate tensor operations of the plain version, so both pick the
// same taps and differ only by the rounding of the lerp.
//
// Projections arrive as (C, vp, n_row) contiguous, float (exact mode) or
// bf16 (fast mode, widened to f32 per tap); the accumulator is (dz, ny, nx)
// contiguous with x minor and is updated in place.
//
// Detector-row band (the Pallas kernel's offs[3], backprojection_pallas.py:
// 386, :546-555): the vp rows of a frame are detector rows [v_lo, v_lo + vp)
// (a z-block samples only that band, geometry.detector_row_band), so a chunk
// carries vp/n_col of the detector's bytes.  The border test still runs on
// the whole detector (0 <= floor(v) <= n_col - 2); the tap row floor(v) - v_lo
// is clamped into [0, vp - 2], so a band that misses a block reads wrong rows
// of the buffer but never outside it.  v_lo = 0, vp = n_col is the unbanded
// kernel, with the same arithmetic.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int BX = 32;   // threads along x
constexpr int BY = 8;    // threads along y
constexpr int ZR = 16;   // z slices per thread, held in registers

struct BpParams {
  int C, n_col, n_row, vp, v_lo;
  int dz, ny, nx;
  int rx1, ry1, z0;
  float off_x, off_y, off_z;
  float l_vx_x, l_vx_y, l_vx_z;
  float d_so, d_sd, safe_min;
  float h_min, inv_lpr, inv_lpc, vb;
};

__device__ __forceinline__ float tap(const float* p, size_t i) {
  return __ldg(p + i);
}

__device__ __forceinline__ float tap(const __nv_bfloat16* p, size_t i) {
  const unsigned short bits =
      __ldg(reinterpret_cast<const unsigned short*>(p) + i);
  return __bfloat162float(__ushort_as_bfloat16(bits));
}

template <typename T>
__global__ void __launch_bounds__(BX * BY)
bp_kernel(float* __restrict__ vol, const T* __restrict__ proj,
          const float* __restrict__ sinp, const float* __restrict__ cosp,
          const BpParams p) {
  const int x = blockIdx.x * BX + threadIdx.x;
  const int y = blockIdx.y * BY + threadIdx.y;
  const int zb = blockIdx.z * ZR;
  if (x >= p.nx || y >= p.ny) return;
  const int nz = min(ZR, p.dz - zb);
  const size_t plane = (size_t)p.ny * p.nx;
  float* col = vol + (size_t)zb * plane + (size_t)y * p.nx + x;

  float acc[ZR];
  float zm[ZR];
#pragma unroll
  for (int k = 0; k < ZR; ++k) {
    acc[k] = (k < nz) ? col[k * plane] : 0.f;
    zm[k] = __fadd_rn(__fmul_rn((float)(p.z0 + zb + k), p.l_vx_z), p.off_z);
  }
  const float xm = __fadd_rn(__fmul_rn((float)(p.rx1 + x), p.l_vx_x), p.off_x);
  const float ym = __fadd_rn(__fmul_rn((float)(p.ry1 + y), p.l_vx_y), p.off_y);
  const size_t frame = (size_t)p.vp * p.n_row;
  const float h_last = (float)(p.n_row - 2);   // last valid left tap
  const float v_last = (float)(p.n_col - 2);   // last valid upper tap
  const int row_last = p.vp - 2;               // last upper tap in the band

  for (int c = 0; c < p.C; ++c) {
    const float sn = __ldg(sinp + c);
    const float cs = __ldg(cosp + c);
    const float s = __fadd_rn(__fmul_rn(xm, cs), __fmul_rn(ym, sn));
    const float t = __fadd_rn(__fmul_rn(-xm, sn), __fmul_rn(ym, cs));
    const float denom = __fadd_rn(s, p.d_so);
    if (!(denom > p.safe_min)) continue;           // at or behind the source
    const float inv = __frcp_rn(denom);
    const float factor = __fmul_rn(inv, p.d_sd);
    const float u = __fmul_rn(inv, p.d_so);
    const float w = 0.5f * (u * u);
    const float h = __fsub_rn(
        __fmul_rn(__fsub_rn(__fmul_rn(t, factor), p.h_min), p.inv_lpr), 0.5f);
    const float h0f = floorf(h);
    if (!(h0f >= 0.f && h0f <= h_last)) continue;  // off the detector in h
    const float fh = __fsub_rn(h, h0f);
    const float fscale = __fmul_rn(factor, p.inv_lpc);
    const T* pc = proj + (size_t)c * frame + (int)h0f;
#pragma unroll
    for (int k = 0; k < ZR; ++k) {
      const float v = __fadd_rn(__fmul_rn(zm[k], fscale), p.vb);
      const float v0f = floorf(v);
      if (v0f >= 0.f && v0f <= v_last) {
        const float fv = __fsub_rn(v, v0f);
        const int row = min(max((int)v0f - p.v_lo, 0), row_last);
        const size_t r0 = (size_t)row * p.n_row;
        const float q11 = tap(pc, r0);
        const float q21 = tap(pc, r0 + 1);
        const float q12 = tap(pc, r0 + p.n_row);
        const float q22 = tap(pc, r0 + p.n_row + 1);
        const float top = q11 * (1.f - fh) + q21 * fh;
        const float bot = q12 * (1.f - fh) + q22 * fh;
        acc[k] += w * (top * (1.f - fv) + bot * fv);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < ZR; ++k) {
    if (k < nz) col[k * plane] = acc[k];
  }
}

}  // namespace

// Launches one backprojection of C projections (vp detector rows from v_lo)
// into the accumulator on `stream`.  Returns cudaGetLastError() after the
// launch (0 = launched).
extern "C" int paris_bp_launch(
    int device, void* stream, float* vol, const void* proj, int proj_bf16,
    const float* sinp, const float* cosp,
    int C, int n_col, int n_row, int vp, int v_lo, int dz, int ny, int nx,
    int rx1, int ry1, int z0,
    float off_x, float off_y, float off_z,
    float l_vx_x, float l_vx_y, float l_vx_z,
    float d_so, float d_sd, float safe_min,
    float h_min, float inv_lpr, float inv_lpc, float vb) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const BpParams p{C, n_col, n_row, vp, v_lo, dz, ny, nx, rx1, ry1, z0,
                   off_x, off_y, off_z, l_vx_x, l_vx_y, l_vx_z,
                   d_so, d_sd, safe_min, h_min, inv_lpr, inv_lpc, vb};
  const dim3 block(BX, BY, 1);
  const dim3 grid((nx + BX - 1) / BX, (ny + BY - 1) / BY, (dz + ZR - 1) / ZR);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (proj_bf16) {
    bp_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        vol, static_cast<const __nv_bfloat16*>(proj), sinp, cosp, p);
  } else {
    bp_kernel<float><<<grid, block, 0, s>>>(
        vol, static_cast<const float*>(proj), sinp, cosp, p);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* paris_bp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
