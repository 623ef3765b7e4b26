// K4 resize_cf_padded: padded channels-first bilinear upsample of the flow
// between Farneback pyramid levels.
//
// Replaces the TPU kernel ripcurrents_tpu/ops/resize_pallas.py:
// resize_bilinear_cf_padded_pallas (kernel), which computes
// out[c] = MyT @ img[c] @ Mx with the embedding of the true region, the
// zero pads and the 1/pyr_scale fold inside the two matrices. Each row of
// MyT and each column of Mx holds at most two nonzeros, so the host hands
// over (idx0, idx1), (w0, w1) per output row and per output column (taken
// from those matrices) and the kernel is a two-tap by two-tap gather, the
// y pass first, as the TPU kernel does.
//
// Each two-term sum is fmaf(w1, v1, w0 * v0) with idx0 < idx1: the
// rounding of a float32 matrix product that accumulates with FMAs in
// ascending source index, where the zero terms change nothing.
//
// Bound: bytes (the source is read once, the output written once; 3.1 MB
// at 640x480 level 0, ~0.9 us at 3.35 TB/s). One launch per pyramid level
// change.
//
// Design. A thread computes 4 adjacent output columns of `rows` output
// rows (the host plan: ops/image.py: resize_plan) for every channel: it
// loads its 4 columns' taps once as two 16-byte reads of each table, each
// row's taps once as one 8-byte read of each (the same for the whole
// warp), gathers the source values through L1 (the 4 columns read 3-4
// adjacent source columns of 2 rows) and writes each row and channel as
// one 16-byte store. A warp covers 128 columns of a row, a block
// RESIZE_WARPS row groups of warps; the plan gives a thread more rows (at
// most 4) until the grid fits RESIZE_MIN_BLOCKS blocks an SM (the launch
// bounds), so the launch is one wave. Small blocks (4 warps) spread a
// coarse level over more SMs.

#include <cuda_runtime.h>

// The block shape comes from the build (ripcurrents_tpu_torch/kernels.py:
// DEFINES), where the host plan reads it too.
#if !defined(RESIZE_WARPS) || !defined(RESIZE_MIN_BLOCKS)
#error "build with -DRESIZE_WARPS=<warps> -DRESIZE_MIN_BLOCKS=<blocks/SM>"
#endif

namespace {

constexpr int kWarps = RESIZE_WARPS;
constexpr int kThreads = 32 * kWarps;

__global__ void __launch_bounds__(kThreads, RESIZE_MIN_BLOCKS)
resize_cf_padded_kernel(const float* __restrict__ img,
                        const int2* __restrict__ yidx,
                        const float2* __restrict__ yw,
                        const int4* __restrict__ xidx,
                        const float4* __restrict__ xw, float* __restrict__ out,
                        int c, int sph, int spw, int dph, int dpw, int rows) {
  const int x = 4 * (blockIdx.x * 32 + (threadIdx.x & 31));
  if (x >= dpw) return;
  const int4 ia = __ldg(xidx + x / 2), ib = __ldg(xidx + x / 2 + 1);
  const float4 wa = __ldg(xw + x / 2), wb = __ldg(xw + x / 2 + 1);
  const int c0[4] = {ia.x, ia.z, ib.x, ib.z};
  const int c1[4] = {ia.y, ia.w, ib.y, ib.w};
  const float w0[4] = {wa.x, wa.z, wb.x, wb.z};
  const float w1[4] = {wa.y, wa.w, wb.y, wb.w};
  const int y_first = (blockIdx.y * kWarps + (threadIdx.x >> 5)) * rows;
  const int y_end = min(y_first + rows, dph);
  const size_t src_plane = static_cast<size_t>(sph) * spw;
  const size_t dst_plane = static_cast<size_t>(dph) * dpw;
  for (int y = y_first; y < y_end; ++y) {
    const int2 iy = __ldg(yidx + y);
    const float2 wy = __ldg(yw + y);
    for (int ch = 0; ch < c; ++ch) {
      const float* r0 = img + ch * src_plane + static_cast<size_t>(iy.x) * spw;
      const float* r1 = img + ch * src_plane + static_cast<size_t>(iy.y) * spw;
      float o[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float t0 =
            fmaf(wy.y, __ldg(r1 + c0[k]), wy.x * __ldg(r0 + c0[k]));
        const float t1 =
            fmaf(wy.y, __ldg(r1 + c1[k]), wy.x * __ldg(r0 + c1[k]));
        o[k] = fmaf(w1[k], t1, w0[k] * t0);
      }
      *reinterpret_cast<float4*>(out + ch * dst_plane +
                                 static_cast<size_t>(y) * dpw + x) =
          make_float4(o[0], o[1], o[2], o[3]);
    }
  }
}

}  // namespace

// img: (c, sph, spw) f32; yidx (dph, 2) int32 and yw (dph, 2) f32: the two
// source rows and weights of each output row; xidx (dpw, 2), xw (dpw, 2)
// likewise for columns; out: (c, dph, dpw) f32, dpw % 4 == 0; rows: output
// rows a thread (the host plan). Launches on `stream`; returns the CUDA
// error of the launch.
extern "C" int resize_cf_padded_launch(const void* img, const void* yidx,
                                       const void* yw, const void* xidx,
                                       const void* xw, void* out, int c,
                                       int sph, int spw, int dph, int dpw,
                                       int rows, void* stream) {
  const dim3 grid((dpw + 127) / 128,
                  (dph + kWarps * rows - 1) / (kWarps * rows));
  resize_cf_padded_kernel<<<grid, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), static_cast<const int2*>(yidx),
      static_cast<const float2*>(yw), static_cast<const int4*>(xidx),
      static_cast<const float4*>(xw), static_cast<float*>(out), c, sph, spw,
      dph, dpw, rows);
  return static_cast<int>(cudaGetLastError());
}
