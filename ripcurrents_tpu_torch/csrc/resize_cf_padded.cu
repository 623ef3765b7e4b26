// K4 resize_cf_padded: padded channels-first bilinear upsample of the flow
// between Farneback pyramid levels.
//
// Replaces the TPU kernel ripcurrents_tpu/ops/resize_pallas.py:
// resize_bilinear_cf_padded_pallas (kernel), which computes
// out[c] = MyT @ img[c] @ Mx with the embedding of the true region, the
// zero pads and the 1/pyr_scale fold inside the two matrices. Each row of
// MyT and each column of Mx holds at most two nonzeros, so the host hands
// over (idx0, idx1), (w0, w1) per output row and per output column (taken
// from those matrices) and the kernel is a two-tap by two-tap gather: the
// y pass first, as the TPU kernel does, one thread per output element.
//
// Each two-term sum is fmaf(w1, v1, w0 * v0) with idx0 < idx1: the
// rounding of a float32 matrix product that accumulates with FMAs in
// ascending source index, where the zero terms change nothing.
//
// Bound: bytes (the source is read once, the output written once; 2.2 MB
// at 640x480). One launch per pyramid level change.

#include <cuda_runtime.h>

namespace {

constexpr int kTileX = 32;
constexpr int kTileY = 8;

__global__ void __launch_bounds__(kTileX * kTileY)
resize_cf_padded_kernel(const float* __restrict__ img,
                        const int* __restrict__ yidx,
                        const float* __restrict__ yw,
                        const int* __restrict__ xidx,
                        const float* __restrict__ xw, float* __restrict__ out,
                        int sph, int spw, int dph, int dpw) {
  const int x = blockIdx.x * kTileX + threadIdx.x;
  const int y = blockIdx.y * kTileY + threadIdx.y;
  if (x >= dpw || y >= dph) return;
  const float* src = img + static_cast<size_t>(blockIdx.z) * sph * spw;
  const int y0 = yidx[2 * y], y1 = yidx[2 * y + 1];
  const float wy0 = yw[2 * y], wy1 = yw[2 * y + 1];
  const int x0 = xidx[2 * x], x1 = xidx[2 * x + 1];
  const float wx0 = xw[2 * x], wx1 = xw[2 * x + 1];
  const float* r0 = src + static_cast<size_t>(y0) * spw;
  const float* r1 = src + static_cast<size_t>(y1) * spw;
  const float t0 = fmaf(wy1, r1[x0], wy0 * r0[x0]);
  const float t1 = fmaf(wy1, r1[x1], wy0 * r0[x1]);
  out[(static_cast<size_t>(blockIdx.z) * dph + y) * dpw + x] =
      fmaf(wx1, t1, wx0 * t0);
}

}  // namespace

// img: (c, sph, spw) f32; yidx (dph, 2) int32 and yw (dph, 2) f32: the two
// source rows and weights of each output row; xidx (dpw, 2), xw (dpw, 2)
// likewise for columns; out: (c, dph, dpw) f32. Launches on `stream`;
// returns the CUDA error of the launch.
extern "C" int resize_cf_padded_launch(const void* img, const void* yidx,
                                       const void* yw, const void* xidx,
                                       const void* xw, void* out, int c,
                                       int sph, int spw, int dph, int dpw,
                                       void* stream) {
  const dim3 grid((dpw + kTileX - 1) / kTileX, (dph + kTileY - 1) / kTileY, c);
  const dim3 block(kTileX, kTileY);
  resize_cf_padded_kernel<<<grid, block, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), static_cast<const int*>(yidx),
      static_cast<const float*>(yw), static_cast<const int*>(xidx),
      static_cast<const float*>(xw), static_cast<float*>(out), sph, spw, dph,
      dpw);
  return static_cast<int>(cudaGetLastError());
}
