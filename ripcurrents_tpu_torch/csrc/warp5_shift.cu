// K7 warp5_shift: the standalone bilinear warp of the portable Farneback
// engine (warp_impl="pallas").
//
// Replaces the TPU kernel ripcurrents_tpu/flow/warp_pallas.py:
// warp5_shift_pallas (_kernel), which evaluates the shift decomposition
//   out(p) = sum_sy hat(dy - sy) * sum_sx hat(dx - sx) * r1(p + (sx, sy))
// over every shift in [-budget, budget + 1]^2 as a static (2b+2)^2 unroll of
// vector multiply-adds on a halo'd VMEM block (the TPU has no per-lane
// gather), hat(t) = clamp(1 - |t|, 0, 1), r1 zero outside the frame.
//
// Only the shifts floor(d) and floor(d) + 1 can carry weight, and the TPU's
// row and column sums start at zero, so adding its zero terms changes
// nothing. Here one thread computes one output pixel (all five channels)
// from those two shifts per axis, each used only where it lies in
// [-budget, budget + 1]: the row sums in ascending sx, then the sum over sy
// in ascending sy, every product and sum rounded on its own (-fmad=false,
// __fmul_rn / __fadd_rn), as the plain PyTorch version
// (flow/warp_kernel.py: warp5_shift_plain) computes them: they agree bit
// for bit, and equal the TPU's sum.
//
// Layout: channels last, as the portable engine carries its tables: r1
// (h, w, 5) f32, flow (h, w, 2) f32, out (h, w, 5) f32.
//
// Bound: bytes (r1 read once, flow read once, out written once: 18.4 MB at
// 640x480). A pixel's four taps are 20-byte records of neighbouring pixels,
// mostly in L1/L2 after its neighbours' reads.

#include <cuda_runtime.h>

namespace {

constexpr int kTileX = 32;
constexpr int kTileY = 8;

__device__ __forceinline__ float hat(float d, float s) {
  return fminf(fmaxf(__fsub_rn(1.0f, fabsf(__fsub_rn(d, s))), 0.0f), 1.0f);
}

__global__ void __launch_bounds__(kTileX * kTileY)
warp5_shift_kernel(const float* __restrict__ r1, const float* __restrict__ flow,
                   float* __restrict__ out, int h, int w, int budget) {
  const int x = blockIdx.x * kTileX + threadIdx.x;
  const int y = blockIdx.y * kTileY + threadIdx.y;
  if (x >= w || y >= h) return;
  const size_t p = static_cast<size_t>(y) * w + x;
  const float dx = flow[2 * p];
  const float dy = flow[2 * p + 1];
  const float lo = static_cast<float>(-budget);
  const float hi = static_cast<float>(budget + 1);
  const float fx = floorf(dx);
  const float fy = floorf(dy);

  float acc[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int ky = 0; ky < 2; ++ky) {
    const float sy = __fadd_rn(fy, static_cast<float>(ky));
    if (!(sy >= lo && sy <= hi)) continue;
    const float wy = hat(dy, sy);
    const int yy = y + static_cast<int>(sy);
    float row[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    for (int kx = 0; kx < 2; ++kx) {
      const float sx = __fadd_rn(fx, static_cast<float>(kx));
      if (!(sx >= lo && sx <= hi)) continue;
      const float wx = hat(dx, sx);
      const int xx = x + static_cast<int>(sx);
      const bool inb = yy >= 0 && yy < h && xx >= 0 && xx < w;
      const float* v = r1 + (static_cast<size_t>(inb ? yy : 0) * w +
                             (inb ? xx : 0)) * 5;
      for (int c = 0; c < 5; ++c) {
        row[c] = __fadd_rn(row[c], __fmul_rn(wx, inb ? v[c] : 0.0f));
      }
    }
    for (int c = 0; c < 5; ++c) {
      acc[c] = __fadd_rn(acc[c], __fmul_rn(wy, row[c]));
    }
  }
  for (int c = 0; c < 5; ++c) out[p * 5 + c] = acc[c];
}

}  // namespace

// r1: (h, w, 5) f32; flow: (h, w, 2) f32 (dx, dy); out: (h, w, 5) f32.
// Launches on `stream`; returns the CUDA error of the launch.
extern "C" int warp5_shift_launch(const void* r1, const void* flow, void* out,
                                  int h, int w, int budget, void* stream) {
  const dim3 grid((w + kTileX - 1) / kTileX, (h + kTileY - 1) / kTileY);
  const dim3 block(kTileX, kTileY);
  warp5_shift_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(r1), static_cast<const float*>(flow),
      static_cast<float*>(out), h, w, budget);
  return static_cast<int>(cudaGetLastError());
}
