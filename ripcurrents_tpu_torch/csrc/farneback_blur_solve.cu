// K2 farneback_blur_solve: window blur of the 5 normal-equation channels
// and the per-pixel 2x2 solve, on Hopper (sm_90a).
//
// Replaces the TPU kernel ripcurrents_tpu/flow/fused_update.py
// _final_kernel (pallas_call in _fused_final) and the `it > 0` half of the
// whole-level kernels _level_kernel / _level_kernel_pipe2 (pallas_call in
// _fused_level). Same function and roundings: a separable replicate-border
// blur (box or Gaussian taps rounded to bf16) of M (bf16), y pass first
// with the result rounded to bf16, x pass accumulated in f32, then
// idet = 1 / (g11*g22 - g12^2 + 1e-3) and the flow (dx, dy). The
// replicate border is taken about the true image size; at the caller's
// choice the alignment pads of the flow are zeroed.
//
// The TPU runs both blur passes as band-matrix products on its MXU, with
// the border-merged y weights rounded to bf16 after merging. Here the
// host passes the same merged y weights per output row (wy, shape
// (hp, 2*half+1), zero where a tap merged into an earlier one) and the
// bf16-rounded x taps (wx), and each pass is a short tap loop.
//
// What bounds it: bytes. At 640x480 level 0 it reads M (3.07 MB) and
// writes the flow (2.46 MB): ~1.7 us at 3.35 TB/s; the blur is ~2 flops
// per tap, channel and pass (~0.2 us at the f32 rate). Design: one
// 32x8 output tile per block; the y pass writes the tile's bf16-rounded
// rows plus the x halo into shared memory (M rows are re-read from L1/L2
// by the neighbouring tap rows, not from device memory), the x pass and
// the solve read shared memory only.
//
// Built with -fmad=false so each product and sum rounds as the plain
// PyTorch version's separate tensor ops do.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTileX = 32;
constexpr int kTileY = 8;
constexpr int kMaxHalf = 16;

__global__ void __launch_bounds__(kTileX * kTileY) farneback_blur_solve_kernel(
    const __nv_bfloat16* __restrict__ m, const float* __restrict__ wy,
    const float* __restrict__ wx, float* __restrict__ flow, int h, int w,
    int hp, int wp, int half, int zero_pads) {
  __shared__ float mid[5][kTileY][kTileX + 2 * kMaxHalf];
  const int nt = 2 * half + 1;
  const int span = kTileX + 2 * half;
  const int bx0 = blockIdx.x * kTileX, by0 = blockIdx.y * kTileY;
  const size_t plane = static_cast<size_t>(hp) * wp;
  const int tid = threadIdx.y * kTileX + threadIdx.x;

  // y pass over the tile's rows and its replicate-clamped x halo.
  for (int k = tid; k < kTileY * span; k += kTileX * kTileY) {
    const int r = k / span, j = k % span;
    const int y = by0 + r;
    const int xs = min(max(bx0 - half + j, 0), w - 1);
    float acc[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
    for (int o = 0; o < nt; ++o) {
      const int ys = min(max(y - half + o, 0), h - 1);
      const float wv = wy[y * nt + o];
      const size_t src = static_cast<size_t>(ys) * wp + xs;
#pragma unroll
      for (int c = 0; c < 5; ++c)
        acc[c] = acc[c] + wv * __bfloat162float(m[c * plane + src]);
    }
#pragma unroll
    for (int c = 0; c < 5; ++c)
      mid[c][r][j] = __bfloat162float(__float2bfloat16_rn(acc[c]));
  }
  __syncthreads();

  const int y = by0 + threadIdx.y, x = bx0 + threadIdx.x;
  float g[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
  for (int o = 0; o < nt; ++o) {
    const float wv = wx[o];
#pragma unroll
    for (int c = 0; c < 5; ++c)
      g[c] = g[c] + wv * mid[c][threadIdx.y][threadIdx.x + o];
  }
  const float idet = 1.f / (g[0] * g[2] - g[1] * g[1] + 1e-3f);
  float dx = (g[2] * g[3] - g[1] * g[4]) * idet;
  float dy = (g[0] * g[4] - g[1] * g[3]) * idet;
  if (zero_pads && (y >= h || x >= w)) {
    dx = 0.f;
    dy = 0.f;
  }
  const size_t o = static_cast<size_t>(y) * wp + x;
  flow[o] = dx;
  flow[plane + o] = dy;
}

}  // namespace

// m: (5, hp, wp) bf16; wy: (hp, 2*half+1) f32; wx: (2*half+1,) f32;
// flow: (2, hp, wp) f32 output. hp % 8 == 0, wp % 32 == 0, half <= 16.
// Launches on `stream`; returns cudaGetLastError.
extern "C" int farneback_blur_solve_launch(const void* m, const void* wy,
                                           const void* wx, void* flow, int h,
                                           int w, int hp, int wp, int half,
                                           int zero_pads, void* stream) {
  const dim3 grid(wp / kTileX, hp / kTileY);
  const dim3 block(kTileX, kTileY);
  farneback_blur_solve_kernel<<<grid, block, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(m), static_cast<const float*>(wy),
      static_cast<const float*>(wx), static_cast<float*>(flow), h, w, hp, wp,
      half, zero_pads);
  return static_cast<int>(cudaGetLastError());
}
