// K1 farneback_update: the first-order Farneback matrix update of one
// pyramid level on Hopper (sm_90a).
//
// Replaces the TPU kernel ripcurrents_tpu/flow/fused_update.py
// _update_kernel (pallas_call in _fused_update) and the `it < iterations`
// half of the whole-level kernels _level_kernel / _level_kernel_pipe2
// (pallas_call in _fused_level). Same function: per (row tile x
// subcolumn) block, the rounded mean of the block's flow over its real
// pixels is the integer base (clamped so the taps stay in the table halo);
// each pixel samples the second frame's 5-channel bf16 expansion table
// bilinearly at base + residual (residual clamped to +-bres), then the
// FarnebackUpdateMatrices tail with OpenCV's 5-px border ramp writes the
// 5 normal-equation channels M as bf16.
//
// The TPU has no per-lane gather, so it builds the sample from
// (2*bres+1)^2 shifted multiply-adds after rolling each block by its base.
// Hopper gathers per thread: the sample here is the plain 4-tap bilinear
// read, which equals the TPU's tap sum because the residual is clamped to
// +-bres (weights outside the two bracketing taps are exactly zero). The
// tap weights are formed as the TPU's hat functions round them:
// w0 = 1 - frac, w1 = 1 - w0.
//
// What bounds it: bytes. At 640x480 level 0 it moves about 11.7 MB (p0
// 3.07 MB, the sampled table ~3.1 MB, flow 2.46 MB, M 3.07 MB written):
// ~3.5 us at 3.35 TB/s, against ~100 flops per pixel (~0.5 us). A legacy
// frame is 12 such launches of a few us, so launch latency, not either
// bound, sets its time. Design for that: one launch per level half
// iteration, no scratch in device memory (the block's base is reduced in
// shared memory, in double so that the rounding matches the plain version
// independent of summation order), coalesced row-major pixel loops. One
// block per (row tile x subcolumn) block keeps the base reduction local;
// it underfills the 132 SMs at 640x480 (15 blocks), which a later
// persistent or row-split design addresses.
//
// Built with -fmad=false so each product and sum rounds as the plain
// PyTorch version's separate tensor ops do.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kHaloY = 32;
constexpr int kHaloX = 128;
constexpr int kThreads = 512;

__device__ __forceinline__ float border_ramp(float d) {
  return d < 0.f ? 0.f : (d <= 1.f ? 0.14f : (d <= 4.f ? 0.4472f : 1.f));
}

__device__ __forceinline__ double warp_sum(double v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kThreads) farneback_update_kernel(
    const __nv_bfloat16* __restrict__ p0, const __nv_bfloat16* __restrict__ p1,
    const float* __restrict__ flow, const float* __restrict__ counts,
    __nv_bfloat16* __restrict__ m, int h, int w, int hp, int wp, int th,
    int sw, int bres) {
  const int s = blockIdx.x, i = blockIdx.y, nsub = gridDim.x;
  const int tw = wp + 2 * kHaloX;
  const size_t tplane = static_cast<size_t>(hp + 2 * kHaloY) * tw;
  const size_t plane = static_cast<size_t>(hp) * wp;
  const float* fx = flow;
  const float* fy = flow + plane;
  const int y0 = i * th, x0 = s * sw, n = th * sw;

  // Block base: rounded mean over the block's real pixels (pads of the
  // flow are zero, counts hold the real-pixel count).
  double sx = 0.0, sy = 0.0;
  for (int k = threadIdx.x; k < n; k += kThreads) {
    const size_t idx = static_cast<size_t>(y0 + k / sw) * wp + x0 + k % sw;
    sx += fx[idx];
    sy += fy[idx];
  }
  __shared__ double part[2][kThreads / 32];
  __shared__ int base[2];
  sx = warp_sum(sx);
  sy = warp_sum(sy);
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  if (lane == 0) {
    part[0][wid] = sx;
    part[1][wid] = sy;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double tx = 0.0, ty = 0.0;
    for (int k = 0; k < kThreads / 32; ++k) {
      tx += part[0][k];
      ty += part[1][k];
    }
    const float cnt = counts[i * nsub + s];
    const float lx = static_cast<float>(kHaloX - bres - 1);
    const float ly = static_cast<float>(kHaloY - bres - 1);
    // rintf rounds half to even, as jnp.round does.
    base[0] = static_cast<int>(
        fminf(fmaxf(rintf(static_cast<float>(tx) / cnt), -lx), lx));
    base[1] = static_cast<int>(
        fminf(fmaxf(rintf(static_cast<float>(ty) / cnt), -ly), ly));
  }
  __syncthreads();
  const int bx = base[0], by = base[1];
  const float fbx = static_cast<float>(bx), fby = static_cast<float>(by);
  const float fb = static_cast<float>(bres);
  const float hm1 = static_cast<float>(h) - 1.f;
  const float wm1 = static_cast<float>(w) - 1.f;

  for (int k = threadIdx.x; k < n; k += kThreads) {
    const int y = y0 + k / sw, x = x0 + k % sw;
    const size_t idx = static_cast<size_t>(y) * wp + x;
    const float dx = fx[idx], dy = fy[idx];
    const float rx = fminf(fmaxf(dx - fbx, -fb), fb);
    const float ry = fminf(fmaxf(dy - fby, -fb), fb);
    const float flx = floorf(rx), fly = floorf(ry);
    const float wx0 = 1.f - (rx - flx), wx1 = 1.f - wx0;
    const float wy0 = 1.f - (ry - fly), wy1 = 1.f - wy0;
    // Row and column of the top-left tap inside the halo'd table; the
    // base clamp keeps row..row+1 and col..col+1 inside it.
    const int row = y + kHaloY + by + static_cast<int>(fly);
    const int col = x + kHaloX + bx + static_cast<int>(flx);
    const size_t t00 = static_cast<size_t>(row) * tw + col;
    const size_t c00 = static_cast<size_t>(y + kHaloY) * tw + x + kHaloX;

    float r0[5], r1[5];
#pragma unroll
    for (int c = 0; c < 5; ++c) {
      const __nv_bfloat16* t = p1 + c * tplane + t00;
      const float a = wx0 * __bfloat162float(t[0]) + wx1 * __bfloat162float(t[1]);
      const float b = wx0 * __bfloat162float(t[tw]) +
                      wx1 * __bfloat162float(t[tw + 1]);
      r1[c] = wy0 * a + wy1 * b;
      r0[c] = __bfloat162float(p0[c * tplane + c00]);
    }

    const float ys = static_cast<float>(y), xs = static_cast<float>(x);
    const float scale = border_ramp(fminf(ys, hm1 - ys)) *
                        border_ramp(fminf(xs, wm1 - xs));
    const float xpd = xs + dx, ypd = ys + dy;
    const bool inside = xpd >= 0.f && ypd >= 0.f && xpd < wm1 && ypd < hm1;

    float r2 = inside ? (r0[0] - r1[0]) * 0.5f : r0[0] * 0.5f;
    float r3 = inside ? (r0[1] - r1[1]) * 0.5f : r0[1] * 0.5f;
    float r4 = inside ? (r0[2] + r1[2]) * 0.5f : r0[2];
    float r5 = inside ? (r0[3] + r1[3]) * 0.5f : r0[3];
    float r6 = inside ? (r0[4] + r1[4]) * 0.25f : r0[4] * 0.5f;
    r2 = r2 + r4 * dx + r6 * dy;
    r3 = r3 + r6 * dx + r5 * dy;
    r2 = r2 * scale;
    r3 = r3 * scale;
    r4 = r4 * scale;
    r5 = r5 * scale;
    r6 = r6 * scale;

    m[idx] = __float2bfloat16_rn(r4 * r4 + r6 * r6);
    m[plane + idx] = __float2bfloat16_rn((r4 + r5) * r6);
    m[2 * plane + idx] = __float2bfloat16_rn(r5 * r5 + r6 * r6);
    m[3 * plane + idx] = __float2bfloat16_rn(r4 * r2 + r6 * r3);
    m[4 * plane + idx] = __float2bfloat16_rn(r6 * r2 + r5 * r3);
  }
}

}  // namespace

// p0, p1: (5, hp + 64, wp + 256) bf16 halo'd expansion tables; flow:
// (2, hp, wp) f32 with zero pads; counts: (hp / th, wp / sw) f32; m:
// (5, hp, wp) bf16 output. Launches on `stream`; returns cudaGetLastError.
extern "C" int farneback_update_launch(const void* p0, const void* p1,
                                       const void* flow, const void* counts,
                                       void* m, int h, int w, int hp, int wp,
                                       int th, int sw, int bres, void* stream) {
  const dim3 grid(wp / sw, hp / th);
  farneback_update_kernel<<<grid, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(p0),
      static_cast<const __nv_bfloat16*>(p1), static_cast<const float*>(flow),
      static_cast<const float*>(counts), static_cast<__nv_bfloat16*>(m), h, w,
      hp, wp, th, sw, bres);
  return static_cast<int>(cudaGetLastError());
}
