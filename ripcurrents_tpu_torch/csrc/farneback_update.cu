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
// ~3.5 us at 3.35 TB/s, against ~100 flops per pixel (~0.5 us). The base
// is a reduction over a whole block (20-46k pixels), and a pyramid has
// only 1-27 blocks per level at 640x480 and 1080p: one thread block per
// base block leaves most of the 132 SMs idle and makes a one-block coarse
// level cost more than level 0.
//
// Design: one thread-block cluster of S CTAs per base block, the block's
// rows split evenly over the S CTAs. The host picks S per level: the
// largest (<= 16) at which the card holds every cluster of the level at
// once (cudaOccupancyMaxActiveClusters), so no cluster waits for another
// to finish. Each CTA sums its slab's flow in double in a fixed order (per
// thread in pair order, a shuffle tree, the warps in order) into its own
// shared memory; after one cluster barrier its threads read the S slab
// sums through distributed shared memory (one peer each, all at once) and
// thread 0 adds them in rank order, so all S CTAs form the same base
// without a second launch and without scratch in device memory. A thread
// handles two adjacent pixels at a time (float2 flow loads, bf16x2 loads
// of p0 and stores of M). A CTA leaves only after every peer has read its
// slab sum (the second half of a split cluster barrier).
//
// Built with -fmad=false so each product and sum rounds as the plain
// PyTorch version's separate tensor ops do; the base is reduced in double
// so that its rounding does not depend on the summation order.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kHaloY = 32;
constexpr int kHaloX = 128;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 16;   // > 8 is a non-portable cluster size

__device__ __forceinline__ float border_ramp(float d) {
  return d < 0.f ? 0.f : (d <= 1.f ? 0.14f : (d <= 4.f ? 0.4472f : 1.f));
}

__device__ __forceinline__ double warp_sum(double v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

struct Level {
  const __nv_bfloat16* p1;
  int tw;            // table row length, wp + 2 * kHaloX
  size_t tplane;     // table channel stride
  float hm1, wm1;    // h - 1, w - 1
  float fb;          // bres
};

// The update of pixel (x, y) with flow (dx, dy) under integer base
// (fbx, fby): the 5 M channels, in the plain version's order of
// operations.
__device__ __forceinline__ void update_pixel(const Level& L, int x, int y,
                                             float dx, float dy, float fbx,
                                             float fby, float r0[5],
                                             float out[5]) {
  const float rx = fminf(fmaxf(dx - fbx, -L.fb), L.fb);
  const float ry = fminf(fmaxf(dy - fby, -L.fb), L.fb);
  const float flx = floorf(rx), fly = floorf(ry);
  const float wx0 = 1.f - (rx - flx), wx1 = 1.f - wx0;
  const float wy0 = 1.f - (ry - fly), wy1 = 1.f - wy0;
  // Row and column of the top-left tap inside the halo'd table; the
  // base clamp keeps row..row+1 and col..col+1 inside it.
  const int row = y + kHaloY + static_cast<int>(fby) + static_cast<int>(fly);
  const int col = x + kHaloX + static_cast<int>(fbx) + static_cast<int>(flx);
  const size_t t00 = static_cast<size_t>(row) * L.tw + col;
  const int tw = L.tw;

  float r1[5];
#pragma unroll
  for (int c = 0; c < 5; ++c) {
    const __nv_bfloat16* t = L.p1 + c * L.tplane + t00;
    const float a = wx0 * __bfloat162float(t[0]) + wx1 * __bfloat162float(t[1]);
    const float b = wx0 * __bfloat162float(t[tw]) +
                    wx1 * __bfloat162float(t[tw + 1]);
    r1[c] = wy0 * a + wy1 * b;
  }

  const float ys = static_cast<float>(y), xs = static_cast<float>(x);
  const float scale = border_ramp(fminf(ys, L.hm1 - ys)) *
                      border_ramp(fminf(xs, L.wm1 - xs));
  const float xpd = xs + dx, ypd = ys + dy;
  const bool inside = xpd >= 0.f && ypd >= 0.f && xpd < L.wm1 && ypd < L.hm1;

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

  out[0] = r4 * r4 + r6 * r6;
  out[1] = (r4 + r5) * r6;
  out[2] = r5 * r5 + r6 * r6;
  out[3] = r4 * r2 + r6 * r3;
  out[4] = r6 * r2 + r5 * r3;
}

// The two pixels (x, y), (x + 1, y) of flow pair q: their M channels from
// flow (dx, dy) and p0 (the pair's two bf16 values per channel), stored as
// one bf16x2 word per channel.
__device__ __forceinline__ void update_pair(const Level& L, int x, int y,
                                            size_t q, float2 dx, float2 dy,
                                            const __nv_bfloat162 (&r0)[5],
                                            float fbx, float fby,
                                            __nv_bfloat16* __restrict__ m,
                                            size_t plane) {
  float ra[5], rb[5];
#pragma unroll
  for (int c = 0; c < 5; ++c) {
    const float2 v = __bfloat1622float2(r0[c]);
    ra[c] = v.x;
    rb[c] = v.y;
  }
  float ma[5], mb[5];
  update_pixel(L, x, y, dx.x, dy.x, fbx, fby, ra, ma);
  update_pixel(L, x + 1, y, dx.y, dy.y, fbx, fby, rb, mb);
  __nv_bfloat162* out = reinterpret_cast<__nv_bfloat162*>(m) + q;
#pragma unroll
  for (int c = 0; c < 5; ++c)
    out[c * (plane >> 1)] = __floats2bfloat162_rn(ma[c], mb[c]);
}

// Grid (S, wp / sw, hp / th), cluster (S, 1, 1): cluster (s, i) is base
// block (row tile i, subcolumn s); its CTA of rank r takes rows
// [r * th / S, (r + 1) * th / S) of the tile. Thread t handles the pixel
// pairs t, t + kThreads, ... of its slab (row-major).
__global__ void __launch_bounds__(kThreads, 2) farneback_update_kernel(
    const __nv_bfloat16* __restrict__ p0, const __nv_bfloat16* __restrict__ p1,
    const float* __restrict__ flow, const float* __restrict__ counts,
    __nv_bfloat16* __restrict__ m, int h, int w, int hp, int wp, int th,
    int sw, int bres) {
  cg::cluster_group cluster = cg::this_cluster();
  const int nslab = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int s = blockIdx.y, i = blockIdx.z, nsub = gridDim.y;
  const int y0 = i * th + rank * th / nslab;
  const int rows = i * th + (rank + 1) * th / nslab - y0;
  const int x0 = s * sw;
  const int pairs_per_row = sw >> 1;
  const int npair = rows * pairs_per_row;
  const size_t plane = static_cast<size_t>(hp) * wp;
  const float2* fx2 = reinterpret_cast<const float2*>(flow);
  const float2* fy2 = reinterpret_cast<const float2*>(flow + plane);
  // float2 index of the pair (y0 + ry, x0 + 2 * rx) is pair0 + ry * wp / 2
  // + rx.
  const size_t pair0 = (static_cast<size_t>(y0) * wp + x0) >> 1;
  const int pair_row = wp >> 1;

  Level L;
  L.p1 = p1;
  L.tw = wp + 2 * kHaloX;
  L.tplane = static_cast<size_t>(hp + 2 * kHaloY) * L.tw;
  L.hm1 = static_cast<float>(h) - 1.f;
  L.wm1 = static_cast<float>(w) - 1.f;
  L.fb = static_cast<float>(bres);

  // This slab's flow sum (pads of the flow are zero), per thread in pair
  // order.
  double sx = 0.0, sy = 0.0;
  for (int k = threadIdx.x; k < npair; k += kThreads) {
    const int ry = k / pairs_per_row, rx = k - ry * pairs_per_row;
    const size_t q = pair0 + static_cast<size_t>(ry) * pair_row + rx;
    const float2 a = fx2[q], b = fy2[q];
    sx += a.x;
    sx += a.y;
    sy += b.x;
    sy += b.y;
  }
  __shared__ double part[2][kWarps];
  __shared__ double slab[2];
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
    for (int k = 0; k < kWarps; ++k) {
      tx += part[0][k];
      ty += part[1][k];
    }
    slab[0] = tx;
    slab[1] = ty;
  }
  cluster.sync();   // every slab sum is in its CTA's shared memory

  // The S slab sums through distributed shared memory, one peer per
  // thread (all S remote reads in flight at once).
  __shared__ double peers[kMaxCluster][2];
  if (static_cast<int>(threadIdx.x) < nslab) {
    const double* peer = cluster.map_shared_rank(slab, threadIdx.x);
    peers[threadIdx.x][0] = peer[0];
    peers[threadIdx.x][1] = peer[1];
  }
  // First half of the exit barrier: this thread has read its peer's sum.
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
  __syncthreads();
  if (threadIdx.x == 0) {
    // The block base from the S slab sums added in rank order: the same
    // sum in every CTA of the cluster.
    double tx = 0.0, ty = 0.0;
    for (int r = 0; r < nslab; ++r) {
      tx += peers[r][0];
      ty += peers[r][1];
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
  const float fbx = static_cast<float>(base[0]);
  const float fby = static_cast<float>(base[1]);

  for (int k = threadIdx.x; k < npair; k += kThreads) {
    const int ry = k / pairs_per_row, rx = k - ry * pairs_per_row;
    const int y = y0 + ry, x = x0 + 2 * rx;
    const size_t q = pair0 + static_cast<size_t>(ry) * pair_row + rx;
    const size_t c00 = static_cast<size_t>(y + kHaloY) * L.tw + x + kHaloX;
    __nv_bfloat162 r0[5];
#pragma unroll
    for (int c = 0; c < 5; ++c)
      r0[c] =
          *reinterpret_cast<const __nv_bfloat162*>(p0 + c * L.tplane + c00);
    update_pair(L, x, y, q, fx2[q], fy2[q], r0, fbx, fby, m, plane);
  }
  // Second half: no CTA's shared memory goes away while a peer may still
  // be reading its slab sum.
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

cudaLaunchConfig_t cluster_config(dim3 grid, int cluster, cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

// How many clusters of `cluster` CTAs of this kernel the card can hold at
// once (cudaOccupancyMaxActiveClusters); a negative CUDA error code when
// the query fails.
extern "C" int farneback_update_active_clusters(int cluster) {
  cudaError_t e = cudaFuncSetAttribute(
      farneback_update_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed,
      1);
  if (e != cudaSuccess) return -static_cast<int>(e);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(dim3(cluster, 1, 1), cluster, nullptr, &attr);
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, farneback_update_kernel, &cfg);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

// p0, p1: (5, hp + 64, wp + 256) bf16 halo'd expansion tables; flow:
// (2, hp, wp) f32 with zero pads; counts: (hp / th, wp / sw) f32; m:
// (5, hp, wp) bf16 output. cluster: CTAs per base block, 1 <= cluster <=
// min(16, th). One cluster launch on `stream`; returns its CUDA error.
extern "C" int farneback_update_launch(const void* p0, const void* p1,
                                       const void* flow, const void* counts,
                                       void* m, int h, int w, int hp, int wp,
                                       int th, int sw, int bres, int cluster,
                                       void* stream) {
  if (cluster < 1 || cluster > kMaxCluster || cluster > th || sw % 2)
    return static_cast<int>(cudaErrorInvalidValue);
  if (cluster > 8) {
    const cudaError_t e = cudaFuncSetAttribute(
        farneback_update_kernel,
        cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(dim3(cluster, wp / sw, hp / th), cluster,
                     static_cast<cudaStream_t>(stream), &attr);
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, farneback_update_kernel, static_cast<const __nv_bfloat16*>(p0),
      static_cast<const __nv_bfloat16*>(p1), static_cast<const float*>(flow),
      static_cast<const float*>(counts), static_cast<__nv_bfloat16*>(m), h, w,
      hp, wp, th, sw, bres);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
