// K8 warp_tiles: the tiled base + residual warp of a C-channel table on
// Hopper (sm_90a).
//
// Replaces the TPU kernel of tools/bench_warp_variants.py: run (the
// pallas_call whose body make_kernel builds): variant "A" runs the fused
// engine's warp stage ripcurrents_tpu/flow/fused_update.py: _warp_subcols
// (_block_base, _shift_block, _tap_sum) alone over a halo'd bf16 table,
// and variant "Z" the same taps with no base (_warp_z). The same algebra is
// the portable engine's tiled warp, ripcurrents_tpu/flow/farneback.py:
// _warp5_tiled, which this kernel also computes for any of its callers'
// channel counts (1, 3, 5). Per tile of (th, tw) pixels, the integer base
// is the rounded mean of the tile's real-pixel flow, clamped; each pixel
// samples the table bilinearly at base + its residual clamped to +-bres.
//
// The TPU has no per-lane gather, so it rolls a halo block by the base and
// sums (2*bres+1)^2 shifted multiply-adds. Here each thread gathers: the
// sample is the plain 4-tap bilinear read, which equals the TPU's tap sum
// because the residual is clamped to +-bres (weights outside the two
// bracketing taps are exactly zero; see csrc/farneback_update.cu). The tap
// weights are formed as the TPU's hat functions round them: w0 = 1 - frac,
// w1 = 1 - w0.
//
// Two layouts:
//   (a) halo: table (5, hp + 64, wp + 256) bf16 with the frame at (32, 128),
//       flow (2, hp, wp) f32 with zero pads, tiles (th, sw), the base
//       clamped to +-(HALO - bres - 1) so every tap stays in the halo,
//       counts (hp / th, wp / sw) from the caller; out (5, hp, wp) f32
//       (_warp_subcols);
//   (b) frame: table (h, w, C) f32, zero outside [0, h) x [0, w), flow
//       (h, w, 2) f32, tiles (th, tw) over the frame padded with zero flow
//       to whole tiles, each tile's real-pixel count computed here from
//       (h, w, th, tw), the base clamped to +-max_base; out (h, w, C) f32
//       (_warp5_tiled, without its zero-padded copy of the table).
// Every table read is bounds-checked and a read outside the table is 0:
// a weight of 0 times a value past the edge would be NaN if that value
// were.
//
// What bounds it: bytes. At 640x480 in layout (b) with C = 5 the table,
// the flow and the output once each are 14.7 MB, ~4.4 us at 3.35 TB/s; at
// 1080p in layout (a) ~79 MB, ~24 us; ~50-80 flops a pixel are far below.
//
// Design: one launch per call. The base needs a reduction over the whole
// tile before any pixel is sampled, so each tile is one thread-block
// cluster of S CTAs (K1's form). CTA r of a cluster owns rows
// [r * th / S, (r + 1) * th / S) of the tile. It sums its rows' flow in
// double in a fixed order (16-byte units of the flow, 8 in flight a
// thread, each thread in unit order, a shuffle tree, the warps in order),
// pushes its slab sum into every CTA of the cluster through distributed
// shared memory before one cluster barrier, and every CTA adds the S sums
// in rank order: all form the same base, with no second launch and no
// scratch in device memory.
// It then samples the same rows, 4 pixels a thread at once, adjacent
// lanes on adjacent pixels (each tap load of a warp on adjacent
// addresses), with 32-bit tap offsets. The host plan (flow/warp_kernel.py:
// tiles_plan) picks S and the CTA size per call: S the largest power of
// two <= 16 at which the card holds every cluster at once, so no cluster
// waits on another. Measured on an H100 and dropped: a thread owning 4
// adjacent pixels with float4 flow loads and stores (each gather of a warp
// then spans 4x the cache lines), lanes on (pixel, channel) pairs, a
// window of the table staged in shared memory by 4- or 16-byte cp.async,
// stores transposed through shared memory, and more clusters per tile.
// The no-base instance of layout (a) (the floor "Z") takes the same plan
// as a plain launch without the reduction.
//
// Built with -fmad=false so each product and sum rounds as the plain
// PyTorch version's separate tensor ops do (flow/warp_kernel.py:
// warp_tiles_plain); the base is reduced in double so that its rounding
// does not depend on the summation order.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kHaloY = 32;
constexpr int kHaloX = 128;
constexpr int kHaloC = 5;
constexpr int kMaxThreads = 512;
constexpr int kMinBlocks = 2;     // 2 x 512 threads an SM: <= 64 registers
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kPix = 4;           // pixels a thread samples at once
constexpr int kUnits = 8;         // float4 a thread sums at once
constexpr int kMaxCluster = 16;   // > 8 is a non-portable cluster size

__device__ __forceinline__ double warp_sum(double v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float value(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float value(const float* p) { return *p; }

struct BaseSmem {
  double warp[2][kMaxWarps];
  double slab[2];
  double peers[kMaxCluster][2];
  int base[2];
};

// First half of a cluster barrier, at the start of a clustered kernel:
// tile_base waits on it before it writes into the other CTAs' shared
// memory, so that every CTA of the cluster has started (the wait comes
// after the flow reads, which hide it).
__device__ __forceinline__ void cluster_arrive_started() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

// The tile's base from each thread's partial sums (sx, sy) of this CTA's
// slab: the warps' shuffle trees added in warp order; each CTA writes its
// slab sum into every CTA's shared memory (distributed shared memory),
// one cluster barrier, and each CTA adds the S sums in rank order; rintf
// rounds half to even, as jnp.round does. Every thread of every CTA of the
// cluster must call it, after cluster_arrive_started(); no CTA touches
// another's shared memory after it.
__device__ __forceinline__ int2 tile_base(double sx, double sy, float cnt,
                                          int lim_x, int lim_y,
                                          BaseSmem& s) {
  cg::cluster_group cluster = cg::this_cluster();
  const int nslab = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  sx = warp_sum(sx);
  sy = warp_sum(sy);
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  if (lane == 0) {
    s.warp[0][wid] = sx;
    s.warp[1][wid] = sy;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double tx = 0.0, ty = 0.0;
    for (int k = 0; k < static_cast<int>(blockDim.x >> 5); ++k) {
      tx += s.warp[0][k];
      ty += s.warp[1][k];
    }
    s.slab[0] = tx;
    s.slab[1] = ty;
  }
  // Every CTA has started (the second half of cluster_arrive_started).
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  __syncthreads();
  // Thread r writes this slab's sum into CTA r's peers[rank].
  if (static_cast<int>(threadIdx.x) < nslab) {
    double* peer = cluster.map_shared_rank(s.peers[rank], threadIdx.x);
    peer[0] = s.slab[0];
    peer[1] = s.slab[1];
  }
  cluster.sync();   // every slab sum is in every CTA's shared memory
  if (threadIdx.x == 0) {
    double tx = 0.0, ty = 0.0;
    for (int r = 0; r < nslab; ++r) {
      tx += s.peers[r][0];
      ty += s.peers[r][1];
    }
    const float lx = static_cast<float>(lim_x);
    const float ly = static_cast<float>(lim_y);
    s.base[0] = static_cast<int>(
        fminf(fmaxf(rintf(static_cast<float>(tx) / cnt), -lx), lx));
    s.base[1] = static_cast<int>(
        fminf(fmaxf(rintf(static_cast<float>(ty) / cnt), -ly), ly));
  }
  __syncthreads();
  return make_int2(s.base[0], s.base[1]);
}

// The bilinear sample of C channels of a table at the residual of flow
// (dx, dy) about base (bx, by), clamped to +-bres, from table cell
// (row, col) = the pixel + the base. Channel ch of cell (r, c) lies at
// tab[r * t_r + c * t_x + ch * t_c].
template <int C, typename T>
__device__ __forceinline__ void sample(const T* __restrict__ tab, int t_c,
                                       int t_r, int t_x, int t_rows,
                                       int t_cols, int row, int col, float dx,
                                       float dy, int bx, int by, float fb,
                                       float* __restrict__ res) {
  const float rx = fminf(fmaxf(dx - static_cast<float>(bx), -fb), fb);
  const float ry = fminf(fmaxf(dy - static_cast<float>(by), -fb), fb);
  const float flx = floorf(rx), fly = floorf(ry);
  const float wx0 = 1.f - (rx - flx), wx1 = 1.f - wx0;
  const float wy0 = 1.f - (ry - fly), wy1 = 1.f - wy0;
  const int r0 = row + static_cast<int>(fly);
  const int c0 = col + static_cast<int>(flx);
  const bool rin[2] = {r0 >= 0 && r0 < t_rows,
                       r0 + 1 >= 0 && r0 + 1 < t_rows};
  const bool cin[2] = {c0 >= 0 && c0 < t_cols,
                       c0 + 1 >= 0 && c0 + 1 < t_cols};
  const int o = r0 * t_r + c0 * t_x;
#pragma unroll
  for (int ch = 0; ch < C; ++ch) {
    float v[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        v[i][j] = (rin[i] && cin[j])
                      ? value(tab + (o + i * t_r + j * t_x + ch * t_c))
                      : 0.f;
      }
    }
    const float a = wx0 * v[0][0] + wx1 * v[0][1];
    const float b = wx0 * v[1][0] + wx1 * v[1][1];
    res[ch] = wy0 * a + wy1 * b;
  }
}

// Layout (b). Grid (S, ntx, nty), cluster (S, 1, 1): cluster (tx, ty) is
// tile (ty, tx); its CTA of rank r takes the tile's rows [r * th / S,
// (r + 1) * th / S) inside the frame. The sum reads them as float4 units
// of the flow array (16-byte aligned, so a row's first and last unit may
// hold floats of other pixels, which are left out), upr units a row, unit
// k of the slab to thread k mod T (T = blockDim.x), kUnits at once; each
// unit's floats in order. The sampling takes pixel k of the slab
// (row-major) on thread k mod T, kPix at once (k = t, t + T, t + 2T,
// t + 3T, then the next kPix * T): adjacent lanes take adjacent pixels,
// and a thread's kPix pixels' loads are in flight together.
template <int C>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
    warp_tiles_frame_kernel(const float* __restrict__ table,
                            const float* __restrict__ flow,
                            float* __restrict__ out, int h, int w, int th,
                            int tw, int bres, int max_base) {
  __shared__ BaseSmem smem;
  const int nslab = gridDim.x, rank = blockIdx.x, nt = blockDim.x;
  const int x0 = blockIdx.y * tw, y0 = blockIdx.z * th;
  const int xe = min(x0 + tw, w), ncols = xe - x0;
  const int ya = y0 + rank * th / nslab;
  const int rows = max(min(y0 + (rank + 1) * th / nslab, h) - ya, 0);
  const int n = rows * ncols;
  cluster_arrive_started();

  // A row's floats [2 (y w + x0), 2 (y w + xe)) lie in at most upr units.
  const int upr = (2 * ncols + 3) / 4 + 1;
  double sx = 0.0, sy = 0.0;
  for (int k0 = threadIdx.x; k0 < rows * upr; k0 += kUnits * nt) {
    float v[kUnits][4];
#pragma unroll
    for (int u = 0; u < kUnits; ++u) {
      const int k = min(k0 + u * nt, rows * upr - 1), r = k / upr;
      const long long lo = 2 * (static_cast<long long>(ya + r) * w + x0);
      const long long hi = lo + 2 * ncols;
      const long long f0 = (lo & ~3LL) + 4LL * (k - r * upr);
      if (f0 >= lo && f0 + 4 <= hi) {
        const float4 a = *reinterpret_cast<const float4*>(flow + f0);
        v[u][0] = a.x;
        v[u][1] = a.y;
        v[u][2] = a.z;
        v[u][3] = a.w;
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          v[u][i] = f0 + i >= lo && f0 + i < hi ? flow[f0 + i] : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnits; ++u) {
      if (k0 + u * nt < rows * upr) {
        sx += v[u][0];
        sy += v[u][1];
        sx += v[u][2];
        sy += v[u][3];
      }
    }
  }
  // The tile's real-pixel count, as flow/warp_kernel.py: frame_counts.
  const int cnt = (min(y0 + th, h) - y0) * ncols;
  const int2 base = tile_base(sx, sy, static_cast<float>(max(cnt, 1)),
                              max_base, max_base, smem);

  const float fb = static_cast<float>(bres);
  const float2* fl = reinterpret_cast<const float2*>(flow);
  for (int k0 = threadIdx.x; k0 < n; k0 += kPix * nt) {
    // All kPix samples first (a pixel past the slab samples its last
    // pixel), then the stores: the gathers of the kPix pixels overlap.
    float res[kPix][C];
    size_t q[kPix];
#pragma unroll
    for (int u = 0; u < kPix; ++u) {
      const int k = min(k0 + u * nt, n - 1), r = k / ncols;
      const int y = ya + r, x = x0 + k - r * ncols;
      q[u] = static_cast<size_t>(y) * w + x;
      const float2 f = fl[q[u]];
      sample<C>(table, 1, w * C, C, h, w, y + base.y, x + base.x, f.x, f.y,
                base.x, base.y, fb, res[u]);
    }
#pragma unroll
    for (int u = 0; u < kPix; ++u) {
      if (k0 + u * nt < n) {
#pragma unroll
        for (int c = 0; c < C; ++c) out[q[u] * C + c] = res[u][c];
      }
    }
  }
}

// Layout (a). Grid (S, wp / sw, hp / th); with kBase a cluster (S, 1, 1)
// per tile as in layout (b), without it (the floor "Z": base 0) a plain
// launch. The sum reads 4 columns of both flow planes as a float4 each
// (sw % 4 == 0, wp % 4 == 0, 16-byte aligned flow), unit k of the slab to
// thread k mod T, kUnits / 2 at once; the sampling as in layout (b).
template <bool kBase>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
    warp_tiles_halo_kernel(const __nv_bfloat16* __restrict__ table,
                           const float* __restrict__ flow,
                           const float* __restrict__ counts,
                           float* __restrict__ out, int hp, int wp, int th,
                           int sw, int bres) {
  const int nslab = gridDim.x, rank = blockIdx.x, nt = blockDim.x;
  const int x0 = blockIdx.y * sw, y0 = blockIdx.z * th;
  const int ya = y0 + rank * th / nslab;
  const int n = (y0 + (rank + 1) * th / nslab - ya) * sw;
  const size_t plane = static_cast<size_t>(hp) * wp;
  const int t_rows = hp + 2 * kHaloY, t_cols = wp + 2 * kHaloX;
  const int t_plane = t_rows * t_cols;

  int2 base = make_int2(0, 0);
  if (kBase) {
    __shared__ BaseSmem smem;
    cluster_arrive_started();
    constexpr int kU = kUnits / 2;
    const int upr = sw >> 2, nu = n >> 2;
    double sx = 0.0, sy = 0.0;
    for (int k0 = threadIdx.x; k0 < nu; k0 += kU * nt) {
      float4 a[kU], b[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int k = min(k0 + u * nt, nu - 1), r = k / upr;
        const size_t q =
            static_cast<size_t>(ya + r) * wp + x0 + 4 * (k - r * upr);
        a[u] = *reinterpret_cast<const float4*>(flow + q);
        b[u] = *reinterpret_cast<const float4*>(flow + plane + q);
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        if (k0 + u * nt < nu) {
          sx += a[u].x;
          sx += a[u].y;
          sx += a[u].z;
          sx += a[u].w;
          sy += b[u].x;
          sy += b[u].y;
          sy += b[u].z;
          sy += b[u].w;
        }
      }
    }
    base = tile_base(sx, sy, counts[blockIdx.z * gridDim.y + blockIdx.y],
                     kHaloX - bres - 1, kHaloY - bres - 1, smem);
  }

  const float fb = static_cast<float>(bres);
  for (int k0 = threadIdx.x; k0 < n; k0 += kPix * nt) {
    float res[kPix][kHaloC];
    size_t q[kPix];
#pragma unroll
    for (int u = 0; u < kPix; ++u) {
      const int k = min(k0 + u * nt, n - 1), r = k / sw;
      const int y = ya + r, x = x0 + k - r * sw;
      q[u] = static_cast<size_t>(y) * wp + x;
      sample<kHaloC>(table, t_plane, t_cols, 1, t_rows, t_cols,
                     y + kHaloY + base.y, x + kHaloX + base.x, flow[q[u]],
                     flow[plane + q[u]], base.x, base.y, fb, res[u]);
    }
#pragma unroll
    for (int u = 0; u < kPix; ++u) {
      if (k0 + u * nt < n) {
#pragma unroll
        for (int c = 0; c < kHaloC; ++c) out[c * plane + q[u]] = res[u][c];
      }
    }
  }
}

cudaLaunchConfig_t launch_config(dim3 grid, int threads, int cluster,
                                 cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 0 ? 1 : 0;
  return cfg;
}

// Launch `kernel` on grid (slabs, ntx, nty) of `threads` threads, as
// clusters of `slabs` CTAs when `cluster`.
template <typename... Params, typename... Args>
int launch(void (*kernel)(Params...), bool cluster, int slabs, int ntx,
           int nty, int threads, void* stream, Args... args) {
  if (slabs < 1 || slabs > kMaxCluster || threads < 32 ||
      threads > kMaxThreads || threads % 32 || ntx < 1 || nty < 1 ||
      nty > 65535 || ntx > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (cluster && slabs > 8) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      launch_config(dim3(slabs, ntx, nty), threads, cluster ? slabs : 0,
                    static_cast<cudaStream_t>(stream), &attr);
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// The tap offsets are 32-bit: a table of 2^31 elements or more is refused.
bool halo_too_big(int hp, int wp) {
  return static_cast<long long>(hp + 2 * kHaloY) * (wp + 2 * kHaloX) *
             kHaloC >= (1LL << 31);
}

template <typename Kernel>
int active_clusters(Kernel kernel, int cluster, int threads) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return -static_cast<int>(e);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(
      dim3(cluster, 1, 1), threads, cluster, nullptr, &attr);
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

}  // namespace

// How many clusters of `cluster` CTAs of `threads` threads the card holds
// at once of every clustered instance of K8 (the least of them); a
// negative CUDA error code when a query fails.
extern "C" int warp_tiles_active_clusters(int cluster, int threads) {
  const int n[4] = {
      active_clusters(warp_tiles_halo_kernel<true>, cluster, threads),
      active_clusters(warp_tiles_frame_kernel<1>, cluster, threads),
      active_clusters(warp_tiles_frame_kernel<3>, cluster, threads),
      active_clusters(warp_tiles_frame_kernel<5>, cluster, threads)};
  int least = n[0];
  for (int v : n) {
    if (v < 0) return v;
    least = v < least ? v : least;
  }
  return least;
}

// Layout (a). table: (5, hp + 64, wp + 256) bf16; flow: (2, hp, wp) f32
// with zero pads, 16-byte aligned; counts: (hp / th, wp / sw) f32; out:
// (5, hp, wp) f32; sw % 4 == 0.
// cluster: CTAs per tile (1-16, <= th); threads: per CTA (32-1024, a
// multiple of 32). One cluster launch on `stream`; returns its CUDA
// error.
extern "C" int warp_tiles_halo_launch(const void* table, const void* flow,
                                      const void* counts, void* out, int hp,
                                      int wp, int th, int sw, int bres,
                                      int cluster, int threads,
                                      void* stream) {
  if (th < 1 || sw < 4 || sw % 4 || hp % th || wp % sw || bres < 0 ||
      cluster > th || halo_too_big(hp, wp)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch(warp_tiles_halo_kernel<true>, true, cluster, wp / sw,
                hp / th, threads, stream,
                static_cast<const __nv_bfloat16*>(table),
                static_cast<const float*>(flow),
                static_cast<const float*>(counts), static_cast<float*>(out),
                hp, wp, th, sw, bres);
}

// Layout (a) with no base (the floor "Z"): the same taps at residual
// clamp(flow, +-bres) around each pixel, `slabs` CTAs per tile, no
// cluster.
extern "C" int warp_tiles_halo_nobase_launch(const void* table,
                                             const void* flow, void* out,
                                             int hp, int wp, int th, int sw,
                                             int bres, int slabs, int threads,
                                             void* stream) {
  if (th < 1 || sw < 1 || hp % th || wp % sw || bres < 0 || slabs > th ||
      halo_too_big(hp, wp)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch(warp_tiles_halo_kernel<false>, false, slabs, wp / sw,
                hp / th, threads, stream,
                static_cast<const __nv_bfloat16*>(table),
                static_cast<const float*>(flow), nullptr,
                static_cast<float*>(out), hp, wp, th, sw, bres);
}

// Layout (b). table: (h, w, channels) f32, channels 1, 3 or 5; flow:
// (h, w, 2) f32, 16-byte aligned; out: (h, w, channels) f32. Tiles
// (th, tw) over the frame (ceil(h / th) x ceil(w / tw)); cluster: CTAs per
// tile (1-16, <= th); threads as above. One cluster launch on `stream`;
// returns its CUDA error.
extern "C" int warp_tiles_frame_launch(const void* table, const void* flow,
                                       void* out, int h, int w, int channels,
                                       int th, int tw, int bres, int max_base,
                                       int cluster, int threads,
                                       void* stream) {
  if (h < 1 || w < 1 || th < 1 || tw < 1 || bres < 0 || max_base < 0 ||
      cluster > th ||
      static_cast<long long>(h) * w * channels >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int ntx = (w + tw - 1) / tw, nty = (h + th - 1) / th;
  const float* t = static_cast<const float*>(table);
  const float* f = static_cast<const float*>(flow);
  float* o = static_cast<float*>(out);
  switch (channels) {
    case 1:
      return launch(warp_tiles_frame_kernel<1>, true, cluster, ntx, nty,
                    threads, stream, t, f, o, h, w, th, tw, bres, max_base);
    case 3:
      return launch(warp_tiles_frame_kernel<3>, true, cluster, ntx, nty,
                    threads, stream, t, f, o, h, w, th, tw, bres, max_base);
    case 5:
      return launch(warp_tiles_frame_kernel<5>, true, cluster, ntx, nty,
                    threads, stream, t, f, o, h, w, th, tw, bres, max_base);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
