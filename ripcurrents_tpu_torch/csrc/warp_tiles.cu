// K8 warp_tiles: the tiled base + residual warp of a 5-channel expansion
// table on Hopper (sm_90a).
//
// Replaces the TPU kernel of tools/bench_warp_variants.py: run (the
// pallas_call whose body make_kernel builds): variant "A" runs the fused
// engine's warp stage ripcurrents_tpu/flow/fused_update.py: _warp_subcols
// (_block_base, _shift_block, _tap_sum) alone over a halo'd bf16 table,
// and variant "Z" the same taps with no base (_warp_z). The same algebra is
// the portable engine's tiled warp, ripcurrents_tpu/flow/farneback.py:
// _warp5_tiled, which this kernel also computes. Per tile of (th, tw)
// pixels, the integer base is the rounded mean of the tile's real-pixel
// flow, clamped; each pixel samples the table bilinearly at base + its
// residual clamped to +-bres.
//
// The TPU has no per-lane gather, so it rolls a halo block by the base and
// sums (2*bres+1)^2 shifted multiply-adds. Here each thread gathers: the
// sample is the plain 4-tap bilinear read, which equals the TPU's tap sum
// because the residual is clamped to +-bres (weights outside the two
// bracketing taps are exactly zero; see csrc/farneback_update.cu). The tap
// weights are formed as the TPU's hat functions round them: w0 = 1 - frac,
// w1 = 1 - w0.
//
// One function, two layouts, taken as strides (the Geom below) and a
// template on the table's type:
//   (a) halo: table (5, hp + 64, wp + 256) bf16 with the frame at (32, 128),
//       flow (2, hp, wp) f32 with zero pads, tiles (th, sw), the base
//       clamped to +-(HALO - bres - 1) so every tap stays in the halo; out
//       (5, hp, wp) f32 (_warp_subcols);
//   (b) frame: table (h, w, 5) f32, zero outside [0, h) x [0, w), flow
//       (h, w, 2) f32, tiles (th, tw) over the frame padded with zero flow
//       to whole tiles, the base clamped to +-max_base; out (h, w, 5) f32
//       (_warp5_tiled, without its zero-padded copy of the table).
// Every table read is bounds-checked and a read outside the table is 0:
// a weight of 0 times a value past the edge would be NaN if that value
// were.
//
// What bounds it: bytes. At 1080p in layout (a) the table's 5 bf16
// channels (20.7 MB), the flow (16.6 MB) and the f32 output (41.5 MB):
// ~79 MB, ~24 us at 3.35 TB/s; ~80 flops per pixel are far below. The
// design fills the card: the base needs a reduction over the whole tile
// (45 tiles at 1080p), so a first pass sums row slabs of every tile (one
// block per slab, ~2048 pixels each, partial sums in double), and the
// sampling pass runs one thread per pixel in blocks of 32 x 8 pixels of
// one tile; each block adds its tile's partials in a fixed order, in
// double, so the base does not depend on the summation order (as K1's
// base). Built with -fmad=false so each product and sum rounds as the
// plain PyTorch version's separate tensor ops do (flow/warp_kernel.py:
// warp_tiles_plain).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kHaloY = 32;
constexpr int kHaloX = 128;
constexpr int kSumThreads = 256;
constexpr int kBlockX = 32;
constexpr int kBlockY = 8;
constexpr int kMaxSplits = 64;

struct Geom {
  // table: element strides of channel, row and column; where pixel (0, 0)
  // of the frame lies in it; its extent (reads outside it are 0)
  long long t_c, t_r, t_x;
  int t_oy, t_ox, t_rows, t_cols;
  // flow: strides of component, row and column; the extent summed (pixels
  // outside it count as zero flow)
  long long f_c, f_r, f_x;
  int f_rows, f_cols;
  // output: strides; the extent written
  long long o_c, o_r, o_x;
  int o_rows, o_cols;
  // tiles, the row slabs of the base pass, the residual and base clamps
  int th, tw, nty, ntx, rows_per_split, nsplit;
  int bres, lim_x, lim_y;
};

__device__ __forceinline__ double warp_sum(double v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float value(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float value(const float* p) { return *p; }

// Pass 1: the double sums of both flow components over one row slab of
// one tile, written to part[(ty * ntx + tx) * nsplit + slab].
__global__ void __launch_bounds__(kSumThreads)
tile_sums_kernel(const float* __restrict__ flow, double2* __restrict__ part,
                 Geom g) {
  const int tx = blockIdx.x, ty = blockIdx.y, s = blockIdx.z;
  const int y0 = ty * g.th + s * g.rows_per_split;
  const int y1 = min(min(y0 + g.rows_per_split, (ty + 1) * g.th), g.f_rows);
  const int x0 = tx * g.tw;
  const int nx = max(min(x0 + g.tw, g.f_cols) - x0, 0);
  const int n = max(y1 - y0, 0) * nx;
  double sx = 0.0, sy = 0.0;
  for (int k = threadIdx.x; k < n; k += kSumThreads) {
    const size_t idx = static_cast<size_t>(y0 + k / nx) * g.f_r +
                       static_cast<size_t>(x0 + k % nx) * g.f_x;
    sx += flow[idx];
    sy += flow[idx + g.f_c];
  }
  __shared__ double red[2][kSumThreads / 32];
  sx = warp_sum(sx);
  sy = warp_sum(sy);
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  if (lane == 0) {
    red[0][wid] = sx;
    red[1][wid] = sy;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double tx_sum = 0.0, ty_sum = 0.0;
    for (int k = 0; k < kSumThreads / 32; ++k) {
      tx_sum += red[0][k];
      ty_sum += red[1][k];
    }
    part[(ty * g.ntx + tx) * g.nsplit + s] = make_double2(tx_sum, ty_sum);
  }
}

// Pass 2: one thread per output pixel, a block per 32 x 8 pixels of one
// tile. kBase false is the no-base floor (variant "Z"): base 0, no pass 1.
template <typename T, bool kBase>
__global__ void __launch_bounds__(kBlockX * kBlockY)
warp_tiles_kernel(const T* __restrict__ table, const float* __restrict__ flow,
                  const float* __restrict__ counts,
                  const double2* __restrict__ part, float* __restrict__ out,
                  Geom g) {
  const int nbx = (g.tw + kBlockX - 1) / kBlockX;
  const int nby = (g.th + kBlockY - 1) / kBlockY;
  const int tx = blockIdx.x / nbx, ty = blockIdx.y / nby;
  const int lx = (blockIdx.x % nbx) * kBlockX + threadIdx.x;
  const int ly = (blockIdx.y % nby) * kBlockY + threadIdx.y;

  int bx = 0, by = 0;
  if (kBase) {
    __shared__ double2 ps[kMaxSplits];
    __shared__ int base[2];
    const int t = threadIdx.y * kBlockX + threadIdx.x;
    const int tile = ty * g.ntx + tx;
    if (t < g.nsplit) ps[t] = part[tile * g.nsplit + t];
    __syncthreads();
    if (t == 0) {
      double sx = 0.0, sy = 0.0;
      for (int k = 0; k < g.nsplit; ++k) {
        sx += ps[k].x;
        sy += ps[k].y;
      }
      const float cnt = counts[tile];
      const float lx_f = static_cast<float>(g.lim_x);
      const float ly_f = static_cast<float>(g.lim_y);
      // rintf rounds half to even, as jnp.round does.
      base[0] = static_cast<int>(
          fminf(fmaxf(rintf(static_cast<float>(sx) / cnt), -lx_f), lx_f));
      base[1] = static_cast<int>(
          fminf(fmaxf(rintf(static_cast<float>(sy) / cnt), -ly_f), ly_f));
    }
    __syncthreads();
    bx = base[0];
    by = base[1];
  }

  const int x = tx * g.tw + lx, y = ty * g.th + ly;
  if (lx >= g.tw || ly >= g.th || x >= g.o_cols || y >= g.o_rows) return;
  const size_t fi = static_cast<size_t>(y) * g.f_r +
                    static_cast<size_t>(x) * g.f_x;
  const float dx = flow[fi], dy = flow[fi + g.f_c];
  const float fb = static_cast<float>(g.bres);
  const float rx = fminf(fmaxf(dx - static_cast<float>(bx), -fb), fb);
  const float ry = fminf(fmaxf(dy - static_cast<float>(by), -fb), fb);
  const float flx = floorf(rx), fly = floorf(ry);
  const float wx0 = 1.f - (rx - flx), wx1 = 1.f - wx0;
  const float wy0 = 1.f - (ry - fly), wy1 = 1.f - wy0;
  // Top-left tap in table coordinates and which of the four taps lie in
  // the table.
  const int r0 = y + g.t_oy + by + static_cast<int>(fly);
  const int c0 = x + g.t_ox + bx + static_cast<int>(flx);
  const bool rin[2] = {r0 >= 0 && r0 < g.t_rows,
                       r0 + 1 >= 0 && r0 + 1 < g.t_rows};
  const bool cin[2] = {c0 >= 0 && c0 < g.t_cols,
                       c0 + 1 >= 0 && c0 + 1 < g.t_cols};
  const size_t oi = static_cast<size_t>(y) * g.o_r +
                    static_cast<size_t>(x) * g.o_x;

#pragma unroll
  for (int c = 0; c < 5; ++c) {
    const T* tc = table + c * g.t_c;
    float v[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        v[i][j] = (rin[i] && cin[j])
                      ? value(tc + static_cast<size_t>(r0 + i) * g.t_r +
                              static_cast<size_t>(c0 + j) * g.t_x)
                      : 0.f;
      }
    }
    const float a = wx0 * v[0][0] + wx1 * v[0][1];
    const float b = wx0 * v[1][0] + wx1 * v[1][1];
    out[oi + c * g.o_c] = wy0 * a + wy1 * b;
  }
}

int launch_sample(const void* table, bool bf16, bool with_base,
                  const void* flow, const void* counts, void* part, void* out,
                  const Geom& g, cudaStream_t stream) {
  if (g.th < 1 || g.tw < 1 || g.bres < 0 || g.nsplit < 1 ||
      g.nsplit > kMaxSplits) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* fl = static_cast<const float*>(flow);
  const float* cn = static_cast<const float*>(counts);
  double2* pt = static_cast<double2*>(part);
  float* o = static_cast<float*>(out);
  if (with_base) {
    tile_sums_kernel<<<dim3(g.ntx, g.nty, g.nsplit), kSumThreads, 0,
                       stream>>>(fl, pt, g);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(g.ntx * ((g.tw + kBlockX - 1) / kBlockX),
                  g.nty * ((g.th + kBlockY - 1) / kBlockY));
  const dim3 block(kBlockX, kBlockY);
  if (bf16 && with_base) {
    warp_tiles_kernel<__nv_bfloat16, true><<<grid, block, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(table), fl, cn, pt, o, g);
  } else if (bf16) {
    warp_tiles_kernel<__nv_bfloat16, false><<<grid, block, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(table), fl, cn, pt, o, g);
  } else {
    warp_tiles_kernel<float, true><<<grid, block, 0, stream>>>(
        static_cast<const float*>(table), fl, cn, pt, o, g);
  }
  return static_cast<int>(cudaGetLastError());
}

Geom halo_geom(int hp, int wp, int th, int sw, int bres,
               int rows_per_split) {
  Geom g{};
  g.t_rows = hp + 2 * kHaloY;
  g.t_cols = wp + 2 * kHaloX;
  g.t_c = static_cast<long long>(g.t_rows) * g.t_cols;
  g.t_r = g.t_cols;
  g.t_x = 1;
  g.t_oy = kHaloY;
  g.t_ox = kHaloX;
  g.f_c = g.o_c = static_cast<long long>(hp) * wp;
  g.f_r = g.o_r = wp;
  g.f_x = g.o_x = 1;
  g.f_rows = g.o_rows = hp;
  g.f_cols = g.o_cols = wp;
  g.th = th;
  g.tw = sw;
  g.nty = hp / th;
  g.ntx = wp / sw;
  g.rows_per_split = rows_per_split;
  g.nsplit = (th + rows_per_split - 1) / rows_per_split;
  g.bres = bres;
  g.lim_x = kHaloX - bres - 1;
  g.lim_y = kHaloY - bres - 1;
  return g;
}

}  // namespace

// Layout (a). table: (5, hp + 64, wp + 256) bf16; flow: (2, hp, wp) f32
// with zero pads; counts: (hp / th, wp / sw) f32; part: scratch of
// (hp / th) * (wp / sw) * ceil(th / rows_per_split) double2; out:
// (5, hp, wp) f32. Launches on `stream`; returns the CUDA error of the
// launches.
extern "C" int warp_tiles_halo_launch(const void* table, const void* flow,
                                      const void* counts, void* part,
                                      void* out, int hp, int wp, int th,
                                      int sw, int bres, int rows_per_split,
                                      void* stream) {
  if (rows_per_split < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Geom g = halo_geom(hp, wp, th, sw, bres, rows_per_split);
  return launch_sample(table, true, true, flow, counts, part, out, g,
                       static_cast<cudaStream_t>(stream));
}

// Layout (a) with no base (the no-base floor): the same taps at residual
// clamp(flow, +-bres) around each pixel. No counts, no scratch.
extern "C" int warp_tiles_halo_nobase_launch(const void* table,
                                             const void* flow, void* out,
                                             int hp, int wp, int th, int sw,
                                             int bres, void* stream) {
  const Geom g = halo_geom(hp, wp, th, sw, bres, th);
  return launch_sample(table, true, false, flow, nullptr, nullptr, out, g,
                       static_cast<cudaStream_t>(stream));
}

// Layout (b). table: (h, w, 5) f32; flow: (h, w, 2) f32; counts:
// (ceil(h / th), ceil(w / tw)) f32, each tile's real-pixel count (>= 1);
// part: scratch of ntiles * ceil(th / rows_per_split) double2; out:
// (h, w, 5) f32.
extern "C" int warp_tiles_frame_launch(const void* table, const void* flow,
                                       const void* counts, void* part,
                                       void* out, int h, int w, int th,
                                       int tw, int bres, int max_base,
                                       int rows_per_split, void* stream) {
  if (rows_per_split < 1 || th < 1 || tw < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Geom g{};
  g.t_c = g.f_c = g.o_c = 1;
  g.t_r = g.o_r = 5LL * w;
  g.t_x = g.o_x = 5;
  g.f_r = 2LL * w;
  g.f_x = 2;
  g.t_oy = g.t_ox = 0;
  g.t_rows = g.f_rows = g.o_rows = h;
  g.t_cols = g.f_cols = g.o_cols = w;
  g.th = th;
  g.tw = tw;
  g.nty = (h + th - 1) / th;
  g.ntx = (w + tw - 1) / tw;
  g.rows_per_split = rows_per_split;
  g.nsplit = (th + rows_per_split - 1) / rows_per_split;
  g.bres = bres;
  g.lim_x = g.lim_y = max_base;
  return launch_sample(table, false, true, flow, counts, part, out, g,
                       static_cast<cudaStream_t>(stream));
}
