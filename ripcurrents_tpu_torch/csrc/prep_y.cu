// K5 prep_y: the y pass of the per-level Farneback expansion prep.
//
// Replaces the TPU kernel ripcurrents_tpu/flow/prep_pallas.py:
// poly_exp_level_pallas (y_kernel), which computes
// t (3*ps, w) bf16 = by3^T (3*ps, h) . bf16(img (h, w)) with f32
// accumulation in 128-row blocks fed by aligned DMA windows. by3 stacks the
// composed (pre-smooth o pyramid resize o expansion correlation) y matrices
// of the g, xg and xxg kernels at a 128-row section stride, with zero rows
// for the canvas pads.
//
// Here by3 stacks its sections at the canvas's own row count ph, so t is
// (3*ph, w) and K6 reads every row of it. Each output is one f32
// accumulator over its source window in ascending source row, each product
// of two bf16 values exact in f32, stored as bf16 (round to nearest even).
// Built with -fmad=false and written with __fmul_rn / __fadd_rn, so the
// plain PyTorch version (flow/prep_kernel.py: prep_y_plain) sums the same
// way and agrees bit for bit.
//
// Bound. The composed matrices take every level straight from the
// full-resolution frame, so t is frame-wide at every level and a level row's
// window is ~33 / 64 / 130 / 260 source rows at levels 0-3: the taps per
// level stay ~30 M at 640x480 (~200 M at 1080p). Level 0 moves the frame
// (f32) and t (bf16) once, 1.2 + 2.1 MB at 640x480, ~1 us at 3.35 TB/s; its
// 30 M taps are 60 M operations, 0.9 us at 67 TFLOP/s counted as FMAs. With
// -fmad=false each product and each add is an instruction of its own, so
// the floor of issued arithmetic is twice that, ~1.8 us, and the coarse
// levels (the same taps, a quarter of the bytes or less) are bound by it.
//
// Design. A block takes 8 level rows of the nonzero rows (one warp each,
// all three sections, which share their window) and 32 * C frame columns
// (C = 1 or 2 adjacent columns a lane, 2 where the level has warps to
// spare). It stages the source rows its warps read with 16-byte cp.async
// copies, all in flight at once, and rounds them to bf16 once in place (a
// scalar edge path for a ragged width, zeros past the frame), and the
// warps' weights,
// widened on the host to each row's window aligned to 4 taps with zero
// weights on the widened taps (zero products leave the sum unchanged). The
// loop then runs from shared memory: per 4 taps a warp reads its 3 weight
// quads as broadcasts, and each lane reads C frame values per tap and adds
// 3 * C products. Blocks past the row tiles write the pad rows' zeros
// without a loop.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// The tile size comes from the build (ripcurrents_tpu_torch/kernels.py:
// DEFINES), where the host plan reads it too.
#ifndef PREP_Y_WARPS
#error "build with -DPREP_Y_WARPS=<level rows a block>"
#endif

namespace {

constexpr int kWarps = PREP_Y_WARPS;
constexpr int kDefaultShared = 48 * 1024;
constexpr int kThreads = 32 * kWarps;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <int C>
__global__ void __launch_bounds__(kThreads)
prep_y_kernel(const float* __restrict__ img, const int2* __restrict__ span,
              const float* __restrict__ wy_u, const int2* __restrict__ tiles,
              __nv_bfloat16* __restrict__ t, int h, int w, int ph, int row0,
              int row1, int taps, int row_tiles) {
  constexpr int kTx = 32 * C;
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int x0 = blockIdx.x * kTx;

  if (static_cast<int>(blockIdx.y) >= row_tiles) {
    // pad rows: zeros in all three sections
    const int i = (blockIdx.y - row_tiles) * kWarps + warp;
    if (i >= ph - (row1 - row0)) return;
    const int y = i < row0 ? i : row1 + (i - row0);
    for (int k = 0; k < 3; ++k) {
      for (int c = 0; c < C; ++c) {
        const int x = x0 + lane * C + c;
        if (x < w) {
          t[static_cast<size_t>(k * ph + y) * w + x] =
              __float2bfloat16_rn(0.0f);
        }
      }
    }
    return;
  }

  const int y0 = row0 + blockIdx.y * kWarps;
  const int nrows = min(kWarps, row1 - y0);
  const int2 tile = tiles[blockIdx.y];
  float* src = smem;                        // (tile.y, kTx) bf16-rounded
  float* wts = smem + tile.y * kTx;         // (kWarps, 3, taps)
  // the weights of the block's rows: contiguous in wy_u, taps % 4 == 0
  const float* wsrc = wy_u + static_cast<size_t>(y0) * 3 * taps;
  for (int e = threadIdx.x; e < nrows * 3 * taps / 4; e += kThreads) {
    cp_async16(wts + 4 * e, wsrc + 4 * e);
  }
  // the tile's source rows, rounded to bf16 once: 16-byte copies all in
  // flight, then each thread rounds the chunks it copied
  if ((w & 3) == 0 && x0 + kTx <= w) {
    for (int e = threadIdx.x; e < tile.y * (kTx / 4); e += kThreads) {
      const int r = e / (kTx / 4);
      const int row = tile.x + r;
      float* dst = src + 4 * e;
      if (row < h) {
        cp_async16(dst, img + static_cast<size_t>(row) * w + x0 +
                            4 * (e - r * (kTx / 4)));
      } else {
        *reinterpret_cast<float4*>(dst) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    for (int e = threadIdx.x; e < tile.y * (kTx / 4); e += kThreads) {
      float4* at = reinterpret_cast<float4*>(src) + e;
      const float4 v = *at;
      *at = make_float4(bf16_round(v.x), bf16_round(v.y), bf16_round(v.z),
                        bf16_round(v.w));
    }
  } else {
    for (int e = threadIdx.x; e < tile.y * kTx; e += kThreads) {
      const int r = e / kTx;
      const int x = x0 + (e - r * kTx);
      const int row = tile.x + r;
      src[e] = row < h && x < w
                   ? bf16_round(img[static_cast<size_t>(row) * w + x])
                   : 0.0f;
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  if (warp >= nrows) return;

  const int y = y0 + warp;
  const int2 sp = span[y];                  // (start, count)
  const float* s = src + (sp.x - tile.x) * kTx + lane * C;
  const float* wg = wts + warp * 3 * taps;
  const float* wxg = wg + taps;
  const float* wxxg = wxg + taps;
  float a0[C], a1[C], a2[C];
#pragma unroll
  for (int c = 0; c < C; ++c) a0[c] = a1[c] = a2[c] = 0.0f;
#pragma unroll 2
  for (int j = 0; j < sp.y; j += 4) {
    const float4 g4 = *reinterpret_cast<const float4*>(wg + j);
    const float4 x4 = *reinterpret_cast<const float4*>(wxg + j);
    const float4 xx4 = *reinterpret_cast<const float4*>(wxxg + j);
    const float g[4] = {g4.x, g4.y, g4.z, g4.w};
    const float xg[4] = {x4.x, x4.y, x4.z, x4.w};
    const float xxg[4] = {xx4.x, xx4.y, xx4.z, xx4.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float v[C];
      if constexpr (C == 2) {
        const float2 p = *reinterpret_cast<const float2*>(s + (j + q) * kTx);
        v[0] = p.x;
        v[1] = p.y;
      } else {
        v[0] = s[(j + q) * kTx];
      }
#pragma unroll
      for (int c = 0; c < C; ++c) {
        a0[c] = __fadd_rn(a0[c], __fmul_rn(g[q], v[c]));
        a1[c] = __fadd_rn(a1[c], __fmul_rn(xg[q], v[c]));
        a2[c] = __fadd_rn(a2[c], __fmul_rn(xxg[q], v[c]));
      }
    }
  }
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int x = x0 + lane * C + c;
    if (x < w) {
      t[static_cast<size_t>(y) * w + x] = __float2bfloat16_rn(a0[c]);
      t[static_cast<size_t>(ph + y) * w + x] = __float2bfloat16_rn(a1[c]);
      t[static_cast<size_t>(2 * ph + y) * w + x] = __float2bfloat16_rn(a2[c]);
    }
  }
}

template <int C>
int launch(const float* img, const int2* span, const float* wy_u,
           const int2* tiles, __nv_bfloat16* t, int h, int w, int ph,
           int row0, int row1, int taps, int row_tiles, int zero_tiles,
           int shared, cudaStream_t stream) {
  if (shared > kDefaultShared) {
    const cudaError_t e = cudaFuncSetAttribute(
        prep_y_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        shared);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((w + 32 * C - 1) / (32 * C), row_tiles + zero_tiles);
  prep_y_kernel<C><<<grid, kThreads, shared, stream>>>(
      img, span, wy_u, tiles, t, h, w, ph, row0, row1, taps, row_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// img: (h, w) f32 frame; span: (ph, 2) int32 widened window (start, count)
// of each level row, count % 4 == 0; wy_u: (ph, 3, taps) f32 weights of
// the three sections over the widened windows (bf16 values, zero outside
// each window); tiles: (row_tiles, 2) int32 staged source rows (first, n)
// of each tile of kWarps level rows from row0; t: (3*ph, w) bf16 out. cols
// (1 or 2) frame columns a lane; shared: dynamic shared-memory bytes (the
// block's limit is raised to it above 48 KB). Launches on `stream`;
// returns the CUDA error of the launch.
extern "C" int prep_y_launch(const void* img, const void* span,
                             const void* wy_u, const void* tiles, void* t,
                             int h, int w, int ph, int row0, int row1,
                             int taps, int row_tiles, int zero_tiles,
                             int cols, int shared, void* stream) {
  const auto* i = static_cast<const float*>(img);
  const auto* s = static_cast<const int2*>(span);
  const auto* wu = static_cast<const float*>(wy_u);
  const auto* tl = static_cast<const int2*>(tiles);
  auto* o = static_cast<__nv_bfloat16*>(t);
  const auto st = static_cast<cudaStream_t>(stream);
  if (cols == 2) {
    return launch<2>(i, s, wu, tl, o, h, w, ph, row0, row1, taps, row_tiles,
                     zero_tiles, shared, st);
  }
  return launch<1>(i, s, wu, tl, o, h, w, ph, row0, row1, taps, row_tiles,
                   zero_tiles, shared, st);
}
