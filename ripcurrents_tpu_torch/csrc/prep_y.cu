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
// (3*ph, w) and K6 reads every row of it. The host hands over each output
// row's contiguous source window [lo, lo + len) of the bf16-rounded matrix
// and its weights (len 0 for a pad row), and one thread computes one
// output: a single f32 accumulator over the window in ascending source row,
// each product of two bf16 values exact in f32, stored as bf16 (round to
// nearest even). Built with
// -fmad=false and written with __fmul_rn / __fadd_rn, so the plain PyTorch
// version (flow/prep_kernel.py: prep_y_plain) sums the same way and agrees
// bit for bit.
//
// Bound: bytes at the finest level (the frame read once, t written once),
// operations at the coarse levels, whose windows are ~4x longer. A warp spans 32 columns of one output row, so its weight
// reads are broadcasts and its frame reads are coalesced.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTileX = 32;
constexpr int kTileY = 8;

__global__ void __launch_bounds__(kTileX * kTileY)
prep_y_kernel(const float* __restrict__ img, const int* __restrict__ lo,
              const int* __restrict__ len, const float* __restrict__ wy,
              __nv_bfloat16* __restrict__ t, int w, int rows, int ly) {
  const int x = blockIdx.x * kTileX + threadIdx.x;
  const int r = blockIdx.y * kTileY + threadIdx.y;
  if (x >= w || r >= rows) return;
  const int l0 = lo[r];
  const int n = len[r];
  const float* wr = wy + static_cast<size_t>(r) * ly;
  const float* src = img + static_cast<size_t>(l0) * w + x;
  float acc = 0.0f;
  for (int j = 0; j < n; ++j) {
    const float v = __bfloat162float(
        __float2bfloat16_rn(src[static_cast<size_t>(j) * w]));
    acc = __fadd_rn(acc, __fmul_rn(wr[j], v));
  }
  t[static_cast<size_t>(r) * w + x] = __float2bfloat16_rn(acc);
}

}  // namespace

// img: (h, w) f32 frame; lo, len: (rows,) int32 source window of each
// output row; wy: (rows, ly) f32 window weights (bf16 values, zero past
// len); t: (rows, w) bf16 out. Launches on `stream`; returns the CUDA
// error of the launch.
extern "C" int prep_y_launch(const void* img, const void* lo, const void* len,
                             const void* wy, void* t, int h, int w, int rows,
                             int ly, void* stream) {
  (void)h;
  const dim3 grid((w + kTileX - 1) / kTileX, (rows + kTileY - 1) / kTileY);
  const dim3 block(kTileX, kTileY);
  prep_y_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), static_cast<const int*>(lo),
      static_cast<const int*>(len), static_cast<const float*>(wy),
      static_cast<__nv_bfloat16*>(t), w, rows, ly);
  return static_cast<int>(cudaGetLastError());
}
