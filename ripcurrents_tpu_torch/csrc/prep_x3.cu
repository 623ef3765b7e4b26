// K6 prep_x3: the x pass of the per-level Farneback expansion prep and the
// five-channel combine.
//
// Replaces the TPU kernel ripcurrents_tpu/flow/prep_pallas.py:
// poly_exp_level_pallas (x_kernel), which multiplies column strips of the
// y-pass result t (3*ps, w) bf16 by the fused [g | xg | xxg] x matrices
// (bf16, f32 accumulation) and combines the six products
//   b1 = t_g  x g,  b3 = t_xg x g,  b5 = t_xxg x g,
//   b2 = t_g  x xg, b6 = t_xg x xg, b4 = t_g   x xxg
// into the expansion channels
//   [b2*ig11, b3*ig11, b1*ig03 + b4*ig33, b1*ig03 + b5*ig33, b6*ig55]
// stored in the table's dtype.
//
// Here t is (3*ph, w), its g, xg and xxg sections at rows 0, ph and 2*ph.
// The host hands over each output column's contiguous source window
// [lo, lo + len) over the union of the three bf16-rounded x matrices, and
// their weights as (3, lx, pw) so that a warp's weight reads are
// coalesced. One thread computes one output pixel (row r, column c): six
// f32 accumulators over the window in ascending source column, products
// of two bf16 values exact in f32, then the combine with separate roundings
// (-fmad=false, __fmul_rn / __fadd_rn), as the plain PyTorch version
// (flow/prep_kernel.py: prep_x3_plain) computes it: they agree bit for bit.
// Pad rows read zero rows of t and pad columns have len 0, so pads come out
// exactly zero. The output is channels first (5, ph, pw) or channels last
// (ph, pw, 5), bf16 or f32.
//
// Bound: bytes at the finest level (t read once, the five channels written
// once), operations at the coarse levels.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTileX = 32;
constexpr int kTileY = 8;

__global__ void __launch_bounds__(kTileX * kTileY)
prep_x3_kernel(const __nv_bfloat16* __restrict__ t, const int* __restrict__ lo,
               const int* __restrict__ len, const float* __restrict__ wx,
               void* __restrict__ out, int w, int ph, int pw, int lx,
               float ig11, float ig03, float ig33, float ig55, int out_bf16,
               int channels_first) {
  const int c = blockIdx.x * kTileX + threadIdx.x;
  const int r = blockIdx.y * kTileY + threadIdx.y;
  if (c >= pw || r >= ph) return;
  const int l0 = lo[c];
  const int n = len[c];
  const __nv_bfloat16* t0 = t + static_cast<size_t>(r) * w + l0;
  const __nv_bfloat16* t1 = t + static_cast<size_t>(ph + r) * w + l0;
  const __nv_bfloat16* t2 = t + static_cast<size_t>(2 * ph + r) * w + l0;
  const size_t plane = static_cast<size_t>(lx) * pw;
  const float* wg = wx + c;
  const float* wxg = wx + plane + c;
  const float* wxxg = wx + 2 * plane + c;
  float b1 = 0.0f, b2 = 0.0f, b3 = 0.0f, b4 = 0.0f, b5 = 0.0f, b6 = 0.0f;
  for (int j = 0; j < n; ++j) {
    const float s0 = __bfloat162float(t0[j]);
    const float s1 = __bfloat162float(t1[j]);
    const float s2 = __bfloat162float(t2[j]);
    const size_t k = static_cast<size_t>(j) * pw;
    const float g = wg[k], xg = wxg[k], xxg = wxxg[k];
    b1 = __fadd_rn(b1, __fmul_rn(s0, g));
    b3 = __fadd_rn(b3, __fmul_rn(s1, g));
    b5 = __fadd_rn(b5, __fmul_rn(s2, g));
    b2 = __fadd_rn(b2, __fmul_rn(s0, xg));
    b6 = __fadd_rn(b6, __fmul_rn(s1, xg));
    b4 = __fadd_rn(b4, __fmul_rn(s0, xxg));
  }
  float o[5];
  o[0] = __fmul_rn(b2, ig11);
  o[1] = __fmul_rn(b3, ig11);
  o[2] = __fadd_rn(__fmul_rn(b1, ig03), __fmul_rn(b4, ig33));
  o[3] = __fadd_rn(__fmul_rn(b1, ig03), __fmul_rn(b5, ig33));
  o[4] = __fmul_rn(b6, ig55);
  const size_t px = static_cast<size_t>(r) * pw + c;
  const size_t chan = static_cast<size_t>(ph) * pw;
  for (int ch = 0; ch < 5; ++ch) {
    const size_t at = channels_first ? ch * chan + px : px * 5 + ch;
    if (out_bf16) {
      static_cast<__nv_bfloat16*>(out)[at] = __float2bfloat16_rn(o[ch]);
    } else {
      static_cast<float*>(out)[at] = o[ch];
    }
  }
}

}  // namespace

// t: (3*ph, w) bf16 y-pass result (sections g, xg, xxg at row 0, ph, 2*ph);
// lo, len: (pw,) int32 source window of each output column; wx: (3, lx, pw)
// f32 weights of the g, xg and xxg x matrices (bf16 values, zero past len);
// out: (5, ph, pw) if channels_first else (ph, pw, 5), bf16 if out_bf16
// else f32. Launches on `stream`; returns the CUDA error of the launch.
extern "C" int prep_x3_launch(const void* t, const void* lo, const void* len,
                              const void* wx, void* out, int w, int ph,
                              int pw, int lx, float ig11, float ig03,
                              float ig33, float ig55, int out_bf16,
                              int channels_first, void* stream) {
  const dim3 grid((pw + kTileX - 1) / kTileX, (ph + kTileY - 1) / kTileY);
  const dim3 block(kTileX, kTileY);
  prep_x3_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(t), static_cast<const int*>(lo),
      static_cast<const int*>(len), static_cast<const float*>(wx), out, w, ph,
      pw, lx, ig11, ig03, ig33, ig55, out_bf16, channels_first);
  return static_cast<int>(cudaGetLastError());
}
