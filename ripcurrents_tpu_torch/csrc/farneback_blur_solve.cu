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
// bf16-rounded taps (wx). A row whose window stays inside the image merges
// nothing, so its wy row equals wx.
//
// What bounds it. Every output is one ascending f32 sum of 2*half+1
// products per pass and channel, then ~12 operations of the solve. Every
// product is of two bf16 values (a bf16 tap times M, or times a mid value
// rounded to bf16), so it has at most 16 significant bits and is exact in
// f32 down to 2^-134: one FMA then rounds acc + w*v as the plain PyTorch
// version's rounded product and rounded add do. The arithmetic is thus
// 10 * (2*half+1) + ~12 instructions per pixel: ~1.1 us at 640x480 and
// ~7.5 us at 1080p for half = 5 at the card's 33.5 T instructions/s. At
// half = 1 (the legacy box 3) the bytes bound it: M read once (3.07 MB)
// and the flow written once (2.46 MB) at 640x480, ~1.7 us. Coarse levels
// are bound by one thread's chain of dependent loads and sums.
//
// Design. A block owns an output tile of `rows` x `cols` pixels (the host
// plans it per level: fused_update.blur_plan) and runs two phases:
// 1. the y pass: a thread owns a strip of RT output rows at two adjacent
//    columns of the tile or of its x halo (the x windows' extra columns,
//    rounded up to even). It walks the strip's source rows once, in
//    ascending order, reads each row's two values of each channel of M as
//    one 4-byte word from device memory (through L1, where the
//    neighbouring strips' overlapping rows hit; the replicate clamp
//    clamps the row index and picks the clamped columns' halves of the
//    word) and adds the product into every accumulator whose window holds
//    the row: per output the same products in the same order as the plain
//    loop, with one load per source row instead of one per tap. Strips
//    whose windows stay inside the image take the taps from the kernel's
//    parameters (the constant bank, no registers), the others read their
//    rows' merged weights. The RT x 2 x 5 accumulators are indexed by
//    constants (the kernel is a template on half and RT), so they stay in
//    registers. No barrier precedes this pass: each warp's loads
//    overlap the other warps' arithmetic. The bf16-rounded mid values go
//    to shared memory (f32, row pitch 4 mod 8 floats);
// 2. after one barrier, the x pass: a thread owns a run of kRun outputs of
//    one row (lanes over rows, so the 16-byte reads of 8 lanes fall on
//    distinct banks), streams the run's mid values once, solves in
//    registers and writes each channel of the flow as 16-byte stores, the
//    pads zeroed. A tile wholly in the pads only writes its zeros.
// Two strip lengths are built: 2 rows for levels with work to spare (fewer
// loads a product) and 1 row for coarse levels (the shortest chain a
// thread); runs are BLUR_RUN = 4 columns.
//
// Built with -fmad=false: the solve's products and sums (not exact) round
// one by one, as the plain version's tensor ops do, and the reciprocal is
// the correctly rounded 1 / det. Kernel and plain version
// (flow/fused_update.py: farneback_blur_solve_plain) agree bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// The block limit and the x run length come from the build
// (ripcurrents_tpu_torch/kernels.py: DEFINES), where the host plan reads
// them too.
#if !defined(BLUR_MAX_THREADS) || !defined(BLUR_RUN)
#error "build with -DBLUR_MAX_THREADS=<threads> -DBLUR_RUN=<columns>"
#endif

namespace {

constexpr int kMaxThreads = BLUR_MAX_THREADS;
constexpr int kRun = BLUR_RUN;
constexpr int kMaxHalf = 16;
constexpr int kDefaultShared = 48 * 1024;

// The bf16-rounded taps, passed by value: a kernel parameter lives in the
// constant bank, which an FFMA reads directly, so the taps take no
// registers.
struct Taps {
  float w[2 * kMaxHalf + 1];
};

// The bf16 value selected by `sel` (a __byte_perm selector: low or high
// half of `pair`) as f32.
__device__ __forceinline__ float bf16_half(unsigned pair, unsigned sel) {
  return __uint_as_float(__byte_perm(pair, 0u, sel));
}

// The y pass of one strip: RT outputs at two adjacent columns. `pairs`
// points at the 4-byte word of M's channel 0 that holds both columns'
// values in each row (channel stride `cs` words, row stride `rs` words),
// sel0 / sel1 select each column's half; `row0` is the image row of the
// strip's first tap, h the true height; `wrow` points at the merged
// weights of the strip's first output row (border strips); `taps` holds
// the taps.
template <int H, int RT, bool kBorder>
__device__ __forceinline__ void y_strip(const unsigned* __restrict__ pairs,
                                        size_t cs, int rs, unsigned sel0,
                                        unsigned sel1, int row0, int h,
                                        const float* __restrict__ wrow,
                                        const Taps& taps,
                                        float (&acc)[RT][2][5]) {
  constexpr int kNt = 2 * H + 1;
#pragma unroll
  for (int i = 0; i < RT + 2 * H; ++i) {
    const int row = kBorder ? min(max(row0 + i, 0), h - 1) : row0 + i;
    const unsigned* at = pairs + static_cast<size_t>(row) * rs;
    float v0[5], v1[5];
#pragma unroll
    for (int c = 0; c < 5; ++c) {
      const unsigned u = __ldg(at + c * cs);
      v0[c] = bf16_half(u, sel0);
      v1[c] = bf16_half(u, sel1);
    }
#pragma unroll
    for (int k = 0; k < RT; ++k) {
      const int o = i - k;
      if (o < 0 || o >= kNt) continue;
      const float wv = kBorder ? __ldg(wrow + k * kNt + o) : taps.w[o];
#pragma unroll
      for (int c = 0; c < 5; ++c) {
        acc[k][0][c] = __fmaf_rn(wv, v0[c], acc[k][0][c]);
        acc[k][1][c] = __fmaf_rn(wv, v1[c], acc[k][1][c]);
      }
    }
  }
}

template <int H, int RT>
__global__ void __launch_bounds__(kMaxThreads) farneback_blur_solve_kernel(
    const unsigned short* __restrict__ m, const float* __restrict__ wy,
    const Taps taps, float* __restrict__ flow, int h, int w, int hp, int wp,
    int rows, int cols, int pitch, int zero_pads) {
  static_assert(kRun % 4 == 0, "the x pass reads and writes 4 columns at once");
  constexpr int kNt = 2 * H + 1;
  constexpr int kHe = (H + 1) / 2 * 2;   // the x halo, rounded up to even
  constexpr int kOff = kHe - H;          // mid column of output x0's window
  extern __shared__ __align__(16) float mid[];   // (5, rows, pitch)
  const int y0 = blockIdx.y * rows, x0 = blockIdx.x * cols;
  const size_t plane = static_cast<size_t>(hp) * wp;
  const int tid = threadIdx.x;

  // a tile wholly in the pads only writes zeros
  const bool pad_tile = zero_pads && (y0 >= h || x0 >= w);

  // 1. the y pass: a strip of RT rows at mid columns 2j, 2j + 1 (image
  // columns x0 - kHe + 2j + {0, 1}, clamped) per thread
  const int npairs = cols / 2 + kHe;
  if (!pad_tile && tid < npairs * (rows / RT)) {
    const int s = tid / npairs;
    const int j = tid - s * npairs;
    const int yr = s * RT;
    const int yf = y0 + yr;
    if (yf < hp) {
      float acc[RT][2][5];
#pragma unroll
      for (int k = 0; k < RT; ++k)
#pragma unroll
        for (int c = 0; c < 5; ++c) acc[k][0][c] = acc[k][1][c] = 0.0f;
      // the aligned word holding both clamped columns, and each one's half
      const int xa = x0 - kHe + 2 * j;
      const int a = min(max(xa, 0), (w - 1) & ~1);
      const int c0 = min(max(xa, 0), w - 1), c1 = min(max(xa + 1, 0), w - 1);
      const unsigned sel0 = c0 > a ? 0x3244u : 0x1044u;
      const unsigned sel1 = c1 > a ? 0x3244u : 0x1044u;
      const unsigned* pairs = reinterpret_cast<const unsigned*>(m + a);
      if (yf - H >= 0 && yf + RT - 1 + H <= h - 1) {
        y_strip<H, RT, false>(pairs, plane / 2, wp / 2, sel0, sel1, yf - H,
                              h, nullptr, taps, acc);
      } else {
        y_strip<H, RT, true>(pairs, plane / 2, wp / 2, sel0, sel1, yf - H,
                             h, wy + static_cast<size_t>(yf) * kNt, taps,
                             acc);
      }
#pragma unroll
      for (int k = 0; k < RT; ++k)
#pragma unroll
        for (int c = 0; c < 5; ++c)
          *reinterpret_cast<float2*>(mid + (c * rows + yr + k) * pitch +
                                     2 * j) =
              make_float2(__bfloat162float(__float2bfloat16_rn(acc[k][0][c])),
                          __bfloat162float(__float2bfloat16_rn(acc[k][1][c])));
    }
  }
  if (!pad_tile) __syncthreads();   // block-uniform

  // 2. the x pass and the solve: a run of kRun outputs of one row a thread;
  // output x0 + c's window starts at mid column kOff + c
  if (tid >= rows * (cols / kRun)) return;
  const int g = tid / rows;
  const int r = tid - g * rows;
  const int y = y0 + r, xb = x0 + g * kRun;
  if (y >= hp || xb >= wp) return;
  float* o0 = flow + static_cast<size_t>(y) * wp + xb;
  if (pad_tile) {
#pragma unroll
    for (int q = 0; q < kRun; q += 4) {
      *reinterpret_cast<float4*>(o0 + q) = make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(o0 + plane + q) =
          make_float4(0.f, 0.f, 0.f, 0.f);
    }
    return;
  }
  constexpr int kSpan = kOff + kRun + 2 * H;
  constexpr int kQuads = (kSpan + 3) / 4;
  float a[kRun][5];
#pragma unroll
  for (int q = 0; q < kRun; ++q)
#pragma unroll
    for (int c = 0; c < 5; ++c) a[q][c] = 0.0f;
  const float* base = mid + r * pitch + g * kRun;
  const int cstride = rows * pitch;
#pragma unroll
  for (int q4 = 0; q4 < kQuads; ++q4) {
    float4 v4[5];
#pragma unroll
    for (int c = 0; c < 5; ++c)
      v4[c] = *reinterpret_cast<const float4*>(base + c * cstride + 4 * q4);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int jj = 4 * q4 + e - kOff;
      if (jj < 0) continue;
      if (jj >= kRun + 2 * H) break;
      float v[5];
#pragma unroll
      for (int c = 0; c < 5; ++c)
        v[c] = e == 0 ? v4[c].x : e == 1 ? v4[c].y : e == 2 ? v4[c].z
                                                            : v4[c].w;
#pragma unroll
      for (int q = 0; q < kRun; ++q) {
        const int o = jj - q;
        if (o < 0 || o >= kNt) continue;
#pragma unroll
        for (int c = 0; c < 5; ++c)
          a[q][c] = __fmaf_rn(taps.w[o], v[c], a[q][c]);
      }
    }
  }
  float dx[kRun], dy[kRun];
  const bool pad_row = zero_pads && y >= h;
#pragma unroll
  for (int q = 0; q < kRun; ++q) {
    const float* gq = a[q];
    const float det = __fadd_rn(
        __fsub_rn(__fmul_rn(gq[0], gq[2]), __fmul_rn(gq[1], gq[1])), 1e-3f);
    const float idet = __frcp_rn(det);   // the rounding of 1 / det
    dx[q] = __fmul_rn(
        __fsub_rn(__fmul_rn(gq[2], gq[3]), __fmul_rn(gq[1], gq[4])), idet);
    dy[q] = __fmul_rn(
        __fsub_rn(__fmul_rn(gq[0], gq[4]), __fmul_rn(gq[1], gq[3])), idet);
    if (pad_row || (zero_pads && xb + q >= w)) {
      dx[q] = 0.0f;
      dy[q] = 0.0f;
    }
  }
#pragma unroll
  for (int q = 0; q < kRun; q += 4) {
    *reinterpret_cast<float4*>(o0 + q) =
        make_float4(dx[q], dx[q + 1], dx[q + 2], dx[q + 3]);
    *reinterpret_cast<float4*>(o0 + plane + q) =
        make_float4(dy[q], dy[q + 1], dy[q + 2], dy[q + 3]);
  }
}

// Lets the kernel take up to `shared` bytes of dynamic shared memory (once
// per instantiation and size above 48 KB).
template <int H, int RT>
cudaError_t allow_shared(int shared) {
  static int granted = kDefaultShared;
  if (shared <= granted) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      farneback_blur_solve_kernel<H, RT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, shared);
  if (e == cudaSuccess) granted = shared;
  return e;
}

template <int H, int RT>
int launch(const unsigned short* m, const float* wy, const Taps& taps,
           float* flow, int h, int w, int hp, int wp, int rows, int cols,
           int pitch, int threads, int shared, int zero_pads,
           cudaStream_t stream) {
  const cudaError_t e = allow_shared<H, RT>(shared);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((wp + cols - 1) / cols, (hp + rows - 1) / rows);
  farneback_blur_solve_kernel<H, RT><<<grid, threads, shared, stream>>>(
      m, wy, taps, flow, h, w, hp, wp, rows, cols, pitch, zero_pads);
  return static_cast<int>(cudaGetLastError());
}

using LaunchFn = int (*)(const unsigned short*, const float*, const Taps&,
                         float*, int, int, int, int, int, int, int, int, int,
                         int, cudaStream_t);

// The instantiations of one strip length, by half-width.
template <int RT, int... Hs>
struct Table {
  static constexpr LaunchFn fns[] = {launch<Hs, RT>...};
};

template <int RT>
using Halves =
    Table<RT, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16>;

}  // namespace

// m: (5, hp, wp) bf16; wy: (hp, 2*half+1) f32 merged y weights (device);
// wx: (2*half+1,) f32 taps (host memory, passed to the kernel by value);
// flow: (2, hp, wp) f32 output. The tile (rows x cols outputs), the strip
// length (1 or 2 rows), the mid row pitch, the block's threads and its
// dynamic shared memory come from the host plan (fused_update.blur_plan):
// rows % strip == 0, cols % BLUR_RUN == 0, hp % 8 == 0, wp % 8 == 0,
// half <= 16. Launches on `stream`; returns the CUDA error of the launch
// (cudaErrorInvalidValue for a strip or half not built).
extern "C" int farneback_blur_solve_launch(const void* m, const void* wy,
                                           const void* wx, void* flow, int h,
                                           int w, int hp, int wp, int half,
                                           int zero_pads, int rows, int cols,
                                           int strip, int pitch, int threads,
                                           int shared, void* stream) {
  if (half < 0 || half > kMaxHalf || (strip != 1 && strip != 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const LaunchFn fn =
      strip == 1 ? Halves<1>::fns[half] : Halves<2>::fns[half];
  Taps taps = {};
  const float* host_taps = static_cast<const float*>(wx);
  for (int o = 0; o <= 2 * half; ++o) taps.w[o] = host_taps[o];
  return fn(static_cast<const unsigned short*>(m),
            static_cast<const float*>(wy), taps, static_cast<float*>(flow),
            h, w, hp, wp, rows, cols, pitch, threads, shared, zero_pads,
            static_cast<cudaStream_t>(stream));
}
