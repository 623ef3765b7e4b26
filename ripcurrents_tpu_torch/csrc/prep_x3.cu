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
// Each output pixel (row r, column c) takes six f32 accumulators over c's
// source window in ascending source column, products of two bf16 values
// exact in f32, then the combine with separate roundings (-fmad=false,
// __fmul_rn / __fadd_rn), as the plain PyTorch version
// (flow/prep_kernel.py: prep_x3_plain) computes it: they agree bit for bit.
// The output is channels first (5, ph, pw) or channels last (ph, pw, 5),
// bf16 or f32; the canvas pads are exactly zero.
//
// Bound. The composed matrices take every level from the full-resolution
// frame, so t is frame-wide and an output's window is ~33 / 64 / 130 / 260
// source columns at levels 0-3. Level 0 at 640x480 (legacy canvas
// 544x896) moves t (2.1 MB) and the bf16 table (4.9 MB) once, ~2.1 us at
// 3.35 TB/s; its 10 M taps of six products and six adds are 122 M
// operations, 1.8 us at 67 TFLOP/s counted as FMAs, and twice that issued
// with -fmad=false (each product and each add an instruction). The coarse
// levels hold a quarter and a sixteenth of level 0's outputs with 2x and
// 4x its window: few outputs, long sequential sums, bound by operations and
// by how many warps they can put on the card.
//
// Design. A warp owns a group of C adjacent output columns (C = 2 where the
// level has warps to spare, else 1), its lanes 32 output rows, so its
// weight reads are broadcasts. A block takes 8 groups of one row tile of
// the level's nonzero region. It stages the three t sections' rows over the
// source columns its groups read into shared memory with 8-byte cp.async
// copies (a scalar edge path for a width that is not a multiple of 4, zeros
// past t), and the groups' weights with 16-byte ones, widened on the host
// to the union of the group's windows aligned to 4 taps with zero weights
// on the widened taps (zero products leave the sum unchanged). The loop
// runs from shared memory: per 4 taps a lane reads 8 bytes of each section
// (a row pitch of 4 mod 8 values puts the 16 lanes of a half-warp on
// distinct bank pairs) and, per column, three weight quads as broadcasts.
// The results go through shared memory so that the block writes whole rows
// of each channel, 16 bytes a store; the staging and the write-out step
// their indices without a division, since at level 0 they issue about as
// many instructions as the loop. The first blocks of the grid write the
// pads' zeros, a warp per canvas row and channel, 16 bytes a store, beside
// the compute tiles rather than after them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

// The tile sizes come from the build (ripcurrents_tpu_torch/kernels.py:
// DEFINES), where the host plan reads them too.
#if !defined(PREP_X_ROWS) || !defined(PREP_X_WARPS) || \
    !defined(PREP_X_ZERO_ROWS)
#error "build with -DPREP_X_ROWS, -DPREP_X_WARPS and -DPREP_X_ZERO_ROWS"
#endif

namespace {

constexpr int kRows = PREP_X_ROWS;
constexpr int kWarps = PREP_X_WARPS;
constexpr int kThreads = 32 * kWarps;
constexpr int kZeroRows = PREP_X_ZERO_ROWS;
constexpr int kDefaultShared = 48 * 1024;
static_assert(kRows == 32, "a tile's rows are the lanes of a warp");

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

// 8 bytes, zero-filled past src_bytes
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}

template <typename T>
__device__ __forceinline__ T cast(float v) {
  if constexpr (std::is_same_v<T, float>) {
    return v;
  } else {
    return __float2bfloat16_rn(v);
  }
}

// Zeros into p[0, n) by one warp: 16-byte stores between a scalar head and
// tail.
template <typename T>
__device__ void zero_run(T* p, int n, int lane) {
  constexpr int kV = 16 / sizeof(T);
  const int head = min(n, static_cast<int>(
      ((16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15) / sizeof(T)));
  const int body = (n - head) / kV;
  for (int i = lane; i < head; i += 32) p[i] = cast<T>(0.0f);
  auto* v = reinterpret_cast<uint4*>(p + head);
  for (int i = lane; i < body; i += 32) v[i] = make_uint4(0, 0, 0, 0);
  for (int i = head + body * kV + lane; i < n; i += 32) p[i] = cast<T>(0.0f);
}

// A flat index over (row, item) pairs of `items` per row, stepped by the
// block's thread count without a division per step.
struct Walk {
  int row, item, drow, ditem, items;
  __device__ Walk(int start, int n) : items(n) {
    row = start / n;
    item = start - row * n;
    drow = kThreads / n;
    ditem = kThreads - drow * n;
  }
  __device__ void next() {
    row += drow;
    item += ditem;
    if (item >= items) {
      item -= items;
      ++row;
    }
  }
};

// C: output columns a warp; T: the table's type (bf16 or float); CF:
// channels first (5, ph, pw), else channels last (ph, pw, 5).
template <int C, typename T, bool CF>
__global__ void __launch_bounds__(kThreads)
prep_x3_kernel(const __nv_bfloat16* __restrict__ t,
               const int2* __restrict__ span, const float* __restrict__ wx_u,
               const int2* __restrict__ tiles, T* __restrict__ out, int w,
               int ph, int pw, int row0, int row1, int col0, int col1,
               int taps, int pitch, int col_tiles, int zero_blocks,
               int stage_bytes, float ig11, float ig03, float ig33,
               float ig55) {
  constexpr int kCols = kWarps * C;         // output columns of a tile
  constexpr int kOutPitch = kCols + 1;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t plane = static_cast<size_t>(ph) * pw;

  if (static_cast<int>(blockIdx.x) < zero_blocks) {
    // pads: every canvas pixel of the block's rows outside the nonzero
    // region [row0, row1) x [col0, col1), a warp per row and channel
    // (channels first) or per row (channels last)
    constexpr int kPlanes = CF ? 5 : 1;
    constexpr int kStep = CF ? 1 : 5;         // values per pixel in a run
    for (int i = warp; i < kZeroRows * kPlanes; i += kWarps) {
      const int r = blockIdx.x * kZeroRows + i / kPlanes;
      if (r >= ph) break;
      T* row = out + (CF ? (i % kPlanes) * plane : 0) +
               static_cast<size_t>(r) * pw * kStep;
      if (r < row0 || r >= row1) {
        zero_run(row, pw * kStep, lane);
      } else {
        zero_run(row, col0 * kStep, lane);
        zero_run(row + col1 * kStep, (pw - col1) * kStep, lane);
      }
    }
    return;
  }

  const int tile_id = blockIdx.x - zero_blocks;
  const int rt = tile_id / col_tiles;
  const int ct = tile_id - rt * col_tiles;
  const int r0 = row0 + rt * kRows;
  const int g0 = ct * kWarps;
  const int groups = (col1 - col0 + C - 1) / C;
  const int ng = min(kWarps, groups - g0);
  const int2 tile = tiles[ct];              // staged source columns
  auto* ts = reinterpret_cast<__nv_bfloat16*>(smem);    // (3, kRows, pitch)
  auto* wts = reinterpret_cast<float*>(smem + stage_bytes);  // (8, 3, C, taps)
  // the three sections' rows over the tile's source columns; rows past the
  // nonzero region and columns past t read as zero
  if ((w & 3) == 0) {
    for (Walk at(threadIdx.x, tile.y / 4); at.row < 3 * kRows; at.next()) {
      const int k = at.row / kRows;
      const int r = r0 + at.row - k * kRows;
      const int c = tile.x + 4 * at.item;
      const bool in = r < row1 && c < w;
      cp_async8(ts + at.row * pitch + 4 * at.item,
                in ? t + static_cast<size_t>(k * ph + r) * w + c : t,
                in ? 8 : 0);
    }
  } else {
    for (Walk at(threadIdx.x, tile.y); at.row < 3 * kRows; at.next()) {
      const int k = at.row / kRows;
      const int r = r0 + at.row - k * kRows;
      const int c = tile.x + at.item;
      ts[at.row * pitch + at.item] =
          r < row1 && c < w ? t[static_cast<size_t>(k * ph + r) * w + c]
                            : __float2bfloat16_rn(0.0f);
    }
  }
  // the groups' weights: contiguous in wx_u, taps % 4 == 0
  const float* wsrc = wx_u + static_cast<size_t>(g0) * 3 * C * taps;
  for (int e = threadIdx.x; e < ng * 3 * C * taps / 4; e += kThreads) {
    cp_async16(wts + 4 * e, wsrc + 4 * e);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  float o[C][5];
  if (warp < ng) {
    const int2 sp = span[g0 + warp];        // (start, count)
    const int u = sp.x - tile.x;
    const auto* p0 = reinterpret_cast<const unsigned*>(
        ts + (0 * kRows + lane) * pitch + u);
    const auto* p1 = reinterpret_cast<const unsigned*>(
        ts + (1 * kRows + lane) * pitch + u);
    const auto* p2 = reinterpret_cast<const unsigned*>(
        ts + (2 * kRows + lane) * pitch + u);
    const float* wg = wts + warp * 3 * C * taps;
    float b1[C], b2[C], b3[C], b4[C], b5[C], b6[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      b1[c] = b2[c] = b3[c] = b4[c] = b5[c] = b6[c] = 0.0f;
    }
#pragma unroll 2
    for (int j = 0; j < sp.y; j += 4) {
      const uint2 q0 = *reinterpret_cast<const uint2*>(p0 + j / 2);
      const uint2 q1 = *reinterpret_cast<const uint2*>(p1 + j / 2);
      const uint2 q2 = *reinterpret_cast<const uint2*>(p2 + j / 2);
      // bf16 -> f32: the low half of a word is the lower column
      const float s0[4] = {__uint_as_float(q0.x << 16),
                           __uint_as_float(q0.x & 0xffff0000u),
                           __uint_as_float(q0.y << 16),
                           __uint_as_float(q0.y & 0xffff0000u)};
      const float s1[4] = {__uint_as_float(q1.x << 16),
                           __uint_as_float(q1.x & 0xffff0000u),
                           __uint_as_float(q1.y << 16),
                           __uint_as_float(q1.y & 0xffff0000u)};
      const float s2[4] = {__uint_as_float(q2.x << 16),
                           __uint_as_float(q2.x & 0xffff0000u),
                           __uint_as_float(q2.y << 16),
                           __uint_as_float(q2.y & 0xffff0000u)};
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float4 g4 =
            *reinterpret_cast<const float4*>(wg + (0 * C + c) * taps + j);
        const float4 x4 =
            *reinterpret_cast<const float4*>(wg + (1 * C + c) * taps + j);
        const float4 xx4 =
            *reinterpret_cast<const float4*>(wg + (2 * C + c) * taps + j);
        const float g[4] = {g4.x, g4.y, g4.z, g4.w};
        const float xg[4] = {x4.x, x4.y, x4.z, x4.w};
        const float xxg[4] = {xx4.x, xx4.y, xx4.z, xx4.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          b1[c] = __fadd_rn(b1[c], __fmul_rn(s0[q], g[q]));
          b3[c] = __fadd_rn(b3[c], __fmul_rn(s1[q], g[q]));
          b5[c] = __fadd_rn(b5[c], __fmul_rn(s2[q], g[q]));
          b2[c] = __fadd_rn(b2[c], __fmul_rn(s0[q], xg[q]));
          b6[c] = __fadd_rn(b6[c], __fmul_rn(s1[q], xg[q]));
          b4[c] = __fadd_rn(b4[c], __fmul_rn(s0[q], xxg[q]));
        }
      }
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      o[c][0] = __fmul_rn(b2[c], ig11);
      o[c][1] = __fmul_rn(b3[c], ig11);
      o[c][2] = __fadd_rn(__fmul_rn(b1[c], ig03), __fmul_rn(b4[c], ig33));
      o[c][3] = __fadd_rn(__fmul_rn(b1[c], ig03), __fmul_rn(b5[c], ig33));
      o[c][4] = __fmul_rn(b6[c], ig55);
    }
  }
  // through shared memory (over the staged t), so that the block writes
  // whole rows of the tile, 16 bytes a store
  __syncthreads();
  auto* os = reinterpret_cast<float*>(smem);  // (5, kRows, kOutPitch)
  if (warp < ng) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
#pragma unroll
      for (int ch = 0; ch < 5; ++ch) {
        os[(ch * kRows + lane) * kOutPitch + warp * C + c] = o[c][ch];
      }
    }
  }
  __syncthreads();
  // a segment is one output row's run of the tile: per channel and row
  // (channels first) or per row, its 5 channels interleaved (channels last)
  constexpr int kV = 16 / sizeof(T);        // values a 16-byte store holds
  constexpr int kSegLen = CF ? kCols : 5 * kCols;
  constexpr int kUnits = (kSegLen + kV - 1) / kV;
  constexpr int kSegs = CF ? 5 * kRows : kRows;
  const int c0 = col0 + g0 * C;
  const int seg_n = (CF ? 1 : 5) * min(kCols, col1 - c0);
  const int nrows = min(kRows, row1 - r0);
  for (int e = threadIdx.x; e < kSegs * kUnits; e += kThreads) {
    const int seg = e / kUnits;
    const int i0 = (e - seg * kUnits) * kV;
    const int rr = CF ? seg % kRows : seg;
    const int ch = CF ? seg / kRows : 0;
    if (rr >= nrows || i0 >= seg_n) continue;
    const size_t px = static_cast<size_t>(r0 + rr) * pw + c0;
    T* dst = CF ? out + ch * plane + px : out + px * 5;
    auto value = [&](int i) {
      return CF ? os[(ch * kRows + rr) * kOutPitch + i]
                : os[((i % 5) * kRows + rr) * kOutPitch + i / 5];
    };
    if (i0 + kV <= seg_n &&
        (reinterpret_cast<uintptr_t>(dst + i0) & 15) == 0) {
      uint4 v;
      if constexpr (std::is_same_v<T, float>) {
        v = make_uint4(__float_as_uint(value(i0)),
                       __float_as_uint(value(i0 + 1)),
                       __float_as_uint(value(i0 + 2)),
                       __float_as_uint(value(i0 + 3)));
      } else {
        unsigned u[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const __nv_bfloat162 h = __floats2bfloat162_rn(
              value(i0 + 2 * q), value(i0 + 2 * q + 1));
          u[q] = *reinterpret_cast<const unsigned*>(&h);
        }
        v = make_uint4(u[0], u[1], u[2], u[3]);
      }
      *reinterpret_cast<uint4*>(dst + i0) = v;
    } else {
      for (int i = i0; i < min(i0 + kV, seg_n); ++i) {
        dst[i] = cast<T>(value(i));
      }
    }
  }
}

template <int C, typename T, bool CF>
int launch(const __nv_bfloat16* t, const int2* span, const float* wx_u,
           const int2* tiles, void* out, int w, int ph, int pw, int row0,
           int row1, int col0, int col1, int taps, int pitch, int row_tiles,
           int col_tiles, int zero_blocks, float ig11, float ig03,
           float ig33, float ig55, int shared, cudaStream_t stream) {
  if (shared > kDefaultShared) {
    const cudaError_t e = cudaFuncSetAttribute(
        prep_x3_kernel<C, T, CF>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, shared);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int stage_bytes = shared - 4 * kWarps * 3 * C * taps;
  prep_x3_kernel<C, T, CF><<<zero_blocks + row_tiles * col_tiles, kThreads,
                             shared, stream>>>(
      t, span, wx_u, tiles, static_cast<T*>(out), w, ph, pw, row0, row1,
      col0, col1, taps, pitch, col_tiles, zero_blocks, stage_bytes, ig11,
      ig03, ig33, ig55);
  return static_cast<int>(cudaGetLastError());
}

template <int C>
int launch_as(int out_bf16, int channels_first, const __nv_bfloat16* t,
              const int2* span, const float* wx_u, const int2* tiles,
              void* out, int w, int ph, int pw, int row0, int row1, int col0,
              int col1, int taps, int pitch, int row_tiles, int col_tiles,
              int zero_blocks, float ig11, float ig03, float ig33, float ig55,
              int shared, cudaStream_t stream) {
#define PREP_X3_ARGS                                                        \
  t, span, wx_u, tiles, out, w, ph, pw, row0, row1, col0, col1, taps, pitch, \
      row_tiles, col_tiles, zero_blocks, ig11, ig03, ig33, ig55, shared,     \
      stream
  if (out_bf16) {
    return channels_first ? launch<C, __nv_bfloat16, true>(PREP_X3_ARGS)
                          : launch<C, __nv_bfloat16, false>(PREP_X3_ARGS);
  }
  return channels_first ? launch<C, float, true>(PREP_X3_ARGS)
                        : launch<C, float, false>(PREP_X3_ARGS);
#undef PREP_X3_ARGS
}

}  // namespace

// t: (3*ph, w) bf16 y-pass result (sections g, xg, xxg at row 0, ph, 2*ph);
// span: (groups, 2) int32 widened window (start, count) of each group of
// cols (1 or 2) output columns from col0, start and count % 4 == 0; wx_u:
// (groups, 3, cols, taps) f32 weights of the g, xg and xxg x matrices over
// them (bf16 values, zero outside each column's window); tiles:
// (col_tiles, 2) int32 staged source columns (first, n) of each tile of
// kWarps groups, first and n % 8 == 0, n < pitch (pitch % 8 == 4); the
// nonzero region is rows [row0, row1) x columns [col0, col1), cut into
// row_tiles of kRows rows; zero_blocks blocks of kZeroRows canvas rows,
// first in the grid, write the pads. out:
// (5, ph, pw) if channels_first else (ph, pw, 5), bf16 if out_bf16 else
// f32. shared: dynamic shared-memory bytes (the block's limit is raised to
// it above 48 KB). Launches on `stream`; returns the CUDA error of the
// launch.
extern "C" int prep_x3_launch(const void* t, const void* span,
                              const void* wx_u, const void* tiles, void* out,
                              int w, int ph, int pw, int row0, int row1,
                              int col0, int col1, int taps, int pitch,
                              int row_tiles, int col_tiles, int zero_blocks,
                              int cols, float ig11, float ig03, float ig33,
                              float ig55, int out_bf16, int channels_first,
                              int shared, void* stream) {
  auto* fn = cols == 2 ? launch_as<2> : launch_as<1>;
  return fn(out_bf16, channels_first, static_cast<const __nv_bfloat16*>(t),
            static_cast<const int2*>(span), static_cast<const float*>(wx_u),
            static_cast<const int2*>(tiles), out, w, ph, pw, row0, row1,
            col0, col1, taps, pitch, row_tiles, col_tiles, zero_blocks, ig11,
            ig03, ig33, ig55, shared, static_cast<cudaStream_t>(stream));
}
