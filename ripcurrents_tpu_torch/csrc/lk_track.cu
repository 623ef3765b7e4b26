// K3 lk_track: pyramidal Lucas-Kanade tracking of sparse points.
//
// Replaces the TPU kernel ripcurrents_tpu/flow/lk_pallas.py: pyr_lk_pallas
// (_kernel), with the gather semantics of flow/lucas_kanade.py: pyr_lk:
// reflect-101 coordinates for the I and J samples, zero outside the image
// for the Scharr derivative windows, cv2's min-eigenvalue gate, epsilon and
// oscillation stopping rules.
//
// One thread block per (stream, point) walks the pyramid coarse to fine in
// one launch. Per level the block samples the I, dI/dx and dI/dy windows
// once into shared memory (3 * wy * wx floats; 30 KB for 50x50), reduces
// the 2x2 gradient matrix, and then iterates: every thread samples its
// share of the J window straight from global memory (a level image is at
// most 1.2 MB and stays in L2), the block reduces the two mismatch sums,
// and all threads take the same Newton step. The loop ends when the point
// is done, which equals the reference's fixed trip count with masking.
//
// Bound: the work is a few MFLOP per point and the level images are read
// once from HBM, so the kernel is bound by latency of its reductions and
// of the J taps, not by bytes or f32 rate. Reductions run in a fixed order
// (per-thread strided sums, a shuffle tree, then the warps' partial sums
// in order; no float atomics), so a run repeats itself bit for bit.
// Built with -fmad=false: every product and sum is rounded on its own, as
// in the plain PyTorch version.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct Pyramid {
  const float* I[kMaxLevels];
  const float* J[kMaxLevels];
  const float* Ix[kMaxLevels];
  const float* Iy[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
};

// cv2 BORDER_REFLECT_101, any distance outside.
__device__ __forceinline__ int reflect101(int i, int n) {
  if (static_cast<unsigned>(i) < static_cast<unsigned>(n)) return i;
  const int period = max(2 * (n - 1), 1);
  i = abs(i) % period;
  return i >= n ? period - i : i;
}

// Sum each of v[0..K) over the block; every thread gets the same totals.
template <int K>
__device__ __forceinline__ void block_sum(float (&v)[K], float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float s = v[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s = s + __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) red[k * kWarps + warp] = s;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) s = s + red[k * kWarps + i];
    v[k] = s;
  }
  __syncthreads();
}

struct Bilinear {
  float a00, a01, a10, a11;
  __device__ Bilinear(float fx, float fy)
      : a00((1.f - fx) * (1.f - fy)),
        a01(fx * (1.f - fy)),
        a10((1.f - fx) * fy),
        a11(fx * fy) {}
};

__device__ __forceinline__ float sample_reflect(const float* img, int h, int w,
                                                int y, int x,
                                                const Bilinear& a) {
  const int r0 = reflect101(y, h) * w, r1 = reflect101(y + 1, h) * w;
  const int c0 = reflect101(x, w), c1 = reflect101(x + 1, w);
  return ((img[r0 + c0] * a.a00 + img[r0 + c1] * a.a01) +
          img[r1 + c0] * a.a10) + img[r1 + c1] * a.a11;
}

__device__ __forceinline__ float sample_zero(const float* img, int h, int w,
                                             int y, int x, const Bilinear& a) {
  const bool y0 = static_cast<unsigned>(y) < static_cast<unsigned>(h);
  const bool y1 = static_cast<unsigned>(y + 1) < static_cast<unsigned>(h);
  const bool x0 = static_cast<unsigned>(x) < static_cast<unsigned>(w);
  const bool x1 = static_cast<unsigned>(x + 1) < static_cast<unsigned>(w);
  const float v00 = (y0 && x0) ? img[y * w + x] : 0.f;
  const float v01 = (y0 && x1) ? img[y * w + x + 1] : 0.f;
  const float v10 = (y1 && x0) ? img[(y + 1) * w + x] : 0.f;
  const float v11 = (y1 && x1) ? img[(y + 1) * w + x + 1] : 0.f;
  return ((v00 * a.a00 + v01 * a.a01) + v10 * a.a10) + v11 * a.a11;
}

__global__ void __launch_bounds__(kThreads)
lk_track_kernel(Pyramid pyr, int nlev, const float* __restrict__ pts,
                float* __restrict__ out, int* __restrict__ iters_out, int n,
                int wx, int wy, int max_iters, float eps2, float min_eig_thr) {
  extern __shared__ float win[];
  __shared__ float red[3 * kWarps];
  const int area = wx * wy;
  float* sI = win;
  float* sIx = win + area;
  float* sIy = win + 2 * area;

  const int stream = blockIdx.y;
  const size_t pt = static_cast<size_t>(stream) * n + blockIdx.x;
  const float ptx = pts[2 * pt], pty = pts[2 * pt + 1];
  const float half_x = (wx - 1) * 0.5f, half_y = (wy - 1) * 0.5f;
  const float fwx = static_cast<float>(wx), fwy = static_cast<float>(wy);
  const int tid = threadIdx.x;
  // Each thread walks elements tid, tid + kThreads, ... of the window and
  // keeps their (row, column) without dividing inside the loops.
  const int oy_first = tid / wx, ox_first = tid % wx;
  const int oy_step = kThreads / wx, ox_step = kThreads % wx;

  const int top = nlev - 1;
  float nx = ldexpf(ptx, -top), ny = ldexpf(pty, -top);
  int iters = 0;
  bool status = false;
  float err = 0.f;

  for (int lvl = top; lvl >= 0; --lvl) {
    const int lh = pyr.h[lvl], lw = pyr.w[lvl];
    const size_t plane = static_cast<size_t>(stream) * lh * lw;
    const float* I = pyr.I[lvl] + plane;
    const float* J = pyr.J[lvl] + plane;
    const float* Ix = pyr.Ix[lvl] + plane;
    const float* Iy = pyr.Iy[lvl] + plane;
    const float flw = static_cast<float>(lw), flh = static_cast<float>(lh);

    const float px = ldexpf(ptx, -lvl) - half_x;
    const float py = ldexpf(pty, -lvl) - half_y;
    if (lvl != top) {
      nx = nx * 2.f;
      ny = ny * 2.f;
    }
    float lx = nx - half_x, ly = ny - half_y;

    const float ipx = floorf(px), ipy = floorf(py);
    // False for NaN and for windows wholly outside the image.
    const bool in_bounds = ipx >= -fwx && ipx < flw && ipy >= -fwy && ipy < flh;
    float a11 = 0.f, a12 = 0.f, a22 = 0.f, min_eig = 0.f, inv_det = 0.f;
    bool solvable = false;
    if (in_bounds) {
      const Bilinear a(px - ipx, py - ipy);
      const int x0 = static_cast<int>(ipx), y0 = static_cast<int>(ipy);
      float g[3] = {0.f, 0.f, 0.f};
      for (int e = tid, oy = oy_first, ox = ox_first; e < area;
           e += kThreads) {
        const float vi = sample_reflect(I, lh, lw, y0 + oy, x0 + ox, a);
        const float vx = sample_zero(Ix, lh, lw, y0 + oy, x0 + ox, a);
        const float vy = sample_zero(Iy, lh, lw, y0 + oy, x0 + ox, a);
        sI[e] = vi;
        sIx[e] = vx;
        sIy[e] = vy;
        g[0] = g[0] + vx * vx;
        g[1] = g[1] + vx * vy;
        g[2] = g[2] + vy * vy;
        ox += ox_step;
        oy += oy_step;
        if (ox >= wx) {
          ox -= wx;
          ++oy;
        }
      }
      block_sum<3>(g, red);   // also orders the window writes before reads
      a11 = g[0];
      a12 = g[1];
      a22 = g[2];
      const float det = a11 * a22 - a12 * a12;
      const float dd = a11 - a22;
      // OpenCV's 1/1024 fixed-point frame, divided by the window area.
      min_eig = (a22 + a11 - sqrtf(dd * dd + 4.f * (a12 * a12))) /
                (2.0f * 1024.0f * fwx * fwy);
      solvable = min_eig >= min_eig_thr && det > 1e-12f;
      inv_det = det > 1e-12f ? 1.0f / det : 0.f;
    }

    float pdx = INFINITY, pdy = INFINITY;
    bool done = !solvable;
    for (int it = 0; it < max_iters && !done; ++it) {
      const float inx = floorf(lx), iny = floorf(ly);
      if (!(inx >= -fwx && inx < flw && iny >= -fwy && iny < flh)) break;
      const Bilinear a(lx - inx, ly - iny);
      const int x0 = static_cast<int>(inx), y0 = static_cast<int>(iny);
      float b[2] = {0.f, 0.f};
      for (int e = tid, oy = oy_first, ox = ox_first; e < area;
           e += kThreads) {
        const float diff =
            sample_reflect(J, lh, lw, y0 + oy, x0 + ox, a) - sI[e];
        b[0] = b[0] + diff * sIx[e];
        b[1] = b[1] + diff * sIy[e];
        ox += ox_step;
        oy += oy_step;
        if (ox >= wx) {
          ox -= wx;
          ++oy;
        }
      }
      block_sum<2>(b, red);
      ++iters;
      const float dx = (a12 * b[1] - a22 * b[0]) * inv_det;
      const float dy = (a12 * b[0] - a11 * b[1]) * inv_det;
      lx = lx + dx;
      ly = ly + dy;
      const bool converged = dx * dx + dy * dy <= eps2;
      // Against the previous accepted step, which starts at +inf.
      const bool osc = fabsf(dx + pdx) < 0.01f && fabsf(dy + pdy) < 0.01f;
      if (osc && !converged) {
        lx = lx - dx * 0.5f;
        ly = ly - dy * 0.5f;
      }
      pdx = dx;
      pdy = dy;
      done = converged || osc;
    }
    nx = lx + half_x;
    ny = ly + half_y;
    if (lvl == 0) {
      const float inx = floorf(lx), iny = floorf(ly);
      const bool final_ok =
          inx >= -fwx && inx < flw && iny >= -fwy && iny < flh;
      status = in_bounds && final_ok && solvable;
      err = min_eig;
    }
    __syncthreads();   // the next level overwrites the windows
  }
  if (tid == 0) {
    out[4 * pt] = nx;
    out[4 * pt + 1] = ny;
    out[4 * pt + 2] = status ? 1.f : 0.f;
    out[4 * pt + 3] = err;
    iters_out[pt] = iters;
  }
}

}  // namespace

// I, J, Ix, Iy: kMaxLevels device pointers each, level 0 (finest) first, to
// (streams, lh[l], lw[l]) f32 images; pts: (streams, n, 2) f32; out:
// (streams, n, 4) f32 (x, y, status, err); iters_out: (streams, n) int32,
// the J windows each point sampled. Launches on `stream`; returns the CUDA
// error of the launch.
extern "C" int lk_track_launch(const void* const* I, const void* const* J,
                               const void* const* Ix, const void* const* Iy,
                               const int* lh, const int* lw, int nlev,
                               const void* pts, void* out, void* iters_out,
                               int streams, int n, int wx, int wy,
                               int max_iters, float eps2, float min_eig_thr,
                               void* stream) {
  Pyramid pyr;
  for (int l = 0; l < kMaxLevels; ++l) {
    const bool live = l < nlev;
    pyr.I[l] = live ? static_cast<const float*>(I[l]) : nullptr;
    pyr.J[l] = live ? static_cast<const float*>(J[l]) : nullptr;
    pyr.Ix[l] = live ? static_cast<const float*>(Ix[l]) : nullptr;
    pyr.Iy[l] = live ? static_cast<const float*>(Iy[l]) : nullptr;
    pyr.h[l] = live ? lh[l] : 0;
    pyr.w[l] = live ? lw[l] : 0;
  }
  const size_t shared = static_cast<size_t>(3) * wx * wy * sizeof(float);
  if (shared > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        lk_track_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shared));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(n, streams);
  lk_track_kernel<<<grid, kThreads, shared,
                    static_cast<cudaStream_t>(stream)>>>(
      pyr, nlev, static_cast<const float*>(pts), static_cast<float*>(out),
      static_cast<int*>(iters_out), n, wx, wy, max_iters, eps2, min_eig_thr);
  return static_cast<int>(cudaGetLastError());
}
