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
// once and reduces the 2x2 gradient matrix; then it iterates Newton steps,
// each of which samples the J window bilinearly at the moving point,
// reduces the two mismatch sums and moves the point. The loop ends when
// the point is done, which equals the reference's fixed trip count with
// masking.
//
// Bound: the work is a few MFLOP per point and the level images are read
// once from HBM, so neither bytes nor the f32 rate set the time: a launch
// lasts as long as the slowest point's chain (up to 30 iterations on each
// level, and each level's set-up), and each link of it is the latency of a
// memory round trip or the instructions one SM issues for the block. The
// design shortens the links:
// - staging: per level, the source pixels of the I, Ix and Iy windows
//   ((wy+1) x (wx+1), interleaved as float4) and a J patch (the window plus
//   kMargin px on each side) are copied to shared memory, with reflect-101
//   coordinates (I, J) or zero fill (Ix, Iy) at the border; each thread
//   issues a batch of loads before it stores any (one round trip per
//   batch), and the copy loops step rows and columns without dividing;
// - 512 threads per point; a thread owns a vertical strip of kStrip
//   elements of one window column (a 50x50 window is 500 strips): it
//   samples the strip's I, Ix, Iy window values from the staged pixels once
//   per level and keeps them in registers, and each iteration reads only
//   the strip's J taps from shared memory, each tap row once for two
//   elements: no index reflection and no L2 round trip inside the chain;
//   the J patch is copied again only when the window's corner leaves it;
// - each iteration's reduction: a shuffle tree per warp, one
//   shared-memory stage, then thread 0 adds the warps' partial sums in a
//   fixed order, takes the Newton step and hands it to every thread
//   through shared memory (two barriers; the serial arithmetic runs once,
//   not in all 16 warps).
// Reductions run in a fixed order with no float atomics, so a run repeats
// itself bit for bit. Built with -fmad=false: every product and sum is
// rounded on its own, as in the plain PyTorch version.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMargin = 8;   // J patch margin around the window, px
// Window rows of one thread's strip: a 50x50 window is 50 columns of
// kThreads / 50 strips each.
constexpr int kStrip = (50 + kThreads / 50 - 1) / (kThreads / 50);
// Loads a thread keeps in flight when it stages a level (the source pixels
// of a 50x50 window are 51 x 51 = 2 batches of 3 per thread, its J patch
// 67 x 67 = 2 batches of 5): larger batches spill registers.
constexpr int kWinBatch = 3;
constexpr int kPatchBatch = 5;

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

// Each warp's sums of v[0..K) (a shuffle tree), written by its lane 0 to
// buf[k * kWarps + warp].
template <int K>
__device__ __forceinline__ void warp_partials(const float (&v)[K],
                                              float* buf) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float s = v[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s = s + __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) buf[k * kWarps + warp] = s;
  }
}

// The block totals from warp_partials' buf: the warps' sums added in warp
// order, read four at a time.
template <int K>
__device__ __forceinline__ void warp_totals(float (&v)[K], const float* buf) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float4* part = reinterpret_cast<const float4*>(buf + k * kWarps);
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kWarps / 4; ++i) {
      const float4 q = part[i];
      s = (((s + q.x) + q.y) + q.z) + q.w;
    }
    v[k] = s;
  }
}

struct Bilinear {
  float a00, a01, a10, a11;
  __device__ Bilinear(float fx, float fy)
      : a00((1.f - fx) * (1.f - fy)),
        a01(fx * (1.f - fy)),
        a10((1.f - fx) * fy),
        a11(fx * fy) {}
};

// The (row, column) of elements e = t, t + kThreads, ... of a rectangle
// of rows of nw elements, for thread t, stepped without dividing.
struct Walk {
  int r, c, dr, dc, nw;
  __device__ explicit Walk(int nw_)
      : r(threadIdx.x / nw_),
        c(threadIdx.x % nw_),
        dr(kThreads / nw_),
        dc(kThreads % nw_),
        nw(nw_) {}
  __device__ void next() {
    r += dr;
    c += dc;
    if (c >= nw) {
      c -= nw;
      ++r;
    }
  }
};

// Copy the source pixels of the I, Ix and Iy windows, rows y0 .. y0 + nh
// and columns x0 .. x0 + nw of the level, into dst as float4 (I, Ix, Iy,
// 0): I at reflect-101 coordinates, Ix and Iy zero outside the image.
// Each thread issues the loads of kBatch elements before it stores any: a
// round trip per kBatch elements a thread. The caller synchronises.
template <int kBatch>
__device__ void stage_windows(float4* dst, const float* __restrict__ I,
                              const float* __restrict__ Ix,
                              const float* __restrict__ Iy, int lh, int lw,
                              int y0, int x0, int nh, int nw) {
  const int n = nh * nw;
  Walk at(nw);
  for (int e0 = threadIdx.x; e0 < n; e0 += kBatch * kThreads) {
    float4 v[kBatch];
    int to[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      to[k] = -1;
      if (e0 + k * kThreads < n) {
        const int y = y0 + at.r, x = x0 + at.c;
        const bool in = static_cast<unsigned>(y) < static_cast<unsigned>(lh) &&
                        static_cast<unsigned>(x) < static_cast<unsigned>(lw);
        const size_t q =
            static_cast<size_t>(reflect101(y, lh)) * lw + reflect101(x, lw);
        v[k] = make_float4(__ldg(I + q), in ? __ldg(Ix + q) : 0.f,
                           in ? __ldg(Iy + q) : 0.f, 0.f);
        to[k] = at.r * nw + at.c;
        at.next();
      }
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k)
      if (to[k] >= 0) dst[to[k]] = v[k];
  }
}

// Copy J[y0 .. y0 + nh) x [x0 .. x0 + nw) at reflect-101 coordinates into
// dst (nh x nw), kBatch loads in flight per thread. The caller
// synchronises.
template <int kBatch>
__device__ void stage_patch(float* dst, const float* __restrict__ J, int lh,
                            int lw, int y0, int x0, int nh, int nw) {
  const int n = nh * nw;
  Walk at(nw);
  for (int e0 = threadIdx.x; e0 < n; e0 += kBatch * kThreads) {
    float v[kBatch];
    int to[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      to[k] = -1;
      if (e0 + k * kThreads < n) {
        v[k] = __ldg(J + static_cast<size_t>(reflect101(y0 + at.r, lh)) * lw +
                     reflect101(x0 + at.c, lw));
        to[k] = at.r * nw + at.c;
        at.next();
      }
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k)
      if (to[k] >= 0) dst[to[k]] = v[k];
  }
}

// A bilinear sample from two rows' tap pairs (t0 = row r at c, c + 1; t1 =
// row r + 1), in the plain version's order.
__device__ __forceinline__ float bilinear(float2 t0, float2 t1,
                                          const Bilinear& a) {
  return ((t0.x * a.a00 + t0.y * a.a01) + t1.x * a.a10) + t1.y * a.a11;
}

// The same for the three staged channels (I, Ix, Iy) of two float4 taps
// per row.
__device__ __forceinline__ float3 bilinear3(float4 p00, float4 p01, float4 p10,
                                           float4 p11, const Bilinear& a) {
  return make_float3(bilinear(make_float2(p00.x, p01.x),
                              make_float2(p10.x, p11.x), a),
                     bilinear(make_float2(p00.y, p01.y),
                              make_float2(p10.y, p11.y), a),
                     bilinear(make_float2(p00.z, p01.z),
                              make_float2(p10.z, p11.z), a));
}

// The window values of one strip (column ox, rows oy0 .. oy0 + kStrip,
// clipped to wy): I, Ix and Iy of each element, in registers.
struct Strip {
  float i[kStrip], x[kStrip], y[kStrip];
};

// Sample a strip from the staged source pixels rw ((wy+1) x nw float4).
__device__ __forceinline__ void window_strip(int ox, int oy0, int wy, int nw,
                                             const float4* rw,
                                             const Bilinear& a, Strip& st) {
  const float4* p = rw + oy0 * nw + ox;
  float4 t0 = p[0], t1 = p[1];
#pragma unroll
  for (int i = 0; i < kStrip; ++i) {
    st.i[i] = st.x[i] = st.y[i] = 0.f;
    if (oy0 + i < wy) {
      p += nw;
      const float4 b0 = p[0], b1 = p[1];
      const float3 v = bilinear3(t0, t1, b0, b1, a);
      st.i[i] = v.x;
      st.x[i] = v.y;
      st.y[i] = v.z;
      t0 = b0;
      t1 = b1;
    }
  }
}

// Add a strip's gradient products to g.
__device__ __forceinline__ void gradient_sums(const Strip& st, int oy0, int wy,
                                              float (&g)[3]) {
#pragma unroll
  for (int i = 0; i < kStrip; ++i) {
    if (oy0 + i < wy) {
      g[0] = g[0] + st.x[i] * st.x[i];
      g[1] = g[1] + st.x[i] * st.y[i];
      g[2] = g[2] + st.y[i] * st.y[i];
    }
  }
}

// Each element's mismatch with the J patch (window corner at jp, rows of
// pw floats) times the gradients, added to b.
__device__ __forceinline__ void mismatch_strip(int ox, int oy0, int wy,
                                               const float* jp, int pw,
                                               const Strip& st,
                                               const Bilinear& a,
                                               float (&b)[2]) {
  const float* p = jp + oy0 * pw + ox;
  float2 t = make_float2(p[0], p[1]);
#pragma unroll
  for (int i = 0; i < kStrip; ++i) {
    if (oy0 + i < wy) {
      p += pw;
      const float2 u = make_float2(p[0], p[1]);
      const float diff = bilinear(t, u, a) - st.i[i];
      b[0] = b[0] + diff * st.x[i];
      b[1] = b[1] + diff * st.y[i];
      t = u;
    }
  }
}

// Thread t owns strips t, t + kThreads, ... of the window (strip s: column
// s % wx, rows from (s / wx) * kStrip); a 50x50 window is 500 strips, one
// per thread, whose window values stay in the thread's registers for the
// level. A larger window's further strips are sampled again from the
// staged pixels at every iteration. Shared memory: the staged source
// pixels ((wy+1) x (wx+1) float4) and the J patch (ph x pw floats).
__global__ void __launch_bounds__(kThreads, 2)
lk_track_kernel(Pyramid pyr, int nlev, const float* __restrict__ pts,
                float* __restrict__ out, int* __restrict__ iters_out, int n,
                int wx, int wy, int max_iters, float eps2, float min_eig_thr) {
  extern __shared__ float4 smem[];
  // The warps' partial sums: of the gradient matrix (read by every thread
  // once per level) and of the mismatch (read by thread 0 every
  // iteration); and thread 0's step (lx, ly, done) for every thread.
  __shared__ __align__(16) float red_g[3 * kWarps];
  __shared__ __align__(16) float red_b[2 * kWarps];
  __shared__ float step[3];
  const int pw = wx + 2 * kMargin + 1, ph = wy + 2 * kMargin + 1;
  const int nw = wx + 1, nh = wy + 1;
  float4* rw = smem;
  float* sJ = reinterpret_cast<float*>(rw + nw * nh);
  const int nstrips = wx * ((wy + kStrip - 1) / kStrip);

  const int stream = blockIdx.y;
  const size_t pt = static_cast<size_t>(stream) * n + blockIdx.x;
  const float ptx = pts[2 * pt], pty = pts[2 * pt + 1];
  const float half_x = (wx - 1) * 0.5f, half_y = (wy - 1) * 0.5f;
  const float fwx = static_cast<float>(wx), fwy = static_cast<float>(wy);
  const int tid = threadIdx.x;
  // This thread's first strip.
  const int ox = tid % wx, oy0 = (tid / wx) * kStrip;
  const bool owns = tid < nstrips;

  const int top = nlev - 1;
  float nx = ldexpf(ptx, -top), ny = ldexpf(pty, -top);
  Strip own;   // the window values of this thread's first strip
  int iters = 0;
  bool status = false;
  float err = 0.f;

  for (int lvl = top; lvl >= 0; --lvl) {
    const int lh = pyr.h[lvl], lw = pyr.w[lvl];
    const size_t plane = static_cast<size_t>(stream) * lh * lw;
    const float* __restrict__ J = pyr.J[lvl] + plane;
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
    const Bilinear aw(px - ipx, py - ipy);   // the windows' weights
    // Top-left of the J patch in level coordinates; -2^30: none yet.
    int qx0 = -(1 << 30), qy0 = -(1 << 30);
    if (in_bounds) {
      const int x0 = static_cast<int>(ipx), y0 = static_cast<int>(ipy);
      stage_windows<kWinBatch>(rw, pyr.I[lvl] + plane, pyr.Ix[lvl] + plane,
                               pyr.Iy[lvl] + plane, lh, lw, y0, x0, nh, nw);
      // The first iteration's J patch, in the same round of copies.
      const float inx = floorf(lx), iny = floorf(ly);
      if (inx >= -fwx && inx < flw && iny >= -fwy && iny < flh) {
        qx0 = static_cast<int>(inx) - kMargin;
        qy0 = static_cast<int>(iny) - kMargin;
        stage_patch<kPatchBatch>(sJ, J, lh, lw, qy0, qx0, ph, pw);
      }
      __syncthreads();
      float g[3] = {0.f, 0.f, 0.f};
      if (owns) {
        window_strip(ox, oy0, wy, nw, rw, aw, own);
        gradient_sums(own, oy0, wy, g);
      }
      for (int s = tid + kThreads; s < nstrips; s += kThreads) {
        Strip st;
        window_strip(s % wx, (s / wx) * kStrip, wy, nw, rw, aw, st);
        gradient_sums(st, (s / wx) * kStrip, wy, g);
      }
      warp_partials(g, red_g);
      __syncthreads();
      warp_totals(g, red_g);
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
      // The window's corner must lie in [q0, q0 + 2 * kMargin] on both
      // axes for its taps to be in the patch; else copy a patch centred
      // on it (the same decision in every thread: the point is uniform).
      // Every thread's reads of the old patch came before the last
      // reduction's barrier, which every thread here has passed.
      if (static_cast<unsigned>(x0 - qx0) > 2u * kMargin ||
          static_cast<unsigned>(y0 - qy0) > 2u * kMargin) {
        qx0 = x0 - kMargin;
        qy0 = y0 - kMargin;
        stage_patch<kPatchBatch>(sJ, J, lh, lw, qy0, qx0, ph, pw);
        __syncthreads();
      }
      const float* jp = sJ + (y0 - qy0) * pw + (x0 - qx0);
      float b[2] = {0.f, 0.f};
      if (owns) mismatch_strip(ox, oy0, wy, jp, pw, own, a, b);
      for (int s = tid + kThreads; s < nstrips; s += kThreads) {
        Strip st;
        window_strip(s % wx, (s / wx) * kStrip, wy, nw, rw, aw, st);
        mismatch_strip(s % wx, (s / wx) * kStrip, wy, jp, pw, st, a, b);
      }
      // The step, taken by thread 0 alone from the warps' partial sums
      // and handed to every thread: the other warps wait at the barrier
      // instead of repeating the same serial arithmetic. Thread 0 reads
      // red_b and writes step only between the two barriers, which every
      // other thread's writes of red_b and reads of step are outside of.
      warp_partials(b, red_b);
      __syncthreads();
      if (tid == 0) {
        warp_totals(b, red_b);
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
        step[0] = lx;
        step[1] = ly;
        step[2] = (converged || osc) ? 1.f : 0.f;
      }
      __syncthreads();
      lx = step[0];
      ly = step[1];
      done = step[2] != 0.f;
      ++iters;
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
    __syncthreads();   // the next level overwrites the staged images
  }
  if (tid == 0) {
    out[4 * pt] = nx;
    out[4 * pt + 1] = ny;
    out[4 * pt + 2] = status ? 1.f : 0.f;
    out[4 * pt + 3] = err;
    iters_out[pt] = iters;
  }
}

// Dynamic shared memory of one block for a wx x wy window, in bytes
// (lk_kernel.py: shared_bytes).
size_t shared_bytes(int wx, int wy) {
  return static_cast<size_t>(wx + 1) * (wy + 1) * sizeof(float4) +
         static_cast<size_t>(wx + 2 * kMargin + 1) * (wy + 2 * kMargin + 1) *
             sizeof(float);
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
  const size_t shared = shared_bytes(wx, wy);
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
