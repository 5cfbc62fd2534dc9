// Streaming patch soft-argmax for the neural-ray-surface (NRS) camera:
// forward and backward kernels for Hopper (sm_90a).
//
// Replaces: packnet_sfm_tpu/ops/pallas_softargmax.py, _fwd_kernel (forward)
// and _bwd_kernel (backward, with the VJP of _build_stack).
//
// What it computes. For each pixel (b, y, x), a softmax over its
// border-clamped k x k window (k = 2p+1, window start sy = clamp(y-p, 0, h-k),
// sx = clamp(x-p, 0, w-k)) of logit = dot(dir[b,:,y,x], ray[b,:,wy,wx]) / T.
// The forward writes the expected window coordinates ex, ey and the softmax
// statistics: m, the window's largest dot (the largest logit times T, kept in
// dot units so that the backward reads back exactly what pass 2 subtracted),
// and s, the sum of exp(logit - largest logit). The backward replays the
// windows with the saved m, s: for pixel q and ray position r of its window,
//   wgt(q, r) = e * (gx * (rx - ex) + gy * (ry - ey)),  e = exp((dot - m) / T),
//   gx = gex / (s T), gy = gey / (s T),
//   d_dir[q] = sum over r of wgt(q, r) * ray[r],
//   d_ray[r] = sum over the q whose window holds r of wgt(q, r) * dir[q].
// Both sums are gathers with one fixed order: no atomics, every element of
// both outputs written once, the same bits on every call.
//
// What bounds it on an H100. At the NRS path's shape (h = w = 192, p = 20)
// a call evaluates 192 * 192 * 41 * 41 = 62 M window positions over 1.5 MB
// of inputs and outputs: operations, not bytes. Forward: 15 FP32 operations
// a position (0.0139 ms at 67 TFLOP/s) and one exponential a position on
// the special-function units (16 lanes a clock on each of 132 SMs: 0.0148
// ms at 1.98 GHz); where the weights underflow and no exponential is taken,
// dot, scale and compare, 7 operations a position (0.0065 ms). What the
// design below can reach is less: its two passes run 4 FP32 instructions
// and 1 shared-memory load per position each, 0.019 ms at one instruction
// a clock on each of an SM's four schedulers.
//
// Design of the forward.
// - A block takes a tile of 32 x SA_R pixels and stages the union of their
//   windows, (32 + k - 1) x (SA_R + k - 1) rays, in shared memory as three
//   planes with 4-byte cp.async copies (the union's start is not aligned
//   for wider ones): global and L1 traffic happens once per block. At
//   p = 20 that is 37 KB; 384 blocks of 32 x 3 pixels are resident in one
//   wave at 3 per SM on 132 SMs (2.9 per SM: no second wave, no SM idle
//   for more than a thirtieth). A window too large for the budget is staged
//   some rows at a time, and again for the second pass.
// - A thread owns the SA_R vertically adjacent pixels of one column and
//   evaluates all of them against each ray it reads from shared memory; the
//   32 lanes of a warp are consecutive columns, so the reads have no bank
//   conflict. The SA_TY warps of a block take the union's rows in turn and
//   merge their partial results through shared memory, in a fixed order.
// - Two passes in place of an online softmax with its rescaling branch:
//   pass 1 the largest dot (3 multiply-adds and a max per position), pass 2
//   exp(logit - m) as one ex2 of (dot - m) * log2(e) / T, and only for the
//   positions within 40 of the largest logit; one branch per ray for the
//   thread's pixels together. At the path's T ~ 1e-4 that skips all but a
//   few positions of seeded unit vectors, and all outside a disc of some
//   ten pixels on a smooth ray surface. The x coordinate is a float carried
//   along the row; a row's weights enter s and ny once, at its end.
// Measured alternatives that lost (PERF.md): 2 or 4
// pixel rows a thread, 4 or 16 warps a block; marking candidate groups in a
// bit mask and evaluating them after the row, or after pass 1 against the
// running largest dot (each lane then walks its own list, at no
// instruction-level parallelism); keeping every row's largest dot to skip
// rows in pass 2; each warp copying only the rows it reads itself, a copy
// group per row, to start on the first while the others are in flight.
//
// Design of the backward. One launch; a block's role comes from blockIdx.y.
// - d_dir role (pixel-owned): the forward's pass 2 with other accumulators.
//   32 x SB_R pixels a block, the union of their windows staged with
//   stage_rays, the same dot3, the same cut-off against m, and for the pairs
//   that pass the weight and three multiply-adds.
// - d_ray role (ray-owned), the transpose: 32 x SB_R ray positions a block.
//   A thread keeps its SB_R rays in registers and scans the pixels whose
//   windows hold them: along an axis those are the interval
//   [win_lo(r), win_hi(r)], 3p + 1 long near a border, where windows are
//   pushed inwards. The pixels' (d0, d1, d2, m) are staged as one float4
//   each (one 16-byte shared load a pixel), and (gx, gy, ex, ey) as a second
//   float4 that only the pairs that pass read. The lanes of a warp have
//   intervals of different lengths near a border: the scan runs to the
//   longest and masks the others. A pixel row that holds all SB_R rays of
//   the thread (all but the first and last few) takes one threshold for them.
// - The ray role's blocks come first in the grid: its border tiles scan up
//   to 2.2 times the pairs of an interior tile, and the shorter d_dir blocks
//   fill the end. Both roles only read the forward's statistics, so they
//   share the SMs freely.
// - SB_TY = 12 warps a block, two blocks an SM (up to 85 registers), 99 KB of
//   staging each: at p = 20 an interior ray tile's pixels (72 x 43 x 32 B)
//   fit in one piece.
// Measured alternatives that lost (PERF.md): the pairs' (gx, gy, ex, ey)
// through __ldg instead of staged; 2 or 4 rows a thread in either role; 4
// to 16 warps a block at 6 to 2 blocks an SM; the d_dir role first; two
// groups of warps with their own ray rows over one staged union; two pixels
// a branch; a warp-uniform branch by vote.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <type_traits>

namespace {

constexpr int TX = 32;  // pixels (or rays) of one row per block (one warp)

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Forward tiling: a block takes TX x SA_R pixels; a thread owns the SA_R
// vertically adjacent pixels of one column, and SA_TY threads (one per warp)
// share a column's window rows.
constexpr int SA_R = 3;
constexpr int SA_TY = 8;
// Backward tiling, both roles: a block takes TX x SB_R pixels (d_dir) or ray
// positions (d_ray); a thread owns SB_R vertically adjacent ones, and the
// SB_TY warps share the rows of what the block stages. Two blocks an SM.
constexpr int SB_R = 3;
constexpr int SB_TY = 12;
static_assert(SB_TY >= 3, "a warp per channel merges the partial sums");
// A window position whose logit lies further than this below the pixel's
// largest has a weight under exp(-40) = 4e-18 against s >= 1: adding it
// changes no float32 sum (half a unit in the last place of 1 is 6e-8), the
// same as for the positions past -87.3 whose weight underflows altogether.
constexpr float CUTOFF = 40.0f;
constexpr float LOG2E = 1.4426950408889634f;

// The dot of a direction with a ray, in one fixed order of roundings: both
// passes must give a position the same value, or the largest position's
// weight would not be exactly 1.
__device__ __forceinline__ float dot3(float a0, float a1, float a2, float b0,
                                      float b1, float b2) {
  return __fmaf_rn(a2, b2, __fmaf_rn(a0, b0, __fmul_rn(a1, b1)));
}

// 2^x on the special-function unit (one instruction; results under 2^-126
// flush to zero, which the cut-off has dropped before).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// tile: the rows [row0, row0 + nrows) of the block's window union, three
// planes of `pstride` floats with rows of `S` floats, columns [ux, ux + uw).
template <int NTY>
__device__ __forceinline__ void stage_rays(float* tile, const float* __restrict__ rb,
                                           size_t plane, int w, int row0, int nrows,
                                           int ux, int uw, int S, int pstride) {
  for (int rr = threadIdx.y; rr < nrows; rr += NTY) {
    const float* g = rb + (size_t)(row0 + rr) * w + ux;
    float* t = tile + rr * S;
    for (int cc = threadIdx.x; cc < uw; cc += TX) {
      __pipeline_memcpy_async(t + cc, g + cc, 4);
      __pipeline_memcpy_async(t + pstride + cc, g + plane + cc, 4);
      __pipeline_memcpy_async(t + 2 * pstride + cc, g + 2 * plane + cc, 4);
    }
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
}

// chunk_rows: rows of the window union staged at a time (all of them where
// they fit the shared-memory budget). Dynamic shared memory: the tile,
// 3 * chunk_rows * (TX + k - 1) floats. m goes out in dot units.
__global__ void __launch_bounds__(TX * SA_TY)
softargmax_fwd_kernel(const float* __restrict__ dir,
                      const float* __restrict__ rays,
                      float* __restrict__ ex, float* __restrict__ ey,
                      float* __restrict__ mo, float* __restrict__ so,
                      int h, int w, int p, float inv_t, float cut,
                      int chunk_rows) {
  constexpr int R = SA_R, NTY = SA_TY;
  extern __shared__ float tile[];
  __shared__ float part[3][NTY][R][TX];
  const int k = 2 * p + 1;
  const int S = TX + k - 1, pstride = chunk_rows * S;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int x0 = blockIdx.x * TX, y0 = blockIdx.y * R;
  const size_t plane = (size_t)h * w;
  const float* rb = rays + (size_t)blockIdx.z * 3 * plane;
  const float* db = dir + (size_t)blockIdx.z * 3 * plane;

  // The union of the block's windows: window starts grow by at most one per
  // pixel, so it spans at most (TX + k - 1) x (R + k - 1) rays.
  const int ux = clampi(x0 - p, 0, w - k);
  const int uw = clampi(min(x0 + TX - 1, w - 1) - p, 0, w - k) + k - ux;
  const int uy = clampi(y0 - p, 0, h - k);
  const int uh = clampi(min(y0 + R - 1, h - 1) - p, 0, h - k) + k - uy;

  // A thread past the image's edge repeats the edge pixel and stores nothing.
  const int x = min(x0 + tx, w - 1);
  const int sxl = clampi(x - p, 0, w - k) - ux;  // window start within the tile
  float d0[R], d1[R], d2[R];
  int syl[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int y = min(y0 + r, h - 1);
    const float* dp = db + (size_t)y * w + x;
    d0[r] = dp[0], d1[r] = dp[plane], d2[r] = dp[2 * plane];
    syl[r] = clampi(y - p, 0, h - k) - uy;
  }

  // Pass 1: the largest dot of every pixel's window (the logit is dot / T).
  // Each ray read from shared memory serves the thread's R pixels; a window
  // row that only some of them hold is masked once, at its end.
  float m[R];
#pragma unroll
  for (int r = 0; r < R; ++r) m[r] = -1e30f;
  for (int c0 = 0; c0 < uh; c0 += chunk_rows) {
    const int nr = min(chunk_rows, uh - c0);
    if (c0 > 0) __syncthreads();
    stage_rays<NTY>(tile, rb, plane, w, uy + c0, nr, ux, uw, S, pstride);
    __syncthreads();
    for (int u = c0 + ty; u < c0 + nr; u += NTY) {
      const float* t0 = tile + (u - c0) * S + sxl;
      float rm[R];
#pragma unroll
      for (int r = 0; r < R; ++r) rm[r] = -1e30f;
#pragma unroll 4
      for (int dx = 0; dx < k; ++dx) {
        const float v0 = t0[dx], v1 = t0[pstride + dx], v2 = t0[2 * pstride + dx];
#pragma unroll
        for (int r = 0; r < R; ++r)
          rm[r] = fmaxf(rm[r], dot3(d0[r], d1[r], d2[r], v0, v1, v2));
      }
#pragma unroll
      for (int r = 0; r < R; ++r)
        if ((unsigned)(u - syl[r]) < (unsigned)k) m[r] = fmaxf(m[r], rm[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) part[0][ty][r][tx] = m[r];
  __syncthreads();
#pragma unroll
  for (int r = 0; r < R; ++r)
    for (int j = 0; j < NTY; ++j) m[r] = fmaxf(m[r], part[0][j][r][tx]);
  __syncthreads();

  // Pass 2: s = sum exp(logit - m) and the coordinate numerators, over the
  // positions within `cut` of the largest dot only; one branch per ray for
  // the thread's R pixels together. exp(logit - m) = 2^((dot - m) * scale):
  // the difference is exact near the largest dot, where the weights count.
  // A row's weights are summed first and enter s and ny once, at its end.
  const float scale = inv_t * LOG2E;
  float thr[R], s[R], nx[R], ny[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    thr[r] = m[r] - cut;
    s[r] = nx[r] = ny[r] = 0.f;
  }
  for (int c0 = 0; c0 < uh; c0 += chunk_rows) {
    const int nr = min(chunk_rows, uh - c0);
    if (uh > chunk_rows) {  // else the whole union is still staged
      __syncthreads();
      stage_rays<NTY>(tile, rb, plane, w, uy + c0, nr, ux, uw, S, pstride);
      __syncthreads();
    }
    for (int u = c0 + ty; u < c0 + nr; u += NTY) {
      const float* t0 = tile + (u - c0) * S + sxl;
      float tr[R], sr[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        tr[r] = (unsigned)(u - syl[r]) < (unsigned)k ? thr[r] : 3e38f;
        sr[r] = 0.f;
      }
      float cx = (float)(ux + sxl);
#pragma unroll 4
      for (int dx = 0; dx < k; ++dx) {
        const float v0 = t0[dx], v1 = t0[pstride + dx], v2 = t0[2 * pstride + dx];
        float dot[R];
        bool any = false;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          dot[r] = dot3(d0[r], d1[r], d2[r], v0, v1, v2);
          any |= dot[r] >= tr[r];
        }
        if (any) {
#pragma unroll
          for (int r = 0; r < R; ++r) {
            if (dot[r] >= tr[r]) {
              const float e = ex2((dot[r] - m[r]) * scale);
              sr[r] += e;
              nx[r] += e * cx;
            }
          }
        }
        cx += 1.f;
      }
      const float cy = (float)(uy + u);
#pragma unroll
      for (int r = 0; r < R; ++r) s[r] += sr[r], ny[r] += sr[r] * cy;
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    part[0][ty][r][tx] = s[r];
    part[1][ty][r][tx] = nx[r];
    part[2][ty][r][tx] = ny[r];
  }
  __syncthreads();
  if (ty == 0 && x0 + tx < w) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (y0 + r >= h) break;
      float ss = 0.f, sx_ = 0.f, sy_ = 0.f;
      for (int j = 0; j < NTY; ++j) {
        ss += part[0][j][r][tx];
        sx_ += part[1][j][r][tx];
        sy_ += part[2][j][r][tx];
      }
      const size_t o = (size_t)blockIdx.z * plane + (size_t)(y0 + r) * w + x;
      const float denom = fmaxf(ss, 1e-30f);
      ex[o] = sx_ / denom;
      ey[o] = sy_ / denom;
      mo[o] = m[r];
      so[o] = ss;
    }
  }
}

// ---------------------------------------------------------------------------
// Backward. Two roles, both gathers; a block's role comes from blockIdx.y.

// Along an axis of length n, the pixels whose clamped window holds ray
// position r are the interval [win_lo, win_hi]: windows near a border are
// pushed inwards, so it is 3p + 1 long at r = 2p, not k, and the whole axis
// where both borders are in reach (n <= 4p + 1)
// (ops/softargmax.transposed_window_bounds is the same formula).
__device__ __forceinline__ int win_lo(int r, int p) { return r <= 2 * p ? 0 : r - p; }
__device__ __forceinline__ int win_hi(int r, int p, int n) {
  return r >= n - (2 * p + 1) ? n - 1 : r + p;
}

// gx or gy: the upstream gradient with 1 / (T s) folded in.
__device__ __forceinline__ float fold_grad(float g, float s, float inv_t) {
  return g / fmaxf(s, 1e-30f) * inv_t;
}

// The warps' partial sums of three accumulators per pixel (or ray), merged
// in one fixed order and written to the three planes of `out`.
template <int R>
__device__ __forceinline__ void merge_and_store(float (*part)[SB_TY][R][TX],
                                                const float (&a0)[R], const float (&a1)[R],
                                                const float (&a2)[R], float* out,
                                                size_t plane, int h, int w, int x0, int y0) {
  const int tx = threadIdx.x, ty = threadIdx.y;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    part[0][ty][r][tx] = a0[r];
    part[1][ty][r][tx] = a1[r];
    part[2][ty][r][tx] = a2[r];
  }
  __syncthreads();
  // warp c sums channel c of every pixel of the tile
  if (ty < 3 && x0 + tx < w) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (y0 + r >= h) break;
      float sum = 0.f;
      for (int j = 0; j < SB_TY; ++j) sum += part[ty][j][r][tx];
      out[ty * plane + (size_t)(y0 + r) * w + x0 + tx] = sum;
    }
  }
}

// d_dir role: the block owns a tile of 32 x R pixels and replays their
// windows as the forward's pass 2 does, over the staged union of rays.
template <int R>
__device__ __forceinline__ void bwd_dir_role(
    float* tile, float (*part)[SB_TY][R][TX], const float* __restrict__ db,
    const float* __restrict__ rb, const float* __restrict__ ex,
    const float* __restrict__ ey, const float* __restrict__ mi,
    const float* __restrict__ si, const float* __restrict__ gex,
    const float* __restrict__ gey, float* __restrict__ ddir_b, int h, int w, int p,
    float inv_t, float cut, int ytile, int chunk_rows) {
  constexpr int NTY = SB_TY;
  const int k = 2 * p + 1;
  const int S = TX + k - 1, pstride = chunk_rows * S;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int x0 = blockIdx.x * TX, y0 = ytile * R;
  const size_t plane = (size_t)h * w;

  const int ux = clampi(x0 - p, 0, w - k);
  const int uw = clampi(min(x0 + TX - 1, w - 1) - p, 0, w - k) + k - ux;
  const int uy = clampi(y0 - p, 0, h - k);
  const int uh = clampi(min(y0 + R - 1, h - 1) - p, 0, h - k) + k - uy;

  // A thread past the image's edge repeats the edge pixel and stores nothing.
  const int x = min(x0 + tx, w - 1);
  const int sxl = clampi(x - p, 0, w - k) - ux;
  float d0[R], d1[R], d2[R], m[R], thr[R], gx[R], gy[R], exv[R], eyv[R];
  float a0[R], a1[R], a2[R];
  int syl[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int y = min(y0 + r, h - 1);
    const size_t o = (size_t)y * w + x;
    d0[r] = db[o], d1[r] = db[plane + o], d2[r] = db[2 * plane + o];
    m[r] = mi[o];
    thr[r] = m[r] - cut;
    gx[r] = fold_grad(gex[o], si[o], inv_t);
    gy[r] = fold_grad(gey[o], si[o], inv_t);
    exv[r] = ex[o], eyv[r] = ey[o];
    syl[r] = clampi(y - p, 0, h - k) - uy;
    a0[r] = a1[r] = a2[r] = 0.f;
  }

  const float scale = inv_t * LOG2E;
  for (int c0 = 0; c0 < uh; c0 += chunk_rows) {
    const int nr = min(chunk_rows, uh - c0);
    if (c0 > 0) __syncthreads();
    stage_rays<NTY>(tile, rb, plane, w, uy + c0, nr, ux, uw, S, pstride);
    __syncthreads();
    for (int u = c0 + ty; u < c0 + nr; u += NTY) {
      const float* t0 = tile + (u - c0) * S + sxl;
      const float cy = (float)(uy + u);
      float tr[R], yc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        tr[r] = (unsigned)(u - syl[r]) < (unsigned)k ? thr[r] : 3e38f;
        yc[r] = gy[r] * (cy - eyv[r]);
      }
      float cx = (float)(ux + sxl);
#pragma unroll 4
      for (int dx = 0; dx < k; ++dx) {
        const float v0 = t0[dx], v1 = t0[pstride + dx], v2 = t0[2 * pstride + dx];
        float dot[R];
        bool any = false;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          dot[r] = dot3(d0[r], d1[r], d2[r], v0, v1, v2);
          any |= dot[r] >= tr[r];
        }
        if (any) {
#pragma unroll
          for (int r = 0; r < R; ++r) {
            if (dot[r] >= tr[r]) {
              const float e = ex2((dot[r] - m[r]) * scale);
              const float wgt = e * fmaf(gx[r], cx - exv[r], yc[r]);
              a0[r] = fmaf(wgt, v0, a0[r]);
              a1[r] = fmaf(wgt, v1, a1[r]);
              a2[r] = fmaf(wgt, v2, a2[r]);
            }
          }
        }
        cx += 1.f;
      }
    }
  }
  merge_and_store<R>(part, a0, a1, a2, ddir_b, plane, h, w, x0, y0);
}

// One pixel of the d_ray role's scan against the thread's R rays.
// q = (d0, d1, d2, m) of the pixel; *pp = (gx, gy, ex, ey) of it, read only
// where a pair counts. cutr[r] is the cut-off where the pixel's row holds ray
// r, else -3e38 (no pair counts); ALL_ROWS says that all R rows hold, so one
// threshold serves them. lane_ok is false past the lane's interval of pixels.
template <int R, bool ALL_ROWS>
__device__ __forceinline__ void ray_step(const float4 q, const float4* pp, bool lane_ok,
                                         const float (&cutr)[R], const float (&v0)[R],
                                         const float (&v1)[R], const float (&v2)[R],
                                         const float (&cyr)[R], float cxr, float scale,
                                         float (&a0)[R], float (&a1)[R], float (&a2)[R]) {
  const float qm = lane_ok ? q.w : 3e38f;
  float dot[R];
  bool pass[R];
  bool any = false;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    dot[r] = dot3(q.x, q.y, q.z, v0[r], v1[r], v2[r]);
    pass[r] = dot[r] >= qm - (ALL_ROWS ? cutr[0] : cutr[r]);
    any |= pass[r];
  }
  if (any) {
    const float4 g = *pp;
    const float xc = g.x * (cxr - g.z);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (pass[r]) {
        const float e = ex2((dot[r] - q.w) * scale);
        const float wgt = e * fmaf(g.y, cyr[r] - g.w, xc);
        a0[r] = fmaf(wgt, q.x, a0[r]);
        a1[r] = fmaf(wgt, q.y, a1[r]);
        a2[r] = fmaf(wgt, q.z, a2[r]);
      }
    }
  }
}

// d_ray role, the transpose: the block owns a tile of 32 x R ray positions;
// a thread keeps its R rays in registers and scans the pixels whose windows
// hold them. Those pixels' (d0, d1, d2, m) and (gx, gy, ex, ey) are staged
// in shared memory as two arrays of float4, D and behind it P, `cap`
// elements each, some rows of the pixel union at a time where it is larger
// than that.
template <int R>
__device__ __forceinline__ void bwd_ray_role(
    float4* tile, int cap, float (*part)[SB_TY][R][TX],
    const float* __restrict__ db, const float* __restrict__ rb,
    const float* __restrict__ ex, const float* __restrict__ ey,
    const float* __restrict__ mi, const float* __restrict__ si,
    const float* __restrict__ gex, const float* __restrict__ gey,
    float* __restrict__ drays_b, int h, int w, int p, float inv_t, float cut, int ytile) {
  constexpr int NTY = SB_TY, NT = TX * SB_TY;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int rx0 = blockIdx.x * TX, ry0 = ytile * R;
  const size_t plane = (size_t)h * w;

  // The pixel union of the tile's rays.
  const int ux = win_lo(rx0, p);
  const int uw = win_hi(min(rx0 + TX - 1, w - 1), p, w) - ux + 1;
  const int uy = win_lo(ry0, p);
  const int uh = win_hi(min(ry0 + R - 1, h - 1), p, h) - uy + 1;

  // A thread past the edge repeats the edge ray and stores nothing. The
  // lanes' intervals differ near a border: the scan runs to the longest of
  // the warp and masks the lanes past their own.
  const int rx = min(rx0 + tx, w - 1);
  const int lxl = win_lo(rx, p) - ux;
  const int nxl = win_hi(rx, p, w) - win_lo(rx, p) + 1;
  const int nmin = __reduce_min_sync(0xffffffffu, nxl);
  const int nmax = __reduce_max_sync(0xffffffffu, nxl);
  const float cxr = (float)rx;
  float v0[R], v1[R], v2[R], cyr[R], a0[R], a1[R], a2[R];
  int lyl[R], nyl[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int ry = min(ry0 + r, h - 1);
    const size_t o = (size_t)ry * w + rx;
    v0[r] = rb[o], v1[r] = rb[plane + o], v2[r] = rb[2 * plane + o];
    cyr[r] = (float)ry;
    lyl[r] = win_lo(ry, p) - uy;
    nyl[r] = win_hi(ry, p, h) - win_lo(ry, p) + 1;
    a0[r] = a1[r] = a2[r] = 0.f;
  }

  float4* D = tile;
  float4* P = tile + cap;
  int chunk_rows = cap / uw;
  if (chunk_rows < uh && chunk_rows >= NTY) chunk_rows = chunk_rows / NTY * NTY;
  const float ruw = 1.0f / (float)uw;
  const float scale = inv_t * LOG2E;
  for (int c0 = 0; c0 < uh; c0 += chunk_rows) {
    const int nr = min(chunk_rows, uh - c0);
    if (c0 > 0) __syncthreads();
    // Staging: the chunk's pixels in one flat order, two of them a thread in
    // flight (the last thread repeats the last pixel).
    const int n = nr * uw;
    for (int i0 = ty * TX + tx; i0 < n; i0 += 2 * NT) {
      int idx[2];
      float4 dv[2], pv[2];
      float sv[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int i = min(i0 + u * NT, n - 1);
        int row = (int)((float)i * ruw);  // i / uw, set right below
        row -= row * uw > i;
        row += (row + 1) * uw <= i;
        const size_t o = (size_t)(uy + c0 + row) * w + ux + (i - row * uw);
        idx[u] = i;
        dv[u] = make_float4(db[o], db[plane + o], db[2 * plane + o], mi[o]);
        pv[u] = make_float4(gex[o], gey[o], ex[o], ey[o]);
        sv[u] = si[o];
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        D[idx[u]] = dv[u];
        P[idx[u]] = make_float4(fold_grad(pv[u].x, sv[u], inv_t),
                                fold_grad(pv[u].y, sv[u], inv_t), pv[u].z, pv[u].w);
      }
    }
    __syncthreads();
    for (int v = c0 + ty; v < c0 + nr; v += NTY) {
      float cutr[R];
      bool all_rows = true;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const bool holds = (unsigned)(v - lyl[r]) < (unsigned)nyl[r];
        cutr[r] = holds ? cut : -3e38f;
        all_rows &= holds;
      }
      const float4* drow = D + (v - c0) * uw + lxl;
      const float4* prow = P + (v - c0) * uw + lxl;
      // The next pixel is read while this one is evaluated. Past its
      // interval a lane reads on into the next row, or into P behind the
      // last one, and the mask drops what it read.
      auto scan_row = [&](auto all) {
        constexpr bool A = decltype(all)::value;
        float4 qn = drow[0];
#pragma unroll 4
        for (int j = 0; j < nmin; ++j) {
          const float4 q = qn;
          qn = drow[j + 1];
          ray_step<R, A>(q, prow + j, true, cutr, v0, v1, v2, cyr, cxr, scale, a0, a1, a2);
        }
#pragma unroll 4
        for (int j = nmin; j < nmax; ++j) {
          const float4 q = qn;
          qn = drow[j + 1];
          ray_step<R, A>(q, prow + j, j < nxl, cutr, v0, v1, v2, cyr, cxr, scale, a0, a1, a2);
        }
      };
      if (all_rows)
        scan_row(std::true_type{});
      else
        scan_row(std::false_type{});
    }
  }
  merge_and_store<R>(part, a0, a1, a2, drays_b, plane, h, w, rx0, ry0);
}

// grid.y: first the d_ray role's `ray_tiles` tiles of SB_R ray rows (its
// border tiles scan the most pairs, and the d_dir role's shorter blocks fill
// the end), then the d_dir role's tiles of SB_R pixel rows. Dynamic shared
// memory: the larger of the d_dir role's 3 * dir_chunk_rows * (TX + k - 1)
// floats and the d_ray role's 2 * ray_cap float4, and 16 bytes that the
// scans' reads ahead may touch.
__global__ void __launch_bounds__(TX * SB_TY, 2)
softargmax_bwd_kernel(const float* __restrict__ dir,
                      const float* __restrict__ rays,
                      const float* __restrict__ ex, const float* __restrict__ ey,
                      const float* __restrict__ mi, const float* __restrict__ si,
                      const float* __restrict__ gex, const float* __restrict__ gey,
                      float* __restrict__ ddir, float* __restrict__ drays,
                      int h, int w, int p, float inv_t, float cut, int ray_tiles,
                      int dir_chunk_rows, int ray_cap) {
  extern __shared__ float4 tile4[];
  __shared__ float part[3][SB_TY][SB_R][TX];
  const size_t plane = (size_t)h * w;
  const size_t o3 = (size_t)blockIdx.z * 3 * plane, o1 = (size_t)blockIdx.z * plane;
  if ((int)blockIdx.y < ray_tiles)
    bwd_ray_role<SB_R>(tile4, ray_cap, part, dir + o3, rays + o3, ex + o1, ey + o1, mi + o1,
                       si + o1, gex + o1, gey + o1, drays + o3, h, w, p, inv_t, cut,
                       (int)blockIdx.y);
  else
    bwd_dir_role<SB_R>(reinterpret_cast<float*>(tile4), part, dir + o3, rays + o3, ex + o1,
                       ey + o1, mi + o1, si + o1, gex + o1, gey + o1, ddir + o3, h, w, p,
                       inv_t, cut, (int)blockIdx.y - ray_tiles, dir_chunk_rows);
}

constexpr long long SMEM_BUDGET = 99 * 1024;  // of what a block stages

bool bad_shape(int b, int h, int w, int p) {
  const int k = 2 * p + 1;
  return b < 0 || p < 0 || h < k || w < k || h > 65535 || b > 65535;
}

}  // namespace

// All tensors are contiguous float32 on the device: dir, rays, ddir, drays
// [b, 3, h, w]; ex, ey, m, s, gex, gey [b, h, w]; m is the window's largest dot, s the sum of exp((dot - m) / T).
// Both launch on `stream` and return cudaGetLastError() (0 on success).

extern "C" int softargmax_fwd(const float* dir, const float* rays, float* ex,
                              float* ey, float* m, float* s, int b, int h,
                              int w, int p, float temperature, void* stream) {
  if (bad_shape(b, h, w, p) || !(temperature > 0.f)) return (int)cudaErrorInvalidValue;
  if (b == 0) return 0;
  // Shared memory: the whole window union of a block where it fits the
  // budget, else as many rows at a time as do.
  const int k = 2 * p + 1;
  const long long row_bytes = 3LL * (TX + k - 1) * sizeof(float);
  int chunk_rows = SA_R + k - 1;
  if (chunk_rows * row_bytes > SMEM_BUDGET) {
    chunk_rows = (int)(SMEM_BUDGET / row_bytes) / SA_TY * SA_TY;
    if (chunk_rows < SA_TY) return (int)cudaErrorInvalidValue;
  }
  const int smem = (int)(chunk_rows * row_bytes);
  // with the static partials a block may pass the 48 KB granted unasked
  const cudaError_t err = cudaFuncSetAttribute(
      softargmax_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((w + TX - 1) / TX, (h + SA_R - 1) / SA_R, b), block(TX, SA_TY);
  softargmax_fwd_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      dir, rays, ex, ey, m, s, h, w, p, 1.0f / temperature, CUTOFF * temperature,
      chunk_rows);
  return (int)cudaGetLastError();
}

extern "C" int softargmax_bwd(const float* dir, const float* rays,
                              const float* ex, const float* ey, const float* m,
                              const float* s, const float* gex, const float* gey,
                              float* ddir, float* drays, int b, int h, int w,
                              int p, float temperature, void* stream) {
  if (bad_shape(b, h, w, p) || !(temperature > 0.f)) return (int)cudaErrorInvalidValue;
  if (b == 0) return 0;
  const int k = 2 * p + 1;
  // d_dir role: the window union of a block as the forward stages it.
  const long long row_bytes = 3LL * (TX + k - 1) * sizeof(float);
  int dir_chunk_rows = SB_R + k - 1;
  if (dir_chunk_rows * row_bytes > SMEM_BUDGET) {
    dir_chunk_rows = (int)(SMEM_BUDGET / row_bytes) / SB_TY * SB_TY;
    if (dir_chunk_rows < SB_TY) return (int)cudaErrorInvalidValue;
  }
  // d_ray role: the pixel union of a tile reaches at most 2p past the tile
  // on either side, at 32 bytes a pixel; at least one row of it must fit.
  const long long uw_max = std::min((long long)w, (long long)TX + 4LL * p);
  const long long uh_max = std::min((long long)h, (long long)SB_R + 4LL * p);
  const long long ray_cap = std::min(uw_max * uh_max, SMEM_BUDGET / 32);
  if (ray_cap < uw_max) return (int)cudaErrorInvalidValue;
  const int tiles = (h + SB_R - 1) / SB_R;  // of either role
  if (2 * tiles > 65535) return (int)cudaErrorInvalidValue;
  const int smem = 16 + (int)std::max(dir_chunk_rows * row_bytes, ray_cap * 32);
  const cudaError_t err = cudaFuncSetAttribute(
      softargmax_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((w + TX - 1) / TX, 2 * tiles, b), block(TX, SB_TY);
  softargmax_bwd_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      dir, rays, ex, ey, m, s, gex, gey, ddir, drays, h, w, p, 1.0f / temperature,
      CUTOFF * temperature, tiles, dir_chunk_rows, (int)ray_cap);
  return (int)cudaGetLastError();
}
