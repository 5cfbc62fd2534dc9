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
// statistics m (max logit) and s (sum of exp(logit - m)). The backward
// replays the window with the saved m, s: with
//   wgt = e * (gx * (cx - ex) + gy * (cy - ey)),  e = exp(logit - m),
//   gx = gex / (s T), gy = gey / (s T),
// it accumulates d_dir += wgt * ray in registers and scatters
// d_ray += wgt * dir into a zeroed [B,3,h,w] buffer with atomicAdd, so the
// summation order of d_ray changes from run to run.
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
// The backward keeps its first design: 32 neighbouring pixels of a row per
// warp read the rays through L1, each pixel's rows are split over TY = 8
// threads, and positions whose weight underflows to zero skip their three
// atomics. Its redesign, and a deterministic gather for d_ray, are left
// for a later change.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int TX = 32;  // pixels of one row per block (one warp)
constexpr int TY = 8;   // threads sharing one pixel's window rows

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Forward tiling: a block takes TX x SA_R pixels; a thread owns the SA_R
// vertically adjacent pixels of one column, and SA_TY threads (one per warp)
// share a column's window rows.
constexpr int SA_R = 3;
constexpr int SA_TY = 8;
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
__device__ __forceinline__ void stage_rays(float* tile, const float* __restrict__ rb,
                                           size_t plane, int w, int row0, int nrows,
                                           int ux, int uw, int S, int pstride) {
  for (int rr = threadIdx.y; rr < nrows; rr += SA_TY) {
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
// 3 * chunk_rows * (TX + k - 1) floats.
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
    stage_rays(tile, rb, plane, w, uy + c0, nr, ux, uw, S, pstride);
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
      stage_rays(tile, rb, plane, w, uy + c0, nr, ux, uw, S, pstride);
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
      mo[o] = m[r] * inv_t;
      so[o] = ss;
    }
  }
}

__global__ void __launch_bounds__(TX * TY)
softargmax_bwd_kernel(const float* __restrict__ dir,
                      const float* __restrict__ rays,
                      const float* __restrict__ ex, const float* __restrict__ ey,
                      const float* __restrict__ mi, const float* __restrict__ si,
                      const float* __restrict__ gex, const float* __restrict__ gey,
                      float* __restrict__ ddir, float* __restrict__ drays,
                      int h, int w, int p, float inv_t) {
  const int k = 2 * p + 1;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int x = blockIdx.x * TX + tx;
  const int y = blockIdx.y;
  const int b = blockIdx.z;
  const bool active = x < w;
  const size_t plane = (size_t)h * w;
  const float* rb = rays + (size_t)b * 3 * plane;
  float* drb = drays + (size_t)b * 3 * plane;
  const size_t o = (size_t)b * plane + (size_t)y * w + x;

  float a0 = 0.f, a1 = 0.f, a2 = 0.f;
  if (active) {
    const float* db = dir + (size_t)b * 3 * plane + (size_t)y * w + x;
    const float d0 = db[0], d1 = db[plane], d2 = db[2 * plane];
    const float exv = ex[o], eyv = ey[o], mv = mi[o];
    const float sv = fmaxf(si[o], 1e-30f);
    // Fold 1/(T s) into the upstream grads: d logit_i = p_i * (...) / T.
    const float gx = gex[o] / sv * inv_t;
    const float gy = gey[o] / sv * inv_t;
    const int sy = clampi(y - p, 0, h - k);
    const int sx = clampi(x - p, 0, w - k);
    for (int dy = ty; dy < k; dy += TY) {
      const int row = sy + dy;
      const size_t roff = (size_t)row * w + sx;
      const float* r0 = rb + roff;
      const float* r1 = r0 + plane;
      const float* r2 = r1 + plane;
      const float ycoef = gy * ((float)row - eyv);
      for (int dx = 0; dx < k; ++dx) {
        const float v0 = __ldg(r0 + dx), v1 = __ldg(r1 + dx), v2 = __ldg(r2 + dx);
        const float logit = (d0 * v0 + d1 * v1 + d2 * v2) * inv_t;
        const float e = expf(logit - mv);
        const float wgt = e * (gx * ((float)(sx + dx) - exv) + ycoef);
        if (wgt != 0.f) {
          a0 += wgt * v0;
          a1 += wgt * v1;
          a2 += wgt * v2;
          float* t = drb + roff + dx;
          atomicAdd(t, wgt * d0);
          atomicAdd(t + plane, wgt * d1);
          atomicAdd(t + 2 * plane, wgt * d2);
        }
      }
    }
  }

  __shared__ float part[3][TY][TX];
  part[0][ty][tx] = a0;
  part[1][ty][tx] = a1;
  part[2][ty][tx] = a2;
  __syncthreads();
  if (ty == 0 && active) {
    float s0 = 0.f, s1 = 0.f, s2 = 0.f;
    for (int j = 0; j < TY; ++j) {
      s0 += part[0][j][tx];
      s1 += part[1][j][tx];
      s2 += part[2][j][tx];
    }
    float* dd = ddir + (size_t)b * 3 * plane + (size_t)y * w + x;
    dd[0] = s0;
    dd[plane] = s1;
    dd[2 * plane] = s2;
  }
}

constexpr long long SMEM_BUDGET = 99 * 1024;  // of a forward block's staged rays

bool bad_shape(int b, int h, int w, int p) {
  const int k = 2 * p + 1;
  return b < 0 || p < 0 || h < k || w < k || h > 65535 || b > 65535;
}

}  // namespace

// All tensors are contiguous float32 on the device: dir, rays, ddir, drays
// [b, 3, h, w]; ex, ey, m, s, gex, gey [b, h, w]. drays must be zeroed.
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
  const dim3 grid((w + TX - 1) / TX, h, b), block(TX, TY);
  softargmax_bwd_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      dir, rays, ex, ey, m, s, gex, gey, ddir, drays, h, w, p, 1.0f / temperature);
  return (int)cudaGetLastError();
}
