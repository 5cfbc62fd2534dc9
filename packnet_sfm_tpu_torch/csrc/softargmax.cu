// Streaming patch soft-argmax for the neural-ray-surface (NRS) camera:
// forward and backward kernels for Hopper (sm_90a).
//
// Replaces: packnet_sfm_tpu/ops/pallas_softargmax.py, _fwd_kernel (forward)
// and _bwd_kernel (backward, with the VJP of _build_stack).
//
// What it computes. For each pixel (b, y, x), an online softmax over its
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
// a call evaluates 192 * 192 * 41 * 41 = 62 M window positions, each a
// 3-term dot, one exp and about ten more FLOPs, over 1.5 MB of inputs and
// outputs: it is bound by exp and FMA issue, not by bytes, once the rays sit
// in L1. The design keeps all window traffic in L1/L2: the 32 threads of a
// warp are 32 neighbouring pixels of one row, so at each window position
// they read 32 neighbouring rays (one coalesced line per channel), and
// neighbouring warps and window rows hit the same lines again. The online
// softmax rescales only when the running max changes, so an ordinary window
// position costs one exp, not two. To fill the card at batch 1 (36,864
// pixels), each pixel's k window rows are split over TY = 8 threads, whose
// partial (m, s, numerators) states are merged in shared memory. In the
// backward, positions whose weight underflows to zero (most of them at the
// path's T ~ 1e-4) skip their three atomics. Staging the block's window
// union in shared memory, and a deterministic gather for d_ray, are left
// for a later change.

#include <cuda_runtime.h>

namespace {

constexpr int TX = 32;  // pixels of one row per block (one warp)
constexpr int TY = 8;   // threads sharing one pixel's window rows

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__global__ void __launch_bounds__(TX * TY)
softargmax_fwd_kernel(const float* __restrict__ dir,
                      const float* __restrict__ rays,
                      float* __restrict__ ex, float* __restrict__ ey,
                      float* __restrict__ mo, float* __restrict__ so,
                      int h, int w, int p, float inv_t) {
  const int k = 2 * p + 1;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int x = blockIdx.x * TX + tx;
  const int y = blockIdx.y;
  const int b = blockIdx.z;
  const bool active = x < w;
  const size_t plane = (size_t)h * w;
  const float* rb = rays + (size_t)b * 3 * plane;

  float m = -1e30f, s = 0.f, nx = 0.f, ny = 0.f;
  if (active) {
    const float* db = dir + (size_t)b * 3 * plane + (size_t)y * w + x;
    const float d0 = db[0], d1 = db[plane], d2 = db[2 * plane];
    const int sy = clampi(y - p, 0, h - k);
    const int sx = clampi(x - p, 0, w - k);
    for (int dy = ty; dy < k; dy += TY) {
      const int row = sy + dy;
      const float* r0 = rb + (size_t)row * w + sx;
      const float* r1 = r0 + plane;
      const float* r2 = r1 + plane;
      const float cy = (float)row;
      for (int dx = 0; dx < k; ++dx) {
        const float logit =
            (d0 * __ldg(r0 + dx) + d1 * __ldg(r1 + dx) + d2 * __ldg(r2 + dx)) * inv_t;
        const float cx = (float)(sx + dx);
        if (logit > m) {
          const float sc = expf(m - logit);
          s = s * sc + 1.f;
          nx = nx * sc + cx;
          ny = ny * sc + cy;
          m = logit;
        } else {
          const float e = expf(logit - m);
          s += e;
          nx += e * cx;
          ny += e * cy;
        }
      }
    }
  }

  __shared__ float part[4][TY][TX];
  part[0][ty][tx] = m;
  part[1][ty][tx] = s;
  part[2][ty][tx] = nx;
  part[3][ty][tx] = ny;
  __syncthreads();
  if (ty == 0 && active) {
    float mm = part[0][0][tx];
    for (int j = 1; j < TY; ++j) mm = fmaxf(mm, part[0][j][tx]);
    float ss = 0.f, sx_ = 0.f, sy_ = 0.f;
    for (int j = 0; j < TY; ++j) {
      const float f = expf(part[0][j][tx] - mm);
      ss += part[1][j][tx] * f;
      sx_ += part[2][j][tx] * f;
      sy_ += part[3][j][tx] * f;
    }
    const size_t o = (size_t)b * plane + (size_t)y * w + x;
    const float denom = fmaxf(ss, 1e-30f);
    ex[o] = sx_ / denom;
    ey[o] = sy_ / denom;
    mo[o] = mm;
    so[o] = ss;
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
  const dim3 grid((w + TX - 1) / TX, h, b), block(TX, TY);
  softargmax_fwd_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      dir, rays, ex, ey, m, s, h, w, p, 1.0f / temperature);
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
