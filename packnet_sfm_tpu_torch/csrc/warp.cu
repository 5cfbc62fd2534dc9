// Bilinear warp (grid sample, align_corners = true) of an NHWC image:
// forward and backward kernels for Hopper (sm_90a).
//
// Replaces: the row gather of the warp's four taps that the JAX package
// probed as a Pallas kernel (docs/bench_pallas_gather_probe.py,
// pallas_gather with _kern_raw / _kern_aligned:
// out[b, r, j, :] = stack[b, idx[b, r, j], :]), together with the XLA code
// that builds its operands and consumes its result
// (packnet_sfm_tpu/ops/warp.py: _sample_pieces, _masked_taps, _lerp_taps,
// grid_sample) and the backward of that gather (_gsd_bwd and the autodiff
// transpose, a scatter-add).
//
// What it computes. For every output pixel (b, i, j) with normalized
// coordinates (cx, cy) = coords[b, i, j]:
//   x = (cx + 1) / 2 * (W - 1),  y = (cy + 1) / 2 * (H - 1),
//   x0 = floor(x), y0 = floor(y), wx = x - x0, wy = y - y0,
//   out = (1-wy) [(1-wx) v00 + wx v01] + wy [(1-wx) v10 + wx v11],
// where v00..v11 are the image at (y0, x0), (y0, x0+1), (y0+1, x0),
// (y0+1, x0+1). padding 'zeros': a tap outside the image counts as 0;
// 'border': a tap's index is clamped into the image. The backward returns
//   d cx = (W-1)/2 * sum_c g [(1-wy)(v01-v00) + wy (v11-v10)],
//   d cy = (H-1)/2 * sum_c g [(bot - top)],
// and, only if the caller wants it, d image, scattered with atomicAdd into a
// zeroed buffer (so its summation order changes from run to run).
//
// What bounds it on an H100. Bytes: per output pixel the forward must read 8
// bytes of coordinates and write 4C of output, and each image byte once
// (4C per source pixel); the arithmetic is some 20 + 8C operations per
// pixel, two orders of magnitude under the card's operations-to-bytes
// ratio. At the flagship loss's finest scale ([8, 192, 640, 3]) that is
// 31 MB forward and 39 MB backward, about 0.01 ms each at 3.35 TB/s.
//
// Design. One thread per output pixel; the 32 threads of a warp are 32
// neighbouring pixels of an output row, so coordinates and output are read
// and written coalesced. Each thread reads its own four taps straight from
// the image: a view-synthesis warp is smooth, so neighbouring threads hit
// neighbouring pixels and L1/L2 serve the reuse between them. Nothing of
// the TPU formulation is carried over: no padded 4-tap stack, no index
// array, no packing of lanes; those answered a machine without a gather.
// Staging image tiles in shared memory, and a deterministic d image, are
// left for a later change.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

struct Taps {
  // Flat pixel offsets (in pixels, within one image) and validity of the
  // four taps, and the lerp weights.
  int o00, o01, o10, o11;
  float m00, m01, m10, m11;  // 1 where the tap counts, else 0
  float wx, wy;
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// `border` != 0: clamp tap indices; else mask the taps outside the image.
__device__ __forceinline__ Taps make_taps(float cx, float cy, int h, int w,
                                          int border) {
  Taps t;
  const float x = (cx + 1.0f) * 0.5f * (float)(w - 1);
  const float y = (cy + 1.0f) * 0.5f * (float)(h - 1);
  const float x0f = floorf(x), y0f = floorf(y);
  t.wx = x - x0f;
  t.wy = y - y0f;
  // Clamp in float before the conversion, so far-away (or non-finite)
  // coordinates cannot overflow the integer; -2 and w are both outside.
  const int x0 = (int)fminf(fmaxf(x0f, -2.0f), (float)w);
  const int y0 = (int)fminf(fmaxf(y0f, -2.0f), (float)h);
  const int x1 = x0 + 1, y1 = y0 + 1;
  const bool vx0 = x0 >= 0 && x0 <= w - 1, vx1 = x1 >= 0 && x1 <= w - 1;
  const bool vy0 = y0 >= 0 && y0 <= h - 1, vy1 = y1 >= 0 && y1 <= h - 1;
  const int cx0 = clampi(x0, 0, w - 1), cx1 = clampi(x1, 0, w - 1);
  const int cy0 = clampi(y0, 0, h - 1), cy1 = clampi(y1, 0, h - 1);
  t.o00 = cy0 * w + cx0;
  t.o01 = cy0 * w + cx1;
  t.o10 = cy1 * w + cx0;
  t.o11 = cy1 * w + cx1;
  t.m00 = (border || (vx0 && vy0)) ? 1.0f : 0.0f;
  t.m01 = (border || (vx1 && vy0)) ? 1.0f : 0.0f;
  t.m10 = (border || (vx0 && vy1)) ? 1.0f : 0.0f;
  t.m11 = (border || (vx1 && vy1)) ? 1.0f : 0.0f;
  return t;
}

__global__ void __launch_bounds__(THREADS)
warp_fwd_kernel(const float* __restrict__ image,
                const float* __restrict__ coords, float* __restrict__ out,
                long long n_out, int per_image, int h, int w, int c,
                int border) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n_out) return;
  const int b = (int)(i / per_image);
  const Taps t = make_taps(coords[2 * i], coords[2 * i + 1], h, w, border);
  const float* img = image + (size_t)b * h * w * c;
  const float* p00 = img + (size_t)t.o00 * c;
  const float* p01 = img + (size_t)t.o01 * c;
  const float* p10 = img + (size_t)t.o10 * c;
  const float* p11 = img + (size_t)t.o11 * c;
  float* o = out + (size_t)i * c;
  for (int ch = 0; ch < c; ++ch) {
    const float v00 = t.m00 != 0.f ? __ldg(p00 + ch) : 0.f;
    const float v01 = t.m01 != 0.f ? __ldg(p01 + ch) : 0.f;
    const float v10 = t.m10 != 0.f ? __ldg(p10 + ch) : 0.f;
    const float v11 = t.m11 != 0.f ? __ldg(p11 + ch) : 0.f;
    const float top = v00 * (1.0f - t.wx) + v01 * t.wx;
    const float bot = v10 * (1.0f - t.wx) + v11 * t.wx;
    o[ch] = top * (1.0f - t.wy) + bot * t.wy;
  }
}

// d_image may be null: then only d_coords is written.
__global__ void __launch_bounds__(THREADS)
warp_bwd_kernel(const float* __restrict__ image,
                const float* __restrict__ coords,
                const float* __restrict__ grad_out,
                float* __restrict__ d_coords, float* __restrict__ d_image,
                long long n_out, int per_image, int h, int w, int c,
                int border) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n_out) return;
  const int b = (int)(i / per_image);
  const Taps t = make_taps(coords[2 * i], coords[2 * i + 1], h, w, border);
  const size_t base = (size_t)b * h * w * c;
  const float* img = image + base;
  const float* p00 = img + (size_t)t.o00 * c;
  const float* p01 = img + (size_t)t.o01 * c;
  const float* p10 = img + (size_t)t.o10 * c;
  const float* p11 = img + (size_t)t.o11 * c;
  const float* g = grad_out + (size_t)i * c;
  const float w00 = (1.0f - t.wx) * (1.0f - t.wy), w01 = t.wx * (1.0f - t.wy);
  const float w10 = (1.0f - t.wx) * t.wy, w11 = t.wx * t.wy;
  float dwx = 0.f, dwy = 0.f;
  for (int ch = 0; ch < c; ++ch) {
    const float gc = g[ch];
    const float v00 = t.m00 != 0.f ? __ldg(p00 + ch) : 0.f;
    const float v01 = t.m01 != 0.f ? __ldg(p01 + ch) : 0.f;
    const float v10 = t.m10 != 0.f ? __ldg(p10 + ch) : 0.f;
    const float v11 = t.m11 != 0.f ? __ldg(p11 + ch) : 0.f;
    const float top = v00 * (1.0f - t.wx) + v01 * t.wx;
    const float bot = v10 * (1.0f - t.wx) + v11 * t.wx;
    dwx += gc * ((1.0f - t.wy) * (v01 - v00) + t.wy * (v11 - v10));
    dwy += gc * (bot - top);
    if (d_image != nullptr) {
      float* di = d_image + base;
      if (t.m00 != 0.f) atomicAdd(di + (size_t)t.o00 * c + ch, gc * w00);
      if (t.m01 != 0.f) atomicAdd(di + (size_t)t.o01 * c + ch, gc * w01);
      if (t.m10 != 0.f) atomicAdd(di + (size_t)t.o10 * c + ch, gc * w10);
      if (t.m11 != 0.f) atomicAdd(di + (size_t)t.o11 * c + ch, gc * w11);
    }
  }
  d_coords[2 * i] = dwx * (0.5f * (float)(w - 1));
  d_coords[2 * i + 1] = dwy * (0.5f * (float)(h - 1));
}

bool bad_shape(int b, int h, int w, int c, int ho, int wo) {
  // Pixel offsets within one image and within one output are ints.
  return b < 0 || h < 1 || w < 1 || c < 1 || ho < 1 || wo < 1 ||
         (long long)h * w > 0x7fffffffLL || (long long)ho * wo > 0x7fffffffLL;
}

long long blocks_for(long long n) { return (n + THREADS - 1) / THREADS; }

}  // namespace

// All tensors are contiguous float32 on the device: image and d_image
// [b, h, w, c]; coords and d_coords [b, ho, wo, 2]; out and grad_out
// [b, ho, wo, c]. padding: 0 zeros, 1 border. d_image is null or zeroed.
// Both launch on `stream` and return cudaGetLastError() (0 on success).

extern "C" int warp_fwd(const float* image, const float* coords, float* out,
                        int b, int h, int w, int c, int ho, int wo,
                        int padding, void* stream) {
  if (bad_shape(b, h, w, c, ho, wo) || (padding != 0 && padding != 1))
    return (int)cudaErrorInvalidValue;
  const long long n = (long long)b * ho * wo;
  if (n == 0) return 0;
  if (blocks_for(n) > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  warp_fwd_kernel<<<(unsigned)blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(
      image, coords, out, n, ho * wo, h, w, c, padding);
  return (int)cudaGetLastError();
}

extern "C" int warp_bwd(const float* image, const float* coords,
                        const float* grad_out, float* d_coords,
                        float* d_image, int b, int h, int w, int c, int ho,
                        int wo, int padding, void* stream) {
  if (bad_shape(b, h, w, c, ho, wo) || (padding != 0 && padding != 1))
    return (int)cudaErrorInvalidValue;
  const long long n = (long long)b * ho * wo;
  if (n == 0) return 0;
  if (blocks_for(n) > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  warp_bwd_kernel<<<(unsigned)blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(
      image, coords, grad_out, d_coords, d_image, n, ho * wo, h, w, c,
      padding);
  return (int)cudaGetLastError();
}
