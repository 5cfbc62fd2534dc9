// Bilinear warp (grid sample, align_corners = true) of an NHWC image:
// forward, backward and coordinate-tangent kernels for Hopper (sm_90a).
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
// and warp_bwd_image, only if the caller wants it, d image: the transposed
// warp, d image[q] = sum over the taps (p, k) that land on q of
// g[p] w_k(p), summed in one fixed order with no float atomics (below).
//
// What bounds it on an H100. Bytes: per output pixel the forward must read 8
// bytes of coordinates and write 4C of output, and each image byte once
// (4C per source pixel); the arithmetic is some 20 + 8C operations per
// pixel, two orders of magnitude under the card's operations-to-bytes
// ratio. At the flagship loss's finest scale ([8, 192, 640, 3]) that is
// 31 MB forward and 39 MB backward, about 0.01 ms each at 3.35 TB/s.
//
// Design of the forward. The work per pixel is tiny, so the time is in how
// the loads and stores are made, not in the arithmetic:
// - The batch is blockIdx.y and a pixel's index within its image is an int:
//   no 64-bit division or multiplication per thread, one 64-bit base
//   pointer per block.
// - C is a template parameter for the paths' cases, 3 (RGB) and 1 (masks,
//   depth), so the 4 C tap loads are hoisted ahead of the arithmetic; any
//   other C takes a run-time channel loop.
// - One pixel per thread; the 32 threads of a warp are 32 neighbouring
//   pixels of an output row, so every coordinate load is one coalesced
//   float2 per thread, and as a view-synthesis warp is smooth their taps are
//   neighbours and L1/L2 serve the reuse between them.
// - Where all four taps lie inside the image (nearly every pixel), a row's
//   two taps are read through one pointer as 2 C contiguous floats, with no
//   masks or clamps.
// Measured and dropped (times in PERF.md): 2 or 4 pixels per thread, which
// adds loads in flight but leaves the small shapes with too few blocks; and
// for C = 3, staging the block's results in shared memory to store them as
// coalesced 16-byte vectors, which costs a barrier and more than the strided
// 4-byte stores it saves, as L2 merges those.
// The backward keeps its first design: one thread per output pixel reading
// its four taps straight from the image. Nothing of the TPU formulation is
// carried over: no padded 4-tap stack, no index array, no packing of lanes;
// those answered a machine without a gather.
//
// The image's gradient (warp_bwd_image). The JAX package gets it from
// autodiff of its gather, an XLA scatter-add, whose sum has one order on
// every run. A scatter with float atomics would sum in the order the threads
// arrive, which changes from run to run, so this is a gather over a sorted
// index instead. A tap's target depends on the coordinates only, not on the
// channel, so one index serves all C channels:
// - count: one thread per output pixel p adds 1 (an integer atomic, exact)
//   to the count of each target pixel q of its at most four taps k: the taps
//   inside the image under 'zeros', all four, clamped, under 'border' (where
//   two taps of a pixel may land on one q; both are entries);
// - the caller turns the counts into segment offsets (an exclusive scan of
//   the int32 counts: index bookkeeping, no part of the arithmetic);
// - place: each entry writes its key 4 p + k into its target's segment, at a
//   slot taken with an integer atomic (so in no fixed order);
// - sum: each segment is put in increasing key order and summed in that
//   order, d image[q, ch] = fmaf(g[p, ch], w_k, ...) from 0 in float32, and
//   written once (rounded once to bfloat16 for a bfloat16 image). A segment
//   of at most SEG_SHORT entries (nearly all: about 4 where the warp is
//   smooth) is sorted by one thread in registers; one of at most SEG_MID by a
//   block in shared memory (a bitonic sort); a longer one (every sample
//   clamped into one corner) by a block that walks the image's output pixels
//   in order and keeps those that land on q, chunk by chunk. The three give
//   the same sum in the same order, so d image's bits depend on neither the
//   run nor the launch configuration.
// It reads the coordinates (8 B a pixel) in three passes and the cotangent
// (4C B) once, and writes d image once; its index moves some 40 B more a
// pixel (counts, offsets, keys and their reads).
//
// The coordinate tangent (warp_jvp). The direct pose alignment of the
// ego-motion path (packnet_sfm_tpu/egomotion/alignment.py) builds its
// Gauss-Newton Jacobian from forward-mode derivatives of the warp with
// respect to the coordinates, which JAX takes by forward-mode AD of its XLA
// warp. For a tangent (tx, ty) of the coordinates it writes, a channel at a
// time,
//   t = (W-1)/2 tx [(1-wy)(v01-v00) + wy (v11-v10)] + (H-1)/2 ty (bot - top),
// the contraction of warp_bwd's d coords terms with the tangent in place of
// a cotangent, from the same taps (make_taps), so that both padding modes
// treat the border exactly as warp_fwd and warp_bwd do. One thread per
// output pixel, C a template parameter (3 and 1, else a run-time loop), as
// in warp_fwd. It reads the coordinates and their tangent (16 bytes) and
// the four taps, and writes 4C bytes: 32 bytes a pixel for C = 3 where the
// taps come from cache. It takes a float32 image: the wrapper widens a
// bfloat16 one exactly. The warp is linear in the image, so an image's
// tangent needs no kernel of its own: it is warp_fwd of the tangent.
//
// The bfloat16 image. The JAX package's bfloat16 policy warps a bfloat16
// image at float32 coordinates and gets float32 back (its _lerp_taps
// promotes the taps). The image's element type is a template parameter
// beside C: a bfloat16 tap is widened to float32 exactly (its 16 bits are
// the top half of the float's) and every operation stays in float32, so the
// variant computes the float32 kernel's function of the widened image,
// reading 2 bytes a channel where that reads 4. d image does not read the
// image: warp_bwd_image_bf16 differs from warp_bwd_image only in rounding
// its float32 sum once to bfloat16 where it writes it.

#include <climits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// A tap, widened to float32.
__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  const unsigned short bits = __ldg(reinterpret_cast<const unsigned short*>(p));
  return __uint_as_float((unsigned)bits << 16);
}

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

// T: the image's element type (float or __nv_bfloat16). C > 0: the channel
// count, known to the compiler. C == 0: any count, `c_rt`. The grid is
// (blocks of one image, images).
template <typename T, int C>
__global__ void __launch_bounds__(THREADS)
warp_fwd_kernel(const T* __restrict__ image,
                const float* __restrict__ coords, float* __restrict__ out,
                int per_image, int h, int w, int c_rt, int border) {
  const int c = C > 0 ? C : c_rt;
  const int pix = blockIdx.x * THREADS + threadIdx.x;  // within the image
  const size_t b = blockIdx.y;
  const T* img = image + b * h * w * c;
  const float2* crd = reinterpret_cast<const float2*>(coords) + b * per_image;
  float* o = out + (b * per_image + pix) * c;
  // a thread past the end samples the image's centre and stores nothing
  // (measured faster than leaving early)
  const bool live = pix < per_image;
  const float2 xy = live ? __ldg(crd + pix) : make_float2(0.f, 0.f);
  const Taps t = make_taps(xy.x, xy.y, h, w, border);

  if constexpr (C == 0) {
    if (!live) return;
    const T* p00 = img + t.o00 * c;
    const T* p01 = img + t.o01 * c;
    const T* p10 = img + t.o10 * c;
    const T* p11 = img + t.o11 * c;
    for (int ch = 0; ch < c; ++ch) {
      const float v00 = t.m00 != 0.f ? ld(p00 + ch) : 0.f;
      const float v01 = t.m01 != 0.f ? ld(p01 + ch) : 0.f;
      const float v10 = t.m10 != 0.f ? ld(p10 + ch) : 0.f;
      const float v11 = t.m11 != 0.f ? ld(p11 + ch) : 0.f;
      const float top = v00 * (1.0f - t.wx) + v01 * t.wx;
      const float bot = v10 * (1.0f - t.wx) + v11 * t.wx;
      o[ch] = top * (1.0f - t.wy) + bot * t.wy;
    }
  } else {
    float v[4][C];
    const T* p00 = img + t.o00 * C;
    const T* p10 = img + t.o10 * C;
    // all four taps inside the image: o01 = o00 + 1 and o11 = o10 + 1
    if (t.o01 == t.o00 + 1 && t.o11 == t.o10 + 1 &&
        t.m00 * t.m01 * t.m10 * t.m11 != 0.f) {
#pragma unroll
      for (int ch = 0; ch < C; ++ch) {
        v[0][ch] = ld(p00 + ch);
        v[1][ch] = ld(p00 + C + ch);
        v[2][ch] = ld(p10 + ch);
        v[3][ch] = ld(p10 + C + ch);
      }
    } else {
      const T* p01 = img + t.o01 * C;
      const T* p11 = img + t.o11 * C;
#pragma unroll
      for (int ch = 0; ch < C; ++ch) {
        v[0][ch] = t.m00 != 0.f ? ld(p00 + ch) : 0.f;
        v[1][ch] = t.m01 != 0.f ? ld(p01 + ch) : 0.f;
        v[2][ch] = t.m10 != 0.f ? ld(p10 + ch) : 0.f;
        v[3][ch] = t.m11 != 0.f ? ld(p11 + ch) : 0.f;
      }
    }
#pragma unroll
    for (int ch = 0; ch < C; ++ch) {
      const float top = v[0][ch] * (1.0f - t.wx) + v[1][ch] * t.wx;
      const float bot = v[2][ch] * (1.0f - t.wx) + v[3][ch] * t.wx;
      const float r = top * (1.0f - t.wy) + bot * t.wy;
      if (live) o[ch] = r;
    }
  }
}

// d coords only; d image is warp_bwd_image's.
template <typename T>
__global__ void __launch_bounds__(THREADS)
warp_bwd_kernel(const T* __restrict__ image,
                const float* __restrict__ coords,
                const float* __restrict__ grad_out,
                float* __restrict__ d_coords, long long n_out, int per_image,
                int h, int w, int c, int border) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n_out) return;
  const int b = (int)(i / per_image);
  const Taps t = make_taps(coords[2 * i], coords[2 * i + 1], h, w, border);
  const size_t base = (size_t)b * h * w * c;
  const T* img = image + base;
  const T* p00 = img + (size_t)t.o00 * c;
  const T* p01 = img + (size_t)t.o01 * c;
  const T* p10 = img + (size_t)t.o10 * c;
  const T* p11 = img + (size_t)t.o11 * c;
  const float* g = grad_out + (size_t)i * c;
  float dwx = 0.f, dwy = 0.f;
  // kept rolled: unrolled, the float32 form took 62 registers and 0.0193 ms
  // at [8,192,640,3] on an H100; rolled, 32 and 0.0151 (the same bits)
#pragma unroll 1
  for (int ch = 0; ch < c; ++ch) {
    const float gc = g[ch];
    const float v00 = t.m00 != 0.f ? ld(p00 + ch) : 0.f;
    const float v01 = t.m01 != 0.f ? ld(p01 + ch) : 0.f;
    const float v10 = t.m10 != 0.f ? ld(p10 + ch) : 0.f;
    const float v11 = t.m11 != 0.f ? ld(p11 + ch) : 0.f;
    const float top = v00 * (1.0f - t.wx) + v01 * t.wx;
    const float bot = v10 * (1.0f - t.wx) + v11 * t.wx;
    dwx += gc * ((1.0f - t.wy) * (v01 - v00) + t.wy * (v11 - v10));
    dwy += gc * (bot - top);
  }
  d_coords[2 * i] = dwx * (0.5f * (float)(w - 1));
  d_coords[2 * i + 1] = dwy * (0.5f * (float)(h - 1));
}

// --- warp_bwd_image: the transposed warp, summed in key order -------------

// Longest segment that one thread sorts in registers, and that one block
// sorts in shared memory (a power of two).
constexpr int SEG_SHORT = 32;
constexpr int SEG_MID = 2048;
// Blocks that walk the lists of longer segments (each takes whole segments).
constexpr int LIST_BLOCKS = 264;

// Tap k's target (a pixel offset within its image) and whether it counts.
__device__ __forceinline__ bool tap_target(const Taps& t, int k, int* q) {
  switch (k) {
    case 0: *q = t.o00; return t.m00 != 0.f;
    case 1: *q = t.o01; return t.m01 != 0.f;
    case 2: *q = t.o10; return t.m10 != 0.f;
    default: *q = t.o11; return t.m11 != 0.f;
  }
}

// Tap k's bilinear weight, as warp_fwd weighs it.
__device__ __forceinline__ float tap_weight(float wx, float wy, int k) {
  switch (k) {
    case 0: return (1.0f - wx) * (1.0f - wy);
    case 1: return wx * (1.0f - wy);
    case 2: return (1.0f - wx) * wy;
    default: return wx * wy;
  }
}

// The weight of the entry with key 4 p + k of image b.
__device__ __forceinline__ float key_weight(const float* coords, int b, int per_image,
                                            int key, int h, int w, int border) {
  const float2 xy = __ldg(reinterpret_cast<const float2*>(coords) +
                          (size_t)b * per_image + (key >> 2));
  const Taps t = make_taps(xy.x, xy.y, h, w, border);
  return tap_weight(t.wx, t.wy, key & 3);
}

template <typename TO> __device__ __forceinline__ TO to_out(float v);
template <> __device__ __forceinline__ float to_out<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 to_out<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// counts[b h w]: the taps that land on each pixel.
__global__ void __launch_bounds__(THREADS)
image_grad_count_kernel(const float* __restrict__ coords, int* __restrict__ counts,
                        long long n_out, int per_image, int h, int w, int border) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n_out) return;
  const int b = (int)(i / per_image);
  const Taps t = make_taps(coords[2 * i], coords[2 * i + 1], h, w, border);
  int* cnt = counts + (size_t)b * h * w;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    int q;
    if (tap_target(t, k, &q)) atomicAdd(cnt + q, 1);
  }
}

// keys[offsets[q] ..]: the keys 4 p + k of q's entries; fill[q] counts the
// slots taken (zeroed by the caller).
__global__ void __launch_bounds__(THREADS)
image_grad_place_kernel(const float* __restrict__ coords, const int* __restrict__ offsets,
                        int* __restrict__ fill, int* __restrict__ keys, long long n_out,
                        int per_image, int h, int w, int border) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n_out) return;
  const int b = (int)(i / per_image);
  const int p = (int)(i - (long long)b * per_image);
  const Taps t = make_taps(coords[2 * i], coords[2 * i + 1], h, w, border);
  const int base = b * h * w;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    int q;
    if (tap_target(t, k, &q)) {
      const int slot = atomicAdd(fill + base + q, 1);
      keys[offsets[base + q] + slot] = 4 * p + k;
    }
  }
}

// One thread per target pixel: a segment of at most SEG_SHORT entries is
// sorted and summed here; a longer one goes on list 0 (at most SEG_MID) or
// list 1, whose lengths are lists[0] and lists[1] and whose entries follow
// from lists + 2 and lists + 2 + n_targets.
template <typename TO>
__global__ void __launch_bounds__(THREADS)
image_grad_short_kernel(const float* __restrict__ coords, const float* __restrict__ grad_out,
                        const int* __restrict__ offsets, const int* __restrict__ keys,
                        int* __restrict__ lists, TO* __restrict__ d_image, int n_targets,
                        int per_image, int h, int w, int c, int border) {
  const int q = blockIdx.x * THREADS + threadIdx.x;
  if (q >= n_targets) return;
  const int lo = offsets[q], n = offsets[q + 1] - lo;
  if (n > SEG_SHORT) {
    const int list = n > SEG_MID ? 1 : 0;
    lists[2 + list * n_targets + atomicAdd(lists + list, 1)] = q;
    return;
  }
  int ks[SEG_SHORT];
  float ws[SEG_SHORT];
  for (int j = 0; j < n; ++j) {      // insertion sort
    const int key = keys[lo + j];
    int at = j;
    for (; at > 0 && ks[at - 1] > key; --at) ks[at] = ks[at - 1];
    ks[at] = key;
  }
  const int b = q / (h * w);
  for (int j = 0; j < n; ++j) ws[j] = key_weight(coords, b, per_image, ks[j], h, w, border);
  const float* g = grad_out + (size_t)b * per_image * c;
  for (int ch = 0; ch < c; ++ch) {
    float acc = 0.f;
    for (int j = 0; j < n; ++j) acc = fmaf(g[(size_t)(ks[j] >> 2) * c + ch], ws[j], acc);
    d_image[(size_t)q * c + ch] = to_out<TO>(acc);
  }
}

// List 0: a block a segment, its keys sorted in shared memory.
template <typename TO>
__global__ void __launch_bounds__(THREADS)
image_grad_mid_kernel(const float* __restrict__ coords, const float* __restrict__ grad_out,
                      const int* __restrict__ offsets, const int* __restrict__ keys,
                      const int* __restrict__ lists, TO* __restrict__ d_image, int n_targets,
                      int per_image, int h, int w, int c, int border) {
  __shared__ int ks[SEG_MID];
  __shared__ float ws[SEG_MID];
  const int n_list = lists[0];
  for (int s = blockIdx.x; s < n_list; s += gridDim.x) {
    const int q = lists[2 + s];
    const int lo = offsets[q], n = offsets[q + 1] - lo;
    int n2 = SEG_SHORT;
    while (n2 < n) n2 <<= 1;
    for (int j = threadIdx.x; j < n2; j += THREADS) ks[j] = j < n ? keys[lo + j] : INT_MAX;
    __syncthreads();
    for (int size = 2; size <= n2; size <<= 1) {         // bitonic sort, ascending
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        for (int j = threadIdx.x; j < n2; j += THREADS) {
          const int other = j ^ stride;
          if (other > j) {
            const int a = ks[j], z = ks[other];
            if ((a > z) == ((j & size) == 0)) {
              ks[j] = z;
              ks[other] = a;
            }
          }
        }
        __syncthreads();
      }
    }
    const int b = q / (h * w);
    for (int j = threadIdx.x; j < n; j += THREADS)
      ws[j] = key_weight(coords, b, per_image, ks[j], h, w, border);
    __syncthreads();
    const float* g = grad_out + (size_t)b * per_image * c;
    for (int ch = threadIdx.x; ch < c; ch += THREADS) {
      float acc = 0.f;
      for (int j = 0; j < n; ++j) acc = fmaf(g[(size_t)(ks[j] >> 2) * c + ch], ws[j], acc);
      d_image[(size_t)q * c + ch] = to_out<TO>(acc);
    }
    __syncthreads();
  }
}

// List 1: a block a segment. The block walks the image's output pixels in
// order, THREADS at a time, and keeps the entries that land on q in key
// order (an exclusive scan of each pixel's count); the channels' threads sum
// each chunk's entries after those of the chunks before it. Channels beyond
// THREADS take further walks.
template <typename TO>
__global__ void __launch_bounds__(THREADS)
image_grad_long_kernel(const float* __restrict__ coords, const float* __restrict__ grad_out,
                       const int* __restrict__ lists, TO* __restrict__ d_image, int n_targets,
                       int per_image, int h, int w, int c, int border) {
  __shared__ int pos[THREADS];
  __shared__ int ek[4 * THREADS];
  __shared__ float ew[4 * THREADS];
  const int n_list = lists[1];
  for (int s = blockIdx.x; s < n_list; s += gridDim.x) {
    const int q = lists[2 + n_targets + s];
    const int b = q / (h * w), local = q - b * (h * w);
    const float2* crd = reinterpret_cast<const float2*>(coords) + (size_t)b * per_image;
    const float* g = grad_out + (size_t)b * per_image * c;
    for (int c0 = 0; c0 < c; c0 += THREADS) {
      const int ch = c0 + threadIdx.x;
      float acc = 0.f;
      for (int p0 = 0; p0 < per_image; p0 += THREADS) {
        const int p = p0 + threadIdx.x;
        const bool live = p < per_image;
        const float2 xy = live ? __ldg(crd + p) : make_float2(0.f, 0.f);
        const Taps t = make_taps(xy.x, xy.y, h, w, border);
        int hits[4], n_hit = 0;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          int target;
          if (live && tap_target(t, k, &target) && target == local) hits[n_hit++] = k;
        }
        pos[threadIdx.x] = n_hit;
        __syncthreads();
        for (int stride = 1; stride < THREADS; stride <<= 1) {   // inclusive scan
          const int add = (int)threadIdx.x >= stride ? pos[threadIdx.x - stride] : 0;
          __syncthreads();
          pos[threadIdx.x] += add;
          __syncthreads();
        }
        const int total = pos[THREADS - 1];
        const int first = pos[threadIdx.x] - n_hit;
        for (int j = 0; j < n_hit; ++j) {
          ek[first + j] = 4 * p + hits[j];
          ew[first + j] = tap_weight(t.wx, t.wy, hits[j]);
        }
        __syncthreads();
        if (ch < c)
          for (int j = 0; j < total; ++j)
            acc = fmaf(g[(size_t)(ek[j] >> 2) * c + ch], ew[j], acc);
        __syncthreads();
      }
      if (ch < c) d_image[(size_t)q * c + ch] = to_out<TO>(acc);
    }
  }
}

template <int C>
__global__ void __launch_bounds__(THREADS)
warp_jvp_kernel(const float* __restrict__ image,
                const float* __restrict__ coords,
                const float* __restrict__ tangent, float* __restrict__ out,
                int per_image, int h, int w, int c_rt, int border) {
  const int c = C > 0 ? C : c_rt;
  const int pix = blockIdx.x * THREADS + threadIdx.x;  // within the image
  if (pix >= per_image) return;
  const size_t b = blockIdx.y;
  const float* img = image + b * h * w * c;
  const float2 xy = __ldg(reinterpret_cast<const float2*>(coords) + b * per_image + pix);
  const float2 dxy = __ldg(reinterpret_cast<const float2*>(tangent) + b * per_image + pix);
  const Taps t = make_taps(xy.x, xy.y, h, w, border);
  const float sx = dxy.x * (0.5f * (float)(w - 1));
  const float sy = dxy.y * (0.5f * (float)(h - 1));
  const float* p00 = img + t.o00 * c;
  const float* p01 = img + t.o01 * c;
  const float* p10 = img + t.o10 * c;
  const float* p11 = img + t.o11 * c;
  float* o = out + (b * per_image + pix) * c;
#pragma unroll
  for (int ch = 0; ch < c; ++ch) {
    const float v00 = t.m00 != 0.f ? ld(p00 + ch) : 0.f;
    const float v01 = t.m01 != 0.f ? ld(p01 + ch) : 0.f;
    const float v10 = t.m10 != 0.f ? ld(p10 + ch) : 0.f;
    const float v11 = t.m11 != 0.f ? ld(p11 + ch) : 0.f;
    const float top = v00 * (1.0f - t.wx) + v01 * t.wx;
    const float bot = v10 * (1.0f - t.wx) + v11 * t.wx;
    const float dwx = (1.0f - t.wy) * (v01 - v00) + t.wy * (v11 - v10);
    o[ch] = sx * dwx + sy * (bot - top);
  }
}

bool bad_shape(int b, int h, int w, int c, int ho, int wo) {
  // Element offsets within one image and within one output are ints.
  return b < 0 || h < 1 || w < 1 || c < 1 || ho < 1 || wo < 1 ||
         (long long)h * w * c > 0x7fffffffLL || (long long)ho * wo * c > 0x7fffffffLL;
}

long long blocks_for(long long n) { return (n + THREADS - 1) / THREADS; }

__global__ void empty_kernel() {}

template <typename T>
int launch_fwd(const T* image, const float* coords, float* out, int b, int h,
               int w, int c, int ho, int wo, int padding, void* stream) {
  if (bad_shape(b, h, w, c, ho, wo) || (padding != 0 && padding != 1))
    return (int)cudaErrorInvalidValue;
  const int per_image = ho * wo;
  // gridDim.y holds at most 65535 images: larger batches go in pieces
  for (int b0 = 0; b0 < b; b0 += 65535) {
    const int nb = b - b0 < 65535 ? b - b0 : 65535;
    const dim3 grid((unsigned)blocks_for(per_image), (unsigned)nb);
    const T* im = image + (size_t)b0 * h * w * c;
    const float* co = coords + (size_t)b0 * per_image * 2;
    float* ou = out + (size_t)b0 * per_image * c;
    cudaStream_t st = (cudaStream_t)stream;
    if (c == 3)
      warp_fwd_kernel<T, 3><<<grid, THREADS, 0, st>>>(im, co, ou, per_image, h, w, c, padding);
    else if (c == 1)
      warp_fwd_kernel<T, 1><<<grid, THREADS, 0, st>>>(im, co, ou, per_image, h, w, c, padding);
    else
      warp_fwd_kernel<T, 0><<<grid, THREADS, 0, st>>>(im, co, ou, per_image, h, w, c, padding);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

template <typename T>
int launch_bwd(const T* image, const float* coords, const float* grad_out,
               float* d_coords, int b, int h, int w, int c, int ho, int wo,
               int padding, void* stream) {
  if (bad_shape(b, h, w, c, ho, wo) || (padding != 0 && padding != 1))
    return (int)cudaErrorInvalidValue;
  const long long n = (long long)b * ho * wo;
  if (n == 0) return 0;
  if (blocks_for(n) > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  warp_bwd_kernel<T><<<(unsigned)blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(
      image, coords, grad_out, d_coords, n, ho * wo, h, w, c, padding);
  return (int)cudaGetLastError();
}

// Offsets into the key array and target pixels are ints: at most INT_MAX
// entries (four a pixel) and INT_MAX - 1 pixels.
bool bad_image_grad(int b, int h, int w, int c, int ho, int wo, int padding) {
  return bad_shape(b, h, w, c, ho, wo) || (padding != 0 && padding != 1) ||
         4LL * b * ho * wo > INT_MAX || (long long)b * h * w >= INT_MAX;
}

template <typename TO>
int launch_image_grad(const float* coords, const float* grad_out, const int* offsets,
                      int* fill, int* keys, int* lists, TO* d_image, int b, int h, int w,
                      int c, int ho, int wo, int padding, void* stream) {
  if (bad_image_grad(b, h, w, c, ho, wo, padding)) return (int)cudaErrorInvalidValue;
  const long long n = (long long)b * ho * wo;
  const int n_targets = b * h * w;
  if (n_targets == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (n > 0) {
    image_grad_place_kernel<<<(unsigned)blocks_for(n), THREADS, 0, st>>>(
        coords, offsets, fill, keys, n, ho * wo, h, w, padding);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  image_grad_short_kernel<TO><<<(unsigned)blocks_for(n_targets), THREADS, 0, st>>>(
      coords, grad_out, offsets, keys, lists, d_image, n_targets, ho * wo, h, w, c, padding);
  image_grad_mid_kernel<TO><<<LIST_BLOCKS, THREADS, 0, st>>>(
      coords, grad_out, offsets, keys, lists, d_image, n_targets, ho * wo, h, w, c, padding);
  image_grad_long_kernel<TO><<<LIST_BLOCKS, THREADS, 0, st>>>(
      coords, grad_out, lists, d_image, n_targets, ho * wo, h, w, c, padding);
  return (int)cudaGetLastError();
}

int launch_jvp(const float* image, const float* coords, const float* tangent,
               float* out, int b, int h, int w, int c, int ho, int wo,
               int padding, void* stream) {
  if (bad_shape(b, h, w, c, ho, wo) || (padding != 0 && padding != 1))
    return (int)cudaErrorInvalidValue;
  const int per_image = ho * wo;
  for (int b0 = 0; b0 < b; b0 += 65535) {
    const int nb = b - b0 < 65535 ? b - b0 : 65535;
    const dim3 grid((unsigned)blocks_for(per_image), (unsigned)nb);
    const float* im = image + (size_t)b0 * h * w * c;
    const float* co = coords + (size_t)b0 * per_image * 2;
    const float* ta = tangent + (size_t)b0 * per_image * 2;
    float* ou = out + (size_t)b0 * per_image * c;
    cudaStream_t st = (cudaStream_t)stream;
    if (c == 3)
      warp_jvp_kernel<3><<<grid, THREADS, 0, st>>>(im, co, ta, ou, per_image, h, w, c, padding);
    else if (c == 1)
      warp_jvp_kernel<1><<<grid, THREADS, 0, st>>>(im, co, ta, ou, per_image, h, w, c, padding);
    else
      warp_jvp_kernel<0><<<grid, THREADS, 0, st>>>(im, co, ta, ou, per_image, h, w, c, padding);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace

// All tensors are contiguous on the device. image [b, h, w, c]: float32, or
// bfloat16 for the _bf16 launchers; coords and d_coords [b, ho, wo, 2], out
// and grad_out [b, ho, wo, c], float32. padding: 0 zeros, 1 border. All
// launch on `stream` and return cudaGetLastError() (0 on success).

extern "C" int warp_fwd(const float* image, const float* coords, float* out,
                        int b, int h, int w, int c, int ho, int wo,
                        int padding, void* stream) {
  return launch_fwd(image, coords, out, b, h, w, c, ho, wo, padding, stream);
}

extern "C" int warp_bwd(const float* image, const float* coords,
                        const float* grad_out, float* d_coords, int b, int h,
                        int w, int c, int ho, int wo, int padding,
                        void* stream) {
  return launch_bwd(image, coords, grad_out, d_coords, b, h, w, c, ho, wo,
                    padding, stream);
}

extern "C" int warp_fwd_bf16(const void* image, const float* coords,
                             float* out, int b, int h, int w, int c, int ho,
                             int wo, int padding, void* stream) {
  return launch_fwd(static_cast<const __nv_bfloat16*>(image), coords, out, b,
                    h, w, c, ho, wo, padding, stream);
}

extern "C" int warp_bwd_bf16(const void* image, const float* coords,
                             const float* grad_out, float* d_coords, int b,
                             int h, int w, int c, int ho, int wo, int padding,
                             void* stream) {
  return launch_bwd(static_cast<const __nv_bfloat16*>(image), coords,
                    grad_out, d_coords, b, h, w, c, ho, wo, padding, stream);
}

// d image of an image [b, h, w, c], in two calls around the caller's scan.
// warp_bwd_image_count adds each tap's 1 to counts [b h w] (int32, zeroed).
// warp_bwd_image takes offsets [b h w + 1], the exclusive scan of those
// counts, and scratch: fill [b h w] (int32, zeroed), keys [4 b ho wo] and
// lists [2 + 2 b h w] (int32, the first two zeroed). d_image is float32, or
// bfloat16 for warp_bwd_image_bf16; every element of it is written.
extern "C" int warp_bwd_image_count(const float* coords, int* counts, int b, int h,
                                    int w, int ho, int wo, int padding,
                                    void* stream) {
  if (bad_image_grad(b, h, w, 1, ho, wo, padding)) return (int)cudaErrorInvalidValue;
  const long long n = (long long)b * ho * wo;
  if (n == 0) return 0;
  image_grad_count_kernel<<<(unsigned)blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(
      coords, counts, n, ho * wo, h, w, padding);
  return (int)cudaGetLastError();
}

extern "C" int warp_bwd_image(const float* coords, const float* grad_out,
                              const int* offsets, int* fill, int* keys, int* lists,
                              float* d_image, int b, int h, int w, int c, int ho,
                              int wo, int padding, void* stream) {
  return launch_image_grad(coords, grad_out, offsets, fill, keys, lists, d_image, b,
                           h, w, c, ho, wo, padding, stream);
}

extern "C" int warp_bwd_image_bf16(const float* coords, const float* grad_out,
                                   const int* offsets, int* fill, int* keys,
                                   int* lists, void* d_image, int b, int h, int w,
                                   int c, int ho, int wo, int padding,
                                   void* stream) {
  return launch_image_grad(coords, grad_out, offsets, fill, keys, lists,
                           static_cast<__nv_bfloat16*>(d_image), b, h, w, c, ho,
                           wo, padding, stream);
}

// coords_tangent [b, ho, wo, 2] and out [b, ho, wo, c], float32: the
// derivative of warp_fwd's output along coords_tangent (float32 image).
extern "C" int warp_jvp(const float* image, const float* coords,
                        const float* coords_tangent, float* out, int b, int h,
                        int w, int c, int ho, int wo, int padding,
                        void* stream) {
  return launch_jvp(image, coords, coords_tangent, out, b, h, w, c, ho, wo,
                    padding, stream);
}

// One warp that does nothing: the time no launch on the card can go under.
extern "C" int launch_floor(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
