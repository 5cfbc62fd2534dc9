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
// - the sum of target q is d image[q, ch] = fmaf(g[p, ch], w_k(p), ...) over
//   its entries (p, k) in increasing key 4 p + k, from 0 in float32, written
//   once (rounded once to bfloat16 for a bfloat16 image); the entries are
//   the taps inside the image under 'zeros', all four, clamped, under
//   'border' (where two taps of a pixel may land on one q: both count);
// - targets are binned by tiles of TILE_H x TILE_W pixels, not by pixel.
//   Place (a thread an output pixel): each warp finds the tiles its 32
//   pixels' taps land on (__reduce_min_sync over each lane's sorted tiles)
//   and writes one record (warp, lanes with a tap there), 8 B, into each
//   tile's bin of BIN_RECORDS, at a slot taken with an integer atomic, the
//   warp's atomics in flight together. A smooth view-synthesis warp gives
//   ~2.3 records a warp, ~18 a tile: ~70 k atomics and ~0.6 MB of records at
//   [8,192,640] where a per-pixel index took 7.9 M atomics and ~40 B a pixel;
// - sum (a block a tile, a thread a target): the block sorts its bin's
//   records by warp, so its pixel slots (each record's lanes in order) run in
//   increasing p. A round of ROUND slots reads each slot's coordinates and
//   cotangent once, and lists the slot under the cell of its first tap
//   (y0, x0), a cell's first CELL_SLOTS in place. Tap k = (dy, dx) lands on
//   (y0 + dy, x0 + dx), so a target away from a 'border' image's edge takes
//   tap k from cell t - (dy, dx) alone: its thread sorts the slots of its four
//   cells, 4 slot + k, with a network of 19 comparators (more than two in a
//   cell: a merge) and adds them in that order. A target on a 'border'
//   edge, where clamped taps of up to 4 x 4 cells meet, merges their lists
//   and tests each tap. Rounds follow in slot order; neighbouring threads
//   write neighbouring pixels. A round with more than CELL_SLOTS slots in a
//   cell (a zoom-out, samples clamped into a corner) lists every cell's
//   slots after a block scan instead;
// - a bin with more than BIN_RECORDS records (more than 256 warps on one
//   tile) takes the walk: its block walks every output pixel of the image in
//   order and keeps those with a tap on the tile (a block scan), then the
//   same rounds. Same order, same bits; slower, on such tiles only;
// - three device operations a call: the fill counters' memset (4 B a tile),
//   place and sum; the records are scratch of any contents, as no pass reads
//   a slot that place did not write.
// The bits do not depend on the run, the launch or the path a tile takes:
// every path adds a target's taps in key order. What bounds it: it must
// read the coordinates (8 B a pixel) and the cotangent (4C B) and write
// d image (4C B a source pixel), 0.0094 ms at [8,192,640,3] at 3.35 TB/s;
// it reads the coordinates twice and its records (~1 B a pixel) once each
// way. Measured on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md), the sum
// pass takes over two thirds of the time and is bound by each block's chain
// of dependent loads and barriers, not by bytes; place by its instructions
// (~300 a pixel). Measured and dropped there (the whole call at
// [8,192,640,3], float32): grouping a round's four entries a slot by target
// with shared atomics and ranks, 0.077 ms (the cells' one list entry a
// slot, 0.058, then in place with the sorting network, 0.045); a
// per-target insertion sort of those entries (80 registers, 0.094); picking
// each target's least slot from unsorted cells, 0.083; tiles of 4 x 32 or
// 16 x 16 targets (no faster, or slower); one resident block a slot walking
// tiles with the next tile's records loaded ahead, 0.049; L1 prefetch of a
// record's coordinates and cotangent while the records are sorted
// (+0.001); a slot's four tap weights kept in shared memory, 0.046; a count
// pass and a scan before place, which the fixed bins make unneeded. Kept:
// __launch_bounds__ for six blocks an SM (40 registers).
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
  int x0, y0;                // the first tap's column and row, in [-2, w] and [-2, h]
  int cx0, cx1, cy0, cy1;    // the taps' columns and rows, clamped into the image
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
  t.x0 = x0;
  t.y0 = y0;
  t.cx0 = cx0;
  t.cx1 = cx1;
  t.cy0 = cy0;
  t.cy1 = cy1;
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

// A tile of TILE_H x TILE_W target pixels is one block of the sum pass, a
// target a thread. A tile's bin keeps at most BIN_RECORDS records, one a
// thread; a tile with more takes the walk. A round of the sum pass takes
// ROUND pixel slots.
constexpr int TILE_W = 32;
constexpr int TILE_H = 8;
constexpr int TILE_THREADS = TILE_W * TILE_H;
constexpr int BIN_RECORDS = 256;
constexpr int ROUND = 2 * TILE_THREADS;
// The cells of first taps (y0, x0) whose taps can land on a tile: its rows
// and columns, two before them and one after.
constexpr int CELLS_W = TILE_W + 3;
constexpr int CELLS_H = TILE_H + 3;
// A cell's slots of a round kept in place; a round with more in a cell
// lists every cell's slots, and a list of more than SHORT_LIST is put in
// order by its slots' ranks, not by its cell's thread.
constexpr int CELL_SLOTS = 4;
constexpr int SHORT_LIST = 32;
constexpr unsigned NO_TILE = 0xffffffffu;
static_assert(BIN_RECORDS == TILE_THREADS, "a record a thread");
static_assert(CELLS_W * CELLS_H <= 2 * TILE_THREADS, "two cells a thread");

// Tap k's bilinear weight, as warp_fwd weighs it.
__device__ __forceinline__ float tap_weight(float wx, float wy, int k) {
  switch (k) {
    case 0: return (1.0f - wx) * (1.0f - wy);
    case 1: return wx * (1.0f - wy);
    case 2: return (1.0f - wx) * wy;
    default: return wx * wy;
  }
}

template <typename TO> __device__ __forceinline__ TO to_out(float v);
template <> __device__ __forceinline__ float to_out<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 to_out<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ void sort2(unsigned& a, unsigned& b) {
  const unsigned lo = min(a, b);
  b = max(a, b);
  a = lo;
}

__device__ __forceinline__ void sort2(int& a, int& b) {
  const int lo = min(a, b);
  b = max(a, b);
  a = lo;
}

// Eight ints in increasing order (a network of 19 comparators).
__device__ __forceinline__ void sort8(int (&e)[8]) {
  sort2(e[0], e[2]), sort2(e[1], e[3]), sort2(e[4], e[6]), sort2(e[5], e[7]);
  sort2(e[0], e[4]), sort2(e[1], e[5]), sort2(e[2], e[6]), sort2(e[3], e[7]);
  sort2(e[0], e[1]), sort2(e[2], e[3]), sort2(e[4], e[5]), sort2(e[6], e[7]);
  sort2(e[2], e[4]), sort2(e[3], e[5]);
  sort2(e[1], e[4]), sort2(e[3], e[6]);
  sort2(e[1], e[2]), sort2(e[3], e[4]), sort2(e[5], e[6]);
}

// Exclusive prefix sum of v over the block's N threads in order, and in
// *total the sum. Every thread of the block calls it; scratch holds N / 32
// ints.
template <int N>
__device__ __forceinline__ int block_scan(int v, int* total, int* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) scratch[warp] = x;
  __syncthreads();
  int before = 0, all = 0;
#pragma unroll
  for (int k = 0; k < N / 32; ++k) {
    const int s = scratch[k];
    before += k < warp ? s : 0;
    all += s;
  }
  __syncthreads();
  *total = all;
  return before + x - v;
}

// Whether tap k of t counts and lands on the tile whose first row and
// column are y_lo and x_lo.
__device__ __forceinline__ bool tap_in_tile(const Taps& t, int k, int y_lo, int x_lo) {
  const int y = k < 2 ? t.cy0 : t.cy1, x = (k & 1) ? t.cx1 : t.cx0;
  const float m = k == 0 ? t.m00 : (k == 1 ? t.m01 : (k == 2 ? t.m10 : t.m11));
  return m != 0.f && y >= y_lo && y < y_lo + TILE_H && x >= x_lo && x < x_lo + TILE_W;
}

// Place: each warp writes one record (warp, lanes) into the bin of each
// tile that a tap of one of its lanes lands on; fill[tile] counts the
// records (zeroed by the launcher), and a bin keeps the first BIN_RECORDS.
// The warp finds its tiles first, lane i keeping the i-th, and then they
// take their slots together: one atomic's round trip a warp, not one a tile.
__global__ void __launch_bounds__(THREADS)
image_grad_place_kernel(const float* __restrict__ coords, int* __restrict__ fill,
                        int2* __restrict__ records, long long n_out, int per_image, int h,
                        int w, int border, int tiles_x, int tiles_img) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  const int lane = threadIdx.x & 31;
  unsigned v0 = NO_TILE, v1 = NO_TILE, v2 = NO_TILE, v3 = NO_TILE;
  if (i < n_out) {
    const unsigned b = (unsigned)i / (unsigned)per_image;  // n_out <= INT_MAX
    const float2 xy = __ldg(reinterpret_cast<const float2*>(coords) + i);
    const Taps t = make_taps(xy.x, xy.y, h, w, border);
    // the taps' tiles: rows of tiles r0 <= r1, columns c0 <= c1
    const unsigned r0 = b * tiles_img + (unsigned)t.cy0 / TILE_H * tiles_x;
    const unsigned r1 = b * tiles_img + (unsigned)t.cy1 / TILE_H * tiles_x;
    const unsigned c0 = (unsigned)t.cx0 / TILE_W, c1 = (unsigned)t.cx1 / TILE_W;
    v0 = t.m00 != 0.f ? r0 + c0 : NO_TILE;
    v1 = t.m01 != 0.f ? r0 + c1 : NO_TILE;
    v2 = t.m10 != 0.f ? r1 + c0 : NO_TILE;
    v3 = t.m11 != 0.f ? r1 + c1 : NO_TILE;
    sort2(v0, v1);
    sort2(v2, v3);
    sort2(v0, v2);
    sort2(v1, v3);
    sort2(v1, v2);
    // drop repeats (each follows its equal)
    if (v3 == v2) v3 = NO_TILE;
    if (v2 == v1) v2 = v3, v3 = NO_TILE;
    if (v1 == v0) v1 = v2, v2 = v3, v3 = NO_TILE;
  }
  const int warp_id = (int)(i >> 5);
  unsigned my_tile = NO_TILE, my_lanes = 0;
  int found = 0;  // the same in every lane
  for (;;) {
    // the warp's next tile in increasing order, and its lanes
    const unsigned tile = __reduce_min_sync(0xffffffffu, v0);
    if (tile != NO_TILE) {
      const unsigned lanes = __ballot_sync(0xffffffffu, v0 == tile);
      if (v0 == tile) v0 = v1, v1 = v2, v2 = v3, v3 = NO_TILE;
      if (lane == found) {
        my_tile = tile;
        my_lanes = lanes;
      }
      ++found;
    }
    if (tile == NO_TILE || found == 32) {
      if (my_tile != NO_TILE) {
        const int slot = atomicAdd(fill + my_tile, 1);
        if (slot < BIN_RECORDS)
          records[(size_t)my_tile * BIN_RECORDS + slot] = make_int2(warp_id, (int)my_lanes);
      }
      if (tile == NO_TILE) break;
      my_tile = NO_TILE;
      found = 0;
    }
  }
}

// Sum: a block a tile, a thread a target pixel. The tile's pixel slots are
// the output pixels with a tap on it, in increasing order: the bin's records
// sorted by warp, each record's lanes in order; or, where the bin
// overflowed, every output pixel of the image walked in order and kept where
// a tap lands on the tile. A round takes ROUND slots and lists them by the
// cell of their first tap (y0, x0), in slot order within a cell. Tap k =
// (dy, dx) lands on (y0 + dy, x0 + dx), so a target t away from a 'border'
// image's edge takes tap k from the slots of cell t - (dy, dx) alone: its
// thread puts its four cells' slots in the order of the keys 4 p + k (a
// sorting network, or a merge where a cell holds more than two). A target
// on a 'border' image's edge, where clamped taps of more cells (and several
// taps of one slot) meet, merges the lists of the cells that can reach it
// and tests each tap. Each thread adds to its sums with fmaf, round after
// round.
template <typename TO, int C>
__global__ void __launch_bounds__(TILE_THREADS, 6)
image_grad_sum_kernel(const float* __restrict__ coords, const float* __restrict__ grad_out,
                      const int* __restrict__ fill, const int2* __restrict__ records,
                      TO* __restrict__ d_image, int per_image, int h, int w, int c_rt,
                      int border, int tiles_x, int tiles_img) {
  constexpr int T = TILE_THREADS;
  constexpr int CG = C > 0 ? C : 4;  // channels a pass sums
  const int c = C > 0 ? C : c_rt;
  __shared__ int s_warp[BIN_RECORDS];  // the records, sorted by warp
  __shared__ unsigned s_lanes[BIN_RECORDS];
  __shared__ int s_first[BIN_RECORDS];  // a record's first pixel slot
  __shared__ int s_slot[ROUND];                           // a round's slots: output pixel,
  __shared__ unsigned short s_cell[ROUND];                // cell of the first tap,
  __shared__ float s_wx[ROUND], s_wy[ROUND];              // lerp weights
  __shared__ float s_g[ROUND * CG];                       // and cotangent
  __shared__ int s_n[2][2 * T];  // a cell's slots, one array a round in turn
  __shared__ int s_at[2 * T];    // a cell's first slot in s_list
  __shared__ unsigned short s_few[CELLS_W * CELLS_H * CELL_SLOTS];  // a cell's first slots
  __shared__ unsigned short s_list[ROUND];  // every cell's slots (a crowded round)
  __shared__ int s_scan[T / 32];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tile = blockIdx.x;
  const int b = tile / tiles_img, in_image = tile - b * tiles_img;
  const int ty = in_image / tiles_x;
  const int y_lo = ty * TILE_H, x_lo = (in_image - ty * tiles_x) * TILE_W;
  const int ly = tid / TILE_W, lx = tid % TILE_W;
  const int qy = y_lo + ly, qx = x_lo + lx;  // this thread's target
  const bool edge = border && (qx == 0 || qx == w - 1 || qy == 0 || qy == h - 1);
  const int cell_t = (ly + 2) * CELLS_W + lx + 2;  // the cell whose tap 0 is the target
  const float2* crd = reinterpret_cast<const float2*>(coords) + (size_t)b * per_image;
  const float* g = grad_out + (size_t)b * per_image * c;

  // a bin's slots past its fill hold anything, and are not used
  const int n_records = fill[tile];
  const int2 rec = records[(size_t)tile * BIN_RECORDS + tid];
  const bool walk = n_records > BIN_RECORDS;
  int n_slots = 0;
  if (!walk && n_records <= 32) {
    // warp 0 sorts the records by warp (no two records of a bin share one),
    // a record a lane, and finds their first slots
    if (warp == 0) {
      int key = lane < n_records ? rec.x : INT_MAX;
      unsigned lanes = lane < n_records ? (unsigned)rec.y : 0u;
#pragma unroll
      for (int size = 2; size <= 32; size <<= 1)
#pragma unroll
        for (int stride = size >> 1; stride > 0; stride >>= 1) {
          const int other = __shfl_xor_sync(0xffffffffu, key, stride);
          const unsigned other_lanes = __shfl_xor_sync(0xffffffffu, lanes, stride);
          const bool low = (lane & stride) == 0, ascending = (lane & size) == 0;
          if (low == ascending ? other < key : other > key) {
            key = other;
            lanes = other_lanes;
          }
        }
      const int n = __popc(lanes);
      int upto = n;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, upto, d);
        if (lane >= d) upto += y;
      }
      s_warp[lane] = key;
      s_lanes[lane] = lanes;
      s_first[lane] = upto - n;
      if (lane == 31) s_scan[0] = upto;
    }
    __syncthreads();
    n_slots = s_scan[0];
  } else if (!walk) {
    // each record at its rank by warp
    if (tid < n_records) s_first[tid] = rec.x;
    __syncthreads();
    if (tid < n_records) {
      int rank = 0;
      for (int u = 0; u < n_records; ++u) rank += s_first[u] < rec.x;
      s_warp[rank] = rec.x;
      s_lanes[rank] = (unsigned)rec.y;
    }
    __syncthreads();
    const int first =
        block_scan<T>(tid < n_records ? __popc(s_lanes[tid]) : 0, &n_slots, s_scan);
    if (tid < n_records) s_first[tid] = first;
    __syncthreads();
  }
  const int rounds = ((walk ? per_image : n_slots) + ROUND - 1) / ROUND;

  for (int c0 = 0; c0 < c; c0 += CG) {
    float acc[CG];
#pragma unroll
    for (int ch = 0; ch < CG; ++ch) acc[ch] = 0.f;
    // (the first round's atomics come after a barrier)
    s_n[0][tid] = s_n[0][tid + T] = 0;
    for (int round = 0; round < rounds; ++round) {
      const int s0 = round * ROUND;
      int* count = s_n[round & 1];
      // the next round's counts (the last round's were read before its end)
      s_n[(round + 1) & 1][tid] = s_n[(round + 1) & 1][tid + T] = 0;
      int n_round;
      if (walk) {
        // pixels s0 + 2 tid and s0 + 2 tid + 1, kept where a tap lands on the tile
        int p[2];
        bool has[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          p[j] = s0 + 2 * tid + j;
          has[j] = false;
          if (p[j] < per_image) {
            const float2 xy = __ldg(crd + p[j]);
            const Taps t = make_taps(xy.x, xy.y, h, w, border);
#pragma unroll
            for (int k = 0; k < 4; ++k) has[j] |= tap_in_tile(t, k, y_lo, x_lo);
          }
        }
        const int at = block_scan<T>((int)has[0] + (int)has[1], &n_round, s_scan);
        if (n_round == 0) continue;  // the same in every thread
        if (has[0]) s_slot[at] = p[0];
        if (has[1]) s_slot[at + (int)has[0]] = p[1];
      } else {
        // a warp a record: its lanes that fall in this round
        n_round = min(ROUND, n_slots - s0);
        for (int r = warp; r < n_records; r += T / 32) {
          const int first = s_first[r] - s0;
          const unsigned m = s_lanes[r];
          if (first >= ROUND || first + __popc(m) <= 0) continue;
          const int s = first + __popc(m & ((1u << lane) - 1u));
          if (((m >> lane) & 1u) && s >= 0 && s < ROUND)
            s_slot[s] = s_warp[r] * 32 + lane - b * per_image;
        }
      }
      __syncthreads();
      // each slot's cell, weights and cotangent, and its arrival in its cell;
      // a cell's first CELL_SLOTS slots are kept in place
      int cell[2], pos[2];
      bool crowded = false;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int s = tid + j * T;
        cell[j] = -1;
        if (s < n_round) {
          const int p = s_slot[s];
          const float2 xy = __ldg(crd + p);
          const Taps t = make_taps(xy.x, xy.y, h, w, border);
          cell[j] = (t.y0 - y_lo + 2) * CELLS_W + (t.x0 - x_lo + 2);
          s_cell[s] = (unsigned short)cell[j];
          s_wx[s] = t.wx;
          s_wy[s] = t.wy;
          const float* gp = g + (size_t)p * c + c0;
#pragma unroll
          for (int ch = 0; ch < CG; ++ch)
            s_g[s * CG + ch] = (C > 0 || c0 + ch < c) ? __ldg(gp + ch) : 0.f;
          pos[j] = atomicAdd(count + cell[j], 1);
          if (pos[j] < CELL_SLOTS) s_few[cell[j] * CELL_SLOTS + pos[j]] = (unsigned short)s;
          else crowded = true;
        }
      }
      // each cell's slots in slot order: in place, or (a crowded round) all
      // listed in s_list, a short list sorted by its cell's thread and a long
      // one's slots each finding their rank
      const bool listed_all = __syncthreads_or(crowded);
      const int n_a = count[2 * tid], n_b = count[2 * tid + 1];
      int at = 0;
      unsigned short* lists = s_few;
      if (listed_all) {
        lists = s_list;
        int n_listed;
        at = block_scan<T>(n_a + n_b, &n_listed, s_scan);
        s_at[2 * tid] = at;
        s_at[2 * tid + 1] = at + n_a;
        __syncthreads();
#pragma unroll
        for (int j = 0; j < 2; ++j)
          if (cell[j] >= 0) s_list[s_at[cell[j]] + pos[j]] = (unsigned short)(tid + j * T);
        __syncthreads();
      }
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int n = m ? n_b : n_a;
        const int lo = listed_all ? at + (m ? n_a : 0) : (2 * tid + m) * CELL_SLOTS;
        if (n <= SHORT_LIST) {
          for (int u = lo + 1; u < lo + n; ++u) {
            const unsigned short v = lists[u];
            int x = u;
            for (; x > lo && lists[x - 1] > v; --x) lists[x] = lists[x - 1];
            lists[x] = v;
          }
        }
      }
      if (listed_all) {
        int dest[2];
        bool any_long = false;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          dest[j] = -1;
          if (cell[j] >= 0 && count[cell[j]] > SHORT_LIST) {
            const int lo = s_at[cell[j]], hi = lo + count[cell[j]];
            const int s = tid + j * T;
            int rank = 0;
            for (int u = lo; u < hi; ++u) rank += s_list[u] < s;
            dest[j] = lo + rank;
            any_long = true;
          }
        }
        if (__syncthreads_or(any_long)) {
#pragma unroll
          for (int j = 0; j < 2; ++j)
            if (dest[j] >= 0) s_list[dest[j]] = (unsigned short)(tid + j * T);
        }
      }
      __syncthreads();
      auto first_of = [&](int cl) { return listed_all ? s_at[cl] : cl * CELL_SLOTS; };
      if (!edge) {
        // the lists of cells t, t - (0,1), t - (1,0), t - (1,1), whose slots
        // land on t with taps 0, 1, 2, 3: entries 4 slot + k in increasing
        // order, from a sorting network where each list holds at most two,
        // else merged
        int hd[4], end[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int cl = cell_t - (k >> 1) * CELLS_W - (k & 1);
          hd[k] = first_of(cl);
          end[k] = hd[k] + count[cl];
        }
        if (end[0] - hd[0] <= 2 && end[1] - hd[1] <= 2 && end[2] - hd[2] <= 2 &&
            end[3] - hd[3] <= 2) {
          int e[8];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            e[2 * k] = hd[k] < end[k] ? 4 * lists[hd[k]] + k : INT_MAX;
            e[2 * k + 1] = hd[k] + 1 < end[k] ? 4 * lists[hd[k] + 1] + k : INT_MAX;
          }
          sort8(e);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            if (e[i] == INT_MAX) break;
            const int slot = e[i] >> 2;
            const float weight = tap_weight(s_wx[slot], s_wy[slot], e[i] & 3);
#pragma unroll
            for (int ch = 0; ch < CG; ++ch)
              acc[ch] = fmaf(s_g[slot * CG + ch], weight, acc[ch]);
          }
        } else {
          int head[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) head[k] = hd[k] < end[k] ? lists[hd[k]] : ROUND;
          for (;;) {
            int slot = head[0], k = 0;
#pragma unroll
            for (int i = 1; i < 4; ++i)
              if (head[i] < slot) {
                slot = head[i];
                k = i;
              }
            if (slot == ROUND) break;
#pragma unroll
            for (int i = 0; i < 4; ++i)
              if (i == k) {
                ++hd[i];
                head[i] = hd[i] < end[i] ? lists[hd[i]] : ROUND;
              }
            const float weight = tap_weight(s_wx[slot], s_wy[slot], k);
#pragma unroll
            for (int ch = 0; ch < CG; ++ch)
              acc[ch] = fmaf(s_g[slot * CG + ch], weight, acc[ch]);
          }
        }
      } else {
        // the cells whose clamped taps can reach the target (at most 4 x 4):
        // their lists merged by slot, each slot's taps tested against it
        const int cx_lo = (qx == 0 ? -2 : qx - 1) - x_lo + 2;
        const int cx_hi = (qx == w - 1 ? w : qx) - x_lo + 2;
        const int cy_lo = (qy == 0 ? -2 : qy - 1) - y_lo + 2;
        const int cy_hi = (qy == h - 1 ? h : qy) - y_lo + 2;
        int cur[16], stop[16], n_lists = 0;
        for (int cy = cy_lo; cy <= cy_hi; ++cy)
          for (int cx = cx_lo; cx <= cx_hi; ++cx) {
            const int cl = cy * CELLS_W + cx;
            if (count[cl] > 0) {
              cur[n_lists] = first_of(cl);
              stop[n_lists] = cur[n_lists] + count[cl];
              ++n_lists;
            }
          }
        for (;;) {
          int slot = ROUND, from = -1;
          for (int i = 0; i < n_lists; ++i)
            if (cur[i] < stop[i] && lists[cur[i]] < slot) {
              slot = lists[cur[i]];
              from = i;
            }
          if (from < 0) break;
          ++cur[from];
          const int cl = s_cell[slot];
          const int ay = y_lo - 2 + cl / CELLS_W, ax = x_lo - 2 + cl % CELLS_W;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if (clampi(ay + (k >> 1), 0, h - 1) == qy && clampi(ax + (k & 1), 0, w - 1) == qx) {
              const float weight = tap_weight(s_wx[slot], s_wy[slot], k);
#pragma unroll
              for (int ch = 0; ch < CG; ++ch)
                acc[ch] = fmaf(s_g[slot * CG + ch], weight, acc[ch]);
            }
          }
        }
      }
      // the next round (or pass) writes what this one read
      if (round + 1 < rounds || c0 + CG < c) __syncthreads();
    }
    if (qy < h && qx < w) {
      TO* o = d_image + ((size_t)b * h * w + (size_t)qy * w + qx) * c + c0;
#pragma unroll
      for (int ch = 0; ch < CG; ++ch)
        if (C > 0 || c0 + ch < c) o[ch] = to_out<TO>(acc[ch]);
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

long long tiles_of(int b, int h, int w) {
  return (long long)b * ((h + TILE_H - 1) / TILE_H) * ((w + TILE_W - 1) / TILE_W);
}

// An output pixel's index and a tile's are ints.
bool bad_image_grad(int b, int h, int w, int c, int ho, int wo, int padding) {
  return bad_shape(b, h, w, c, ho, wo) || (padding != 0 && padding != 1) ||
         (long long)b * ho * wo > INT_MAX || tiles_of(b, h, w) > INT_MAX;
}

template <typename TO>
int launch_image_grad(const float* coords, const float* grad_out, int* fill,
                      int2* records, TO* d_image, int b, int h, int w, int c, int ho,
                      int wo, int padding, void* stream) {
  if (bad_image_grad(b, h, w, c, ho, wo, padding)) return (int)cudaErrorInvalidValue;
  const long long n = (long long)b * ho * wo;
  const int n_tiles = (int)tiles_of(b, h, w);
  if (n_tiles == 0) return 0;
  const int tiles_x = (w + TILE_W - 1) / TILE_W, tiles_img = n_tiles / b;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(fill, 0, sizeof(int) * (size_t)n_tiles, st);
  if (err != cudaSuccess) return (int)err;
  if (n > 0) {
    image_grad_place_kernel<<<(unsigned)blocks_for(n), THREADS, 0, st>>>(
        coords, fill, records, n, ho * wo, h, w, padding, tiles_x, tiles_img);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int per_image = ho * wo;
  if (c == 3)
    image_grad_sum_kernel<TO, 3><<<n_tiles, TILE_THREADS, 0, st>>>(
        coords, grad_out, fill, records, d_image, per_image, h, w, c, padding, tiles_x, tiles_img);
  else if (c == 1)
    image_grad_sum_kernel<TO, 1><<<n_tiles, TILE_THREADS, 0, st>>>(
        coords, grad_out, fill, records, d_image, per_image, h, w, c, padding, tiles_x, tiles_img);
  else
    image_grad_sum_kernel<TO, 0><<<n_tiles, TILE_THREADS, 0, st>>>(
        coords, grad_out, fill, records, d_image, per_image, h, w, c, padding, tiles_x, tiles_img);
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

// d image of an image [b, h, w, c]: the launcher zeroes fill, then places
// and sums. Scratch: fill [b tiles_y tiles_x] and records [b tiles_y tiles_x
// BIN_RECORDS] int2 (tiles_y = ceil(h / TILE_H), tiles_x = ceil(w / TILE_W)),
// int32, any contents. d_image is float32, or bfloat16 for
// warp_bwd_image_bf16; every element of it is written.
extern "C" int warp_bwd_image(const float* coords, const float* grad_out, int* fill,
                              int* records, float* d_image, int b, int h, int w, int c,
                              int ho, int wo, int padding, void* stream) {
  return launch_image_grad(coords, grad_out, fill, reinterpret_cast<int2*>(records), d_image,
                           b, h, w, c, ho, wo, padding, stream);
}

extern "C" int warp_bwd_image_bf16(const float* coords, const float* grad_out, int* fill,
                                   int* records, void* d_image, int b, int h, int w, int c,
                                   int ho, int wo, int padding, void* stream) {
  return launch_image_grad(coords, grad_out, fill, reinterpret_cast<int2*>(records),
                           static_cast<__nv_bfloat16*>(d_image), b, h, w, c, ho, wo,
                           padding, stream);
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
