// Weight and bias gradient of the packed 3D convolution of the unpack
// layers (and the two-step pack), ops/fold_conv.channel_conv3d, for Hopper
// (sm_90a).
//
// Replaces: no TPU kernel. The JAX package leaves this gradient to XLA's
// autodiff of its conv3d. On the card cuDNN computes it, and in float32
// (TF32 off, as the float32 recipes state) it picks a grouped direct
// weight-gradient kernel that held 224 of the ~396 ms of device time of a
// PackNet-SAN train step. Its work is small: this kernel takes its place.
//
// What it computes. The convolution is F.conv3d over x [B, 1, Cp, Hin, W]
// with d output channels, a 3x3x3 kernel and padding (1, ph, 1): ph = 1 for
// the whole image (H = Hin), ph = 0 for a band of rows that arrives with its
// halo rows attached (H = Hin - 2). For dy [B, d, Cp, H, W],
//   dW[j, kz, kh, kx] = sum_{b,c,h,w} dy[b, j, c, h, w] x[b, c+kz-1, h+kh-ph, w+kx-1],
//   db[j]             = sum_{b,c,h,w} dy[b, j, c, h, w],
// with x zero outside the input: 28 sums of products a j over every voxel.
//
// What bounds it on an H100. Bytes: x and dy read once each, (1 + d) values
// a voxel; 282 MB a SAN step in float32 over its 11 calls, 0.085 ms at
// 3.35 TB/s. The arithmetic is 27 d fused multiply-adds a voxel: 5.4 a byte
// in float32 at d = 4, under the card's ~10 FP32 FMAs a byte, so float32 at
// d = 4 is bound by bytes; bfloat16 at d = 8 (12 FMAs a byte) by the FP32
// units. It accumulates in float32 on the CUDA cores: no TF32, no tensor
// cores, in either element type.
//
// Design. A block of 32 x 4 threads takes work items: a tile of one
// sample's output voxels, TILE_C channels by TILE_H rows by TILE_W columns,
// for JB of the d output channels (JB = 2, or 1 for an odd d).
// - The block stages the tile's x with its halo, (TILE_C + 2) x
//   (TILE_H + 2) x (TILE_W + 2) values widened to float32, in shared memory;
//   zeros stand for the padding.
// - A thread owns one (h, w) of the tile and walks its TILE_C channels. The
//   register blocking is along the channel (depth) axis: the thread keeps
//   the 3 x 3 neighbourhoods of planes c-1, c and c+1 in 27 registers, so a
//   step reads one new plane's 9 values from shared memory and each x value
//   read serves the three kz taps of three steps. Blocking along w instead
//   (a thread a strip of RW columns) rereads (RW + 2) / RW times as many
//   values a voxel and breaks the warp's one 128-byte line of dy a load.
// - dy is read once, straight from device memory into registers, a warp's
//   32 threads on 32 neighbouring w (coalesced), AHEAD steps before its use.
// - The thread accumulates 28 JB sums (27 taps and the bias of JB output
//   channels) in registers over every item the block takes: blocks stride
//   over the items, so the reduction below is paid once a block, not once
//   an item. The wrapper launches no more blocks than the card holds at
//   once (BLOCKS_PER_SM on each SM), so all of them run in one wave.
// - At the end the block sums its threads' partials (a fixed butterfly of
//   warp shuffles, then its 4 warps in order) and writes 28 JB floats to the
//   scratch that the wrapper allocates. A second kernel sums each output's
//   partials over the blocks in a fixed order (a warp an output) and writes
//   dW [d, 1, 3, 3, 3] and db [d] in the element type: under bfloat16 the
//   float32 sum is rounded once.
// No float atomics: a call gives the same bits every time. The number of
// blocks follows from the shape alone (the wrapper's plan), never from the
// card, so the order of the sums does too.
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md): ~0.05 ms at
// SAN's largest call (x [1, 1, 32, 176, 608], d = 4, float32), 2.4 times
// its bytes bound; JB = 4 took 234-255 registers, 2 blocks an SM, and was
// 1.5 times slower there; loading dy 2, 4 or 8 steps ahead read the same.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TILE_W = 32, TILE_H = 4, TILE_C = 16;
constexpr int THREADS = TILE_W * TILE_H;
constexpr int BLOCKS_PER_SM = 4;  // at most 128 registers a thread
constexpr int SW = TILE_W + 2, SH = TILE_H + 2, PLANE = SW * SH;
constexpr int TILE_VALUES = (TILE_C + 2) * PLANE;
constexpr int SUMS = 28;  // 27 taps and the bias
constexpr int AHEAD = 2;  // steps of dy loaded ahead of their use
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

struct Shape {
  int b, cp, hin, h, w, ph, d;
  int tiles_w, tiles_h, chunks, items;
};

// Accumulate one step of a thread's walk, the output channel whose taps
// read the planes a (c-1), m (c) and n (c+1), at dy values g.
template <int JB>
__device__ __forceinline__ void accumulate(float (&acc)[JB][SUMS], const float (&a)[9],
                                           const float (&m)[9], const float (&n)[9],
                                           const float (&g)[JB]) {
#pragma unroll
  for (int jj = 0; jj < JB; ++jj) {
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      acc[jj][k] = fmaf(g[jj], a[k], acc[jj][k]);
      acc[jj][9 + k] = fmaf(g[jj], m[k], acc[jj][9 + k]);
      acc[jj][18 + k] = fmaf(g[jj], n[k], acc[jj][18 + k]);
    }
    acc[jj][27] += g[jj];
  }
}

// The 3 x 3 neighbourhood of the thread's (h, w) in tile plane pz.
__device__ __forceinline__ void load_plane(float (&p)[9], const float* tap, int pz) {
#pragma unroll
  for (int kh = 0; kh < 3; ++kh)
#pragma unroll
    for (int kx = 0; kx < 3; ++kx) p[kh * 3 + kx] = tap[pz * PLANE + kh * SW + kx];
}

// A walk over a whole chunk of TILE_C channels, unrolled: dy of step
// i + AHEAD is loaded at step i.
template <typename T, int JB>
__device__ __forceinline__ void walk_chunk(float (&acc)[JB][SUMS], const float* tap,
                                           const T* g_at, long long hw, long long j_stride) {
  float p[3][9], g[TILE_C][JB];
  load_plane(p[0], tap, 0);
  load_plane(p[1], tap, 1);
#pragma unroll
  for (int i = 0; i < AHEAD; ++i)
#pragma unroll
    for (int jj = 0; jj < JB; ++jj) g[i][jj] = widen(g_at[jj * j_stride + i * hw]);
#pragma unroll
  for (int i = 0; i < TILE_C; ++i) {
    if (i + AHEAD < TILE_C)
#pragma unroll
      for (int jj = 0; jj < JB; ++jj)
        g[i + AHEAD][jj] = widen(g_at[jj * j_stride + (i + AHEAD) * hw]);
    load_plane(p[(i + 2) % 3], tap, i + 2);
    accumulate<JB>(acc, p[i % 3], p[(i + 1) % 3], p[(i + 2) % 3], g[i]);
  }
}

// A walk over the last, shorter chunk of a Cp that TILE_C does not divide.
template <typename T, int JB>
__device__ void walk_rest(float (&acc)[JB][SUMS], const float* tap, const T* g_at, long long hw,
                          long long j_stride, int cn) {
  float p[3][9], g[JB];
  load_plane(p[0], tap, 0);
  load_plane(p[1], tap, 1);
  for (int i = 0; i < cn; ++i) {
#pragma unroll
    for (int jj = 0; jj < JB; ++jj) g[jj] = widen(g_at[jj * j_stride + i * hw]);
    load_plane(p[2], tap, i + 2);
    accumulate<JB>(acc, p[0], p[1], p[2], g);
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      p[0][k] = p[1][k];
      p[1][k] = p[2][k];
    }
  }
}

template <typename T, int JB>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
channel_conv3d_wgrad_partials(const T* __restrict__ x, const T* __restrict__ dy,
                              float* __restrict__ partials, Shape s) {
  __shared__ float tile[TILE_VALUES];
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * TILE_W + tx;
  const int j0 = blockIdx.y * JB;
  const long long hw = (long long)s.h * s.w, hw_in = (long long)s.hin * s.w;
  const long long j_stride = (long long)s.cp * hw;
  // the two places of a tile plane (SH x SW) this thread stages, if any
  constexpr int PLACES = (PLANE + THREADS - 1) / THREADS;
  int place_y[PLACES], place_x[PLACES];
#pragma unroll
  for (int q = 0; q < PLACES; ++q) {
    const int v = tid + q * THREADS;
    place_y[q] = v < PLANE ? v / SW : -1;
    place_x[q] = v < PLANE ? v % SW : 0;
  }
  float acc[JB][SUMS];
#pragma unroll
  for (int jj = 0; jj < JB; ++jj)
#pragma unroll
    for (int k = 0; k < SUMS; ++k) acc[jj][k] = 0.f;

  for (int item = blockIdx.x; item < s.items; item += gridDim.x) {
    int rest = item;
    const int wt = rest % s.tiles_w;
    rest /= s.tiles_w;
    const int ht = rest % s.tiles_h;
    rest /= s.tiles_h;
    const int cc = rest % s.chunks;
    const int b = rest / s.chunks;
    const int c0 = cc * TILE_C, h0 = ht * TILE_H, w0 = wt * TILE_W;

    __syncthreads();  // the previous item's walk is done with the tile
    const T* xb = x + (long long)b * s.cp * hw_in;
#pragma unroll
    for (int q = 0; q < PLACES; ++q) {
      if (place_y[q] < 0) continue;
      const int hi = h0 - s.ph + place_y[q], wi = w0 - 1 + place_x[q];
      const bool inside = hi >= 0 && hi < s.hin && wi >= 0 && wi < s.w;
      const T* src = xb + (long long)hi * s.w + wi;
      float* dst = tile + place_y[q] * SW + place_x[q];
#pragma unroll
      for (int pz = 0; pz < TILE_C + 2; ++pz) {
        const int c = c0 - 1 + pz;
        dst[pz * PLANE] = inside && c >= 0 && c < s.cp ? widen(src[c * hw_in]) : 0.f;
      }
    }
    __syncthreads();

    const int h = h0 + ty, w = w0 + tx;
    if (h >= s.h || w >= s.w) continue;
    const T* g_at = dy + ((long long)b * s.d + j0) * j_stride + c0 * hw + (long long)h * s.w + w;
    const float* tap = tile + ty * SW + tx;
    if (c0 + TILE_C <= s.cp)
      walk_chunk<T, JB>(acc, tap, g_at, hw, j_stride);
    else
      walk_rest<T, JB>(acc, tap, g_at, hw, j_stride, s.cp - c0);
  }

  // the block's sums: each warp's by a butterfly, then the warps in order
#pragma unroll
  for (int jj = 0; jj < JB; ++jj)
#pragma unroll
    for (int k = 0; k < SUMS; ++k) {
      float v = acc[jj][k];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
      acc[jj][k] = v;
    }
  __syncthreads();  // the tile is free: it holds the warps' sums now
  if (tx == 0)
#pragma unroll
    for (int jj = 0; jj < JB; ++jj)
#pragma unroll
      for (int k = 0; k < SUMS; ++k) tile[(ty * JB + jj) * SUMS + k] = acc[jj][k];
  __syncthreads();
  float* out = partials + ((long long)blockIdx.y * gridDim.x + blockIdx.x) * (JB * SUMS);
  for (int v = tid; v < JB * SUMS; v += THREADS) {
    float sum = tile[v];
    for (int wp = 1; wp < TILE_H; ++wp) sum += tile[wp * JB * SUMS + v];
    out[v] = sum;
  }
}

// A warp an output (j, k): the blocks' partials of j's j-block summed lane
// by lane in block order, then by a butterfly; lane 0 writes.
template <typename T>
__global__ void channel_conv3d_wgrad_sum(const float* __restrict__ partials, T* __restrict__ dw,
                                         T* __restrict__ db, int d, int jb, int blocks) {
  const int o = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (o >= d * SUMS) return;
  const int j = o / SUMS, k = o % SUMS;
  const float* p = partials + (long long)(j / jb) * blocks * jb * SUMS + (j % jb) * SUMS + k;
  float sum = 0.f;
  for (int i = lane; i < blocks; i += 32) sum += p[(long long)i * jb * SUMS];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(FULL, sum, off);
  if (lane == 0) put(k < 27 ? dw + j * 27 + k : db + j, sum);
}

template <typename T, int JB>
cudaError_t launch_jb(const T* x, const T* dy, float* partials, const Shape& s, int blocks,
                      cudaStream_t stream) {
  channel_conv3d_wgrad_partials<T, JB>
      <<<dim3(blocks, s.d / JB), dim3(TILE_W, TILE_H), 0, stream>>>(x, dy, partials, s);
  return cudaGetLastError();
}

template <typename T>
int launch(const T* x, const T* dy, float* partials, T* dw, T* db, int b, int cp, int hin,
           int h, int w, int ph, int d, int jb, int blocks, void* stream_ptr) {
  if (b < 1 || cp < 1 || w < 1 || h < 1 || d < 1 || blocks < 1 || (ph != 0 && ph != 1) ||
      h != hin + 2 * ph - 2 || (jb != 1 && jb != 2) || d % jb != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t stream = (cudaStream_t)stream_ptr;
  Shape s{b, cp, hin, h, w, ph, d, (w + TILE_W - 1) / TILE_W, (h + TILE_H - 1) / TILE_H,
          (cp + TILE_C - 1) / TILE_C, 0};
  s.items = b * s.chunks * s.tiles_h * s.tiles_w;
  const cudaError_t err = jb == 2 ? launch_jb<T, 2>(x, dy, partials, s, blocks, stream)
                                  : launch_jb<T, 1>(x, dy, partials, s, blocks, stream);
  if (err != cudaSuccess) return (int)err;
  const int warps = 8;
  channel_conv3d_wgrad_sum<T><<<(d * SUMS + warps - 1) / warps, 32 * warps, 0, stream>>>(
      partials, dw, db, d, jb, blocks);
  return (int)cudaGetLastError();
}

}  // namespace

// x [b, 1, cp, hin, w] and dy [b, d, cp, h, w] (h = hin + 2 ph - 2), float32;
// partials: scratch of d * blocks * 28 floats, any contents; dw [d, 27] and
// db [d] are written whole. jb (1 or 2, dividing d) output channels a
// block; blocks a j-block, from the wrapper's plan.
extern "C" int channel_conv3d_wgrad(const float* x, const float* dy, float* partials, float* dw,
                                    float* db, int b, int cp, int hin, int h, int w, int ph, int d,
                                    int jb, int blocks, void* stream) {
  return launch(x, dy, partials, dw, db, b, cp, hin, h, w, ph, d, jb, blocks, stream);
}

// The same for bfloat16 x, dy, dw and db; the sums in float32, rounded once.
extern "C" int channel_conv3d_wgrad_bf16(const void* x, const void* dy, float* partials, void* dw,
                                         void* db, int b, int cp, int hin, int h, int w, int ph,
                                         int d, int jb, int blocks, void* stream) {
  return launch(static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(dy),
                partials, static_cast<__nv_bfloat16*>(dw), static_cast<__nv_bfloat16*>(db), b, cp,
                hin, h, w, ph, d, jb, blocks, stream);
}
