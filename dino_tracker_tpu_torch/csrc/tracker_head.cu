// Tracker head convs (K4): conv1 (1 -> 16, 3x3, zero pad 1) + bias + ReLU,
// then conv2 (16 -> 1, 3x3, zero pad 1) + bias, over B x H' x W' f32
// correlation maps. K4-fwd computes the logits; K4-bwd the input gradient and
// the five parameter gradients (conv1's and conv2's normalised weights and
// biases), recomputing the hidden map instead of reading a saved one.
//
// Replaces no TPU kernel: the JAX package leaves the two convs to XLA
// (dino_tracker_tpu/models/tracker_head.py, normalized_conv2d). It was added
// because cuDNN runs these 1-channel NHWC shapes far below their bound: it
// falls back to a grouped direct kernel and writes, then reads back, the
// 16-channel f32 hidden map (16x the map's bytes), and autograd saves it
// for the backward.
//
//   pre_c(q) = b1[c] + sum_o w1[c,o] x(q+o)          o in {-1,0,1}^2
//   h_c(q)   = relu(pre_c(q)),  h_c = 0 outside the map (conv2's zero pad)
//   y(p)     = b2 + sum_c sum_o w2[c,o] h_c(p+o)
//
// What bounds it on an H100: f32 FMAs. 288 FMAs a pixel forward and about
// 720 backward against 8 (forward) and 12 (backward) bytes a pixel of
// device memory: ~36 FLOP per byte forward, far above the card's 20
// (67e12 / 3.35e12). So the design keeps every intermediate on the SM and
// feeds the FMA pipes from registers:
//
// - A tile is a few rows by kTW columns of output pixels of one map. Both
//   kernels run a fixed number of persistent blocks (as many as fit on the
//   card at once), each walking the tiles b, b + gridDim.x, ... It reads a
//   tile's window of the
//   map (and, backward, of the output gradient) over the tile plus a
//   2-pixel ring into shared memory once, zeros outside the map, with
//   cp.async into one of two buffers while it computes on the other: the
//   next tile's window is in flight during this tile's work.
// - conv2 is rewritten as a gather of per-pixel sums: with
//   v_o(q) = sum_c w2[c,o] h_c(q) (9 numbers a pixel),
//   y(p) = b2 + sum_o v_o(p+o). A thread computes the 16 hidden values of
//   one pixel of the tile plus a 1-pixel ring in registers and keeps only
//   its 9 v_o in shared memory; the output pixel then adds 9 of them. The
//   16-channel hidden map never leaves the thread.
// - Backward, the same rewrite gives the input gradient: with
//   gp_c(q) = relu'(pre_c(q)) * sum_o w2[c,o] g_y(q-o) and
//   u_o(q) = sum_c w1[c,o] gp_c(q), g_x(r) = sum_o u_o(r-o). The parameter
//   gradients g_w1[c,o] = sum_q gp_c(q) x(q+o), g_b1[c] = sum_q gp_c(q),
//   g_w2[c,o] = sum_q h_c(q) g_y(q-o) and g_b2 = sum_q g_y(q) are sums over
//   the tile's own pixels: phase 1 leaves h and gp of those pixels in
//   shared memory, and phase 2 gives each thread one column of the tile and
//   four of the 16 channels, with 77 running sums in registers and a
//   3-row sliding window of x and g_y, so each FMA's operands come from
//   registers. The blocks walk the tiles in a fixed order, so the sums live
//   in registers across tiles and each block writes its 305 partial sums
//   once. A second small kernel adds
//   the blocks' partials in block order. No atomics: a replay gives the
//   same bits.
//
// Weights live in shared memory, one channel's 19 values in five 16-byte
// words, read uniformly by a warp (a broadcast). Plain f32 FMAs throughout:
// no TF32, no tensor cores.
//
// Plain C interface, bound with ctypes (dino_tracker_tpu_torch/ops/head_conv.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kC = 16;                         // hidden channels
constexpr int kTH = 8, kTW = 64;               // K4-bwd's tile: output rows and columns
constexpr int kRH = kTH + 2, kRW = kTW + 2;    // the tile plus a 1-pixel ring
constexpr int kXH = kTH + 4, kXW = kTW + 4;    // the tile plus a 2-pixel ring
constexpr int kRegion = kRH * kRW;
constexpr int kOwn = kTH * kTW;
constexpr int kThreads = 256;
// K4-fwd's tile: 9 rows, so its ring of 11 x 66 pixels nearly fills 3 a thread
constexpr int kFwdTH = 9, kFwdXH = kFwdTH + 4, kFwdRegion = (kFwdTH + 2) * kRW;
constexpr int kSlots = (kFwdRegion + kThreads - 1) / kThreads;  // K4-fwd: ring pixels a thread
constexpr int kNParams = 2 * kC * 9 + kC + 1;  // g_w1 (144), g_b1 (16), g_w2 (144), g_b2
constexpr int kHgStride = 2 * kC + 4;          // h[16], gp[16], 4 pad: 16-byte rows, no conflicts
constexpr int kGroups = 4, kCG = kC / kGroups; // phase 2: four channel groups of four
constexpr int kAccW2 = kCG * 9 + kCG;          // phase 2's running sums: g_w1 [j][k], g_b1 [j],
constexpr int kAccB2 = kAccW2 + kCG * 9;       //   g_w2 [j][k], g_b2
constexpr int kAcc = kAccB2 + 1;
constexpr int kBwdSmem = (kC * 5 * 4 + kOwn * kHgStride + 9 * kRegion + 4 * kXH * kXW) * 4;

static_assert(kThreads == kTW * kGroups, "phase 2: a thread per column and channel group");
static_assert(kThreads / 32 * kGroups * kAcc <= kOwn * kHgStride, "the block reduction fits in hg");

struct Tile {
  int64_t base;  // the map's first element
  int row0, col0;
};

__device__ __forceinline__ Tile tile_of(int64_t t, int th, int h, int w, int tiles_w,
                                        int tiles_per_map) {
  const int64_t map = t / tiles_per_map;
  const int k = (int)(t - map * tiles_per_map);
  return {map * h * w, (k / tiles_w) * th, (k % tiles_w) * kTW};
}

__device__ __forceinline__ bool inside(int r, int c, int h, int w) {
  return r >= 0 && r < h && c >= 0 && c < w;
}

// torch.relu: a NaN stays NaN
__device__ __forceinline__ float relu(float v) {
  float r;
  asm("max.NaN.f32 %0, %1, 0f00000000;" : "=f"(r) : "f"(v));
  return r;
}

// wp[c] = {w1[c][0..8], w2[c][0..8], b1[c], 0}: one channel in five 16-byte words
__device__ void load_weights(float4 (*wp)[5], const float* __restrict__ w1,
                             const float* __restrict__ b1, const float* __restrict__ w2) {
  float* f = reinterpret_cast<float*>(wp);
  for (int i = threadIdx.x; i < kC * 20; i += blockDim.x) {
    const int c = i / 20, k = i % 20;
    f[i] = k < 9 ? w1[c * 9 + k] : k < 18 ? w2[c * 9 + k - 9] : k == 18 ? b1[c] : 0.f;
  }
}

__device__ __forceinline__ void channel(const float4 (*wp)[5], int c, float (&a)[9],
                                        float (&b)[9], float& bias) {
  const float4 q0 = wp[c][0], q1 = wp[c][1], q2 = wp[c][2], q3 = wp[c][3], q4 = wp[c][4];
  a[0] = q0.x; a[1] = q0.y; a[2] = q0.z; a[3] = q0.w;
  a[4] = q1.x; a[5] = q1.y; a[6] = q1.z; a[7] = q1.w; a[8] = q2.x;
  b[0] = q2.y; b[1] = q2.z; b[2] = q2.w; b[3] = q3.x;
  b[4] = q3.y; b[5] = q3.z; b[6] = q3.w; b[7] = q4.x; b[8] = q4.y;
  bias = q4.z;
}

// Starts copying dst[r][c] = src at map row row0 - 2 + r, column
// col0 - 2 + c (cp.async, zero-filled outside the map; src is the map's
// first element). copy_wait() then __syncthreads() make them visible to
// the block.
template <int kRows>
__device__ void load_window(float (*dst)[kXW], const float* __restrict__ src, int h, int w,
                            int row0, int col0) {
  for (int i = threadIdx.x; i < kRows * kXW; i += blockDim.x) {
    const int r = i / kXW, c = i % kXW;
    const int gr = row0 - 2 + r, gc = col0 - 2 + c;
    const bool in = inside(gr, gc, h, w);
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(&dst[r][c]));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(in ? src + (int64_t)gr * w + gc : src), "r"(in ? 4 : 0));
  }
}

__device__ __forceinline__ void copy_wait() { asm volatile("cp.async.wait_all;\n" ::); }

// K4-fwd: persistent blocks over the tiles. Region pixel i = (r, c) is map pixel
// (row0 - 1 + r, col0 - 1 + c); its tap (ky, kx) reads xs[r + ky][c + kx].
// A thread takes kSlots region pixels at once, so each channel's weights,
// read once from shared memory, feed kSlots pixels' FMAs; the channel loop
// stays rolled, so the weights of one channel at a time live in registers.
__global__ void __launch_bounds__(kThreads, 3)
head_conv_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                     const float* __restrict__ b1, const float* __restrict__ w2,
                     const float* __restrict__ b2, float* __restrict__ y, int64_t n_tiles,
                     int h, int w, int tiles_w, int tiles_per_map) {
  __shared__ float4 wp[kC][5];
  __shared__ float window[2][kFwdXH][kXW];
  __shared__ float vs[9][kFwdRegion];
  load_weights(wp, w1, b1, w2);
  const float bias2 = b2[0];
  Tile t = tile_of(blockIdx.x, kFwdTH, h, w, tiles_w, tiles_per_map);
  load_window<kFwdXH>(window[0], x + t.base, h, w, t.row0, t.col0);
  for (int64_t ti = blockIdx.x, it = 0; ti < n_tiles; ti += gridDim.x, ++it) {
    copy_wait();
    __syncthreads();  // this tile's window is in; the last tile is done with vs, the other buffer
    const bool more = ti + gridDim.x < n_tiles;
    const Tile next = tile_of(more ? ti + gridDim.x : ti, kFwdTH, h, w, tiles_w, tiles_per_map);
    if (more) load_window<kFwdXH>(window[(it + 1) & 1], x + next.base, h, w, next.row0, next.col0);
    float (*xs)[kXW] = window[it & 1];
    float xn[kSlots][9], v[kSlots][9];
    bool in_map[kSlots];
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int i = threadIdx.x + s * kThreads;
      const int r = i < kFwdRegion ? i / kRW : 0, c = i < kFwdRegion ? i % kRW : 0;
      in_map[s] = i < kFwdRegion && inside(t.row0 - 1 + r, t.col0 - 1 + c, h, w);
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        xn[s][k] = xs[r + k / 3][c + k % 3];
        v[s][k] = 0.f;
      }
    }
#pragma unroll 1
    for (int ch = 0; ch < kC; ++ch) {
      float a[9], b[9], bias;
      channel(wp, ch, a, b, bias);
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        float pre = bias;
#pragma unroll
        for (int k = 0; k < 9; ++k) pre = fmaf(a[k], xn[s][k], pre);
        const float hv = relu(pre);
#pragma unroll
        for (int k = 0; k < 9; ++k) v[s][k] = fmaf(b[k], hv, v[s][k]);
      }
    }
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int i = threadIdx.x + s * kThreads;
      if (i < kFwdRegion) {
#pragma unroll
        for (int k = 0; k < 9; ++k) vs[k][i] = in_map[s] ? v[s][k] : 0.f;  // h = 0 off the map
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kFwdTH * kTW; i += kThreads) {
      const int r = i / kTW, c = i % kTW;
      const int gr = t.row0 + r, gc = t.col0 + c;
      if (gr >= h || gc >= w) continue;
      // output (r, c) is region (r + 1, c + 1); its tap (ky, kx) is region (r + ky, c + kx)
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < 9; ++k) acc += vs[k][(r + k / 3) * kRW + c + k % 3];
      y[t.base + (int64_t)gr * w + gc] = acc + bias2;
    }
    t = next;
  }
}

// K4-bwd: gridDim.x persistent blocks; block b takes tiles b, b + gridDim.x, ...
// and writes its 305 partial sums to partials[b].
__global__ void __launch_bounds__(kThreads, 2)
head_conv_bwd_kernel(const float* __restrict__ x, const float* __restrict__ gy,
                     const float* __restrict__ w1, const float* __restrict__ b1,
                     const float* __restrict__ w2, float* __restrict__ gx,
                     float* __restrict__ partials, int64_t n_tiles, int h, int w, int tiles_w,
                     int tiles_per_map) {
  extern __shared__ float4 smem[];
  float4 (*wp)[5] = reinterpret_cast<float4 (*)[5]>(smem);
  float* hg = reinterpret_cast<float*>(smem + kC * 5);  // own pixel i: hg[i * kHgStride ...]
  float (*us)[kRegion] = reinterpret_cast<float (*)[kRegion]>(hg + kOwn * kHgStride);
  float (*windows)[kXW] = reinterpret_cast<float (*)[kXW]>(us + 9);  // x, g_y; x, g_y

  load_weights(wp, w1, b1, w2);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = lane >> 3;                  // phase 2: channels grp * 4 .. grp * 4 + 3
  const int col = warp * 8 + (lane & 7);      // phase 2: the tile's column
  float acc[kAcc];
#pragma unroll
  for (int a = 0; a < kAcc; ++a) acc[a] = 0.f;

  Tile t = tile_of(blockIdx.x, kTH, h, w, tiles_w, tiles_per_map);
  load_window<kXH>(windows, x + t.base, h, w, t.row0, t.col0);
  load_window<kXH>(windows + kXH, gy + t.base, h, w, t.row0, t.col0);
  for (int64_t ti = blockIdx.x, it = 0; ti < n_tiles; ti += gridDim.x, ++it) {
    copy_wait();
    __syncthreads();  // this tile's windows are in; the last tile is done with the rest
    const bool more = ti + gridDim.x < n_tiles;
    const Tile next = tile_of(more ? ti + gridDim.x : ti, kTH, h, w, tiles_w, tiles_per_map);
    float (*xs)[kXW] = windows + (it & 1) * 2 * kXH;
    float (*gys)[kXW] = xs + kXH;
    if (more) {
      float (*nx)[kXW] = windows + ((it + 1) & 1) * 2 * kXH;
      load_window<kXH>(nx, x + next.base, h, w, next.row0, next.col0);
      load_window<kXH>(nx + kXH, gy + next.base, h, w, next.row0, next.col0);
    }

    // Phase 1: region pixel q = (r, c): u_o(q) for the input gradient, and
    // h, gp of the tile's own pixels for phase 2. x(q+o) at tap (ky, kx) is
    // xs[r + ky][c + kx]; g_y(q-o) is gys[r + 2 - ky][c + 2 - kx].
#pragma unroll 1
    for (int i = threadIdx.x; i < kRegion; i += kThreads) {
      const int r = i / kRW, c = i % kRW;
      const bool own = r >= 1 && r <= kTH && c >= 1 && c <= kTW;
      float* hrow = hg + (own ? ((r - 1) * kTW + (c - 1)) * kHgStride : 0);
      float u[9];
#pragma unroll
      for (int k = 0; k < 9; ++k) u[k] = 0.f;
      if (inside(t.row0 - 1 + r, t.col0 - 1 + c, h, w)) {
        float xn[9], gn[9];
#pragma unroll
        for (int k = 0; k < 9; ++k) {
          xn[k] = xs[r + k / 3][c + k % 3];
          gn[k] = gys[r + 2 - k / 3][c + 2 - k % 3];
        }
#pragma unroll 1
        for (int cg = 0; cg < kGroups; ++cg) {
          float hv[kCG], gp[kCG];
#pragma unroll
          for (int j = 0; j < kCG; ++j) {
            float a[9], b[9], bias;
            channel(wp, cg * kCG + j, a, b, bias);
            float pre = bias, gh = 0.f;
#pragma unroll
            for (int k = 0; k < 9; ++k) {
              pre = fmaf(a[k], xn[k], pre);
              gh = fmaf(b[k], gn[k], gh);
            }
            hv[j] = relu(pre);
            gp[j] = pre > 0.f ? gh : 0.f;
#pragma unroll
            for (int k = 0; k < 9; ++k) u[k] = fmaf(a[k], gp[j], u[k]);
          }
          if (own) {
            *reinterpret_cast<float4*>(hrow + cg * kCG) = make_float4(hv[0], hv[1], hv[2], hv[3]);
            *reinterpret_cast<float4*>(hrow + kC + cg * kCG) =
                make_float4(gp[0], gp[1], gp[2], gp[3]);
          }
        }
      } else if (own) {  // outside the map: nothing to add in phase 2
        const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int k = 0; k < 2 * kC; k += 4) *reinterpret_cast<float4*>(hrow + k) = z;
      }
#pragma unroll
      for (int k = 0; k < 9; ++k) us[k][i] = u[k];
    }
    __syncthreads();

    // g_x(p) = sum_o u_o(p - o): own pixel (r, c) is region (r + 1, c + 1),
    // so its tap (ky, kx) reads region (r + 2 - ky, c + 2 - kx).
    for (int i = threadIdx.x; i < kOwn; i += kThreads) {
      const int r = i / kTW, c = i % kTW;
      const int gr = t.row0 + r, gc = t.col0 + c;
      if (gr >= h || gc >= w) continue;
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < 9; ++k) s += us[k][(r + 2 - k / 3) * kRW + c + 2 - k % 3];
      gx[t.base + (int64_t)gr * w + gc] = s;
    }

    // Phase 2: this thread's column, rows 0..kTH-1, channels grp*4..grp*4+3.
    // Own pixel (j, col) is xs[j + 2][col + 2]; x(q+o) at tap (ky, kx) is
    // xs[j + 1 + ky][col + 1 + kx] = xw[ky][kx], and g_y(q-o) is
    // gys[j + 3 - ky][col + 3 - kx] = gw[2 - ky][2 - kx], where xw and gw
    // hold rows j+1..j+3, columns col+1..col+3 (a window sliding down).
    float xw[3][3], gw[3][3];
#pragma unroll
    for (int m = 0; m < 2; ++m) {
#pragma unroll
      for (int n = 0; n < 3; ++n) {
        xw[m + 1][n] = xs[1 + m][col + 1 + n];
        gw[m + 1][n] = gys[1 + m][col + 1 + n];
      }
    }
#pragma unroll
    for (int j = 0; j < kTH; ++j) {
#pragma unroll
      for (int n = 0; n < 3; ++n) {
        xw[0][n] = xw[1][n]; xw[1][n] = xw[2][n]; xw[2][n] = xs[j + 3][col + 1 + n];
        gw[0][n] = gw[1][n]; gw[1][n] = gw[2][n]; gw[2][n] = gys[j + 3][col + 1 + n];
      }
      const float* row = hg + (j * kTW + col) * kHgStride + grp * kCG;
      const float4 h4 = *reinterpret_cast<const float4*>(row);
      const float4 g4 = *reinterpret_cast<const float4*>(row + kC);
      const float hv[kCG] = {h4.x, h4.y, h4.z, h4.w};
      const float gp[kCG] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
      for (int jj = 0; jj < kCG; ++jj) {
#pragma unroll
        for (int k = 0; k < 9; ++k) {
          acc[jj * 9 + k] = fmaf(gp[jj], xw[k / 3][k % 3], acc[jj * 9 + k]);
          acc[kAccW2 + jj * 9 + k] =
              fmaf(hv[jj], gw[2 - k / 3][2 - k % 3], acc[kAccW2 + jj * 9 + k]);
        }
        acc[kCG * 9 + jj] += gp[jj];
      }
      acc[kAccB2] += gw[1][1];
    }
    t = next;
  }

  // The block's sums: the 8 lanes of a channel group by a butterfly (each
  // lane ends with the same bits), then the 8 warps in warp order.
  __syncthreads();  // hg is free
#pragma unroll
  for (int a = 0; a < kAcc; ++a) {
    float v = acc[a];
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    v += __shfl_xor_sync(0xffffffffu, v, 4);
    acc[a] = v;
  }
  float* red = hg;  // red[warp][grp][a]
  if ((lane & 7) == 0) {
#pragma unroll
    for (int a = 0; a < kAcc; ++a) red[(warp * kGroups + grp) * kAcc + a] = acc[a];
  }
  __syncthreads();
  for (int p = threadIdx.x; p < kNParams; p += kThreads) {
    int g, a;
    if (p < kC * 9) {  // g_w1[c][k]
      g = p / 9 / kCG; a = (p / 9 % kCG) * 9 + p % 9;
    } else if (p < kC * 10) {  // g_b1[c]
      g = (p - kC * 9) / kCG; a = kCG * 9 + (p - kC * 9) % kCG;
    } else if (p < kNParams - 1) {  // g_w2[c][k]
      const int q = p - kC * 10;
      g = q / 9 / kCG; a = kAccW2 + (q / 9 % kCG) * 9 + q % 9;
    } else {  // g_b2: every group's threads saw the same pixels
      g = 0; a = kAccB2;
    }
    float s = 0.f;
    for (int wi = 0; wi < kThreads / 32; ++wi) s += red[(wi * kGroups + g) * kAcc + a];
    partials[(int64_t)blockIdx.x * kNParams + p] = s;
  }
}

// out[p] = the blocks' partials[.][p] added in block order
__global__ void head_conv_bwd_reduce_kernel(const float* __restrict__ partials, int n_blocks,
                                            float* __restrict__ out) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= kNParams) return;
  float s = 0.f;
  for (int i = 0; i < n_blocks; ++i) s += partials[(int64_t)i * kNParams + p];
  out[p] = s;
}

// A map of h x w in tiles of rows x kTW: tiles_w across, tiles_per_map in
// all, n over the b maps.
bool tiles(int rows, int64_t b, int64_t h, int64_t w, int* tiles_w, int* tiles_per_map,
           int64_t* n) {
  if (b < 1 || h < 1 || w < 1 || h * w >= (int64_t(1) << 31)) return false;
  const int64_t th = (h + rows - 1) / rows, tw = (w + kTW - 1) / kTW;
  if (th * tw >= (int64_t(1) << 31) || b * th * tw >= (int64_t(1) << 31)) return false;
  *tiles_w = (int)tw;
  *tiles_per_map = (int)(th * tw);
  *n = b * th * tw;
  return true;
}

}  // namespace

// On the current device: allow K4-bwd its shared memory and write the most
// blocks of K4-fwd and of K4-bwd that can be resident at once (blocks an
// SM x SMs) to *fwd and *bwd. Call once a device, before the first launch
// on it.
extern "C" int head_conv_max_blocks(int* fwd, int* bwd) {
  cudaError_t err = cudaFuncSetAttribute(
      head_conv_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBwdSmem);
  if (err != cudaSuccess) return (int)err;
  int dev, sms, per_sm_fwd, per_sm_bwd;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm_fwd, head_conv_fwd_kernel,
                                                           kThreads, 0)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm_bwd, head_conv_bwd_kernel,
                                                           kThreads, kBwdSmem)) != cudaSuccess)
    return (int)err;
  *fwd = per_sm_fwd * sms;
  *bwd = per_sm_bwd * sms;
  return *fwd > 0 && *bwd > 0 ? (int)cudaSuccess : (int)cudaErrorInvalidConfiguration;
}

// x and y are contiguous B x H x W f32 (B, H, W >= 1); w1 16x1x3x3, b1 16,
// w2 1x16x3x3, b2 1, all f32 and contiguous; max_blocks from
// head_conv_max_blocks. Returns cudaGetLastError(), or cudaErrorInvalidValue
// for shapes out of range.
extern "C" int head_conv_fwd(const void* x, const void* w1, const void* b1, const void* w2,
                             const void* b2, void* y, int64_t max_blocks, int64_t b, int64_t h,
                             int64_t w, void* stream) {
  int tiles_w, tiles_per_map;
  int64_t n;
  if (max_blocks < 1 || !tiles(kFwdTH, b, h, w, &tiles_w, &tiles_per_map, &n))
    return (int)cudaErrorInvalidValue;
  head_conv_fwd_kernel<<<(unsigned)(n < max_blocks ? n : max_blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w1), static_cast<const float*>(b1),
      static_cast<const float*>(w2), static_cast<const float*>(b2), static_cast<float*>(y), n,
      (int)h, (int)w, tiles_w, tiles_per_map);
  return (int)cudaGetLastError();
}

// x, gy and gx are contiguous B x H x W f32 (B, H, W >= 1); w1, b1, w2 as in
// head_conv_fwd; partials holds max_blocks x 305 f32 (scratch), params 305
// f32: g_w1 [16][9], g_b1 [16], g_w2 [16][9], g_b2. max_blocks comes from
// head_conv_max_blocks on this device; the same inputs give the same
// bits. Returns cudaGetLastError() after the two launches, or
// cudaErrorInvalidValue for shapes out of range.
extern "C" int head_conv_bwd(const void* x, const void* gy, const void* w1, const void* b1,
                             const void* w2, void* gx, void* partials, void* params,
                             int64_t max_blocks, int64_t b, int64_t h, int64_t w, void* stream) {
  int tiles_w, tiles_per_map;
  int64_t n;
  if (max_blocks < 1 || !tiles(kTH, b, h, w, &tiles_w, &tiles_per_map, &n))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (int)(n < max_blocks ? n : max_blocks);
  head_conv_bwd_kernel<<<blocks, kThreads, kBwdSmem, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(gy), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(w2), static_cast<float*>(gx),
      static_cast<float*>(partials), n, (int)h, (int)w, tiles_w, tiles_per_map);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  head_conv_bwd_reduce_kernel<<<(kNParams + 127) / 128, 128, 0, s>>>(
      static_cast<const float*>(partials), blocks, static_cast<float*>(params));
  return (int)cudaGetLastError();
}
