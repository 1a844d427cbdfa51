// RAFT correlation lookup (K3): one GRU iteration's whole lookup, the 9x9
// bilinear window of every source pixel's own correlation map at each of the
// four pyramid levels, written as the 4 * 81 = 324 channels of a B x 324 x h x w
// f32 tensor (the layout the motion encoder's 1x1 convc1 reads).
//
// Replaces the TPU kernel dino_tracker_tpu/ops/window_gather.py:37
// _window_gather_kernel (launched by window_gather :86, called from
// models/raft.py:254 _window_patches <- corr_lookup :288 <- raft_decode :568)
// together with the bilinear combine that the JAX package runs in XLA after it
// (raft.py:373-389). The TPU kernel copied one padded 10 x 10 patch per pixel
// and level to device memory and read it back for the combine; here the patch
// never leaves registers, and the pyramid is read unpadded.
//
// Semantics (those of the plain version, ops/window_gather.py
// corr_lookup_reference, and of torch grid_sample with zero padding):
// - Level l samples its map at (x / 2^l + dx, y / 2^l + dy), dx, dy in -4..4.
//   Channel l * 81 + i * 9 + j takes dx = i - 4, dy = j - 4: the x offset is
//   the slower index (the princeton-vl order, raft.py:228-244).
// - The centre is clamped to [-(r + 1), size - 1 + r + 1] before floor
//   (raft.py:344-345); clamped windows read only zeros, as unclamped ones do.
// - All 81 taps share one fractional offset (fx, fy); each output is
//   w00 p00 + w01 p01 + w10 p10 + w11 p11 with w00 = (1 - fy)(1 - fx),
//   w01 = (1 - fy) fx, w10 = fy (1 - fx), w11 = fy fx.
// - Taps outside the map read 0: bounds are checked here, so no padded copy
//   of the pyramid exists.
// - A map axis of size 1 (tiny inputs only: under 128 padded pixels a side)
//   sends every tap's coordinate on that axis to 0, as the JAX package's
//   grid-sample tap path does there (raft.py:323-338).
//
// What bounds it on an H100: bytes. Per source pixel it must read the
// in-map part of 4 windows of 10 x 10 f32 (at most 1600 B) and its 8 B of
// coordinates, and write 324 f32 (1296 B): ~0.15 GB per launch for a decode
// batch of 8 pairs at 60 x 107, ~0.044 ms at 3.35 TB/s. It does 7 FLOP per
// output, far below the ~20 FLOP per byte where the card's f32 rate would
// bound it.
//
// Design (a first kernel: simple and right):
// - One thread per (source pixel, level); blockIdx.y is the level. Threads
//   of a block take consecutive pixels, so each of the 81 output channels a
//   thread writes is one coalesced row across the warp.
// - A thread walks its window row by row: it keeps two rows of 10 values in
//   registers, and after loading row j + 1 writes the 9 outputs of dy = j.
//   Each window row is 40 contiguous bytes of the pixel's own map; maps of
//   neighbouring pixels lie hl * wl * 4 bytes apart, so these reads are not
//   coalesced and go through the L1 read-only path (__ldg). Staging windows
//   through shared memory, vector loads and more pixels per warp are the
//   later forms (ROADMAP Queue B).
//
// Plain C interface, bound with ctypes (dino_tracker_tpu_torch/ops/window_gather.py).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kLevels = 4;
constexpr int kR = 4;               // lookup radius
constexpr int kWin = 2 * kR + 1;    // 9 taps a side
constexpr int kSide = kWin + 1;     // 10: the window plus the bilinear +1
constexpr int kChannels = kLevels * kWin * kWin;  // 324
constexpr int kThreads = 128;

struct Pyramid {
  const float* vol[kLevels];  // (N, h_l, w_l) each, N = B * h * w
  int h[kLevels];
  int w[kLevels];
};

// Row `y` of the window, columns x0 + k * step for k = 0..9, zeros outside.
__device__ __forceinline__ void load_row(float (&row)[kSide],
                                         const float* __restrict__ map, int y,
                                         int hl, int wl, int x0, int step) {
  const bool y_in = y >= 0 && y < hl;
#pragma unroll
  for (int k = 0; k < kSide; ++k) {
    const int x = x0 + k * step;
    row[k] = (y_in && x >= 0 && x < wl) ? __ldg(map + (int64_t)y * wl + x) : 0.f;
  }
}

// Clamped centre, or 0 with step 0 on an axis of size 1.
__device__ __forceinline__ float centre(float c, int size, int* step) {
  if (size == 1) {
    *step = 0;
    return 0.f;
  }
  *step = 1;
  return fminf(fmaxf(c, -(kR + 1.f)), size - 1 + kR + 1.f);
}

__global__ void __launch_bounds__(kThreads)
corr_lookup_kernel(Pyramid pyr, const float* __restrict__ coords,
                   float* __restrict__ out, int64_t n, int hw) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int level = blockIdx.y;
  const int64_t b = i / hw;
  const int p = (int)(i - b * hw);
  const int hl = pyr.h[level], wl = pyr.w[level];
  const float inv = 1.f / (float)(1 << level);  // exact: a power of two
  int step_x, step_y;
  const float cx = centre(coords[b * 2 * hw + p] * inv, wl, &step_x);
  const float cy = centre(coords[(b * 2 + 1) * hw + p] * inv, hl, &step_y);
  const float fx0 = floorf(cx), fy0 = floorf(cy);
  const float fx = cx - fx0, fy = cy - fy0;
  const float w00 = (1.f - fy) * (1.f - fx), w01 = (1.f - fy) * fx;
  const float w10 = fy * (1.f - fx), w11 = fy * fx;
  const int x0 = (int)fx0 - kR * step_x, y0 = (int)fy0 - kR * step_y;
  const float* __restrict__ map = pyr.vol[level] + i * (int64_t)hl * wl;
  float* __restrict__ dst = out + (b * kChannels + level * kWin * kWin) * hw + p;

  float top[kSide], bottom[kSide];
  load_row(top, map, y0, hl, wl, x0, step_x);
#pragma unroll
  for (int j = 0; j < kWin; ++j) {
    load_row(bottom, map, y0 + (j + 1) * step_y, hl, wl, x0, step_x);
#pragma unroll
    for (int t = 0; t < kWin; ++t) {  // t: the x offset, the slower channel index
      dst[(int64_t)(t * kWin + j) * hw] =
          w00 * top[t] + w01 * top[t + 1] + w10 * bottom[t] + w11 * bottom[t + 1];
    }
#pragma unroll
    for (int k = 0; k < kSide; ++k) top[k] = bottom[k];
  }
}

}  // namespace

// coords: B x 2 x h x w f32 (pixel x, then y, of the level-0 grid); out:
// B x 324 x h x w f32; level l: (B * h * w) x h_l x w_l f32, all contiguous.
// Returns the CUDA error of the launch (0 on success).
extern "C" int corr_lookup_fwd(const float* vol0, const float* vol1,
                               const float* vol2, const float* vol3, int h0,
                               int w0, int h1, int w1, int h2, int w2, int h3,
                               int w3, const float* coords, float* out,
                               int64_t batch, int h, int w, void* stream) {
  Pyramid pyr{{vol0, vol1, vol2, vol3}, {h0, h1, h2, h3}, {w0, w1, w2, w3}};
  const int hw = h * w;
  const int64_t n = batch * hw;
  if (n == 0) return (int)cudaSuccess;
  const dim3 grid((unsigned)((n + kThreads - 1) / kThreads), kLevels);
  corr_lookup_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(pyr, coords,
                                                                  out, n, hw);
  return (int)cudaGetLastError();
}
