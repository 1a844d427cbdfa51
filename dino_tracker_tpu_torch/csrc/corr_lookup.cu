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
// goes through shared memory only, and the pyramid is read unpadded.
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
// bound it. Device memory moves 32-byte sectors: a 40-byte window row at a
// 4-byte offset spans 2-3 of them, so the reachable floor lies ~1.3-1.4x
// above the byte bound.
//
// Design: pixel tiles staged through shared memory.
// - A block takes kTile = 64 consecutive source pixels (16 and 32 measured
//   slower) at one level, blockIdx.y. Pixels are B * h * w flattened, so a
//   tile may cross a frame boundary: each pixel keeps its own frame b and
//   position p. The ragged last tile is masked.
// - Fill: every thread of the block copies window cells into shared memory
//   with 4-byte cp.async, enumerated so that consecutive lanes take
//   consecutive cells of one window row: a warp instruction reads ~3 whole
//   40-byte rows, where a thread per pixel reading its own window touched 32
//   maps hl * wl * 4 bytes apart and used 4 bytes of each sector. Cells
//   outside the map are zero-filled (src-size 0, the source address kept on
//   a cell inside the map). An axis of size 1 copies its one cell for every
//   tap (step 0).
// - Compute: one thread per pixel over all 9 x offsets (splitting them over
//   3 threads measured slower). A thread walks the shared window row by row,
//   two rows in registers, and writes its channels; lanes are consecutive
//   pixels, so each channel row is one coalesced store.
//   Windows sit kCells + 1 floats apart, so a warp's 32 pixels read 32 banks.
// - What the card gives: the window reads alone take ~2.5x their sector
//   floor and the output writes alone ~2.3x their byte time; the two
//   overlap, and the kernel lands at ~2x the floor. The maps' layout (one
//   map per source pixel, ~2 M window rows of 40 bytes at scattered
//   offsets a launch) sets that, not how the loads are issued: a thread
//   per pixel with 4-byte loads, these 4-byte copies, and 16-byte copies
//   of aligned chunks (~35 a window instead of 100) all land within 10%.
//   Reading whole rows of a small level's span, prefetch hints and
//   streaming stores were slower or no faster.
// - Many blocks are resident per SM, so one block's fill overlaps others'
//   compute without a double buffer inside the block.
// - No TMA: tensor maps need global strides that are multiples of 16 B, and
//   the levels' row strides at the main path's grid are 428, 212, 104 and 52 B.
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
constexpr int kCells = kSide * kSide;
constexpr int kChannels = kLevels * kWin * kWin;  // 324
constexpr int kTile = 64;           // source pixels a block, one thread each
constexpr int kStride = kCells + 1;  // odd: a warp's windows fall in 32 banks

struct Pyramid {
  const float* vol[kLevels];  // (N, h_l, w_l) each, N = B * h * w
  int h[kLevels];
  int w[kLevels];
};

// Clamped centre, or 0 on an axis of size 1 (whose taps take step 0).
__device__ __forceinline__ float centre(float c, int size) {
  return size == 1 ? 0.f : fminf(fmaxf(c, -(kR + 1.f)), size - 1 + kR + 1.f);
}

// 4-byte asynchronous copy to shared memory; src_size 0 writes a zero.
__device__ __forceinline__ void cp_async4(float* dst, const float* src, int src_size) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(src_size));
}

__global__ void __launch_bounds__(kTile)
corr_lookup_kernel(Pyramid pyr, const float* __restrict__ coords,
                   float* __restrict__ out, int n, int hw) {
  __shared__ float win[kTile * kStride];
  __shared__ int origin[kTile][2];  // x, y of each pixel's window cell (0, 0)
  const int level = blockIdx.y;
  const int px = threadIdx.x;
  const int first = blockIdx.x * kTile;
  const int i = first + px;
  const int hl = pyr.h[level], wl = pyr.w[level];
  const int step_x = wl == 1 ? 0 : 1, step_y = hl == 1 ? 0 : 1;
  const int b = i / hw, p = i - b * hw;
  float w00 = 0.f, w01 = 0.f, w10 = 0.f, w11 = 0.f;
  if (i < n) {
    const float inv = 1.f / (float)(1 << level);  // exact: a power of two
    const float cx = centre(coords[(int64_t)(2 * b) * hw + p] * inv, wl);
    const float cy = centre(coords[(int64_t)(2 * b + 1) * hw + p] * inv, hl);
    const float fx0 = floorf(cx), fy0 = floorf(cy);
    const float fx = cx - fx0, fy = cy - fy0;
    w00 = (1.f - fy) * (1.f - fx);
    w01 = (1.f - fy) * fx;
    w10 = fy * (1.f - fx);
    w11 = fy * fx;
    origin[px][0] = (int)fx0 - kR * step_x;
    origin[px][1] = (int)fy0 - kR * step_y;
  }
  __syncthreads();

  const int cells = min(kTile, n - first) * kCells;
  const float* __restrict__ maps = pyr.vol[level] + (int64_t)first * hl * wl;
  for (int e = px; e < cells; e += kTile) {
    const int q = e / kCells, cell = e - q * kCells;  // constant divisors
    const int row = cell / kSide, col = cell - row * kSide;
    const int y = origin[q][1] + row * step_y, x = origin[q][0] + col * step_x;
    const bool in = y >= 0 && y < hl && x >= 0 && x < wl;
    cp_async4(&win[q * kStride + cell], maps + (int64_t)q * hl * wl + (in ? y * wl + x : 0),
              in ? 4 : 0);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  if (i >= n) return;

  const float* __restrict__ s = win + px * kStride;
  float* __restrict__ dst = out + ((int64_t)b * kChannels + level * kWin * kWin) * hw + p;
  float top[kSide], bottom[kSide];
#pragma unroll
  for (int k = 0; k < kSide; ++k) top[k] = s[k];
#pragma unroll
  for (int j = 0; j < kWin; ++j) {
#pragma unroll
    for (int k = 0; k < kSide; ++k) bottom[k] = s[(j + 1) * kSide + k];
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
// B x 324 x h x w f32; level l: (B * h * w) x h_l x w_l f32, all contiguous;
// B * h * w < 2^31. Returns the CUDA error of the launch (0 on success).
extern "C" int corr_lookup_fwd(const float* vol0, const float* vol1,
                               const float* vol2, const float* vol3, int h0,
                               int w0, int h1, int w1, int h2, int w2, int h3,
                               int w3, const float* coords, float* out,
                               int64_t batch, int h, int w, void* stream) {
  Pyramid pyr{{vol0, vol1, vol2, vol3}, {h0, h1, h2, h3}, {w0, w1, w2, w3}};
  const int hw = h * w;
  const int64_t n = batch * hw;
  if (n == 0) return (int)cudaSuccess;
  if (n >= (int64_t(1) << 31)) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((n + kTile - 1) / kTile), kLevels);
  corr_lookup_kernel<<<grid, kTile, 0, (cudaStream_t)stream>>>(
      pyr, coords, out, (int)n, hw);
  return (int)cudaGetLastError();
}
