// Blurpool forward (K1-fwd): anti-aliased 2x downsample of an NHWC tensor,
// and its backward (K1-bwd) further down.
//
// Replaces the TPU kernel dino_tracker_tpu/ops/blurpool.py:59 _down_kernel
// (with _leading_taps, launched by _leading_pass and composed twice by
// blurpool_pallas, once per axis through a transpose).
//
//   y[n,o,p,c] = sum_{i,j in 0..3} a_i a_j x[n, r_H(2o-1+i), r_W(2p-1+j), c]
//   a = [1,3,3,1]/8, r = reflect without repeating the edge
//   (-1 -> 1, L -> L-2, L+1 -> L-3), f32 accumulation, bf16 or f32 IO.
//
// What bounds it on an H100: device-memory bytes. Each output element costs
// 16 FMAs and the pass moves about 1.25 bytes per input byte (read x once,
// write a quarter of it), far below the card's compute-to-bandwidth ratio.
// The design answers that with one fused 2-D pass over NHWC and no
// transposes (the Pallas form writes a half-size intermediate and
// transposes it twice): each thread owns a vector of VEC channels of one
// output pixel, C is the fastest axis so a warp's loads and stores are
// coalesced 16-byte accesses, and the reflect indices of the 4 rows and
// 4 columns are computed per output row and column. The overlapping
// 4x4 windows of neighbouring outputs re-read x through L1/L2, not DRAM.
// A simple kernel that is right comes first; tiling through shared memory
// is later work.
//
// Plain C interface, bound with ctypes (dino_tracker_tpu_torch/ops/blurpool.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int64_t reflect(int64_t i, int64_t n) {
  if (i < 0) return -i;
  if (i >= n) return 2 * n - 2 - i;
  return i;
}

// VEC channels of one pixel as f32, from 16-byte (or scalar) loads.
template <typename T, int VEC>
struct Vec;

template <>
struct Vec<float, 4> {
  __device__ static void load(const float* p, float* v) {
    float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  }
  __device__ static void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Vec<float, 1> {
  __device__ static void load(const float* p, float* v) { v[0] = *p; }
  __device__ static void store(float* p, const float* v) { *p = v[0]; }
};

template <>
struct Vec<__nv_bfloat16, 8> {
  __device__ static void load(const __nv_bfloat16* p, float* v) {
    uint4 q = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float2 f = __bfloat1622float2(h[k]);
      v[2 * k] = f.x;
      v[2 * k + 1] = f.y;
    }
  }
  __device__ static void store(__nv_bfloat16* p, const float* v) {
    uint4 q;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
    for (int k = 0; k < 4; ++k) h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
    *reinterpret_cast<uint4*>(p) = q;
  }
};

template <>
struct Vec<__nv_bfloat16, 1> {
  __device__ static void load(const __nv_bfloat16* p, float* v) { v[0] = __bfloat162float(*p); }
  __device__ static void store(__nv_bfloat16* p, const float* v) { *p = __float2bfloat16_rn(v[0]); }
};

template <typename T, int VEC>
__global__ void blurpool_down_kernel(const T* __restrict__ x, T* __restrict__ y,
                                     int64_t n, int64_t h, int64_t w, int64_t c) {
  const float a[4] = {0.125f, 0.375f, 0.375f, 0.125f};
  const int64_t ho = (h + 1) / 2, wo = (w + 1) / 2, cv = c / VEC;
  const int64_t total = n * ho * wo * cv;
  for (int64_t idx = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; idx < total;
       idx += (int64_t)gridDim.x * blockDim.x) {
    const int64_t ci = idx % cv;
    int64_t rest = idx / cv;
    const int64_t p = rest % wo;
    rest /= wo;
    const int64_t o = rest % ho;
    const int64_t b = rest / ho;

    int64_t col[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) col[j] = reflect(2 * p - 1 + j, w) * c + ci * VEC;

    float acc[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = 0.f;

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const T* row = x + (b * h + reflect(2 * o - 1 + i, h)) * w * c;
      float racc[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) racc[k] = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float v[VEC];
        Vec<T, VEC>::load(row + col[j], v);
#pragma unroll
        for (int k = 0; k < VEC; ++k) racc[k] = fmaf(a[j], v[k], racc[k]);
      }
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[k] = fmaf(a[i], racc[k], acc[k]);
    }
    Vec<T, VEC>::store(y + ((b * ho + o) * wo + p) * c + ci * VEC, acc);
  }
}

template <typename T, int VEC>
void launch(const void* x, void* y, int64_t n, int64_t h, int64_t w, int64_t c,
            cudaStream_t stream) {
  const int threads = 256;
  const int64_t total = n * ((h + 1) / 2) * ((w + 1) / 2) * (c / VEC);
  int64_t blocks = (total + threads - 1) / threads;
  if (blocks > 0x7fffffff) blocks = 0x7fffffff;  // the grid-stride loop covers the rest
  if (blocks == 0) return;
  blurpool_down_kernel<T, VEC><<<(unsigned int)blocks, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), n, h, w, c);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// ---------------------------------------------------------------------------
// Blurpool backward (K1-bwd): the exact transpose (VJP) of the forward.
//
// Replaces the TPU kernel dino_tracker_tpu/ops/blurpool.py:67 _up_kernel
// (launched by _blur_up_axis1 and composed twice by _bwd, once per axis
// through a transpose, with the reflect-boundary adds hand-written per
// parity).
//
//   gx[n,i,j,c] = sum a_k a_l g[n,o,p,c] over every (o,k) with
//                 r_H(2o-1+k) = i and every (p,l) with r_W(2p-1+l) = j.
//
// A gather, not a scatter: no atomics, a deterministic result, f32
// accumulation and a single rounding at the store (the Pallas form rounds
// twice, once after each axis pass).
//
// Quads. Along one axis, outputs 2m and 2m+1 read g only at o = m-1..m+1:
// unreflected, 2m takes o = m-1 (tap a3) and o = m (a1), 2m+1 takes o = m
// (a2) and o = m+1 (a0); the reflected taps (q = -1 -> 1, L -> L-2,
// L+1 -> L-3) land inside the same window. So one thread owns a 2x2 quad of
// gx and VEC channels: it loads the quad's 3x3 window of g (9 vectors, where
// four independent output pixels would load 16), keeps the two output rows'
// partial sums per window column in registers, and stores 4 vectors.
// - Interior quads (1 <= m and 2m + 5 <= L on both axes, so no reflected
//   tap reaches them) use those constant weights: no branches, no bounds.
// - Edge quads (the first quad row or column, the last two, the half quad
//   of an odd H or W, every quad of an axis shorter than 7) use per-axis
//   weight tables built from the definition: for each window position d
//   (o = m-1+d) and tap k, a_k is added to output r where
//   r(2o-1+k) = 2m+r. Window positions outside g read zeros. Edge quads are
//   the first and last warps of a row and whole blocks of the first and last
//   quad rows, so the interior stays branch-free.
//
// Grid: blockIdx.z = frame, blockIdx.y = quad row, blockIdx.x * blockDim.y +
// threadIdx.y = quad column, threadIdx.x = channel vector (a loop when C/VEC
// exceeds blockDim.x). No division anywhere; index math is int32 within a
// frame (the caller keeps H*W*C < 2^31) on an int64 frame base.
//
// What bounds it on an H100: device-memory bytes. It must read g (a quarter
// of gx's size) and write gx once: at the largest training shape in bf16,
// 104 MB read and 416 MB written, ~0.155 ms at 3.35 TB/s. A thread per
// input pixel with int64 div/mod and a 6x6 slot loop of data-dependent skips
// spends a few hundred instructions per 16-byte store and stays near a
// quarter of that bound: it is bound by issue, not bytes. The quad form
// spends 9 vector loads, 4 vector stores and 20 FMAs a channel on a quad,
// and reads each g vector through L1, where the nine quads that share it
// meet.
// ---------------------------------------------------------------------------

constexpr int kUpThreads = 128;
// 7 blocks an SM cap a thread at 72 registers: ptxas spills 20 bytes to
// L1-backed local memory in the bf16 form, which still runs faster than at
// 80 registers and 6 blocks (no spill) or 95 and 5 (fewer loads in flight).
constexpr int kUpMinBlocks = 7;
constexpr float kA0 = 0.125f, kA1 = 0.375f, kA2 = 0.375f, kA3 = 0.125f;

__device__ __forceinline__ int reflect32(int i, int n) {
  if (i < 0) return -i;
  if (i >= n) return 2 * n - 2 - i;
  return i;
}

// Weights of a quad's two outputs along one axis (i = 2m + r, r = 0, 1) on
// its three window positions (o = m - 1 + d): the sum of a_k over the taps k
// with reflect(2o - 1 + k) = i. An output past the end (odd L) gets zeros.
__device__ __forceinline__ void axis_weights(int m, int len, int lo, float (&wt)[2][3]) {
  const float a[4] = {kA0, kA1, kA2, kA3};
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    wt[0][d] = 0.f;
    wt[1][d] = 0.f;
    const int o = m - 1 + d;
    if (o < 0 || o >= lo) continue;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = reflect32(2 * o - 1 + k, len);
      if (i == 2 * m) wt[0][d] += a[k];
      if (i == 2 * m + 1) wt[1][d] += a[k];
    }
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kUpThreads, kUpMinBlocks)
blurpool_up_kernel(const T* __restrict__ g, T* __restrict__ gx, int h, int w, int c) {
  const int ho = (h + 1) >> 1, wo = (w + 1) >> 1, cv = c / VEC;
  const int m = blockIdx.y;
  const int n = blockIdx.x * blockDim.y + threadIdx.y;
  if (n >= wo) return;
  const T* __restrict__ gb = g + (int64_t)blockIdx.z * ho * wo * c;
  T* __restrict__ xb = gx + (int64_t)blockIdx.z * h * w * c;
  const bool interior = m >= 1 && 2 * m + 5 <= h && n >= 1 && 2 * n + 5 <= w;
  float wr[2][3], wc[2][3];
  bool row_ok[3], col_ok[3];
  if (!interior) {
    axis_weights(m, h, ho, wr);
    axis_weights(n, w, wo, wc);
  }
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    row_ok[d] = m - 1 + d >= 0 && m - 1 + d < ho;
    col_ok[d] = n - 1 + d >= 0 && n - 1 + d < wo;
  }
  // Only edge quads can be half quads (odd H or W).
  const bool row1_ok = 2 * m + 1 < h, col1_ok = 2 * n + 1 < w;
  for (int ci = threadIdx.x; ci < cv; ci += blockDim.x) {
    // Window position (d, e) is g at (m - 1 + d, n - 1 + e): src + (d * wo + e) * c.
    // Output (2m + r, 2n + s) is dst + (r * w + s) * c.
    const T* __restrict__ src = gb + ((m - 1) * wo + (n - 1)) * c + ci * VEC;
    T* __restrict__ dst = xb + (2 * m * w + 2 * n) * c + ci * VEC;
    float part[2][3][VEC];  // output row r's partial sum at window column e
    if (interior) {
#pragma unroll
      for (int e = 0; e < 3; ++e) {
        float v0[VEC], v1[VEC], v2[VEC];
        Vec<T, VEC>::load(src + e * c, v0);
        Vec<T, VEC>::load(src + (wo + e) * c, v1);
        Vec<T, VEC>::load(src + (2 * wo + e) * c, v2);
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          part[0][e][k] = fmaf(kA1, v1[k], kA3 * v0[k]);
          part[1][e][k] = fmaf(kA0, v2[k], kA2 * v1[k]);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float o0[VEC], o1[VEC];
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          o0[k] = fmaf(kA1, part[r][1][k], kA3 * part[r][0][k]);
          o1[k] = fmaf(kA0, part[r][2][k], kA2 * part[r][1][k]);
        }
        Vec<T, VEC>::store(dst + r * w * c, o0);
        Vec<T, VEC>::store(dst + (r * w + 1) * c, o1);
      }
    } else {
#pragma unroll
      for (int e = 0; e < 3; ++e) {
#pragma unroll
        for (int k = 0; k < VEC; ++k) part[0][e][k] = part[1][e][k] = 0.f;
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          float v[VEC];
          if (row_ok[d] && col_ok[e]) {
            Vec<T, VEC>::load(src + (d * wo + e) * c, v);
          } else {
#pragma unroll
            for (int k = 0; k < VEC; ++k) v[k] = 0.f;
          }
#pragma unroll
          for (int k = 0; k < VEC; ++k) {
            part[0][e][k] = fmaf(wr[0][d], v[k], part[0][e][k]);
            part[1][e][k] = fmaf(wr[1][d], v[k], part[1][e][k]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          float o[VEC];
#pragma unroll
          for (int k = 0; k < VEC; ++k) {
            o[k] = 0.f;
#pragma unroll
            for (int e = 0; e < 3; ++e) o[k] = fmaf(wc[s][e], part[r][e][k], o[k]);
          }
          if ((r == 0 || row1_ok) && (s == 0 || col1_ok))
            Vec<T, VEC>::store(dst + (r * w + s) * c, o);
        }
      }
    }
  }
}

template <typename T, int VEC>
int launch_up(const void* g, void* gx, int64_t n, int64_t h, int64_t w, int64_t c,
              cudaStream_t stream) {
  const int64_t ho = (h + 1) / 2, wo = (w + 1) / 2, cv = c / VEC;
  if (n == 0 || c == 0) return (int)cudaSuccess;
  if (n > 65535 || ho > 65535 || h * w * c >= (int64_t(1) << 31))
    return (int)cudaErrorInvalidValue;
  const int bx = (int)(cv < kUpThreads ? cv : kUpThreads);
  const int by = kUpThreads / bx;
  const dim3 grid((unsigned)((wo + by - 1) / by), (unsigned)ho, (unsigned)n);
  blurpool_up_kernel<T, VEC><<<grid, dim3(bx, by), 0, stream>>>(
      static_cast<const T*>(g), static_cast<T*>(gx), (int)h, (int)w, (int)c);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. x is contiguous N×H×W×C with H, W >= 3,
// y is contiguous N×ceil(H/2)×ceil(W/2)×C. Returns cudaGetLastError().
extern "C" int blurpool_down_nhwc(const void* x, void* y, int64_t n, int64_t h,
                                  int64_t w, int64_t c, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec_ok = aligned16(x) && aligned16(y);
  if (dtype == 0) {
    if (vec_ok && c % 4 == 0) launch<float, 4>(x, y, n, h, w, c, s);
    else launch<float, 1>(x, y, n, h, w, c, s);
  } else if (dtype == 1) {
    if (vec_ok && c % 8 == 0) launch<__nv_bfloat16, 8>(x, y, n, h, w, c, s);
    else launch<__nv_bfloat16, 1>(x, y, n, h, w, c, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16. g is contiguous N×ceil(H/2)×ceil(W/2)×C,
// gx is contiguous N×H×W×C with H, W >= 3 (the forward's input shape),
// N and ceil(H/2) at most 65535 (grid limits) and H*W*C < 2^31.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for other inputs.
extern "C" int blurpool_up_nhwc(const void* g, void* gx, int64_t n, int64_t h,
                                int64_t w, int64_t c, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec_ok = aligned16(g) && aligned16(gx);
  if (dtype == 0) {
    if (vec_ok && c % 4 == 0) return launch_up<float, 4>(g, gx, n, h, w, c, s);
    return launch_up<float, 1>(g, gx, n, h, w, c, s);
  }
  if (dtype == 1) {
    if (vec_ok && c % 8 == 0) return launch_up<__nv_bfloat16, 8>(g, gx, n, h, w, c, s);
    return launch_up<__nv_bfloat16, 1>(g, gx, n, h, w, c, s);
  }
  return (int)cudaErrorInvalidValue;
}
