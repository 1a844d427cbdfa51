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
// Written as a gather, not a scatter: one thread per input pixel and VEC
// channels reads the g vectors that feed it, so there are no atomics and the
// result is deterministic. Per axis, an input index i is reached from the
// unreflected padded position i itself, from -1 when i = 1 (left reflect)
// and from 2L-2-i when that lies past the edge (right reflect); each padded
// position q is hit by the two taps k with 2o-1+k = q. At most three (o, k)
// terms survive per axis once the axis is longer than 3 (four at length 3),
// so a pixel reads at most 9 g vectors at the training shapes.
// Accumulation is f32 with a single rounding at the store (the Pallas form
// rounds twice, once after each axis pass).
//
// What bounds it on an H100: device-memory bytes. It reads g (a quarter of
// gx's size) through L1/L2 and writes gx once: at the L1 training shape in
// bf16, 104 MB read and 416 MB written, about 0.16 ms at 3.35 TB/s. The
// design keeps the forward's answer to that: C-minor 16-byte accesses, one
// fused 2-D pass, no transposes and no intermediate in device memory.
// ---------------------------------------------------------------------------

// Candidate (o, weight) slots of one axis: two taps for each of the three
// padded positions q that can read input index i. Slots that do not exist
// get weight 0 (and o = 0), so the loops over them unroll with constant
// indices and the slots stay in registers.
constexpr int kAxisSlots = 6;

__device__ __forceinline__ void axis_taps(int64_t i, int64_t L, int64_t lo,
                                          int64_t* os, float* ws) {
  const float a[4] = {0.125f, 0.375f, 0.375f, 0.125f};
  // x[i] read in place; x[-1] reflects to x[1]; x[q >= L] reflects to
  // x[2L-2-q], so q = 2L-2-i reads i when that q lies past the edge
  const int64_t qs[3] = {i, -1, 2 * L - 2 - i};
  const bool q_ok[3] = {true, i == 1, i <= L - 2};
#pragma unroll
  for (int t = 0; t < 3; ++t) {
    const int64_t q = qs[t];
    const int k0 = (int)((q + 1) & 1);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int k = k0 + 2 * u;
      const int64_t twice_o = q + 1 - k;  // even by the choice of k
      const bool ok = q_ok[t] && twice_o >= 0 && twice_o / 2 < lo;
      os[2 * t + u] = ok ? twice_o / 2 : 0;
      ws[2 * t + u] = ok ? a[k] : 0.f;
    }
  }
}

template <typename T, int VEC>
__global__ void blurpool_up_kernel(const T* __restrict__ g, T* __restrict__ gx,
                                   int64_t n, int64_t h, int64_t w, int64_t c) {
  const int64_t ho = (h + 1) / 2, wo = (w + 1) / 2, cv = c / VEC;
  const int64_t total = n * h * w * cv;
  for (int64_t idx = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; idx < total;
       idx += (int64_t)gridDim.x * blockDim.x) {
    const int64_t ci = idx % cv;
    int64_t rest = idx / cv;
    const int64_t j = rest % w;
    rest /= w;
    const int64_t i = rest % h;
    const int64_t b = rest / h;

    int64_t oh[kAxisSlots], ow[kAxisSlots];
    float wh[kAxisSlots], ww[kAxisSlots];
    axis_taps(i, h, ho, oh, wh);
    axis_taps(j, w, wo, ow, ww);

    float acc[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
#pragma unroll
    for (int s = 0; s < kAxisSlots; ++s) {
      if (wh[s] == 0.f) continue;
      const T* row = g + (b * ho + oh[s]) * wo * c + ci * VEC;
      float racc[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) racc[k] = 0.f;
#pragma unroll
      for (int t = 0; t < kAxisSlots; ++t) {
        if (ww[t] == 0.f) continue;
        float v[VEC];
        Vec<T, VEC>::load(row + ow[t] * c, v);
#pragma unroll
        for (int k = 0; k < VEC; ++k) racc[k] = fmaf(ww[t], v[k], racc[k]);
      }
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[k] = fmaf(wh[s], racc[k], acc[k]);
    }
    Vec<T, VEC>::store(gx + ((b * h + i) * w + j) * c + ci * VEC, acc);
  }
}

template <typename T, int VEC>
void launch_up(const void* g, void* gx, int64_t n, int64_t h, int64_t w, int64_t c,
               cudaStream_t stream) {
  const int threads = 256;
  const int64_t total = n * h * w * (c / VEC);
  int64_t blocks = (total + threads - 1) / threads;
  if (blocks > 0x7fffffff) blocks = 0x7fffffff;  // the grid-stride loop covers the rest
  if (blocks == 0) return;
  blurpool_up_kernel<T, VEC><<<(unsigned int)blocks, threads, 0, stream>>>(
      static_cast<const T*>(g), static_cast<T*>(gx), n, h, w, c);
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
// gx is contiguous N×H×W×C with H, W >= 3 (the forward's input shape).
// Returns cudaGetLastError().
extern "C" int blurpool_up_nhwc(const void* g, void* gx, int64_t n, int64_t h,
                                int64_t w, int64_t c, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec_ok = aligned16(g) && aligned16(gx);
  if (dtype == 0) {
    if (vec_ok && c % 4 == 0) launch_up<float, 4>(g, gx, n, h, w, c, s);
    else launch_up<float, 1>(g, gx, n, h, w, c, s);
  } else if (dtype == 1) {
    if (vec_ok && c % 8 == 0) launch_up<__nv_bfloat16, 8>(g, gx, n, h, w, c, s);
    else launch_up<__nv_bfloat16, 1>(g, gx, n, h, w, c, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
