// DeltaDINO's BatchNorm with the ReLU after it (K5), over N x H x W x C
// activations (NHWC, contiguous, bf16 or f32). K5-fwd normalises x with the
// batch's (or the running) mean and variance and applies the ReLU in one
// pass; K5-bwd computes the input gradient and the affine parameters'
// gradients in two. The affine step and the gradients are f32, rounded to
// the activation's dtype as the plain chain rounds them (below).
//
// Replaces no TPU kernel: the JAX package leaves BatchNorm to XLA, which
// fuses it (dino_tracker_tpu/models/nn.py batchnorm). It was added because
// PyTorch's eager chain for it (f32 copies of the activation, two means,
// four elementwise passes, a cast and a ReLU, and as many VJPs, with f32
// copies saved for them) moved ~70 bytes an element forward and over 100
// backward.
//
//   mean, inv = rsqrt(var + eps): from the batch's statistics, computed by the
//     caller with the plain chain's own ops (models/nn.py batch_moments),
//     or from the running ones
//   xh = (x - mean) * inv
//   y = round(xh * w + b), then the ReLU where the layer has one
//   g' = g where round(y) > 0 (the ReLU's mask, recomputed from x), else g
//   gx = round(round((g' * w) * inv) + round(-inv * w * (sum(g') / n + xh * sum(g' xh) / n)))
//        (eval: round((g' * w) * inv))
//   grad_b = sum(g'),  grad_w = sum(g' xh)
//
// Every f32 step of the forward is rounded as PyTorch's chain rounds it
// (__fsub_rn, __fmul_rn, __fadd_rn: never contracted into an FMA), so from
// the chain's statistics the output has the chain's bits, and the backward
// recomputes the forward's output, and so its ReLU mask, exactly. Equal bits
// matter: a bf16 output one unit off in a few elements is carried by the
// next layers' bf16 roundings into noise of a unit over the whole refined
// stack, and the training loss, its gradients and Adam's steps then follow
// other noise than the plain chain's. The input gradient's two terms are
// rounded as autograd of the chain rounds them: the chain reads x through two
// casts to f32, one into the statistics and one into (x - mean), so its
// gradient reaches x as two f32 tensors, each cast to the activation's dtype,
// and then added in that dtype (rounding the exact sum once instead moves
// the parameter gradients upstream by a few percent in bf16).
//
// What bounds it on an H100: bytes. A few operations an element against 4
// bytes forward (read x, write y) and 10 backward (read g and x for the sums,
// again for gx, write gx): far below the card's ~300 bf16 FLOP a byte. So
// each pass reads and writes each tensor once:
//
// - A thread owns one vector of channels (8 bf16 or 4 f32: 16-byte loads;
//   one channel where C is not a multiple of that) and walks rows: a block is
//   rpi rows by tpr channel vectors (tpr = C's vectors, split into equal
//   chunks along gridDim.y above kThreads), chosen from C by the host. The
//   channel's constants (mean, inv, w, b, ...) stay in the thread's registers.
// - The backward's sums kernel (bn_grad_sums_kernel) runs a fixed number of
//   persistent blocks an SM; each thread adds its rows in order, a few loads
//   in flight, a block adds its threads' sums in row order in shared memory
//   and writes one partial per channel, and bn_reduce_kernel adds the
//   blocks' partials in block order. No atomics: the same inputs give the
//   same bits, eager or replayed from a CUDA graph. On a mesh the caller
//   all-reduces the sums before bn_grad_apply_kernel.
//
// Plain C interface, bound with ctypes (dino_tracker_tpu_torch/ops/batchnorm.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;     // most threads a block
constexpr int kMaxVec = 8;        // widest channel vector (8 bf16)
// Rows a thread loads before it uses them, and blocks an SM (the launch
// bounds: 80 registers a thread at 3, 128 at 2, so that nothing spills),
// per kernel: each keeps 24-32 KB of loads in flight an SM. The backward's
// kernels hold more channel constants and two tensors' loads.
constexpr int kApplyUnroll = 2, kApplyBlocksPerSm = 3;
constexpr int kGradUnroll = 2, kGradBlocksPerSm = 2;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// V elements of T from p (16-byte aligned where V > 1) as f32
template <typename T, int V>
__device__ __forceinline__ void load(const T* p, float (&v)[V]) {
  if constexpr (V == 1) {
    v[0] = to_f32(p[0]);
  } else {
    static_assert(V * sizeof(T) == 16, "a vector is one 16-byte load");
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = to_f32(e[j]);
  }
}

template <typename T, int V>
__device__ __forceinline__ void store(T* p, const float (&v)[V]) {
  if constexpr (V == 1) {
    p[0] = from_f32<T>(v[0]);
  } else {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int j = 0; j < V; ++j) e[j] = from_f32<T>(v[j]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
}

// The forward's f32 output before rounding: ((x - mean) * inv) * w + b, each
// step rounded, then the ReLU
__device__ __forceinline__ float normalised(float xh, float w, float b, bool relu) {
  const float y = __fadd_rn(__fmul_rn(xh, w), b);
  return relu && y < 0.f ? 0.f : y;
}

template <typename T>
__device__ __forceinline__ float rounded(float v) { return to_f32(from_f32<T>(v)); }

// The ReLU's mask as the backward reads it: the forward's output, rounded to
// T, above 0
template <typename T>
__device__ __forceinline__ bool passes(float xh, float w, float b) {
  return rounded<T>(__fadd_rn(__fmul_rn(xh, w), b)) > 0.f;
}

// A thread's place: its channel vector cv (of C / V) and its row in the
// block's rows (sub < rpi)
struct Place {
  int col, sub, cv;
};

__device__ __forceinline__ Place place(int tpr) {
  const int col = threadIdx.x % tpr;
  return {col, (int)threadIdx.x / tpr, (int)blockIdx.y * tpr + col};
}

// The block's sums of its threads' a[] and q[] in row order, written as
// this block's partials: partials[blockIdx.x][0 .. C) and [C .. 2C)
template <int V>
__device__ __forceinline__ void write_partials(const float (&a)[V], const float (&q)[V],
                                               int c, int tpr, int rpi, float* partials) {
  __shared__ float red[kThreads * 2 * kMaxVec];
  const Place pl = place(tpr);
  const int width = tpr * V;  // channels of this block's chunk
  float* mine = red + pl.sub * 2 * width + pl.col * V;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    mine[j] = a[j];
    mine[width + j] = q[j];
  }
  __syncthreads();
  for (int k = threadIdx.x; k < 2 * width; k += blockDim.x) {
    const int ch = (int)blockIdx.y * width + k % width;
    if (ch >= c) continue;
    float t = 0.f;
    for (int r = 0; r < rpi; ++r) t = __fadd_rn(t, red[r * 2 * width + k]);
    partials[(int64_t)blockIdx.x * 2 * c + (k / width) * c + ch] = t;
  }
}

// K5-bwd, sums: each block's per-channel partial [sum g', sum g' xh]
template <typename T, int V, int kUnroll = kGradUnroll>
__global__ void __launch_bounds__(kThreads, kGradBlocksPerSm)
bn_grad_sums_kernel(const T* __restrict__ g, const T* __restrict__ x, int64_t rows, int c,
                    int tpr, int rpi, const float* __restrict__ stat,
                    const float* __restrict__ w, const float* __restrict__ b, int relu,
                    float* __restrict__ partials) {
  const Place pl = place(tpr);
  float sg[V], sgx[V];
#pragma unroll
  for (int j = 0; j < V; ++j) sg[j] = sgx[j] = 0.f;
  if (pl.cv * V < c) {
    float mean[V], inv[V], wt[V], bs[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int ch = pl.cv * V + j;
      mean[j] = stat[ch];
      inv[j] = stat[2 * c + ch];
      wt[j] = w[ch];
      bs[j] = b[ch];
    }
    const int64_t step = (int64_t)gridDim.x * rpi;
    const int64_t off = (int64_t)pl.cv * V;
    for (int64_t r = (int64_t)blockIdx.x * rpi + pl.sub; r < rows; r += kUnroll * step) {
      float gv[kUnroll][V], xv[kUnroll][V];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (r + u * step < rows) {
          load<T, V>(g + (r + u * step) * c + off, gv[u]);
          load<T, V>(x + (r + u * step) * c + off, xv[u]);
        }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (r + u * step >= rows) break;
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float xh = __fmul_rn(__fsub_rn(xv[u][j], mean[j]), inv[j]);
          const float gp = !relu || passes<T>(xh, wt[j], bs[j]) ? gv[u][j] : 0.f;
          sg[j] = __fadd_rn(sg[j], gp);
          sgx[j] = __fadd_rn(sgx[j], __fmul_rn(gp, xh));
        }
      }
    }
  }
  write_partials<V>(sg, sgx, c, tpr, rpi, partials);
}

// sums[k] = the blocks' partials of k added in block order (k < 2C), and
// sums[2C] = count
__global__ void bn_reduce_kernel(const float* __restrict__ partials, int blocks, int n2,
                                 float count, float* __restrict__ sums) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k < n2) {
    float t = 0.f;
#pragma unroll 8
    for (int i = 0; i < blocks; ++i) t = __fadd_rn(t, partials[(int64_t)i * n2 + k]);
    sums[k] = t;
  }
  if (k == 0) sums[n2] = count;
}

// K5-fwd: y from x and the statistics' mean and inv
template <typename T, int V, int kUnroll = kApplyUnroll>
__global__ void __launch_bounds__(kThreads, kApplyBlocksPerSm)
bn_apply_kernel(const T* __restrict__ x, T* __restrict__ y, int64_t rows, int c, int tpr,
                int rpi, const float* __restrict__ mean_in, const float* __restrict__ inv_in,
                const float* __restrict__ w, const float* __restrict__ b, int relu) {
  const Place pl = place(tpr);
  if (pl.cv * V >= c) return;
  float mean[V], inv[V], wt[V], bs[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int ch = pl.cv * V + j;
    mean[j] = mean_in[ch];
    inv[j] = inv_in[ch];
    wt[j] = w[ch];
    bs[j] = b[ch];
  }
  const int64_t step = (int64_t)gridDim.x * rpi;
  const int64_t off = (int64_t)pl.cv * V;
  for (int64_t r = (int64_t)blockIdx.x * rpi + pl.sub; r < rows; r += kUnroll * step) {
    float v[kUnroll][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (r + u * step < rows) load<T, V>(x + (r + u * step) * c + off, v[u]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (r + u * step >= rows) break;
#pragma unroll
      for (int j = 0; j < V; ++j)
        v[u][j] = normalised(__fmul_rn(__fsub_rn(v[u][j], mean[j]), inv[j]), wt[j], bs[j],
                             relu);
      store<T, V>(y + (r + u * step) * c + off, v[u]);
    }
  }
}

// K5-bwd, apply: gx from g, x, the statistics and the all-reduced
// [sum g', sum g' xh, n] (null in eval mode: the statistics are constants,
// and their term is 0)
template <typename T, int V, int kUnroll = kGradUnroll>
__global__ void __launch_bounds__(kThreads, kGradBlocksPerSm)
bn_grad_apply_kernel(const T* __restrict__ g, const T* __restrict__ x, T* __restrict__ gx,
                     int64_t rows, int c, int tpr, int rpi, const float* __restrict__ stat,
                     const float* __restrict__ w, const float* __restrict__ b, int relu,
                     const float* __restrict__ sums) {
  const Place pl = place(tpr);
  if (pl.cv * V >= c) return;
  float mean[V], inv[V], wt[V], bs[V], a[V], mg[V], mgx[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int ch = pl.cv * V + j;
    mean[j] = stat[ch];
    inv[j] = stat[2 * c + ch];
    wt[j] = w[ch];
    bs[j] = b[ch];
    a[j] = __fmul_rn(inv[j], wt[j]);
    mg[j] = sums != nullptr ? __fdiv_rn(sums[ch], sums[2 * c]) : 0.f;
    mgx[j] = sums != nullptr ? __fdiv_rn(sums[c + ch], sums[2 * c]) : 0.f;
  }
  const int64_t step = (int64_t)gridDim.x * rpi;
  const int64_t off = (int64_t)pl.cv * V;
  for (int64_t r = (int64_t)blockIdx.x * rpi + pl.sub; r < rows; r += kUnroll * step) {
    float gv[kUnroll][V], xv[kUnroll][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (r + u * step < rows) {
        load<T, V>(g + (r + u * step) * c + off, gv[u]);
        load<T, V>(x + (r + u * step) * c + off, xv[u]);
      }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (r + u * step >= rows) break;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float xh = __fmul_rn(__fsub_rn(xv[u][j], mean[j]), inv[j]);
        const float gp = !relu || passes<T>(xh, wt[j], bs[j]) ? gv[u][j] : 0.f;
        const float direct = __fmul_rn(__fmul_rn(gp, wt[j]), inv[j]);
        const float stats = -__fmul_rn(a[j], __fadd_rn(mg[j], __fmul_rn(xh, mgx[j])));
        gv[u][j] = __fadd_rn(rounded<T>(direct), rounded<T>(stats));
      }
      store<T, V>(gx + (r + u * step) * c + off, gv[u]);
    }
  }
}

// A block's shape for C channels in vectors of vec: tpr channel vectors
// (C's, in equal chunks of at most kThreads along gridDim.y) by rpi rows
struct Shape {
  int tpr, rpi, chunks;
};

Shape shape(int64_t c, int vec) {
  const int cvecs = (int)(c / vec);
  const int chunks = (cvecs + kThreads - 1) / kThreads;
  const int tpr = (cvecs + chunks - 1) / chunks;
  return {tpr, kThreads / tpr, chunks};
}

// persistent blocks along the rows: per_sm an SM over the chunks, and no
// more than the rows fill
int row_blocks(int64_t rows, const Shape& s, int sms, int per_sm) {
  const int64_t fill = (rows + s.rpi - 1) / s.rpi;
  int64_t cap = (int64_t)sms * per_sm / s.chunks;
  if (cap < 1) cap = 1;
  const int64_t n = fill < cap ? fill : cap;
  return (int)(n < 1 ? 1 : n);
}

bool valid(int64_t rows, int64_t c, int vec, int is_bf16, int sms) {
  const int width = is_bf16 ? 8 : 4;
  return rows >= 0 && c >= 1 && c <= (1 << 20) && sms >= 1 && (vec == 1 || vec == width) &&
         c % vec == 0 && rows * c < ((int64_t)1 << 62);
}

template <typename T, int V>
struct Tag {
  using type = T;
  static constexpr int vec = V;
};

// f(Tag<T, V>) for the activation's dtype and vector width
template <typename F>
int dispatch(int is_bf16, int vec, F&& f) {
  if (is_bf16) return vec == 1 ? f(Tag<__nv_bfloat16, 1>{}) : f(Tag<__nv_bfloat16, 8>{});
  return vec == 1 ? f(Tag<float, 1>{}) : f(Tag<float, 4>{});
}

int reduce(const float* partials, int blocks, int64_t c, float count, float* sums,
           cudaStream_t s) {
  const int n2 = (int)(2 * c);
  bn_reduce_kernel<<<(n2 + 127) / 128, 128, 0, s>>>(partials, blocks, n2, count, sums);
  return (int)cudaGetLastError();
}

}  // namespace

// Persistent blocks of the backward's sums kernel along the rows: the
// partials hold this many x 2C f32.
extern "C" int64_t bn_sum_blocks(int64_t rows, int64_t c, int vec, int sms) {
  if (rows < 1 || c < 1 || vec < 1 || c % vec != 0 || sms < 1) return 0;
  return row_blocks(rows, shape(c, vec), sms, kGradBlocksPerSm);
}

// K5-fwd. x, y: rows x C (contiguous; 16-byte aligned where vec > 1), bf16
// (is_bf16) or f32; vec 8 (bf16), 4 (f32) or 1; sms the device's SMs; mean,
// inv = rsqrt(var + eps), w, b: C f32. relu: apply the ReLU. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for arguments out of range.
extern "C" int bn_fwd(const void* x, void* y, int is_bf16, int vec, int64_t rows, int64_t c,
                      int sms, const void* mean, const void* inv, const void* w, const void* b,
                      int relu, void* stream) {
  if (!valid(rows, c, vec, is_bf16, sms)) return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  const Shape sh = shape(c, vec);
  const int blocks = row_blocks(rows, sh, sms, kApplyBlocksPerSm);
  return dispatch(is_bf16, vec, [&](auto tag) {
    using T = typename decltype(tag)::type;
    bn_apply_kernel<T, decltype(tag)::vec>
        <<<dim3(blocks, sh.chunks), sh.tpr * sh.rpi, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const T*>(x), static_cast<T*>(y), rows, (int)c, sh.tpr, sh.rpi,
            static_cast<const float*>(mean), static_cast<const float*>(inv),
            static_cast<const float*>(w), static_cast<const float*>(b), relu);
    return (int)cudaGetLastError();
  });
}

// K5-bwd, sums. g, x: rows x C of one dtype, as in bn_fwd; stat: [mean,
// var, inv] of the forward; w, b: C f32; partials bn_sum_blocks(...) x 2C
// f32 (scratch); sums 2C + 1 f32 out: [sum g', sum g' xh, count]. rows may
// be 0 (sums 0).
extern "C" int bn_bwd_sums(const void* g, const void* x, int is_bf16, int vec, int64_t rows,
                           int64_t c, int sms, const void* stat, const void* w, const void* b,
                           int relu, void* partials, void* sums, float count, void* stream) {
  if (!valid(rows, c, vec, is_bf16, sms)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Shape sh = shape(c, vec);
  const int blocks = rows > 0 ? row_blocks(rows, sh, sms, kGradBlocksPerSm) : 0;
  float* part = static_cast<float*>(partials);
  if (blocks > 0) {
    const int err = dispatch(is_bf16, vec, [&](auto tag) {
      using T = typename decltype(tag)::type;
      bn_grad_sums_kernel<T, decltype(tag)::vec>
          <<<dim3(blocks, sh.chunks), sh.tpr * sh.rpi, 0, s>>>(
              static_cast<const T*>(g), static_cast<const T*>(x), rows, (int)c, sh.tpr, sh.rpi,
              static_cast<const float*>(stat), static_cast<const float*>(w),
              static_cast<const float*>(b), relu, part);
      return (int)cudaGetLastError();
    });
    if (err != cudaSuccess) return err;
  }
  return reduce(part, blocks, c, count, static_cast<float*>(sums), s);
}

// K5-bwd, apply. gx: rows x C out, the dtype of g and x; sums: the
// all-reduced [sum g', sum g' xh, n] in train mode, null in eval mode.
extern "C" int bn_bwd_apply(const void* g, const void* x, void* gx, int is_bf16, int vec,
                            int64_t rows, int64_t c, int sms, const void* stat, const void* w,
                            const void* b, int relu, const void* sums, void* stream) {
  if (!valid(rows, c, vec, is_bf16, sms)) return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  const Shape sh = shape(c, vec);
  const int blocks = row_blocks(rows, sh, sms, kGradBlocksPerSm);
  return dispatch(is_bf16, vec, [&](auto tag) {
    using T = typename decltype(tag)::type;
    bn_grad_apply_kernel<T, decltype(tag)::vec>
        <<<dim3(blocks, sh.chunks), sh.tpr * sh.rpi, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const T*>(g), static_cast<const T*>(x), static_cast<T*>(gx), rows,
            (int)c, sh.tpr, sh.rpi, static_cast<const float*>(stat),
            static_cast<const float*>(w), static_cast<const float*>(b), relu,
            static_cast<const float*>(sums));
    return (int)cudaGetLastError();
  });
}
