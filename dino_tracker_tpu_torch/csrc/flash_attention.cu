// Flash attention forward (K2): out = softmax(q k^T * scale) v, non-causal,
// over contiguous [BH, S, 64] tensors (batch and heads flattened), bf16 or f32.
//
// Replaces the TPU kernel dino_tracker_tpu/ops/flash_attention.py:27
// _flash_fwd_kernel (launched by flash_attention :85, called from
// ops/attention.py:47 multi_head_attention <- models/vit.py:170 vit_block).
//
// What bounds it on an H100: tensor-core operations. One launch at the ViT
// feature stage's shape (4 frames x 16 heads, S = 8108 tokens, d = 64) does
// 4 * BH * S^2 * d = 1.08 TFLOP of products (Q K^T and P V) against 0.27 GB
// of q, k, v and out: ~4000 FLOP per byte, far above the card's ~295, so the
// bound is 1.08 TFLOP / 989 TFLOP/s = 1.09 ms. The score matrix (S x S per
// head, 263 MB in f32) must never reach device memory; the exponentials and
// the running max/sum are the softmax's SIMT share of the work.
//
// Design (a first kernel: simple and right; see ROADMAP for the faster forms):
// - One block per (query tile of 64 rows, batch-head); 4 warps, 16 query rows
//   each. The TPU kernel carried its softmax state across sequential grid
//   steps over key tiles; blocks run in parallel here, so each block loops
//   over all key tiles itself and keeps the running max m, running sum l and
//   the f32 accumulator in registers (online softmax).
// - bf16: products on the tensor cores with mma.sync m16n8k16 (bf16 in, f32
//   accumulation). Q's fragments stay in registers for the whole loop; each
//   key tile (64 keys) of K, and of V transposed, is staged in shared memory
//   with rows padded by 8 elements so fragment reads are free of bank
//   conflicts. The score fragment of Q K^T is, register for register, the A
//   fragment of P V, so probabilities never leave registers.
// - Probabilities are rounded to bf16 (v's dtype) before P V, as the TPU
//   kernel (flash_attention.py:68) and the plain version do; the running sum
//   l adds the unrounded f32 values, as the TPU kernel does. One division by
//   l at the end, with the l == 0 guard of flash_attention.py:77-78.
// - S need not be a multiple of any tile: keys >= S get a score of -inf and
//   query rows >= S are loaded as zeros and never stored, so there is no
//   padding copy and no valid_len argument. The running max starts at -inf;
//   where it is still -inf the exponentials use 0 in its place, so a fully
//   masked tile gives p = 0 and never exp(-inf - -inf) = NaN.
// - f32: a plain SIMT path, one thread per query row, key tiles of 32 in
//   shared memory. It exists to hold the card against the CPU reference at
//   f32 precision and is not on the bf16 main path.
//
// Plain C interface, bound with ctypes (dino_tracker_tpu_torch/ops/flash_attention.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;        // head dim
constexpr int kBQ = 64;       // query rows per block (4 warps x 16)
constexpr int kBK = 64;       // keys per tile
constexpr int kPad = kD + 8;  // padded shared-memory row, in bf16 elements
constexpr int kThreads = 128;

__device__ __forceinline__ void mma_bf16_16816(float* c, const uint32_t* a,
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // .x (lo) in the low half
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Fragment layouts of mma.m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16x16, row-major): a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..),
//     a3 (g+8, 2t+8..);
//   B (16x8, k x n): b0 (k 2t..2t+1, n g), b1 (k 2t+8..2t+9, n g);
//   C (16x8 f32): c0, c1 (g, 2t..2t+1), c2, c3 (g+8, 2t..2t+1).
// For S = Q K^T, B[k][n] = K[n][k]: a B register is two neighbouring d values
// of one key row. For O = P V, B[k][n] = V[k][n] = Vt[n][k]: two neighbouring
// keys of one d row of the transposed tile.
__global__ void __launch_bounds__(kThreads)
flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      __nv_bfloat16* __restrict__ o, int64_t s_len,
                      float scale_log2) {
  __shared__ __align__(16) __nv_bfloat16 q_s[kBQ][kPad];
  __shared__ __align__(16) __nv_bfloat16 k_s[kBK][kPad];
  __shared__ __align__(16) __nv_bfloat16 vt_s[kD][kBK + 8];

  const int64_t base = (int64_t)blockIdx.y * s_len * kD;
  const int64_t q0 = (int64_t)blockIdx.x * kBQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const uint4 zero = make_uint4(0, 0, 0, 0);

  // the block's query tile, 16 bytes (8 values) a thread per step
  for (int c = tid; c < kBQ * kD / 8; c += kThreads) {
    const int r = c / 8, col = (c % 8) * 8;
    uint4 val = zero;
    if (q0 + r < s_len)
      val = *reinterpret_cast<const uint4*>(q + base + (q0 + r) * kD + col);
    *reinterpret_cast<uint4*>(&q_s[r][col]) = val;
  }
  __syncthreads();

  const int r0 = warp * 16 + g;  // this thread's rows: r0 and r0 + 8
  uint32_t qa[4][4];             // A fragments of the 4 16-wide d chunks
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    qa[kc][0] = ld32(&q_s[r0][kc * 16 + 2 * t]);
    qa[kc][1] = ld32(&q_s[r0 + 8][kc * 16 + 2 * t]);
    qa[kc][2] = ld32(&q_s[r0][kc * 16 + 8 + 2 * t]);
    qa[kc][3] = ld32(&q_s[r0 + 8][kc * 16 + 8 + 2 * t]);
  }

  float m[2] = {-INFINITY, -INFINITY};  // running max (log2 units), rows r0, r0+8
  float l[2] = {0.f, 0.f};              // this thread's share of the running sum
  float acc[8][4];                      // O fragments of the 8 8-wide d tiles
#pragma unroll
  for (int dn = 0; dn < 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dn][e] = 0.f;

  for (int64_t k0 = 0; k0 < s_len; k0 += kBK) {
    __syncthreads();  // every warp is done with the previous tile
    for (int c = tid; c < kBK * kD / 8; c += kThreads) {
      const int r = c / 8, col = (c % 8) * 8;
      uint4 kv = zero, vv = zero;
      if (k0 + r < s_len) {
        kv = *reinterpret_cast<const uint4*>(k + base + (k0 + r) * kD + col);
        vv = *reinterpret_cast<const uint4*>(v + base + (k0 + r) * kD + col);
      }
      *reinterpret_cast<uint4*>(&k_s[r][col]) = kv;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int i = 0; i < 8; ++i) vt_s[col + i][r] = ve[i];
    }
    __syncthreads();

    // scores of 16 rows x 64 keys: 8 n-tiles of 8 keys
    float sc[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        const __nv_bfloat16* kr = &k_s[n * 8 + g][kc * 16 + 2 * t];
        mma_bf16_16816(sc[n], qa[kc], ld32(kr), ld32(kr + 8));
      }
    }

    // scale into log2 units, mask keys >= S, row max over the quad
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int64_t key = k0 + n * 8 + 2 * t + (e & 1);
        sc[n][e] = key < s_len ? sc[n][e] * scale_log2 : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], sc[n][e]);
      }
    }
    float mu[2], alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      mu[i] = mx[i] == -INFINITY ? 0.f : mx[i];  // no -inf - -inf
      alpha[i] = exp2f(m[i] - mu[i]);
      m[i] = mx[i];
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[n][e] = exp2f(sc[n][e] - mu[e >> 1]);
        l[e >> 1] += sc[n][e];
      }
    }
#pragma unroll
    for (int dn = 0; dn < 8; ++dn) {
      acc[dn][0] *= alpha[0];
      acc[dn][1] *= alpha[0];
      acc[dn][2] *= alpha[1];
      acc[dn][3] *= alpha[1];
    }

    // O += P V over 4 chunks of 16 keys; P's A fragment is two score tiles
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(sc[2 * kk][0], sc[2 * kk][1]);
      pa[1] = pack_bf16(sc[2 * kk][2], sc[2 * kk][3]);
      pa[2] = pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
      pa[3] = pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
#pragma unroll
      for (int dn = 0; dn < 8; ++dn) {
        const __nv_bfloat16* vr = &vt_s[dn * 8 + g][kk * 16 + 2 * t];
        mma_bf16_16816(acc[dn], pa, ld32(vr), ld32(vr + 8));
      }
    }
  }

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    inv[i] = li == 0.f ? 1.f : 1.f / li;
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int64_t row = q0 + r0 + 8 * i;
    if (row >= s_len) continue;
    __nv_bfloat16* orow = o + base + row * kD;
#pragma unroll
    for (int dn = 0; dn < 8; ++dn)
      *reinterpret_cast<uint32_t*>(orow + dn * 8 + 2 * t) =
          pack_bf16(acc[dn][2 * i] * inv[i], acc[dn][2 * i + 1] * inv[i]);
  }
}

constexpr int kFK = 32;  // keys per tile of the f32 path

__global__ void __launch_bounds__(kThreads)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     int64_t s_len, float scale) {
  __shared__ __align__(16) float k_s[kFK][kD];
  __shared__ __align__(16) float v_s[kFK][kD];
  const int64_t base = (int64_t)blockIdx.y * s_len * kD;
  const int64_t row = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const bool live = row < s_len;

  float qr[kD], acc[kD];
#pragma unroll
  for (int i = 0; i < kD; ++i) {
    qr[i] = live ? q[base + row * kD + i] : 0.f;
    acc[i] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  for (int64_t k0 = 0; k0 < s_len; k0 += kFK) {
    __syncthreads();
    for (int c = threadIdx.x; c < kFK * kD / 4; c += kThreads) {
      const int r = c / (kD / 4), col = (c % (kD / 4)) * 4;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (k0 + r < s_len) {
        kv = *reinterpret_cast<const float4*>(k + base + (k0 + r) * kD + col);
        vv = *reinterpret_cast<const float4*>(v + base + (k0 + r) * kD + col);
      }
      *reinterpret_cast<float4*>(&k_s[r][col]) = kv;
      *reinterpret_cast<float4*>(&v_s[r][col]) = vv;
    }
    __syncthreads();

    // the key loops stay rolled and only the 64-wide d loops unroll (so q
    // and acc stay in registers): this path is off the main path, and
    // unrolling both nests would take most of the file's nvcc time
    float sc[kFK];
    float mx = m;
#pragma unroll 1
    for (int j = 0; j < kFK; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < kD; ++i) dot = fmaf(qr[i], k_s[j][i], dot);
      sc[j] = k0 + j < s_len ? dot * scale : -INFINITY;
      mx = fmaxf(mx, sc[j]);
    }
    const float mu = mx == -INFINITY ? 0.f : mx;
    const float alpha = expf(m - mu);
    m = mx;
    l *= alpha;
#pragma unroll
    for (int i = 0; i < kD; ++i) acc[i] *= alpha;
#pragma unroll 1
    for (int j = 0; j < kFK; ++j) {
      const float p = expf(sc[j] - mu);
      l += p;
#pragma unroll
      for (int i = 0; i < kD; ++i) acc[i] = fmaf(p, v_s[j][i], acc[i]);
    }
  }
  if (!live) return;
  const float inv = l == 0.f ? 1.f : 1.f / l;
#pragma unroll
  for (int i = 0; i < kD; ++i) o[base + row * kD + i] = acc[i] * inv;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q, k, v, o are contiguous [bh, s_len, d]
// with d = 64 and 16-byte aligned; 1 <= bh <= 65535. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for arguments it does not take.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, int64_t bh, int64_t s_len, int64_t d,
                                   float sm_scale, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d != kD || bh < 1 || bh > 65535 || s_len < 1 || !aligned16(q) ||
      !aligned16(k) || !aligned16(v) || !aligned16(o))
    return (int)cudaErrorInvalidValue;
  if (dtype == 1) {
    const dim3 grid((unsigned)((s_len + kBQ - 1) / kBQ), (unsigned)bh);
    flash_fwd_bf16_kernel<<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), s_len,
        sm_scale * 1.4426950408889634f);  // log2(e): exp(x) = exp2(x log2 e)
  } else if (dtype == 0) {
    const dim3 grid((unsigned)((s_len + kThreads - 1) / kThreads), (unsigned)bh);
    flash_fwd_f32_kernel<<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), s_len, sm_scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
