// Flash attention forward (K2): out = softmax(q k^T * scale) v, non-causal,
// head dim 64, bf16 (the main path) or f32.
//
// Replaces the TPU kernel dino_tracker_tpu/ops/flash_attention.py:27
// _flash_fwd_kernel (launched by flash_attention :85, called from
// ops/attention.py:47 multi_head_attention <- models/vit.py:170 vit_block).
//
// What bounds it on an H100: tensor-core operations. One launch at the ViT
// feature stage's shape (4 frames x 16 heads, S = 8108 tokens, d = 64) does
// 4 * BH * S^2 * d = 1.08 TFLOP of products (Q K^T and P V) against 0.27 GB
// of q, k, v and out: ~4000 FLOP per byte, far above the card's ~295, so the
// bound is 1.08 TFLOP / 989 TFLOP/s = 1.09 ms. At d = 64 the softmax's
// exponentials come close: S^2 * BH = 4.2e9 ex2 on the SFUs (16 a clock per
// SM) take ~1 ms by themselves, so the products and the softmax must overlap.
//
// bf16 design (Hopper only: wgmma, TMA, mbarriers, setmaxnreg; sm_90a):
// - One block per (query tile of BM = 192 rows, batch-head), the query tiles
//   of one head adjacent in blockIdx.x so that head's K/V stay in L2. Three
//   consumer warpgroups (warps 0-11, 64 query rows each) and one producer
//   warpgroup after them; the producer drops to 24 registers with
//   setmaxnreg.dec, the consumers take 160 each with setmaxnreg.inc.
// - The producer's first thread loads the block's Q once and then every key
//   tile (BN = 128 keys) of K and of V through TMA into a ring of 4 stages,
//   each tile with its own "full" mbarrier (expect_tx bytes); consumers free a
//   stage through its "empty" mbarrier (one arrival per consumer warp). The
//   tensor maps are 4-D (d, h, s, b) with the caller's own byte strides, so
//   q, k and v are read where the qkv projection wrote them (no head copies);
//   rows past S come in as zeros (TMA's out-of-bounds fill). Every tile row
//   is 64 bf16 = 128 B, loaded with the 128-byte swizzle and read by wgmma
//   through matching B128 descriptors.
// - S = Q K^T: wgmma m64n128k16, both operands from shared memory, both
//   K-major; four k-steps over d = 64 (the descriptor's start moves 32 B).
// - O += P V: wgmma m64n64k16 with A = P from registers (the S accumulator's
//   layout is, register for register, the A fragment layout, so P never
//   leaves registers) and B = the V tile as TMA laid it ([keys][d]), read
//   MN-major with the transpose bit: nothing transposes V.
// - Overlap. Within a warpgroup there is none: each runs S, its softmax and
//   P V in turn, and the three warpgroups' phases interleave on the SM only
//   through the warp scheduler; each K/V tile fetched from L2 serves 192 query
//   rows, and S, P and O are never all live at once, so the loop fits 160
//   registers. The two explicit overlaps of FA3 were measured on the H100 and
//   left out (PERF.md): issuing the next tile's Q K^T before this tile's
//   softmax keeps S, P and O live together, which spills at 160 registers and
//   so needs BM = 128 (two consumers at 240 registers), and that kernel was
//   slower (2.76-2.89 ms against 2.07-2.16 ms at [4,16,8108,64]);
//   named-barrier ping-pong of the warpgroups' issues was slower too.
// - Numerics as the TPU kernel: scores and the running max in f32, in log2
//   units (exp(x) = exp2(x log2 e)); probabilities rounded to bf16 before
//   P V (flash_attention.py:68); the running sum l adds the unrounded f32
//   values; one division by l at the end, with the l == 0 guard
//   (:77-78). Keys >= S get a score of -inf (only the last key tile needs
//   the mask); rows >= S are computed on zeros and never stored. The running
//   max starts at -inf; where it is still -inf the exponentials use 0 in its
//   place, so a fully masked row never gives exp(-inf - -inf) = NaN.
// - The output is written from registers into the caller's [B, S, H, 64]
//   buffer (strides passed in), so the ViT's transpose back is a view.
// - f32: a plain SIMT path over contiguous [BH, S, 64], one thread per query
//   row, key tiles of 32 in shared memory. It exists to hold the card against
//   the CPU reference at f32 precision and is not on the bf16 main path.
//
// The tensor maps are encoded on the host per call with cuTensorMapEncodeTiled,
// reached through the runtime's driver entry point (no -lcuda at build time).
// Plain C interface, bound with ctypes (dino_tracker_tpu_torch/ops/flash_attention.py).

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;          // head dim
constexpr int kThreads = 128;   // one warpgroup; the f32 path's block
constexpr int kBN = 128;        // keys per tile (bf16 path)
constexpr int kQRows = 64;      // query rows per consumer warpgroup
constexpr int kConsumers = 3;   // consumer warpgroups a block
constexpr int kBM = kConsumers * kQRows;  // query rows a block
constexpr int kStages = 4;      // K/V ring depth
constexpr int kTileBytes = kBN * kD * 2;     // one K or V tile, 16 KB
constexpr int kQBytes = kQRows * kD * 2;     // one warpgroup's Q tile, 8 KB
constexpr int kSwizzleAtom = 1024;           // 8 rows x 128 B

// ---------------------------------------------------------------- PTX helpers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// returns once the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// one box of the 4-D map at coordinates (d, h, s, b), completion on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int h, int s, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(0), "r"(h), "r"(s), "r"(b), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start, leading and stride
// byte offsets in 16-byte units
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// pins an accumulator's registers in program order around the asynchronous
// wgmma, so no read is hoisted above its wait
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (64x128 f32) (+)= A (64x16, smem, K-major) * B (16x128, smem, K-major)
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t da, uint64_t db,
                                                    int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64x64 f32) += A (64x16 bf16, registers) * B (16x64, smem, MN-major)
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], uint32_t a0, uint32_t a1,
                                                   uint32_t a2, uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

__device__ __forceinline__ float ex2(float x) {  // 2^x on the SFU; ex2(-inf) = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // .x (lo) in the low half
  return *reinterpret_cast<uint32_t*>(&h);
}

// ------------------------------------------------------- consumer building blocks
//
// Accumulator layout of a wgmma m64nN tile (warp w of the warpgroup, lane
// g = lane / 4, t = lane % 4): register i holds row 16w + g + 8 * ((i >> 1) & 1),
// column 8 * (i / 4) + 2t + (i & 1). The A fragment of a k16 step kk from
// registers is the same layout over columns 16kk .. 16kk + 15.

// S = Q K^T over the four 16-wide d steps of one key tile
__device__ __forceinline__ void issue_qk(float (&s)[64], uint32_t q_tile, uint32_t k_tile) {
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk)
    wgmma_m64n128k16_ss(s, smem_desc(q_tile + 32 * kk, 16, kSwizzleAtom),
                        smem_desc(k_tile + 32 * kk, 16, kSwizzleAtom), kk > 0);
  wg_commit();
}

// O += P V over the eight 16-key steps of one key tile; V is MN-major: 16 keys
// are two 1024-byte swizzle atoms (stride byte offset) and the 64 d columns one
// atom wide (the leading byte offset is never stepped; it is set alike)
__device__ __forceinline__ void issue_pv(float (&o)[32], const uint32_t (&p)[32],
                                         uint32_t v_tile) {
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk)
    wgmma_m64n64k16_rs(o, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3],
                       smem_desc(v_tile + 2 * kSwizzleAtom * kk, kSwizzleAtom, kSwizzleAtom));
  wg_commit();
}

// Online softmax of one key tile's scores, in place: masks keys >= S, updates
// the running max m (log2 units) and this thread's share of the running sum
// l, returns the rescale factor of the old O and sum in alpha, and leaves the
// unrounded probabilities exp2(s * scale_log2 - m) in s.
__device__ __forceinline__ void softmax_tile(float (&s)[64], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], int k0, int s_len, int t,
                                             float scale_log2) {
  if (k0 + kBN > s_len) {
#pragma unroll
    for (int i = 0; i < 64; ++i)
      if (k0 + 8 * (i / 4) + 2 * t + (i & 1) >= s_len) s[i] = -INFINITY;
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < 64; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
  float neg_mu[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r] * scale_log2);  // scale > 0: max commutes
    const float mu = m_new == -INFINITY ? 0.f : m_new;    // no -inf - -inf
    alpha[r] = ex2(m[r] - mu);
    m[r] = m_new;
    l[r] *= alpha[r];
    neg_mu[r] = -mu;
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int r = (i >> 1) & 1;
    s[i] = ex2(fmaf(s[i], scale_log2, neg_mu[r]));
    l[r] += s[i];
  }
}

// the probabilities rounded to bf16 pairs: the A fragments of P V
__device__ __forceinline__ void to_bf16(const float (&s)[64], uint32_t (&p)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) p[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
}

// ------------------------------------------------------------------- the kernel

// Q tiles, K and V rings, barriers, alignment slack
constexpr int kSmemBytes =
    kConsumers * kQBytes + 2 * kStages * kTileBytes + 8 * (1 + 3 * kStages) + kSwizzleAtom;

__global__ void __launch_bounds__((kConsumers + 1) * kThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map,
                       __nv_bfloat16* __restrict__ o, int64_t o_sb, int64_t o_ss,
                       int64_t o_sh, int heads, int s_len, float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  // swizzled tiles start on a 1024-byte swizzle atom
  const uint32_t q_s = (smem_u32(smem_raw) + kSwizzleAtom - 1) & ~(uint32_t)(kSwizzleAtom - 1);
  const uint32_t k_s = q_s + kConsumers * kQBytes;
  const uint32_t v_s = k_s + kStages * kTileBytes;
  const uint32_t q_full = v_s + kStages * kTileBytes;
  const uint32_t k_full = q_full + 8;                 // kStages barriers each
  const uint32_t v_full = k_full + 8 * kStages;
  const uint32_t empty = v_full + 8 * kStages;

  const int tid = threadIdx.x, wg = tid / kThreads;
  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const int q0 = blockIdx.x * kBM;
  const int nk = (s_len + kBN - 1) / kBN;

  if (tid == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int i = 0; i < kStages; ++i) {
      mbar_init(k_full + 8 * i, 1);
      mbar_init(v_full + 8 * i, 1);
      mbar_init(empty + 8 * i, kConsumers * 4);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {  // producer warpgroup: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == kConsumers * kThreads) {
      mbar_expect_tx(q_full, kConsumers * kQBytes);
#pragma unroll
      for (int c = 0; c < kConsumers; ++c)
        tma_load(q_s + c * kQBytes, &q_map, q_full, h, q0 + c * kQRows, b);
      for (int j = 0; j < nk; ++j) {
        const int st = j % kStages;
        mbar_wait(empty + 8 * st, ((j / kStages) & 1) ^ 1);  // the first round passes
        mbar_expect_tx(k_full + 8 * st, kTileBytes);
        tma_load(k_s + st * kTileBytes, &k_map, k_full + 8 * st, h, j * kBN, b);
        mbar_expect_tx(v_full + 8 * st, kTileBytes);
        tma_load(v_s + st * kTileBytes, &v_map, v_full + 8 * st, h, j * kBN, b);
      }
    }
  } else {  // consumer warpgroups: 64 query rows each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 160;\n" ::: "memory");
    const int warp = (tid % kThreads) / 32, lane = tid % 32, t = lane & 3;
    const uint32_t q_tile = q_s + wg * kQBytes;

    float o_acc[32], s[64], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];
    uint32_t p[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) o_acc[i] = 0.f;

    mbar_wait(q_full, 0);
    // one key tile at a time: S, then its softmax, then P V
    for (int j = 0; j < nk; ++j) {
      const int st = j % kStages;
      const uint32_t ph = (j / kStages) & 1;
      mbar_wait(k_full + 8 * st, ph);
      issue_qk(s, q_tile, k_s + st * kTileBytes);
      wg_wait_all();
      reg_fence(s);
      softmax_tile(s, m, l, alpha, j * kBN, s_len, t, scale_log2);
#pragma unroll
      for (int i = 0; i < 32; ++i) o_acc[i] *= alpha[(i >> 1) & 1];
      to_bf16(s, p);
      mbar_wait(v_full + 8 * st, ph);
      issue_pv(o_acc, p, v_s + st * kTileBytes);
      wg_wait_all();
      reg_fence(o_acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * st);
    }

    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float li = l[r];
      li += __shfl_xor_sync(0xffffffffu, li, 1);
      li += __shfl_xor_sync(0xffffffffu, li, 2);
      inv[r] = li == 0.f ? 1.f : 1.f / li;
    }
    const int row0 = q0 + wg * kQRows + warp * 16 + (lane >> 2);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= s_len) continue;
      __nv_bfloat16* orow = o + b * o_sb + row * o_ss + h * o_sh;
#pragma unroll
      for (int j = 0; j < kD / 8; ++j)
        *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * t) =
            pack_bf16(o_acc[4 * j + 2 * r] * inv[r], o_acc[4 * j + 2 * r + 1] * inv[r]);
    }
  }
}

// ------------------------------------------------------------------ f32 path

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

// ------------------------------------------------------------------ host side

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(ptr);
  }
  return fn;
}

// a 4-D map (d, h, s, b) of one operand; byte_strides = (h, s, b); boxes of
// box_rows x 64 with the 128-byte swizzle, zeros out of bounds
bool encode_map(CUtensorMap* map, const void* ptr, int64_t batch, int64_t heads, int64_t s_len,
                const int64_t* byte_strides, uint32_t box_rows) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)kD, (cuuint64_t)heads, (cuuint64_t)s_len,
                              (cuuint64_t)batch};
  cuuint64_t strides[3];
  for (int i = 0; i < 3; ++i) {
    if (byte_strides[i] <= 0 || byte_strides[i] % 16 || byte_strides[i] >= (1ll << 40))
      return false;
    strides[i] = (cuuint64_t)byte_strides[i];
  }
  const cuuint32_t box[4] = {(cuuint32_t)kD, 1, box_rows, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// bf16 [B, H, S, 64] q, k, v as strided views: in_strides holds, for q, k and
// v in turn, the byte strides of the h, s and b axes (each a positive multiple
// of 16; the d axis is contiguous), and each base pointer is 16-byte aligned.
// o is written at o + b * o_strides[0] + s * o_strides[1] + h * o_strides[2]
// (elements) + d. 1 <= batch * heads <= 65535, 1 <= s_len < 2^31.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for arguments it does
// not take.
extern "C" int flash_attention_fwd_bf16(const void* q, const void* k, const void* v, void* o,
                                        int64_t batch, int64_t heads, int64_t s_len, int64_t d,
                                        const int64_t* in_strides, const int64_t* o_strides,
                                        float sm_scale, void* stream) {
  if (d != kD || batch < 1 || heads < 1 || batch * heads > 65535 || s_len < 1 ||
      s_len >= (1ll << 31) || !aligned16(q) || !aligned16(k) || !aligned16(v) ||
      !aligned16(o))
    return (int)cudaErrorInvalidValue;
  CUtensorMap qm, km, vm;
  if (!encode_map(&qm, q, batch, heads, s_len, in_strides, kQRows) ||
      !encode_map(&km, k, batch, heads, s_len, in_strides + 3, kBN) ||
      !encode_map(&vm, v, batch, heads, s_len, in_strides + 6, kBN))
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((s_len + kBM - 1) / kBM), (unsigned)(batch * heads));
  flash_fwd_wgmma_kernel<<<grid, (kConsumers + 1) * kThreads, kSmemBytes,
                           static_cast<cudaStream_t>(stream)>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), o_strides[0], o_strides[1], o_strides[2],
      (int)heads, (int)s_len, sm_scale * 1.4426950408889634f);  // scale in log2 units
  return (int)cudaGetLastError();
}

// f32 q, k, v, o contiguous [bh, s_len, d] with d = 64 and 16-byte aligned;
// 1 <= bh <= 65535. Returns cudaGetLastError(), or cudaErrorInvalidValue for
// arguments it does not take.
extern "C" int flash_attention_fwd_f32(const void* q, const void* k, const void* v, void* o,
                                       int64_t bh, int64_t s_len, int64_t d, float sm_scale,
                                       void* stream) {
  if (d != kD || bh < 1 || bh > 65535 || s_len < 1 || !aligned16(q) || !aligned16(k) ||
      !aligned16(v) || !aligned16(o))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((s_len + kThreads - 1) / kThreads), (unsigned)bh);
  flash_fwd_f32_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), s_len, sm_scale);
  return (int)cudaGetLastError();
}
