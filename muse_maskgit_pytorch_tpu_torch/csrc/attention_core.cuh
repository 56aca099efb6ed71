// One flash-attention core for Hopper (sm_90a), bf16 inputs, forward only:
// the bf16 paths of K4 (`flash_attention.cu`, the plain attention behind
// `ops.attend`) and of K2 (`qknorm_attention.cu`, the models' fused qk-norm
// attention with a learned null key/value) are this kernel with two
// template arguments.
//
// Arithmetic, as the TPU kernels do it (`_flash_kernel`, `_qknorm_kernel` in
// muse_maskgit_pytorch_tpu/ops/attention.py): the queries are scaled (K4:
// q * scale) or l2-normalised and scaled in f32 (K2: q / |q| * q_scale *
// scale, k / |k| * k_scale, eps 1e-12 inside the rsqrt) and rounded to bf16
// once; S = Q K^T is one bf16 x bf16 product with f32 accumulation; P =
// exp(S - running max) is rounded to bf16 before P V, another bf16 product
// with f32 accumulation; the softmax statistics and the output accumulator
// stay f32. K2's null key scores s0 = f32(q^) . nk^ in f32 and seeds the
// online softmax (m0 = s0, l0 = 1, acc0 = nv). Under a gradient K2 also
// writes each row's logsumexp m + log(l), null included, for its backward
// (`qknorm_attention_bwd.cu`); K4 and K2's inference route pass no LSE. Keys past m score -inf, so a
// ragged last tile never counts (K4's fully masked row is the mean of v over
// its m real keys, as `xla_attention` defines it).
//
// What bounds it on the H100: at the models' shapes (d 64, 64-1025 keys) the
// bytes: one read of q, k, v and one write of the output against 4 n m d
// FLOP, which the tensor cores do at 989 TFLOP/s bf16 -- above 295 FLOP per
// byte only from about 600 keys on. Design: a block takes 128 queries of one
// (batch, head): two consumer warpgroups of 64 query rows each and one
// producer warp.
//   * Q^ is staged once in shared memory, in the 128-byte (d 64) or 64-byte
//     (d 32) swizzled K-major layout that `wgmma` reads.
//   * The producer warp streams K and V in 64-key tiles through a 3-stage
//     ring with TMA (`cp.async.bulk.tensor`, completion on an mbarrier per
//     stage; consumers release a stage through a second mbarrier), so the
//     next tiles load while this one is multiplied. The TMA descriptors
//     carry the callers' strides (K2's k and v are column slices of one
//     `to_kv` output) and zero-fill rows past m. It stages each tile's 64
//     key biases (0 or -1e30 from the mask, -inf past m) beside it.
//   * S = Q^ K^T: `wgmma` m64n64k16, A and B from shared memory (K-major).
//     P stays in registers: its f32 accumulator fragments are the bf16 A
//     fragments of P V, which reads V from shared memory MN-major
//     (`wgmma` m64n{64,32}k16, B transposed), straight from the TMA tile.
//   * K2's prologue: each raw K tile is l2-normalised and scaled in f32 by
//     the two consumer warpgroups, in place, and written back as bf16 into
//     the layout the B descriptor reads (one named barrier per tile).
//   * About 66 KB of shared memory and 288 threads: two blocks per SM.
//     Occupancy is not what bounds it: on K2, the models' kernel, variants
//     with one consumer warpgroup per block, two ring stages or more blocks
//     per SM timed the same or slower (three blocks of two warpgroups spill
//     registers and take 3-4x as long); one warpgroup with two stages was a
//     few percent faster on K4 only (PERF.md, PR 3).

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the driver entry point is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace attention_core {

constexpr int WGS = 2;         // consumer warpgroups
constexpr int BQ = 64 * WGS;   // queries per block
constexpr int BK = 64;         // keys per kv tile
constexpr int STAGES = 3;      // K/V ring depth
constexpr int MIN_BLOCKS = 2;  // blocks per SM, for the register budget
constexpr int CONSUMERS = 128 * WGS;
constexpr int THREADS = CONSUMERS + 32;  // and one producer warp
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  const __nv_bfloat16* q;
  __nv_bfloat16* out;
  const float* bias;         // (B, m) f32 or null
  const __nv_bfloat16* nk;   // K2: (H, D) null key / value
  const __nv_bfloat16* nv;
  const float* q_scale;      // K2: (D,) learned scales
  const float* k_scale;
  float* lse;                // K2 under a gradient: (B, H, n) f32 row logsumexp, or null
  long long q_sb, q_sh, q_sn;  // element strides of q over batch, head, row
  long long o_sb, o_sh, o_sn;  // and of the output
  int n, m, H;
  // TMA coordinates of kv tile kv0 of (b, h): {h * c0_h, kv0, b * c2_b + h * c2_h}
  int c0_h, c2_b, c2_h;
  float scale;
};

// shared memory of one block, byte offsets from a 1024-aligned base
template <int D>
struct Smem {
  static constexpr int ROWB = D * 2;         // bytes of one bf16 row: the swizzle width
  static constexpr int TILE = BK * ROWB;     // one K or V tile
  static constexpr int Q_OFF = 0;            // [BQ][D] bf16, swizzled
  static constexpr int K_OFF = BQ * ROWB;    // [STAGES][BK][D]
  static constexpr int V_OFF = K_OFF + STAGES * TILE;
  static constexpr int BIAS_OFF = V_OFF + STAGES * TILE;      // [STAGES][BK] f32
  static constexpr int BAR_OFF = BIAS_OFF + STAGES * BK * 4;  // full[STAGES], empty[STAGES]
  static constexpr int VEC_OFF = BAR_OFF + 2 * STAGES * 8;    // qsc, ksc, nkh, nvs [D]; s0 [BQ]
  static constexpr int BYTES = VEC_OFF + (4 * D + BQ) * 4;
  static constexpr int ALLOC = BYTES + 1024;  // slack to align the base
};

// -- PTX wrappers ---------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

// wait until the phase of parity `parity` has completed (built with
// -DATTENTION_CORE_WATCHDOG, a wait of more than about ten seconds traps, so
// a pipeline fault becomes a launch error instead of a hung card)
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
#ifdef ATTENTION_CORE_WATCHDOG
  const long long t0 = clock64();
#endif
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
#ifdef ATTENTION_CORE_WATCHDOG
    if (!done && clock64() - t0 > 20000000000ll) __trap();
#endif
  }
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void named_barrier(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// generic-proxy shared stores become visible to wgmma (the async proxy)
__device__ __forceinline__ void fence_async_smem() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait_all() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

// keep the compiler from moving accesses of an accumulator across a wgmma
template <int N>
__device__ __forceinline__ void fence_operands(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// byte offset of 16-byte chunk `c` of row `r` in a swizzled tile whose rows
// are ROWB bytes (128: Swizzle<3,4,3>, 64: Swizzle<2,4,3>), as TMA writes it
template <int ROWB>
__device__ __forceinline__ int swz(int r, int c) {
  constexpr int mask = ROWB / 16 - 1;
  return r * ROWB + ((c ^ ((r * ROWB >> 7) & mask)) << 4);
}

// wgmma shared-memory descriptors (start >> 4 in bits 0-13, leading byte
// offset >> 4 in 16-29, stride byte offset >> 4 in 32-45, swizzle in 62-63:
// 1 = 128B, 2 = 64B)
template <int ROWB>
__device__ __forceinline__ uint64_t desc_(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  constexpr uint64_t layout = ROWB == 128 ? 1 : 2;
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (layout << 62);
}
// K-major: rows of ROWB bytes along K, 8-row groups ROWB * 8 apart
template <int ROWB>
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t addr) {
  return desc_<ROWB>(addr, 16, ROWB * 8);
}
// MN-major: each K row holds ROWB bytes of N (one swizzle atom wide); groups
// of 8 K rows ROWB * 8 apart
template <int ROWB>
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t addr) {
  return desc_<ROWB>(addr, BK * ROWB, ROWB * 8);
}

// d (64 x 64, f32) (+)= A (64 x 16, smem, K-major) B (16 x 64, smem, K-major)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x N, f32) += A (64 x 16, bf16 registers) B (16 x N, smem, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void unpack8(const uint4& u, float* x) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float* x) {
  return make_uint4(pack_bf16(x[0], x[1]), pack_bf16(x[2], x[3]), pack_bf16(x[4], x[5]), pack_bf16(x[6], x[7]));
}

// -- the kernel -----------------------------------------------------------------

// D: head dim (32 or 64). QKNORM: K2 (l2-norms, learned scales, null key and
// value) or K4 (q * scale).
template <int D, bool QKNORM>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
flash_core_kernel(const __grid_constant__ CUtensorMap tmap_k, const __grid_constant__ CUtensorMap tmap_v,
                  const Params p) {
  using L = Smem<D>;
  constexpr int ROWB = L::ROWB;
  constexpr int CPR = D / 8;  // 16-byte chunks per row
  static_assert(D == 32 || D == 64, "head dim 32 or 64");
  static_assert(!QKNORM || D == 64, "the qk-norm path is built for head dim 64");

  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sbase = smem_u32(smem);
  float* bias_s = reinterpret_cast<float*>(smem + L::BIAS_OFF);
  float* qsc = reinterpret_cast<float*>(smem + L::VEC_OFF);
  float* ksc = qsc + D;
  float* nkh = ksc + D;
  float* nvs = nkh + D;
  float* s0s = nvs + D;
  const uint32_t full0 = sbase + L::BAR_OFF, empty0 = full0 + 8 * STAGES;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int h = blockIdx.y, b = blockIdx.z;
  const int ntiles = (p.m + BK - 1) / BK;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 32);                 // every producer lane arrives
      mbar_init(empty0 + 8 * s, CONSUMERS / 32);    // lane 0 of every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (QKNORM && tid < D) {
    qsc[tid] = p.q_scale[tid] * p.scale;
    ksc[tid] = p.k_scale[tid];
  }
  __syncthreads();
  if (QKNORM && warp == 0) {  // the null key, normalised and scaled in f32
    float a[D / 32], ss = 0.0f;
#pragma unroll
    for (int i = 0; i < D / 32; ++i) {
      a[i] = __bfloat162float(p.nk[h * D + lane + 32 * i]);
      ss += a[i] * a[i];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    const float r = rsqrtf(ss + 1e-12f);
#pragma unroll
    for (int i = 0; i < D / 32; ++i) {
      const int c = lane + 32 * i;
      nkh[c] = a[i] * r * ksc[c];
      nvs[c] = __bfloat162float(p.nv[h * D + c]);
    }
  }
  __syncthreads();

  if (warp == CONSUMERS / 32) {
    // -- producer warp: K/V tiles by TMA, the tile's key biases by hand
    const int c0 = h * p.c0_h, c2 = b * p.c2_b + h * p.c2_h;
    const float* brow = p.bias ? p.bias + static_cast<long long>(b) * p.m : nullptr;
    for (int i = 0; i < ntiles; ++i) {
      const int s = i % STAGES;
      mbar_wait(empty0 + 8 * s, ((i / STAGES) & 1) ^ 1);
      float* bs = bias_s + s * BK;
#pragma unroll
      for (int j = lane; j < BK; j += 32) {
        const int key = i * BK + j;
        bs[j] = key < p.m ? (brow ? brow[key] : 0.0f) : -INFINITY;
      }
      if (lane == 0) {
        mbar_arrive_tx(full0 + 8 * s, 2 * L::TILE);
        tma_load_3d(sbase + L::K_OFF + s * L::TILE, &tmap_k, full0 + 8 * s, c0, i * BK, c2);
        tma_load_3d(sbase + L::V_OFF + s * L::TILE, &tmap_v, full0 + 8 * s, c0, i * BK, c2);
      } else {
        mbar_arrive(full0 + 8 * s);
      }
    }
    return;
  }

  // -- consumer warpgroups: 64 query rows each
  const int wg = warp >> 2, wt = tid & 127;
  const int qr0 = blockIdx.x * BQ + wg * 64;  // first query row of this warpgroup
  const uint32_t qaddr = sbase + L::Q_OFF + wg * 64 * ROWB;
  {
    // Q^ into shared memory: two threads per row, half a row each
    constexpr int CH = CPR / 2;
    unsigned char* qs = smem + L::Q_OFF + wg * 64 * ROWB;
    const int r = wt >> 1, half = wt & 1, qi = qr0 + r;
    float x[CH * 8];
    if (qi < p.n) {
      const __nv_bfloat16* src = p.q + b * p.q_sb + h * p.q_sh + qi * p.q_sn + half * CH * 8;
#pragma unroll
      for (int c = 0; c < CH; ++c) unpack8(*reinterpret_cast<const uint4*>(src + c * 8), x + c * 8);
    } else {
#pragma unroll
      for (int e = 0; e < CH * 8; ++e) x[e] = 0.0f;
    }
    if (QKNORM) {
      float ss = 0.0f;
#pragma unroll
      for (int e = 0; e < CH * 8; ++e) ss += x[e] * x[e];
      ss += __shfl_xor_sync(0xffffffffu, ss, 1);
      const float rr = rsqrtf(ss + 1e-12f);
#pragma unroll
      for (int e = 0; e < CH * 8; ++e) x[e] = x[e] * rr * qsc[half * CH * 8 + e];
    } else {
#pragma unroll
      for (int e = 0; e < CH * 8; ++e) x[e] *= p.scale;
    }
    float s0 = 0.0f;
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const uint4 u = pack8(x + c * 8);
      *reinterpret_cast<uint4*>(qs + swz<ROWB>(r, half * CH + c)) = u;
      if (QKNORM) {  // the null score from the rounded q^, in f32
        float xr[8];
        unpack8(u, xr);
#pragma unroll
        for (int e = 0; e < 8; ++e) s0 += xr[e] * nkh[(half * CH + c) * 8 + e];
      }
    }
    if (QKNORM) {
      s0 += __shfl_xor_sync(0xffffffffu, s0, 1);
      if (half == 0) s0s[wg * 64 + r] = s0;
    }
    fence_async_smem();
    named_barrier(2 + wg, 128);
  }

  // accumulator fragment of this thread: rows rw and rw + 8 of the
  // warpgroup, columns 8 j + 2 t + {0, 1}
  const int g = lane >> 2, t = lane & 3;
  const int rw = (warp & 3) * 16 + g;
  float m_r[2], l_r[2], o[D / 2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    m_r[i] = QKNORM ? s0s[wg * 64 + rw + 8 * i] : -INFINITY;
    l_r[i] = (QKNORM && t == 0) ? 1.0f : 0.0f;  // per-thread partial sums; the null's 1 counted once
  }
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[4 * j + e] = QKNORM ? nvs[8 * j + 2 * t + (e & 1)] : 0.0f;
  }

  for (int i = 0; i < ntiles; ++i) {
    const int s = i % STAGES;
    mbar_wait(full0 + 8 * s, (i / STAGES) & 1);
    const uint32_t kaddr = sbase + L::K_OFF + s * L::TILE;
    const uint32_t vaddr = sbase + L::V_OFF + s * L::TILE;
    if (QKNORM) {
      // k^ in place: the consumers share the tile's rows, TPR threads per row
      constexpr int TPR = CONSUMERS / BK;
      constexpr int CH = CPR / TPR;
      unsigned char* kt = smem + L::K_OFF + s * L::TILE;
      const int r = tid / TPR, part = tid % TPR;
      float x[CH * 8];
#pragma unroll
      for (int c = 0; c < CH; ++c) unpack8(*reinterpret_cast<const uint4*>(kt + swz<ROWB>(r, part * CH + c)), x + c * 8);
      float ss = 0.0f;
#pragma unroll
      for (int e = 0; e < CH * 8; ++e) ss += x[e] * x[e];
#pragma unroll
      for (int o = 1; o < TPR; o <<= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
      const float rr = rsqrtf(ss + 1e-12f);
#pragma unroll
      for (int e = 0; e < CH * 8; ++e) x[e] = x[e] * rr * ksc[part * CH * 8 + e];
#pragma unroll
      for (int c = 0; c < CH; ++c) *reinterpret_cast<uint4*>(kt + swz<ROWB>(r, part * CH + c)) = pack8(x + c * 8);
      fence_async_smem();
      named_barrier(1, CONSUMERS);
    }

    // S = Q^ K^T (64 rows x 64 keys per warpgroup)
    float sc[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) sc[e] = 0.0f;
    fence_operands(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(sc, desc_kmajor<ROWB>(qaddr + kk * 32), desc_kmajor<ROWB>(kaddr + kk * 32), kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_operands(sc);

    // key bias, then the online softmax update of rows rw (i = 0), rw + 8 (i = 1)
    const float* bs = bias_s + s * BK;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float b0 = bs[8 * j + 2 * t], b1 = bs[8 * j + 2 * t + 1];
      sc[4 * j] += b0;
      sc[4 * j + 1] += b1;
      sc[4 * j + 2] += b0;
      sc[4 * j + 3] += b1;
    }
#pragma unroll
    for (int ii = 0; ii < 2; ++ii) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * ii], sc[4 * j + 2 * ii + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_r[ii], mx);
      const float alpha = exp2f((m_r[ii] - m_new) * LOG2E);
      m_r[ii] = m_new;
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float pe = exp2f((sc[4 * j + 2 * ii + e] - m_new) * LOG2E);
          sc[4 * j + 2 * ii + e] = pe;
          rs += pe;
        }
      }
      l_r[ii] = l_r[ii] * alpha + rs;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j + 2 * ii] *= alpha;
        o[4 * j + 2 * ii + 1] *= alpha;
      }
    }

    // O += P V: the score fragments of keys 16 kc .. 16 kc + 15 are the bf16
    // A fragment of step kc
    uint32_t pa[4][4];
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
#pragma unroll
      for (int e = 0; e < 4; ++e) pa[kc][e] = pack_bf16(sc[8 * kc + 2 * e], sc[8 * kc + 2 * e + 1]);
    }
    fence_operands(o);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) wgmma_rs(o, pa[kc], desc_mnmajor<ROWB>(vaddr + kc * 16 * ROWB));
    wgmma_commit();
    wgmma_wait_all();
    fence_operands(o);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * s);
  }

#pragma unroll
  for (int ii = 0; ii < 2; ++ii) {
    float l = l_r[ii];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.0f / l;
    const int qi = qr0 + rw + 8 * ii;
    if (qi < p.n) {
      __nv_bfloat16* dst = p.out + b * p.o_sb + h * p.o_sh + qi * p.o_sn + 2 * t;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(dst + 8 * j) = pack_bf16(o[4 * j + 2 * ii] * inv, o[4 * j + 2 * ii + 1] * inv);
      if (p.lse != nullptr && t == 0) p.lse[(static_cast<long long>(b) * p.H + h) * p.n + qi] = m_r[ii] + logf(l);
    }
  }
}

// -- host side --------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, a driver API call, fetched through the runtime so
// the library needs no link against libcuda
inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    return (e == cudaSuccess && found == cudaDriverEntryPointSuccess) ? reinterpret_cast<EncodeTiledFn>(ptr) : nullptr;
  }();
  return fn;
}

// A 3-D bf16 view {dim0 (contiguous), dim1, dim2} with element strides
// stride1 and stride2, read in boxes of {D, BK, 1} into the swizzled layout
// of Smem<D>; rows past dim1 are zero-filled.
inline cudaError_t make_kv_map(CUtensorMap* map, const void* base, int D, long long dim0, long long dim1,
                               long long dim2, long long stride1, long long stride2) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(dim0), static_cast<cuuint64_t>(dim1),
                              static_cast<cuuint64_t>(dim2)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(stride1 * 2), static_cast<cuuint64_t>(stride2 * 2)};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(D), BK, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides, box,
                            unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            D == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int D, bool QKNORM>
cudaError_t launch(const CUtensorMap& tmap_k, const CUtensorMap& tmap_v, const Params& p, int B, cudaStream_t stream) {
  const cudaError_t e = cudaFuncSetAttribute(flash_core_kernel<D, QKNORM>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<D>::ALLOC);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.n + BQ - 1) / BQ, p.H, B);
  flash_core_kernel<D, QKNORM><<<grid, THREADS, Smem<D>::ALLOC, stream>>>(tmap_k, tmap_v, p);
  return cudaGetLastError();
}

}  // namespace attention_core
