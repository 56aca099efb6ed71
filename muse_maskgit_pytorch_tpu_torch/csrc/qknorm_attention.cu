// Fused qk-l2norm attention with a learned null key/value per head, for
// Hopper (sm_90a). The forward; under a gradient it also writes each row's
// logsumexp, which the backward (`qknorm_attention_bwd.cu`) reads.
//
// Replaces the TPU kernel `_qknorm_kernel` in
// muse_maskgit_pytorch_tpu/ops/attention.py (Pallas). From the RAW
// projections q (b, n, h, d) and k, v (b, m, h, d), read through their
// strides (k and v are column slices of one to_kv output, so no transpose
// and no null-KV concat is materialised), it computes per (batch, head):
//   q^ = q / sqrt(|q|^2 + 1e-12) * q_scale * scale,  k^ = k / ... * k_scale,
//   the null key normalised the same way and always attendable,
//   an additive key bias (0 or -1e30 from the context mask),
//   softmax([q^ . nk^, q^ k^T + bias]) [nv; v].
//
// What bounds it on the H100: at the main path's shapes (d 64, kv 256 or 64)
// in bf16 the bytes, one read of q, k, v and one write of the output, against
// 4*n*m*d FLOP that the tensor cores do faster; in f32, on the CUDA cores
// (no TF32), the 4*n*m*d FLOP at 67 TFLOP/s. The online softmax is seeded
// with the null position (m0 = s0, l0 = 1, acc0 = nv), so no kv length limit
// exists and nothing but q, k, v and the output touches global memory. Norms
// and softmax statistics are f32. Two kernels:
//   * bf16 inputs (the models' path): the Hopper core of
//     `attention_core.cuh`, shared with K4, with the TPU kernel's roundings
//     (q^ and k^ to bf16 after the f32 norm and scale, P to bf16 before
//     P v): TMA ring of raw K/V tiles fed by a producer warp, each K tile
//     normalised in place once per block, `wgmma` for both products.
//   * f32 inputs (the models' default dtype): `qknorm_fwd_f32`, IEEE f32 FMA
//     on the CUDA cores, a block per (128 queries, head, batch) of 128
//     threads, two blocks an SM; each thread holds 8 x 8 tiles of S and of
//     P v, so every shared float4 it reads feeds 32 FMAs. Raw k and v stream
//     by cp.async, a tile's load under half a tile of products; each thread
//     normalises the k rows its own copies brought, in place, before the
//     barrier that shows the tile, so k^ is rounded as the plain version
//     rounds it (folding 1 / |k| into the scores instead was faster, but
//     its other rounding turned an f32 decode's remasking order, which
//     `chip_smoke.py` [parity] holds to the plain path's). The online
//     softmax runs in base 2 (ex2.approx); a tile whose keys are all masked
//     is skipped. The loops over d and over the keys are unrolled twice, not
//     fully: fully unrolled the kernel is about 12k instructions and runs
//     far slower (the instruction cache, by every sign).

#include <cuda_runtime.h>
#include <math.h>

#include "attention_core.cuh"

namespace {

namespace ac = attention_core;

constexpr int D = 64;            // head dim
constexpr int FQ = 128;          // f32: queries a block
constexpr int FT = 128;          // f32: threads, each 8 queries x 8 keys (S) and 8 queries x 8 dims (P v)
constexpr int KT = 64;           // keys a tile
constexpr int RP = D + 4;        // padded row of q^ and k: 8 rows read at once fill the 32 banks
constexpr int PP = KT + 8;       // padded row of P: the four rows a warp stores at once are 8 banks apart
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr float MASKED = -1e30f;  // a key bias at or below this adds exactly 0 to the softmax

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
// reductions over the 8 lanes that share a row (lanes 8r..8r + 7)
__device__ __forceinline__ float max8(float v) {
  for (int o = 4; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float sum8(float v) {
  for (int o = 4; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ void st4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
// global -> shared, asynchronously, 16 or 4 bytes; zero-filled when !valid
__device__ __forceinline__ void cp16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(valid ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// -- f32 inputs: CUDA-core kernel ---------------------------------------------

struct F32Params {
  const float *q, *k, *v, *nk, *nv, *q_scale, *k_scale, *bias;
  float *out, *lse;
  int n, m, H;
  long long q_sb, q_sn, k_sb, k_sm, v_sb, v_sm;
  float scale;
};

// shared memory of `qknorm_fwd_f32`, in floats, each region 16-byte aligned:
// 107,008 bytes, two blocks an SM
struct F32Smem {
  static constexpr int Q = 0;               // [FQ][RP] q^ = q / |q| q_scale scale
  static constexpr int P = Q + FQ * RP;     // [FQ][PP] the tile's exp2(x - row max)
  static constexpr int K = P + FQ * PP;     // [KT][RP] the tile's k, raw, then k^ = k / |k| k_scale
  static constexpr int V = K + KT * RP;     // [KT][D] its v
  static constexpr int B = V + KT * D;      // [KT] its key bias as given
  static constexpr int KB = B + KT;         // [KT] its bias log2e, -inf past m
  static constexpr int NK = KB + KT;        // [D] nk^
  static constexpr int NV = NK + D;         // [D] nv
  static constexpr int S0 = NV + D;         // [FQ] the null score, base 2
  static constexpr int BYTES = (S0 + FQ) * 4;
};

// A block per (128 queries, head, batch), 128 threads, two blocks an SM.
// Each thread holds an 8 x 8 tile of both products, so every float4 of an
// operand it reads from shared memory feeds 32 FMAs (the 8 lanes that share
// a row read the same q^ / P float4, each k / v float4 one wavefront for
// the 8 of them): S for queries qg + 16 i and keys kl + 8 j (i, j < 8),
// each operand read as float4 along d from row-major tiles (no transposed
// copy); then P v for the same queries and dims 4 kl..4 kl + 3 and
// 32 + 4 kl..32 + 4 kl + 3. A warp's lanes are 4 query rows x 8 columns.
// q^ stays in shared memory. Raw k (with the key bias) and v arrive by
// cp.async into one buffer each, in turns: k of tile t + 1 as soon as S of
// tile t is done, v of tile t as soon as P v of tile t - 1 is (tile 0's
// with q), so each load runs under half a tile of products. A thread
// normalises the k rows its own copies brought (visible to it at its own
// cp.async wait), the 16 lanes that copied a row summing its squares by
// shuffles, before the barrier that shows the tile: no barrier of its own.
// The online softmax runs in base 2, x = (q^ . k^ + bias) log2e, from the
// null position (m0 = s0, l0 = 1, acc0 = nv); the row max is shuffled over
// the row's 8 lanes, the row sum kept per lane and summed at the end. A
// tile whose keys are all masked (bias <= -1e30, which adds exactly 0 to
// every row) is skipped. Three barriers a tile: k in, S done, P and v in.
__global__ void __launch_bounds__(FT, 2) qknorm_fwd_f32(const F32Params p) {
  using S = F32Smem;
  extern __shared__ __align__(16) float fs[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int kl = lane & 7, qg = 4 * warp + (lane >> 3);
  const int q0 = blockIdx.x * FQ, h = blockIdx.y, b = blockIdx.z;
  const int n = p.n, m = p.m, nkt = (m + KT - 1) / KT;

  // 64 rows of D floats at src (row stride `stride`) into dst (row stride
  // `dst_stride`); rows >= rows zero
  auto rows_async = [&](float* dst, int dst_stride, const float* src, long long stride, int rows) {
    const uint32_t s = ac::smem_u32(dst);
#pragma unroll
    for (int it = 0; it < KT * D / 4 / FT; ++it) {
      const int c = tid + it * FT, r = c >> 4, ch = 4 * (c & 15);
      cp16(s + (r * dst_stride + ch) * 4, src + (r < rows ? r : 0) * stride + ch, r < rows);
    }
  };
  auto load_k = [&](int t) {  // tile t's raw k and key bias
    const int key0 = t * KT, rows = min(KT, m - key0);
    rows_async(fs + S::K, RP, p.k + b * p.k_sb + key0 * p.k_sm + h * D, p.k_sm, rows);
    if (p.bias != nullptr && tid < KT)
      cp4(ac::smem_u32(fs + S::B + tid), p.bias + (long long)b * m + key0 + min(tid, rows - 1), tid < rows);
  };
  auto load_v = [&](int t) {
    const int key0 = t * KT;
    rows_async(fs + S::V, D, p.v + b * p.v_sb + key0 * p.v_sm + h * D, p.v_sm, min(KT, m - key0));
  };

  {  // the block's raw q rows into the q^ buffer, with tile 0's k; rows past n zero
    const float* qp = p.q + b * p.q_sb + (long long)q0 * p.q_sn + h * D;
    const int rows = min(FQ, n - q0);
    rows_async(fs + S::Q, RP, qp, p.q_sn, rows);
    rows_async(fs + S::Q + KT * RP, RP, rows > KT ? qp + KT * p.q_sn : qp, p.q_sn, rows - KT);
  }
  if (nkt > 0) load_k(0);
  cp_commit();
  if (nkt > 0) load_v(0);
  cp_commit();
  if (warp == 0) {  // nk^ = nk / |nk| k_scale, and nv
    const float a0 = p.nk[h * D + lane], a1 = p.nk[h * D + lane + 32];
    const float r = rsqrtf(warp_sum(a0 * a0 + a1 * a1) + 1e-12f);
    fs[S::NK + lane] = a0 * r * p.k_scale[lane];
    fs[S::NK + lane + 32] = a1 * r * p.k_scale[lane + 32];
    fs[S::NV + lane] = p.nv[h * D + lane];
    fs[S::NV + lane + 32] = p.nv[h * D + lane + 32];
  }
  cp_wait<1>();  // q and tile 0's k
  __syncthreads();
  {  // q^ = q / |q| (q_scale scale) in place; s0 = q^ . nk^ log2e
    float qs[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) qs[e] = p.q_scale[(e < 4 ? 4 * kl : 28 + 4 * kl) + e] * p.scale;
    const float4 na = ld4(fs + S::NK + 4 * kl), nb = ld4(fs + S::NK + 32 + 4 * kl);
    const float nk8[8] = {na.x, na.y, na.z, na.w, nb.x, nb.y, nb.z, nb.w};
#pragma unroll 2
    for (int r = qg; r < FQ; r += 16) {
      float* row = fs + S::Q + r * RP + 4 * kl;
      const float4 xa = ld4(row), xb = ld4(row + 32);
      const float x[8] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
      float ss = 0.0f;
#pragma unroll
      for (int e = 0; e < 8; ++e) ss = fmaf(x[e], x[e], ss);
      const float rq = rsqrtf(sum8(ss) + 1e-12f);
      float hq[8], s0 = 0.0f;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        hq[e] = x[e] * rq * qs[e];
        s0 = fmaf(hq[e], nk8[e], s0);
      }
      s0 = sum8(s0);
      st4(row, hq[0], hq[1], hq[2], hq[3]);
      st4(row + 32, hq[4], hq[5], hq[6], hq[7]);
      if (kl == 0) fs[S::S0 + r] = s0 * LOG2E;
    }
  }

  // the online softmax state of rows qg + 16 i, seeded with the null position;
  // the row sum per lane (the null's 1 on the row's first lane)
  float mrow[8], lrow[8], acc[8][8];
  const float* qrow = fs + S::Q + qg * RP;
  float* prow = fs + S::P + qg * PP;
  const int kc = 4 * (tid & 15);  // the dims of each k row this thread copies
  const float ks4[4] = {p.k_scale[kc], p.k_scale[kc + 1], p.k_scale[kc + 2], p.k_scale[kc + 3]};
  for (int t = 0; t <= nkt; ++t) {
    if (t > 0) cp_wait<0>();  // k of tile t (tile 0's came with q)
    if (t < nkt) {
      // k^ = k / |k| k_scale in place, before the barrier that shows it: each
      // thread takes the 16 bytes of 8 rows its own copies brought, the 16
      // lanes that copied a row sum its squares; and its key's bias log2e
      float4 xs[KT * D / 4 / FT];
      float ss[KT * D / 4 / FT];
#pragma unroll
      for (int it = 0; it < KT * D / 4 / FT; ++it) {
        xs[it] = ld4(fs + S::K + ((tid + it * FT) >> 4) * RP + kc);
        ss[it] = xs[it].x * xs[it].x + xs[it].y * xs[it].y + xs[it].z * xs[it].z + xs[it].w * xs[it].w;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
#pragma unroll
        for (int it = 0; it < KT * D / 4 / FT; ++it) ss[it] += __shfl_xor_sync(0xffffffffu, ss[it], o);
#pragma unroll
      for (int it = 0; it < KT * D / 4 / FT; ++it) {
        const float rk = rsqrtf(ss[it] + 1e-12f);
        const float4 x = xs[it];
        st4(fs + S::K + ((tid + it * FT) >> 4) * RP + kc, x.x * rk * ks4[0], x.y * rk * ks4[1], x.z * rk * ks4[2],
            x.w * rk * ks4[3]);
      }
      if (tid < KT)
        fs[S::KB + tid] = t * KT + tid < m ? (p.bias != nullptr ? fs[S::B + tid] * LOG2E : 0.0f) : -INFINITY;
    }
    // whether any key of tile t takes part: each of the first 64 threads
    // reads the bias its own copy brought
    const bool on = t < nkt && tid < KT && t * KT + tid < m && (p.bias == nullptr || fs[S::B + tid] > MASKED);
    const bool any_on = __syncthreads_or(on);
    if (t == 0) {  // after the barrier that shows q^ and s0
      const float4 va = ld4(fs + S::NV + 4 * kl), vb = ld4(fs + S::NV + 32 + 4 * kl);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        mrow[i] = fs[S::S0 + qg + 16 * i];
        lrow[i] = kl == 0 ? 1.0f : 0.0f;
        acc[i][0] = va.x, acc[i][1] = va.y, acc[i][2] = va.z, acc[i][3] = va.w;
        acc[i][4] = vb.x, acc[i][5] = vb.y, acc[i][6] = vb.z, acc[i][7] = vb.w;
      }
    }
    if (t == nkt) break;
    if (!any_on) {  // every key masked: the state stays as it is
      if (t + 1 < nkt) load_k(t + 1);
      cp_commit();
      continue;
    }
    if (t > 0) load_v(t);
    cp_commit();
    // S = q^ k^T: keys kl + 8 j
    float s[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.0f;
    const float* krow = fs + S::K + kl * RP;
#pragma unroll 2
    for (int d0 = 0; d0 < D; d0 += 4) {
      float4 kv[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) kv[j] = ld4(krow + 8 * j * RP + d0);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 qv = ld4(qrow + 16 * i * RP + d0);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          s[i][j] = fmaf(qv.x, kv[j].x, fmaf(qv.y, kv[j].y, fmaf(qv.z, kv[j].z, fmaf(qv.w, kv[j].w, s[i][j]))));
      }
    }
    __syncthreads();  // k and the bias read for the last time
    if (t + 1 < nkt) load_k(t + 1);
    cp_commit();

    // base 2: x = S log2e + bias log2e; online softmax; P to shared memory
    float kb[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) kb[j] = fs[S::KB + kl + 8 * j];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] = fmaf(s[i][j], LOG2E, kb[j]);
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(mrow[i], max8(mx));
      const float alpha = ex2(mrow[i] - m_new);
      mrow[i] = m_new;
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float e = ex2(s[i][j] - m_new);
        prow[16 * i * PP + kl + 8 * j] = e;
        rs += e;
      }
      lrow[i] = fmaf(lrow[i], alpha, rs);
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[i][c] *= alpha;
    }
    cp_wait<1>();  // v of tile t
    __syncthreads();

    // acc += P v: dims 4 kl + c and 32 + 4 kl + c
    const float* vcol = fs + S::V + 4 * kl;
#pragma unroll 2
    for (int j0 = 0; j0 < KT; j0 += 4) {
      float4 va[4], vb[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        va[j] = ld4(vcol + (j0 + j) * D);
        vb[j] = ld4(vcol + (j0 + j) * D + 32);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 pv = ld4(prow + 16 * i * PP + j0);
        const float pw[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][0] = fmaf(pw[j], va[j].x, acc[i][0]);
          acc[i][1] = fmaf(pw[j], va[j].y, acc[i][1]);
          acc[i][2] = fmaf(pw[j], va[j].z, acc[i][2]);
          acc[i][3] = fmaf(pw[j], va[j].w, acc[i][3]);
          acc[i][4] = fmaf(pw[j], vb[j].x, acc[i][4]);
          acc[i][5] = fmaf(pw[j], vb[j].y, acc[i][5]);
          acc[i][6] = fmaf(pw[j], vb[j].z, acc[i][6]);
          acc[i][7] = fmaf(pw[j], vb[j].w, acc[i][7]);
        }
      }
    }
  }

  // out = acc / l, 16 bytes a lane twice; lse = m ln 2 + log l in nats
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int qi = q0 + qg + 16 * i;
    const float l = sum8(lrow[i]);
    if (qi < n) {
      const float inv = 1.0f / l;
      float* o = p.out + (((long long)b * n + qi) * p.H + h) * D + 4 * kl;
      st4(o, acc[i][0] * inv, acc[i][1] * inv, acc[i][2] * inv, acc[i][3] * inv);
      st4(o + 32, acc[i][4] * inv, acc[i][5] * inv, acc[i][6] * inv, acc[i][7] * inv);
      if (p.lse != nullptr && kl == 0) p.lse[((long long)b * p.H + h) * n + qi] = fmaf(mrow[i], LN2, logf(l));
    }
  }
}

// bf16 through the Hopper core: k, v as 3-D views {H * D, m, B} with the
// callers' batch and sequence strides
cudaError_t launch_bf16(const void* q, const void* k, const void* v, const void* nk, const void* nv,
                        const void* qs, const void* ks, const void* bias, void* out, void* lse, int B, int n,
                        int m, int H, long long q_sb, long long q_sn, long long k_sb, long long k_sm,
                        long long v_sb, long long v_sm, float scale, cudaStream_t stream) {
  CUtensorMap tk = {}, tv = {};  // without keys no tile is loaded, and the maps stay unused
  if (m > 0) {
    cudaError_t e = ac::make_kv_map(&tk, k, D, (long long)H * D, m, B, k_sm, k_sb);
    if (e == cudaSuccess) e = ac::make_kv_map(&tv, v, D, (long long)H * D, m, B, v_sm, v_sb);
    if (e != cudaSuccess) return e;
  }
  ac::Params p = {};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.bias = static_cast<const float*>(bias);
  p.nk = static_cast<const __nv_bfloat16*>(nk);
  p.nv = static_cast<const __nv_bfloat16*>(nv);
  p.q_scale = static_cast<const float*>(qs);
  p.k_scale = static_cast<const float*>(ks);
  p.lse = static_cast<float*>(lse);
  p.q_sb = q_sb;
  p.q_sh = D;
  p.q_sn = q_sn;
  p.o_sb = (long long)n * H * D;
  p.o_sh = D;
  p.o_sn = (long long)H * D;
  p.n = n;
  p.m = m;
  p.H = H;
  p.c0_h = D;
  p.c2_b = 1;
  p.c2_h = 0;
  p.scale = scale;
  return ac::launch<D, true>(tk, tv, p, B, stream);
}

cudaError_t launch_f32(const void* q, const void* k, const void* v, const void* nk, const void* nv,
                       const void* qs, const void* ks, const void* bias, void* out, void* lse, int B, int n,
                       int m, int H, long long q_sb, long long q_sn, long long k_sb, long long k_sm,
                       long long v_sb, long long v_sm, float scale, cudaStream_t stream) {
  F32Params p;
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.nk = static_cast<const float*>(nk);
  p.nv = static_cast<const float*>(nv);
  p.q_scale = static_cast<const float*>(qs);
  p.k_scale = static_cast<const float*>(ks);
  p.bias = static_cast<const float*>(bias);
  p.out = static_cast<float*>(out);
  p.lse = static_cast<float*>(lse);
  p.n = n;
  p.m = m;
  p.H = H;
  p.q_sb = q_sb;
  p.q_sn = q_sn;
  p.k_sb = k_sb;
  p.k_sm = k_sm;
  p.v_sb = v_sb;
  p.v_sm = v_sm;
  p.scale = scale;
  static bool done[32] = {};  // the dynamic shared memory limit, raised once per device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && !(dev < 32 && done[dev])) {
    e = cudaFuncSetAttribute(qknorm_fwd_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, F32Smem::BYTES);
    if (e == cudaSuccess && dev < 32) done[dev] = true;
  }
  if (e != cudaSuccess) return e;
  const dim3 grid((n + FQ - 1) / FQ, H, B);
  qknorm_fwd_f32<<<grid, FT, F32Smem::BYTES, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B, n, H, 64), k/v (B, m, H, 64) with unit stride over (H, 64) and the
// given element strides over batch and sequence; nk/nv (H, 64) contiguous
// in the inputs' dtype; q_scale/k_scale (64,) f32; bias (B, m) f32 or null;
// out (B, n, H, 64) contiguous; lse (B, H, n) f32, each row's logsumexp
// over the null position and the keys, or null. dtype 0 = f32, 1 = bf16
// (bf16: q, k, v 16-byte aligned, their strides multiples of 8 elements).
// Returns cudaGetLastError().
int muse_qknorm_attn_launch(const void* q, const void* k, const void* v, const void* nk,
                            const void* nv, const void* q_scale, const void* k_scale,
                            const void* bias, void* out, void* lse, int B, int n, int m, int H,
                            long long q_sb, long long q_sn, long long k_sb, long long k_sm,
                            long long v_sb, long long v_sm, float scale, int dtype, void* stream) {
  if (B <= 0 || n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_bf16(q, k, v, nk, nv, q_scale, k_scale, bias, out, lse, B, n, m, H, q_sb, q_sn, k_sb,
                       k_sm, v_sb, v_sm, scale, s);
  return launch_f32(q, k, v, nk, nv, q_scale, k_scale, bias, out, lse, B, n, m, H, q_sb, q_sn, k_sb,
                    k_sm, v_sb, v_sm, scale, s);
}

const char* muse_qknorm_attn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
