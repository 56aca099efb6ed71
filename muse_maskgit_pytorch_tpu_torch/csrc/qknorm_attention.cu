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
// the bytes, one read of q, k, v and one write of the output, against
// 4*n*m*d FLOP that the tensor cores do faster. The online softmax is seeded
// with the null position (m0 = s0, l0 = 1, acc0 = nv), so no kv length limit
// exists and nothing but q, k, v and the output touches global memory. Norms
// and softmax statistics are f32. Two kernels:
//   * bf16 inputs (the models' path): the Hopper core of
//     `attention_core.cuh`, shared with K4, with the TPU kernel's roundings
//     (q^ and k^ to bf16 after the f32 norm and scale, P to bf16 before
//     P v): TMA ring of raw K/V tiles fed by a producer warp, each K tile
//     normalised in place once per block, `wgmma` for both products.
//   * f32 inputs: CUDA-core FMA, one block per (64-query tile, head, batch),
//     4x4 register tiles per thread.

#include <cuda_runtime.h>
#include <math.h>

#include "attention_core.cuh"

namespace {

constexpr int D = 64;         // head dim
constexpr int QT = 64;        // queries per block
constexpr int KT = 64;        // keys per kv tile
constexpr int NT = 256;       // threads: 16 x 16, each a 4 x 4 tile
constexpr int NW = NT / 32;
constexpr int QTP = QT + 4;   // padded strides of the transposed tiles
constexpr int KTP = KT + 4;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
// reductions over the 16 lanes that hold one row (lanes 0-15 or 16-31)
__device__ __forceinline__ float half_max(float v) {
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float half_sum(float v) {
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// -- f32 inputs: CUDA-core FMA kernel -----------------------------------------

__global__ void __launch_bounds__(NT)
qknorm_attn_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                   const float* __restrict__ nk, const float* __restrict__ nv,
                   const float* __restrict__ q_scale, const float* __restrict__ k_scale,
                   const float* __restrict__ bias, float* __restrict__ out, float* __restrict__ lse, int n, int m, int H,
                   long long q_sb, long long q_sn, long long k_sb, long long k_sm,
                   long long v_sb, long long v_sm, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;              // [D][QTP]  normalised, scaled queries, transposed
  float* Kt = Qt + D * QTP;      // [D][KTP]  normalised keys, transposed
  float* Vs = Kt + D * KTP;      // [KT][D]
  float* Pt = Vs + KT * D;       // [KT][QTP] probabilities, transposed
  __shared__ float qsc[D], ksc[D], nkh[D], nvs[D], s0s[QT];

  const int q0 = blockIdx.x * QT, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tx = tid & 15, ty = tid >> 4;  // key/dim group, query group

  if (tid < D) {
    qsc[tid] = q_scale[tid] * scale;
    ksc[tid] = k_scale[tid];
  }
  __syncthreads();
  if (warp == 0) {
    const float a0 = nk[h * D + lane], a1 = nk[h * D + lane + 32];
    const float r = rsqrtf(warp_sum(a0 * a0 + a1 * a1) + 1e-12f);
    nkh[lane] = a0 * r * ksc[lane];
    nkh[lane + 32] = a1 * r * ksc[lane + 32];
    nvs[lane] = nv[h * D + lane];
    nvs[lane + 32] = nv[h * D + lane + 32];
  }
  __syncthreads();

  // -- queries: one warp per row, normalised and scaled; s0 = q^ . nk^
  for (int r = warp; r < QT; r += NW) {
    const int qi = q0 + r;
    float a0 = 0.0f, a1 = 0.0f;
    if (qi < n) {
      const float* p = q + b * q_sb + qi * q_sn + h * D;
      a0 = p[lane];
      a1 = p[lane + 32];
    }
    const float rr = rsqrtf(warp_sum(a0 * a0 + a1 * a1) + 1e-12f);
    a0 = a0 * rr * qsc[lane];
    a1 = a1 * rr * qsc[lane + 32];
    Qt[lane * QTP + r] = a0;
    Qt[(lane + 32) * QTP + r] = a1;
    const float s0 = warp_sum(a0 * nkh[lane] + a1 * nkh[lane + 32]);
    if (lane == 0) s0s[r] = s0;
  }
  __syncthreads();

  // -- online softmax state for rows ty*4 + i, seeded with the null position
  float mrow[4], lrow[4], acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    mrow[i] = s0s[ty * 4 + i];
    lrow[i] = 1.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = nvs[tx * 4 + j];
  }

  for (int kv0 = 0; kv0 < m; kv0 += KT) {
    __syncthreads();  // previous tile's Kt / Vs / Pt are no longer read
    for (int r = warp; r < KT; r += NW) {
      const int c = kv0 + r;
      float a0 = 0.0f, a1 = 0.0f, w0 = 0.0f, w1 = 0.0f;
      if (c < m) {
        const float* pk = k + b * k_sb + c * k_sm + h * D;
        const float* pv = v + b * v_sb + c * v_sm + h * D;
        a0 = pk[lane];
        a1 = pk[lane + 32];
        w0 = pv[lane];
        w1 = pv[lane + 32];
      }
      const float rr = rsqrtf(warp_sum(a0 * a0 + a1 * a1) + 1e-12f);
      Kt[lane * KTP + r] = a0 * rr * ksc[lane];
      Kt[(lane + 32) * KTP + r] = a1 * rr * ksc[lane + 32];
      Vs[r * D + lane] = w0;
      Vs[r * D + lane + 32] = w1;
    }
    __syncthreads();

    // S = Q^ K^T for this thread's 4 x 4 tile
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int dd = 0; dd < D; ++dd) {
      const float4 qa = *reinterpret_cast<const float4*>(&Qt[dd * QTP + ty * 4]);
      const float4 kb = *reinterpret_cast<const float4*>(&Kt[dd * KTP + tx * 4]);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      const float kv[4] = {kb.x, kb.y, kb.z, kb.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] += qv[i] * kv[j];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = kv0 + tx * 4 + j;
      const float bj = c < m ? (bias ? bias[(long long)b * m + c] : 0.0f) : -INFINITY;
#pragma unroll
      for (int i = 0; i < 4; ++i) s[i][j] += bj;
    }

    // online softmax update; P goes to shared memory for the PV product
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
      mx = half_max(mx);
      const float m_new = fmaxf(mrow[i], mx);
      const float alpha = expf(mrow[i] - m_new);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        s[i][j] = p;
        rs += p;
      }
      rs = half_sum(rs);
      lrow[i] = lrow[i] * alpha + rs;
      mrow[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      *reinterpret_cast<float4*>(&Pt[(tx * 4 + j) * QTP + ty * 4]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    }
    __syncthreads();

    // acc += P V for rows ty*4+i, dims tx*4+j
#pragma unroll 8
    for (int c = 0; c < KT; ++c) {
      const float4 pa = *reinterpret_cast<const float4*>(&Pt[c * QTP + ty * 4]);
      const float4 vb = *reinterpret_cast<const float4*>(&Vs[c * D + tx * 4]);
      const float pv[4] = {pa.x, pa.y, pa.z, pa.w};
      const float vv[4] = {vb.x, vb.y, vb.z, vb.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += pv[i] * vv[j];
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= n) continue;
    const float inv = 1.0f / lrow[i];
    if (lse != nullptr && tx == 0) lse[((long long)b * H + h) * n + qi] = mrow[i] + logf(lrow[i]);
    float* o = out + (((long long)b * n + qi) * H + h) * D + tx * 4;
#pragma unroll
    for (int j = 0; j < 4; ++j) o[j] = acc[i][j] * inv;
  }
}

constexpr size_t kSmemBytes = sizeof(float) * (D * QTP + D * KTP + KT * D + KT * QTP);

// bf16 through the Hopper core: k, v as 3-D views {H * D, m, B} with the
// callers' batch and sequence strides
cudaError_t launch_bf16(const void* q, const void* k, const void* v, const void* nk, const void* nv,
                        const void* qs, const void* ks, const void* bias, void* out, void* lse, int B, int n,
                        int m, int H, long long q_sb, long long q_sn, long long k_sb, long long k_sm,
                        long long v_sb, long long v_sm, float scale, cudaStream_t stream) {
  namespace ac = attention_core;
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
  cudaError_t e = cudaFuncSetAttribute(qknorm_attn_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((n + QT - 1) / QT, H, B);
  qknorm_attn_kernel<<<grid, NT, kSmemBytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(nk), static_cast<const float*>(nv), static_cast<const float*>(qs),
      static_cast<const float*>(ks), static_cast<const float*>(bias), static_cast<float*>(out),
      static_cast<float*>(lse), n,
      m, H, q_sb, q_sn, k_sb, k_sm, v_sb, v_sm, scale);
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
