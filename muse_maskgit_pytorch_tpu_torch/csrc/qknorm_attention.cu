// Fused qk-l2norm attention with a learned null key/value per head, for
// Hopper (sm_90a). Forward only.
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
// the arithmetic, 4*n*m*d per (batch, head), against one read of q, k, v.
// Design: one block per (64-query tile, head, batch); kv is consumed in
// 64-row tiles with an online softmax whose state is seeded with the null
// position (m0 = s0, l0 = 1, acc0 = nv), so no kv length limit exists and
// nothing but q, k, v and the output touches global memory. Norms and
// softmax statistics are f32. Two kernels compute the products:
//   * bf16 inputs (the models' path): tensor cores, `mma.sync` m16n8k16,
//     one warp per 16 queries. The normalised q and k and the
//     probabilities are f32 values; each is split into three bf16 parts
//     (x = hi + mid + lo to ~24 bits), and the products take six (q.k) or
//     three (P.v, v is bf16 already) partial products, so scores and
//     outputs keep f32-level accuracy instead of bf16's.
//   * f32 inputs: CUDA-core FMA, 4x4 register tiles per thread.
// wgmma/TMA pipelines are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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
                   const float* __restrict__ bias, float* __restrict__ out, int n, int m, int H,
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
    float* o = out + (((long long)b * n + qi) * H + h) * D + tx * 4;
#pragma unroll
    for (int j = 0; j < 4; ++j) o[j] = acc[i][j] * inv;
  }
}

// -- bf16 inputs: tensor-core kernel -----------------------------------------

constexpr int MW = 8;          // warps per block, 16 queries each
constexpr int MNT = MW * 32;   // threads
constexpr int MQT = MW * 16;   // queries per block
constexpr int LDS = D + 8;     // padded bf16 row stride: fragment loads hit 32 banks
constexpr int NSPLIT = 3;      // f32 value = hi + mid + lo, three bf16 parts

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (lo, hi) -> bf16x2 with `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// the pair (a, b) as three bf16x2 words: x = hi + mid + lo to ~24 bits
__device__ __forceinline__ void split3_pack(float a, float b, uint32_t parts[NSPLIT]) {
#pragma unroll
  for (int p = 0; p < NSPLIT; ++p) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
    parts[p] = *reinterpret_cast<const uint32_t*>(&v);
    a -= __low2float(v);
    b -= __high2float(v);
  }
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ float2 ld_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__global__ void __launch_bounds__(MNT, 2)
qknorm_attn_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ nk,
                       const __nv_bfloat16* __restrict__ nv, const float* __restrict__ q_scale,
                       const float* __restrict__ k_scale, const float* __restrict__ bias,
                       __nv_bfloat16* __restrict__ out, int n, int m, int H, long long q_sb,
                       long long q_sn, long long k_sb, long long k_sm, long long v_sb,
                       long long v_sm, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // parts p of the normalised queries / keys: Qs + p * MQT * LDS, Ks + p * KT * LDS
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [3][MQT][LDS]
  __nv_bfloat16* Ks = Qs + NSPLIT * MQT * LDS;                      // [3][KT][LDS]
  __nv_bfloat16* Vt = Ks + NSPLIT * KT * LDS;                       // [D][LDS], transposed
  __shared__ float qsc[D], ksc[D], nkh[D], nvs[D], s0s[MQT];

  const int q0 = blockIdx.x * MQT, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;  // mma fragment coordinates
  const int d0 = 2 * lane;                  // the two dims this lane loads

  if (tid < D) {
    qsc[tid] = q_scale[tid] * scale;
    ksc[tid] = k_scale[tid];
  }
  __syncthreads();
  if (warp == 0) {
    const float2 a = ld_pair(nk + h * D + d0);
    const float r = rsqrtf(warp_sum(a.x * a.x + a.y * a.y) + 1e-12f);
    nkh[d0] = a.x * r * ksc[d0];
    nkh[d0 + 1] = a.y * r * ksc[d0 + 1];
    const float2 w = ld_pair(nv + h * D + d0);
    nvs[d0] = w.x;
    nvs[d0 + 1] = w.y;
  }
  __syncthreads();

  // -- queries: one warp per row, f32 norm and scale, split in three parts
  for (int r = warp; r < MQT; r += MW) {
    const int qi = q0 + r;
    float2 a = make_float2(0.0f, 0.0f);
    if (qi < n) a = ld_pair(q + b * q_sb + qi * q_sn + h * D + d0);
    const float rr = rsqrtf(warp_sum(a.x * a.x + a.y * a.y) + 1e-12f);
    const float x0 = a.x * rr * qsc[d0], x1 = a.y * rr * qsc[d0 + 1];
    uint32_t parts[NSPLIT];
    split3_pack(x0, x1, parts);
#pragma unroll
    for (int p = 0; p < NSPLIT; ++p)
      *reinterpret_cast<uint32_t*>(&Qs[(p * MQT + r) * LDS + d0]) = parts[p];
    const float s0 = warp_sum(x0 * nkh[d0] + x1 * nkh[d0 + 1]);
    if (lane == 0) s0s[r] = s0;
  }
  __syncthreads();

  const int r0 = warp * 16;  // this warp's 16 query rows
  // online softmax state of rows g and g + 8, seeded with the null position
  float m_r[2] = {s0s[r0 + g], s0s[r0 + g + 8]};
  float l_r[2] = {1.0f, 1.0f};
  float o[8][4];
#pragma unroll
  for (int dt = 0; dt < 8; ++dt) {
    const float v0 = nvs[dt * 8 + tig * 2], v1 = nvs[dt * 8 + tig * 2 + 1];
    o[dt][0] = v0; o[dt][1] = v1; o[dt][2] = v0; o[dt][3] = v1;
  }

  for (int kv0 = 0; kv0 < m; kv0 += KT) {
    __syncthreads();  // the previous tile is no longer read
    for (int r = warp; r < KT; r += MW) {
      const int c = kv0 + r;
      float2 a = make_float2(0.0f, 0.0f);
      __nv_bfloat162 w = __floats2bfloat162_rn(0.0f, 0.0f);
      if (c < m) {
        a = ld_pair(k + b * k_sb + c * k_sm + h * D + d0);
        w = *reinterpret_cast<const __nv_bfloat162*>(v + b * v_sb + c * v_sm + h * D + d0);
      }
      const float rr = rsqrtf(warp_sum(a.x * a.x + a.y * a.y) + 1e-12f);
      uint32_t parts[NSPLIT];
      split3_pack(a.x * rr * ksc[d0], a.y * rr * ksc[d0 + 1], parts);
#pragma unroll
      for (int p = 0; p < NSPLIT; ++p)
        *reinterpret_cast<uint32_t*>(&Ks[(p * KT + r) * LDS + d0]) = parts[p];
      Vt[d0 * LDS + r] = w.x;
      Vt[(d0 + 1) * LDS + r] = w.y;
    }
    __syncthreads();

    // S = Q^ K^T for 16 rows x 64 keys (8 tiles of 16 x 8), six partial
    // products per tile, smallest first: q.k to ~2^-18 of |q||k|
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.0f;
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      const int c = kc * 16 + tig * 2;
      uint32_t qa[NSPLIT][4];
#pragma unroll
      for (int p = 0; p < NSPLIT; ++p) {
        const __nv_bfloat16* Q = Qs + p * MQT * LDS;
        qa[p][0] = ld32(&Q[(r0 + g) * LDS + c]);
        qa[p][1] = ld32(&Q[(r0 + g + 8) * LDS + c]);
        qa[p][2] = ld32(&Q[(r0 + g) * LDS + c + 8]);
        qa[p][3] = ld32(&Q[(r0 + g + 8) * LDS + c + 8]);
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        uint32_t kb[NSPLIT][2];
#pragma unroll
        for (int p = 0; p < NSPLIT; ++p) {
          const __nv_bfloat16* K = Ks + (p * KT + nt * 8 + g) * LDS;
          kb[p][0] = ld32(&K[c]);
          kb[p][1] = ld32(&K[c + 8]);
        }
        // a short chain into a fresh accumulator, added to S in f32: the
        // tensor cores' accumulation does not round to nearest
        float c4[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        mma_bf16(c4, qa[2], kb[0][0], kb[0][1]);
        mma_bf16(c4, qa[0], kb[2][0], kb[2][1]);
        mma_bf16(c4, qa[1], kb[1][0], kb[1][1]);
        mma_bf16(c4, qa[1], kb[0][0], kb[0][1]);
        mma_bf16(c4, qa[0], kb[1][0], kb[1][1]);
        mma_bf16(c4, qa[0], kb[0][0], kb[0][1]);
#pragma unroll
        for (int j = 0; j < 4; ++j) s[nt][j] += c4[j];
      }
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = kv0 + nt * 8 + tig * 2 + j;
        const float bj = c < m ? (bias ? bias[(long long)b * m + c] : 0.0f) : -INFINITY;
        s[nt][j] += bj;
        s[nt][j + 2] += bj;
      }
    }

    // online softmax update for rows g (i = 0) and g + 8 (i = 1)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) mx = fmaxf(mx, fmaxf(s[nt][2 * i], s[nt][2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_r[i], mx);
      const float alpha = expf(m_r[i] - m_new);
      float rs = 0.0f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        s[nt][2 * i] = expf(s[nt][2 * i] - m_new);
        s[nt][2 * i + 1] = expf(s[nt][2 * i + 1] - m_new);
        rs += s[nt][2 * i] + s[nt][2 * i + 1];
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      l_r[i] = l_r[i] * alpha + rs;
      m_r[i] = m_new;
#pragma unroll
      for (int dt = 0; dt < 8; ++dt) {
        o[dt][2 * i] *= alpha;
        o[dt][2 * i + 1] *= alpha;
      }
    }

    // O += P V: P's accumulator tiles are already A fragments (2 key tiles
    // = one 16-key chunk); P in three parts, v is bf16 already
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      uint32_t pa[NSPLIT][4], w[NSPLIT];
      split3_pack(s[2 * kc][0], s[2 * kc][1], w);
#pragma unroll
      for (int p = 0; p < NSPLIT; ++p) pa[p][0] = w[p];
      split3_pack(s[2 * kc][2], s[2 * kc][3], w);
#pragma unroll
      for (int p = 0; p < NSPLIT; ++p) pa[p][1] = w[p];
      split3_pack(s[2 * kc + 1][0], s[2 * kc + 1][1], w);
#pragma unroll
      for (int p = 0; p < NSPLIT; ++p) pa[p][2] = w[p];
      split3_pack(s[2 * kc + 1][2], s[2 * kc + 1][3], w);
#pragma unroll
      for (int p = 0; p < NSPLIT; ++p) pa[p][3] = w[p];
      const int c = kc * 16 + tig * 2;
#pragma unroll
      for (int dt = 0; dt < 8; ++dt) {
        const int vr = (dt * 8 + g) * LDS;
        const uint32_t v0 = ld32(&Vt[vr + c]), v1 = ld32(&Vt[vr + c + 8]);
        float c4[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        mma_bf16(c4, pa[2], v0, v1);
        mma_bf16(c4, pa[1], v0, v1);
        mma_bf16(c4, pa[0], v0, v1);
#pragma unroll
        for (int j = 0; j < 4; ++j) o[dt][j] += c4[j];
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = q0 + r0 + g + 8 * i;
    if (qi >= n) continue;
    const float inv = 1.0f / l_r[i];
    __nv_bfloat16* po = out + (((long long)b * n + qi) * H + h) * D + tig * 2;
#pragma unroll
    for (int dt = 0; dt < 8; ++dt) {
      *reinterpret_cast<uint32_t*>(po + dt * 8) = pack_bf16(o[dt][2 * i] * inv, o[dt][2 * i + 1] * inv);
    }
  }
}

constexpr size_t kSmemBytes = sizeof(float) * (D * QTP + D * KTP + KT * D + KT * QTP);
constexpr size_t kMmaSmemBytes = sizeof(__nv_bfloat16) * LDS * (NSPLIT * MQT + NSPLIT * KT + D);

cudaError_t launch_mma(const void* q, const void* k, const void* v, const void* nk, const void* nv,
                       const void* qs, const void* ks, const void* bias, void* out, int B, int n,
                       int m, int H, long long q_sb, long long q_sn, long long k_sb, long long k_sm,
                       long long v_sb, long long v_sm, float scale, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(qknorm_attn_mma_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMmaSmemBytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((n + MQT - 1) / MQT, H, B);
  qknorm_attn_mma_kernel<<<grid, MNT, kMmaSmemBytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(nk),
      static_cast<const __nv_bfloat16*>(nv), static_cast<const float*>(qs),
      static_cast<const float*>(ks), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(out), n, m, H, q_sb, q_sn, k_sb, k_sm, v_sb, v_sm, scale);
  return cudaGetLastError();
}

cudaError_t launch_f32(const void* q, const void* k, const void* v, const void* nk, const void* nv,
                       const void* qs, const void* ks, const void* bias, void* out, int B, int n,
                       int m, int H, long long q_sb, long long q_sn, long long k_sb, long long k_sm,
                       long long v_sb, long long v_sm, float scale, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(qknorm_attn_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((n + QT - 1) / QT, H, B);
  qknorm_attn_kernel<<<grid, NT, kSmemBytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(nk), static_cast<const float*>(nv), static_cast<const float*>(qs),
      static_cast<const float*>(ks), static_cast<const float*>(bias), static_cast<float*>(out), n,
      m, H, q_sb, q_sn, k_sb, k_sm, v_sb, v_sm, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B, n, H, 64), k/v (B, m, H, 64) with unit stride over (H, 64) and the
// given element strides over batch and sequence; nk/nv (H, 64) contiguous
// in the inputs' dtype; q_scale/k_scale (64,) f32; bias (B, m) f32 or null;
// out (B, n, H, 64) contiguous. dtype 0 = f32, 1 = bf16.
// Returns cudaGetLastError().
int muse_qknorm_attn_launch(const void* q, const void* k, const void* v, const void* nk,
                            const void* nv, const void* q_scale, const void* k_scale,
                            const void* bias, void* out, int B, int n, int m, int H,
                            long long q_sb, long long q_sn, long long k_sb, long long k_sm,
                            long long v_sb, long long v_sm, float scale, int dtype, void* stream) {
  if (B <= 0 || n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_mma(q, k, v, nk, nv, q_scale, k_scale, bias, out, B, n, m, H, q_sb, q_sn, k_sb,
                      k_sm, v_sb, v_sm, scale, s);
  return launch_f32(q, k, v, nk, nv, q_scale, k_scale, bias, out, B, n, m, H, q_sb, q_sn, k_sb,
                    k_sm, v_sb, v_sm, scale, s);
}

const char* muse_qknorm_attn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
