// Plain (non-causal) flash attention for Hopper (sm_90a). Forward only.
//
// Replaces the TPU kernel `_flash_kernel` in
// muse_maskgit_pytorch_tpu/ops/attention.py (Pallas). For q (b, h, n, d),
// k, v (b, h, m, d), contiguous, f32 or bf16, and an optional additive f32
// key bias (b, m) (0 or -1e30 from a bool mask), it computes
//   out = softmax(q k^T * scale + bias) v
// with an online softmax over kv tiles: statistics and accumulation in f32,
// the output in the input dtype.
//
// One difference from the Pallas kernel, on purpose: that wrapper pads kv to
// a multiple of its block with zero rows and -1e30 bias, so a row whose real
// keys are all masked averages v over the padded length. Here keys past m
// score -inf and never count: such a row averages v over its m real keys,
// as `xla_attention` (and the JAX tests) define it.
//
// What bounds it on the H100: 4 * n * m * d FLOP per (batch, head) against
// one read of q, k, v and one write of the output -- the bytes below about
// 600 keys, the tensor cores' 989 TFLOP/s above (d 64). Two kernels:
//   * bf16 (the Pallas kernel's arithmetic: q * scale rounded to bf16, bf16
//     products with f32 accumulation, p rounded to bf16 before p v): the
//     Hopper core of `attention_core.cuh`, shared with K2 -- TMA ring of K/V
//     tiles fed by a producer warp, `wgmma` for both products, P kept in
//     registers. Templated on d in {32, 64}.
//   * f32: CUDA-core FMA, one block per (64-query tile, head, batch), 256
//     threads as 16 x 16, queries staged once, scaled, in shared memory; kv
//     in 64-key tiles with the running max, sum and output in registers.

#include <cuda_runtime.h>
#include <math.h>

#include "attention_core.cuh"

namespace {

constexpr int QT = 64;        // queries per block
constexpr int KT = 64;        // keys per kv tile
constexpr int NT = 256;       // threads: 16 x 16
constexpr int QTP = QT + 4;   // padded strides of the transposed tiles
constexpr int KTP = KT + 4;

// reductions over the 16 lanes that hold one row (lanes 0-15 or 16-31)
__device__ __forceinline__ float half_max(float v) {
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float half_sum(float v) {
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (D * QTP + D * KTP + KT * D + KT * QTP);
}

template <int D>
__global__ void __launch_bounds__(NT)
flash_attn_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                  const float* __restrict__ bias, float* __restrict__ out, int n, int m, int H,
                  float scale) {
  constexpr int DJ = D / 16;  // output dims per thread
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;            // [D][QTP]  scaled queries, transposed
  float* Kt = Qt + D * QTP;    // [D][KTP]  keys, transposed
  float* Vs = Kt + D * KTP;    // [KT][D]
  float* Pt = Vs + KT * D;     // [KT][QTP] probabilities, transposed

  const int q0 = blockIdx.x * QT, h = blockIdx.y, b = blockIdx.z;
  const long long bh = (long long)b * H + h;
  const float* qb = q + bh * n * D;
  const float* kb = k + bh * m * D;
  const float* vb = v + bh * m * D;
  const float* brow = bias ? bias + (long long)b * m : nullptr;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;  // key/dim group, query group

  for (int e = tid; e < QT * D; e += NT) {
    const int r = e / D, c = e % D, qi = q0 + r;
    Qt[c * QTP + r] = qi < n ? qb[(long long)qi * D + c] * scale : 0.0f;
  }

  float mrow[4], lrow[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    mrow[i] = -INFINITY;
    lrow[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.0f;
  }

  for (int kv0 = 0; kv0 < m; kv0 += KT) {
    __syncthreads();  // the previous tile's Kt / Vs / Pt are no longer read
    for (int e = tid; e < KT * D; e += NT) {
      const int r = e / D, c = e % D, kj = kv0 + r;
      const bool in = kj < m;
      Kt[c * KTP + r] = in ? kb[(long long)kj * D + c] : 0.0f;
      Vs[r * D + c] = in ? vb[(long long)kj * D + c] : 0.0f;
    }
    __syncthreads();

    // S = Q K^T for this thread's 4 x 4 tile, plus the key bias; keys past
    // m score -inf
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int dd = 0; dd < D; ++dd) {
      const float4 qa = *reinterpret_cast<const float4*>(&Qt[dd * QTP + ty * 4]);
      const float4 ka = *reinterpret_cast<const float4*>(&Kt[dd * KTP + tx * 4]);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      const float kv[4] = {ka.x, ka.y, ka.z, ka.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = kv0 + tx * 4 + j;
      const float bj = c < m ? (brow ? brow[c] : 0.0f) : -INFINITY;
#pragma unroll
      for (int i = 0; i < 4; ++i) s[i][j] += bj;
    }

    // online softmax update; P goes to shared memory for the PV product.
    // Every tile holds at least one real key, so m_new is finite.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float mx = half_max(fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3])));
      const float m_new = fmaxf(mrow[i], mx);
      const float alpha = expf(mrow[i] - m_new);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
      lrow[i] = lrow[i] * alpha + half_sum(rs);
      mrow[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      *reinterpret_cast<float4*>(&Pt[(tx * 4 + j) * QTP + ty * 4]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    }
    __syncthreads();

    // acc += P V for rows ty*4 + i, dims tx*DJ + j
#pragma unroll 8
    for (int c = 0; c < KT; ++c) {
      const float4 pa = *reinterpret_cast<const float4*>(&Pt[c * QTP + ty * 4]);
      const float pv[4] = {pa.x, pa.y, pa.z, pa.w};
      float vv[DJ];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = Vs[c * D + tx * DJ + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= n) continue;
    const float inv = 1.0f / lrow[i];
    float* o = out + (bh * n + qi) * D + tx * DJ;
#pragma unroll
    for (int j = 0; j < DJ; ++j) o[j] = acc[i][j] * inv;
  }
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, const void* bias, void* out, int B,
                       int H, int n, int m, float scale, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(flash_attn_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem_bytes<D>());
  if (e != cudaSuccess) return e;
  const dim3 grid((n + QT - 1) / QT, H, B);
  flash_attn_kernel<D><<<grid, NT, smem_bytes<D>(), stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(bias), static_cast<float*>(out), n, m, H, scale);
  return cudaGetLastError();
}

// bf16 through the Hopper core: k, v as 3-D views {d, m, B * H}
template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, const void* bias, void* out, int B,
                        int H, int n, int m, float scale, cudaStream_t stream) {
  namespace ac = attention_core;
  CUtensorMap tk, tv;
  cudaError_t e = ac::make_kv_map(&tk, k, D, D, m, (long long)B * H, D, (long long)m * D);
  if (e == cudaSuccess) e = ac::make_kv_map(&tv, v, D, D, m, (long long)B * H, D, (long long)m * D);
  if (e != cudaSuccess) return e;
  ac::Params p = {};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.bias = static_cast<const float*>(bias);
  p.q_sb = p.o_sb = (long long)H * n * D;
  p.q_sh = p.o_sh = (long long)n * D;
  p.q_sn = p.o_sn = D;
  p.n = n;
  p.m = m;
  p.H = H;
  p.c0_h = 0;
  p.c2_b = H;
  p.c2_h = 1;
  p.scale = scale;
  return ac::launch<D, false>(tk, tv, p, B, stream);
}

}  // namespace

extern "C" {

// q (B, H, n, d), k/v (B, H, m, d), out (B, H, n, d): contiguous, dtype
// 0 = f32, 1 = bf16 (pointers 16-byte aligned); d 32 or 64; m > 0. bias
// (B, m) f32 or null.
// Returns cudaGetLastError().
int muse_flash_attn_launch(const void* q, const void* k, const void* v, const void* bias, void* out,
                           int B, int H, int n, int m, int d, float scale, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || n <= 0) return 0;
  if (m <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64 && dtype == 0) return launch_f32<64>(q, k, v, bias, out, B, H, n, m, scale, s);
  if (d == 64 && dtype == 1) return launch_bf16<64>(q, k, v, bias, out, B, H, n, m, scale, s);
  if (d == 32 && dtype == 0) return launch_f32<32>(q, k, v, bias, out, B, H, n, m, scale, s);
  if (d == 32 && dtype == 1) return launch_bf16<32>(q, k, v, bias, out, B, H, n, m, scale, s);
  return cudaErrorInvalidValue;
}

const char* muse_flash_attn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
