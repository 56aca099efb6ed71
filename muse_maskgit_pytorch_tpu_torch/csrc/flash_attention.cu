// Plain (non-causal) flash attention for Hopper (sm_90a). Forward only.
//
// Replaces the TPU kernel `_flash_kernel` in
// muse_maskgit_pytorch_tpu/ops/attention.py (Pallas). For q (b, h, n, d),
// k, v (b, h, m, d), contiguous, f32 or bf16, and an optional additive f32
// key bias (b, m) (0 or -1e30 from a bool mask), it computes
//   out = softmax(q k^T * scale + bias) v
// with an online softmax over kv tiles: statistics and accumulation in f32,
// the output in the input dtype. bf16 inputs are widened to f32 as they are
// staged, so every product is exact and every sum f32 (the Pallas kernel's
// bf16 dots with f32 accumulation, without its bf16 rounding of p).
//
// One difference from the Pallas kernel, on purpose: that wrapper pads kv to
// a multiple of its block with zero rows and -1e30 bias, so a row whose real
// keys are all masked averages v over the padded length. Here keys past m
// score -inf and never count: such a row averages v over its m real keys,
// as `xla_attention` (and the JAX tests) define it.
//
// What bounds it on the H100: arithmetic, 4 * n * m * d FLOP per (batch,
// head) against one read of q, k, v; at d 32 or 64 the tiles are small
// enough for CUDA cores. Design: one block per (64-query tile, head, batch),
// 256 threads as 16 x 16; queries staged once, scaled, in shared memory; kv
// consumed in 64-key tiles with the running max, sum and output in
// registers (4 query rows x 4 keys of S and 4 rows x d/16 dims of the output
// per thread), so there is no kv length limit and nothing but q, k, v and
// the output touches device memory. Templated on d in {32, 64}. Tensor-core
// products (mma.sync / wgmma) are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int QT = 64;        // queries per block
constexpr int KT = 64;        // keys per kv tile
constexpr int NT = 256;       // threads: 16 x 16
constexpr int QTP = QT + 4;   // padded strides of the transposed tiles
constexpr int KTP = KT + 4;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) { return __float2bfloat16(v); }

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

template <int D, typename T>
__global__ void __launch_bounds__(NT)
flash_attn_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const float* __restrict__ bias, T* __restrict__ out, int n, int m, int H,
                  float scale) {
  constexpr int DJ = D / 16;  // output dims per thread
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;            // [D][QTP]  scaled queries, transposed
  float* Kt = Qt + D * QTP;    // [D][KTP]  keys, transposed
  float* Vs = Kt + D * KTP;    // [KT][D]
  float* Pt = Vs + KT * D;     // [KT][QTP] probabilities, transposed

  const int q0 = blockIdx.x * QT, h = blockIdx.y, b = blockIdx.z;
  const long long bh = (long long)b * H + h;
  const T* qb = q + bh * n * D;
  const T* kb = k + bh * m * D;
  const T* vb = v + bh * m * D;
  const float* brow = bias ? bias + (long long)b * m : nullptr;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;  // key/dim group, query group

  for (int e = tid; e < QT * D; e += NT) {
    const int r = e / D, c = e % D, qi = q0 + r;
    Qt[c * QTP + r] = qi < n ? to_f32(qb[(long long)qi * D + c]) * scale : 0.0f;
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
      Kt[c * KTP + r] = in ? to_f32(kb[(long long)kj * D + c]) : 0.0f;
      Vs[r * D + c] = in ? to_f32(vb[(long long)kj * D + c]) : 0.0f;
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
    T* o = out + (bh * n + qi) * D + tx * DJ;
#pragma unroll
    for (int j = 0; j < DJ; ++j) o[j] = from_f32<T>(acc[i][j] * inv);
  }
}

template <int D, typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* bias, void* out, int B,
                   int H, int n, int m, float scale, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(flash_attn_kernel<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem_bytes<D>());
  if (e != cudaSuccess) return e;
  const dim3 grid((n + QT - 1) / QT, H, B);
  flash_attn_kernel<D, T><<<grid, NT, smem_bytes<D>(), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(bias), static_cast<T*>(out), n, m, H, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B, H, n, d), k/v (B, H, m, d), out (B, H, n, d): contiguous, dtype
// 0 = f32, 1 = bf16; d 32 or 64; m > 0. bias (B, m) f32 or null.
// Returns cudaGetLastError().
int muse_flash_attn_launch(const void* q, const void* k, const void* v, const void* bias, void* out,
                           int B, int H, int n, int m, int d, float scale, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || n <= 0) return 0;
  if (m <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64 && dtype == 0) return launch<64, float>(q, k, v, bias, out, B, H, n, m, scale, s);
  if (d == 64 && dtype == 1) return launch<64, __nv_bfloat16>(q, k, v, bias, out, B, H, n, m, scale, s);
  if (d == 32 && dtype == 0) return launch<32, float>(q, k, v, bias, out, B, H, n, m, scale, s);
  if (d == 32 && dtype == 1) return launch<32, __nv_bfloat16>(q, k, v, bias, out, B, H, n, m, scale, s);
  return cudaErrorInvalidValue;
}

const char* muse_flash_attn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
