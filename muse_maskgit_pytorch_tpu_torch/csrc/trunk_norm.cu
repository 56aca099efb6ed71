// The token transformer's normalisation in one launch, for Hopper (sm_90a):
// LayerNorm over rows, and GEGLU followed by the inner LayerNorm.
//
// Replaces no TPU kernel: the JAX package's LayerNorm and GEGLU are XLA's
// fusions (muse_maskgit_pytorch_tpu/models/transformer.py). In PyTorch the
// same code ran as about nine launches a norm (an f32 copy of the rows, a
// mean and a variance reduction, three broadcasting passes over f32
// intermediates, the cast back), two more for GELU and the gate product,
// and moved about 12 bytes for every byte of the row. Profiled on the H100,
// those kernels were the largest layer of generation: 5.45 ms of the 14.0
// device ms an image at batch 32, 29.3 of 67.8 in the 512px cascade, with
// about 300 of a decode step's 600 launches.
//
//   layernorm:        out = (x - mean) * rsqrt(var + 1e-5) * gamma
//   geglu_layernorm:  h = [a | gate] (rows, 2d); g = gate * gelu_erf(a);
//                     out = layernorm(g) with gamma
//
// x is bf16 or f32, row-major with a row stride; gamma f32 (d,); out has
// x's dtype and is dense (rows, d). Statistics are f32: the mean, then the
// biased variance as the mean of squared deviations from it. In bf16 the
// kernel rounds where the composite PyTorch code rounds, so that only the
// order of the f32 sums differs from it: gelu(a) to bf16, gate * gelu to
// bf16, and the result after the multiply by gamma.
//
// What bounds it on the H100: bytes. Every input byte is read once and
// every output byte written once, nothing else reaches device memory: at
// (16384, 512) bf16 that is 33.5 MB, 10 us at 3.35 TB/s; GEGLU at
// (16384, 2730 -> 1365) 134 MB, 40 us.
//
// Design. One warp owns one row, and a block four rows, so a row count that
// is no multiple of four leaves some warps idle. The warp copies its row
// into shared memory with 16-byte cp.async copies, all in flight at once,
// then its lanes take the elements in turn (element j to lane j % 32) and
// read them from there once a pass: the sum, the squared deviations from
// the mean (each in f32, reduced across the warp by shuffles), and the
// result, stored straight from registers. Little shared memory a row (5.5
// KB at GEGLU's bf16 width) keeps 40 or more warps on an SM, so that some
// load while others compute. GEGLU's erf GELU in bf16 costs about as many
// instructions as its bytes take time, so its first pass is unrolled four
// times for independent work within a warp. Rows need not be 16-byte
// aligned: at width 1365 a bf16 row starts 2 bytes into a 16-byte word on
// every other row, and the gate half of a (rows, 2730) input 2 bytes into
// one on every row. So the input is read as the whole 16-byte words that
// hold the row, and the row lies in shared memory at its own offset modulo
// 16. GEGLU's product is kept over its x in shared memory between passes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>


namespace {

constexpr int WARPS = 4;              // rows a block
constexpr int STATIC_SMEM = 48 * 1024;
constexpr int MAX_SMEM = 232448;      // a block's shared memory on sm_90, opted in
constexpr float SQRT1_2 = 0.70710678118654752440f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) { return __float2bfloat16(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Global -> shared, asynchronously (cp.async; the caller waits): the
// 16-byte words that hold the row's `bytes` bytes from `src`, whole, to
// `slot` (16-byte aligned), so that the row lies at `slot + (src & 15)`. A
// word that holds a byte of a tensor lies in the tensor's page, so the
// bytes it adds on either side are safe to read; they are never used.
__device__ __forceinline__ void row_in(char* slot, const char* src, int bytes, int lane) {
  const uintptr_t shift = reinterpret_cast<uintptr_t>(src) & 15u;
  const char* base = src - shift;
  const int vecs = (static_cast<int>(shift) + bytes + 15) >> 4;
  for (int i = lane; i < vecs; i += 32) {
    const unsigned saddr = static_cast<unsigned>(__cvta_generic_to_shared(slot + 16 * i));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(saddr), "l"(base + 16 * i));
  }
}

// One row from `xs` (shared memory; GEGLU: [x | gate]) to `y` (device
// memory). The lanes take the elements in turn (element j to lane j % 32)
// and read them from shared memory once a pass: the sum, the squared
// deviations from the mean (each in f32, reduced across the warp by
// shuffles), the result. GEGLU's product g = gate * gelu_erf(x) is rounded
// where the composite code rounds it (in bf16: gelu, then the product) and
// kept over x, by the lane that read x, in the input's dtype (exact: g is
// rounded to it already).
template <typename T, bool GEGLU>
__device__ __forceinline__ void norm_row(T* xs, T* __restrict__ y, const float* __restrict__ gamma, int d,
                                         int lane) {
  const float inv_d = 1.f / static_cast<float>(d);
  float sum = 0.f;
#pragma unroll 4
  for (int j = lane; j < d; j += 32) {
    float v = to_f32(xs[j]);
    if (GEGLU) {
      const float gelu = to_f32(from_f32<T>(v * 0.5f * (1.f + erff(v * SQRT1_2))));
      const T g = from_f32<T>(to_f32(xs[d + j]) * gelu);
      xs[j] = g;
      v = to_f32(g);
    }
    sum += v;
  }
  const float mean = warp_sum(sum) * inv_d;
  float ssd = 0.f;
  for (int j = lane; j < d; j += 32) {
    const float c = to_f32(xs[j]) - mean;
    ssd += c * c;
  }
  const float rstd = rsqrtf(warp_sum(ssd) * inv_d + 1e-5f);
  for (int j = lane; j < d; j += 32) y[j] = from_f32<T>((to_f32(xs[j]) - mean) * rstd * __ldg(gamma + j));
}

// `slot`: a warp's bytes of shared memory for its row, a 16-byte multiple,
// 16 bytes over the row so that the row fits at any offset.
template <typename T, bool GEGLU>
__device__ __forceinline__ void warp_row(const T* __restrict__ x, long long row_stride,
                                         const float* __restrict__ gamma, T* __restrict__ out, int rows, int d,
                                         int slot) {
  extern __shared__ __align__(16) char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * WARPS + warp;
  if (row >= rows) return;
  const char* src = reinterpret_cast<const char*>(x + row * row_stride);
  char* buf = smem + warp * slot;
  row_in(buf, src, (GEGLU ? 2 : 1) * d * static_cast<int>(sizeof(T)), lane);
  asm volatile("cp.async.wait_all;\n" ::);
  __syncwarp();
  norm_row<T, GEGLU>(reinterpret_cast<T*>(buf + (reinterpret_cast<uintptr_t>(src) & 15u)),
                     out + row * static_cast<long long>(d), gamma, d, lane);
}

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
    layernorm_rows(const T* __restrict__ x, long long row_stride, const float* __restrict__ gamma,
                   T* __restrict__ out, int rows, int d, int slot) {
  warp_row<T, false>(x, row_stride, gamma, out, rows, d, slot);
}

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
    geglu_layernorm_rows(const T* __restrict__ x, long long row_stride, const float* __restrict__ gamma,
                         T* __restrict__ out, int rows, int d, int slot) {
  warp_row<T, true>(x, row_stride, gamma, out, rows, d, slot);
}

template <typename T>
cudaError_t launch(const void* x, long long row_stride, const void* gamma, void* out, int rows, int d,
                   bool geglu, cudaStream_t s) {
  const int slot = ((geglu ? 2 : 1) * d * static_cast<int>(sizeof(T)) + 16 + 15) / 16 * 16;
  const int smem = WARPS * slot;
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  auto kern = geglu ? geglu_layernorm_rows<T> : layernorm_rows<T>;
  if (smem > STATIC_SMEM) {
    const cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<static_cast<unsigned>((rows + WARPS - 1) / WARPS), WARPS * 32, smem, s>>>(
      static_cast<const T*>(x), row_stride, static_cast<const float*>(gamma), static_cast<T*>(out), rows, d, slot);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x: `rows` rows of d (GEGLU: 2 d) contiguous elements, bf16 (bf16 = 1) or
// f32, a row starting `row_stride` elements after the one before; gamma:
// f32 (d,); out: dense (rows, d) in x's dtype. Pointers aligned to their
// element. Returns cudaGetLastError().
int muse_trunk_norm_launch(const void* x, long long row_stride, const void* gamma, void* out, int rows, int d,
                           int geglu, int bf16, void* stream) {
  if (rows <= 0) return 0;
  if (d <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(x, row_stride, gamma, out, rows, d, geglu != 0, s)
              : launch<float>(x, row_stride, gamma, out, rows, d, geglu != 0, s);
}

const char* muse_trunk_norm_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
