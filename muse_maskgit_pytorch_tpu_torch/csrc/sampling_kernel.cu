// Fused top-k / gumbel sampler for the MaskGit decode loop, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_sample_kernel` in
// muse_maskgit_pytorch_tpu/ops/sampling_kernel.py (Pallas). Per row of a
// (rows, V) logits array it computes, in one launch:
//   1. optionally the CFG combine l = null + (cond - null) * scale (cfg_pair);
//   2. the top-k threshold by 10 rounds of value bisection that keep
//      count(l >= lo) >= k, with the same f32 operations as the Pallas body
//      (mid = 0.5 * (lo + hi), `>=` compares), so the threshold is
//      bit-identical;
//   3. the logsumexp of the unfiltered row;
//   4. gumbel noise, injected or from a Philox4x32-10 stream keyed on
//      (seed, row) with the column as counter (4 columns per call);
//   5. the first-index argmax of l / max(temp, 1e-10) + g over l >= thresh,
//      and prob = exp(l[idx] - lse).
//
// What bounds it on the H100: bytes first. At the main path's step 0 the
// logits are 32*256 rows x 65536 bf16 = 1.07 GB, read once from HBM
// (0.32 ms at 3.35 TB/s); everything else is 11 passes over a row that is
// already on chip, and the gumbel transcendental work. Design: one block per
// row. A bf16 row (128 KB at V = 65536) is staged once into dynamic shared
// memory, and the passes read it 8 values per 16-byte load; an f32 or
// cfg_pair row does not fit in shared memory and is re-read from global
// memory (L2) on each pass. The logsumexp shares a pass with the first
// bisection round. Noise is drawn only for the ~10% of columns at or above
// the threshold: each warp appends their indices to a ring in shared memory
// and draws for 32 of them at a time, so no lane runs Philox for a column
// that another lane of its warp needed.
//
// Exactness: this file is compiled with -fmad=false and without fast math,
// so the CFG combine is a rounded multiply then a rounded add and `/` is
// the IEEE division, as in the plain PyTorch version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kBisectIters = 10;
constexpr int kRing = 512;  // per-warp ring of column indices (>= 32 + 8 * 32)
// largest bf16 row staged in shared memory (the card allows 227 KB a block,
// the rings take 64 KB)
constexpr int kMaxStagedBytes = 160 * 1024;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// Philox4x32-10 (Salmon et al., SC'11): counter (c0, 0, 0, 0), key (k0, k1).
__device__ __forceinline__ uint4 philox4x32_10(uint32_t c0, uint32_t k0, uint32_t k1) {
  uint32_t x0 = c0, x1 = 0u, x2 = 0u, x3 = 0u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t lo0 = 0xD2511F53u * x0, hi0 = __umulhi(0xD2511F53u, x0);
    const uint32_t lo1 = 0xCD9E8D57u * x2, hi1 = __umulhi(0xCD9E8D57u, x2);
    const uint32_t n0 = hi1 ^ x1 ^ k0, n2 = hi0 ^ x3 ^ k1;
    x0 = n0; x1 = lo1; x2 = n2; x3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return make_uint4(x0, x1, x2, x3);
}

__device__ __forceinline__ float bits_to_gumbel(uint32_t bits) {
  // top 23 bits -> u in [2^-24, 1 - 2^-24], strictly inside (0, 1). (The
  // TPU kernel's 24-bit form b * 2^-24 + 2^-25 rounds to 1.0 at
  // b = 2^24 - 1, and then g = +inf wins the argmax whatever the logit.)
  const float u = (float)(bits >> 9) * (1.0f / 8388608.0f) + (1.0f / 16777216.0f);
  return -logf(-logf(u));
}

// the two bf16 of a 32-bit word, widened exactly (low half = lower index)
__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

template <typename T, bool PAIR, bool STAGED>
struct Row {
  const T* cond;
  const T* null;
  const __nv_bfloat16* staged;
  float scale;
  int V;
  __device__ __forceinline__ float operator()(int i) const {
    if (STAGED) return __bfloat162float(staged[i]);
    if (PAIR) {
      const float c = to_f(cond[i]);
      const float n = to_f(null[i]);
      return n + (c - n) * scale;
    }
    return to_f(cond[i]);
  }
  // Visit every column once as f(first column, values, count, valid), in
  // any order. Staged rows go 8 columns per 16-byte shared-memory load. Every thread runs the same
  // number of outer iterations (warp-uniform), with `valid` false past the
  // end, so f may use warp collectives.
  template <class F>
  __device__ __forceinline__ void visit(F&& f) const {
    if (STAGED && (V & 7) == 0) {
      const uint4* s = reinterpret_cast<const uint4*>(staged);
      const int chunks = V >> 3;
      for (int base = 0; base < chunks; base += kThreads) {
        const int c = base + threadIdx.x;
        const bool valid = c < chunks;
        const uint4 u = valid ? s[c] : make_uint4(0u, 0u, 0u, 0u);
        const float x[8] = {bf16_lo(u.x), bf16_hi(u.x), bf16_lo(u.y), bf16_hi(u.y),
                            bf16_lo(u.z), bf16_hi(u.z), bf16_lo(u.w), bf16_hi(u.w)};
        f(c << 3, x, 8, valid);
      }
    } else {
      for (int base = 0; base < V; base += kThreads) {
        const int i = base + threadIdx.x;
        const bool valid = i < V;
        const float x[1] = {valid ? (*this)(i) : 0.0f};
        f(i, x, 1, valid);
      }
    }
  }
};

// -- block-wide reductions (every thread gets the result) -------------------

__device__ __forceinline__ void block_sum2(int& a, float& b, int* sh_i, float* sh_f) {
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) { sh_i[warp] = a; sh_f[warp] = b; }
  __syncthreads();
  a = sh_i[lane];
  b = sh_f[lane];
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
}

__device__ __forceinline__ int block_sum_int(int v, int* sh) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  v = sh[lane];
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void block_min_max(float& lo, float& hi, float* sh_lo, float* sh_hi) {
  for (int o = 16; o > 0; o >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) { sh_lo[warp] = lo; sh_hi[warp] = hi; }
  __syncthreads();
  lo = sh_lo[lane];
  hi = sh_hi[lane];
  for (int o = 16; o > 0; o >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
}

// (z, index, logit) with the larger z winning and the lower index on ties
__device__ __forceinline__ void argmax_merge(float& z, int& i, float& l, float z2, int i2, float l2) {
  if (z2 > z || (z2 == z && i2 < i)) { z = z2; i = i2; l = l2; }
}

__device__ __forceinline__ void block_argmax(float& z, int& i, float& l, float* sh_z, int* sh_i, float* sh_l) {
  for (int o = 16; o > 0; o >>= 1) {
    const float z2 = __shfl_xor_sync(0xffffffffu, z, o);
    const int i2 = __shfl_xor_sync(0xffffffffu, i, o);
    const float l2 = __shfl_xor_sync(0xffffffffu, l, o);
    argmax_merge(z, i, l, z2, i2, l2);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) { sh_z[warp] = z; sh_i[warp] = i; sh_l[warp] = l; }
  __syncthreads();
  z = sh_z[lane];
  i = sh_i[lane];
  l = sh_l[lane];
  for (int o = 16; o > 0; o >>= 1) {
    const float z2 = __shfl_xor_sync(0xffffffffu, z, o);
    const int i2 = __shfl_xor_sync(0xffffffffu, i, o);
    const float l2 = __shfl_xor_sync(0xffffffffu, l, o);
    argmax_merge(z, i, l, z2, i2, l2);
  }
}

template <typename T, bool PAIR, bool NOISE, bool STAGED>
__global__ void __launch_bounds__(kThreads)
sample_kernel(const T* __restrict__ logits, const float* __restrict__ noise,
              const int* __restrict__ seed_ptr, int rows, int V, int k, float temp,
              float scale, int* __restrict__ idx_out, float* __restrict__ prob_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int* ring = reinterpret_cast<int*>(smem_raw);  // [kWarps][kRing]
  __nv_bfloat16* srow = reinterpret_cast<__nv_bfloat16*>(smem_raw + kWarps * kRing * sizeof(int));
  __shared__ float sh_a[kWarps], sh_b[kWarps];
  __shared__ int sh_i[kWarps];

  const int row = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  Row<T, PAIR, STAGED> val;
  val.cond = logits + (size_t)row * V;
  val.null = PAIR ? logits + ((size_t)rows + row) * V : nullptr;
  val.staged = srow;
  val.scale = scale;
  val.V = V;

  // -- pass 1: (stage the row,) min and max
  float lo = FLT_MAX, hi = -FLT_MAX;
  if (STAGED) {
    if ((V & 7) == 0) {
      const uint4* g = reinterpret_cast<const uint4*>(val.cond);
      uint4* s = reinterpret_cast<uint4*>(srow);
      for (int c = tid; c < (V >> 3); c += kThreads) {
        const uint4 u = g[c];
        s[c] = u;
        const float x[8] = {bf16_lo(u.x), bf16_hi(u.x), bf16_lo(u.y), bf16_hi(u.y),
                            bf16_lo(u.z), bf16_hi(u.z), bf16_lo(u.w), bf16_hi(u.w)};
#pragma unroll
        for (int j = 0; j < 8; ++j) { lo = fminf(lo, x[j]); hi = fmaxf(hi, x[j]); }
      }
    } else {
      const __nv_bfloat16* g = reinterpret_cast<const __nv_bfloat16*>(val.cond);
      for (int i = tid; i < V; i += kThreads) {
        const __nv_bfloat16 x = g[i];
        srow[i] = x;
        lo = fminf(lo, __bfloat162float(x));
        hi = fmaxf(hi, __bfloat162float(x));
      }
    }
  } else {
    for (int i = tid; i < V; i += kThreads) {
      const float f = val(i);
      lo = fminf(lo, f);
      hi = fmaxf(hi, f);
    }
  }
  block_min_max(lo, hi, sh_a, sh_b);  // its barriers also publish the staged row
  const float row_max = hi;

  // -- pass 2: logsumexp of the unfiltered row + bisection round 1
  float lse;
  {
    const float mid = 0.5f * (lo + hi);
    int cnt = 0;
    float s = 0.0f;
    val.visit([&](int, const float* x, int n, bool valid) {
      if (!valid) return;
      for (int j = 0; j < n; ++j) {
        s += expf(x[j] - row_max);
        cnt += x[j] >= mid ? 1 : 0;
      }
    });
    block_sum2(cnt, s, sh_i, sh_a);
    lse = logf(s) + row_max;
    if (cnt >= k) lo = mid; else hi = mid;
  }
  // -- passes 3..11: bisection rounds 2..10
  for (int it = 1; it < kBisectIters; ++it) {
    const float mid = 0.5f * (lo + hi);
    int cnt = 0;
    val.visit([&](int, const float* x, int n, bool valid) {
      if (!valid) return;
      for (int j = 0; j < n; ++j) cnt += x[j] >= mid ? 1 : 0;
    });
    cnt = block_sum_int(cnt, sh_i);
    if (cnt >= k) lo = mid; else hi = mid;
  }
  const float thresh = lo;

  // -- pass 12: filtered, temperature-scaled gumbel argmax. Columns at or
  // above the threshold go into the warp's ring; every 32 of them, each
  // lane draws the noise of one and scores it.
  const float t = fmaxf(temp, 1e-10f);
  const uint32_t seed = NOISE ? 0u : (uint32_t)seed_ptr[0];
  int* wring = ring + warp * kRing;
  float best_z = -INFINITY, best_l = 0.0f;
  int best_i = INT32_MAX;
  auto score = [&](int i) {
    const float l = val(i);
    float g;
    if (NOISE) {
      g = noise[(size_t)row * V + i];
    } else {
      const uint4 b = philox4x32_10((uint32_t)(i >> 2), seed, (uint32_t)row);
      const int w = i & 3;
      g = bits_to_gumbel(w == 0 ? b.x : w == 1 ? b.y : w == 2 ? b.z : b.w);
    }
    const float z = l / t + g;
    argmax_merge(best_z, best_i, best_l, z, i, l);
  };
  int head = 0, tail = 0;  // ring positions, the same in every lane of the warp
  val.visit([&](int i0, const float* x, int n, bool valid) {
    unsigned pass = 0u;
    if (valid)
      for (int j = 0; j < n; ++j) pass |= (x[j] >= thresh ? 1u : 0u) << j;
    // exclusive prefix of the lanes' counts
    const int cnt = __popc(pass);
    int incl = cnt;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += y;
    }
    const int total = __shfl_sync(0xffffffffu, incl, 31);
    int pos = tail + incl - cnt;
    while (pass) {
      const int j = __ffs(pass) - 1;
      pass &= pass - 1;
      wring[(pos++) & (kRing - 1)] = i0 + j;
    }
    tail += total;
    __syncwarp();
    while (tail - head >= 32) {
      score(wring[(head + lane) & (kRing - 1)]);
      head += 32;
    }
    __syncwarp();
  });
  if (lane < tail - head) score(wring[(head + lane) & (kRing - 1)]);
  // columns below the threshold are never scored (the TPU kernel gives them
  // -1e30, which cannot win: the row maximum always passes)
  block_argmax(best_z, best_i, best_l, sh_a, sh_i, sh_b);
  if (tid == 0) {
    idx_out[row] = best_i;
    prob_out[row] = expf(best_l - lse);
  }
}

template <typename T, bool PAIR, bool NOISE, bool STAGED>
cudaError_t launch(const void* logits, const void* noise, const void* seed, void* idx, void* prob,
                   int rows, int V, int k, float temp, float scale, cudaStream_t stream) {
  auto kern = sample_kernel<T, PAIR, NOISE, STAGED>;
  const size_t smem = kWarps * kRing * sizeof(int) + (STAGED ? (size_t)V * sizeof(__nv_bfloat16) : 0);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<rows, kThreads, smem, stream>>>(
      static_cast<const T*>(logits), static_cast<const float*>(noise), static_cast<const int*>(seed),
      rows, V, k, temp, scale, static_cast<int*>(idx), static_cast<float*>(prob));
  return cudaGetLastError();
}

template <typename T, bool PAIR, bool STAGED>
cudaError_t dispatch_noise(bool has_noise, const void* logits, const void* noise, const void* seed,
                           void* idx, void* prob, int rows, int V, int k, float temp, float scale,
                           cudaStream_t stream) {
  return has_noise ? launch<T, PAIR, true, STAGED>(logits, noise, seed, idx, prob, rows, V, k, temp, scale, stream)
                   : launch<T, PAIR, false, STAGED>(logits, noise, seed, idx, prob, rows, V, k, temp, scale, stream);
}

}  // namespace

extern "C" {

// logits: (rows, V), or (2 * rows, V) cond rows then null rows when
// cfg_pair; dtype 0 = f32, 1 = bf16. noise: (rows, V) f32 or null. seed: one
// int32 in device memory (read by the kernel, so the host never syncs).
// Outputs idx int32 (rows,), prob f32 (rows,). Returns cudaGetLastError().
int muse_sample_launch(const void* logits, const void* noise, const void* seed, void* idx,
                       void* prob, int rows, int V, int k, float temp, float scale, int dtype,
                       int cfg_pair, void* stream) {
  if (rows <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool has_noise = noise != nullptr;
  if (dtype == 1) {
    if (cfg_pair)
      return dispatch_noise<__nv_bfloat16, true, false>(has_noise, logits, noise, seed, idx, prob, rows, V, k, temp, scale, s);
    if ((size_t)V * 2 <= (size_t)kMaxStagedBytes)
      return dispatch_noise<__nv_bfloat16, false, true>(has_noise, logits, noise, seed, idx, prob, rows, V, k, temp, scale, s);
    return dispatch_noise<__nv_bfloat16, false, false>(has_noise, logits, noise, seed, idx, prob, rows, V, k, temp, scale, s);
  }
  if (cfg_pair)
    return dispatch_noise<float, true, false>(has_noise, logits, noise, seed, idx, prob, rows, V, k, temp, scale, s);
  return dispatch_noise<float, false, false>(has_noise, logits, noise, seed, idx, prob, rows, V, k, temp, scale, s);
}

const char* muse_sample_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
