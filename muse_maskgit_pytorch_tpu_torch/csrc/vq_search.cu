// Nearest-codebook search, fused distance + argmax, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_vq_kernel` in muse_maskgit_pytorch_tpu/ops/vq.py
// (Pallas). For x (n, d) and a codebook (K, d), both f32 and row-major, and
// cb_sq (K,) f32, it writes per row the int32 argmax over codes of
//   score = 2 * x . c - cb_sq[c],
// the lowest index among equal scores (jnp.argmax within a tile, and a later
// tile winning only when strictly greater, in the Pallas kernel). The (n, K)
// score matrix never reaches device memory.
//
// What bounds it on the H100: arithmetic. At the EMA-VQ path's shape
// (n 8192, K 65536, d 256) the search is 2.75e11 f32 FLOP against 8 MB of
// x and a 64 MB codebook; on CUDA cores (67 TFLOP/s f32 on the H100 SXM data
// sheet) that is at least about 4 ms.
//
// Design. The Pallas kernel carries a running max and argmax across its
// sequential k grid axis in VMEM; Hopper's blocks run in no order, so the
// loop over codebook tiles lives inside the block:
//   * one block of 256 threads owns 128 rows of x, staged once in shared
//     memory (transposed, 132 KB at d 256, hence one block per SM);
//   * it streams its share of the codebook in 128-code x 32-dim chunks
//     through a double-buffered shared-memory tile, the next chunk's global
//     loads in flight while the current one is used;
//   * each thread accumulates an 8 x 8 register tile of dot products over
//     the whole of d in one fixed order (so identical code rows score
//     identically), then folds the tile's scores into a running (best, arg)
//     per row, replacing only on a strictly greater score, codes in
//     increasing order;
//   * 128 row tiles would leave SMs idle, so the codebook is split across
//     blocks (grid.y) until the blocks fill the SMs; each block reduces its
//     rows over its 16 threads (ties to the lower index) and merges into a
//     per-row 64-bit key with atomicMax: high word the score's
//     order-preserving bits, low word ~index, so the larger score, then the
//     lower index, wins whatever order the blocks finish in;
//   * a second small kernel turns the keys into int32 ids.
// Padded codes (K not a multiple of 128) are skipped, never scored; padded
// rows (n not a multiple of 128) are never written. Tensor-core search
// (3xTF32 or split bf16, wgmma/TMA) is later work.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;       // threads: 16 x 16, each an 8 x 8 tile
constexpr int BM = 128;       // rows of x per block
constexpr int BN = 128;       // codes per tile
constexpr int BK = 32;        // dims per codebook chunk
constexpr int BMP = BM + 4;   // padded strides of the transposed tiles
constexpr int BNP = BN + 4;
constexpr int MAX_D = 256;

// (score, index) -> a key whose unsigned order is (score, then lower index)
__device__ __forceinline__ unsigned long long pack_key(float s, int idx) {
  unsigned u = __float_as_uint(s);
  if (u == 0x80000000u) u = 0u;  // -0 and +0 are one score
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<unsigned long long>(u) << 32) | (0xFFFFFFFFu - static_cast<unsigned>(idx));
}

__global__ void __launch_bounds__(NT, 1)
vq_search_kernel(const float* __restrict__ x, const float* __restrict__ cb,
                 const float* __restrict__ cb_sq, unsigned long long* __restrict__ keys, int n,
                 int K, int d, int dp, int tiles_per_split) {
  extern __shared__ __align__(16) float smem[];
  float* Xs = smem;             // [dp][BMP]  this block's rows of x, transposed
  float* Cs = Xs + dp * BMP;    // [2][BK][BNP] codebook chunks, transposed

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int row0 = blockIdx.x * BM;
  const int code_tiles = (K + BN - 1) / BN;
  const int t_begin = blockIdx.y * tiles_per_split;
  const int t_end = min(t_begin + tiles_per_split, code_tiles);
  if (t_begin >= t_end) return;
  const int chunks = dp / BK;  // chunks per code tile
  const int steps = (t_end - t_begin) * chunks;

  // rows of x, zero beyond n and beyond d (zeros add nothing to the dots)
  for (int e = tid; e < BM * (dp / 4); e += NT) {
    const int r = e % BM, c = (e / BM) * 4;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (row0 + r < n && c < d) v = *reinterpret_cast<const float4*>(x + (long long)(row0 + r) * d + c);
    Xs[(c + 0) * BMP + r] = v.x;
    Xs[(c + 1) * BMP + r] = v.y;
    Xs[(c + 2) * BMP + r] = v.z;
    Xs[(c + 3) * BMP + r] = v.w;
  }

  // chunk s: code tile t_begin + s / chunks, dims (s % chunks) * BK + [0, BK)
  float4 reg[BN * BK / 4 / NT];
  auto load_chunk = [&](int s) {
    const int c0 = (t_begin + s / chunks) * BN, k0 = (s % chunks) * BK;
#pragma unroll
    for (int i = 0; i < BN * BK / 4 / NT; ++i) {
      const int e = tid + i * NT, code = c0 + e % BN, dim = k0 + (e / BN) * 4;
      reg[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (code < K && dim < d) reg[i] = *reinterpret_cast<const float4*>(cb + (long long)code * d + dim);
    }
  };
  auto store_chunk = [&](float* C) {
#pragma unroll
    for (int i = 0; i < BN * BK / 4 / NT; ++i) {
      const int e = tid + i * NT, code = e % BN, dd = (e / BN) * 4;
      C[(dd + 0) * BNP + code] = reg[i].x;
      C[(dd + 1) * BNP + code] = reg[i].y;
      C[(dd + 2) * BNP + code] = reg[i].z;
      C[(dd + 3) * BNP + code] = reg[i].w;
    }
  };

  float acc[8][8];
  float best[8];
  int arg[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    best[i] = -INFINITY;
    arg[i] = INT_MAX;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  }

  load_chunk(0);
  store_chunk(Cs);
  __syncthreads();

  for (int s = 0; s < steps; ++s) {
    const float* C = Cs + (s & 1) * BK * BNP;
    if (s + 1 < steps) load_chunk(s + 1);  // in flight during the products
    const float* X = Xs + (s % chunks) * BK * BMP;
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&X[kk * BMP + ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&X[kk * BMP + 64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&C[kk * BNP + tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&C[kk * BNP + 64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }

    if (s % chunks == chunks - 1) {
      // the tile's dots are complete: fold its scores into (best, arg),
      // codes in increasing order, strictly greater to replace
      const int c0 = (t_begin + s / chunks) * BN;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = c0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4));
        if (c < K) {
          const float sq = cb_sq[c];
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float sc = 2.0f * acc[i][j] - sq;
            if (sc > best[i]) {
              best[i] = sc;
              arg[i] = c;
            }
          }
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i][j] = 0.0f;
      }
    }

    if (s + 1 < steps) store_chunk(Cs + ((s + 1) & 1) * BK * BNP);
    __syncthreads();
  }

  // reduce each row over its 16 threads (one half-warp), ties to the lower
  // index, and merge across the codebook splits
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float b = best[i];
    int a = arg[i];
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, b, o);
      const int oa = __shfl_xor_sync(0xffffffffu, a, o);
      if (ob > b || (ob == b && oa < a)) {
        b = ob;
        a = oa;
      }
    }
    const int row = row0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4));
    if (tx == 0 && row < n && a != INT_MAX) atomicMax(&keys[row], pack_key(b, a));
  }
}

__global__ void vq_finalize_kernel(const unsigned long long* __restrict__ keys, int* __restrict__ out,
                                   int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = static_cast<int>(0xFFFFFFFFu - static_cast<unsigned>(keys[i] & 0xFFFFFFFFull));
}

}  // namespace

extern "C" {

// x (n, d), cb (K, d), cb_sq (K,): f32, contiguous, 16-byte aligned;
// d a multiple of 4, at most 256. keys: n uint64 of scratch; out: n int32.
// ksplit: codebook splits per row tile. Returns cudaGetLastError().
int muse_vq_search_launch(const void* x, const void* cb, const void* cb_sq, void* keys, void* out,
                          int n, int K, int d, int ksplit, void* stream) {
  if (n <= 0) return 0;
  if (K <= 0 || d <= 0 || d % 4 != 0 || d > MAX_D || ksplit <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int dp = (d + BK - 1) / BK * BK;
  const size_t smem = sizeof(float) * ((size_t)dp * BMP + 2 * BK * BNP);
  cudaError_t e = cudaFuncSetAttribute(vq_search_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  const int code_tiles = (K + BN - 1) / BN;
  const int tiles_per_split = (code_tiles + ksplit - 1) / ksplit;
  const int splits = (code_tiles + tiles_per_split - 1) / tiles_per_split;
  e = cudaMemsetAsync(keys, 0, sizeof(unsigned long long) * (size_t)n, s);
  if (e != cudaSuccess) return e;
  const dim3 grid((n + BM - 1) / BM, splits);
  vq_search_kernel<<<grid, NT, smem, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(cb), static_cast<const float*>(cb_sq),
      static_cast<unsigned long long*>(keys), n, K, d, dp, tiles_per_split);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  vq_finalize_kernel<<<(n + 255) / 256, 256, 0, s>>>(static_cast<const unsigned long long*>(keys),
                                                     static_cast<int*>(out), n);
  return cudaGetLastError();
}

const char* muse_vq_search_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
