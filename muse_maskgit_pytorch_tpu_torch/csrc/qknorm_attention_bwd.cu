// The backward of K2, the fused qk-l2norm attention with a learned null
// key/value per head, for Hopper (sm_90a).
//
// The TPU has no kernel to replace here: JAX's backward of `_qknorm_kernel`
// (`_qknorm_bwd` in muse_maskgit_pytorch_tpu/ops/attention.py) is XLA's vjp
// of `_qknorm_xla`, a recompute of the whole attention in plain ops. This is
// the port's own kernel for the function that vjp computes. Per (batch,
// head), from the output gradient g (b, n, h, d), with u = t / |t| and
// r = 1 / |t| (eps 1e-12 inside the rsqrt) for q, k and the null key:
//   q^ = u_q q_scale scale, k^ = u_k k_scale, nk^ = u_nk k_scale;
//   P = exp([s0, S + bias] - LSE), the row logsumexp LSE saved by the forward;
//   D = rowsum(g out); dP = g [nv; v]^T; dS = P (dP - D);
//   dv = P^T g, d nv = sum P_0 g; dq^ = dS [nk^; k^]; dk^ = dS^T q^,
//   d nk^ = sum dS_0 q^; through each norm dt = r (w - u (u . w)) with w the
//   gradient of t^ times its scale; d q_scale = scale sum dq^ u_q,
//   d k_scale = sum dk^ u_k + sum_h d nk^ u_nk. The key bias gets none.
//
// What bounds it on the H100. At d 64 the backward does 10 n m d FLOP a
// head (S and dP, dV, dQ, dK) against one read of q, k, v, out and g and one
// write of dq, dk and dv: about 64 FLOP a byte at 64 keys and 160 at 256,
// under the 295 at which the tensor cores would set the pace, so at the
// base stage's shapes the bytes bound it (0.040 ms at (64, 256, 8, 64) x
// 256); at the super-res stage's 1024 keys, about 300, the two meet.
//
// bf16, n <= 256 (every base-stage train shape): `onepass`, one launch. A
// block per (batch, head) holds the q side whole in 196 KiB of shared memory
// (raw q, q^ and g, 96 KB at n = 256) and reads every input once: q, g and
// out in the prologue (q^ rounded where the forward rounds it, D, the null
// column and its d nv / d nk^ sums from values in hand), k and v as 64-key
// tiles through a two-stage cp.async ring, k^ normalised as a tile lands.
// Its two warpgroups take each key tile together, each over its own query
// tiles: S^T and dP^T once per tile pair, P^T and dS^T in registers as the
// A fragments of dV += P^T g and dK^ += dS^T q^, and dQ^ += dS k^ from dS^T
// stored to shared memory (`wgmma` with both operands MN-major). Each
// warpgroup keeps dQ^ of its two query tiles in registers for the whole
// block, so nothing is recomputed and no q^ / k^ round trip through device
// memory is left: the block's floor is the bytes bound itself. The
// warpgroups swap their dK^ / dV halves through shared memory at the end of
// each key tile; dv, dk (k's norm from the raw k tile still in the ring)
// and at the end dq (q's norm) are staged in shared memory and written 16
// bytes a thread. Each block writes one row of the scale and null
// gradients' partial sums; the last block of each head sums that head's
// rows, and the last of those the heads' (integer tickets, zeroed by a
// memset before the launch). One block per SM (its shared memory and 249
// registers a thread): 512 blocks at the base shapes, about 4 waves, each
// block's loads, prologue and epilogue overlapping nothing; its clocks by
// part come from the -DQKNORM_BWD_TIMING build.
//
// bf16, n > 256 (the super-res stage's shapes): two TMA pipelines, four
// launches. `queries_bf16` (a block per 128 queries: q^ and g resident,
// k^ / v tiles streamed) takes q's norm, D = rowsum(g out), which it writes
// for the next kernel, the null column and dQ^ with S and dP recomputed, so
// 14 n m d FLOP a head against the bound's 10 (dQ^ parts in f32 would move
// 537 MB each way at the super-res self shape). `keys_bf16` (a block per
// 128 keys: k^ and v resident, q^ / g tiles streamed with LSE and D) takes
// dK^ and dV. In each, two consumer warpgroups own 64 rows apiece and a
// producer warpgroup feeds them by TMA through a four-stage ring with full
// / ready / empty mbarriers a stage; each streamed tile is normalised in
// place in shared memory (so no q^ / k^ round trip through device memory).
// The consumers leave a `wgmma` group in flight: a tile's exponentials run
// under its dP product, its dS under the dV product. `setmaxnreg` gives
// the consumers 216 registers a thread. Then `sum_rows` and `reduce`. At
// the super-res shapes it takes 0.94x / 0.82x the time of PR 9's route
// (self / cross) but 1.35-1.38x SDPA's backward: the exponentials (twice,
// with the recompute) and the S and dP products, which read both operands
// from shared memory, leave the tensor cores idle about 70% of the time
// (PERF.md, PR 13).
//
// f32, every n: IEEE f32 on the CUDA cores (no TF32), whose 67 TFLOP/s
// set the pace: 10 n m d FLOP a head at d 64 is 0.321 ms at (64, 256, 8,
// 64) x 256 against 0.040 ms of bytes. Two kernels, then the sums.
// `keys_f32`, a block per (64 keys, head, batch), holds k^ and v in shared
// memory and streams the query tiles through a two-stage cp.async ring; as
// a tile lands it takes the rows' |q|^2 and D = g . out (so no `prep` and
// no q^ / k^ round trip through device memory) and transposes q and g.
// S^T and dP^T are computed once per tile pair, and dV and dK^ stay in
// registers, so the products are the bound's 10 n m d: the tile's dQ^
// goes out as a part, r_q dQ^ = (dS r_q) k^ for its 64 keys, in place of
// the recompute. Its register tiles are 4 x 4 with a warp's lanes 8 x 4
// over each product, so every operand read is one shared-memory
// wavefront, and the loops are unrolled; one block an SM (202 KiB).
// `queries_f32`, a block per
// 64 queries, sums each row's parts in key order with the null column and
// q's norm (memory-bound: the parts are 4 n D bytes a key tile, 537 MB at
// the super-res self shape). Then `sum_rows` and `reduce` sum the rows of
// the scale and null gradients in two fixed-order stages, as on the bf16
// split route: four launches a call.
//
// Every route: no float atomics, so two launches on the same inputs give
// bit-identical gradients. Rows past n or m are zero-filled and masked by
// LSE = +inf / bias = -inf; a fully masked row (bias -1e30) or m = 0 gives
// P = 0 on every key, dq = 0 through the keys and all of g to null_v. The
// one-pass and f32 kernels' tiles arrive by cp.async, each block waiting on
// its own copy groups and barriers; the bf16 split route's rings wait
// through `mbar_wait` (attention_core.cuh), which a build with
// -DATTENTION_CORE_WATCHDOG turns into a trap after about ten seconds.

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_core.cuh"

namespace {

namespace ac = attention_core;

constexpr int D = 64;            // head dim
constexpr int T = 64;            // rows of a tile (keys or queries)
constexpr int ROWB = D * 2;      // bytes of one bf16 row, the 128-byte swizzle
constexpr int TILE = T * ROWB;   // one bf16 tile
constexpr int NTH = 128;         // bf16 kernels: one warpgroup
constexpr int EP = D + 4;        // padded row of the f32 epilogue tiles
constexpr float LOG2E = 1.4426950408889634f;

// -- small helpers ------------------------------------------------------------

__device__ __forceinline__ void load8(const float* p, float* x) {
  const float4 a = *reinterpret_cast<const float4*>(p), b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w, x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
}
__device__ __forceinline__ void store8(float* p, const float* x) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(x[4], x[5], x[6], x[7]);
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid
__device__ __forceinline__ void cp16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// a 64-row bf16 tile into the swizzled K-major layout `wgmma` reads: row r
// from src + r * stride (elements), rows >= rows zero-filled; NT threads
template <int NT = NTH>
__device__ __forceinline__ void tile_async(uint32_t dst, const __nv_bfloat16* src, long long stride, int rows,
                                           int tid) {
#pragma unroll
  for (int it = 0; it < T * 8 / NT; ++it) {
    const int c = tid + it * NT, r = c >> 3, ch = c & 7;
    const bool ok = r < rows;
    cp16(dst + ac::swz<ROWB>(r, ch), ok ? src + r * stride + ch * 8 : src, ok);
  }
}

// 32 values of row r of a swizzled bf16 tile (half 0: columns 0-31, 1: 32-63)
__device__ __forceinline__ void tile_row_half(const unsigned char* tile, int r, int half, float* x) {
#pragma unroll
  for (int c = 0; c < 4; ++c) ac::unpack8(*reinterpret_cast<const uint4*>(tile + ac::swz<ROWB>(r, half * 4 + c)), x + 8 * c);
}
// The f32 keys kernel's epilogue: acc (rows x 64, f32, two threads
// a row, half a row each) holds dt^ of `rows` rows starting at row0 of the
// raw input t (strides t_s). Writes dt = r (w - u (u . w)), w = dt^ * sc,
// into dst (row stride H * D), and leaves dt^ u in acc for the scale's sum.
template <typename TT>
__device__ __forceinline__ void norm_chain_rows(float* acc, const TT* t, long long t_s, int rows, const float* sc,
                                                TT* dst, long long d_s, int tid, int nthreads) {
  for (int idx = tid; idx < 2 * T; idx += nthreads) {
    const int r = idx >> 1, half = idx & 1;
    float u[32], w[32];
    float* a = acc + r * EP + half * 32;
    const bool ok = r < rows;
    float ss = 0.0f;
    if (ok) {
#pragma unroll
      for (int c = 0; c < 4; ++c) load8(t + r * t_s + half * 32 + 8 * c, u + 8 * c);
    } else {
#pragma unroll
      for (int e = 0; e < 32; ++e) u[e] = 0.0f;
    }
#pragma unroll
    for (int e = 0; e < 32; ++e) ss += u[e] * u[e];
    ss += __shfl_xor_sync(0xffffffffu, ss, 1);
    const float rr = rsqrtf(ss + 1e-12f);
    float uw = 0.0f;
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      u[e] *= rr;
      w[e] = a[e] * sc[half * 32 + e];
      uw += u[e] * w[e];
    }
    uw += __shfl_xor_sync(0xffffffffu, uw, 1);
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      a[e] *= u[e];
      w[e] = rr * (w[e] - u[e] * uw);
    }
    if (ok) {
#pragma unroll
      for (int c = 0; c < 4; ++c) store8(dst + r * d_s + half * 32 + 8 * c, w + 8 * c);
    }
  }
}

// column sums of a (64 x 64, padded) f32 tile in row order, times mul
__device__ __forceinline__ void column_sums(const float* acc, float* dst, float mul, int tid) {
  if (tid < D) {
    float s = 0.0f;
    for (int r = 0; r < T; ++r) s += acc[r * EP + tid];
    dst[tid] = s * mul;
  }
}

// the arguments every main kernel takes
template <typename TT>
struct Bwd {
  const TT *g, *q, *k, *v, *out, *nk, *nv;
  const float *lse, *q_scale, *k_scale, *bias;
  float* delta;  // D (B, H, n): the split routes' first kernel writes it
  TT *dq, *dk, *dv, *dnk, *dnv;
  float *dqs, *dks;
  // per-block partials, (blocks, H, D): d q_scale, d k_scale, d nk^, d nv;
  // one-pass: each head's sums (H, 3, D) and H + 1 tickets, zero at the
  // launch
  float *dqs_part, *dks_part, *dnk_part, *dnv_part, *head_sums;
  float* dpart;  // f32: the key tiles' r_q dQ^ (B, H, key tiles, n, D)
  int* counter;
  long long* clocks;  // -DQKNORM_BWD_TIMING: the one-pass kernel's clocks, 10 a block
  long long g_sb, g_sn, q_sb, q_sn, k_sb, k_sm, v_sb, v_sm;
  int n, m, H;
  float scale;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename TT>
__device__ __forceinline__ TT from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) { return __float2bfloat16(x); }

// -- the one-pass kernel's partials, summed in a fixed order ---------------------------

// Every partial is (B, H, D) f32, one row a block. Each head's last block
// to finish sums that head's rows over the batch: d nv and d nk^ (the
// latter through the null key's norm) are then final, and d q_scale,
// d k_scale and d nk^ u_nk go to the head's row of `head_sums`; the last
// of those sums the H rows. An integer ticket a head and one more, zeroed
// by a memset before the launch. At a ticket a block's threads meet at a
// barrier, then its first thread fences (cumulative over the block's
// writes, as the barrier orders them) and takes the ticket; the last
// arrival's first thread fences again before the barrier that lets its
// block read. Sums are read with ld.global.cg (L2): an earlier launch's
// reducer may have left the same addresses in this SM's L1.
__device__ __forceinline__ bool last_arrival(int* counter, int arrivals) {
  __shared__ int last;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(counter, 1) == arrivals - 1;
    if (last) __threadfence();
  }
  __syncthreads();
  return last;
}

// Called by every block of head h when its partials are written;
// `scratch`: (blockDim / 4 + 4) x D floats of shared memory.
template <typename TT>
__device__ void reduce_partials(const Bwd<TT>& p, int h, int B, float* scratch) {
  const int H = p.H;
  if (!last_arrival(p.counter + h, B)) return;
  const int tid = threadIdx.x, parts = blockDim.x / 16, c4 = tid & 15, part = tid >> 4;
  float4* sums = reinterpret_cast<float4*>(scratch);  // [4][parts][16]
  const float* src[4] = {p.dqs_part, p.dks_part, p.dnv_part, p.dnk_part};
  {  // a thread: four columns of each partial over one part of the batch, in order
    const int per = (B + parts - 1) / parts, b0 = min(B, part * per), b1 = min(B, b0 + per);
    float4 acc[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) acc[a] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 4
    for (int b = b0; b < b1; ++b) {
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float4 x = __ldcg(reinterpret_cast<const float4*>(src[a] + ((long long)b * H + h) * D) + c4);
        acc[a].x += x.x, acc[a].y += x.y, acc[a].z += x.z, acc[a].w += x.w;
      }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) sums[(a * parts + part) * 16 + c4] = acc[a];
  }
  __syncthreads();
  float* tot = scratch + 4 * parts * 64;  // [4][D]: d q_scale, d k_scale, d nv, d nk^ of head h
  for (int i = tid; i < 4 * D; i += blockDim.x) {
    const int a = i / D, c = i % D;
    float t = 0.0f;
    for (int pp = 0; pp < parts; ++pp) t += reinterpret_cast<const float*>(sums + (a * parts + pp) * 16)[c];
    tot[a * D + c] = t;
  }
  __syncthreads();
  float* mine = p.head_sums + (long long)h * 3 * D;  // d q_scale, d k_scale, d nk^ u_nk of head h
  if (tid < 32) {  // d nk^ through the null key's norm
    float u[2], w[2], ss = 0.0f, uw = 0.0f;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      u[e] = to_f(p.nk[h * D + tid + 32 * e]);
      ss += u[e] * u[e];
    }
    const float r = rsqrtf(warp_sum(ss) + 1e-12f);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = tid + 32 * e;
      u[e] *= r;
      w[e] = tot[3 * D + c] * p.k_scale[c];
      uw += u[e] * w[e];
    }
    uw = warp_sum(uw);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = tid + 32 * e;
      p.dnk[h * D + c] = from_f<TT>(r * (w[e] - u[e] * uw));
      p.dnv[h * D + c] = from_f<TT>(tot[2 * D + c]);
      mine[c] = tot[c];
      mine[D + c] = tot[D + c];
      mine[2 * D + c] = tot[3 * D + c] * u[e];
    }
  }
  if (!last_arrival(p.counter + H, H)) return;
  if (tid < D) {
    float a = 0.0f, k = 0.0f, cn = 0.0f;
    for (int hh = 0; hh < H; ++hh) {
      a += __ldcg(p.head_sums + hh * 3 * D + tid);
      k += __ldcg(p.head_sums + hh * 3 * D + D + tid);
      cn += __ldcg(p.head_sums + hh * 3 * D + 2 * D + tid);
    }
    p.dqs[tid] = a;
    p.dks[tid] = k + cn;
  }
}

// -- bf16, one pass over each (batch, head): n <= 256 -------------------------------

// Built with -DQKNORM_BWD_TIMING, the one-pass kernel leaves, for each block,
// its start and end on the global timer (ns), its SM, and the SM clocks its
// thread 0 (warpgroup 0) spent in each part: the q-side loads, the
// prologue, each key tile's wait and k^, the tile pairs, the warpgroups'
// exchange with dv and dk, dq's epilogue, the partials' reduction. A part
// ends where thread 0 gets there, so one that ends at a barrier holds its
// wait for the other threads.
constexpr int CLOCK_SLOTS = 10;  // as `ops/attention.py` reads them
#ifdef QKNORM_BWD_TIMING
__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define BWD_TICK(part)                        \
  do {                                        \
    if (tid == 0) {                           \
      const long long now = clock64();        \
      clk[3 + (part)] += now - clk_t;         \
      clk_t = now;                            \
    }                                         \
  } while (0)
#else
#define BWD_TICK(part) \
  do {                 \
  } while (0)
#endif

// d (64 x 64, f32) += A (64 x 16, smem, MN-major) B (16 x 64, smem, MN-major):
// dQ^ += dS k^ with dS^T and k^ as they lie in shared memory
__device__ __forceinline__ void wgmma_ss_tt(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// Sums a[32] over the 16 lanes that share lane & 1 (partners lane ^ 2, 4,
// 8, 16), scattering the result: afterwards a[0], a[1] hold the sums of
// columns c, c + 1, c = 16 b4 + 8 b3 + 4 b2 + 2 b1 from the lane's bits.
template <int LEN, int O>
__device__ __forceinline__ void rs_step(float (&a)[32], int lane) {
  const bool upper = lane & O;
#pragma unroll
  for (int i = 0; i < LEN / 2; ++i) {
    const float keep = upper ? a[i + LEN / 2] : a[i], send = upper ? a[i] : a[i + LEN / 2];
    a[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
  }
}
__device__ __forceinline__ void reduce_scatter32(float (&a)[32], int lane) {
  rs_step<32, 16>(a, lane);
  rs_step<16, 8>(a, lane);
  rs_step<8, 4>(a, lane);
  rs_step<4, 2>(a, lane);
}

constexpr int OP_NQ = 4;           // query tiles a block holds: n <= 256
constexpr int OP_N = OP_NQ * T;
constexpr int OP_NTH = 256;        // two warpgroups

struct OnePassSmem {
  static constexpr int QH_OFF = 0;                     // [4] q^ tiles, rows past n zero
  static constexpr int G_OFF = QH_OFF + OP_NQ * TILE;  // [4] g tiles
  static constexpr int QR_OFF = G_OFF + OP_NQ * TILE;  // [4] raw q tiles
  static constexpr int KR_OFF = QR_OFF + OP_NQ * TILE; // [2] raw k tiles, a ring
  static constexpr int V_OFF = KR_OFF + 2 * TILE;      // [2] v tiles
  static constexpr int KH_OFF = V_OFF + 2 * TILE;      // k^ of the key tile in hand
  static constexpr int DS_OFF = KH_OFF + TILE;         // [2] dS^T, one a warpgroup
  static constexpr int XCH_OFF = DS_OFF + 2 * TILE;    // [2][32][128] f32: the warpgroups' dK^ / dV halves
  static constexpr int VEC_OFF = XCH_OFF + 2 * T * D * 4;
  // f32: lse2, del, ds0, rq [OP_N]; kb, rk, nkh, nvs, qsc, ksc [64]; red_a, red_b, ks_acc [8][64]
  static constexpr int BYTES = VEC_OFF + (4 * OP_N + 6 * D + 3 * 8 * D) * 4;
  static constexpr int ALLOC = BYTES + 1024;
  static_assert(2 * T * D * 4 >= (OP_NTH / 4 + 4) * D * 4, "the reduction's scratch fits the exchange");
};

// One block per (head, batch), two warpgroups. The block holds the raw q,
// q^ and g of every query row (read once) and streams the key tiles once
// through a two-stage cp.async ring of raw k and v; k^ is normalised as a
// tile lands. Both warpgroups take the key tile in hand, each over its own
// query tiles (wg, wg + 2): S^T, dP^T once per tile pair, then dV += P^T g,
// dK^ += dS^T q^ (A in registers) and dQ^ += dS k^ (dS^T through shared
// memory, `wgmma` with both operands MN-major), dQ^ in registers for the
// whole kernel. At the end of a key tile the warpgroups swap halves: 0 sums
// dv, 1 sums dK^ and applies k's norm, each staging its rows in its dS^T
// tile for 16-byte stores. The null column, D and the d nv / d nk^ rows
// come from the prologue, dq's norm and the d q_scale row from the
// epilogue (dq staged in the g tiles); `reduce_partials` sums the rows.
__global__ void __launch_bounds__(OP_NTH, 1) qknorm_bwd_onepass_bf16(const Bwd<__nv_bfloat16> p) {
  using L = OnePassSmem;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (ac::smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sbase = ac::smem_u32(smem);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, wg = warp >> 2, wt = tid & 127;
  const int h = blockIdx.x, b = blockIdx.y, n = p.n, m = p.m;
  const int nqt = (n + T - 1) / T, nkt = (m + T - 1) / T;
  const long long hd = (long long)p.H * D, bh = (long long)b * p.H + h;
#ifdef QKNORM_BWD_TIMING
  long long clk[CLOCK_SLOTS] = {}, clk_t = clock64();
  if (tid == 0) {
    unsigned sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    clk[0] = global_ns();
    clk[2] = sm;
  }
#endif
  float* lse2 = reinterpret_cast<float*>(smem + L::VEC_OFF);
  float* del = lse2 + OP_N;
  float* ds0 = del + OP_N;
  float* rq = ds0 + OP_N;
  float* kb = rq + OP_N;
  float* rk = kb + D;
  float* nkh = rk + D;
  float* nvs = nkh + D;
  float* qsc = nvs + D;
  float* ksc = qsc + D;
  float* red_a = ksc + D;
  float* red_b = red_a + 8 * D;
  float* ks_acc = red_b + 8 * D;

  const __nv_bfloat16* kg = p.k + b * p.k_sb + h * D;
  const __nv_bfloat16* vg = p.v + b * p.v_sb + h * D;
  auto load_key_tile = [&](int j) {
    const int s = j & 1, k0 = j * T, keys = min(T, m - k0);
    tile_async<OP_NTH>(sbase + L::KR_OFF + s * TILE, kg + k0 * p.k_sm, p.k_sm, keys, tid);
    tile_async<OP_NTH>(sbase + L::V_OFF + s * TILE, vg + k0 * p.v_sm, p.v_sm, keys, tid);
  };
  // raw q and g in two copy groups (rows 0-127, 128-255), then the first key tile
  for (int i = 0; i < OP_NQ; ++i) {
    const int q0 = i * T, rows = min(T, n - q0);
    if (i < nqt) {
      tile_async<OP_NTH>(sbase + L::QR_OFF + i * TILE, p.q + b * p.q_sb + q0 * p.q_sn + h * D, p.q_sn, rows, tid);
      tile_async<OP_NTH>(sbase + L::G_OFF + i * TILE, p.g + b * p.g_sb + q0 * p.g_sn + h * D, p.g_sn, rows, tid);
    }
    if (i & 1) cp_commit();
  }
  if (nkt > 0) load_key_tile(0);
  cp_commit();
  // the forward's output for D, this thread's half of rows tid / 2 and
  // tid / 2 + 128, into registers while the copies fly
  const int half = tid & 1;
  uint4 outv[2][4];
#pragma unroll
  for (int it = 0; it < 2; ++it) {
    const int r = (tid >> 1) + it * (OP_NTH / 2);
    const uint4* o = reinterpret_cast<const uint4*>(p.out + ((long long)b * n + r) * hd + h * D + half * 32);
#pragma unroll
    for (int c = 0; c < 4; ++c) outv[it][c] = r < n ? o[c] : make_uint4(0u, 0u, 0u, 0u);
  }
  if (tid < D) {
    qsc[tid] = p.q_scale[tid] * p.scale;
    ksc[tid] = p.k_scale[tid];
  }
  for (int i = tid; i < 8 * D; i += OP_NTH) ks_acc[i] = 0.0f;
  if (warp == 0) {  // the null key, normalised and scaled in f32, as the forward does
    const float a0 = __bfloat162float(p.nk[h * D + lane]), a1 = __bfloat162float(p.nk[h * D + lane + 32]);
    const float r = rsqrtf(warp_sum(a0 * a0 + a1 * a1) + 1e-12f);
    nkh[lane] = a0 * r * p.k_scale[lane];
    nkh[lane + 32] = a1 * r * p.k_scale[lane + 32];
    nvs[lane] = __bfloat162float(p.nv[h * D + lane]);
    nvs[lane + 32] = __bfloat162float(p.nv[h * D + lane + 32]);
  }
  cp_wait<2>();  // rows 0-127 of q and g
  __syncthreads();
  BWD_TICK(0);

  // -- prologue, two threads a row: q^ (rounded as the forward rounds it),
  // D = g . out, the null column (s0 from the rounded q^, P_0, dS_0) and
  // this block's sums of P_0 g and dS_0 q^
  {
    const float* lse = p.lse + bh * n;
    float anv[32], ank[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) anv[e] = ank[e] = 0.0f;
#pragma unroll
    for (int it = 0; it < 2; ++it) {
      if (it * (OP_NTH / 2) >= nqt * T) break;
      if (it == 1) {  // rows 128-255 of q and g
        cp_wait<1>();
        __syncthreads();
      }
      const int r = (tid >> 1) + it * (OP_NTH / 2), ti = r >> 6, rr = r & (T - 1);
      if (r >= nqt * T) continue;  // a tile never loaded (whole warps skip it)
      const bool ok = r < n;
      float x[32], gv[32], ov[32];
      tile_row_half(smem + L::QR_OFF + ti * TILE, rr, half, x);
      tile_row_half(smem + L::G_OFF + ti * TILE, rr, half, gv);
#pragma unroll
      for (int c = 0; c < 4; ++c) ac::unpack8(outv[it][c], ov + 8 * c);
      float ss = 0.0f;
#pragma unroll
      for (int e = 0; e < 32; ++e) ss += x[e] * x[e];
      ss += __shfl_xor_sync(0xffffffffu, ss, 1);
      const float rr_q = rsqrtf(ss + 1e-12f);
      float s0 = 0.0f, dp0 = 0.0f, dd = 0.0f;
      unsigned char* qh_t = smem + L::QH_OFF + ti * TILE;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float y[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) y[e] = x[8 * c + e] * rr_q * qsc[half * 32 + 8 * c + e];
        const uint4 u = ac::pack8(y);
        *reinterpret_cast<uint4*>(qh_t + ac::swz<ROWB>(rr, half * 4 + c)) = u;
        ac::unpack8(u, x + 8 * c);  // x now holds the rounded q^
#pragma unroll
        for (int e = 0; e < 8; ++e) s0 += x[8 * c + e] * nkh[half * 32 + 8 * c + e];
      }
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        dp0 += gv[e] * nvs[half * 32 + e];
        dd += gv[e] * ov[e];
      }
      s0 += __shfl_xor_sync(0xffffffffu, s0, 1);
      dp0 += __shfl_xor_sync(0xffffffffu, dp0, 1);
      dd += __shfl_xor_sync(0xffffffffu, dd, 1);
      const float l2 = ok ? lse[r] * LOG2E : INFINITY;
      const float p0 = ok ? exp2f(s0 * LOG2E - l2) : 0.0f;
      const float d0 = ok ? p0 * (dp0 - dd) : 0.0f;
      if (half == 0) {
        lse2[r] = l2;
        del[r] = ok ? dd : 0.0f;
        ds0[r] = d0;
        rq[r] = rr_q;
      }
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        anv[e] = fmaf(p0, gv[e], anv[e]);
        ank[e] = fmaf(d0, x[e], ank[e]);
      }
    }
    // over the 16 lanes of one half (each lane keeps two columns' sums), then the warps in order
    reduce_scatter32(anv, lane);
    reduce_scatter32(ank, lane);
    const int col = half * 32 + (lane & 30);
    red_a[warp * D + col] = anv[0];
    red_a[warp * D + col + 1] = anv[1];
    red_b[warp * D + col] = ank[0];
    red_b[warp * D + col + 1] = ank[1];
    ac::fence_async_smem();  // q^ for wgmma
    __syncthreads();
    if (tid < 2 * D) {
      const int c = tid & (D - 1);
      const float* src = tid < D ? red_a : red_b;
      float s = 0.0f;
      for (int w = 0; w < OP_NTH / 32; ++w) s += src[w * D + c];
      (tid < D ? p.dnv_part : p.dnk_part)[bh * D + c] = s;
    }
  }

  BWD_TICK(1);

  // -- the key tiles
  const int gq = lane >> 2, t = lane & 3;
  const int rw = (warp & 3) * 16 + gq;  // accumulator rows rw, rw + 8 of the warpgroup's 64
  float dq[2][32];
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int e = 0; e < 32; ++e) dq[u][e] = 0.0f;
  const uint32_t kh_a = sbase + L::KH_OFF, ds_a = sbase + L::DS_OFF + wg * TILE;
  unsigned char* ds_t = smem + L::DS_OFF + wg * TILE;
  float* xch = reinterpret_cast<float*>(smem + L::XCH_OFF);
  for (int j = 0; j < nkt; ++j) {
    const int s = j & 1, k0 = j * T, keys = min(T, m - k0);
    cp_wait<0>();
    __syncthreads();  // tile j is in; every thread is done with tile j - 1
    if (j + 1 < nkt) {
      load_key_tile(j + 1);
      cp_commit();
    }
    {  // k^ = k / |k| k_scale, rounded to bf16 as the forward rounds it: four threads a row
      const int r = tid >> 2, part = tid & 3;
      const unsigned char* kr_t = smem + L::KR_OFF + s * TILE;
      unsigned char* kh_t = smem + L::KH_OFF;
      float x[16];
#pragma unroll
      for (int c = 0; c < 2; ++c)
        ac::unpack8(*reinterpret_cast<const uint4*>(kr_t + ac::swz<ROWB>(r, part * 2 + c)), x + 8 * c);
      float ss = 0.0f;
#pragma unroll
      for (int e = 0; e < 16; ++e) ss += x[e] * x[e];
      ss += __shfl_xor_sync(0xffffffffu, ss, 1);
      ss += __shfl_xor_sync(0xffffffffu, ss, 2);
      const float rr_k = rsqrtf(ss + 1e-12f);
#pragma unroll
      for (int c = 0; c < 2; ++c) {
#pragma unroll
        for (int e = 0; e < 8; ++e) x[8 * c + e] = x[8 * c + e] * rr_k * ksc[(part * 2 + c) * 8 + e];
        *reinterpret_cast<uint4*>(kh_t + ac::swz<ROWB>(r, part * 2 + c)) = ac::pack8(x + 8 * c);
      }
      if (part == 0) rk[r] = rr_k;
      if (tid < T) kb[tid] = tid < keys ? (p.bias ? p.bias[(long long)b * m + k0 + tid] : 0.0f) * LOG2E : -INFINITY;
    }
    ac::fence_async_smem();
    __syncthreads();
    BWD_TICK(2);
    const float kb2[2] = {kb[rw], kb[rw + 8]};
    const uint32_t va = sbase + L::V_OFF + s * TILE;
    float dv[32], dk[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) dv[e] = dk[e] = 0.0f;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i = wg + 2 * u;
      if (i < nqt) {
        const uint32_t qa = sbase + L::QH_OFF + i * TILE, ga = sbase + L::G_OFF + i * TILE;
        // S^T = k^ q^T and dP^T = v g^T (64 keys x 64 queries)
        float sc[32], dp[32];
#pragma unroll
        for (int e = 0; e < 32; ++e) sc[e] = dp[e] = 0.0f;
        ac::fence_operands(sc);
        ac::fence_operands(dp);
        ac::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          ac::wgmma_ss_n64(sc, ac::desc_kmajor<ROWB>(kh_a + kk * 32), ac::desc_kmajor<ROWB>(qa + kk * 32), kk > 0);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          ac::wgmma_ss_n64(dp, ac::desc_kmajor<ROWB>(va + kk * 32), ac::desc_kmajor<ROWB>(ga + kk * 32), kk > 0);
        ac::wgmma_commit();
        ac::wgmma_wait_all();
        ac::fence_operands(sc);
        ac::fence_operands(dp);
        // P^T = exp(S^T + bias - LSE), dS^T = P^T (dP^T - D)
        const float* ls = lse2 + i * T;
        const float* dl = del + i * T;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = 8 * jj + 2 * t + (e & 1);
            const float pe = exp2f(fmaf(sc[4 * jj + e], LOG2E, kb2[e >> 1]) - ls[col]);
            sc[4 * jj + e] = pe;
            dp[4 * jj + e] = pe * (dp[4 * jj + e] - dl[col]);
          }
        }
        uint32_t pa[4][4], da[4][4];
#pragma unroll
        for (int kc = 0; kc < 4; ++kc) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            pa[kc][e] = ac::pack_bf16(sc[8 * kc + 2 * e], sc[8 * kc + 2 * e + 1]);
            da[kc][e] = ac::pack_bf16(dp[8 * kc + 2 * e], dp[8 * kc + 2 * e + 1]);
          }
        }
        // dS^T (bf16) into this warpgroup's tile, once its last dQ product has read it
        ac::named_barrier(1 + wg, 128);
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
          for (int ii = 0; ii < 2; ++ii)
            *reinterpret_cast<uint32_t*>(ds_t + ac::swz<ROWB>(rw + 8 * ii, jj) + 4 * t) =
                da[jj >> 1][(jj & 1) * 2 + ii];
        }
        ac::fence_async_smem();
        ac::named_barrier(1 + wg, 128);
        // dV += P^T g, dK^ += dS^T q^ (B MN-major), dQ^ += dS k^ (A and B MN-major)
        ac::fence_operands(dv);
        ac::fence_operands(dk);
        ac::fence_operands(dq[u]);
        ac::wgmma_fence();
#pragma unroll
        for (int kc = 0; kc < 4; ++kc) ac::wgmma_rs(dv, pa[kc], ac::desc_mnmajor<ROWB>(ga + kc * 16 * ROWB));
#pragma unroll
        for (int kc = 0; kc < 4; ++kc) ac::wgmma_rs(dk, da[kc], ac::desc_mnmajor<ROWB>(qa + kc * 16 * ROWB));
#pragma unroll
        for (int kc = 0; kc < 4; ++kc)
          wgmma_ss_tt(dq[u], ac::desc_mnmajor<ROWB>(ds_a + kc * 16 * ROWB),
                      ac::desc_mnmajor<ROWB>(kh_a + kc * 16 * ROWB));
        ac::wgmma_commit();
        ac::wgmma_wait_all();
        ac::fence_operands(dv);
        ac::fence_operands(dk);
        ac::fence_operands(dq[u]);
      }
    }
    BWD_TICK(3);
    // the warpgroups' halves: 0 hands over dK^ and finishes dv, 1 hands over
    // dV and takes dK^ through k's norm (each sum is warpgroup 0's + 1's);
    // each stages its bf16 rows in its dS^T tile, then writes them 16 bytes
    // a thread
    {
      float* mine = xch + wg * 32 * 128;
      const float* other = xch + (wg ^ 1) * 32 * 128;
#pragma unroll
      for (int e = 0; e < 32; ++e) mine[e * 128 + wt] = wg == 0 ? dk[e] : dv[e];
      __syncthreads();
      if (wg == 0) {
#pragma unroll
        for (int ii = 0; ii < 2; ++ii) {
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const int e0 = 4 * jj + 2 * ii;
            *reinterpret_cast<uint32_t*>(ds_t + ac::swz<ROWB>(rw + 8 * ii, jj) + 4 * t) =
                ac::pack_bf16(dv[e0] + other[e0 * 128 + wt], dv[e0 + 1] + other[(e0 + 1) * 128 + wt]);
          }
        }
      } else {
        const unsigned char* kr_t = smem + L::KR_OFF + s * TILE;
        float cs[16];
#pragma unroll
        for (int e = 0; e < 16; ++e) cs[e] = 0.0f;
#pragma unroll
        for (int ii = 0; ii < 2; ++ii) {
          const int r = rw + 8 * ii;
          const float rr_k = rk[r];
          float u[16], w[16], uw = 0.0f;
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const float2 kv = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(kr_t + ac::swz<ROWB>(r, jj) + 4 * t));
            const int e0 = 4 * jj + 2 * ii, c = 8 * jj + 2 * t;
            const float g0 = other[e0 * 128 + wt] + dk[e0], g1 = other[(e0 + 1) * 128 + wt] + dk[e0 + 1];
            u[2 * jj] = kv.x * rr_k;
            u[2 * jj + 1] = kv.y * rr_k;
            w[2 * jj] = g0 * ksc[c];
            w[2 * jj + 1] = g1 * ksc[c + 1];
            uw += u[2 * jj] * w[2 * jj] + u[2 * jj + 1] * w[2 * jj + 1];
            cs[2 * jj] = fmaf(g0, u[2 * jj], cs[2 * jj]);
            cs[2 * jj + 1] = fmaf(g1, u[2 * jj + 1], cs[2 * jj + 1]);
          }
          uw += __shfl_xor_sync(0xffffffffu, uw, 1);
          uw += __shfl_xor_sync(0xffffffffu, uw, 2);
#pragma unroll
          for (int jj = 0; jj < 8; ++jj)
            *reinterpret_cast<uint32_t*>(ds_t + ac::swz<ROWB>(r, jj) + 4 * t) =
                ac::pack_bf16(rr_k * (w[2 * jj] - u[2 * jj] * uw), rr_k * (w[2 * jj + 1] - u[2 * jj + 1] * uw));
        }
        // this warp's rows of d k_scale = sum dk^ u_k, into its running sums
#pragma unroll
        for (int e = 0; e < 16; ++e) {
#pragma unroll
          for (int o = 4; o < 32; o <<= 1) cs[e] += __shfl_xor_sync(0xffffffffu, cs[e], o);
        }
        if (lane < 4) {
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            ks_acc[(warp & 3) * D + 8 * jj + 2 * t] += cs[2 * jj];
            ks_acc[(warp & 3) * D + 8 * jj + 2 * t + 1] += cs[2 * jj + 1];
          }
        }
      }
      ac::named_barrier(1 + wg, 128);
      __nv_bfloat16* dst = (wg == 0 ? p.dv : p.dk) + ((long long)b * m + k0) * hd + h * D;
#pragma unroll
      for (int it = 0; it < T * 8 / 128; ++it) {
        const int c = wt + it * 128, r = c >> 3, ch = c & 7;
        if (r < keys)
          *reinterpret_cast<uint4*>(dst + r * hd + ch * 8) =
              *reinterpret_cast<const uint4*>(ds_t + ac::swz<ROWB>(r, ch));
      }
    }
    BWD_TICK(4);
  }
  __syncthreads();

  // -- epilogue: dq^ += dS_0 nk^, q's norm, and this block's d q_scale rows
  {
    float cs[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) cs[e] = 0.0f;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i = wg + 2 * u;
      if (i >= nqt) continue;
      const unsigned char* qr_t = smem + L::QR_OFF + i * TILE;
#pragma unroll
      for (int ii = 0; ii < 2; ++ii) {
        const int rr = rw + 8 * ii, r = i * T + rr;
        const float d0 = ds0[r], rr_q = rq[r];
        float uq[16], w[16], uw = 0.0f;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const float2 qv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(qr_t + ac::swz<ROWB>(rr, jj) + 4 * t));
          const int e0 = 4 * jj + 2 * ii, c = 8 * jj + 2 * t;
          const float g0 = fmaf(d0, nkh[c], dq[u][e0]), g1 = fmaf(d0, nkh[c + 1], dq[u][e0 + 1]);
          uq[2 * jj] = qv.x * rr_q;
          uq[2 * jj + 1] = qv.y * rr_q;
          w[2 * jj] = g0 * qsc[c];
          w[2 * jj + 1] = g1 * qsc[c + 1];
          uw += uq[2 * jj] * w[2 * jj] + uq[2 * jj + 1] * w[2 * jj + 1];
          cs[2 * jj] = fmaf(g0, uq[2 * jj], cs[2 * jj]);
          cs[2 * jj + 1] = fmaf(g1, uq[2 * jj + 1], cs[2 * jj + 1]);
        }
        uw += __shfl_xor_sync(0xffffffffu, uw, 1);
        uw += __shfl_xor_sync(0xffffffffu, uw, 2);
        unsigned char* st = smem + L::G_OFF + i * TILE;  // g is done with: dq's bf16 rows
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
          *reinterpret_cast<uint32_t*>(st + ac::swz<ROWB>(rr, jj) + 4 * t) =
              ac::pack_bf16(rr_q * (w[2 * jj] - uq[2 * jj] * uw), rr_q * (w[2 * jj + 1] - uq[2 * jj + 1] * uw));
      }
    }
#pragma unroll
    for (int e = 0; e < 16; ++e) {
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) cs[e] += __shfl_xor_sync(0xffffffffu, cs[e], o);
    }
    if (lane < 4) {
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        red_a[warp * D + 8 * jj + 2 * t] = cs[2 * jj];
        red_a[warp * D + 8 * jj + 2 * t + 1] = cs[2 * jj + 1];
      }
    }
  }
  __syncthreads();
  for (int c = tid; c < nqt * T * 8; c += OP_NTH) {
    const int r = c >> 3, ch = c & 7;
    if (r < n)
      *reinterpret_cast<uint4*>(p.dq + ((long long)b * n + r) * hd + h * D + ch * 8) =
          *reinterpret_cast<const uint4*>(smem + L::G_OFF + (r >> 6) * TILE + ac::swz<ROWB>(r & (T - 1), ch));
  }
  if (tid < 2 * D) {
    const int c = tid & (D - 1);
    float sum = 0.0f;
    if (tid < D) {
      for (int w = 0; w < OP_NTH / 32; ++w) sum += red_a[w * D + c];
      p.dqs_part[bh * D + c] = sum * p.scale;
    } else {
      for (int w = 0; w < 4; ++w) sum += ks_acc[w * D + c];
      p.dks_part[bh * D + c] = sum;
    }
  }
  BWD_TICK(5);
  reduce_partials(p, h, gridDim.y, xch);
  BWD_TICK(6);
#ifdef QKNORM_BWD_TIMING
  if (tid == 0) {
    clk[1] = global_ns();
    for (int i = 0; i < CLOCK_SLOTS; ++i) p.clocks[bh * CLOCK_SLOTS + i] = clk[i];
  }
#endif
}

// -- bf16, n > 256: two TMA pipelines, query-stationary then key-stationary --------------

// Both kernels: a block owns 128 rows of one (batch, head), 64 to each of two
// consumer warpgroups, and the first warp of a producer warpgroup streams
// the other side's 64-row tiles through a four-stage ring by TMA (tensor
// maps over the callers' strides; rows past n or m are zero-filled),
// writing each tile's row terms beside it. Each streamed tile's first
// operand is normalised in place (f32, rounded to bf16 into the swizzled
// layout `wgmma` reads, as the forward does): in the keys kernel by the
// producer warpgroup's next two warps, a row a thread, as the tile lands; in
// the queries kernel by the consumers, four threads a row, while the last
// tile's dQ^ product runs (measured faster that way round for each kernel,
// PERF.md). Stage s has three mbarriers: full (the copies and the row
// terms), ready (normalised) and empty (both warpgroups done with it), so a
// warpgroup waits for the other only through the ring. The consumers read
// S and dP from shared memory and keep one `wgmma` group in flight: a
// tile's exponentials run under its dP product, its dS under the dV
// product.
constexpr int SP_WGS = 2;                      // consumer warpgroups
constexpr int SP_ROWS = 64 * SP_WGS;           // rows (queries or keys) a block owns
constexpr int SP_STAGES = 4;                   // ring depth
constexpr int SP_CONSUMERS = 128 * SP_WGS;
constexpr int SP_THREADS = SP_CONSUMERS + 128;  // and the producer warpgroup
// `setmaxnreg` hands the producers' registers to the consumers: 168 a
// thread at launch (each SM sub-partition's 16384 registers over its three
// warps), 72 for the producers and 216 for the consumers after
constexpr int SP_PRODUCER_REGS = 72, SP_CONSUMER_REGS = 216;
constexpr int SP_NORM = T;  // the keys kernel's normalising threads (producer warps 1 and 2): a row each
static_assert(SP_CONSUMERS * SP_CONSUMER_REGS + 128 * SP_PRODUCER_REGS <= 168 * SP_THREADS, "the register file");

struct SplitSmem {
  static constexpr int RAW_OFF = 0;                          // [2] the block's rows as given: raw q or raw k
  static constexpr int HAT_OFF = RAW_OFF + SP_WGS * TILE;    // [2] the same normalised: q^ or k^
  static constexpr int SEC_OFF = HAT_OFF + SP_WGS * TILE;    // [2] g or v
  static constexpr int RING_OFF = SEC_OFF + SP_WGS * TILE;   // [stage] the streamed tile pair
  static constexpr int STAGE = 2 * TILE;
  static constexpr int SVEC_OFF = RING_OFF + SP_STAGES * STAGE;  // [stage][2][T] f32: the tile's row terms
  static constexpr int VEC_OFF = SVEC_OFF + SP_STAGES * 2 * T * 4;
  // f32: four vectors of the block's rows, qsc, ksc, nkh, nvs [D], three [8][D] reduction rows
  static constexpr int NVEC = 4 * SP_ROWS + 4 * D + 3 * 8 * D;
  static constexpr int BAR_OFF = VEC_OFF + NVEC * 4;  // full, ready, empty [stage]; the resident tiles
  static constexpr int BYTES = BAR_OFF + (3 * SP_STAGES + 1) * 8;
  static constexpr int ALLOC = BYTES + 1024;
};

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// d (64 x 64, f32) (+)= A (64 x 16, bf16 registers) B (16 x 64, smem, MN-major); d is
// overwritten where !accumulate
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db, int accumulate) {
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// keep A fragments live (in their registers) until a `wgmma` that reads them has retired
__device__ __forceinline__ void fence_frags(uint32_t (&r)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// the ring's barriers
struct SplitRing {
  uint32_t full0, ready0, empty0, res;
  __device__ __forceinline__ uint32_t full(int s) const { return full0 + 8 * s; }
  __device__ __forceinline__ uint32_t ready(int s) const { return ready0 + 8 * s; }
  __device__ __forceinline__ uint32_t empty(int s) const { return empty0 + 8 * s; }
};

__device__ __forceinline__ SplitRing split_ring(uint32_t sbase) {
  const uint32_t b0 = sbase + SplitSmem::BAR_OFF;
  return {b0, b0 + 8 * SP_STAGES, b0 + 16 * SP_STAGES, b0 + 24 * SP_STAGES};
}

__device__ __forceinline__ void split_init(const SplitRing& ring, int readies) {
#pragma unroll
  for (int s = 0; s < SP_STAGES; ++s) {
    ac::mbar_init(ring.full(s), 32);                  // every lane of the loading warp
    ac::mbar_init(ring.ready(s), readies);            // every thread that normalises
    ac::mbar_init(ring.empty(s), SP_CONSUMERS / 32);  // lane 0 of every consumer warp
  }
  ac::mbar_init(ring.res, 1);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// The producer warp: the block's two resident tile pairs (rows row0, row0 +
// 64 of maps ra and rb), then `tiles` streamed pairs (maps sa, sb); `terms(s,
// j)` writes stage s's row terms for tile j, each lane a share, before the
// lane arrives on the stage's full barrier.
template <typename Terms>
__device__ __forceinline__ void split_loads(const SplitRing& ring, uint32_t sbase, const CUtensorMap* ra,
                                            const CUtensorMap* rb, const CUtensorMap* sa, const CUtensorMap* sb,
                                            int c0, int c2, int row0, int tiles, int lane, Terms terms) {
  if (lane == 0) {
    ac::mbar_arrive_tx(ring.res, 2 * SP_WGS * TILE);
#pragma unroll
    for (int w = 0; w < SP_WGS; ++w) {
      ac::tma_load_3d(sbase + SplitSmem::RAW_OFF + w * TILE, ra, ring.res, c0, row0 + 64 * w, c2);
      ac::tma_load_3d(sbase + SplitSmem::SEC_OFF + w * TILE, rb, ring.res, c0, row0 + 64 * w, c2);
    }
  }
  for (int j = 0; j < tiles; ++j) {
    const int s = j % SP_STAGES;
    ac::mbar_wait(ring.empty(s), ((j / SP_STAGES) & 1) ^ 1);
    terms(s, j);
    if (lane == 0) {
      const uint32_t dst = sbase + SplitSmem::RING_OFF + s * SplitSmem::STAGE;
      ac::mbar_arrive_tx(ring.full(s), SplitSmem::STAGE);
      ac::tma_load_3d(dst, sa, ring.full(s), c0, j * T, c2);
      ac::tma_load_3d(dst + TILE, sb, ring.full(s), c0, j * T, c2);
    } else {
      ac::mbar_arrive(ring.full(s));
    }
  }
}

// The normalising threads: row nt of each streamed tile's first operand,
// t^ = t / |t| sc in place as the tile lands (the row's eight 16-byte
// chunks in flight at once), then the stage's ready barrier.
__device__ __forceinline__ void split_normalise(const SplitRing& ring, unsigned char* smem, const float* sc,
                                                int tiles, int nt) {
  for (int j = 0; j < tiles; ++j) {
    const int s = j % SP_STAGES;
    ac::mbar_wait(ring.full(s), (j / SP_STAGES) & 1);
    unsigned char* row = smem + SplitSmem::RING_OFF + s * SplitSmem::STAGE + nt * ROWB;
    uint4 raw[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) raw[c] = *reinterpret_cast<const uint4*>(row + ((c ^ (nt & 7)) << 4));
    float part[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      float x[8];
      ac::unpack8(raw[c], x);
      part[c] = ((x[0] * x[0] + x[1] * x[1]) + (x[2] * x[2] + x[3] * x[3])) +
                ((x[4] * x[4] + x[5] * x[5]) + (x[6] * x[6] + x[7] * x[7]));
    }
    const float rr = rsqrtf(((part[0] + part[1]) + (part[2] + part[3])) + ((part[4] + part[5]) + (part[6] + part[7])) + 1e-12f);
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      float x[8];
      ac::unpack8(raw[c], x);
#pragma unroll
      for (int e = 0; e < 8; ++e) x[e] = x[e] * rr * sc[8 * c + e];
      *reinterpret_cast<uint4*>(row + ((c ^ (nt & 7)) << 4)) = ac::pack8(x);
    }
    ac::fence_async_smem();
    ac::mbar_arrive(ring.ready(s));
  }
}

// A consumer's share of streamed tile j (the queries kernel: its
// consumers normalise k^ while a tile's dQ^ product runs): a quarter of row
// ctid / 4, t^ = t / |t| sc in place once the tile has landed; then the
// stage's ready barrier.
__device__ __forceinline__ void normalise_share(const SplitRing& ring, unsigned char* smem, const float* sc, int j,
                                                int ctid) {
  const int s = j % SP_STAGES, r = ctid >> 2, part = ctid & 3;
  ac::mbar_wait(ring.full(s), (j / SP_STAGES) & 1);
  unsigned char* tile = smem + SplitSmem::RING_OFF + s * SplitSmem::STAGE;
  uint4* a0 = reinterpret_cast<uint4*>(tile + ac::swz<ROWB>(r, 2 * part));
  uint4* a1 = reinterpret_cast<uint4*>(tile + ac::swz<ROWB>(r, 2 * part + 1));
  float x[16], sq[8];
  ac::unpack8(*a0, x);
  ac::unpack8(*a1, x + 8);
#pragma unroll
  for (int e = 0; e < 8; ++e) sq[e] = x[2 * e] * x[2 * e] + x[2 * e + 1] * x[2 * e + 1];
  float ss = ((sq[0] + sq[1]) + (sq[2] + sq[3])) + ((sq[4] + sq[5]) + (sq[6] + sq[7]));
  ss += __shfl_xor_sync(0xffffffffu, ss, 1);
  ss += __shfl_xor_sync(0xffffffffu, ss, 2);
  const float rr = rsqrtf(ss + 1e-12f);
#pragma unroll
  for (int e = 0; e < 16; ++e) x[e] = x[e] * rr * sc[part * 16 + e];
  *a0 = ac::pack8(x);
  *a1 = ac::pack8(x + 8);
  ac::fence_async_smem();
  ac::mbar_arrive(ring.ready(s));
}

// Built with -DQKNORM_BWD_TIMING, each split-route block leaves its start and
// end on the global timer (ns), its SM, and the SM clocks its thread 0
// (warpgroup 0) spent in each part: prologue, ready waits, products,
// exponentials and dS, epilogue, and (queries kernel) its share of
// normalising the next tile, its full wait included.
#ifdef QKNORM_BWD_TIMING
#define SP_TICK(slot)                  \
  do {                                 \
    if (tid == 0) {                    \
      const long long now = clock64(); \
      clk[slot] += now - clk_t;        \
      clk_t = now;                     \
    }                                  \
  } while (0)
#define SP_TIMER_START()                                  \
  long long clk[CLOCK_SLOTS] = {}, clk_t = clock64();     \
  if (tid == 0) {                                         \
    unsigned sm;                                          \
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));       \
    clk[0] = global_ns();                                 \
    clk[2] = sm;                                          \
  }
#define SP_TIMER_END()                                                                                  \
  if (tid == 0) {                                                                                       \
    clk[1] = global_ns();                                                                               \
    long long* row = p.clocks + (((long long)b * gridDim.y + h) * gridDim.x + blockIdx.x) * CLOCK_SLOTS; \
    for (int i = 0; i < CLOCK_SLOTS; ++i) row[i] = clk[i];                                              \
  }
#else
#define SP_TICK(slot) \
  do {                \
  } while (0)
#define SP_TIMER_START()
#define SP_TIMER_END()
#endif

// Query-stationary, launched first: a block per (128 queries, head, batch).
// Its prologue takes q^ (rounded where the forward rounds it), D = g . out
// (written for the keys kernel), the null column (s0 from the rounded q^,
// P_0, dS_0) and the block's d nv / d nk^ rows. Then per key tile (k^
// normalised in place): S = q^ k^T and dP = g v^T from shared memory, P
// and dS in registers, dQ^ += dS k^ with dS as the A fragment.
// The epilogue adds dS_0 nk^, applies q's norm (raw q stays resident) and
// writes dq 16 bytes a thread and the block's d q_scale row.
__global__ void __launch_bounds__(SP_THREADS, 1)
qknorm_bwd_queries_bf16(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_g,
                        const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
                        const Bwd<__nv_bfloat16> p) {
  using L = SplitSmem;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (ac::smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sbase = ac::smem_u32(smem);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int qb = blockIdx.x, h = blockIdx.y, b = blockIdx.z, n = p.n, m = p.m;
  const int q0 = qb * SP_ROWS, nkt = (m + T - 1) / T;
  const long long hd = (long long)p.H * D, bh = (long long)b * p.H + h;
  float* svec = reinterpret_cast<float*>(smem + L::SVEC_OFF);  // [stage][2][T]: the key tile's bias * log2e
  float* lse2 = reinterpret_cast<float*>(smem + L::VEC_OFF);   // [SP_ROWS] LSE * log2e, +inf past n
  float* del = lse2 + SP_ROWS;                                 // D
  float* ds0 = del + SP_ROWS;                                  // dS_0
  float* rq = ds0 + SP_ROWS;                                   // 1 / |q|
  float* qsc = rq + SP_ROWS;
  float* ksc = qsc + D;
  float* nkh = ksc + D;
  float* nvs = nkh + D;
  float* red_a = nvs + D;  // [8][D] d nv, d nk^ and d q_scale rows by warp
  float* red_b = red_a + 8 * D;
  float* red_c = red_b + 8 * D;
  const SplitRing ring = split_ring(sbase);

  if (tid == 0) split_init(ring, SP_CONSUMERS);
  if (tid < D) {
    qsc[tid] = p.q_scale[tid] * p.scale;
    ksc[tid] = p.k_scale[tid];
  }
  if (warp == 1) {  // the null key, normalised and scaled in f32, as the forward does
    const float a0 = __bfloat162float(p.nk[h * D + lane]), a1 = __bfloat162float(p.nk[h * D + lane + 32]);
    const float r = rsqrtf(warp_sum(a0 * a0 + a1 * a1) + 1e-12f);
    nkh[lane] = a0 * r * p.k_scale[lane];
    nkh[lane + 32] = a1 * r * p.k_scale[lane + 32];
    nvs[lane] = __bfloat162float(p.nv[h * D + lane]);
    nvs[lane + 32] = __bfloat162float(p.nv[h * D + lane + 32]);
  }
  __syncthreads();

  if (warp >= SP_CONSUMERS / 32) {  // the producer warpgroup: its first warp loads
    regs_dec<SP_PRODUCER_REGS>();
    if (warp == SP_CONSUMERS / 32) {
      const float* brow = p.bias ? p.bias + (long long)b * m : nullptr;
      split_loads(ring, sbase, &tm_q, &tm_g, &tm_k, &tm_v, h * D, b, q0, nkt, lane, [&](int s, int j) {
        float* kb = svec + s * 2 * T;
        for (int c = lane; c < T; c += 32) {
          const int key = j * T + c;
          kb[c] = key < m ? (brow ? brow[key] * LOG2E : 0.0f) : -INFINITY;
        }
      });
    }
    return;
  }

  regs_inc<SP_CONSUMER_REGS>();
  SP_TIMER_START();
  const int wg = warp >> 2, wt = tid & 127;
  const int gq = lane >> 2, t = lane & 3, rw = (warp & 3) * 16 + gq;  // accumulator rows rw, rw + 8
  const int r0 = q0 + wg * 64;                                          // this warpgroup's first query
  unsigned char* qr_t = smem + L::RAW_OFF + wg * TILE;
  unsigned char* qh_t = smem + L::HAT_OFF + wg * TILE;
  unsigned char* g_t = smem + L::SEC_OFF + wg * TILE;

  // -- prologue, two threads a row: q^, D, the null column, this warp's d nv / d nk^ sums
  {
    const int r = wt >> 1, half = wt & 1, qi = r0 + r, row = wg * 64 + r;
    const bool ok = qi < n;
    // the forward's output and LSE of this row, read while the resident tiles land
    uint4 ou[4] = {};
    const float lse_r = ok ? p.lse[bh * n + qi] : 0.0f;
    if (ok) {
      const uint4* o = reinterpret_cast<const uint4*>(p.out + ((long long)b * n + qi) * hd + h * D + half * 32);
#pragma unroll
      for (int c = 0; c < 4; ++c) ou[c] = o[c];
    }
    ac::mbar_wait(ring.res, 0);
    float x[32], gv[32], ov[32];
    tile_row_half(qr_t, r, half, x);
    tile_row_half(g_t, r, half, gv);
#pragma unroll
    for (int c = 0; c < 4; ++c) ac::unpack8(ou[c], ov + 8 * c);
    float ss = 0.0f;
#pragma unroll
    for (int e = 0; e < 32; ++e) ss += x[e] * x[e];
    ss += __shfl_xor_sync(0xffffffffu, ss, 1);
    const float rr_q = rsqrtf(ss + 1e-12f);
    float s0 = 0.0f, dp0 = 0.0f, dd = 0.0f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float y[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) y[e] = x[8 * c + e] * rr_q * qsc[half * 32 + 8 * c + e];
      const uint4 u = ac::pack8(y);
      *reinterpret_cast<uint4*>(qh_t + ac::swz<ROWB>(r, half * 4 + c)) = u;
      ac::unpack8(u, x + 8 * c);  // x now holds the rounded q^
#pragma unroll
      for (int e = 0; e < 8; ++e) s0 += x[8 * c + e] * nkh[half * 32 + 8 * c + e];
    }
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      dp0 += gv[e] * nvs[half * 32 + e];
      dd += gv[e] * ov[e];
    }
    s0 += __shfl_xor_sync(0xffffffffu, s0, 1);
    dp0 += __shfl_xor_sync(0xffffffffu, dp0, 1);
    dd += __shfl_xor_sync(0xffffffffu, dd, 1);
    const float l2 = ok ? lse_r * LOG2E : INFINITY;
    const float p0 = ok ? exp2f(s0 * LOG2E - l2) : 0.0f;
    const float d0 = ok ? p0 * (dp0 - dd) : 0.0f;
    if (half == 0) {
      lse2[row] = l2;
      del[row] = ok ? dd : 0.0f;
      ds0[row] = d0;
      rq[row] = rr_q;
      if (ok) p.delta[bh * n + qi] = dd;
    }
    float anv[32], ank[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      anv[e] = p0 * gv[e];
      ank[e] = d0 * x[e];
    }
    // over the 16 lanes of one half (each lane keeps two columns' sums)
    reduce_scatter32(anv, lane);
    reduce_scatter32(ank, lane);
    const int col = half * 32 + (lane & 30);
    red_a[warp * D + col] = anv[0];
    red_a[warp * D + col + 1] = anv[1];
    red_b[warp * D + col] = ank[0];
    red_b[warp * D + col + 1] = ank[1];
    ac::fence_async_smem();  // q^ for wgmma
    ac::named_barrier(1 + wg, 128);
  }
  if (nkt > 0) normalise_share(ring, smem, ksc, 0, tid);  // the first key tile's k^
  SP_TICK(3);

  // -- the key tiles
  const float l2r[2] = {lse2[wg * 64 + rw], lse2[wg * 64 + rw + 8]};
  const float dlr[2] = {del[wg * 64 + rw], del[wg * 64 + rw + 8]};
  float dq[32];
  uint32_t da[4][4];
#pragma unroll
  for (int kc = 0; kc < 4; ++kc)
#pragma unroll
    for (int e = 0; e < 4; ++e) da[kc][e] = 0u;
  for (int j = 0; j < nkt; ++j) {
    const int s = j % SP_STAGES;
    ac::mbar_wait(ring.ready(s), (j / SP_STAGES) & 1);
    SP_TICK(4);
    const uint32_t k_a = sbase + L::RING_OFF + s * L::STAGE, v_a = k_a + TILE;
    const uint32_t qh_a = sbase + L::HAT_OFF + wg * TILE, g_a = sbase + L::SEC_OFF + wg * TILE;
    // S = q^ k^T, then dP = g v^T (64 queries x 64 keys), two groups; the first k step overwrites
    float sc[32], dp[32];
    ac::fence_operands(sc);
    ac::fence_operands(dp);
    ac::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      ac::wgmma_ss_n64(sc, ac::desc_kmajor<ROWB>(qh_a + kk * 32), ac::desc_kmajor<ROWB>(k_a + kk * 32), kk > 0);
    ac::wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      ac::wgmma_ss_n64(dp, ac::desc_kmajor<ROWB>(g_a + kk * 32), ac::desc_kmajor<ROWB>(v_a + kk * 32), kk > 0);
    ac::wgmma_commit();
    wgmma_wait<1>();  // S, and the last tile's dQ^ product: its stage is free
    ac::fence_operands(sc);
    fence_frags(da);
    SP_TICK(5);
    if (j > 0) {
      __syncwarp();
      if (lane == 0) ac::mbar_arrive(ring.empty((j - 1) % SP_STAGES));
    }
    // P = exp(S + bias - LSE), while dP is multiplied
    const float* kb = svec + s * 2 * T;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const float2 bb = *reinterpret_cast<const float2*>(kb + 8 * jj + 2 * t);  // columns 8 jj + 2 t, + 1
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sc[4 * jj + e] = ex2(fmaf(sc[4 * jj + e], LOG2E, (e & 1) ? bb.y : bb.x) - l2r[e >> 1]);
    }
    SP_TICK(6);
    wgmma_wait<0>();
    ac::fence_operands(dp);
    SP_TICK(5);
    // dS = P (dP - D), rounded to bf16 as the A fragment of dQ^ += dS k^ (B MN-major)
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i0 = 8 * kc + 2 * e;  // rows rw (e even) or rw + 8 (e odd)
        da[kc][e] = ac::pack_bf16(sc[i0] * (dp[i0] - dlr[e & 1]), sc[i0 + 1] * (dp[i0 + 1] - dlr[e & 1]));
      }
    }
    SP_TICK(6);
    ac::fence_operands(dq);
    ac::wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) wgmma_rs(dq, da[kc], ac::desc_mnmajor<ROWB>(k_a + kc * 16 * ROWB), j > 0 || kc > 0);
    ac::wgmma_commit();
    SP_TICK(5);
    if (j + 1 < nkt) normalise_share(ring, smem, ksc, j + 1, tid);  // the next tile's k^, under the dQ^ product
    SP_TICK(8);
  }
  wgmma_wait<0>();
  ac::fence_operands(dq);
  fence_frags(da);
  if (nkt == 0) {
#pragma unroll
    for (int e = 0; e < 32; ++e) dq[e] = 0.0f;
  }
  SP_TICK(5);

  // -- epilogue: dq^ += dS_0 nk^, q's norm, dq staged in the g tile; this warp's d q_scale sums
  ac::named_barrier(1 + wg, 128);  // every warp's products have retired: g may be overwritten
  {
    float cs[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) cs[e] = 0.0f;
#pragma unroll
    for (int ii = 0; ii < 2; ++ii) {
      const int rr = rw + 8 * ii, row = wg * 64 + rr;
      const float d0 = ds0[row], rr_q = rq[row];
      float uq[16], w[16], uw = 0.0f;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const float2 qv =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(qr_t + ac::swz<ROWB>(rr, jj) + 4 * t));
        const int e0 = 4 * jj + 2 * ii, c = 8 * jj + 2 * t;
        const float g0 = fmaf(d0, nkh[c], dq[e0]), g1 = fmaf(d0, nkh[c + 1], dq[e0 + 1]);
        uq[2 * jj] = qv.x * rr_q;
        uq[2 * jj + 1] = qv.y * rr_q;
        w[2 * jj] = g0 * qsc[c];
        w[2 * jj + 1] = g1 * qsc[c + 1];
        uw += uq[2 * jj] * w[2 * jj] + uq[2 * jj + 1] * w[2 * jj + 1];
        cs[2 * jj] = fmaf(g0, uq[2 * jj], cs[2 * jj]);
        cs[2 * jj + 1] = fmaf(g1, uq[2 * jj + 1], cs[2 * jj + 1]);
      }
      uw += __shfl_xor_sync(0xffffffffu, uw, 1);
      uw += __shfl_xor_sync(0xffffffffu, uw, 2);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
        *reinterpret_cast<uint32_t*>(g_t + ac::swz<ROWB>(rr, jj) + 4 * t) =
            ac::pack_bf16(rr_q * (w[2 * jj] - uq[2 * jj] * uw), rr_q * (w[2 * jj + 1] - uq[2 * jj + 1] * uw));
    }
#pragma unroll
    for (int e = 0; e < 16; ++e) {
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) cs[e] += __shfl_xor_sync(0xffffffffu, cs[e], o);
    }
    if (lane < 4) {
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        red_c[warp * D + 8 * jj + 2 * t] = cs[2 * jj];
        red_c[warp * D + 8 * jj + 2 * t + 1] = cs[2 * jj + 1];
      }
    }
  }
  ac::named_barrier(1 + wg, 128);
#pragma unroll
  for (int it = 0; it < T * 8 / 128; ++it) {
    const int c = wt + it * 128, r = c >> 3, ch = c & 7, qi = r0 + r;
    if (qi < n)
      *reinterpret_cast<uint4*>(p.dq + ((long long)b * n + qi) * hd + h * D + ch * 8) =
          *reinterpret_cast<const uint4*>(g_t + ac::swz<ROWB>(r, ch));
  }
  // the block's rows of d nv, d nk^ and d q_scale: the warps' sums in order
  ac::named_barrier(3, SP_CONSUMERS);
  if (tid < 3 * D) {
    const int a = tid / D, c = tid % D;
    const float* src = a == 0 ? red_a : a == 1 ? red_b : red_c;
    float sum = 0.0f;
    for (int w = 0; w < SP_CONSUMERS / 32; ++w) sum += src[w * D + c];
    float* dst = a == 0 ? p.dnv_part : a == 1 ? p.dnk_part : p.dqs_part;
    dst[(((long long)b * gridDim.x + qb) * p.H + h) * D + c] = a == 2 ? sum * p.scale : sum;
  }
  SP_TICK(7);
  SP_TIMER_END();
}

// Key-stationary, after the queries kernel (which wrote D): a block per (128
// keys, head, batch). Its prologue normalises k (raw k stays resident for the
// epilogue). Per query tile (q^ normalised in place, g, LSE and D beside
// them): S^T = k^ q^T and dP^T = v g^T from shared memory, P^T and dS^T in
// registers as the A fragments of dV += P^T g and dK^ += dS^T q^. The
// epilogue writes dv, then dk through k's norm, each staged in the k^ tile
// and written 16 bytes a thread, and the block's d k_scale row.
__global__ void __launch_bounds__(SP_THREADS, 1)
qknorm_bwd_keys_bf16(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_g,
                     const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
                     const Bwd<__nv_bfloat16> p) {
  using L = SplitSmem;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (ac::smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sbase = ac::smem_u32(smem);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int kblk = blockIdx.x, h = blockIdx.y, b = blockIdx.z, n = p.n, m = p.m;
  const int k0 = kblk * SP_ROWS, nqt = (n + T - 1) / T;
  const long long hd = (long long)p.H * D, bh = (long long)b * p.H + h;
  float* svec = reinterpret_cast<float*>(smem + L::SVEC_OFF);  // [stage]: LSE * log2e [T] (+inf past n), D [T]
  float* kb = reinterpret_cast<float*>(smem + L::VEC_OFF);     // [SP_ROWS] key bias * log2e, -inf past m
  float* rk = kb + SP_ROWS;                                    // 1 / |k|
  float* qsc = rk + 3 * SP_ROWS;
  float* ksc = qsc + D;
  float* red_a = ksc + 3 * D;  // [8][D] d k_scale rows by warp
  const SplitRing ring = split_ring(sbase);

  if (tid == 0) split_init(ring, SP_NORM);
  if (tid < D) {
    qsc[tid] = p.q_scale[tid] * p.scale;
    ksc[tid] = p.k_scale[tid];
  }
  __syncthreads();

  if (warp >= SP_CONSUMERS / 32) {  // the producer warpgroup: its first warp loads
    regs_dec<SP_PRODUCER_REGS>();
    if (warp == SP_CONSUMERS / 32) {
      const float* lse = p.lse + bh * n;
      const float* dl = p.delta + bh * n;
      split_loads(ring, sbase, &tm_k, &tm_v, &tm_q, &tm_g, h * D, b, k0, nqt, lane, [&](int s, int j) {
        float* sv = svec + s * 2 * T;
        for (int c = lane; c < T; c += 32) {
          const int qi = j * T + c;
          const bool ok = qi < n;
          sv[c] = ok ? lse[qi] * LOG2E : INFINITY;
          sv[T + c] = ok ? dl[qi] : 0.0f;
        }
      });
    } else if (warp <= SP_CONSUMERS / 32 + SP_NORM / 32) {
      split_normalise(ring, smem, qsc, nqt, tid - SP_CONSUMERS - 32);
    }
    return;
  }

  regs_inc<SP_CONSUMER_REGS>();
  SP_TIMER_START();
  const int wg = warp >> 2, wt = tid & 127;
  const int gq = lane >> 2, t = lane & 3, rw = (warp & 3) * 16 + gq;  // accumulator rows (keys) rw, rw + 8
  const int kw0 = k0 + wg * 64;                                         // this warpgroup's first key
  const unsigned char* kr_t = smem + L::RAW_OFF + wg * TILE;
  unsigned char* kh_t = smem + L::HAT_OFF + wg * TILE;
  ac::mbar_wait(ring.res, 0);
  {  // k^ = k / |k| k_scale, rounded to bf16 as the forward rounds it: two threads a row
    const int r = wt >> 1, half = wt & 1, key = kw0 + r;
    float x[32];
    tile_row_half(kr_t, r, half, x);
    float ss = 0.0f;
#pragma unroll
    for (int e = 0; e < 32; ++e) ss += x[e] * x[e];
    ss += __shfl_xor_sync(0xffffffffu, ss, 1);
    const float rr_k = rsqrtf(ss + 1e-12f);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float y[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) y[e] = x[8 * c + e] * rr_k * ksc[half * 32 + 8 * c + e];
      *reinterpret_cast<uint4*>(kh_t + ac::swz<ROWB>(r, half * 4 + c)) = ac::pack8(y);
    }
    if (half == 0) {
      rk[wg * 64 + r] = rr_k;
      kb[wg * 64 + r] = key < m ? (p.bias ? p.bias[(long long)b * m + key] * LOG2E : 0.0f) : -INFINITY;
    }
    ac::fence_async_smem();  // k^ for wgmma
    ac::named_barrier(1 + wg, 128);
  }
  SP_TICK(3);

  const float kb2[2] = {kb[wg * 64 + rw], kb[wg * 64 + rw + 8]};
  float dv[32], dk[32];
  uint32_t pa[4][4], da[4][4];
#pragma unroll
  for (int kc = 0; kc < 4; ++kc)
#pragma unroll
    for (int e = 0; e < 4; ++e) pa[kc][e] = da[kc][e] = 0u;
  for (int i = 0; i < nqt; ++i) {
    const int s = i % SP_STAGES;
    ac::mbar_wait(ring.ready(s), (i / SP_STAGES) & 1);
    SP_TICK(4);
    const uint32_t q_a = sbase + L::RING_OFF + s * L::STAGE, g_a = q_a + TILE;
    const uint32_t kh_a = sbase + L::HAT_OFF + wg * TILE, v_a = sbase + L::SEC_OFF + wg * TILE;
    // S^T = k^ q^T, then dP^T = v g^T (64 keys x 64 queries), two groups; the first k step overwrites
    float sc[32], dp[32];
    ac::fence_operands(sc);
    ac::fence_operands(dp);
    ac::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      ac::wgmma_ss_n64(sc, ac::desc_kmajor<ROWB>(kh_a + kk * 32), ac::desc_kmajor<ROWB>(q_a + kk * 32), kk > 0);
    ac::wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      ac::wgmma_ss_n64(dp, ac::desc_kmajor<ROWB>(v_a + kk * 32), ac::desc_kmajor<ROWB>(g_a + kk * 32), kk > 0);
    ac::wgmma_commit();
    wgmma_wait<1>();  // S^T, and the last tile's dV and dK^ products: its stage is free
    ac::fence_operands(sc);
    fence_frags(pa);
    fence_frags(da);
    SP_TICK(5);
    if (i > 0) {
      __syncwarp();
      if (lane == 0) ac::mbar_arrive(ring.empty((i - 1) % SP_STAGES));
    }
    // P^T = exp(S^T + bias - LSE), rounded to bf16 as the A fragment of dV += P^T g (B MN-major)
    const float* ls = svec + s * 2 * T;
    const float* dl = ls + T;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const float2 ll = *reinterpret_cast<const float2*>(ls + 8 * jj + 2 * t);  // columns 8 jj + 2 t, + 1
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sc[4 * jj + e] = ex2(fmaf(sc[4 * jj + e], LOG2E, kb2[e >> 1]) - ((e & 1) ? ll.y : ll.x));
    }
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)
#pragma unroll
      for (int e = 0; e < 4; ++e) pa[kc][e] = ac::pack_bf16(sc[8 * kc + 2 * e], sc[8 * kc + 2 * e + 1]);
    SP_TICK(6);
    ac::fence_operands(dv);
    ac::wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) wgmma_rs(dv, pa[kc], ac::desc_mnmajor<ROWB>(g_a + kc * 16 * ROWB), i > 0 || kc > 0);
    ac::wgmma_commit();
    SP_TICK(5);
    wgmma_wait<1>();  // dP^T (dV may fly)
    ac::fence_operands(dp);
    SP_TICK(5);
    // dS^T = P^T (dP^T - D), rounded to bf16 as the A fragment of dK^ += dS^T q^
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i0 = 8 * kc + 2 * e;
        const float2 dd = *reinterpret_cast<const float2*>(dl + 16 * kc + 8 * (e >> 1) + 2 * t);
        da[kc][e] = ac::pack_bf16(sc[i0] * (dp[i0] - dd.x), sc[i0 + 1] * (dp[i0 + 1] - dd.y));
      }
    }
    SP_TICK(6);
    ac::fence_operands(dk);
    ac::wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) wgmma_rs(dk, da[kc], ac::desc_mnmajor<ROWB>(q_a + kc * 16 * ROWB), i > 0 || kc > 0);
    ac::wgmma_commit();
  }
  wgmma_wait<0>();
  ac::fence_operands(dv);
  ac::fence_operands(dk);
  fence_frags(pa);
  fence_frags(da);
  SP_TICK(5);

  // -- epilogue: dv, then dk through k's norm, each staged in this warpgroup's k^ tile
  const int keys = min(64, m - kw0);
  auto store_rows = [&](__nv_bfloat16* dst) {
    ac::named_barrier(1 + wg, 128);
#pragma unroll
    for (int it = 0; it < T * 8 / 128; ++it) {
      const int c = wt + it * 128, r = c >> 3, ch = c & 7;
      if (r < keys)
        *reinterpret_cast<uint4*>(dst + r * hd + ch * 8) = *reinterpret_cast<const uint4*>(kh_t + ac::swz<ROWB>(r, ch));
    }
    ac::named_barrier(1 + wg, 128);
  };
  ac::named_barrier(1 + wg, 128);  // every warp's products have retired: k^ may be overwritten
#pragma unroll
  for (int ii = 0; ii < 2; ++ii) {
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int e0 = 4 * jj + 2 * ii;
      *reinterpret_cast<uint32_t*>(kh_t + ac::swz<ROWB>(rw + 8 * ii, jj) + 4 * t) = ac::pack_bf16(dv[e0], dv[e0 + 1]);
    }
  }
  store_rows(p.dv + ((long long)b * m + kw0) * hd + h * D);
  {
    float cs[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) cs[e] = 0.0f;
#pragma unroll
    for (int ii = 0; ii < 2; ++ii) {
      const int r = rw + 8 * ii;
      const float rr_k = rk[wg * 64 + r];
      float u[16], w[16], uw = 0.0f;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const float2 kv =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(kr_t + ac::swz<ROWB>(r, jj) + 4 * t));
        const int e0 = 4 * jj + 2 * ii, c = 8 * jj + 2 * t;
        u[2 * jj] = kv.x * rr_k;
        u[2 * jj + 1] = kv.y * rr_k;
        w[2 * jj] = dk[e0] * ksc[c];
        w[2 * jj + 1] = dk[e0 + 1] * ksc[c + 1];
        uw += u[2 * jj] * w[2 * jj] + u[2 * jj + 1] * w[2 * jj + 1];
        cs[2 * jj] = fmaf(dk[e0], u[2 * jj], cs[2 * jj]);
        cs[2 * jj + 1] = fmaf(dk[e0 + 1], u[2 * jj + 1], cs[2 * jj + 1]);
      }
      uw += __shfl_xor_sync(0xffffffffu, uw, 1);
      uw += __shfl_xor_sync(0xffffffffu, uw, 2);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
        *reinterpret_cast<uint32_t*>(kh_t + ac::swz<ROWB>(r, jj) + 4 * t) =
            ac::pack_bf16(rr_k * (w[2 * jj] - u[2 * jj] * uw), rr_k * (w[2 * jj + 1] - u[2 * jj + 1] * uw));
    }
    // this warp's d k_scale = sum dk^ u_k over its rows
#pragma unroll
    for (int e = 0; e < 16; ++e) {
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) cs[e] += __shfl_xor_sync(0xffffffffu, cs[e], o);
    }
    if (lane < 4) {
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        red_a[warp * D + 8 * jj + 2 * t] = cs[2 * jj];
        red_a[warp * D + 8 * jj + 2 * t + 1] = cs[2 * jj + 1];
      }
    }
  }
  store_rows(p.dk + ((long long)b * m + kw0) * hd + h * D);
  ac::named_barrier(3, SP_CONSUMERS);
  if (tid < D) {
    float sum = 0.0f;
    for (int w = 0; w < SP_CONSUMERS / 32; ++w) sum += red_a[w * D + tid];
    p.dks_part[(((long long)b * gridDim.x + kblk) * p.H + h) * D + tid] = sum;
  }
  SP_TICK(7);
  SP_TIMER_END();
}

// -- f32: one key-stationary pass, then the query side, on CUDA cores ---------------

constexpr int FT = 256;        // threads of the f32 kernels
constexpr int RP = D + 4;      // padded row of the f32 tiles that a warp reads a row a lane
constexpr int RTILE = T * RP;
static_assert(RP == EP, "the keys kernel stages dK^ in its output tile");

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ void st4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
// 4 bytes global -> shared, asynchronously; zero-filled when !valid
__device__ __forceinline__ void cp4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(valid ? 4 : 0) : "memory");
}
// the sum over the 16 lanes of a half warp
__device__ __forceinline__ float sum16(float v) {
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// shared memory of `qknorm_bwd_keys_f32`, in floats, each region 16-byte aligned
struct KeysSmem {
  static constexpr int KQT = 0;                 // [c][key] k^ q_scale scale log2e
  static constexpr int VT = KQT + D * T;        // [c][key] v
  static constexpr int KS = VT + D * T;         // [key][RP] k^
  static constexpr int QT = KS + RTILE;         // [c][q] the query tile's raw q
  static constexpr int GT = QT + D * T;         // [c][q] g
  static constexpr int PS = GT + D * T;         // [q][key] P
  static constexpr int DS = PS + T * T;         // [q][RP] dS r_q
  static constexpr int RING = DS + RTILE;       // two stages: raw q [q][RP], g [q][RP], lse [T]
  static constexpr int STAGE = 2 * RTILE + T;
  static constexpr int OUT = RING + 2 * STAGE;  // [q][RP] the forward's output, one stage; dK^ at the end
  static constexpr int RED = OUT + RTILE;       // [8][T] q's sum of squares and g . out by column quarter
  static constexpr int KB = RED + 8 * T;        // [T] key bias log2e, -inf past m
  static constexpr int QSC = KB + T;            // [D] q_scale scale
  static constexpr int BYTES = (QSC + D) * 4;
};

// The f32 route's second kernel, the query side: a block per (64 queries,
// head, batch), 16 lanes a row (4 columns each), 16 rows at a time. A row
// sums its key tiles' parts r_q dQ^ in key order, adds the null column's
// dS_0 nk^, and goes through q's norm: with w' = r_q dQ^ q_scale scale,
// dq = w' - u_q (u_q . w'). Each block writes a row of d q_scale, d nv and
// d nk^ sums, each over its rows in order. D comes from the keys kernel,
// or from g . out where there is no key (nkt = 0).
__global__ void __launch_bounds__(FT) qknorm_bwd_queries_f32(const Bwd<float> p, int nkt) {
  __shared__ __align__(16) float nkh[D], nvs[D], qsc[D];
  __shared__ float4 sums[3][16][16];  // [d q_scale, d nv, d nk^][row slot][column group]
  const int tid = threadIdx.x, l = tid & 15, slot = tid >> 4, lane = tid & 31;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z, n = p.n, q0 = qt * T;
  const long long hd = (long long)p.H * D, bh = (long long)b * p.H + h;
  if (tid < 32) {  // the null key's norm
    const float a0 = p.nk[h * D + lane], a1 = p.nk[h * D + lane + 32];
    const float rn = rsqrtf(warp_sum(a0 * a0 + a1 * a1) + 1e-12f);
    nkh[lane] = a0 * rn * p.k_scale[lane];
    nkh[lane + 32] = a1 * rn * p.k_scale[lane + 32];
    nvs[lane] = p.nv[h * D + lane];
    nvs[lane + 32] = p.nv[h * D + lane + 32];
  }
  if (tid < D) qsc[tid] = p.q_scale[tid] * p.scale;
  __syncthreads();
  const float4 nk4 = ld4(nkh + 4 * l), nv4 = ld4(nvs + 4 * l), qs4 = ld4(qsc + 4 * l);
  float4 aq = make_float4(0.0f, 0.0f, 0.0f, 0.0f), av = aq, ak = aq;
  for (int rr = slot; rr < T; rr += 16) {  // every lane of a warp takes each step: the sums shuffle
    const int q = q0 + rr;
    const bool ok = q < n;
    float4 qv = make_float4(0.0f, 0.0f, 0.0f, 0.0f), gv = qv, acc = qv, ov = qv;
    float dd = 0.0f;
    if (ok) {
      qv = ld4(p.q + b * p.q_sb + q * p.q_sn + h * D + 4 * l);
      gv = ld4(p.g + b * p.g_sb + q * p.g_sn + h * D + 4 * l);
      if (nkt == 0) ov = ld4(p.out + ((long long)b * n + q) * hd + h * D + 4 * l);
      else dd = p.delta[bh * n + q];
      const float* part = p.dpart + (bh * nkt * n + q) * D + 4 * l;
#pragma unroll 8
      for (int kt = 0; kt < nkt; ++kt) {
        const float4 x = ld4(part + (long long)kt * n * D);
        acc.x += x.x, acc.y += x.y, acc.z += x.z, acc.w += x.w;
      }
    }
    const float rq = rsqrtf(sum16(qv.x * qv.x + qv.y * qv.y + qv.z * qv.z + qv.w * qv.w) + 1e-12f);
    const float4 u = make_float4(qv.x * rq, qv.y * rq, qv.z * rq, qv.w * rq);
    const float4 qh = make_float4(u.x * qs4.x, u.y * qs4.y, u.z * qs4.z, u.w * qs4.w);  // q^
    const float s0 = sum16(qh.x * nk4.x + qh.y * nk4.y + qh.z * nk4.z + qh.w * nk4.w);
    const float dp0 = sum16(gv.x * nv4.x + gv.y * nv4.y + gv.z * nv4.z + gv.w * nv4.w);
    const float dgo = sum16(gv.x * ov.x + gv.y * ov.y + gv.z * ov.z + gv.w * ov.w);
    if (nkt == 0) dd = dgo;
    const float p0 = ok ? expf(s0 - p.lse[bh * n + q]) : 0.0f;
    const float ds0 = p0 * (dp0 - dd), c0 = rq * ds0;
    // r_q dQ^ and w' = r_q dQ^ q_scale scale
    const float4 w2 = make_float4(fmaf(c0, nk4.x, acc.x), fmaf(c0, nk4.y, acc.y), fmaf(c0, nk4.z, acc.z),
                                  fmaf(c0, nk4.w, acc.w));
    const float4 w1 = make_float4(w2.x * qs4.x, w2.y * qs4.y, w2.z * qs4.z, w2.w * qs4.w);
    const float uw = sum16(u.x * w1.x + u.y * w1.y + u.z * w1.z + u.w * w1.w);
    if (ok)
      st4(p.dq + ((long long)b * n + q) * hd + h * D + 4 * l, w1.x - u.x * uw, w1.y - u.y * uw, w1.z - u.z * uw,
          w1.w - u.w * uw);
    // d q_scale / scale: dQ^ u_q = (r_q dQ^) q; d nv: P_0 g; d nk^: dS_0 q^
    aq.x = fmaf(w2.x, qv.x, aq.x), aq.y = fmaf(w2.y, qv.y, aq.y), aq.z = fmaf(w2.z, qv.z, aq.z), aq.w = fmaf(w2.w, qv.w, aq.w);
    av.x = fmaf(p0, gv.x, av.x), av.y = fmaf(p0, gv.y, av.y), av.z = fmaf(p0, gv.z, av.z), av.w = fmaf(p0, gv.w, av.w);
    ak.x = fmaf(ds0, qh.x, ak.x), ak.y = fmaf(ds0, qh.y, ak.y), ak.z = fmaf(ds0, qh.z, ak.z), ak.w = fmaf(ds0, qh.w, ak.w);
  }
  sums[0][slot][l] = aq;
  sums[1][slot][l] = av;
  sums[2][slot][l] = ak;
  __syncthreads();
  if (tid < 48) {
    const int a = tid >> 4, c = tid & 15;
    float4 t = sums[a][0][c];
#pragma unroll
    for (int i = 1; i < 16; ++i) {
      const float4 x = sums[a][i][c];
      t.x += x.x, t.y += x.y, t.z += x.z, t.w += x.w;
    }
    const float mul = a == 0 ? p.scale : 1.0f;
    float* dst = a == 0 ? p.dqs_part : a == 1 ? p.dnv_part : p.dnk_part;
    st4(dst + (((long long)b * gridDim.x + qt) * p.H + h) * D + 4 * c, t.x * mul, t.y * mul, t.z * mul, t.w * mul);
  }
}

// The f32 route's main kernel: a block per (64 keys, head, batch), 256
// threads, one block an SM (202 KiB of shared memory). k^ (normalised as
// the raw tile lands) and v stay in shared memory; the query tiles stream
// through a two-stage cp.async ring (raw q, g, out, lse), and as each lands
// its rows' |q|^2 and D = g . out are taken and raw q and g transposed. A
// thread holds a 4 x 4 tile of each product, a warp's lanes 8 lo x 4 hi:
// S^T and dP^T (keys 4 lo + i, queries 4 hi + j) once per tile pair, then
// dV += P^T g and dK^ / (q_scale scale) += (dS r_q)^T q (keys 4 hi + i,
// columns 4 lo + j) and the tile's part of r_q dQ^ = (dS r_q) k^ (queries
// hi + 16 i), which goes to `dpart` (B, H, key tiles, n, D). q^ = u_q
// q_scale scale is never formed: S = r_q (q . k^ q_scale scale), with
// log2e folded into that k^ copy, and r_q rides on dS. The block with the
// first key tile writes D for the query side.
__global__ void __launch_bounds__(FT, 1) qknorm_bwd_keys_f32(const Bwd<float> p) {
  extern __shared__ __align__(16) float fs[];
  float* kqt = fs + KeysSmem::KQT;
  float* vt = fs + KeysSmem::VT;
  float* ks = fs + KeysSmem::KS;
  float* qt = fs + KeysSmem::QT;
  float* gt = fs + KeysSmem::GT;
  float* ps = fs + KeysSmem::PS;
  float* dsm = fs + KeysSmem::DS;
  float* ring = fs + KeysSmem::RING;
  float* outb = fs + KeysSmem::OUT;
  float* red = fs + KeysSmem::RED;
  float* kb = fs + KeysSmem::KB;
  float* qsc = fs + KeysSmem::QSC;
  // a warp takes 8 lo x 4 hi groups of four: 8 float4 of one operand row and 4 of the other, a
  // wavefront each
  const int tid = threadIdx.x, w = tid >> 5, lo = (tid & 7) + 8 * (w & 1), hi = ((tid >> 3) & 3) + 4 * (w >> 1);
  const int r = tid & (T - 1), qtr = tid >> 6;  // a row a lane, a quarter of its columns a warp pair
  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z, nkt = gridDim.x;
  const int n = p.n, m = p.m, key0 = kt * T, keys = min(T, m - key0), nqt = (n + T - 1) / T;
  const long long hd = (long long)p.H * D, bh = (long long)b * p.H + h;
  const float* lse = p.lse + bh * n;

  // 64 rows of D floats from src (row stride `stride`) into dst [T][RP]; rows >= rows zero
  auto rows_async = [&](float* dst, const float* src, long long stride, int rows) {
    const uint32_t s = ac::smem_u32(dst);
#pragma unroll
    for (int it = 0; it < T * D / 4 / FT; ++it) {
      const int c = tid + it * FT, rr = c >> 4, ch = c & 15;
      const bool ok = rr < rows;
      cp16(s + (rr * RP + ch * 4) * 4, src + (ok ? rr : 0) * stride + ch * 4, ok);
    }
  };
  auto load_query_tile = [&](int j) {
    const int q0 = j * T, rows = min(T, n - q0);
    float* st = ring + (j & 1) * KeysSmem::STAGE;
    rows_async(st, p.q + b * p.q_sb + q0 * p.q_sn + h * D, p.q_sn, rows);
    rows_async(st + RTILE, p.g + b * p.g_sb + q0 * p.g_sn + h * D, p.g_sn, rows);
    rows_async(outb, p.out + ((long long)b * n + q0) * hd + h * D, hd, rows);
    if (tid < T) cp4(ac::smem_u32(st + 2 * RTILE + tid), lse + q0 + min(tid, rows - 1), tid < rows);
  };

  // the raw k and v tiles land in stage 1, free until query tile 1's loads
  float* kraw = ring + KeysSmem::STAGE;
  float* vraw = kraw + RTILE;
  rows_async(kraw, p.k + b * p.k_sb + key0 * p.k_sm + h * D, p.k_sm, keys);
  rows_async(vraw, p.v + b * p.v_sb + key0 * p.v_sm + h * D, p.v_sm, keys);
  cp_commit();
  load_query_tile(0);
  cp_commit();
  if (tid < T) {
    const int key = key0 + tid;
    kb[tid] = key < m ? (p.bias ? p.bias[(long long)b * m + key] * LOG2E : 0.0f) : -INFINITY;
  }
  if (tid < D) qsc[tid] = p.q_scale[tid] * p.scale;
  cp_wait<1>();
  __syncthreads();
  {  // k's sums of squares by quarter; v transposed
    float ss = 0.0f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = qtr * 16 + e * 4;
      const float4 x = ld4(kraw + r * RP + c), y = ld4(vraw + r * RP + c);
      ss = fmaf(x.x, x.x, fmaf(x.y, x.y, fmaf(x.z, x.z, fmaf(x.w, x.w, ss))));
      vt[(c + 0) * T + r] = y.x;
      vt[(c + 1) * T + r] = y.y;
      vt[(c + 2) * T + r] = y.z;
      vt[(c + 3) * T + r] = y.w;
    }
    red[qtr * T + r] = ss;
  }
  __syncthreads();
  {  // k^ into both layouts
    const float rk = rsqrtf(((red[r] + red[T + r]) + red[2 * T + r]) + red[3 * T + r] + 1e-12f);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = qtr * 16 + e * 4;
      const float4 x = ld4(kraw + r * RP + c);
      const float y[4] = {x.x * rk * p.k_scale[c], x.y * rk * p.k_scale[c + 1], x.z * rk * p.k_scale[c + 2],
                          x.w * rk * p.k_scale[c + 3]};
      st4(ks + r * RP + c, y[0], y[1], y[2], y[3]);
#pragma unroll
      for (int i = 0; i < 4; ++i) kqt[(c + i) * T + r] = y[i] * qsc[c + i] * LOG2E;
    }
  }

  float dv[4][4] = {}, dk[4][4] = {};
  for (int j = 0; j < nqt; ++j) {
    const int q0 = j * T, rows = min(T, n - q0);
    const float* qr = ring + (j & 1) * KeysSmem::STAGE;
    const float* gs = qr + RTILE;
    const float* ls = gs + RTILE;
    cp_wait<0>();
    __syncthreads();
    {  // q's sums of squares and g . out by quarter; raw q and g transposed
      float ss = 0.0f, dd = 0.0f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = qtr * 16 + e * 4;
        const float4 x = ld4(qr + r * RP + c), y = ld4(gs + r * RP + c), o = ld4(outb + r * RP + c);
        ss = fmaf(x.x, x.x, fmaf(x.y, x.y, fmaf(x.z, x.z, fmaf(x.w, x.w, ss))));
        dd = fmaf(y.x, o.x, fmaf(y.y, o.y, fmaf(y.z, o.z, fmaf(y.w, o.w, dd))));
        qt[(c + 0) * T + r] = x.x;
        qt[(c + 1) * T + r] = x.y;
        qt[(c + 2) * T + r] = x.z;
        qt[(c + 3) * T + r] = x.w;
        gt[(c + 0) * T + r] = y.x;
        gt[(c + 1) * T + r] = y.y;
        gt[(c + 2) * T + r] = y.z;
        gt[(c + 3) * T + r] = y.w;
      }
      red[qtr * T + r] = ss;
      red[(4 + qtr) * T + r] = dd;
    }
    __syncthreads();
    if (j + 1 < nqt) load_query_tile(j + 1);  // into the other stage and `outb`, both read for the last time above
    cp_commit();
    if (kt == 0 && tid < rows)
      p.delta[bh * n + q0 + tid] = ((red[4 * T + tid] + red[5 * T + tid]) + red[6 * T + tid]) + red[7 * T + tid];

    float s[4][4] = {}, dp[4][4] = {};  // S^T log2e / r_q and dP^T: keys 4 lo + i, queries 4 hi + jj
#pragma unroll
    for (int c = 0; c < D; ++c) {
      const float4 ka = ld4(kqt + c * T + 4 * lo), va = ld4(vt + c * T + 4 * lo);
      const float4 qb = ld4(qt + c * T + 4 * hi), gb = ld4(gt + c * T + 4 * hi);
      const float kv[4] = {ka.x, ka.y, ka.z, ka.w}, vv[4] = {va.x, va.y, va.z, va.w};
      const float qv[4] = {qb.x, qb.y, qb.z, qb.w}, gv[4] = {gb.x, gb.y, gb.z, gb.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          s[i][jj] = fmaf(kv[i], qv[jj], s[i][jj]);
          dp[i][jj] = fmaf(vv[i], gv[jj], dp[i][jj]);
        }
    }
    {  // P = exp2(S log2e + bias log2e - lse log2e) and dS r_q = P (dP - D) r_q, both [q][key]
      float sq[4] = {}, dq4[4] = {};
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float4 x = ld4(red + a * T + 4 * hi), y = ld4(red + (4 + a) * T + 4 * hi);
        sq[0] += x.x, sq[1] += x.y, sq[2] += x.z, sq[3] += x.w;
        dq4[0] += y.x, dq4[1] += y.y, dq4[2] += y.z, dq4[3] += y.w;
      }
      const float4 l4 = ld4(ls + 4 * hi), k4 = ld4(kb + 4 * lo);
      const float lv[4] = {l4.x, l4.y, l4.z, l4.w}, kv[4] = {k4.x, k4.y, k4.z, k4.w};
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int q = 4 * hi + jj;
        const float rq = rsqrtf(sq[jj] + 1e-12f), lq = q < rows ? lv[jj] * LOG2E : INFINITY;
        float pv[4], dsv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = exp2f(fmaf(s[i][jj], rq, kv[i] - lq));
          dsv[i] = pv[i] * (dp[i][jj] - dq4[jj]) * rq;
        }
        st4(ps + q * T + 4 * lo, pv[0], pv[1], pv[2], pv[3]);
        st4(dsm + q * RP + 4 * lo, dsv[0], dsv[1], dsv[2], dsv[3]);
      }
    }
    __syncthreads();
    // dV += P^T g and dK^ / (q_scale scale) += (dS r_q)^T q (keys 4 hi + i, columns 4 lo + jj);
    // this tile's r_q dQ^ = (dS r_q) k^ (queries hi + 16 i, columns 4 lo + jj)
    float dqp[4][4] = {};
#pragma unroll 4
    for (int x = 0; x < T; x += 4) {
#pragma unroll
      for (int xx = 0; xx < 4; ++xx) {
        const int qq = x + xx;
        const float4 pa = ld4(ps + qq * T + 4 * hi), da = ld4(dsm + qq * RP + 4 * hi);
        const float4 ga = ld4(gs + qq * RP + 4 * lo), qa = ld4(qr + qq * RP + 4 * lo);
        const float pv[4] = {pa.x, pa.y, pa.z, pa.w}, sv[4] = {da.x, da.y, da.z, da.w};
        const float gv[4] = {ga.x, ga.y, ga.z, ga.w}, qv[4] = {qa.x, qa.y, qa.z, qa.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            dv[i][jj] = fmaf(pv[i], gv[jj], dv[i][jj]);
            dk[i][jj] = fmaf(sv[i], qv[jj], dk[i][jj]);
          }
      }
      float dr[4][4], kr[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 a = ld4(dsm + (hi + 16 * i) * RP + x), c = ld4(ks + (x + i) * RP + 4 * lo);
        dr[i][0] = a.x, dr[i][1] = a.y, dr[i][2] = a.z, dr[i][3] = a.w;
        kr[i][0] = c.x, kr[i][1] = c.y, kr[i][2] = c.z, kr[i][3] = c.w;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int xx = 0; xx < 4; ++xx)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) dqp[i][jj] = fmaf(dr[i][xx], kr[xx][jj], dqp[i][jj]);
    }
    float* dst = p.dpart + ((bh * nkt + kt) * n + q0) * D;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (hi + 16 * i < rows) st4(dst + (hi + 16 * i) * D + 4 * lo, dqp[i][0], dqp[i][1], dqp[i][2], dqp[i][3]);
  }

  __syncthreads();
  float* acc = outb;  // [key][EP] dK^
  float* dvp = p.dv + ((long long)b * m + key0) * hd + h * D;
  const float4 q4 = ld4(qsc + 4 * lo);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int rr = 4 * hi + i;
    st4(acc + rr * EP + 4 * lo, dk[i][0] * q4.x, dk[i][1] * q4.y, dk[i][2] * q4.z, dk[i][3] * q4.w);
    if (rr < keys) st4(dvp + rr * hd + 4 * lo, dv[i][0], dv[i][1], dv[i][2], dv[i][3]);
  }
  __syncthreads();
  norm_chain_rows(acc, p.k + b * p.k_sb + key0 * p.k_sm + h * D, p.k_sm, keys, p.k_scale,
                  p.dk + ((long long)b * m + key0) * hd + h * D, hd, tid, FT);
  __syncthreads();
  column_sums(acc, p.dks_part + (((long long)b * nkt + kt) * p.H + h) * D, 1.0f, tid);
}

// -- the split route's partials, in a fixed order -------------------------------------

constexpr int CH = 32;          // row chunks of the first stage
constexpr int RT = 512;         // threads of the second stage

// First stage, grid (CH, 4): block (c, a) sums chunk c of the rows of
// partial a in row order into stage[a][c]. The partials are f32 (tiles, H,
// D): a = 0 d q_scale and a = 1 d k_scale as (tiles x H) rows of D columns;
// a = 2 d nv and a = 3 d nk^ as tiles rows of H x D columns. q_tiles =
// B x query blocks, k_tiles = B x key blocks (64 rows a block in f32, 128
// in bf16).
__global__ void __launch_bounds__(256)
qknorm_bwd_sum_rows(const float* __restrict__ dqs_part, const float* __restrict__ dks_part,
                    const float* __restrict__ dnv_part, const float* __restrict__ dnk_part, float* __restrict__ stage,
                    int q_tiles, int k_tiles, int H) {
  const int c = blockIdx.x, a = blockIdx.y;
  const float* src = a == 0 ? dqs_part : a == 1 ? dks_part : a == 2 ? dnv_part : dnk_part;
  const long long rows = a == 0 ? (long long)q_tiles * H : a == 1 ? (long long)k_tiles * H : q_tiles;
  const int width = a < 2 ? D : H * D;
  const long long per = (rows + CH - 1) / CH;
  const long long r0 = min(rows, c * per), r1 = min(rows, r0 + per);
  float* dst = stage + ((long long)a * CH + c) * H * D;
  for (int col = threadIdx.x; col < width; col += blockDim.x) {
    float sum = 0.0f;
    for (long long r = r0; r < r1; ++r) sum += src[r * width + col];
    dst[col] = sum;
  }
}

// Second stage, one block: the CH chunks of each partial in order, d nk^
// through the null key's norm, and its share of d k_scale.
template <typename TT>
__global__ void __launch_bounds__(RT)
qknorm_bwd_reduce(const float* __restrict__ stage, const TT* __restrict__ nk, const float* __restrict__ k_scale,
                  float* __restrict__ dqs, float* __restrict__ dks, TT* __restrict__ dnk, TT* __restrict__ dnv, int H) {
  extern __shared__ float rs[];
  float* dnkh = rs;             // [H][D] d nk^
  float* contrib = rs + H * D;  // [H][D] d nk^ u_nk
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long hd = (long long)H * D, plane = CH * hd;
  for (int idx = tid; idx < H * D; idx += RT) {
    float a = 0.0f, b = 0.0f;
    for (int c = 0; c < CH; ++c) {
      a += stage[2 * plane + c * hd + idx];
      b += stage[3 * plane + c * hd + idx];
    }
    dnv[idx] = from_f<TT>(a);
    dnkh[idx] = b;
  }
  __syncthreads();
  for (int h = warp; h < H; h += RT / 32) {  // d null_k through its norm
    float u[2], w[2], ss = 0.0f, uw = 0.0f;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      u[e] = to_f(nk[h * D + lane + 32 * e]);
      ss += u[e] * u[e];
    }
    const float r = rsqrtf(warp_sum(ss) + 1e-12f);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int cc = lane + 32 * e;
      u[e] *= r;
      w[e] = dnkh[h * D + cc] * k_scale[cc];
      uw += u[e] * w[e];
      contrib[h * D + cc] = dnkh[h * D + cc] * u[e];
    }
    uw = warp_sum(uw);
#pragma unroll
    for (int e = 0; e < 2; ++e) dnk[h * D + lane + 32 * e] = from_f<TT>(r * (w[e] - u[e] * uw));
  }
  __syncthreads();
  if (tid < D) {
    float sq = 0.0f, sk = 0.0f;
    for (int c = 0; c < CH; ++c) {
      sq += stage[c * hd + tid];
      sk += stage[plane + c * hd + tid];
    }
    for (int h = 0; h < H; ++h) sk += contrib[h * D + tid];
    dqs[tid] = sq;
    dks[tid] = sk;
  }
}

// -- host side ------------------------------------------------------------------

inline size_t align256(size_t x) { return (x + 255) & ~size_t(255); }

inline bool takes_one_pass(int n, int esize) { return esize == 2 && n <= OP_N; }

struct Workspace {
  size_t counter, head_sums, stage, dpart, delta, dqs_part, dks_part, dnk_part, dnv_part, clocks, bytes;
};

// Rows a block owns on a split route: 128 (bf16) or 64 (f32), on the query
// side and on the key side.
inline int split_rows(int esize) { return esize == 2 ? SP_ROWS : T; }

#ifdef QKNORM_BWD_TIMING
// The timing build's rows of clocks: a block each of the one-pass kernel
// (B x H) or of the bf16 split route's two kernels
inline size_t clock_rows(int B, int n, int m, int H, int esize) {
  if (takes_one_pass(n, esize) || esize == 4) return (size_t)B * H;
  return (size_t)B * H * ((n + SP_ROWS - 1) / SP_ROWS + (m + SP_ROWS - 1) / SP_ROWS);
}
#endif

// one-pass: the tickets and the heads' sums; split routes: the chunk sums
// and D, f32 also the key tiles' dQ^ parts; then the partials, a row a
// block and head
inline Workspace workspace(int B, int n, int m, int H, int esize) {
  const size_t nkt = (m + T - 1) / T;
  Workspace w = {};
  size_t at = 0;
  auto take = [&](size_t bytes) {
    const size_t here = at;
    at += align256(bytes);
    return here;
  };
  size_t q_blocks = B, k_blocks = B;  // one-pass: a block a (batch, head)
  if (takes_one_pass(n, esize)) {
    w.counter = take((H + 1) * sizeof(int));
    w.head_sums = take((size_t)H * 3 * D * 4);
  } else {
    w.stage = take((size_t)4 * CH * H * D * 4);
    if (esize == 4) w.dpart = take((size_t)B * H * nkt * n * D * 4);
    w.delta = take((size_t)B * H * n * 4);
    const int rows = split_rows(esize);
    q_blocks = (size_t)B * ((n + rows - 1) / rows), k_blocks = (size_t)B * ((m + rows - 1) / rows);
  }
  w.dqs_part = take(q_blocks * H * D * 4);
  w.dks_part = take(k_blocks * H * D * 4);
  w.dnk_part = take(q_blocks * H * D * 4);
  w.dnv_part = take(q_blocks * H * D * 4);
#ifdef QKNORM_BWD_TIMING
  w.clocks = take(clock_rows(B, n, m, H, esize) * CLOCK_SLOTS * 8);
#endif
  w.bytes = at;
  return w;
}

// the dynamic shared memory limit of a kernel (`slot`, one a kernel),
// raised once per device
inline cudaError_t allow_smem(const void* fn, int bytes, int slot) {
  static bool done[4][32] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 32 && done[slot][dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess && dev < 32) done[slot][dev] = true;
  return e;
}

template <typename TT>
cudaError_t launch_all(const void* g, const void* q, const void* k, const void* v, const void* out, const float* lse,
                       const void* nk, const void* nv, const float* qs, const float* ks, const float* bias, void* dq,
                       void* dk, void* dv, void* dnk, void* dnv, float* dqs, float* dks, unsigned char* ws, int B,
                       int n, int m, int H, long long g_sb, long long g_sn, long long q_sb, long long q_sn,
                       long long k_sb, long long k_sm, long long v_sb, long long v_sm, float scale,
                       cudaStream_t stream) {
  const Workspace w = workspace(B, n, m, H, sizeof(TT));
  const int nqt = (n + T - 1) / T, nkt = (m + T - 1) / T;
  Bwd<TT> p = {};
  p.g = static_cast<const TT*>(g);
  p.q = static_cast<const TT*>(q);
  p.k = static_cast<const TT*>(k);
  p.v = static_cast<const TT*>(v);
  p.out = static_cast<const TT*>(out);
  p.nk = static_cast<const TT*>(nk);
  p.nv = static_cast<const TT*>(nv);
  p.lse = lse;
  p.delta = reinterpret_cast<float*>(ws + w.delta);
  p.dpart = reinterpret_cast<float*>(ws + w.dpart);
  p.q_scale = qs;
  p.k_scale = ks;
  p.bias = bias;
  p.dq = static_cast<TT*>(dq);
  p.dk = static_cast<TT*>(dk);
  p.dv = static_cast<TT*>(dv);
  p.dnk = static_cast<TT*>(dnk);
  p.dnv = static_cast<TT*>(dnv);
  p.dqs = dqs;
  p.dks = dks;
  p.dqs_part = reinterpret_cast<float*>(ws + w.dqs_part);
  p.dks_part = reinterpret_cast<float*>(ws + w.dks_part);
  p.dnk_part = reinterpret_cast<float*>(ws + w.dnk_part);
  p.dnv_part = reinterpret_cast<float*>(ws + w.dnv_part);
  p.head_sums = reinterpret_cast<float*>(ws + w.head_sums);
  p.counter = reinterpret_cast<int*>(ws + w.counter);
  p.clocks = reinterpret_cast<long long*>(ws + w.clocks);
  p.g_sb = g_sb, p.g_sn = g_sn, p.q_sb = q_sb, p.q_sn = q_sn;
  p.k_sb = k_sb, p.k_sm = k_sm, p.v_sb = v_sb, p.v_sm = v_sm;
  p.n = n, p.m = m, p.H = H, p.scale = scale;

  cudaError_t e;
  if constexpr (sizeof(TT) == 2) {
    if (takes_one_pass(n, 2)) {
      if ((e = cudaMemsetAsync(p.counter, 0, (H + 1) * sizeof(int), stream)) != cudaSuccess) return e;
      if ((e = allow_smem(reinterpret_cast<const void*>(qknorm_bwd_onepass_bf16), OnePassSmem::ALLOC, 0)) !=
          cudaSuccess)
        return e;
      qknorm_bwd_onepass_bf16<<<dim3(H, B), OP_NTH, OnePassSmem::ALLOC, stream>>>(p);
      return cudaGetLastError();
    }
  }

  int q_tiles = B * nqt, k_tiles = B * nkt;  // the partials' rows
  if constexpr (sizeof(TT) == 2) {
    // the bf16 split route: the query-stationary kernel (which writes D),
    // then the key-stationary one, over TMA maps of the callers' strides
    const int nqb = (n + SP_ROWS - 1) / SP_ROWS, nkb = (m + SP_ROWS - 1) / SP_ROWS;
    CUtensorMap tq = {}, tg = {}, tk = {}, tv = {};  // without keys k and v are never loaded
    if ((e = ac::make_kv_map(&tq, q, D, (long long)H * D, n, B, q_sn, q_sb)) != cudaSuccess) return e;
    if ((e = ac::make_kv_map(&tg, g, D, (long long)H * D, n, B, g_sn, g_sb)) != cudaSuccess) return e;
    if (m > 0) {
      if ((e = ac::make_kv_map(&tk, k, D, (long long)H * D, m, B, k_sm, k_sb)) != cudaSuccess) return e;
      if ((e = ac::make_kv_map(&tv, v, D, (long long)H * D, m, B, v_sm, v_sb)) != cudaSuccess) return e;
    }
    if ((e = allow_smem(reinterpret_cast<const void*>(qknorm_bwd_queries_bf16), SplitSmem::ALLOC, 1)) != cudaSuccess)
      return e;
    qknorm_bwd_queries_bf16<<<dim3(nqb, H, B), SP_THREADS, SplitSmem::ALLOC, stream>>>(tq, tg, tk, tv, p);
    if (m > 0) {
      if ((e = cudaGetLastError()) != cudaSuccess) return e;
      if ((e = allow_smem(reinterpret_cast<const void*>(qknorm_bwd_keys_bf16), SplitSmem::ALLOC, 2)) != cudaSuccess)
        return e;
      Bwd<TT> pk = p;
      pk.clocks += (long long)B * H * nqb * CLOCK_SLOTS;  // the timing build's rows of this kernel
      qknorm_bwd_keys_bf16<<<dim3(nkb, H, B), SP_THREADS, SplitSmem::ALLOC, stream>>>(tq, tg, tk, tv, pk);
    }
    q_tiles = B * nqb, k_tiles = B * nkb;
  } else {
    // f32: the key-stationary pass, then the query side
    if (nkt > 0) {
      if ((e = allow_smem(reinterpret_cast<const void*>(qknorm_bwd_keys_f32), KeysSmem::BYTES, 3)) != cudaSuccess)
        return e;
      qknorm_bwd_keys_f32<<<dim3(nkt, H, B), FT, KeysSmem::BYTES, stream>>>(p);
      if ((e = cudaGetLastError()) != cudaSuccess) return e;
    }
    qknorm_bwd_queries_f32<<<dim3(nqt, H, B), FT, 0, stream>>>(p, nkt);
  }
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  // the partials in two fixed-order stages
  float* stage = reinterpret_cast<float*>(ws + w.stage);
  qknorm_bwd_sum_rows<<<dim3(CH, 4), 256, 0, stream>>>(p.dqs_part, p.dks_part, p.dnv_part, p.dnk_part, stage,
                                                       q_tiles, k_tiles, H);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  qknorm_bwd_reduce<TT><<<1, RT, 2 * H * D * 4, stream>>>(stage, p.nk, ks, dqs, dks, p.dnk, p.dnv, H);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of the scratch buffer `muse_qknorm_attn_bwd_launch` takes.
long long muse_qknorm_attn_bwd_workspace(int B, int n, int m, int H, int dtype) {
  return static_cast<long long>(workspace(B, n, m, H, dtype == 1 ? 2 : 4).bytes);
}

// Where the timing build's clocks lie in the workspace (bytes from its
// start; rows of 10 int64: B x H for the one-pass kernel, then on the bf16
// split route B x H x query blocks for `queries_bf16` and B x H x key
// blocks for `keys_bf16`), or -1 without -DQKNORM_BWD_TIMING.
long long muse_qknorm_attn_bwd_clocks(int B, int n, int m, int H, int dtype) {
#ifdef QKNORM_BWD_TIMING
  return static_cast<long long>(workspace(B, n, m, H, dtype == 1 ? 2 : 4).clocks);
#else
  return -1;
#endif
}

// Rows of clocks the timing build writes (see above); 0 without it.
long long muse_qknorm_attn_bwd_clock_rows(int B, int n, int m, int H, int dtype) {
#ifdef QKNORM_BWD_TIMING
  return static_cast<long long>(clock_rows(B, n, m, H, dtype == 1 ? 2 : 4));
#else
  return 0;
#endif
}

// 1 where the call takes the one-pass kernel, 0 where the split route.
int muse_qknorm_attn_bwd_one_pass(int n, int dtype) { return takes_one_pass(n, dtype == 1 ? 2 : 4) ? 1 : 0; }

// g (B, n, H, 64), q (B, n, H, 64), k/v (B, m, H, 64): unit stride over
// (H, 64), the given element strides over batch and sequence; out (B, n, H,
// 64) contiguous, the forward's output; lse (B, H, n) f32, the forward's row
// logsumexp; nk/nv (H, 64) in the inputs' dtype; q_scale/k_scale (64,) f32;
// bias (B, m) f32 or null. Writes dq (B, n, H, 64), dk/dv (B, m, H, 64)
// contiguous and d nk, d nv (H, 64) in the inputs' dtype, d q_scale,
// d k_scale (64,) in f32. dtype 0 = f32, 1 = bf16 (bf16: 16-byte aligned
// rows). B, n >= 1 and H <= 64. Returns the first CUDA error, else 0.
int muse_qknorm_attn_bwd_launch(const void* g, const void* q, const void* k, const void* v, const void* out,
                                const void* lse, const void* nk, const void* nv, const void* q_scale,
                                const void* k_scale, const void* bias, void* dq, void* dk, void* dv, void* dnk,
                                void* dnv, void* dqs, void* dks, void* workspace_, int B, int n, int m, int H,
                                long long g_sb, long long g_sn, long long q_sb, long long q_sn, long long k_sb,
                                long long k_sm, long long v_sb, long long v_sm, float scale, int dtype,
                                void* stream) {
  if (B <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* ws = static_cast<unsigned char*>(workspace_);
  const auto* lf = static_cast<const float*>(lse);
  const auto* qs = static_cast<const float*>(q_scale);
  const auto* ks = static_cast<const float*>(k_scale);
  const auto* bf = static_cast<const float*>(bias);
  auto f = [](void* x) { return static_cast<float*>(x); };
  if (dtype == 1)
    return launch_all<__nv_bfloat16>(g, q, k, v, out, lf, nk, nv, qs, ks, bf, dq, dk, dv, dnk, dnv, f(dqs), f(dks),
                                     ws, B, n, m, H, g_sb, g_sn, q_sb, q_sn, k_sb, k_sm, v_sb, v_sm, scale, s);
  return launch_all<float>(g, q, k, v, out, lf, nk, nv, qs, ks, bf, dq, dk, dv, dnk, dnv, f(dqs), f(dks), ws, B, n,
                           m, H, g_sb, g_sn, q_sb, q_sn, k_sb, k_sm, v_sb, v_sm, scale, s);
}

const char* muse_qknorm_attn_bwd_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
