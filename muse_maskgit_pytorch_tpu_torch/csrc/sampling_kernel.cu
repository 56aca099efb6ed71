// Fused top-k / gumbel sampler for the MaskGit decode loop, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_sample_kernel` in
// muse_maskgit_pytorch_tpu/ops/sampling_kernel.py (Pallas). Per row of a
// (rows, V) logits array it computes, in one launch:
//   1. optionally the CFG combine l = null + (cond - null) * scale (cfg_pair;
//      the scale is read from device memory, like the seed, so a decode loop
//      whose guidance changes from step to step never reads it on the host);
//   2. the top-k threshold of 10 rounds of value bisection that keep
//      count(l >= lo) >= k (mid = 0.5 * (lo + hi) in f32, `>=` compares),
//      bit-identical to the Pallas body's;
//   3. the logsumexp of the unfiltered row;
//   4. gumbel noise, injected or from a Philox4x32-10 stream keyed on
//      (seed, row_offset + row) with the column as counter (4 columns per
//      call; a data-parallel rank that samples rows of a global batch passes
//      its first global row, so its noise is the global batch's);
//   5. the first-index argmax of l / max(temp, 1e-10) + g over l >= thresh,
//      and prob = exp(l[idx] - lse).
//
// A second entry point, `muse_philox_gumbel_launch`, writes the noise of
// step 4 out as a (rows, V) array, for the exact sampler (see
// `philox_gumbel_kernel` at the end of the file).
//
// What bounds it on the H100. By bytes, the main path's step 0 (32*256 rows x
// 65536 bf16 = 1.07 GB, read once from HBM) needs 0.32 ms at 3.35 TB/s: 5.2 us
// a row for each of the 132 SMs. The kernel takes about 1.1 ms there (NVIDIA
// H100 80GB HBM3, 700 W): the row's copy is hidden, and what is left is the
// instructions an SM spends on a row, some 14 a value in the three passes
// and some 125 for each of the ~6554 columns that pass the threshold (a
// Philox4x32-10 call, two logf, an IEEE division), with a block barrier
// between the parts. Built with -DSAMPLER_TIMING it reports the clocks of
// each part. Design:
//
//   * Three passes over a row, not one per bisection round. The ten rounds
//     only ever compare against the 1023 node values of a depth-10 tree that
//     the row's (min, max) fix in advance. Pass A takes min and max. The
//     block then writes the tree's 1024 leaf intervals' lower ends E[0..1023]
//     (thread j walks its own path with the bisection's f32 operations; E is
//     sorted, and E[(2 j + 1) << (9 - d)] is the mid of node j at depth d).
//     Pass B counts each logit into the bin g with E[g] <= x < E[g + 1] (a
//     1024-bin histogram in shared memory, shared-memory atomics) and sums
//     the logsumexp terms. The bin is an arithmetic guess
//     (x - lo) * 1024 / (hi - lo), counted as it is in straight-line code; a
//     value whose guess lies nearer a bin edge than 3.8 times what the
//     roundings could move it (about one in 250) is marked, and afterwards
//     searches E and moves its count if the guess was wrong, so every count
//     is the count the `>=` compares give. A suffix sum over the bins holds
//     count(l >= mid) for every node at once, and the ten rounds are ten
//     look-ups. Pass C is the filtered argmax.
//   * A persistent grid, one block of 1024 threads on each SM, walking rows
//     blockIdx.x, blockIdx.x + gridDim.x, ... A bf16 row of up to 65536
//     arrives by the 1-D bulk copy (`cp.async.bulk`, no tensor map) in 16 KB
//     chunks into a ring of 11 chunks: the 8 of the row in hand and 3 of the
//     next. A row's copies complete on one mbarrier, awaited before pass A.
//     Pass C reads the row for the last time when it writes its lists (an
//     entry carries the value with the column); the last warp to get there
//     starts the copies that reuse the row's 8 slots, so the next rows
//     stream from HBM while this one draws its noise. Thread t always reads
//     the t-th 16 bytes of a chunk, in every pass.
//   * Noise is drawn only for the ~10% of columns at or above the threshold.
//     In pass C a thread marks them in a 64-bit mask (two bf16 a compare);
//     one prefix sum over the warp's counts places every lane's columns in
//     the warp's list in shared memory, and the warp then draws for 32 of
//     them at a time, one a lane: no lane runs Philox for a column that
//     another lane of its warp needed. A warp with more columns than its
//     list holds (a row of ties, k near V) scores them lane by lane.
//   * A row's argmax is finished behind the next row's first barrier, so a
//     warp that is done with pass C starts on the next row at once. Five
//     block barriers a row.
//   * f32 rows, cfg_pair rows, rows longer than 65536 or not 16-byte aligned
//     take the same three passes reading global memory (L2 after the first),
//     16 bytes a thread where the row's alignment allows.
//
// Exactness: this file is compiled with -fmad=false and without fast math,
// so the CFG combine is a rounded multiply then a rounded add and `/` is
// the IEEE division, as in the plain PyTorch version. The logsumexp terms
// alone use the hardware's exp2 (relative error 2^-22 a term, checked
// against the plain version at 1e-5 of prob). A row that holds a NaN or an
// infinity guesses no bins: every value searches E.
//
// Built with -DSAMPLER_WATCHDOG, a wait on an mbarrier of more than about
// ten seconds traps, so a pipeline fault is a launch error, not a hung card.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kBisectIters = 10;
constexpr int kBins = 1 << kBisectIters;
constexpr int kChunkBytes = 16 * 1024;  // one bulk copy; 16 bytes a thread
constexpr int kChunkElems = kChunkBytes / 2;
constexpr int kSlots = 11;          // chunks in the ring
constexpr int kBars = 16;           // mbarriers, one a row in flight (kSlots one-chunk rows at most)
constexpr int kMaxStagedV = 65536;  // 8 chunks; a column fits 16 bits of a list entry

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

__device__ __forceinline__ void unpack8(const uint4& u, float* x) {
  x[0] = bf16_lo(u.x); x[1] = bf16_hi(u.x); x[2] = bf16_lo(u.y); x[3] = bf16_hi(u.y);
  x[4] = bf16_lo(u.z); x[5] = bf16_hi(u.z); x[6] = bf16_lo(u.w); x[7] = bf16_hi(u.w);
}

// -- PTX wrappers -------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
#ifdef SAMPLER_WATCHDOG
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
#ifdef SAMPLER_WATCHDOG
    if (!done && clock64() - t0 > 20000000000ll) __trap();
#endif
  }
}

// 1-D bulk copy global -> shared, completing `bytes` on the mbarrier
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// earlier generic-proxy accesses of shared memory are ordered before later
// async-proxy ones (the bulk copy that reuses a chunk)
__device__ __forceinline__ void fence_async_smem() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

// -- row sources ----------------------------------------------------------------
//
// A source visits every column of the row in hand once per pass, kGroup
// columns a thread and step, as f(values, valid): step s gives thread t the
// columns (s * kThreads + t) * kGroup + j. Every thread runs the same number
// of steps (warp-uniform), with `valid` false past the end, so f may use warp
// collectives. Pass C keeps the columns that passed the threshold as entries
// of a per-warp list of kList: entry(step, j) makes one, entry_col and
// entry_val read it back.

// A row in global memory, G columns (16 bytes where G > 1) a thread.
template <typename T, bool PAIR, int G>
struct GlobalRow {
  static constexpr bool kStaged = false;
  static constexpr bool kPair = PAIR;
  static constexpr int kGroup = G;
  static constexpr int kList = 512;
  const T* cond;
  const T* null;
  float scale;
  int V;

  __device__ __forceinline__ void begin_row(const T* logits, int rows, int row) {
    cond = logits + (size_t)row * V;
    null = PAIR ? logits + ((size_t)rows + row) * V : nullptr;
  }
  __device__ __forceinline__ void await_row() const {}
  __device__ __forceinline__ void release_row() {}
  __device__ __forceinline__ void end_row() {}
  __device__ __forceinline__ float combine(float c, float n) const { return PAIR ? n + (c - n) * scale : c; }
  __device__ __forceinline__ float at(int i) const {
    return combine(to_f(cond[i]), PAIR ? to_f(null[i]) : 0.0f);
  }
  __device__ __forceinline__ void load(const T* p, int group, float* x) const {
    if constexpr (G == 1) {
      x[0] = to_f(p[group]);
    } else if constexpr (sizeof(T) == 2) {
      unpack8(reinterpret_cast<const uint4*>(p)[group], x);
    } else {
      const float4 v = reinterpret_cast<const float4*>(p)[group];
      x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
    }
  }
  template <class F>
  __device__ __forceinline__ void visit(F&& f) const {
    const int groups = V / G;
    for (int base = 0; base < groups; base += kThreads) {
      const int c = base + threadIdx.x;
      const bool valid = c < groups;
      float x[G];
#pragma unroll
      for (int j = 0; j < G; ++j) x[j] = 0.0f;
      if (valid) {
        load(cond, c, x);
        if (PAIR) {
          float n[G];
          load(null, c, n);
#pragma unroll
          for (int j = 0; j < G; ++j) x[j] = combine(x[j], n[j]);
        }
      }
      f(x, valid);
    }
  }
  __device__ __forceinline__ void min_max(float& lo, float& hi) const {
    bool nan = false;
    visit([&](const float* x, bool valid) {
      if (!valid) return;
#pragma unroll
      for (int j = 0; j < G; ++j) { lo = fminf(lo, x[j]); hi = fmaxf(hi, x[j]); nan |= x[j] != x[j]; }
    });
    if (nan) hi = INFINITY;  // not a regular row: no bin is guessed from a NaN
  }
  // f(bits): bit j set where the step's j-th column is at or above thresh
  template <class F>
  __device__ __forceinline__ void visit_marks(float thresh, F&& f) const {
    visit([&](const float* x, bool valid) {
      uint32_t m = 0u;
      if (valid) {
#pragma unroll
        for (int j = 0; j < G; ++j) m |= (x[j] >= thresh ? 1u : 0u) << j;
      }
      f(m);
    });
  }
  // a list entry is the column; its value is read again
  __device__ __forceinline__ uint32_t entry(int step, int j) const {
    return (uint32_t)((step * kThreads + (int)threadIdx.x) * G + j);
  }
  __device__ __forceinline__ int entry_col(uint32_t e) const { return (int)e; }
  __device__ __forceinline__ float entry_val(uint32_t e) const { return at((int)e); }
  // the entries of a mask's columns (bit b: step step0 + b / G, column b % G of it)
  __device__ __forceinline__ void write_marked(unsigned long long mask, int step0, uint32_t* out) const {
    while (mask) {
      const int b = __ffsll((long long)mask) - 1;
      mask &= mask - 1;
      *out++ = entry(step0 + b / G, b % G);
    }
  }
};

// A bf16 row (V % 8 == 0, V <= kMaxStagedV, 16-byte aligned) streaming
// through the ring of chunks in shared memory. Chunk q of this block's
// sequence (row q / nc of its rows, part q % nc) lives in slot q % kSlots.
// The copies of the block's i-th row complete on mbarrier i % kBars, in its
// phase (i / kBars) & 1: fewer than kBars rows are ever in flight. FULL: the
// row is kMaxStagedV long, eight whole chunks, and its loops unroll.
template <bool FULL>
struct StagedRow {
  static constexpr bool kStaged = true;
  static constexpr int kGroup = 8;
  static constexpr int kList = 320;
  const unsigned char* chunks;  // shared memory, kSlots * kChunkBytes
  uint32_t chunks_u32, full_u32;
  const __nv_bfloat16* logits;
  int* released;          // warps that are done with the row in hand's chunks
  int rows, V, nc, last_bytes;  // chunks a row, bytes of a row's last chunk
  int ahead_rows, ahead_part;   // kSlots = ahead_rows * nc + ahead_part
  int r, slot0;                 // the row in hand (r-th of this block) and its first chunk's slot

  __device__ __forceinline__ void begin_row(const __nv_bfloat16*, int, int) {}
  __device__ __forceinline__ int parts() const { return FULL ? kMaxStagedV / kChunkElems : nc; }
  // whether this thread has 16 bytes of the row's part c
  __device__ __forceinline__ bool has(int c) const {
    return FULL || (int)threadIdx.x * 16 < (c == nc - 1 ? last_bytes : kChunkBytes);
  }
  // one thread: start the copy of part c of this block's i-th row into slot s
  __device__ __forceinline__ void start_copy(int i, int c, int s) const {
    const size_t row = (size_t)blockIdx.x + (size_t)i * gridDim.x;
    if (row >= (size_t)rows) return;
    const __nv_bfloat16* src = logits + row * V + (size_t)c * kChunkElems;
    const uint32_t bytes = c == nc - 1 ? last_bytes : kChunkBytes;
    const uint32_t bar = full_u32 + 8 * (i % kBars);
    mbar_arrive_tx(bar, bytes);
    bulk_load(chunks_u32 + s * kChunkBytes, src, bytes, bar);
  }
  // A warp has read the row in hand for the last time. The last warp to say
  // so starts the copies that reuse the row's slots: the chunks kSlots
  // further on in the block's sequence.
  __device__ __forceinline__ void release_row() {
    __syncwarp();
    if ((threadIdx.x & 31) != 0) return;
    __threadfence_block();
    if (atomicAdd(released, 1) != kWarps - 1) return;
    *released = 0;
    __threadfence_block();
    fence_async_smem();
    int s = slot0;
    for (int c = 0; c < nc; ++c) {
      const int p = c + ahead_part;
      if (p >= nc) start_copy(r + ahead_rows + 1, p - nc, s); else start_copy(r + ahead_rows, p, s);
      if (++s == kSlots) s = 0;
    }
  }
  __device__ __forceinline__ void end_row() {
    ++r;
    const int s = slot0 + nc;  // nc <= 8 < kSlots
    slot0 = s >= kSlots ? s - kSlots : s;
  }
  __device__ __forceinline__ const unsigned char* mine(int step) const {  // this thread's 16 bytes
    int s = slot0 + step;
    if (s >= kSlots) s -= kSlots;
    return chunks + s * kChunkBytes + threadIdx.x * 16;
  }
  template <class F>
  __device__ __forceinline__ void visit(F&& f) const {
#pragma unroll
    for (int c = 0; c < parts(); ++c) {
      const bool valid = has(c);
      uint4 u = make_uint4(0u, 0u, 0u, 0u);
      if (valid) u = *reinterpret_cast<const uint4*>(mine(c));
      float x[8];
      unpack8(u, x);
      f(x, valid);
    }
  }
  // a list entry carries the value above the column, so the chunks are free
  // once the list is written
  __device__ __forceinline__ uint32_t entry(int step, int j) const {
    const uint32_t raw = reinterpret_cast<const uint16_t*>(mine(step))[j];
    return (raw << 16) | (uint32_t)(step * kChunkElems + (int)threadIdx.x * 8 + j);
  }
  __device__ __forceinline__ int entry_col(uint32_t e) const { return (int)(e & 0xffffu); }
  __device__ __forceinline__ float entry_val(uint32_t e) const { return __uint_as_float(e & 0xffff0000u); }
  // the entries of a mask's columns (bit b: step b / 8, column b % 8 of it;
  // a row is one mask). A lane runs this as often as the fullest lane of its
  // warp has columns, so the loop is kept short: but for the thread's own
  // offset, a column is its value's place in the row.
  __device__ __forceinline__ void write_marked(unsigned long long mask, int, uint32_t* out) const {
    const uint32_t base = chunks_u32 + slot0 * kChunkBytes + threadIdx.x * 16;
    const uint32_t wrap_at = (kSlots - slot0) * 8;  // bits of the steps that lie past the ring's end
    const uint32_t col0 = threadIdx.x * 8;
    uint32_t lo = (uint32_t)mask, hi = (uint32_t)(mask >> 32);
    while (lo | hi) {
      uint32_t b;
      if (lo) { b = __ffs(lo) - 1; lo &= lo - 1; } else { b = 31 + __ffs(hi); hi &= hi - 1; }
      const uint32_t place = (b & 7u) | ((b >> 3) << 13);
      uint32_t addr = base + 2u * place;
      if (b >= wrap_at) addr -= kSlots * kChunkBytes;
      uint16_t raw;
      asm volatile("ld.shared.u16 %0, [%1];\n" : "=h"(raw) : "r"(addr));
      *out++ = ((uint32_t)raw << 16) | (place + col0);
    }
  }
  __device__ __forceinline__ float at(int i) const {
    int s = slot0 + (i / kChunkElems);
    if (s >= kSlots) s -= kSlots;
    const uint16_t* chunk = reinterpret_cast<const uint16_t*>(chunks + s * kChunkBytes);
    return __uint_as_float((uint32_t)chunk[i % kChunkElems] << 16);
  }
  // wait until the row in hand's chunks have landed
  __device__ __forceinline__ void await_row() const {
    mbar_wait(full_u32 + 8 * (r % kBars), (r / kBars) & 1);
  }
  // min and max of the row; two bf16 an instruction
  __device__ __forceinline__ void min_max(float& lo, float& hi) const {
    uint32_t mn = 0x7f7f7f7fu, mx = 0xff7fff7fu;  // the largest and the lowest finite bf16, twice
    auto as2 = [](uint32_t& w) -> __nv_bfloat162& { return reinterpret_cast<__nv_bfloat162&>(w); };
    int s = slot0;
#pragma unroll
    for (int c = 0; c < parts(); ++c) {
      if (has(c)) {
        uint4 u = *reinterpret_cast<const uint4*>(chunks + s * kChunkBytes + threadIdx.x * 16);
        as2(mn) = __hmin2_nan(__hmin2_nan(as2(u.x), as2(u.y)), __hmin2_nan(__hmin2_nan(as2(u.z), as2(u.w)), as2(mn)));
        as2(mx) = __hmax2_nan(__hmax2_nan(as2(u.x), as2(u.y)), __hmax2_nan(__hmax2_nan(as2(u.z), as2(u.w)), as2(mx)));
      }
      if (++s == kSlots) s = 0;
    }
    const float l0 = bf16_lo(mn), l1 = bf16_hi(mn), h0 = bf16_lo(mx), h1 = bf16_hi(mx);
    lo = fminf(l0, l1);
    hi = fmaxf(h0, h1);
    if (l0 != l0 || l1 != l1 || h0 != h0 || h1 != h1) hi = INFINITY;  // a NaN: not a regular row
  }
  // f(bits): bit j set where the step's j-th column is at or above thresh;
  // two columns a compare, against the least bf16 at or above thresh
  template <class F>
  __device__ __forceinline__ void visit_marks(float thresh, F&& f) const {
    const uint32_t tb = __float_as_uint(thresh);
    const uint32_t up = (tb >> 16) + (((tb & 0xffffu) != 0u && (tb >> 31) == 0u) ? 1u : 0u);
    uint32_t th2 = up * 0x10001u;
    auto as2 = [](uint32_t& w) -> __nv_bfloat162& { return reinterpret_cast<__nv_bfloat162&>(w); };
#pragma unroll
    for (int c = 0; c < parts(); ++c) {
      uint32_t m = 0u;
      if (has(c)) {
        uint4 u = *reinterpret_cast<const uint4*>(mine(c));
        const uint32_t both = (__hge2_mask(as2(u.x), as2(th2)) & 0x00020001u) | (__hge2_mask(as2(u.y), as2(th2)) & 0x00080004u) |
                              (__hge2_mask(as2(u.z), as2(th2)) & 0x00200010u) | (__hge2_mask(as2(u.w), as2(th2)) & 0x00800040u);
        m = (both | (both >> 16)) & 0xffu;
      }
      f(m);
    }
  }
};

// -- block-wide reductions (every thread gets the result) -------------------

// Each takes arrays of its own: a barrier of the row's other parts lies
// between their last read here and the next row's write.

__device__ __forceinline__ void block_min_max(float& lo, float& hi, float* sh_lo, float* sh_hi) {
  for (int o = 16; o > 0; o >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
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

__device__ __forceinline__ void warp_argmax(float& z, int& i, float& l) {
  for (int o = 16; o > 0; o >>= 1) {
    const float z2 = __shfl_xor_sync(0xffffffffu, z, o);
    const int i2 = __shfl_xor_sync(0xffffffffu, i, o);
    const float l2 = __shfl_xor_sync(0xffffffffu, l, o);
    argmax_merge(z, i, l, z2, i2, l2);
  }
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// -- the kernel -------------------------------------------------------------------

// Built with -DSAMPLER_TIMING, the kernel leaves the clocks that block 0's
// first thread spent in each part of a row, summed over the block's rows,
// behind the probabilities (prob_out then has room for rows + kParts): the
// wait for the row's copies, min and max, the tree, pass B, the threshold,
// pass C's marks, its list, its scores, the row's end. A part ends where its
// warp gets there, so a part that follows a barrier holds the wait for the
// slowest warp of the part before.
constexpr int kParts = 9;
#ifdef SAMPLER_TIMING
#define TICK(n)                                          \
  do {                                                   \
    if (blockIdx.x == 0 && threadIdx.x == 0) {           \
      const long long now = clock64();                   \
      ticks[n] += now - tick0;                           \
      tick0 = now;                                       \
    }                                                    \
  } while (0)
#else
#define TICK(n)
#endif

template <typename T, class Src, bool NOISE>
__global__ void __launch_bounds__(kThreads, 1)
sample_kernel(const T* __restrict__ logits, const float* __restrict__ noise,
              const int* __restrict__ seed_ptr, int rows, int V, int k, float temp,
              const float* __restrict__ scale_ptr, int* __restrict__ idx_out, float* __restrict__ prob_out,
              int row_offset) {
  // [chunk ring, staged rows only][lists][E][pad][histogram]
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* after_chunks = smem_raw + (Src::kStaged ? kSlots * kChunkBytes : 0);
  constexpr int kList = Src::kList;
  constexpr int G = Src::kGroup;
  uint32_t* lists = reinterpret_cast<uint32_t*>(after_chunks);  // [kWarps][kList]
  float* E = reinterpret_cast<float*>(lists + kWarps * kList);   // [kBins + 1], sorted
  int* hist = reinterpret_cast<int*>(E + kBins + 4);              // [-1, kBins]: a spare word on each side
  __shared__ float mm_lo[kWarps], mm_hi[kWarps];              // min and max
  __shared__ float sc_s[kWarps];                               // logsumexp terms
  __shared__ int sc_n[kWarps];                                 // histogram suffix sums
  __shared__ float am_z[kWarps], am_l[kWarps];                 // argmax
  __shared__ int am_i[kWarps];
  __shared__ __align__(8) uint64_t full_bar[kBars];
  __shared__ int released;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
#ifdef SAMPLER_TIMING
  long long ticks[kParts] = {}, tick0 = clock64();
#endif
  Src src;
  if constexpr (Src::kStaged) {
    src.chunks = smem_raw;
    src.chunks_u32 = smem_u32(smem_raw);
    src.full_u32 = smem_u32(full_bar);
    src.logits = logits;
    src.released = &released;
    src.rows = rows;
    src.V = V;
    src.nc = (V * 2 + kChunkBytes - 1) / kChunkBytes;
    src.last_bytes = V * 2 - (src.nc - 1) * kChunkBytes;
    src.ahead_rows = kSlots / src.nc;
    src.ahead_part = kSlots % src.nc;
    src.r = src.slot0 = 0;
    if (tid == 0) {
      released = 0;
      for (int b = 0; b < kBars; ++b) mbar_init(src.full_u32 + 8 * b, src.nc);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (tid == 0)
      for (int q = 0; q < kSlots; ++q) src.start_copy(q / src.nc, q % src.nc, q);
  } else {
    src.scale = Src::kPair ? scale_ptr[0] : 1.0f;  // one 4-byte load a block
    src.V = V;
  }

  const float t = fmaxf(temp, 1e-10f);
  const uint32_t seed = NOISE ? 0u : (uint32_t)seed_ptr[0];
  uint32_t* wlist = lists + warp * kList;

  // A row's argmax ends behind the next row's first barrier, not one of its
  // own: a warp that is done with pass C goes straight on to the next row.
  int pend_row = -1;
  float pend_lse = 0.0f;
  auto finish_row = [&]() {
    if (warp != 0) return;
    float z = am_z[lane], l = am_l[lane];
    int i = am_i[lane];
    warp_argmax(z, i, l);
    if (lane == 0) {
      idx_out[pend_row] = i;
      prob_out[pend_row] = expf(l - pend_lse);
    }
  };

  for (int row = blockIdx.x; row < rows; row += gridDim.x) {
    src.begin_row(logits, rows, row);

    // -- pass A: min and max (a staged row's chunks are awaited here)
    float lo = FLT_MAX, hi = -FLT_MAX;
    src.await_row();
    TICK(0);
    src.min_max(lo, hi);
    block_min_max(lo, hi, mm_lo, mm_hi);
    if (pend_row >= 0) finish_row();  // the barrier in there has published the warps' best
    const float row_max = hi;
    TICK(1);

    // -- the tree: thread j walks to leaf j with the bisection's operations;
    // its interval's lower end is E[j] (E[0] = min, E[kBins] = +inf)
    {
      float a = lo, b = hi;
#pragma unroll
      for (int d = 0; d < kBisectIters; ++d) {
        const float mid = 0.5f * (a + b);
        if ((tid >> (kBisectIters - 1 - d)) & 1) a = mid; else b = mid;
      }
      E[tid] = a;
      if (tid == 0) E[kBins] = INFINITY;
      hist[tid] = 0;
    }
    // The guess f = x * inv - lo * inv is x's position among E's values, in
    // bins, but for roundings. With M = max(|lo|, |hi|), so M * inv >= 512:
    // E[j] carries at most 10 roundings of 2^-24 M each (5 * 2^-23 M inv);
    // inv, the constant and the fused multiply-add add at most
    // 3.5 * 2^-23 M inv. delta is 3.8 times their sum, so a guess at least
    // delta away from every integer (bin edge) needs no compare against E.
    // A row whose range is tiny beside its magnitude, or overflows, searches
    // E for every value.
    const float inv = (float)kBins / (hi - lo);
    const float delta = fmaxf(fabsf(lo), fabsf(hi)) * inv * (1.0f / 262144.0f);
    const bool regular = delta < 0.25f;  // false for inf and NaN
    __syncthreads();
    TICK(2);

    // -- pass B: logsumexp terms and the histogram over E's bins
    float s = 0.0f;
    const float kLog2e = 1.4426950408889634f;
    const float max_l2e = row_max * kLog2e;  // terms are 2^(x log2(e) - max_l2e)
    auto search = [&](float v) {  // the largest g with E[g] <= v, from the guess
      int g = min(max((int)((v - lo) * inv), 0), kBins - 1);
      while (g < kBins - 1 && v >= E[g + 1]) ++g;
      while (g > 0 && v < E[g]) --g;
      return g;
    };
    if (regular) {
      // f - 0.5 rounded to the nearest integer by the 2^23 trick (no
      // conversions) is the bin, unless f is within delta of an integer.
      // Every value is counted at its guess, in straight-line code, and
      // marked in a 64-bit mask (G bits a step, a step's last column lowest)
      // if it was too near an edge to trust; when the mask is full, the few
      // marked search E and move their count if the guess was wrong. (A value in
      // the lowest quarter bin is counted at -1, the row maximum may be at
      // kBins: the spare words. S[0] is never looked up.)
      const float c = -lo * inv - 0.5f;
      const float near_half = 0.5f - delta;
      const uint32_t hist0 = smem_u32(hist) - (0x4b000000u << 2);  // so that hist0 + 4 * bits(shifted) is the bin's word
      unsigned long long near = 0ull;
      int step0 = 0, steps = 0;  // the mask holds steps [step0, step0 + steps)
      auto settle = [&]() {
        while (near) {
          const int b = __ffsll((long long)near) - 1;
          near &= near - 1;
          const float v = src.entry_val(src.entry(step0 + b / G, G - 1 - b % G));
          const int guess = __float_as_int(__fmaf_rn(v, inv, c) + 8388608.0f) - 0x4b000000;
          const int g = search(v);
          if (g != guess) {
            atomicSub(&hist[guess], 1);
            atomicAdd(&hist[g], 1);
          }
        }
        step0 += steps;
        steps = 0;
      };
      src.visit([&](const float* x, bool valid) {
        uint32_t marks = 0u;
        if (valid) {
#pragma unroll
          for (int j = 0; j < G; ++j) {
            const float v = x[j];
            s += ex2_approx(__fmaf_rn(v, kLog2e, -max_l2e));
            const float f = __fmaf_rn(v, inv, c);
            const float shifted = f + 8388608.0f;
            const float d = f - (shifted - 8388608.0f);  // in [-0.5, 0.5]
            const float room = near_half - fabsf(d);     // negative: too near an edge
            marks = __funnelshift_l(__float_as_uint(room), marks, 1);  // (marks << 1) | sign
            asm volatile("red.shared.add.u32 [%0], 1;\n" ::"r"(hist0 + (__float_as_uint(shifted) << 2)) : "memory");
          }
        }
        near |= (unsigned long long)marks << (steps * G);
        if (++steps == 64 / G) settle();
      });
      if (steps) settle();
    } else {
      src.visit([&](const float* x, bool valid) {
        if (!valid) return;
#pragma unroll
        for (int j = 0; j < G; ++j) {
          const float v = x[j];
          s += ex2_approx(__fmaf_rn(v, kLog2e, -max_l2e));
          int g = 0;  // the largest g with E[g] <= v
#pragma unroll
          for (int step = kBins >> 1; step > 0; step >>= 1)
            if (E[g + step] <= v) g += step;
          atomicAdd(&hist[g], 1);
        }
      });
    }
    TICK(3);
    // sum s over the block; suffix-sum the bins in place: S[m] = count(l >= E[m])
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    __syncthreads();  // the histogram is complete
    int incl = hist[tid];
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_down_sync(0xffffffffu, incl, o);
      if (lane + o < 32) incl += y;
    }
    if (lane == 0) { sc_s[warp] = s; sc_n[warp] = incl; }
    __syncthreads();
    s = sc_s[lane];
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    const float lse = logf(s) + max_l2e * 0.6931471805599453f;
    hist[tid] = incl + warp_sum(lane > warp ? sc_n[lane] : 0);
    __syncthreads();
    // the ten rounds: node j of depth d has mid E[m], m = (2 j + 1) << (9 - d)
    int leaf = 0;
#pragma unroll
    for (int d = 0; d < kBisectIters; ++d) {
      const int m = (2 * leaf + 1) << (kBisectIters - 1 - d);
      leaf = 2 * leaf + (hist[m] >= k ? 1 : 0);
    }
    const float thresh = E[leaf];
    TICK(4);

    // -- pass C: filtered, temperature-scaled gumbel argmax. A thread marks
    // its columns at or above the threshold in a 64-bit mask, one bit a
    // column; when the mask is full (a staged row: once, at the row's end)
    // the warp writes the marked columns into its list, packed, and then
    // draws noise for 32 of them at a time, one a lane: no lane runs Philox
    // for a column that another lane of its warp needed.
    float best_z = -INFINITY, best_l = 0.0f;
    int best_i = INT32_MAX;
    auto score = [&](int i, float l) {
      float g;
      if (NOISE) {
        g = noise[(size_t)row * V + i];
      } else {
        const uint4 b = philox4x32_10((uint32_t)(i >> 2), seed, (uint32_t)(row_offset + row));
        const int w = i & 3;
        g = bits_to_gumbel(w == 0 ? b.x : w == 1 ? b.y : w == 2 ? b.z : b.w);
      }
      const float z = l / t + g;
      argmax_merge(best_z, best_i, best_l, z, i, l);
    };
    constexpr int kMaskSteps = 64 / G;
    unsigned long long mask = 0ull;
    int step0 = 0, steps = 0;  // the mask holds steps [step0, step0 + steps)
    auto flush = [&]() {
      TICK(5);
      const int cnt = __popcll(mask);
      int upto = cnt;  // inclusive prefix over the lanes
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, upto, o);
        if (lane >= o) upto += y;
      }
      const int total = __shfl_sync(0xffffffffu, upto, 31);
      if (total <= kList) {
        src.write_marked(mask, step0, wlist + (upto - cnt));
        mask = 0ull;
        if (Src::kStaged) src.release_row(); else __syncwarp();
        TICK(6);
        for (int h = lane; h < total; h += 32) {
          const uint32_t e = wlist[h];
          score(src.entry_col(e), src.entry_val(e));
        }
        __syncwarp();
      } else {
        // more than the list holds (a row of ties, k near V): every lane
        // scores its own columns
        while (mask) {
          const int b = __ffsll((long long)mask) - 1;
          mask &= mask - 1;
          const int i = src.entry_col(src.entry(step0 + b / G, b % G));
          score(i, src.at(i));
        }
        if (Src::kStaged) src.release_row();
      }
      step0 += steps;
      steps = 0;
    };
    src.visit_marks(thresh, [&](uint32_t m) {
      mask |= (unsigned long long)m << (steps * G);
      if (++steps == kMaskSteps) flush();
    });
    if (steps) flush();
    TICK(7);
    // columns below the threshold are never scored (the TPU kernel gives them
    // -1e30, which cannot win: the row maximum always passes)
    warp_argmax(best_z, best_i, best_l);
    if (lane == 0) { am_z[warp] = best_z; am_i[warp] = best_i; am_l[warp] = best_l; }
    pend_row = row;
    pend_lse = lse;
    src.end_row();
    TICK(8);
  }
  if (pend_row >= 0) {
    __syncthreads();
    finish_row();
  }
#ifdef SAMPLER_TIMING
  if (blockIdx.x == 0 && tid == 0)
    for (int n = 0; n < kParts; ++n) prob_out[rows + n] = (float)ticks[n];
#endif
}

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
  }
  return count;
}

template <typename T, class Src, bool NOISE>
cudaError_t launch(const void* logits, const void* noise, const void* seed, void* idx, void* prob,
                   int rows, int V, int k, float temp, const void* scale, int row_offset, cudaStream_t stream) {
  auto kern = sample_kernel<T, Src, NOISE>;
  const size_t smem = (Src::kStaged ? (size_t)kSlots * kChunkBytes : 0) + kWarps * Src::kList * sizeof(uint32_t) +
                      (kBins + 4) * sizeof(float) + (kBins + 4) * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int grid = rows < sm_count() ? rows : sm_count();
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(logits), static_cast<const float*>(noise), static_cast<const int*>(seed),
      rows, V, k, temp, static_cast<const float*>(scale), static_cast<int*>(idx), static_cast<float*>(prob),
      row_offset);
  return cudaGetLastError();
}

template <typename T, class Src, typename... Args>
cudaError_t dispatch_noise(bool has_noise, Args... args) {
  return has_noise ? launch<T, Src, true>(args...) : launch<T, Src, false>(args...);
}

template <typename T, int G, typename... Args>
cudaError_t dispatch_global(bool pair, int V, bool aligned, bool has_noise, Args... args) {
  if (aligned && V % G == 0)
    return pair ? dispatch_noise<T, GlobalRow<T, true, G>>(has_noise, args...)
                : dispatch_noise<T, GlobalRow<T, false, G>>(has_noise, args...);
  return pair ? dispatch_noise<T, GlobalRow<T, true, 1>>(has_noise, args...)
              : dispatch_noise<T, GlobalRow<T, false, 1>>(has_noise, args...);
}

// -- the exact sampler's noise: K1's stream, written out ------------------------
//
// out[r, c] = bits_to_gumbel(word c % 4 of philox4x32_10(c / 4, seed,
// row_offset + r)), rounded once to T: at every (row, column) the noise that
// K1 draws inside its body. It replaces no TPU kernel (the JAX package's
// exact sampler draws `jax.random.gumbel` in XLA); `sampler="xla"` reads it
// so that its noise lives on the device, keyed on the global row, and a
// traced program can hold it. One thread a Philox call, four columns, stored
// as one 16-byte (f32) or 8-byte (bf16) write where V % 4 == 0. What bounds
// it on the H100: not the bytes written (0.32 ms for (8192, 65536) bf16 at
// 3.35 TB/s) but the instructions, some 20 a value for Philox and two IEEE
// logf (this file is built without fast math, so the values are the plain
// version's and K1's bit for bit).
template <typename T, bool VEC>
__global__ void __launch_bounds__(256)
philox_gumbel_kernel(const int* __restrict__ seed_ptr, T* __restrict__ out, int rows, int V, int row_offset) {
  const int groups = (V + 3) >> 2;
  const int gi = blockIdx.x * blockDim.x + threadIdx.x;
  if (gi >= groups) return;
  const uint32_t seed = (uint32_t)seed_ptr[0];
  for (int row = blockIdx.y; row < rows; row += gridDim.y) {
    const uint4 b = philox4x32_10((uint32_t)gi, seed, (uint32_t)(row_offset + row));
    const float g0 = bits_to_gumbel(b.x), g1 = bits_to_gumbel(b.y), g2 = bits_to_gumbel(b.z), g3 = bits_to_gumbel(b.w);
    T* dst = out + (size_t)row * V + 4 * (size_t)gi;
    if constexpr (VEC && sizeof(T) == 4) {
      *reinterpret_cast<float4*>(dst) = make_float4(g0, g1, g2, g3);
    } else if constexpr (VEC) {
      const __nv_bfloat162 lo = __floats2bfloat162_rn(g0, g1), hi = __floats2bfloat162_rn(g2, g3);
      uint2 w;
      w.x = *reinterpret_cast<const uint32_t*>(&lo);
      w.y = *reinterpret_cast<const uint32_t*>(&hi);
      *reinterpret_cast<uint2*>(dst) = w;
    } else {
      const float g[4] = {g0, g1, g2, g3};
      const int c0 = 4 * gi;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (c0 + j < V) {
          if constexpr (sizeof(T) == 4) dst[j] = g[j]; else dst[j] = __float2bfloat16_rn(g[j]);
        }
      }
    }
  }
}

template <typename T>
cudaError_t launch_gumbel(const void* seed, void* out, int rows, int V, int row_offset, cudaStream_t stream) {
  const int groups = (V + 3) / 4;
  const dim3 block(256);
  const dim3 grid((groups + 255) / 256, rows < 65535 ? rows : 65535);
  const bool vec = V % 4 == 0 && reinterpret_cast<uintptr_t>(out) % (4 * sizeof(T)) == 0;
  if (vec)
    philox_gumbel_kernel<T, true><<<grid, block, 0, stream>>>(static_cast<const int*>(seed), static_cast<T*>(out), rows, V, row_offset);
  else
    philox_gumbel_kernel<T, false><<<grid, block, 0, stream>>>(static_cast<const int*>(seed), static_cast<T*>(out), rows, V, row_offset);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// seed: one int32 in device memory; out: (rows, V), dtype 0 = f32, 1 = bf16.
// Returns cudaGetLastError().
int muse_philox_gumbel_launch(const void* seed, void* out, int rows, int V, int row_offset, int dtype, void* stream) {
  if (rows <= 0 || V <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? launch_gumbel<__nv_bfloat16>(seed, out, rows, V, row_offset, s)
                    : launch_gumbel<float>(seed, out, rows, V, row_offset, s);
}

// logits: (rows, V), or (2 * rows, V) cond rows then null rows when
// cfg_pair; dtype 0 = f32, 1 = bf16. noise: (rows, V) f32 or null. seed: one
// int32 in device memory (read by the kernel, so the host never syncs);
// scale: with cfg_pair, one f32 in device memory, else unread (may be null).
// row_offset: the Philox key's row is row_offset + row (0 for a whole batch).
// Outputs idx int32 (rows,), prob f32 (rows,). Returns cudaGetLastError().
int muse_sample_launch(const void* logits, const void* noise, const void* seed, void* idx,
                       void* prob, int rows, int V, int k, float temp, const void* scale, int dtype,
                       int cfg_pair, int row_offset, void* stream) {
  if (rows <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool has_noise = noise != nullptr;
  const bool aligned = reinterpret_cast<uintptr_t>(logits) % 16 == 0;
  if (dtype == 1) {
    if (!cfg_pair && aligned && V == kMaxStagedV)
      return dispatch_noise<__nv_bfloat16, StagedRow<true>>(has_noise, logits, noise, seed, idx, prob, rows, V, k, temp, scale, row_offset, s);
    if (!cfg_pair && aligned && V % 8 == 0 && V < kMaxStagedV)
      return dispatch_noise<__nv_bfloat16, StagedRow<false>>(has_noise, logits, noise, seed, idx, prob, rows, V, k, temp, scale, row_offset, s);
    return dispatch_global<__nv_bfloat16, 8>(cfg_pair != 0, V, aligned, has_noise, logits, noise, seed, idx, prob, rows, V, k, temp, scale, row_offset, s);
  }
  return dispatch_global<float, 4>(cfg_pair != 0, V, aligned, has_noise, logits, noise, seed, idx, prob, rows, V, k, temp, scale, row_offset, s);
}

const char* muse_sample_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
