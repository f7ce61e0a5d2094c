// Fused arc-cosine Gram for Hopper (sm_90a): float32 in and out, the
// contraction on the tensor cores in 3xTF32.
//
// Replaces: gaussian_processes_tpu/ops/gram_pallas.py::acos_gram_pallas (the
// Pallas TPU kernel with body _gram_kernel, epilogue _acos_tile and the
// arccos polynomial _acos_poly).
//
// Computes, for each item of a batch of u1 (m, k) and s2 (n, k), both
// row-major (an "NT" product), with the item's own q11, q22 and sigma0:
//   q12[i, j] = sum_t u1[i, t] * s2[j, t]
//   X1 = sqrt(q11 + s0^2), X2 = sqrt(q22 + s0^2), s0 = *sigma0
//   c  = clip((q12 + s0^2) / (X1 X2 + 1e-7), -1, 1)
//   K  = X1 X2 * (sqrt(1 - c^2) + (pi - acos c) c) / pi
// and the gradient of K with respect to u1, s2, q11, q22 and sigma0 (the
// TPU kernel had none: JAX differentiates its XLA path).
//
// The forward: three kernels, launched in order by tf32_split_f32 and
// acos_gram_f32:
//
// 1. tf32_split_kernel (tf32_split_vec_kernel where k is a multiple of 4),
//    once per operand, over all items' rows at once: big = cvt.rna.tf32(a) and
//    small = a - big (exact in float32), into one (2, rows, kp) buffer whose
//    row stride kp = k rounded up to 4 floats (TMA wants 16-byte strides);
//    the padding columns are zero.  NaN stays NaN (small = NaN - NaN), and
//    inf becomes a NaN small part, so a poisoned operand poisons K.
// 2. acos_gram_tf32x3_kernel: one 128 x 128 output tile of one item per
//    block, over one planned range of k; grid z runs over items x splits.  Warpgroup 2 is the producer: one thread issues
//    cp.async.bulk.tensor loads of the big and small 128 x 32 tiles of both
//    operands (128 B rows, 128-byte swizzle) into a ring of 3 stages of
//    64 KB, each with a full and an empty mbarrier.  Warpgroups 0 and 1 are
//    the consumers, 64 rows each: for every 8 floats of k they issue
//    wgmma.m64n128k8.f32.tf32.tf32 three times into one float32 accumulator,
//    small*big, big*small, then big*big (small*small, 2^-22 relative, is
//    dropped).  Both operands are K-major in shared memory, as TF32 wgmma
//    requires, so nothing is transposed.  With one range of k the epilogue
//    runs in registers; with several, each block writes its raw partial q12
//    to a workspace (batch, splits, m, n).
// 3. acos_gram_reduce_kernel (split k only): sums the partials in split
//    order and applies the same epilogue.
// Where a gradient is wanted, the epilogue (or the reduce kernel) also
// writes the raw q12 it used, so that the backward differentiates at the
// forward's own q12; K's arithmetic does not change.
//
// The backward, launched by acos_gram_bwd_f32, tf32_split_t_f32 and
// nt_product_f32 (ops/gram_cuda.py runs them in that order):
// 4. acos_gram_bwd_kernel, then acos_gram_bwd_sums_kernel and
//    acos_gram_bwd_sigma_kernel: dq12 = dL/dq12
//    elementwise from g = dL/dK and the saved q12 (written with its TF32
//    planes), and dL/dq11, dL/dq22, dL/dsigma0 by per-tile partial sums
//    added in a fixed order (see "The Gram's backward epilogue" below).
// 5. tf32_split_t_kernel: the split pass for an operand whose contraction
//    axis is its rows (S2^T, U1^T, dq12^T): TF32 wgmma takes only operands
//    that are K-major in shared memory, so the transpose happens here,
//    through a shared-memory tile, and not in the main loop.
// 6. nt_product_tf32x3_kernel (+ nt_product_reduce_kernel with split k):
//    the same main loop with no epilogue, for dU1 = dq12 S2 (m, k) and
//    dS2 = dq12^T U1 (n, k).  Both cost what the forward's product costs
//    (2 m n k flops in 3xTF32 each), so the backward is about twice the
//    forward; its elementwise pass and the transposing splits are bound by
//    bytes.
//
// Accumulation interval: the tensor cores' float32 accumulation does not
// round like fmaf, and at K_tilde's diagonal (c -> 1) every term has the
// same sign, so a per-addition bias adds up over the 3 k/8 additions.  With
// one accumulator for the whole range the diagonal missed the 1e-5 gate on
// the card (1.4e-5 relative at k 6400 and 11664).  So the consumers start a
// fresh accumulator every PROMOTE_EVERY = 4 k-blocks (128 floats of k, 48
// wgmmas) and add it into a float32 register sum with fadd: 1.2e-6 and
// 1.0e-6, at no time cost that the card could measure (every 16 blocks gave
// 4.2e-6, every block 7.0e-7; H100 80GB HBM3 at 700 W, PERF.md).
//
// What bounds it, and what the design does about it: 3xTF32 makes the
// contraction three TF32 tensor-core products, 6 m n k flops against the
// card's 495 TFLOP/s of TF32, so tensor-core issue bounds the fit's shapes:
// the main kernel ran at 300-350 TF32 TFLOP/s there (61-70% of peak), and
// the two split passes took 0.11-0.25 ms beside it (H100 80GB HBM3 at
// 700 W, PERF.md).  The split pass lets TMA load every operand tile as it
// is, with no conversion in the main loop; the 3-stage ring keeps two
// k-blocks of loads in flight while the consumers compute; the promotion
// interval buys the accuracy for 64 fadds per thread every 4 k-blocks.  K_tilde's 289 tiles and K's
// 425 fill 2.2 and 3.2 waves of 132 one-block SMs and the prediction's K*
// (30 x 2100) only 17 blocks, so the planner in ops/gram_cuda.py
// (plan_gram) splits k until the launched waves are at least 85% full
// (2, 2 and 7 splits).  At K* the split pass's bytes (read k (m + n)
// floats, write twice that) bound it instead: 0.10 of its 0.18 ms.
//
// The epilogue runs in registers with a real acosf (the Pallas kernel
// carried a polynomial only because Mosaic had no acos); the clip is written
// with comparisons so that a NaN stays NaN.  The operands' tensor maps are
// three-dimensional (k, rows, item), so a tile that runs past row m or n of
// its item is zero-filled by TMA instead of reading the next item: nothing
// is padded in m or n, and stores are masked to (m, n).  The output is
// written in place through its pointer, so a contiguous row block of a
// larger matrix (the large-ntilde path's K[r0:r0+nb]) is a valid target.

#include <cuda.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;            // rows of u1 per block (two warpgroups)
constexpr int BN = 128;            // rows of s2 per block (the wgmma's n)
constexpr int BK = 32;             // floats of k per stage: one 128-B row
constexpr int STAGES = 3;
constexpr int PROMOTE_EVERY = 4;   // k-blocks per accumulator (see above)
constexpr int CONSUMERS = 2;       // consumer warpgroups
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr int TILE_BYTES = BM * BK * 4;        // 16 KB
constexpr int STAGE_BYTES = 4 * TILE_BYTES;    // A big, A small, B big, B small
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024 + 2 * STAGES * 8;
constexpr float JITTER = 1e-7f;

static_assert(BM == BN, "one tensor-map box serves both operands");
static_assert(BM == 64 * CONSUMERS, "each consumer warpgroup owns 64 rows");

// Error codes of this file's own (cudaError_t values are >= 0).
constexpr int ERR_NO_ENCODER = -1;    // cuTensorMapEncodeTiled not found
constexpr int ERR_TENSOR_MAP = -2;    // cuTensorMapEncodeTiled refused
constexpr int ERR_PLAN = -3;          // splits outside [1, k-blocks]

// ---------------------------------------------------------------------------
// Device helpers: mbarriers, TMA, wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n\t.reg .b64 state;\n\t"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n\t}" ::"r"(bar)
      : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Wait until the phase of parity `parity` has completed.  A wait that has
// not completed after 4 s traps (the launch then fails with an error)
// instead of hanging the card: no stage of this kernel takes a millisecond.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  const uint64_t t0 = global_ns();
  while (!mbar_try(bar, parity))
    if (global_ns() - t0 > 4000000000ull) __trap();
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int row,
                                         int item) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row),
      "r"(item)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile with 128-B rows in the
// 128-byte swizzle: start address >> 4, leading offset unused (1), stride
// between 8-row groups 1024 B, layout type 1 (SWIZZLE_128B).  The tile base
// is 1024-B aligned, so a step of 32 B along k is an add of 2.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma boundary.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128 per warpgroup, float32) = A (64 x 8, TF32) * B (8 x 128, TF32)
// + (scale_d ? d : 0); A and B from shared-memory descriptors.
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "setp.ne.b32 p, %66, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// K entry from q12 and the two norms (sigma0^2 folded in).
__device__ __forceinline__ float acos_entry(float q12, float x1, float x2,
                                            float s02) {
  const float X = x1 * x2;
  float c = (q12 + s02) / (X + JITTER);
  // written with comparisons so that a NaN stays NaN (fminf/fmaxf would
  // replace it by a bound)
  c = c < -1.f ? -1.f : (c > 1.f ? 1.f : c);
  const float s = sqrtf(fmaxf(1.f - c * c, 0.f));
  return X * ((s + (CUDART_PI_F - acosf(c)) * c) / CUDART_PI_F);
}

// ---------------------------------------------------------------------------
// Kernels
// ---------------------------------------------------------------------------

// a (rows, k) -> big, small (rows, kp), zero in columns [k, kp).
__global__ void tf32_split_kernel(const float* __restrict__ a,
                                  float* __restrict__ big,
                                  float* __restrict__ small, int rows, int k,
                                  int kp) {
  const size_t total = static_cast<size_t>(rows) * kp;
  const size_t step = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < total; i += step) {
    const size_t r = i / kp;
    const int c = static_cast<int>(i - r * kp);
    const float v = c < k ? a[r * k + c] : 0.f;
    const float b = tf32_rna(v);
    big[i] = b;
    small[i] = v - b;
  }
}

// The same for k == kp, four floats per thread and step.
__global__ void tf32_split_vec_kernel(const float4* __restrict__ a,
                                      float4* __restrict__ big,
                                      float4* __restrict__ small,
                                      size_t total4) {
  const size_t step = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < total4; i += step) {
    const float4 v = a[i];
    const float4 b = make_float4(tf32_rna(v.x), tf32_rna(v.y), tf32_rna(v.z),
                                 tf32_rna(v.w));
    big[i] = b;
    small[i] = make_float4(v.x - b.x, v.y - b.y, v.z - b.z, v.w - b.w);
  }
}

// The 3xTF32 main loop of one block over k-blocks [kb0, kb1) of one item:
// the producer warpgroup's one thread keeps the ring full, the two consumer
// warpgroups run the wgmmas (see the top of the file).  Returns false in the
// producer warpgroup, which has nothing left to do; in a consumer thread
// `sum` then holds its part of the block's 128 x 128 tile of A B^T, in the
// accumulator layout of m64nNk8 (see store_tile).
__device__ __forceinline__ bool tf32x3_mainloop(
    const CUtensorMap* a_big, const CUtensorMap* a_small,
    const CUtensorMap* b_big, const CUtensorMap* b_small, int item, int m0,
    int n0, int kb0, int kb1, float (&sum)[64]) {
  extern __shared__ uint8_t smem_raw[];
  // 128-byte-swizzled tiles want a 1024-B aligned base
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + STAGES * STAGE_BYTES;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (STAGES + s); };
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // ---- producer: one thread keeps the ring full ----
    if (threadIdx.x == CONSUMERS * 128) {
      int stage = 0;
      uint32_t phase = 0;
      for (int kb = kb0; kb < kb1; ++kb) {
        mbar_wait(empty(stage), phase ^ 1u);
        const uint32_t s = base + stage * STAGE_BYTES;
        mbar_expect_tx(full(stage), STAGE_BYTES);
        tma_load(s, a_big, full(stage), kb * BK, m0, item);
        tma_load(s + TILE_BYTES, a_small, full(stage), kb * BK, m0, item);
        tma_load(s + 2 * TILE_BYTES, b_big, full(stage), kb * BK, n0, item);
        tma_load(s + 3 * TILE_BYTES, b_small, full(stage), kb * BK, n0,
                 item);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1u;
        }
      }
    }
    return false;
  }

  // ---- consumers: 64 rows x 128 columns each ----
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    acc[i] = 0.f;
    sum[i] = 0.f;
  }
  const uint32_t a_rows = wg * 64 * (BK * 4);  // this warpgroup's 64 rows
  int stage = 0;
  uint32_t phase = 0;
  int held = 0;  // k-blocks in acc since the last promotion
  for (int kb = kb0; kb < kb1; ++kb) {
    mbar_wait(full(stage), phase);
    const uint32_t s = base + stage * STAGE_BYTES;
    const uint64_t da_big = smem_desc(s + a_rows);
    const uint64_t da_small = smem_desc(s + TILE_BYTES + a_rows);
    const uint64_t db_big = smem_desc(s + 2 * TILE_BYTES);
    const uint64_t db_small = smem_desc(s + 3 * TILE_BYTES);
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      const uint64_t step = static_cast<uint64_t>((kk * 8 * 4) >> 4);
      wgmma_tf32(acc, da_small + step, db_big + step,
                 (kk > 0 || held > 0) ? 1 : 0);
      wgmma_tf32(acc, da_big + step, db_small + step, 1);
      wgmma_tf32(acc, da_big + step, db_big + step, 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_acc(acc);
    if (threadIdx.x % 128 == 0) mbar_arrive(empty(stage));
    if (++held == PROMOTE_EVERY || kb + 1 == kb1) {
#pragma unroll
      for (int i = 0; i < 64; ++i) sum[i] += acc[i];
      held = 0;
    }
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1u;
    }
  }
  return true;
}

// Accumulator layout of m64nNk8: register 4 j + 2 i + c of thread t holds
// row 16 warp + t/4 % 8 + 8 i, column 8 j + 2 (t % 4) + c.  The first row
// and column a consumer thread holds in the block at (m0, n0):
__device__ __forceinline__ int tile_row0(int m0) {
  const int t = threadIdx.x % 128;
  return m0 + (threadIdx.x / 128) * 64 + (t / 32) * 16 + (t % 32) / 4;
}
__device__ __forceinline__ int tile_col0(int n0) {
  return n0 + 2 * (threadIdx.x % 4);
}

// Writes a consumer thread's part of a tile into the row-major (m, n)
// matrix dst, masked to (m, n).
__device__ __forceinline__ void store_tile(const float (&sum)[64], float* dst,
                                           int m, int n, int row0, int col0) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + 8 * i;
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = col0 + 8 * j + c;
        if (col < n) dst[static_cast<size_t>(r) * n + col] =
            sum[4 * j + 2 * i + c];
      }
  }
}

// The block's range of k-blocks: split `split` of `splits`.
__device__ __forceinline__ int split_lo(int split, int kblocks, int splits) {
  return static_cast<int>(static_cast<long long>(split) * kblocks / splits);
}

// Grid (tiles of n, tiles of m, batch x splits).  With one split, out is K
// (batch, m, n), and q12 (batch, m, n) the raw cross form where it is not
// null; with several, out is the workspace (batch, splits, m, n) of raw
// partial q12 (q12 then comes from the reduce kernel).  q11 is (batch, m),
// q22 (batch, n), sigma0 (batch,).
__global__ void __launch_bounds__(THREADS, 1)
    acos_gram_tf32x3_kernel(const __grid_constant__ CUtensorMap a_big,
                            const __grid_constant__ CUtensorMap a_small,
                            const __grid_constant__ CUtensorMap b_big,
                            const __grid_constant__ CUtensorMap b_small,
                            const float* __restrict__ q11,
                            const float* __restrict__ q22,
                            const float* __restrict__ sigma0,
                            float* __restrict__ out, float* __restrict__ q12,
                            int m, int n, int kblocks, int splits) {
  const int item = blockIdx.z / splits;
  const int split = blockIdx.z - item * splits;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  float sum[64];
  if (!tf32x3_mainloop(&a_big, &a_small, &b_big, &b_small, item, m0, n0,
                       split_lo(split, kblocks, splits),
                       split_lo(split + 1, kblocks, splits), sum))
    return;

  const int row0 = tile_row0(m0);
  const int col0 = tile_col0(n0);
  const size_t mn = static_cast<size_t>(m) * n;
  if (splits > 1) {
    store_tile(sum, out + (static_cast<size_t>(item) * splits + split) * mn,
               m, n, row0, col0);
    return;
  }
  if (q12 != nullptr) store_tile(sum, q12 + item * mn, m, n, row0, col0);
  q11 += static_cast<size_t>(item) * m;
  q22 += static_cast<size_t>(item) * n;
  out += item * mn;
  const float s0 = sigma0[item];
  const float s02 = s0 * s0;
  float x1[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + 8 * i;
    x1[i] = r < m ? sqrtf(q11[r] + s02) : 1.f;
  }
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int col = col0 + 8 * j + c;
      if (col >= n) continue;
      const float x2 = sqrtf(q22[col] + s02);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = row0 + 8 * i;
        if (r < m)
          out[static_cast<size_t>(r) * n + col] =
              acos_entry(sum[4 * j + 2 * i + c], x1[i], x2, s02);
      }
    }
}

// K[b, i, j] from the partial sums ws[b, 0..splits)[i, j], added in split
// order (and that sum into q12 where it is not null).
__global__ void acos_gram_reduce_kernel(const float* __restrict__ ws,
                                        int splits,
                                        const float* __restrict__ q11,
                                        const float* __restrict__ q22,
                                        const float* __restrict__ sigma0,
                                        float* __restrict__ out,
                                        float* __restrict__ q12, int m,
                                        int n, int batch) {
  const size_t mn = static_cast<size_t>(m) * n;
  const size_t total = mn * batch;
  const size_t step = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < total; i += step) {
    const size_t b = i / mn;
    const size_t e = i - b * mn;
    const float* part = ws + b * splits * mn + e;
    float q = part[0];
    for (int s = 1; s < splits; ++s) q += part[s * mn];
    if (q12 != nullptr) q12[i] = q;
    const size_t r = e / n;
    const size_t c = e - r * n;
    const float s0 = sigma0[b];
    const float s02 = s0 * s0;
    out[i] = acos_entry(q, sqrtf(q11[b * m + r] + s02),
                        sqrtf(q22[b * n + c] + s02), s02);
  }
}

// The same main loop with no epilogue: out (batch, m, n) = A B^T per item,
// or, with several splits, the workspace (batch, splits, m, n) of partial
// sums that nt_product_reduce_kernel adds in split order.
__global__ void __launch_bounds__(THREADS, 1)
    nt_product_tf32x3_kernel(const __grid_constant__ CUtensorMap a_big,
                             const __grid_constant__ CUtensorMap a_small,
                             const __grid_constant__ CUtensorMap b_big,
                             const __grid_constant__ CUtensorMap b_small,
                             float* __restrict__ out, int m, int n,
                             int kblocks, int splits) {
  const int item = blockIdx.z / splits;
  const int split = blockIdx.z - item * splits;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  float sum[64];
  if (!tf32x3_mainloop(&a_big, &a_small, &b_big, &b_small, item, m0, n0,
                       split_lo(split, kblocks, splits),
                       split_lo(split + 1, kblocks, splits), sum))
    return;
  const size_t mn = static_cast<size_t>(m) * n;
  store_tile(sum, out + (static_cast<size_t>(item) * splits + split) * mn, m,
             n, tile_row0(m0), tile_col0(n0));
}

__global__ void nt_product_reduce_kernel(const float* __restrict__ ws,
                                         int splits, float* __restrict__ out,
                                         size_t mn, int batch) {
  const size_t total = mn * batch;
  const size_t step = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < total; i += step) {
    const size_t b = i / mn;
    const float* part = ws + b * splits * mn + (i - b * mn);
    float q = part[0];
    for (int s = 1; s < splits; ++s) q += part[s * mn];
    out[i] = q;
  }
}

// a (batch, rows, cols) -> big, small (batch, cols, rowsp), transposed:
// big[b, c, r] = tf32(a[b, r, c]) and small = a - big, zero in rows
// [rows, rowsp).  A 32 x 32 tile goes through shared memory (one padded
// column against bank conflicts), so both the reads along c and the
// writes along r are coalesced.  Block (32, 8), grid (row tiles of rowsp,
// column tiles, batch).
__global__ void tf32_split_t_kernel(const float* __restrict__ a,
                                    float* __restrict__ big,
                                    float* __restrict__ small, int rows,
                                    int cols, int rowsp) {
  __shared__ float tile[32][33];
  const int r0 = blockIdx.x * 32;
  const int c0 = blockIdx.y * 32;
  const size_t b = blockIdx.z;
  const float* ab = a + b * rows * cols;
  for (int j = threadIdx.y; j < 32; j += 8) {
    const int r = r0 + j;
    const int c = c0 + threadIdx.x;
    tile[j][threadIdx.x] =
        r < rows && c < cols ? ab[static_cast<size_t>(r) * cols + c] : 0.f;
  }
  __syncthreads();
  const size_t plane = b * cols * rowsp;
  for (int j = threadIdx.y; j < 32; j += 8) {
    const int c = c0 + j;
    const int r = r0 + threadIdx.x;
    if (c < cols && r < rowsp) {
      const float v = tile[threadIdx.x][j];
      const float hi = tf32_rna(v);
      const size_t o = plane + static_cast<size_t>(c) * rowsp + r;
      big[o] = hi;
      small[o] = v - hi;
    }
  }
}

// ---------------------------------------------------------------------------
// The Gram's backward epilogue
// ---------------------------------------------------------------------------
//
// From g = dL/dK and the forward's own q12, per element (the formulas of the
// plain backward, gram_cuda.acos_gram_bwd_torch, rounded as it rounds them:
// the products, sums and quotients that decide the clip are written with
// the _rn intrinsics so that the compiler contracts none of them):
//   X1 X2 = P, den = P + 1e-7, ratio = (q12 + s0^2) / den, c = clip(ratio)
//   dclip = 1 inside, 1/2 exactly on a bound, 0 beyond (NaN: 0, and the
//   NaN of c passes on through the product)
//   g_ratio = g P (pi - acos c) / pi dclip,  dq12 = g_ratio / den
//   g_P = g J(c) - g_ratio ratio / den
// and the row and column sums dq11[i] = sum_j g_P X2_j / (2 X1_i), dq22[j] =
// sum_i g_P X1_i / (2 X2_j), dsigma0 = 2 s0 (sum dq11 + sum dq22 + sum
// dq12).  Every sum runs in a fixed order (per-tile partials, then one
// thread per entry of dq11 and dq22 adds them in tile order, then one block
// per item adds those for dsigma0; no floating-point atomics), so two runs
// give the same bits.  dq12 also goes out as the two TF32 planes of the
// product dU1 = dq12 S2 (A operand, row stride np), which saves the split
// pass a read of dq12.
//
// What bounds it: bytes (read g and q12, write dq12 and its planes; ~40
// operations an element against ~20 bytes), so each thread streams its
// elements once with coalesced loads.

constexpr int BWD_TM = 32;    // rows of a backward tile: 8 warps x 4 rows
constexpr int BWD_TN = 128;   // columns: 32 lanes x 4
constexpr int BWD_THREADS = 256;

// Grid (tiles of n, tiles of m, batch).  row_part (batch, tiles_n, m),
// col_part (batch, tiles_m, n) and num_part (batch, tiles_m x tiles_n)
// take the tile's sums of g_P X2 along its row, g_P X1 along its column and
// dq12.
__global__ void __launch_bounds__(BWD_THREADS)
    acos_gram_bwd_kernel(const float* __restrict__ g,
                         const float* __restrict__ q12,
                         const float* __restrict__ q11,
                         const float* __restrict__ q22,
                         const float* __restrict__ sigma0,
                         float* __restrict__ dq12, float* __restrict__ big,
                         float* __restrict__ small, int np,
                         float* __restrict__ row_part,
                         float* __restrict__ col_part,
                         float* __restrict__ num_part, int m, int n) {
  __shared__ float col_sh[BWD_THREADS / 32][BWD_TN];
  __shared__ float num_sh[BWD_THREADS / 32];
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r_base = blockIdx.y * BWD_TM + warp * 4;
  const int c_base = blockIdx.x * BWD_TN + lane;
  const size_t mn = static_cast<size_t>(m) * n;
  const float s0 = sigma0[b];
  const float s02 = __fmul_rn(s0, s0);
  float x2[4], col_acc[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int c = c_base + 32 * q;
    x2[q] = c < n ? __fsqrt_rn(__fadd_rn(q22[static_cast<size_t>(b) * n + c],
                                         s02))
                  : 0.f;
    col_acc[q] = 0.f;
  }
  float num_acc = 0.f;
#pragma unroll
  for (int rr = 0; rr < 4; ++rr) {
    const int r = r_base + rr;
    if (r >= m) continue;  // the same for the whole warp
    const float x1 =
        __fsqrt_rn(__fadd_rn(q11[static_cast<size_t>(b) * m + r], s02));
    const size_t row = b * mn + static_cast<size_t>(r) * n;
    const size_t prow = (static_cast<size_t>(b) * m + r) * np;
    float row_acc = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = c_base + 32 * q;
      if (c >= n) {
        if (c < np) big[prow + c] = small[prow + c] = 0.f;
        continue;
      }
      const float gv = g[row + c];
      const float P = __fmul_rn(x1, x2[q]);
      const float den = __fadd_rn(P, JITTER);
      const float ratio = __fdiv_rn(__fadd_rn(q12[row + c], s02), den);
      const float a = fabsf(ratio);
      const float dclip = a < 1.f ? 1.f : (a == 1.f ? 0.5f : 0.f);
      const float cc = ratio < -1.f ? -1.f : (ratio > 1.f ? 1.f : ratio);
      const float s = __fsqrt_rn(fmaxf(__fsub_rn(1.f, __fmul_rn(cc, cc)),
                                       0.f));
      const float pma = __fsub_rn(CUDART_PI_F, acosf(cc));
      const float J = __fdiv_rn(__fadd_rn(s, __fmul_rn(pma, cc)),
                                CUDART_PI_F);
      const float g_ratio = __fmul_rn(
          __fmul_rn(__fmul_rn(gv, P), __fdiv_rn(pma, CUDART_PI_F)), dclip);
      const float d = __fdiv_rn(g_ratio, den);
      const float gP = __fsub_rn(__fmul_rn(gv, J),
                                 __fdiv_rn(__fmul_rn(g_ratio, ratio), den));
      dq12[row + c] = d;
      const float hi = tf32_rna(d);
      big[prow + c] = hi;
      small[prow + c] = d - hi;
      row_acc += gP * x2[q];
      col_acc[q] += gP * x1;
      num_acc += d;
    }
#pragma unroll
    for (int off = 16; off > 0; off /= 2)
      row_acc += __shfl_xor_sync(0xffffffffu, row_acc, off);
    if (lane == 0)
      row_part[(static_cast<size_t>(b) * gridDim.x + blockIdx.x) * m + r] =
          row_acc;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) col_sh[warp][lane + 32 * q] = col_acc[q];
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    num_acc += __shfl_xor_sync(0xffffffffu, num_acc, off);
  if (lane == 0) num_sh[warp] = num_acc;
  __syncthreads();
  if (threadIdx.x < BWD_TN) {
    const int c = blockIdx.x * BWD_TN + threadIdx.x;
    float acc = col_sh[0][threadIdx.x];
    for (int w = 1; w < BWD_THREADS / 32; ++w) acc += col_sh[w][threadIdx.x];
    if (c < n)
      col_part[(static_cast<size_t>(b) * gridDim.y + blockIdx.y) * n + c] =
          acc;
  }
  if (threadIdx.x == 0) {
    float acc = num_sh[0];
    for (int w = 1; w < BWD_THREADS / 32; ++w) acc += num_sh[w];
    num_part[(static_cast<size_t>(b) * gridDim.y + blockIdx.y) * gridDim.x +
             blockIdx.x] = acc;
  }
}

// Adds a block's 256 values in a fixed tree order; thread 0 gets the sum.
__device__ float block_sum(float v, float* sh) {
  const int t = threadIdx.x;
  sh[t] = v;
  __syncthreads();
  for (int half = BWD_THREADS / 2; half > 0; half /= 2) {
    if (t < half) sh[t] += sh[t + half];
    __syncthreads();
  }
  const float s = sh[0];
  __syncthreads();
  return s;
}

// One thread per entry of dq11 and of dq22: the tiles' partials added in
// tile order.  Grid (entries of m + n in blocks of 256, batch).
__global__ void __launch_bounds__(BWD_THREADS)
    acos_gram_bwd_sums_kernel(const float* __restrict__ row_part,
                              const float* __restrict__ col_part,
                              const float* __restrict__ q11,
                              const float* __restrict__ q22,
                              const float* __restrict__ sigma0,
                              float* __restrict__ dq11,
                              float* __restrict__ dq22, int m, int n,
                              int tiles_m, int tiles_n) {
  const size_t b = blockIdx.y;
  const int e = blockIdx.x * BWD_THREADS + threadIdx.x;
  if (e >= m + n) return;
  const float s0 = sigma0[b];
  const float s02 = __fmul_rn(s0, s0);
  const bool row = e < m;
  const int i = row ? e : e - m;
  const int len = row ? m : n;
  const int tiles = row ? tiles_n : tiles_m;
  const float* p = (row ? row_part : col_part) + b * tiles * len + i;
  float acc = p[0];
#pragma unroll 8
  for (int t = 1; t < tiles; ++t) acc += p[static_cast<size_t>(t) * len];
  const float x = __fsqrt_rn(__fadd_rn((row ? q11 : q22)[b * len + i], s02));
  (row ? dq11 : dq22)[b * len + i] = __fdiv_rn(acc, __fmul_rn(2.f, x));
}

// One block per item: dsigma0 = 2 s0 (sum dq11 + sum dq22 + sum dq12),
// each sum in a fixed order.
__global__ void __launch_bounds__(BWD_THREADS)
    acos_gram_bwd_sigma_kernel(const float* __restrict__ dq11,
                               const float* __restrict__ dq22,
                               const float* __restrict__ num_part,
                               const float* __restrict__ sigma0,
                               float* __restrict__ dsigma0, int m, int n,
                               int tiles) {
  __shared__ float sh[BWD_THREADS];
  const size_t b = blockIdx.x;
  float sum_a = 0.f, sum_b = 0.f, sum_num = 0.f;
  for (int i = threadIdx.x; i < m; i += BWD_THREADS) sum_a += dq11[b * m + i];
  for (int j = threadIdx.x; j < n; j += BWD_THREADS) sum_b += dq22[b * n + j];
  for (int t = threadIdx.x; t < tiles; t += BWD_THREADS)
    sum_num += num_part[b * tiles + t];
  sum_a = block_sum(sum_a, sh);
  sum_b = block_sum(sum_b, sh);
  sum_num = block_sum(sum_num, sh);
  if (threadIdx.x == 0)
    dsigma0[b] = (sum_a + sum_b + sum_num) * 2.f * sigma0[b];
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, fetched through the CUDA runtime (no -lcuda).
EncodeTiledFn encoder() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
#if CUDART_VERSION >= 12050
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) !=
            cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault) != cudaSuccess)
      p = nullptr;
#endif
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// Tensor map of one (batch, rows, kp) float32 plane, boxes of one item's
// 128 x 32, 128-B swizzle, zero fill outside (past row `rows` of an item
// too: the item is the map's outermost dimension).
bool encode_plane(EncodeTiledFn enc, CUtensorMap* map, const float* plane,
                  int rows, int kp, int batch) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(kp),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[2] = {
      static_cast<cuuint64_t>(kp) * 4,
      static_cast<cuuint64_t>(kp) * static_cast<cuuint64_t>(rows) * 4};
  const cuuint32_t box[3] = {BK, BM, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
             const_cast<float*>(plane), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int grid_for(size_t work) {
  const size_t blocks = (work + 255) / 256;
  return static_cast<int>(blocks < 4096 ? (blocks > 0 ? blocks : 1) : 4096);
}

// Checks a main-loop plan and encodes the four planes' tensor maps of the
// split operands a (2, batch, m, kp) and b (2, batch, n, kp); 0 or an
// error code.
int encode_operands(const float* a, const float* b, int m, int n, int kp,
                    int splits, int batch, CUtensorMap (&maps)[4]) {
  const int kblocks = (kp + BK - 1) / BK;
  if (splits < 1 || splits > kblocks || batch < 1 ||
      static_cast<long long>(batch) * splits > 65535)
    return ERR_PLAN;
  EncodeTiledFn enc = encoder();
  if (enc == nullptr) return ERR_NO_ENCODER;
  const size_t a_plane = static_cast<size_t>(batch) * m * kp;
  const size_t b_plane = static_cast<size_t>(batch) * n * kp;
  if (!encode_plane(enc, &maps[0], a, m, kp, batch) ||
      !encode_plane(enc, &maps[1], a + a_plane, m, kp, batch) ||
      !encode_plane(enc, &maps[2], b, n, kp, batch) ||
      !encode_plane(enc, &maps[3], b + b_plane, n, kp, batch))
    return ERR_TENSOR_MAP;
  return 0;
}

}  // namespace

// Plain C interface (loaded with ctypes).  Each function launches on
// `stream`, allocates nothing, and returns 0 when every launch was accepted,
// else a cudaError_t (> 0) or one of this file's codes (< 0).

// a (rows, k) -> dst (2, rows, kp): big plane, then small plane.
extern "C" int tf32_split_f32(const float* a, float* dst, int rows, int k,
                              int kp, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* big = dst;
  float* small = dst + static_cast<size_t>(rows) * kp;
  const size_t total = static_cast<size_t>(rows) * kp;
  if (k == kp && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(dst) % 16 == 0) {
    tf32_split_vec_kernel<<<grid_for(total / 4), 256, 0, st>>>(
        reinterpret_cast<const float4*>(a), reinterpret_cast<float4*>(big),
        reinterpret_cast<float4*>(small), total / 4);
  } else {
    tf32_split_kernel<<<grid_for(total), 256, 0, st>>>(a, big, small, rows, k,
                                                       kp);
  }
  return static_cast<int>(cudaGetLastError());
}

// a (batch, rows, cols) -> dst (2, batch, cols, rowsp): the big plane of
// a^T per item, then the small plane, zero in rows [rows, rowsp).
extern "C" int tf32_split_t_f32(const float* a, float* dst, int batch,
                                int rows, int cols, int rowsp, void* stream) {
  if (batch < 1 || batch > 65535 || rows < 1 || cols < 1 || rowsp < rows ||
      (cols + 31) / 32 > 65535)
    return ERR_PLAN;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((rowsp + 31) / 32, (cols + 31) / 32, batch);
  tf32_split_t_kernel<<<grid, dim3(32, 8), 0, st>>>(
      a, dst, dst + static_cast<size_t>(batch) * cols * rowsp, rows, cols,
      rowsp);
  return static_cast<int>(cudaGetLastError());
}

// K (batch, m, n) from the split operands a (2, batch, m, kp) and b (2,
// batch, n, kp), with q11 (batch, m), q22 (batch, n) and sigma0 (batch,);
// q12 (batch, m, n) takes the raw cross form where it is not null.  With
// splits > 1, ws holds (batch, splits, m, n) floats; otherwise it is not
// touched.  out may be any contiguous (batch, m, n) target.
extern "C" int acos_gram_f32(const float* a, const float* b, const float* q11,
                             const float* q22, const float* sigma0,
                             float* out, float* q12, float* ws, int m, int n,
                             int kp, int splits, int batch, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  CUtensorMap maps[4];
  const int rc = encode_operands(a, b, m, n, kp, splits, batch, maps);
  if (rc != 0) return rc;
  cudaError_t e = cudaFuncSetAttribute(
      acos_gram_tf32x3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM, batch * splits);
  acos_gram_tf32x3_kernel<<<grid, THREADS, SMEM_BYTES, st>>>(
      maps[0], maps[1], maps[2], maps[3], q11, q22, sigma0,
      splits > 1 ? ws : out, q12, m, n, (kp + BK - 1) / BK, splits);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return static_cast<int>(e);
  acos_gram_reduce_kernel<<<grid_for(static_cast<size_t>(batch) * m * n), 256,
                            0, st>>>(ws, splits, q11, q22, sigma0, out, q12, m,
                                     n, batch);
  return static_cast<int>(cudaGetLastError());
}

// out (batch, m, n) = A B^T per item, from the split operands a (2, batch,
// m, kp) and b (2, batch, n, kp), on the Gram's main loop; ws as in
// acos_gram_f32.
extern "C" int nt_product_f32(const float* a, const float* b, float* out,
                              float* ws, int m, int n, int kp, int splits,
                              int batch, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  CUtensorMap maps[4];
  const int rc = encode_operands(a, b, m, n, kp, splits, batch, maps);
  if (rc != 0) return rc;
  cudaError_t e = cudaFuncSetAttribute(
      nt_product_tf32x3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM, batch * splits);
  nt_product_tf32x3_kernel<<<grid, THREADS, SMEM_BYTES, st>>>(
      maps[0], maps[1], maps[2], maps[3], splits > 1 ? ws : out, m, n,
      (kp + BK - 1) / BK, splits);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return static_cast<int>(e);
  const size_t mn = static_cast<size_t>(m) * n;
  nt_product_reduce_kernel<<<grid_for(mn * batch), 256, 0, st>>>(
      ws, splits, out, mn, batch);
  return static_cast<int>(cudaGetLastError());
}

// The backward epilogue of a batch of Grams: from g and q12 (batch, m, n),
// q11 (batch, m), q22 (batch, n) and sigma0 (batch,), dq12 (batch, m, n),
// its TF32 planes planes (2, batch, m, np) (np >= n, zero in the columns
// past n), dq11 (batch, m), dq22 (batch, n) and dsigma0 (batch,).  part
// holds batch x (tiles_n m + tiles_m n + tiles_m tiles_n) floats, tiles of
// 32 rows by 128 columns.
extern "C" int acos_gram_bwd_f32(const float* g, const float* q12,
                                 const float* q11, const float* q22,
                                 const float* sigma0, float* dq12,
                                 float* planes, int np, float* part,
                                 float* dq11, float* dq22, float* dsigma0,
                                 int m, int n, int batch, void* stream) {
  const int tiles_m = (m + BWD_TM - 1) / BWD_TM;
  const int tiles_n = (n + BWD_TN - 1) / BWD_TN;
  if (batch < 1 || batch > 65535 || tiles_m > 65535 || np < n)
    return ERR_PLAN;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* row_part = part;
  float* col_part = row_part + static_cast<size_t>(batch) * tiles_n * m;
  float* num_part = col_part + static_cast<size_t>(batch) * tiles_m * n;
  const dim3 grid(tiles_n, tiles_m, batch);
  acos_gram_bwd_kernel<<<grid, BWD_THREADS, 0, st>>>(
      g, q12, q11, q22, sigma0, dq12, planes,
      planes + static_cast<size_t>(batch) * m * np, np, row_part, col_part,
      num_part, m, n);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  acos_gram_bwd_sums_kernel<<<dim3((m + n + BWD_THREADS - 1) / BWD_THREADS,
                                   batch),
                              BWD_THREADS, 0, st>>>(
      row_part, col_part, q11, q22, sigma0, dq11, dq22, m, n, tiles_m,
      tiles_n);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  acos_gram_bwd_sigma_kernel<<<batch, BWD_THREADS, 0, st>>>(
      dq11, dq22, num_part, sigma0, dsigma0, m, n, tiles_m * tiles_n);
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory of one Gram block, in bytes.
extern "C" int acos_gram_smem_bytes() { return SMEM_BYTES; }

extern "C" const char* acos_gram_error_string(int code) {
  switch (code) {
    case ERR_NO_ENCODER:
      return "cuTensorMapEncodeTiled not found through the CUDA runtime";
    case ERR_TENSOR_MAP:
      return "cuTensorMapEncodeTiled refused an operand's tensor map";
    case ERR_PLAN:
      return "sizes outside the launch's limits (splits outside [1, number "
             "of 32-float blocks of k], or a grid dimension above 65535)";
    default:
      return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}
