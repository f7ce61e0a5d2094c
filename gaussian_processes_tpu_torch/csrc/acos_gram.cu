// Fused arc-cosine Gram for Hopper (sm_90a), float32.
//
// Replaces: gaussian_processes_tpu/ops/gram_pallas.py::acos_gram_pallas (the
// Pallas TPU kernel with body _gram_kernel, epilogue _acos_tile and the
// arccos polynomial _acos_poly).
//
// Computes, for u1 (m, k) and s2 (n, k), both row-major (an "NT" product):
//   q12[i, j] = sum_t u1[i, t] * s2[j, t]
//   X1 = sqrt(q11 + s0^2), X2 = sqrt(q22 + s0^2), s0 = *sigma0
//   c  = clip((q12 + s0^2) / (X1 X2 + 1e-7), -1, 1)
//   K  = X1 X2 * (sqrt(1 - c^2) + (pi - acos c) c) / pi
// and writes K (m, n) once.  q12 never exists in device memory.
//
// What bounds it: the contraction.  It takes 2 m n k flops against
// (m + n) k 4 bytes of operands, i.e. m n / (2 (m + n)) flop per byte: about
// 630 at the fit's K (m = 3160, n = 2100) and 525 at its K_tilde (2100 x
// 2100), far above the card's flop-to-byte balance, so the kernel is bound
// by float32 FMA issue rate (no TF32: the Gram feeds an eigendecomposition
// and a Cholesky).
//
// What the tiling does about it: each 256-thread block owns a 128 x 128
// output tile and walks k in steps of 8.  Each step stages a 128 x 8 slice
// of u1 and of s2 in shared memory, transposed so that k is the slow index;
// every thread then keeps an 8 x 8 block of accumulators in registers and
// reads 8 + 8 operands from shared memory for 64 FMAs.  Each operand loaded
// from device memory is reused 128 times from shared memory and each shared
// value 8 times from registers.  Ragged edges are masked on load (zero
// fill) and on store; nothing is padded or copied by the caller.  The
// epilogue runs in registers, with a real acosf (the Pallas kernel carried a
// polynomial only because Mosaic had no acos).
//
// Later work: wgmma with TMA-fed shared-memory rings, or 3xTF32 splitting,
// would move this onto the tensor cores.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 8;
constexpr int TM = 8;
constexpr int TN = 8;
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256
constexpr int PAD = 4;  // keeps rows 16-byte aligned for float4 reads
constexpr float JITTER = 1e-7f;

static_assert(BM == BN, "one tile loader serves both operands");
static_assert(THREADS * 4 == BM * BK, "each thread stages 4 values per operand");

// Stage rows [row0, row0 + BM) x cols [k0, k0 + BK) of a row-major
// (rows, K) matrix into dst[k][row], zero-filling outside the matrix.
// Thread t loads 4 consecutive k of one row: two threads cover one row's
// 32 bytes, so a warp reads 16 full 32-byte sectors.
__device__ __forceinline__ void stage_tile(const float* __restrict__ src,
                                           int rows, int K, int row0, int k0,
                                           bool vec, float (*dst)[BM + PAD],
                                           int tid) {
  const int r = tid >> 1;
  const int c = (tid & 1) * 4;
  const int gr = row0 + r;
  const int gc = k0 + c;
  float v0 = 0.f, v1 = 0.f, v2 = 0.f, v3 = 0.f;
  if (gr < rows) {
    const float* p = src + static_cast<size_t>(gr) * K + gc;
    if (vec) {
      // K % 4 == 0 and gc % 4 == 0: the float4 lies wholly inside or outside
      if (gc < K) {
        const float4 t = *reinterpret_cast<const float4*>(p);
        v0 = t.x; v1 = t.y; v2 = t.z; v3 = t.w;
      }
    } else {
      if (gc < K) v0 = p[0];
      if (gc + 1 < K) v1 = p[1];
      if (gc + 2 < K) v2 = p[2];
      if (gc + 3 < K) v3 = p[3];
    }
  }
  dst[c + 0][r] = v0;
  dst[c + 1][r] = v1;
  dst[c + 2][r] = v2;
  dst[c + 3][r] = v3;
}

__global__ void __launch_bounds__(THREADS)
acos_gram_kernel(const float* __restrict__ u1, const float* __restrict__ s2,
                 const float* __restrict__ q11, const float* __restrict__ q22,
                 const float* __restrict__ sigma0, float* __restrict__ out,
                 int m, int n, int K, bool vec) {
  __shared__ __align__(16) float As[BK][BM + PAD];
  __shared__ __align__(16) float Bs[BK][BN + PAD];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    stage_tile(u1, m, K, row0, k0, vec, As, tid);
    stage_tile(s2, n, K, col0, k0, vec, Bs, tid);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * TM]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][ty * TM + 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * TN]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk][tx * TN + 4]);
      a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
      a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
      b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
      b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // Epilogue in registers: norms with sigma0^2 folded in, clip, J factor.
  const float s0 = *sigma0;
  const float s02 = s0 * s0;
  float x1[TM], x2[TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gi = row0 + ty * TM + i;
    x1[i] = gi < m ? sqrtf(q11[gi] + s02) : 1.f;
  }
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int gj = col0 + tx * TN + j;
    x2[j] = gj < n ? sqrtf(q22[gj] + s02) : 1.f;
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gi = row0 + ty * TM + i;
    if (gi >= m) continue;
    float* orow = out + static_cast<size_t>(gi) * n;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gj = col0 + tx * TN + j;
      if (gj >= n) continue;
      const float X = x1[i] * x2[j];
      float c = (acc[i][j] + s02) / (X + JITTER);
      // written with comparisons so that a NaN stays NaN (fminf/fmaxf
      // would replace it by a bound)
      c = c < -1.f ? -1.f : (c > 1.f ? 1.f : c);
      const float s = sqrtf(fmaxf(1.f - c * c, 0.f));
      const float J = (s + (CUDART_PI_F - acosf(c)) * c) / CUDART_PI_F;
      orow[gj] = X * J;
    }
  }
}

}  // namespace

// Plain C interface (loaded with ctypes).  Launches on `stream`, allocates
// nothing, and returns cudaGetLastError() as an int (0 = launched).
extern "C" int acos_gram_f32(const float* u1, const float* s2,
                             const float* q11, const float* q22,
                             const float* sigma0, float* out, int m, int n,
                             int k, void* stream) {
  const bool vec = (k % 4 == 0) &&
                   (reinterpret_cast<uintptr_t>(u1) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(s2) % 16 == 0);
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  acos_gram_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      u1, s2, q11, q22, sigma0, out, m, n, k, vec);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* acos_gram_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
