// int8 x int8 -> int32 GEMM for Hopper (sm_90a), exact.
//
// Replaces the Pallas TPU kernel src/repro/kernels/quant_matmul/
// quant_matmul.py:_kernel / quant_matmul_int: (M, K) int8 @ (K, N) int8 ->
// (M, N) int32.  That kernel zero-pads to 128/128/512 blocks and carries
// the int32 sum across its sequential K grid axis in the output block.
//
// Bound on an H100: at the shapes of the served path (M = the decode batch
// or a prompt of at most a few dozen tokens, K and N of 1024 or 2816) the
// GEMM moves the whole K x N int8 weight once and does 2*M*K*N integer
// operations, far below the card's int8 tensor-core rate: it is bound by
// the bytes of w over the memory rate.  What the design does about it:
// blocks are small (16 rows of x by 64 columns of w) and K is split across
// blocks (128 per block), so even at M = 1 there are a hundred or more
// blocks streaming w at once across the 132 SMs.  The partial sums of the
// K splits meet in the output through int32 atomicAdd, which is exact and
// order-free for integers (the output is zeroed first on the same stream).
// Each block loads its whole 16 x 128 tile of x and 128 x 64 tile of w with
// 16-byte loads, all issued before the first is used, so a block waits on
// device memory about once; it stages the tiles in shared memory (w
// transposed to k-contiguous rows) and runs mma.sync.m16n8k32 s8 x s8 ->
// s32, two per warp per 32-deep k step.  Any M >= 1, ragged K and N
// (zero-filled edges, read byte by byte) and the full int8 range (-128
// included) are taken.  cp.async/TMA staging and wgmma come later.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 16;        // rows of x per block: one mma m16
constexpr int BN = 64;        // columns of w per block: 4 warps x 16
constexpr int BK = 128;       // k per block (split-K): four mma k32 steps
constexpr int LDS = BK + 16;  // shared row stride in bytes (conflict-free fragments)
constexpr int THREADS = 128;
constexpr int B_CHUNKS = BK * BN / 16 / THREADS;  // 16-byte pieces of w per thread
static_assert(BM * BK / 16 == THREADS, "one 16-byte piece of x per thread");

__device__ __forceinline__ void mma_s8(int (&c)[4], const int (&a)[4],
                                       const int (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 16 bytes at p: one vector load when all 16 are in range and aligned
// (`whole`), else byte by byte, the first `avail` of them, zeros after.
__device__ __forceinline__ int4 load16(const int8_t* __restrict__ p,
                                       bool whole, int avail) {
  if (whole) return __ldg(reinterpret_cast<const int4*>(p));
  union { int4 v; int8_t b[16]; } u;
#pragma unroll
  for (int j = 0; j < 16; ++j) u.b[j] = j < avail ? p[j] : 0;
  return u.v;
}

__global__ void __launch_bounds__(THREADS)
quant_matmul_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                    int32_t* __restrict__ out, int M, int N, int K, bool vec) {
  __shared__ __align__(16) int8_t As[BM * LDS];  // As[m][k]
  __shared__ __align__(16) int8_t Bs[BN * LDS];  // Bs[n][k] (w transposed)
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int k0 = blockIdx.z * BK;
  const int k_end = min(K, k0 + BK);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // mma group id / thread in group

  // every global load of the block first, then the shared stores
  const int ar = tid >> 3, ac = (tid & 7) * 16;  // x piece: row, k offset
  const int am = m0 + ar, ak = k0 + ac;
  const int4 a_reg = (am < M && ak < k_end)
      ? load16(x + (size_t)am * K + ak, vec && ak + 16 <= k_end, k_end - ak)
      : make_int4(0, 0, 0, 0);
  int4 b_reg[B_CHUNKS];
#pragma unroll
  for (int q = 0; q < B_CHUNKS; ++q) {
    const int i = tid + q * THREADS, r = i >> 2, c = (i & 3) * 16;
    const int k = k0 + r, n = n0 + c;
    b_reg[q] = (k < k_end && n < N)
        ? load16(w + (size_t)k * N + n, vec && n + 16 <= N, N - n)
        : make_int4(0, 0, 0, 0);
  }
  *reinterpret_cast<int4*>(&As[ar * LDS + ac]) = a_reg;
#pragma unroll
  for (int q = 0; q < B_CHUNKS; ++q) {
    const int i = tid + q * THREADS, r = i >> 2, c = (i & 3) * 16;
    union { int4 v; int8_t b[16]; } u;
    u.v = b_reg[q];
#pragma unroll
    for (int j = 0; j < 16; ++j) Bs[(c + j) * LDS + r] = u.b[j];
  }
  __syncthreads();

  int acc[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};
#pragma unroll
  for (int kk = 0; kk < BK; kk += 32) {
    int a[4];
    a[0] = *reinterpret_cast<const int*>(&As[g * LDS + kk + t * 4]);
    a[1] = *reinterpret_cast<const int*>(&As[(g + 8) * LDS + kk + t * 4]);
    a[2] = *reinterpret_cast<const int*>(&As[g * LDS + kk + 16 + t * 4]);
    a[3] = *reinterpret_cast<const int*>(&As[(g + 8) * LDS + kk + 16 + t * 4]);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int nn = warp * 16 + j * 8 + g;
      int b[2];
      b[0] = *reinterpret_cast<const int*>(&Bs[nn * LDS + kk + t * 4]);
      b[1] = *reinterpret_cast<const int*>(&Bs[nn * LDS + kk + 16 + t * 4]);
      mma_s8(acc[j], a, b);
    }
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + g + (i >= 2 ? 8 : 0);
      const int n = n0 + warp * 16 + j * 8 + t * 2 + (i & 1);
      if (m < M && n < N) atomicAdd(&out[(size_t)m * N + n], acc[j][i]);
    }
  }
}

}  // namespace

extern "C" int quant_matmul_int_launch(const void* x, const void* w, void* out,
                                       int M, int N, int K, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M < 0 || N < 0 || K < 0) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaMemsetAsync(out, 0, (size_t)M * N * sizeof(int32_t), s);
  if (e != cudaSuccess) return (int)e;
  if (M == 0 || N == 0 || K == 0) return (int)cudaGetLastError();
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, (K + BK - 1) / BK);
  if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidValue;
  // 16-byte loads need every row of x and w to start on a 16-byte boundary
  const bool vec = K % 16 == 0 && N % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0;
  quant_matmul_kernel<<<grid, THREADS, 0, s>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<int32_t*>(out), M, N, K, vec);
  return (int)cudaGetLastError();
}

extern "C" const char* quant_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
