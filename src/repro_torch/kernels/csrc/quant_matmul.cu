// int8 x int8 -> int32 GEMM for Hopper (sm_90a), exact, one launch per call.
//
// Replaces the Pallas TPU kernel src/repro/kernels/quant_matmul/
// quant_matmul.py:_kernel / quant_matmul_int: (M, K) int8 @ (K, N) int8 ->
// (M, N) int32.  That kernel zero-pads to 128/128/512 blocks and carries
// the int32 sum across its sequential K grid axis in the output block.
//
// Bound on an H100: on the served path M is the decode batch or a prompt of
// at most 64 tokens and K, N are 1024 or 2816, so the GEMM moves the K x N
// int8 weight once and does 2*M*K*N integer operations: at most 128 per byte
// of w, against the ~590 per byte at which the int8 tensor cores would
// become the limit.  It is bound by the bytes of w over the memory rate,
// 0.3-0.9 us; measured, a call costs the launch (~1.8 us for an empty
// kernel), one cold pass over w, and the latency of what follows the last
// byte.  What the design does about it:
//
// * One device operation per call: no memset, no atomics on out.  Each
//   block owns 16 columns, so N = 1024 and 2816 give 64 and 176 blocks, and
//   its 8 warps split the block's k range and meet in shared memory in a
//   fixed order.  K splits across blocks only where a block's share would
//   not fit one staged chunk of 1024 k (the wrapper's plan(); K = 2816 on
//   the path): each split then writes its int32 partial to a workspace, one
//   thread bumps the column tile's arrival counter (atom.acq_rel, after a
//   barrier), and the last block to arrive sums the partials in split order,
//   writes out and puts the counter back to 0.
// * Every byte in flight at once.  A thread issues all its loads first:
//   4 k rows x 16 columns of w, one 16-byte load per row, then its x
//   fragments.  The path's whole weight (1-2.9 MB) is in flight in one wave.
// * No byte-wise transpose.  mma.sync.m16n8k32 wants 4 consecutive k of one
//   column per B register.  A thread turns its 4 rows x 16 columns into 16
//   such words with __byte_perm 4 x 4 transposes in registers and stores
//   them as whole words to shared memory (column-major, padded so that the
//   fragment reads are 64-bit and take two wavefronts).  The k order inside
//   an mma is free as long as x uses the same one: lane (g, t) takes rows
//   8t..8t+7 of a step, so its x fragment is the 8 bytes x[m][8t..8t+7].
// * w read once at any M: the block keeps its share of w in shared memory
//   and loops over the 16-row tiles of x, loading the next tile's x while
//   the current one runs.
//
// Any M >= 1, ragged K and N (zero-filled edges), unaligned pointers (byte
// loads, chosen per call by a template flag) and the full int8 range (-128
// included) are taken; int32 sums wrap as the tensor cores' do.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int BN = 16;       // columns of w per block: 16 bytes of a row
constexpr int KSTEP = 32;    // k per mma step
constexpr int KC = 1024;     // k rows a block stages in shared memory, at most
constexpr int CSTEPS = KC / KSTEP;
constexpr int SPW = CSTEPS / WARPS;  // steps per warp
constexpr int QPT = KC / 4 / THREADS;  // 4-row quads of w per thread
constexpr int LDQ = KC / 4 + 8;  // words per column of w in shared memory
constexpr int RLD = BN + 8;      // shared row stride of the warp reduction
static_assert(LDQ % 32 == 8 && RLD % 32 == 24, "2-wavefront 64-bit access");
static_assert(QPT >= 1 && SPW >= 1 && WARPS * SPW == CSTEPS,
              "KC k rows cover every thread and warp");
static_assert(16 * BN == THREADS, "one output of a 16-row tile per thread");

__device__ __forceinline__ void mma_s8(int (&c)[4], const int (&a)[4],
                                       const int (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// BYTES bytes at p, byte by byte, the first `avail` of them and zeros
// after: the load of a row not aligned for a vector load.
template <int BYTES>
__device__ __forceinline__ void load_bytes(int8_t (&b)[BYTES],
                                           const int8_t* __restrict__ p,
                                           int avail) {
#pragma unroll
  for (int j = 0; j < BYTES; ++j) b[j] = j < avail ? __ldg(p + j) : 0;
}

// 16 bytes of w at p (the 16 columns of one k row of a tile), zero-filled
// past `avail`; one vector load when rows are 16-byte aligned (VEC).
template <bool VEC>
__device__ __forceinline__ int4 load_w16(const int8_t* __restrict__ p,
                                         int avail) {
  if (VEC) return __ldg(reinterpret_cast<const int4*>(p));
  union { int4 v; int8_t b[16]; } u;
  load_bytes(u.b, p, avail);
  return u.v;
}

// 8 bytes of x at p, the same way (VEC: rows 8-byte aligned).
template <bool VEC>
__device__ __forceinline__ int2 load_x8(const int8_t* __restrict__ p,
                                        int avail) {
  if (VEC) return __ldg(reinterpret_cast<const int2*>(p));
  union { int2 v; int8_t b[8]; } u;
  load_bytes(u.b, p, avail);
  return u.v;
}

// Four words, each 4 columns of one k row (rows r0..r3), to four words,
// each the 4 k rows of one column: c_j byte i = r_i byte j.
__device__ __forceinline__ void transpose4(unsigned r0, unsigned r1,
                                           unsigned r2, unsigned r3, int* c) {
  const unsigned t0 = __byte_perm(r0, r1, 0x5140);  // r0.0 r1.0 r0.1 r1.1
  const unsigned t1 = __byte_perm(r0, r1, 0x7362);  // r0.2 r1.2 r0.3 r1.3
  const unsigned t2 = __byte_perm(r2, r3, 0x5140);
  const unsigned t3 = __byte_perm(r2, r3, 0x7362);
  c[0] = __byte_perm(t0, t2, 0x5410);
  c[1] = __byte_perm(t0, t2, 0x7632);
  c[2] = __byte_perm(t1, t3, 0x5410);
  c[3] = __byte_perm(t1, t3, 0x7632);
}

// x fragments of one 16-row tile for each of this warp's steps of the
// split: xa[i][h] = x[m + 8h][k .. k+7], k = step * 32 + 8t.
template <bool VEC>
__device__ __forceinline__ void load_x_tile(
    int2 (&xa)[SPW][2], const int8_t* __restrict__ x, int M, int K, int m,
    int kstep0, int csteps, int warp, int t) {
#pragma unroll
  for (int i = 0; i < SPW; ++i) {
    const int s = warp + WARPS * i, k = (kstep0 + s) * KSTEP + 8 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int mm = m + 8 * h;
      xa[i][h] = (s < csteps && mm < M && k < K)
          ? load_x8<VEC>(x + (size_t)mm * K + k, K - k) : make_int2(0, 0);
    }
  }
}

template <bool WVEC, bool XVEC>
__global__ void __launch_bounds__(THREADS)
quant_matmul_kernel(const int8_t* __restrict__ x,
                    const int8_t* __restrict__ w, int32_t* __restrict__ out,
                    int32_t* __restrict__ ws, unsigned* __restrict__ counters,
                    int M, int N, int K, int steps, int splits) {
  // bs[c * LDQ + q]: k rows 4q..4q+3 of the split, column c, one word
  __shared__ __align__(16) int bs[BN * LDQ];
  __shared__ __align__(16) int red[WARPS][16 * RLD];
  __shared__ bool last;
  const int tile = blockIdx.x, split = blockIdx.y;
  const int n0 = tile * BN;
  const int lo = (int)((long long)split * steps / splits);
  const int hi = (int)((long long)(split + 1) * steps / splits);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // mma group id / thread in group
  const int mtiles = (M + 15) / 16;
  // this block's partial sums: out itself when K is not split
  int32_t* dst = splits == 1 ? out : ws + (size_t)split * M * N;

  const int csteps = hi - lo, kb = lo * KSTEP;  // at most CSTEPS (plan)
  // every load first: this thread's quads of w, then x's first tile
  int4 raw[QPT][4];
#pragma unroll
  for (int j = 0; j < QPT; ++j) {
    const int q = tid + THREADS * j;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int k = kb + 4 * q + r;
      raw[j][r] = (q < 8 * csteps && k < K)
          ? load_w16<WVEC>(w + (size_t)k * N + n0, N - n0)
          : make_int4(0, 0, 0, 0);
    }
  }
  int2 xa[SPW][2];
  load_x_tile<XVEC>(xa, x, M, K, g, lo, csteps, warp, t);
#pragma unroll
  for (int j = 0; j < QPT; ++j) {
    const int q = tid + THREADS * j;
    if (q < 8 * csteps) {
      const int4* r = raw[j];
      int cw[BN];
      transpose4(r[0].x, r[1].x, r[2].x, r[3].x, cw);
      transpose4(r[0].y, r[1].y, r[2].y, r[3].y, cw + 4);
      transpose4(r[0].z, r[1].z, r[2].z, r[3].z, cw + 8);
      transpose4(r[0].w, r[1].w, r[2].w, r[3].w, cw + 12);
#pragma unroll
      for (int c = 0; c < BN; ++c) bs[c * LDQ + q] = cw[c];
    }
  }
  __syncthreads();

  for (int mt = 0; mt < mtiles; ++mt) {
    int2 xn[SPW][2];  // the next tile's x, in flight while this one runs
    load_x_tile<XVEC>(xn, x, M, K, (mt + 1) * 16 + g, lo, csteps, warp, t);
    int acc[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};
#pragma unroll
    for (int i = 0; i < SPW; ++i) {
      // A step past the split has x = 0 and reads whatever w is there.
      const int s = warp + WARPS * i;
      // k order inside the mma: slot quad t = rows 8t..8t+3 of the step,
      // slot quad 4 + t = rows 8t+4..8t+7 (x and w alike)
      const int a[4] = {xa[i][0].x, xa[i][1].x, xa[i][0].y, xa[i][1].y};
#pragma unroll
      for (int jn = 0; jn < 2; ++jn) {
        const int2 bb = *reinterpret_cast<const int2*>(
            &bs[(8 * jn + g) * LDQ + 8 * s + 2 * t]);
        const int b[2] = {bb.x, bb.y};
        mma_s8(acc[jn], a, b);
      }
    }
    // the warps' sums of this tile meet in shared memory, one output per
    // thread: acc[jn] = rows g, g + 8 of columns 8jn + 2t, 8jn + 2t + 1
    int* my = red[warp];
#pragma unroll
    for (int jn = 0; jn < 2; ++jn) {
      *reinterpret_cast<int2*>(&my[g * RLD + 8 * jn + 2 * t]) =
          make_int2(acc[jn][0], acc[jn][1]);
      *reinterpret_cast<int2*>(&my[(g + 8) * RLD + 8 * jn + 2 * t]) =
          make_int2(acc[jn][2], acc[jn][3]);
    }
    __syncthreads();
    const int row = tid / BN, col = n0 + tid % BN;
    if (mt * 16 + row < M && col < N) {
      const int o = row * RLD + tid % BN;
      unsigned v = 0;
#pragma unroll
      for (int wi = 0; wi < WARPS; ++wi) v += (unsigned)red[wi][o];
      dst[(size_t)(mt * 16 + row) * N + col] = (int32_t)v;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < SPW; ++i) {
      xa[i][0] = xn[i][0];
      xa[i][1] = xn[i][1];
    }
  }
  if (splits == 1) return;

  // the last split of this column tile to arrive sums all of them, in
  // order.  The barrier orders the block's partial stores before thread 0's
  // release; its acquire and the second barrier order the reads after it.
  __syncthreads();
  if (tid == 0) {
    unsigned prev;
    asm volatile("atom.add.acq_rel.gpu.u32 %0, [%1], 1;"
                 : "=r"(prev) : "l"(counters + tile) : "memory");
    last = prev == (unsigned)splits - 1;
  }
  __syncthreads();
  if (!last) return;
  const size_t stride = (size_t)M * N;
  for (int e = tid; e < M * BN; e += THREADS) {
    const int m = e / BN, col = n0 + e % BN;
    if (col >= N) continue;
    const int32_t* p = ws + (size_t)m * N + col;
    unsigned v = 0;
#pragma unroll 4
    for (int s = 0; s < splits; ++s) v += (unsigned)__ldcg(p + s * stride);
    out[(size_t)m * N + col] = (int32_t)v;
  }
  if (tid == 0) counters[tile] = 0;
}

}  // namespace

// col_tiles and splits come from the wrapper's plan(), each split at most
// KC rows of K; ws holds splits * M * N int32 and counters col_tiles zeroed
// words when splits > 1.
extern "C" int quant_matmul_int_launch(const void* x, const void* w, void* out,
                                       void* ws, void* counters, int M, int N,
                                       int K, int col_tiles, int splits,
                                       void* stream) {
  if (M <= 0 || N <= 0 || K < 0) return (int)cudaErrorInvalidValue;
  const int steps = K > 0 ? (K + KSTEP - 1) / KSTEP : 1;
  if (col_tiles != (N + BN - 1) / BN || splits < 1 || splits > steps ||
      splits > 65535 || (steps + splits - 1) / splits > CSTEPS ||
      (splits > 1 && (ws == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  // 16-byte loads of w need every row of w on a 16-byte boundary, 8-byte
  // loads of x every row of x on an 8-byte boundary
  const bool wvec = N % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const bool xvec = K % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 8 == 0;
  auto kernel = wvec ? (xvec ? quant_matmul_kernel<true, true>
                             : quant_matmul_kernel<true, false>)
                     : (xvec ? quant_matmul_kernel<false, true>
                             : quant_matmul_kernel<false, false>);
  kernel<<<dim3(col_tiles, splits), THREADS, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<int32_t*>(out), static_cast<int32_t*>(ws),
      static_cast<unsigned*>(counters), M, N, K, steps, splits);
  return (int)cudaGetLastError();
}

extern "C" const char* quant_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
