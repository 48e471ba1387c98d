// Transposition between integer operands and crossbar bit-plane columns,
// both ways, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference packs and unpacks crossbar state
// on the host (src/repro/pim/executor.py: write_numbers, read_numbers).
// The port's plain versions of those (src/repro_torch/pim/executor.py) do
// it with int64 PyTorch operations that build every operand row, widen each
// bit plane to int64 and sum 32 shifted copies, and that moved about 9 GB a
// decode step of jamba-v0.1 in pim_sim.  These two kernels do the same
// transposition straight from the operands to the state and from the
// state to the accumulators.
//
// Writer.  Operand v, x (P, M, K) or w (P, O, K), uint8 at any strides;
// column table cols (K, nb) int32, nb <= 8.  For every crossbar c in
// [lo, hi) of a batch of P chunk GEMMs of n_cb crossbars each, row j of
// crossbar c is global row g = (c mod n_cb) * rows + j of chunk
// q = c div n_cb, whose value is v[q, g div o, k] for x and v[q, g mod o, k]
// for w, and 0 for g >= m * o or j >= rows.  Bit b of term k goes to word
// j div 32 (bit j mod 32) of column cols[k, b] of the crossbar's state
// part[c - lo] (C, n, W) int32.  Nothing else of the state is written.
//
// What bounds the writer on an H100: the state words it writes, C * K * nb
// * W * 4 bytes over 3.35 TB/s (jamba's w_in at batch 2: 12,432 crossbars,
// 117.8 MB, 35 us); its input is a few KB of x, or the weight once.
// Design: one block per crossbar, one warp per row-word (a loop when W is
// above WRITE_WARPS).  A lane holds one row: four of its terms at a time as
// one 32-bit value (term t in byte t), and a 32 x 32 bit transpose across
// the warp (five rounds of shfl_xor and masks) leaves lane 8t + b holding
// the row-word of bit b of term t, for 32 (term, bit) columns at once: some
// 30 instructions for 32 words, where one ballot per word would take about
// four times as many.  The words are staged in shared memory (an odd row
// stride, so the transposed stores are free of bank conflicts) for
// PASS_TERMS terms at a time (all 37 of the 1024-column program in one
// pass), then each column's W words go out as one run
// of W * 4 bytes (16-byte stores when W is a multiple of 4).  Operand bytes
// are read through L1: x's rows are shared by every crossbar of a chunk,
// and a crossbar's w rows are 9.5 KB at K = 37.
//
// Reader.  State (C, n, W) int32 after the program, accumulator columns
// acc (A,) int32, A <= 63; writes out (C, rows) int64 (any contiguous
// buffer, a slice of the caller's accumulator included): row r is the sum
// over j of bit r of word r div 32 of column acc[j], shifted left by j.
// Bound: C * A * W * 4 bytes in and C * rows * 8 out over 3.35 TB/s (w_in:
// 34.2 MB, 10 us).  Design: one block per crossbar stages its A * W words
// in shared memory, then one thread per row assembles its value (every
// lane of a warp reads the same word: a broadcast) and writes one int64,
// coalesced.
//
// Column tables are checked by the wrapper (kernels/pim_bits), once per
// table: columns in [0, n), and a writer's all distinct.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WRITE_WARPS = 8;       // most warps per writer block
constexpr int PASS_TERMS = 40;       // terms staged per pass (K = 37: one)
constexpr int MAX_BITS = 8;          // bits per term: four terms per lane
constexpr int READ_THREADS = 256;    // most threads per reader block
constexpr int MAX_ACC = 63;          // accumulator bits: int64 sign bit free

// Transpose a 32 x 32 bit matrix held one row per lane: afterwards bit l
// of lane p is bit p of lane l's value before.  Each round swaps the
// off-diagonal blocks of size s: lane l with (l & s) == 0 keeps its bits
// at positions p with (p & s) == 0 and takes its partner's there, shifted
// up by s; its partner keeps its other half and takes l's, shifted down.
__device__ __forceinline__ uint32_t transpose32(uint32_t x, int lane) {
  const uint32_t lows[5] = {0x0000ffffu, 0x00ff00ffu, 0x0f0f0f0fu,
                            0x33333333u, 0x55555555u};
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const int s = 16 >> i;
    const uint32_t low = lows[i];
    const uint32_t y = __shfl_xor_sync(0xffffffffu, x, s);
    x = (lane & s) ? ((x & ~low) | ((y >> s) & low))
                   : ((x & low) | ((y & low) << s));
  }
  return x;
}

__global__ void __launch_bounds__(WRITE_WARPS * 32)
pim_bits_write_kernel(const uint8_t* __restrict__ v, long long sq,
                      long long sr, long long sk,
                      const int32_t* __restrict__ cols, int K, int nb,
                      int32_t* __restrict__ part, int lo, int n_cb, int rows,
                      long long m, long long o, int of_x, int n, int W,
                      int vec) {
  extern __shared__ int32_t words[];   // [pair][word], row stride S
  const int S = W | 1;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int warps = blockDim.x / 32;
  const long long c = (long long)lo + blockIdx.x;
  const long long q = c / n_cb;
  const long long g0 = (c - q * n_cb) * rows;
  const long long total = m * o;
  int32_t* dst = part + (size_t)blockIdx.x * n * W;
  const int vw = vec ? 4 : 1;
  const int per = W / vw;

  for (int k0 = 0; k0 < K; k0 += PASS_TERMS) {
    const int kn = min(PASS_TERMS, K - k0);
    for (int wi = warp; wi < W; wi += warps) {
      const int j = wi * 32 + lane;
      const long long g = g0 + j;
      const bool live = j < rows && g < total;
      const uint8_t* src = v;
      if (live) src = v + q * sq + (of_x ? g / o : g % o) * sr + k0 * sk;
      for (int t0 = 0; t0 < kn; t0 += 4) {
        uint32_t x = 0;
#pragma unroll
        for (int t = 0; t < 4; ++t)
          if (live && t0 + t < kn)
            x |= (uint32_t)__ldg(src + (t0 + t) * sk) << (8 * t);
        x = transpose32(x, lane);
        const int t = t0 + lane / MAX_BITS, b = lane % MAX_BITS;
        if (t < kn && b < nb) words[(t * nb + b) * S + wi] = (int32_t)x;
      }
    }
    __syncthreads();
    const int pairs = kn * nb;
    const int32_t* col = cols + k0 * nb;
    for (int e = threadIdx.x; e < pairs * per; e += blockDim.x) {
      const int i = e / per, w0 = (e - i * per) * vw;
      int32_t* d = dst + (size_t)__ldg(col + i) * W + w0;
      const int32_t* s = words + i * S + w0;
      if (vec)
        *reinterpret_cast<int4*>(d) = make_int4(s[0], s[1], s[2], s[3]);
      else
        *d = *s;
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(READ_THREADS)
pim_bits_read_kernel(const int32_t* __restrict__ state,
                     const int32_t* __restrict__ acc, int A, int n, int W,
                     int rows, long long* __restrict__ out) {
  extern __shared__ uint32_t sw[];     // [accumulator bit][word]
  const int32_t* st = state + (size_t)blockIdx.x * n * W;
  for (int e = threadIdx.x; e < A * W; e += blockDim.x) {
    const int j = e / W, wi = e - j * W;
    sw[e] = (uint32_t)st[(size_t)__ldg(acc + j) * W + wi];
  }
  __syncthreads();
  long long* o = out + (size_t)blockIdx.x * rows;
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    const int wi = r >> 5, sh = r & 31;
    unsigned long long val = 0;
    for (int j = 0; j < A; ++j)
      val |= (unsigned long long)((sw[j * W + wi] >> sh) & 1u) << j;
    o[r] = (long long)val;
  }
}

}  // namespace

// Write operand v (strides sq, sr, sk in elements) onto columns cols
// (K, nb) of crossbars [lo, hi) of state part, whose first crossbar is
// crossbar lo.  Returns a cudaError_t.
extern "C" int pim_bits_write_launch(const void* v, long long sq,
                                     long long sr, long long sk,
                                     const void* cols, int K, int nb,
                                     void* part, int lo, int hi, int n_cb,
                                     int rows, long long m, long long o,
                                     int of_x, int n, int W, void* stream) {
  if (K < 0 || nb < 1 || nb > MAX_BITS || lo < 0 || hi < lo || n_cb < 1 ||
      rows < 1 || m < 1 || o < 1 || n < 1 || W != (rows + 31) / 32 ||
      (long long)K * nb > n)
    return (int)cudaErrorInvalidValue;
  if (hi == lo || K == 0) return (int)cudaSuccess;
  const int vec = W % 4 == 0 && reinterpret_cast<uintptr_t>(part) % 16 == 0;
  const int warps = W < WRITE_WARPS ? W : WRITE_WARPS;
  const size_t smem = (size_t)PASS_TERMS * nb * (W | 1) * sizeof(int32_t);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        pim_bits_write_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  pim_bits_write_kernel<<<hi - lo, warps * 32, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(v), sq, sr, sk,
      static_cast<const int32_t*>(cols), K, nb, static_cast<int32_t*>(part),
      lo, n_cb, rows, m, o, of_x, n, W, vec);
  return (int)cudaGetLastError();
}

// Read the A accumulator columns acc of state (C, n, W) into out (C, rows)
// int64.  Returns a cudaError_t.
extern "C" int pim_bits_read_launch(const void* state, const void* acc,
                                    int A, int C, int n, int W, int rows,
                                    void* out, void* stream) {
  if (A < 0 || A > MAX_ACC || C < 0 || n < 1 || rows < 1 ||
      W != (rows + 31) / 32)
    return (int)cudaErrorInvalidValue;
  if (C == 0) return (int)cudaSuccess;
  const int rounded = (rows + 31) / 32 * 32;
  const int threads = rounded < READ_THREADS ? rounded : READ_THREADS;
  const size_t smem = (size_t)A * W * sizeof(uint32_t);
  pim_bits_read_kernel<<<C, threads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(state), static_cast<const int32_t*>(acc), A,
      n, W, rows, static_cast<long long*>(out));
  return (int)cudaGetLastError();
}

extern "C" const char* pim_bits_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
