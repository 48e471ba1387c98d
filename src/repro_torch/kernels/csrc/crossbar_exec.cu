// Crossbar microcode executor for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/crossbar_exec/
// crossbar_exec.py:_kernel / crossbar_exec: run flat microcode (G, 4) int32
// rows (code, ia, ib, dst) over bit-packed crossbar state (C, n, W) (the
// reference's uint32 words, held here as int32 with the same bits).  Codes:
// 0 INIT (all ones), 1 NOT, 2 NOR, 3 OR, 4 NAND, 5 AND; each row reads
// bitline columns ia and ib across all row-words and writes column dst.
//
// Bound on an H100: the state crosses device memory once each way (32 KiB
// per crossbar at n = 1024, W = 8) and every gate is 3 int32 operations per
// row-word, so neither bytes nor operations bind: the kernel is bound by
// the latency of its serial gate chain.  Gate g may read what gate g-1
// wrote, so one row-word's gates run strictly in order, each a shared-
// memory load, an ALU op and a shared-memory store.  What the design does:
// row-words are independent and every crossbar of a launch runs the same
// microcode, so each thread owns one row-word; a block keeps the whole
// (n x W) state of one or more crossbars resident in dynamic shared memory
// (column-major across the block's crossbars, so the threads of a warp
// touch consecutive words of one column: conflict-free), streams the
// microcode through shared memory in chunks of MC_CHUNK rows as a uniform
// broadcast (read into registers OPS_AHEAD rows at a time, so the row
// loads leave the gate chain), and writes the state back once at the end.  The TPU's
// (n x 128-word) tile (512 KiB) does not fit a block's 227 KB; a block here
// holds at most 6 crossbars of 32 KiB.  The host side batches every
// crossbar of every K-chunk that shares one program into one launch.
// Column indices are validated by the wrapper, once per microcode.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MC_CHUNK = 512;  // microcode rows staged per pass (8 KiB)
constexpr int OPS_AHEAD = 8;   // rows read into registers ahead of the chain

// One gate on this thread's row-word.  Branch-free: with orm = -1 for the
// OR family, (a & b) | ((a ^ b) & orm) is a | b, else a & b; NOT reads
// b = a; INIT forces all ones; the inverting gates flip the result.  The
// masks depend on the code only, off the a/b load -> store chain.
__device__ __forceinline__ void gate(int32_t* st, const int4 op, int stride,
                                     int t) {
  const int c = op.x;
  const int32_t orm = (c >= 1 && c <= 3) ? -1 : 0;
  const int32_t force = (c == 0) ? -1 : 0;
  const int32_t inv = (c == 1 || c == 2 || c == 4) ? -1 : 0;
  const int ib = (c <= 1) ? op.y : op.z;
  const int32_t a = st[op.y * stride + t];
  const int32_t b = st[ib * stride + t];
  st[op.w * stride + t] = (((a & b) | ((a ^ b) & orm)) | force) ^ inv;
}

__global__ void crossbar_exec_kernel(const int4* __restrict__ mc, int n_ops,
                                     const int32_t* __restrict__ state_in,
                                     int32_t* __restrict__ state_out, int C,
                                     int n, int W, int cb_per_block) {
  extern __shared__ __align__(16) int32_t smem[];
  int4* mcs = reinterpret_cast<int4*>(smem);
  int32_t* st = smem + 4 * MC_CHUNK;  // st[col * stride + cb * W + w]
  const int c0 = blockIdx.x * cb_per_block;
  const int ncb = min(cb_per_block, C - c0);
  const int stride = cb_per_block * W;  // words per column in the block
  const int slab = n * W;               // words per crossbar
  const int t = threadIdx.x;            // (crossbar, word) = (t / W, t % W)
  const bool live = t < ncb * W;
  const size_t base = (size_t)c0 * slab;
  const int total = ncb * slab;

  for (int i = t; i < total; i += blockDim.x) {
    const int cb = i / slab, rem = i - cb * slab, col = rem / W;
    st[col * stride + cb * W + (rem - col * W)] = state_in[base + i];
  }
  __syncthreads();
  for (int g0 = 0; g0 < n_ops; g0 += MC_CHUNK) {
    const int cnt = min(MC_CHUNK, n_ops - g0);
    for (int i = t; i < cnt; i += blockDim.x) mcs[i] = mc[g0 + i];
    __syncthreads();
    if (live) {
      int g = 0;
      for (; g + OPS_AHEAD <= cnt; g += OPS_AHEAD) {
        int4 ops[OPS_AHEAD];
#pragma unroll
        for (int j = 0; j < OPS_AHEAD; ++j) ops[j] = mcs[g + j];
#pragma unroll
        for (int j = 0; j < OPS_AHEAD; ++j) gate(st, ops[j], stride, t);
      }
      for (; g < cnt; ++g) gate(st, mcs[g], stride, t);
    }
    __syncthreads();
  }
  for (int i = t; i < total; i += blockDim.x) {
    const int cb = i / slab, rem = i - cb * slab, col = rem / W;
    state_out[base + i] = st[col * stride + cb * W + (rem - col * W)];
  }
}

}  // namespace

// Crossbars per block for this launch (0 if one crossbar does not fit).
extern "C" int crossbar_exec_block_crossbars(int C, int n, int W) {
  int dev = 0, smem_optin = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  cudaDeviceGetAttribute(&smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long slab = (long)n * W * sizeof(int32_t);
  const long room = (long)smem_optin - 16L * MC_CHUNK;
  int cb_max = slab > 0 ? (int)(room / slab) : 0;
  if (W > 0 && cb_max > 1024 / W) cb_max = 1024 / W;
  if (cb_max < 1) return 0;
  const int spread = sms > 0 ? (C + sms - 1) / sms : 1;  // fill every SM
  return spread < 1 ? 1 : (spread < cb_max ? spread : cb_max);
}

extern "C" int crossbar_exec_launch(const void* mc, int n_ops,
                                    const void* state_in, void* state_out,
                                    int C, int n, int W, void* stream) {
  if (C <= 0 || n <= 0 || W <= 0 || n_ops < 0) return (int)cudaErrorInvalidValue;
  const int cb = crossbar_exec_block_crossbars(C, n, W);
  if (cb < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = 16 * (size_t)MC_CHUNK + (size_t)cb * n * W * sizeof(int32_t);
  cudaError_t e = cudaFuncSetAttribute(
      crossbar_exec_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (C + cb - 1) / cb;
  crossbar_exec_kernel<<<blocks, cb * W, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(mc), n_ops,
      static_cast<const int32_t*>(state_in), static_cast<int32_t*>(state_out),
      C, n, W, cb);
  return (int)cudaGetLastError();
}

extern "C" const char* crossbar_exec_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
