// Crossbar microcode executor for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/crossbar_exec/
// crossbar_exec.py:_kernel / crossbar_exec: run microcode rows (code, ia,
// ib, dst) over bit-packed crossbar state (C, n, W) (the reference's uint32
// words, held here as int32 with the same bits).  Codes: 0 INIT (all
// ones), 1 NOT, 2 NOR, 3 OR, 4 NAND, 5 AND; each row reads bitline columns
// ia and ib across all row-words and writes column dst.
//
// The host (kernels/crossbar_exec/schedule.py) hands the kernel the
// microcode as fixed-width groups of GROUP gates that are independent: no
// gate of a group writes a column that another gate of the group reads or
// writes.  That group structure is the partitions' parallelism: the gates
// of one operation act on disjoint sections of the crossbar, and
// neighbouring operations often do too.  So the gates of a group may run
// in any order, on any thread, and only consecutive groups need a barrier
// between them.  Each gate is ((a & b) | ((a | b) & orm)) ^ inv over
// columns a and b, with INIT as NOR of an extra all-zero column n with
// itself, NOT as NOR(ia, ia), and short groups padded with AND of column n
// into itself.  Column n lives in shared memory only and is never written
// back.
//
// What bounds it on an H100.  The card's floor (PERF.md) is tens of
// microseconds: the state crosses device memory once each way (32 KiB per
// crossbar at n = 1024, W = 8) and a gate is one logic operation per
// row-word.  This design's floors are higher.  Every gate runs over every
// row-word of the launch through shared memory: 12 bytes per gate per
// row-word (two loads, one store), about 40 row-words per SM at the decode
// shape, so 86,320 gates move 41 MB per SM, about 160 us at 128 bytes per
// clock.  And the groups run in order, one barrier apart: each group is a
// chain of barrier, state loads, logic and stores, whatever the row-words.
// One warp per SM doing every gate (one thread per row-word) would also
// leave three of the SM's four schedulers idle, and a warp issues shared
// memory instructions only every few cycles.  So each block's WARPS warps
// each serve all of the block's row-words (LANE_WORDS adjacent words per
// lane, one 64-bit access) and split every group: warp w runs gates
// w * PER_WARP .. (w + 1) * PER_WARP - 1, then the block meets at a
// barrier.  Per group a warp issues 3 record loads, 12 state loads and 6
// state stores, and the next groups' records are read and decoded while
// this group's loads are in flight.  GROUP = 24 measured fastest of 16, 24
// and 32 (wider groups meet at fewer barriers but carry more no-op
// padding).  What the design keeps: a block holds the whole (n + 1) x W
// state of up to 6 crossbars in dynamic shared memory (loaded with
// cp.async, every load in flight at once), column-major across the block's
// crossbars (the lanes of a warp touch consecutive words of one column:
// conflict-free); the group records stream through shared memory as a
// broadcast, in chunks of CHUNK groups, double-buffered with cp.async so
// the next chunk arrives while this one runs; the state is read once and
// written once.  Column indices are validated by the wrapper, once per
// microcode.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int GROUP = 24;                 // gates per group (schedule.py)
constexpr int WARPS = 4;                  // warps per block, one per scheduler
constexpr int PER_WARP = GROUP / WARPS;   // gates per warp per group
constexpr int SLICE = 2 * PER_WARP;       // int32 per warp per group record
constexpr int REC = WARPS * SLICE;        // int32 per group record
constexpr int CHUNK = 32;                 // groups per staged chunk
constexpr int CHUNK_WORDS = CHUNK * REC;  // 6 KiB per staging buffer
// two staging buffers, then room for the two records the pipeline reads
// past the end of a chunk
constexpr int STAGE_WORDS = 2 * CHUNK_WORDS + 2 * REC;
constexpr int STAGE_BYTES = STAGE_WORDS * 4;
constexpr int LANE_WORDS = 2;             // row-words per lane
constexpr int ROW_WORDS = 32 * LANE_WORDS;  // most row-words per block

static_assert(SLICE % 4 == 0, "a warp's record slice is whole int4s");

__device__ __forceinline__ int2 lds64(uint32_t addr) {
  int2 v;
  asm volatile("ld.shared.v2.b32 {%0, %1}, [%2];"
               : "=r"(v.x), "=r"(v.y)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ void sts64(uint32_t addr, int2 v) {
  asm volatile("st.shared.v2.b32 [%0], {%1, %2};" ::"r"(addr), "r"(v.x),
               "r"(v.y)
               : "memory");
}

__device__ __forceinline__ void cp_async16(int32_t* dst, const int32_t* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(int32_t* dst, const int32_t* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Copy chunk k of the group records into a staging buffer (async).
__device__ __forceinline__ void stage(int32_t* buf, const int32_t* groups,
                                      int n_groups, int k) {
  const int g0 = k * CHUNK;
  const int vecs = min(CHUNK, n_groups - g0) * (REC / 4);
  const int32_t* src = groups + (size_t)g0 * REC;
  for (int i = threadIdx.x; i < vecs; i += blockDim.x)
    cp_async16(buf + 4 * i, src + 4 * i);
}

// A warp's slice of one group record holds per gate the words a | b << 16
// and dst | orm << 30 | inv << 31 (one bit per mask), so that a warp reads
// its slice in SLICE / 4 loads.
__device__ __forceinline__ void read_slice(int (&v)[SLICE],
                                           const int32_t* rec) {
#pragma unroll
  for (int q = 0; q < SLICE / 4; ++q) {
    const int4 x = reinterpret_cast<const int4*>(rec)[q];
    v[4 * q] = x.x;
    v[4 * q + 1] = x.y;
    v[4 * q + 2] = x.z;
    v[4 * q + 3] = x.w;
  }
}

// A decoded slice: the shared byte addresses of this lane's words in its
// gates' columns a, b, dst, and the gates' masks.
struct Gates {
  uint32_t a[PER_WARP], b[PER_WARP], d[PER_WARP];
  int32_t orm[PER_WARP], inv[PER_WARP];
};

__device__ __forceinline__ void decode(Gates& s, const int (&v)[SLICE],
                                       uint32_t sb, uint32_t s4) {
#pragma unroll
  for (int j = 0; j < PER_WARP; ++j) {
    const uint32_t ab = v[j], dm = v[PER_WARP + j];
    s.a[j] = sb + (ab & 0xffffu) * s4;
    s.b[j] = sb + (ab >> 16) * s4;
    s.d[j] = sb + (dm & 0xffffu) * s4;
    s.orm[j] = static_cast<int32_t>(dm << 1) >> 31;
    s.inv[j] = static_cast<int32_t>(dm) >> 31;
  }
}

__device__ __forceinline__ int32_t gate(int32_t a, int32_t b, int32_t orm,
                                        int32_t inv) {
  return ((a & b) | ((a | b) & orm)) ^ inv;
}

// Run cnt groups from rec: this warp's gates of each group on this lane's
// words (sb: the shared byte address of the lane's words in column 0; s4:
// the bytes between two columns), a barrier after each group.  The loop is
// software-pipelined: a group's state loads issue first, from addresses
// decoded in the previous iteration; the slice two groups ahead is read,
// and the next one decoded, while they are in flight.  (Past the last
// group of a chunk they read the next buffer or the spare room after the
// buffers, and the values go unused.)
__device__ __forceinline__ void run_chunk(const int32_t* rec, int cnt,
                                          uint32_t sb, uint32_t s4) {
  rec += (threadIdx.x / 32) * SLICE;
  int raw[SLICE];
  Gates cur;
  read_slice(raw, rec);
  decode(cur, raw, sb, s4);
  read_slice(raw, rec + REC);
#pragma unroll 2
  for (int g = 0; g < cnt; ++g, rec += REC) {
    int2 a[PER_WARP], b[PER_WARP];
#pragma unroll
    for (int j = 0; j < PER_WARP; ++j) {
      a[j] = lds64(cur.a[j]);
      b[j] = lds64(cur.b[j]);
    }
    int ahead[SLICE];
    read_slice(ahead, rec + 2 * REC);
    Gates nxt;
    decode(nxt, raw, sb, s4);
#pragma unroll
    for (int j = 0; j < PER_WARP; ++j)
      sts64(cur.d[j],
            make_int2(gate(a[j].x, b[j].x, cur.orm[j], cur.inv[j]),
                      gate(a[j].y, b[j].y, cur.orm[j], cur.inv[j])));
    cur = nxt;
#pragma unroll
    for (int q = 0; q < SLICE; ++q) raw[q] = ahead[q];
    __syncthreads();
  }
}

__global__ void __launch_bounds__(WARPS * 32)
crossbar_exec_kernel(const int32_t* __restrict__ groups, int n_groups,
                     const int32_t* __restrict__ state_in,
                     int32_t* __restrict__ state_out, int C, int n, int W,
                     int cb_per_block) {
  extern __shared__ __align__(16) int32_t smem[];
  int32_t* st = smem + STAGE_WORDS;  // st[col * stride + cb * W + w]
  const int c0 = blockIdx.x * cb_per_block;
  const int ncb = min(cb_per_block, C - c0);
  // words per column in the block: whole lanes, so every 64-bit access is
  // aligned; the padding words are never written back
  const int stride = (cb_per_block * W + LANE_WORDS - 1) / LANE_WORDS *
                     LANE_WORDS;
  const int slab = n * W;               // words per crossbar
  const int t = threadIdx.x;
  const int lane = t % 32;              // words LANE_WORDS * lane, + 1
  const size_t base = (size_t)c0 * slab;
  const int total = ncb * slab;
  const int n_chunks = (n_groups + CHUNK - 1) / CHUNK;

  // The state arrives by cp.async too, 16 bytes at a time where a
  // crossbar's W words of a column are whole aligned vectors: the block's
  // threads then keep every load in flight at once.
  const bool vec = W % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(state_in) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(state_out) % 16 == 0;
  const int step = vec ? 4 : 1;
  if (n_chunks > 0) stage(smem, groups, n_groups, 0);
  for (int e = step * t; e < total; e += step * blockDim.x) {
    const int cb = e / slab, rem = e - cb * slab, col = rem / W;
    int32_t* dst = st + col * stride + cb * W + (rem - col * W);
    if (vec)
      cp_async16(dst, state_in + base + e);
    else
      cp_async4(dst, state_in + base + e);
  }
  cp_async_commit();
  for (int i = t; i < stride; i += blockDim.x) st[n * stride + i] = 0;

  // a lane past the block's row-words mirrors lane 0: it loads and
  // stores lane 0's words, with lane 0's values, in the same instructions
  const bool active = LANE_WORDS * lane < ncb * W;
  const uint32_t sb = static_cast<uint32_t>(
      __cvta_generic_to_shared(st + (active ? LANE_WORDS * lane : 0)));
  const uint32_t s4 = 4u * stride;
  for (int k = 0; k < n_chunks; ++k) {
    if (k + 1 < n_chunks) {
      stage(smem + ((k + 1) & 1) * CHUNK_WORDS, groups, n_groups, k + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    run_chunk(smem + (k & 1) * CHUNK_WORDS, min(CHUNK, n_groups - k * CHUNK),
              sb, s4);
  }
  cp_async_wait<0>();
  __syncthreads();
  for (int e = step * t; e < total; e += step * blockDim.x) {
    const int cb = e / slab, rem = e - cb * slab, col = rem / W;
    const int32_t* src = st + col * stride + cb * W + (rem - col * W);
    if (vec)
      *reinterpret_cast<int4*>(state_out + base + e) =
          *reinterpret_cast<const int4*>(src);
    else
      state_out[base + e] = *src;
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
  // (n + 1) columns of cb * W words, plus up to LANE_WORDS - 1 padding
  const long per_cb = (long)(n + 1) * W * sizeof(int32_t);
  const long room = (long)smem_optin - STAGE_BYTES -
                    (long)(n + 1) * (LANE_WORDS - 1) * sizeof(int32_t);
  int cb_max = per_cb > 0 ? (int)(room / per_cb) : 0;
  if (W > 0 && cb_max > ROW_WORDS / W) cb_max = ROW_WORDS / W;
  if (cb_max < 1) return 0;
  const int spread = sms > 0 ? (C + sms - 1) / sms : 1;  // fill every SM
  return spread < 1 ? 1 : (spread < cb_max ? spread : cb_max);
}

// Run n_groups group records of width `width` (it must be GROUP) over
// state_in (C, n, W) into state_out.  Returns a cudaError_t.
extern "C" int crossbar_exec_launch(const void* groups, int n_groups,
                                    int width, const void* state_in,
                                    void* state_out, int C, int n, int W,
                                    void* stream) {
  if (C <= 0 || n <= 0 || W <= 0 || n_groups < 0 || width != GROUP)
    return (int)cudaErrorInvalidValue;
  const int cb = crossbar_exec_block_crossbars(C, n, W);
  if (cb < 1) return (int)cudaErrorInvalidValue;
  const int stride = (cb * W + LANE_WORDS - 1) / LANE_WORDS * LANE_WORDS;
  const size_t smem = STAGE_BYTES + (size_t)(n + 1) * stride * sizeof(int32_t);
  cudaError_t e = cudaFuncSetAttribute(
      crossbar_exec_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (C + cb - 1) / cb;
  crossbar_exec_kernel<<<blocks, WARPS * 32, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(groups), n_groups,
      static_cast<const int32_t*>(state_in), static_cast<int32_t*>(state_out),
      C, n, W, cb);
  return (int)cudaGetLastError();
}

extern "C" const char* crossbar_exec_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
