// Kernel K3: embedding row gather through a ring of k row copies in flight.
//
//   out[b, :] = table[clamp(ids[b], 0, n_rows - 1), :]
//
// Replaces the Pallas kernel mamdr_tpu/ops/embedding_lookup.py:103
// (pallas_gather_rows_pipelined, call :149): one grid step that starts k
// HBM->VMEM row DMAs on k semaphores and then, as copy i completes,
// re-issues copy i+k on the freed slot, the whole [B, D] output staying
// VMEM-resident. It is a probe of the gather's cost (the rate of starting copies, or
// the depth in flight?), run by mamdr_tpu_torch/probe_gather.py and by no
// training path, as in the JAX package.
//
// Bound on an H100 SXM: bytes, as K2's: a 1024-row lookup of 128-d float32
// rows moves about 1.05 MB, 0.31 us at 3.35 TB/s, and does no arithmetic.
//
// Design. The ring is k slots of one row each in dynamic shared memory,
// filled by asynchronous global->shared copies (cp.async, 16 bytes a
// thread) and drained to the output in device memory: the TPU kernel's
// VMEM-resident output (512 KB at the probe's shapes) has no counterpart in
// 227 KB of shared memory, so the output streams out as slots complete. A
// block owns kRounds*k consecutive rows: row i of the block lands in slot
// i % k, and when the copy of row i has completed the slot is written out and
// re-armed with row i + k — wait(i), start(i + k), as the Pallas loop does.
// The slots are dealt round-robin to the block's warps (at most 32), and a
// warp drives its slots as its own ring: each lane copies the same 16-byte
// pieces of a row that it later reads back and stores, so a copy's
// completion (cp.async.wait_group, which counts a thread's own copy groups)
// is all the synchronisation the ring needs, with no barrier between warps.
// One commit group per row keeps group i and row i aligned; past the end of
// the block's rows the groups are empty. Unlike the Pallas kernel, which does
// not clip (an out-of-range id is an out-of-bounds DMA there), ids are
// clamped as K2 clamps them.
//
// C interface for ctypes: returns the cudaError_t of the launch.

#include <cuda_runtime.h>

namespace {

constexpr int kRounds = 4;      // rows per block = kRounds * k: each slot is re-armed 3 times
constexpr int kMaxWarps = 32;
constexpr int kMaxSharedBytes = 232448;  // 227 KB: the most a block may opt into on sm_90

__device__ __forceinline__ void cp_async_16(float4* smem_dst, const float4* src) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `pending` of this thread's newest copy groups are still
// in flight. The instruction takes an immediate; waiting for more than asked
// (the default) is always correct.
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
#define MAMDR_WAIT_CASE(n) \
  case n:                  \
    asm volatile("cp.async.wait_group " #n ";\n" ::: "memory"); \
    break;
    MAMDR_WAIT_CASE(1)
    MAMDR_WAIT_CASE(2)
    MAMDR_WAIT_CASE(3)
    MAMDR_WAIT_CASE(4)
    MAMDR_WAIT_CASE(5)
    MAMDR_WAIT_CASE(6)
    MAMDR_WAIT_CASE(7)
    MAMDR_WAIT_CASE(8)
    MAMDR_WAIT_CASE(9)
    MAMDR_WAIT_CASE(10)
    MAMDR_WAIT_CASE(11)
    MAMDR_WAIT_CASE(12)
    MAMDR_WAIT_CASE(13)
    MAMDR_WAIT_CASE(14)
    MAMDR_WAIT_CASE(15)
#undef MAMDR_WAIT_CASE
    default:
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  }
}

__global__ void gather_rows_pipelined_kernel(const float4* __restrict__ table,
                                             const int* __restrict__ ids,
                                             float4* __restrict__ out, int n_rows,
                                             int d4, int batch, int k) {
  extern __shared__ float4 ring[];  // [k][d4]
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int n_warps = blockDim.x / 32;
  const int row0 = blockIdx.x * kRounds * k;
  const int rows = min(batch - row0, kRounds * k);  // this block's rows
  // this warp's slots: warp, warp + n_warps, ... below k
  const int my_slots = (k - warp + n_warps - 1) / n_warps;
  if (my_slots <= 0) return;
  const int my_rows_max = kRounds * my_slots;

  // The warp's t-th row: round t / my_slots, its slot number t % my_slots.
  auto slot_of = [&](int t) { return warp + (t % my_slots) * n_warps; };
  auto row_of = [&](int t) { return (t / my_slots) * k + slot_of(t); };
  auto start = [&](int t) {
    const int r = t < my_rows_max ? row_of(t) : rows;
    if (r < rows) {
      int id = ids[row0 + r];
      id = id < 0 ? 0 : (id >= n_rows ? n_rows - 1 : id);
      const float4* src = table + static_cast<long long>(id) * d4;
      float4* dst = ring + static_cast<long long>(slot_of(t)) * d4;
      for (int c = lane; c < d4; c += 32) cp_async_16(dst + c, src + c);
    }
    cp_async_commit();  // one group per row, empty past the end
  };

  for (int t = 0; t < my_slots; ++t) start(t);
  for (int t = 0; t < my_rows_max; ++t) {
    const int r = row_of(t);
    if (r >= rows) break;  // rows only grow with t within a round; later rounds too
    cp_async_wait(my_slots - 1);  // the copy of row t has landed
    const float4* src = ring + static_cast<long long>(slot_of(t)) * d4;
    float4* dst = out + static_cast<long long>(row0 + r) * d4;
    for (int c = lane; c < d4; c += 32) dst[c] = src[c];
    start(t + my_slots);  // the freed slot takes the row k further on
  }
  cp_async_wait(0);
}

}  // namespace

// The ring takes k * dim * 4 bytes of shared memory; a k that does not fit a
// block's 227 KB is refused (the wrapper raises before it gets here).
extern "C" int mamdr_gather_rows_pipelined(const void* table, const void* ids,
                                           void* out, int n_rows, int dim,
                                           int batch, int k, void* stream) {
  const long long smem = static_cast<long long>(k) * dim * 4;
  if (k < 1 || smem > kMaxSharedBytes) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        gather_rows_pipelined_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // about four slots a warp, at most 32 warps
  int warps = (k + 3) / 4;
  warps = warps > kMaxWarps ? kMaxWarps : warps;
  const int rows_per_block = kRounds * k;
  const int blocks = (batch + rows_per_block - 1) / rows_per_block;
  gather_rows_pipelined_kernel<<<blocks, warps * 32, static_cast<size_t>(smem),
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(table), static_cast<const int*>(ids),
      static_cast<float4*>(out), n_rows, dim / 4, batch, k);
  return static_cast<int>(cudaGetLastError());
}
