// Kernel K3: embedding row gather through rings of bulk row copies in flight.
//
//   out[b, :] = table[clamp(ids[b], 0, n_rows - 1), :]
//
// Replaces the Pallas kernel mamdr_tpu/ops/embedding_lookup.py:103
// (pallas_gather_rows_pipelined, call :149): one grid step on one core that
// starts k HBM->VMEM row DMAs on k semaphores and then, as copy i completes,
// re-issues copy i+k on the freed slot. It is a probe of the gather's cost
// (the rate of starting copies, or the depth in flight?), run by
// mamdr_tpu_torch/probe_gather.py and by no training path, as in the JAX
// package.
//
// Bound on an H100 SXM: bytes, as K2's: a 1024-row lookup of 128-d float32
// rows moves about 1.05 MB, 0.31 us at 3.35 TB/s, and does no arithmetic.
// What a gather of this size really pays is latency: a launch, an id load,
// a row load and a row store, each dependent on the one before.
//
// Design. The TPU kernel's single ring is one core's; this card has 132
// SMs and a copy engine on each, so the ring is dealt over the card: the
// grid has a few blocks per SM (four, as the wrapper plans it: with one,
// 30720 ids took 24 us, with four 11), a block owns a contiguous run of rows
// and a ring of min(k, its rows) one-row slots in dynamic shared memory,
// each slot with its own mbarrier. k is the depth in flight PER BLOCK. The
// copies belong to the copy engine (the counterpart of
// pltpu.make_async_copy on a DMA semaphore): a row comes in as one
// cp.async.bulk.shared::cluster.global copy that completes on the slot's
// mbarrier (armed with mbarrier.arrive.expect_tx for the row's bytes), and
// when the barrier flips the same thread sends the slot out with one
// cp.async.bulk.global.shared::cta store to out[i]; once that store has read
// the slot (cp.async.bulk.wait_group.read) the slot is re-armed with row
// i + slots -- wait(i), start(i + k), as the Pallas loop does. No row passes
// through registers. The block is a few issuing threads (kIssuers: 128);
// thread t drives slots t, t + 128, ... as its own ring
// (bulk groups and the waits on them are per thread), so a block's copies
// are started side by side and no barrier between threads is needed after
// the mbarriers are set up. Unlike the Pallas kernel, which does not clip (an
// out-of-range id is an out-of-bounds DMA there), ids are clamped as K2
// clamps them.
//
// C interface for ctypes: returns the cudaError_t of the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Issuing threads a block. 128 measured best of 1, 32 and 128 on an H100
// (mamdr_tpu_torch/probe_gather.py --sweep, which builds the other two with -D).
#ifndef MAMDR_K3_ISSUERS
#define MAMDR_K3_ISSUERS 128
#endif
constexpr int kIssuers = MAMDR_K3_ISSUERS;
constexpr int kMaxSharedBytes = 232448;  // 227 KB: the most a block may opt into on sm_90

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Spin until the barrier's phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// One row, device memory -> the slot; completes on the slot's mbarrier.
__device__ __forceinline__ void bulk_load(void* slot, const void* src, int bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(slot)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// The slot -> one row of the output; one bulk group per store.
__device__ __forceinline__ void bulk_store(void* dst, const void* slot, int bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(smem_addr(slot)), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// ring: [slots][row_bytes] of rows, then [slots] mbarriers (8-byte aligned:
// row_bytes is a multiple of 16).
__global__ void __launch_bounds__(kIssuers)
gather_rows_pipelined_kernel(const char* __restrict__ table, const int* __restrict__ ids,
                             char* __restrict__ out, int n_rows, int row_bytes, int batch,
                             int rows_per_block, int slots) {
  extern __shared__ __align__(128) char ring[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + static_cast<size_t>(slots) * row_bytes);
  const int t = threadIdx.x;
  const int row0 = blockIdx.x * rows_per_block;
  const int rows = min(batch - row0, rows_per_block);  // this block's rows

  for (int s = t; s < slots; s += kIssuers) mbar_init(&bars[s], 1);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();

  auto start = [&](int r) {  // row r of the block into slot r % slots
    const int s = r % slots;
    int id = ids[row0 + r];
    id = id < 0 ? 0 : (id >= n_rows ? n_rows - 1 : id);
    mbar_expect_tx(&bars[s], row_bytes);
    bulk_load(ring + static_cast<size_t>(s) * row_bytes,
              table + static_cast<size_t>(id) * row_bytes, row_bytes, &bars[s]);
  };

  // this thread's slots, each with its first row
  for (int s = t; s < slots && s < rows; s += kIssuers) start(s);
  // then its rows in order: turn 0 of each of its slots, turn 1, ...
  for (int turn = 0; turn * slots < rows; ++turn) {
    for (int s = t; s < slots; s += kIssuers) {
      const int r = turn * slots + s;
      if (r >= rows) break;
      mbar_wait(&bars[s], turn & 1);  // row r has landed
      bulk_store(out + static_cast<size_t>(row0 + r) * row_bytes,
                 ring + static_cast<size_t>(s) * row_bytes, row_bytes);
      if (r + slots < rows) {
        // the store must have read the slot before the next row lands in it
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        start(r + slots);
      }
    }
  }
  // the ring must outlive the stores that read it
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

}  // namespace

// The wrapper plans the launch (ring_plan in ops/embedding_lookup.py): a
// block owns rows_per_block consecutive rows and a ring of `slots` rows,
// slots * (dim * 4 + 8) bytes of shared memory, refused if it does not fit a
// block's 227 KB. A row's byte length must be a multiple of 16.
extern "C" int mamdr_gather_rows_pipelined(const void* table, const void* ids,
                                           void* out, int n_rows, int dim, int batch,
                                           int rows_per_block, int slots, void* stream) {
  const long long row_bytes = static_cast<long long>(dim) * 4;
  const long long smem = static_cast<long long>(slots) * (row_bytes + 8);
  if (slots < 1 || rows_per_block < slots || batch < 1 || row_bytes % 16 != 0 ||
      smem > kMaxSharedBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        gather_rows_pipelined_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (batch + rows_per_block - 1) / rows_per_block;
  gather_rows_pipelined_kernel<<<blocks, kIssuers, static_cast<size_t>(smem),
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const char*>(table), static_cast<const int*>(ids),
      static_cast<char*>(out), n_rows, static_cast<int>(row_bytes), batch, rows_per_block,
      slots);
  return static_cast<int>(cudaGetLastError());
}
