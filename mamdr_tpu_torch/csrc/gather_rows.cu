// Kernel K2: embedding row gather with clip semantics.
//
//   out[b, :] = table[clamp(ids[b], 0, n_rows - 1), :]
//
// Replaces the Pallas row gather mamdr_tpu/ops/embedding_lookup.py:56
// (pallas_gather_rows: rows DMA'd HBM->VMEM eight per grid step, ids
// scalar-prefetched, no clip) and serves the port's embedding_lookup, whose
// JAX counterpart is jnp.take(mode="clip") (embedding_lookup.py:53).
//
// Bound on an H100 SXM: bytes. A 1024-row lookup of 128-d float32 rows
// reads 4 KB of ids and 512 KB of rows and writes 512 KB: about 1.05 MB,
// 0.31 us at 3.35 TB/s; it does no arithmetic to speak of. The design does
// what the TPU kernel's DMAs did, in the shape the card wants: one warp per
// row, each lane moving 16 bytes per load and store (float4), so a 512-byte
// row is one fully coalesced 32-lane transaction. Each warp loads its own
// id (no scalar prefetch) and clamps it in the kernel.
//
// C interface for ctypes: returns the cudaError_t of the launch.

#include <cuda_runtime.h>

namespace {

constexpr int kRowsPerBlock = 8;  // 8 warps = 256 threads

__global__ void gather_rows_kernel(const float4* __restrict__ table,
                                   const int* __restrict__ ids,
                                   float4* __restrict__ out, int n_rows,
                                   int d4, int batch) {
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= batch) return;
  int id = ids[row];
  id = id < 0 ? 0 : (id >= n_rows ? n_rows - 1 : id);
  const float4* src = table + static_cast<long long>(id) * d4;
  float4* dst = out + static_cast<long long>(row) * d4;
  for (int c = lane; c < d4; c += 32) dst[c] = src[c];
}

}  // namespace

extern "C" int mamdr_gather_rows(const void* table, const void* ids, void* out,
                                 int n_rows, int dim, int batch,
                                 void* stream) {
  const int blocks = (batch + kRowsPerBlock - 1) / kRowsPerBlock;
  gather_rows_kernel<<<blocks, kRowsPerBlock * 32, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(table), static_cast<const int*>(ids),
      static_cast<float4*>(out), n_rows, dim / 4, batch);
  return static_cast<int>(cudaGetLastError());
}
