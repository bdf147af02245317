// Kernel K2: the field gather that writes the tower input, with clip
// semantics per field and per lane.
//
//   out[l*B + b, off_f : off_f + D_f] =
//       table_f[l * lane_stride_f + clamp(ids_f[l*B + b], 0, N_f - 1), :]
//
// for up to four fields f, each a table of N_f rows of D_f float32 (one
// table every lane reads, lane_stride_f = 0, or a lane-stacked [L, N_f, D_f]
// table, lane_stride_f = N_f) and its int32 ids [L*B]. The output is one
// contiguous [L*B, sum D_f] array: the MLP tower's input x. For the fields the
// caller marks, the kernel also writes the flat row ids it read, int32 [L*B]
// (lane offset plus clamped id), which the backward's scatter-add takes.
//
// A field may carry a row window instead of the clamp (the row-sharded
// lookup, parallel/embedding_shard.py): the table is rows [row_lo, row_lo +
// N_f) of a larger one, and
//
//   mode 1 (window): id v reads table_f[lane + v - row_lo] when that row is
//     in the shard, else writes zeros, and its flat id is then the spare row
//     one past the field's table view (lanes * N_f stacked, N_f shared),
//     which the scatter-add drops;
//   mode 2 (silent): writes zeros, with the clamped flat id of mode 0 (a
//     replicated table that one rank of the shard group contributes, the
//     others read for the gradient only).
//
// Mode 0 is the clamp above, and the descriptor's default.
//
// Replaces the Pallas row gather mamdr_tpu/ops/embedding_lookup.py:56
// (pallas_gather_rows: rows DMA'd HBM->VMEM eight per grid step, ids
// scalar-prefetched, no clip), which the JAX package calls once per field
// before concatenating the fields (mamdr_tpu/ops/fused_mlp_step.py:252-255,
// mamdr_tpu/models/deepctr.py:92-94). The clip is jnp.take(mode="clip")'s
// (embedding_lookup.py:53).
//
// Bound on an H100 SXM: bytes, and at 1024 rows the latency of a launch. A
// train step's 1024 rows of three 128-d fields write 1.5 MB and read at most
// 1.5 MB of rows; a contiguous copy of 0.5 MB already takes about 1.4 us in a
// CUDA graph, so three launches of one field each (and a concat that reads
// and writes x again) paid that floor three times. Here one launch gathers
// every field: one warp per output row, across all fields. Lane f < fields
// loads field f's id (one round trip for all fields' ids, clamped in the
// kernel), the ids are shared by shuffles, and then every lane issues all of
// its float4 loads of the row (three 512-byte rows: three loads a lane)
// before any store: two dependent round trips a launch, not two a field.
// Neighbouring lanes read neighbouring 16 bytes of a row, so each field's row
// is one coalesced 512-byte access. At a DN step every row's domain id is the
// same: that field is read from L2. The grid is the wrapper's field_plan
// (ops/embedding_lookup.py): four warps a block, 256 blocks at 1024 rows,
// covering the card's 132 SMs (2 and 8 warps timed the same on an H100).
//
// The field descriptors travel by value in the kernel's parameter space: no
// descriptor array on the device and no allocation a call, so a launch can be
// captured in a CUDA graph. The launch is a programmatic dependent launch
// (programmatic stream serialization; griddepcontrol.wait before the first
// load): the grid may be launched while the kernel before it drains, which
// took 1024 rows from 2.3-2.5 to 2.0 us a call in a CUDA graph on an H100,
// with the same bits.
//
// C interface for ctypes: returns the cudaError_t of the launch.

#include <cuda_runtime.h>

// The descriptors have external linkage: the C entry takes a Plan*.
namespace mamdr_k2 {

constexpr int kMaxFields = 4;
constexpr int kMaxThreads = 128;  // a block: at most four warps, four output rows
constexpr int kUnroll = 4;        // float4 loads a lane holds before its stores

struct Field {
  const float4* table;  // [lanes or 1, n_rows, d4] float4
  const int* ids;       // [rows]
  int* flat;            // [rows] row ids read, or null
  int n_rows;           // rows of one lane's table
  int lane_stride;      // rows between lanes' tables: 0 (shared) or n_rows
  int d4;               // width in float4
  int off4;             // first output column, in float4
  int row_lo;           // mode 1: global row of this table's first row
  int mode;             // 0 clamp, 1 window (zeros outside), 2 silent (zeros)
};

// What the wrapper fills in (ops/embedding_lookup.py::_GatherPlan mirrors it).
struct Plan {
  Field field[kMaxFields];
  int n_fields;  // 1..kMaxFields, in output order: off4 ascending, no gap
  int batch;     // rows of one lane
  int rows;      // lanes * batch
  int out_d4;    // output row width in float4: the sum of the fields' d4
};

}  // namespace mamdr_k2

namespace {

using mamdr_k2::Field;
using mamdr_k2::kMaxFields;
using mamdr_k2::kMaxThreads;
using mamdr_k2::kUnroll;
using mamdr_k2::Plan;

__global__ void __launch_bounds__(kMaxThreads)
    gather_fields_kernel(const Plan p, float4* __restrict__ out) {
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= p.rows) return;  // whole warps only: the shuffles below see all 32
  // the kernel before may still be running: wait for its writes (the ids)
  asm volatile("griddepcontrol.wait;" ::: "memory");

  // Round trip 1: lane f < n_fields loads and clamps field f's id. The
  // field's descriptor is picked by constant indices (no dynamic index into
  // the parameter space, which would copy it to local memory).
  const int* ids = p.field[0].ids;
  int* flat = p.field[0].flat;
  int n_rows = p.field[0].n_rows, stride = p.field[0].lane_stride;
  int row_lo = p.field[0].row_lo, mode = p.field[0].mode;
#pragma unroll
  for (int f = 1; f < kMaxFields; ++f) {
    if (lane == f) {
      ids = p.field[f].ids;
      flat = p.field[f].flat;
      n_rows = p.field[f].n_rows;
      stride = p.field[f].lane_stride;
      row_lo = p.field[f].row_lo;
      mode = p.field[f].mode;
    }
  }
  int id = -1;  // the row read, -1 for zeros
  if (lane < p.n_fields) {
    const int v = __ldg(ids + row);
    const int base = (row / p.batch) * stride;
    int fid;
    if (mode == 1) {
      const long long local = static_cast<long long>(v) - row_lo;
      const bool in = local >= 0 && local < n_rows;
      // the spare row: one past the lanes' tables (stride n_rows) or the table
      fid = in ? base + static_cast<int>(local)
               : (stride != 0 ? (p.rows / p.batch) * stride : n_rows);
      id = in ? fid : -1;
    } else {
      fid = base + (v < 0 ? 0 : (v >= n_rows ? n_rows - 1 : v));
      id = mode == 0 ? fid : -1;
    }
    if (flat != nullptr) flat[row] = fid;
  }
  int rid[kMaxFields];
#pragma unroll
  for (int f = 0; f < kMaxFields; ++f) rid[f] = __shfl_sync(0xffffffffu, id, f);

  // Round trip 2: the row's float4 columns, kUnroll a lane in flight.
  float4* dst = out + static_cast<long long>(row) * p.out_d4;
  for (int c0 = 0; c0 < p.out_d4; c0 += 32 * kUnroll) {
    float4 v[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const int c = c0 + j * 32 + lane;
      if (c < p.out_d4) {
        const float4* table = p.field[0].table;
        int d4 = p.field[0].d4, off4 = 0, r = rid[0];
#pragma unroll
        for (int f = 1; f < kMaxFields; ++f) {
          if (f < p.n_fields && c >= p.field[f].off4) {
            table = p.field[f].table;
            d4 = p.field[f].d4;
            off4 = p.field[f].off4;
            r = rid[f];
          }
        }
        v[j] = r < 0 ? make_float4(0.f, 0.f, 0.f, 0.f)
                     : __ldg(table + static_cast<long long>(r) * d4 + (c - off4));
      }
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const int c = c0 + j * 32 + lane;
      if (c < p.out_d4) dst[c] = v[j];
    }
  }
}

}  // namespace

// sizeof(Plan): the wrapper checks its ctypes mirror against it.
extern "C" int mamdr_gather_fields_plan_bytes() { return static_cast<int>(sizeof(Plan)); }

// blocks x threads is the wrapper's field_plan: whole warps, one an output
// row, covering every row.
extern "C" int mamdr_gather_fields(const Plan* plan, int blocks, int threads, void* out,
                                   void* stream) {
  const Plan& p = *plan;
  if (p.n_fields < 1 || p.n_fields > kMaxFields || p.rows < 1 || p.batch < 1 ||
      p.rows % p.batch != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (threads < 32 || threads > kMaxThreads || threads % 32 != 0 || blocks < 1 ||
      static_cast<long long>(blocks) * (threads / 32) < p.rows)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  int off4 = 0;
  for (int f = 0; f < p.n_fields; ++f) {
    const Field& fd = p.field[f];
    if (fd.off4 != off4 || fd.d4 < 1 || fd.n_rows < 1 || fd.table == nullptr ||
        fd.ids == nullptr || fd.mode < 0 || fd.mode > 2)
      return static_cast<int>(cudaErrorInvalidValue);
    off4 += fd.d4;
  }
  if (off4 != p.out_d4) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t rc = cudaLaunchKernelEx(&cfg, gather_fields_kernel, p,
                                      static_cast<float4*>(out));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(cudaGetLastError());
}
