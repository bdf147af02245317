// Probe: how fast blocks can stream weight tiles from L2 into shared memory.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o probe_tile_stream probe_tile_stream.cu
//   ./probe_tile_stream
//
// Built and run by mamdr_tpu_torch/k1_ablation.py; no kernel of the port. A
// block streams the 32 x 128 float tiles (16 KB) of a 384 x 256 matrix, as
// kernel K1's slab_kernel streams W_1 (csrc/fused_mlp_step.cu), through a
// ring of three stages with nothing to compute, and reports clock cycles per
// tile: with cp.async (16 bytes a thread, what K1 does) and with ld.global +
// st.shared. The grid is (slabs, lanes): every lane has its own matrix, the
// slabs of a lane read the same one. One block alone shows the latency-bound
// rate of one SM; a grid that covers the card shows what all SMs get from L2
// between them, which is what bounds K1's weight traffic at 30 lanes.

#include <cstdint>
#include <cstdio>
#include <cuda_runtime.h>

namespace {

constexpr int kTileRows = 32, kTileCols = 128, kLd = 136, kStages = 3, kThreads = 256;
constexpr int kRows = 384, kCols = 256;  // W_1 of the main path's tower
constexpr int kChunks = kTileRows * kTileCols / 4 / kThreads;  // 16-byte chunks a thread

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <bool kAsync>
__global__ void __launch_bounds__(kThreads, 1)
stream_tiles(const float* w, int reps, float* sink, long long* cycles_per_tile) {
  extern __shared__ __align__(16) float stages[];
  const int tid = threadIdx.x;
  w += static_cast<long long>(blockIdx.y) * kRows * kCols;
  constexpr int k_tiles = kRows / kTileRows, n_chunks = kCols / kTileCols;
  const int total = k_tiles * n_chunks * reps;
  int i_tile = 0, i_kt = 0, i_nc = 0, i_st = 0;
  auto issue = [&]() {
    if (i_tile < total) {
      float* s = stages + i_st * kTileRows * kLd;
      const float* g = w + i_kt * kTileRows * kCols + i_nc * kTileCols;
      float4 held[kChunks];
#pragma unroll
      for (int q = 0; q < kChunks; ++q) {
        const int ch = tid + q * kThreads, r = ch / (kTileCols / 4), c = (ch % (kTileCols / 4)) * 4;
        if (kAsync)
          asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(s + r * kLd + c)),
                       "l"(g + r * kCols + c)
                       : "memory");
        else
          held[q] = *reinterpret_cast<const float4*>(g + r * kCols + c);
      }
      if (!kAsync) {
#pragma unroll
        for (int q = 0; q < kChunks; ++q) {
          const int ch = tid + q * kThreads, r = ch / (kTileCols / 4), c = (ch % (kTileCols / 4)) * 4;
          *reinterpret_cast<float4*>(s + r * kLd + c) = held[q];
        }
      }
      if (++i_kt == k_tiles) { i_kt = 0; if (++i_nc == n_chunks) i_nc = 0; }
      if (++i_st == kStages) i_st = 0;
      ++i_tile;
    }
    if (kAsync) asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  float sum = 0.0f;
  const long long t0 = clock64();
  for (int s = 0; s < kStages - 1; ++s) issue();
  int st = 0;
  for (int tile = 0; tile < total; ++tile) {
    if (kAsync) asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2) : "memory");
    __syncthreads();
    issue();
    sum += stages[st * kTileRows * kLd + (tid % kTileRows) * kLd + tid / kTileRows];
    if (++st == kStages) st = 0;
  }
  if (kAsync) asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  const long long t1 = clock64();
  sink[(blockIdx.y * gridDim.x + blockIdx.x) * kThreads + tid] = sum;
  if (tid == 0 && blockIdx.x == 0 && blockIdx.y == 0) *cycles_per_tile = (t1 - t0) / total;
}

template <bool kAsync>
bool run(const char* route, int slabs, int lanes, const float* w, float* sink, long long* cycles) {
  const int bytes = kStages * kTileRows * kLd * 4;
  cudaFuncSetAttribute(stream_tiles<kAsync>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  for (int warm = 0; warm < 2; ++warm)
    stream_tiles<kAsync><<<dim3(slabs, lanes), kThreads, bytes>>>(w, 20, sink, cycles);
  if (cudaDeviceSynchronize() != cudaSuccess) return false;
  long long per_tile = 0;
  cudaMemcpy(&per_tile, cycles, sizeof(per_tile), cudaMemcpyDeviceToHost);
  int khz = 0;
  cudaDeviceGetAttribute(&khz, cudaDevAttrClockRate, 0);
  const int blocks = slabs * lanes;
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  const int busy = blocks < sms ? blocks : sms;  // SMs streaming at once
  const double tb_s = 16384.0 * busy / (static_cast<double>(per_tile) / (khz * 1e3)) / 1e12;
  std::printf("tile stream %-22s %3d slabs x %2d lanes: %5lld cycles a 16 KB tile a block, "
              "%5.2f TB/s over %3d SMs at %d MHz\n",
              route, slabs, lanes, per_tile, tb_s, busy, khz / 1000);
  return true;
}

}  // namespace

int main() {
  constexpr int kLanes = 30;
  float *w = nullptr, *sink = nullptr;
  long long* cycles = nullptr;
  if (cudaMalloc(&w, sizeof(float) * kLanes * kRows * kCols) != cudaSuccess) return 1;
  cudaMemset(w, 0, sizeof(float) * kLanes * kRows * kCols);
  cudaMalloc(&sink, sizeof(float) * 64 * kLanes * kThreads);
  cudaMalloc(&cycles, sizeof(long long));
  const int grids[][2] = {{1, 1}, {64, 1}, {16, kLanes}, {32, kLanes}};
  bool ok = true;
  for (const auto& g : grids) {
    ok = ok && run<true>("cp.async 16 B", g[0], g[1], w, sink, cycles);
    ok = ok && run<false>("ld.global + st.shared", g[0], g[1], w, sink, cycles);
  }
  return ok && cudaGetLastError() == cudaSuccess ? 0 : 1;
}
