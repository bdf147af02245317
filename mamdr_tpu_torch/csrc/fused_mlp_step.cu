// Kernel K1: the fused MLP tower train step (forward, weighted BCE, backward).
//
// Replaces the Pallas kernel mamdr_tpu/ops/fused_mlp_step.py:141
// (_fused_tower_grad; body _make_kernel :63-135, masks _hash_keep :44-60).
// For tower dims [in, h1, ..., hk] and a bias-free 1-logit head it computes
//   forward:  z_i = h_{i-1} W_i + b_i,  h_i = dropout_i(relu(z_i))
//   loss:     sum_b w_b * bce(h_k Wl, y_b) / max(sum_b w_b, 1)
//   backward: dWl, then per layer dz_i, dW_i = h_{i-1}^T dz_i,
//             db_i = sum_b dz_i, dh_{i-1} = dz_i W_i^T; dx = dh_0
// with inverted dropout from the murmur3 hash of the batch-global counter
// row * h_i + col (as _hash_keep), recomputed in the backward, not stored.
//
// Bound on an H100 SXM: operations. At the main path's shapes (B 1024,
// dims 384-256-128-64-1) one call does about 0.86 GFLOP of float32
// products (forward, dW and dh, as the Pallas CostEstimate counts them):
// about 13 us at the published 67 TFLOP/s non-tensor-core float32 rate,
// against about 1.3 us for its ~4.3 MB of device-memory traffic.
//
// Design. The Pallas kernel keeps every activation VMEM-resident in one
// grid step; one Hopper SM cannot (W1 alone is 384 KB against 227 KB of
// shared memory), and one SM would leave 131 idle. So the step is a short
// chain of launches on one stream, each spread over the card:
//   - one tiled SGEMM kernel (64x64 output tile per 256-thread block, 16-deep
//     k-steps staged through shared memory with the next step prefetched
//     into registers, 4x4 outputs per thread) that takes both operands
//     through arbitrary strides, so W^T and h^T are read in place, with
//     three epilogues: store; forward (bias, ReLU, dropout, storing z and
//     h); backward (dropout and ReLU masks of the layer below, giving its dz
//     directly from dh);
//   - these products have few output tiles (2 to 96) for their reduction
//     length (64 to 1024), so each splits its reduction into slices (split-K,
//     aiming at about 264 blocks, at least 4 k-steps a slice); the slices
//     write partials and a finishing kernel sums them in slice order and
//     applies the epilogue;
//   - the head (logits, BCE, loss, dlogits, dWl, dz of the last hidden
//     layer) runs as two row-parallel kernels, a warp per row, with the
//     batch sums (weights, loss, dWl) taken as per-block partials summed in
//     block order; a column-sum kernel gives the bias grads.
// z, h and dz go through device memory (scratch from the wrapper). Every
// reduction has one fixed order and no atomics, and the split depends on
// the shapes only, so results are bitwise reproducible run to run.
// Tensor cores (wgmma/TMA) are later work.
//
// Lanes. Every operand may carry a leading lane axis L (the Domain-
// Regularization phase trains one independent model per query domain, all
// advancing together): x [L,B,in], W_i [L,in,out], b_i [L,out], seeds
// [L,n_layers], loss [L], and so on, each contiguous, so a lane's stride is
// its per-lane element count and no pointer list grows with L. The lane is
// a grid dimension of every launch of the chain (the products fold it into
// grid z beside the split-K slice; the others use grid y). A block offsets
// its pointers to its lane once and then does exactly what the single-lane
// kernel does: the same split plan (it depends on the per-lane shapes
// only), the same lane-local dropout counter with the lane's own seeds, the
// same max(sum(w), 1) per lane, the same reduction orders. Lane l of a
// batched call is therefore bit-equal to a single-lane call on lane l's
// operands. At L 30 and the main path's shapes one call does 25.7 GFLOP:
// about 383 us at the float32 rate.
//
// C interface for ctypes: pointer arrays are host arrays of device
// pointers; returns the first cudaError_t of the launches.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64, BN = 64, BK = 16;
constexpr int TM = 4, TN = 4;
constexpr int kThreads = (BM / TM) * (BN / TN);  // 256
constexpr int kPadA = 4;            // As row padding: fewer bank conflicts, float4-aligned
constexpr int kTargetBlocks = 264;  // split-K aim: two waves of an H100's 132 SMs
constexpr int kHeadRows = 32;       // rows per block of the head kernels
constexpr int kHeadThreads = 256;   // 8 warps, a row per warp at a time

enum Epilogue { kStore = 0, kForward = 1, kBackward = 2 };

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// _hash_keep: uniform from the top 24 bits of fmix32(counter * 2654435761 + seed)
__device__ __forceinline__ bool hash_keep(uint32_t seed, uint32_t counter,
                                          float rate) {
  const uint32_t x = fmix32(counter * 2654435761u + seed);
  const float u = static_cast<float>(x >> 8) * (1.0f / 16777216.0f);
  return u >= rate;
}

// Where a product's result goes, and what the epilogue needs.
struct Epi {
  float* out;          // kStore: the product; kForward: z; kBackward: dz below
  const float* bias;   // kForward: [N]
  float* h;            // kForward: relu + dropout of z
  const float* z;      // kBackward: pre-activation of the output [M,N]
  const int* seeds;    // per-layer dropout seeds (uint32 bits)
  int layer;
  float rate, scale;
  int n_layers;        // seeds per lane

  // This lane's part of every operand of an [M,N] product's epilogue.
  __device__ __forceinline__ Epi at_lane(int lane, long long mn, int n) const {
    Epi e = *this;
    e.out += lane * mn;
    if (bias) e.bias += static_cast<long long>(lane) * n;
    if (h) e.h += lane * mn;
    if (z) e.z += lane * mn;
    e.seeds += static_cast<long long>(lane) * n_layers;
    return e;
  }
};

// Element o = m*N + n of the product, value v.
template <int EPI>
__device__ __forceinline__ void epilogue(const Epi& e, long long o, int n, float v) {
  if (EPI == kStore) {
    e.out[o] = v;
  } else if (EPI == kForward) {
    const float z = v + e.bias[n];
    e.out[o] = z;
    float a = fmaxf(z, 0.0f);
    if (e.rate > 0.0f)
      a = hash_keep(static_cast<uint32_t>(e.seeds[e.layer]), static_cast<uint32_t>(o),
                    e.rate) ? a * e.scale : 0.0f;
    e.h[o] = a;
  } else {  // kBackward: v is dh of this layer's output
    float da = v;
    if (e.rate > 0.0f)
      da = hash_keep(static_cast<uint32_t>(e.seeds[e.layer]), static_cast<uint32_t>(o),
                     e.rate) ? v * e.scale : 0.0f;
    e.out[o] = e.z[o] > 0.0f ? da : 0.0f;
  }
}

// C[M,N] = A[M,K] B[K,N]; A(m,k) = A[m*a_sm + k*a_sk], B(k,n) = B[k*b_sk + n*b_sn].
// Grid z is lane * slices + slice. Slice s of a split takes k in
// [s*k_chunk, (s+1)*k_chunk) and writes its partial to the lane's scratch at
// part + s*M*N; unsplit, the block applies the epilogue. a_ls and b_ls are
// the operands' lane strides, part_ls the scratch's.
template <int EPI>
__global__ void __launch_bounds__(kThreads)
gemm_kernel(int M, int N, int K, int k_chunk, int slices,
            const float* __restrict__ A, long long a_sm, long long a_sk, long long a_ls,
            const float* __restrict__ B, long long b_sk, long long b_sn, long long b_ls,
            Epi ep_all, float* __restrict__ part, long long part_ls) {
  __shared__ __align__(16) float As[BK][BM + kPadA];
  __shared__ __align__(16) float Bs[BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int lane = blockIdx.z / slices;
  const int slice_idx = blockIdx.z % slices;
  A += lane * a_ls;
  B += lane * b_ls;
  const int k_beg = slice_idx * k_chunk;
  const int k_end = min(K, k_beg + k_chunk);
  constexpr int kLoads = (BM * BK) / kThreads;  // 4 (A and B alike)

  // Element r of this thread's share of a k-step, for each operand;
  // neighbouring threads take neighbouring addresses along whichever axis
  // has stride 1.
  int am[kLoads], ak[kLoads], bk[kLoads], bn[kLoads];
#pragma unroll
  for (int r = 0; r < kLoads; ++r) {
    const int e = tid + r * kThreads;
    if (a_sk == 1) { am[r] = e / BK; ak[r] = e % BK; }
    else           { am[r] = e % BM; ak[r] = e / BM; }
    if (b_sn == 1) { bk[r] = e / BN; bn[r] = e % BN; }
    else           { bn[r] = e / BK; bk[r] = e % BK; }
  }
  float ra[kLoads], rb[kLoads];
  auto load = [&](int k0) {
#pragma unroll
    for (int r = 0; r < kLoads; ++r) {
      const int gm = m0 + am[r], gk = k0 + ak[r];
      ra[r] = (gm < M && gk < k_end) ? A[gm * a_sm + gk * a_sk] : 0.0f;
      const int gk2 = k0 + bk[r], gn = n0 + bn[r];
      rb[r] = (gk2 < k_end && gn < N) ? B[gk2 * b_sk + gn * b_sn] : 0.0f;
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  load(k_beg);
  for (int k0 = k_beg; k0 < k_end; k0 += BK) {
#pragma unroll
    for (int r = 0; r < kLoads; ++r) {
      As[ak[r]][am[r]] = ra[r];
      Bs[bk[r]][bn[r]] = rb[r];
    }
    __syncthreads();
    if (k0 + BK < k_end) load(k0 + BK);  // in flight during the products
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&As[k][ty * TM]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[k][tx * TN]);
      const float av[TM] = {a.x, a.y, a.z, a.w};
      const float bv[TN] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  const bool split = slices > 1;
  const long long mn = static_cast<long long>(M) * N;
  float* slice = split ? part + lane * part_ls + slice_idx * mn : nullptr;
  const Epi ep = ep_all.at_lane(lane, mn, N);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx * TN + j;
      if (n >= N) continue;
      const long long o = static_cast<long long>(m) * N + n;
      if (split) slice[o] = acc[i][j];
      else epilogue<EPI>(ep, o, n, acc[i][j]);
    }
  }
}

// Sum the slice partials of an [M,N] product in slice order, then the
// epilogue. Grid y is the lane.
template <int EPI>
__global__ void __launch_bounds__(256)
finish_kernel(int M, int N, int slices, const float* __restrict__ part,
              long long part_ls, Epi ep_all) {
  const long long total = static_cast<long long>(M) * N;
  const int lane = blockIdx.y;
  part += lane * part_ls;
  const Epi ep = ep_all.at_lane(lane, total, N);
  for (long long o = blockIdx.x * 256LL + threadIdx.x; o < total;
       o += static_cast<long long>(gridDim.x) * 256) {
    float s = 0.0f;
    for (int z = 0; z < slices; ++z) s += part[z * total + o];
    epilogue<EPI>(ep, o, static_cast<int>(o % N), s);
  }
}

// Head, part 1: a warp per row. g[b] = (sigmoid(l_b) - y_b) * w_b, and per
// block the partial sums of bce*w and of w (part[2*block], part[2*block+1]).
// Grid y is the lane (both head kernels).
__global__ void __launch_bounds__(kHeadThreads)
head_rows_kernel(int batch, int hid, const float* __restrict__ hl,
                 const float* __restrict__ wl, const float* __restrict__ label,
                 const float* __restrict__ weight, float* __restrict__ g,
                 float* __restrict__ part, long long part_ls) {
  __shared__ float sl[kHeadThreads / 32], sw[kHeadThreads / 32];
  const long long lane_id = blockIdx.y;
  hl += lane_id * batch * hid;
  wl += lane_id * hid;
  label += lane_id * batch;
  weight += lane_id * batch;
  g += lane_id * batch;
  part += lane_id * part_ls;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  constexpr int n_warps = kHeadThreads / 32;
  const int r0 = blockIdx.x * kHeadRows;
  const int r1 = min(batch, r0 + kHeadRows);
  float ls = 0.0f, ws = 0.0f;
  for (int b = r0 + warp; b < r1; b += n_warps) {
    const float* row = hl + static_cast<long long>(b) * hid;
    float p = 0.0f;
    for (int j = lane; j < hid; j += 32) p = fmaf(row[j], wl[j], p);
    for (int off = 16; off > 0; off >>= 1) p += __shfl_down_sync(0xffffffffu, p, off);
    if (lane == 0) {
      const float l = p, y = label[b], w = weight[b];
      const float bce = fmaxf(l, 0.0f) - l * y + log1pf(expf(-fabsf(l)));
      ls += bce * w;
      ws += w;
      g[b] = (1.0f / (1.0f + expf(-l)) - y) * w;
    }
  }
  if (lane == 0) { sl[warp] = ls; sw[warp] = ws; }
  __syncthreads();
  if (threadIdx.x == 0) {
    float a = 0.0f, c = 0.0f;
    for (int q = 0; q < n_warps; ++q) { a += sl[q]; c += sw[q]; }
    part[2 * blockIdx.x] = a;
    part[2 * blockIdx.x + 1] = c;
  }
}

// Head, part 2: every block sums the part-1 partials in block order (so all
// agree on the denominator), block 0 writes the loss; then for its rows
// dlog = g / denom, dz of the last hidden layer (dh = dlog Wl^T through its
// dropout and ReLU masks), and its partial of dWl (dwl_part[block*hid + j]).
__global__ void __launch_bounds__(kHeadThreads)
head_grad_kernel(int batch, int hid, int n_part, const float* __restrict__ part,
                 const float* __restrict__ hl, const float* __restrict__ wl,
                 const float* __restrict__ zl, const int* __restrict__ seeds,
                 int layer, int n_layers, float rate, float scale,
                 float* __restrict__ dlog, float* __restrict__ loss,
                 float* __restrict__ dwl_part, float* __restrict__ dzl,
                 long long part_ls) {
  __shared__ float s_den;
  __shared__ float s_dlog[kHeadRows];
  const long long lane_id = blockIdx.y;
  part += lane_id * part_ls;
  dwl_part += lane_id * part_ls;
  hl += lane_id * batch * hid;
  zl += lane_id * batch * hid;
  dzl += lane_id * batch * hid;
  wl += lane_id * hid;
  dlog += lane_id * batch;
  loss += lane_id;
  seeds += lane_id * n_layers;
  if (threadIdx.x == 0) {
    float ls = 0.0f, ws = 0.0f;
    for (int q = 0; q < n_part; ++q) { ls += part[2 * q]; ws += part[2 * q + 1]; }
    const float den = fmaxf(ws, 1.0f);
    s_den = den;
    if (blockIdx.x == 0) *loss = ls / den;
  }
  __syncthreads();
  const int r0 = blockIdx.x * kHeadRows;
  const int rows = min(batch, r0 + kHeadRows) - r0;
  for (int r = threadIdx.x; r < rows; r += kHeadThreads) {
    const float d = dlog[r0 + r] / s_den;  // dlog holds g from part 1
    dlog[r0 + r] = d;
    s_dlog[r] = d;
  }
  __syncthreads();
  const uint32_t seed = static_cast<uint32_t>(seeds[layer]);
  for (int e = threadIdx.x; e < rows * hid; e += kHeadThreads) {
    const int r = e / hid, j = e % hid;
    const long long o = static_cast<long long>(r0 + r) * hid + j;
    const float dh = s_dlog[r] * wl[j];
    float da = dh;
    if (rate > 0.0f)
      da = hash_keep(seed, static_cast<uint32_t>(o), rate) ? dh * scale : 0.0f;
    dzl[o] = zl[o] > 0.0f ? da : 0.0f;
  }
  for (int j = threadIdx.x; j < hid; j += kHeadThreads) {
    float p = 0.0f;
    for (int r = 0; r < rows; ++r)
      p = fmaf(hl[static_cast<long long>(r0 + r) * hid + j], s_dlog[r], p);
    dwl_part[static_cast<long long>(blockIdx.x) * hid + j] = p;
  }
}

// db[n] = sum_b dz[b, n]: 32 columns per block, 32 row-strided partials per
// column (four independent chains each), then a fixed-order sum. Grid y is
// the lane.
__global__ void __launch_bounds__(1024)
colsum_kernel(int batch, int n_cols, const float* __restrict__ dz,
              float* __restrict__ db) {
  __shared__ float partial[32][33];
  dz += static_cast<long long>(blockIdx.y) * batch * n_cols;
  db += static_cast<long long>(blockIdx.y) * n_cols;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  const int n = blockIdx.x * 32 + tx;
  float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
  if (n < n_cols) {
    int b = ty;
    for (; b + 96 < batch; b += 128) {
      s0 += dz[static_cast<long long>(b) * n_cols + n];
      s1 += dz[static_cast<long long>(b + 32) * n_cols + n];
      s2 += dz[static_cast<long long>(b + 64) * n_cols + n];
      s3 += dz[static_cast<long long>(b + 96) * n_cols + n];
    }
    for (; b < batch; b += 32) s0 += dz[static_cast<long long>(b) * n_cols + n];
  }
  partial[ty][tx] = (s0 + s1) + (s2 + s3);
  __syncthreads();
  if (ty == 0 && n < n_cols) {
    float t = 0.0f;
    for (int q = 0; q < 32; ++q) t += partial[q][tx];
    db[n] = t;
  }
}

// How an [M,N] product with reduction length K is split: slices of a whole
// number of k-steps, about kTargetBlocks blocks in all, at least four
// k-steps a slice. Depends on the shapes only.
struct Plan {
  int chunk, slices;
};

inline Plan plan(int M, int N, int K) {
  const int tiles = ((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  int slices = kTargetBlocks / tiles;
  const int most = K / (4 * BK);
  if (slices > most) slices = most;
  if (slices < 1) slices = 1;
  int chunk = (K + slices - 1) / slices;
  chunk = ((chunk + BK - 1) / BK) * BK;
  return {chunk, (K + chunk - 1) / chunk};
}

inline long long split_floats(int M, int N, int K) {
  const Plan p = plan(M, N, K);
  return p.slices > 1 ? static_cast<long long>(p.slices) * M * N : 0;
}

inline int elementwise_blocks(long long n) {
  const long long b = (n + 255) / 256;
  return static_cast<int>(b < 2048 ? b : 2048);
}

// One strided operand of a product: element (r, c) of lane l is at
// p[l*ls + r*sr + c*sc].
struct Mat {
  const float* p;
  long long sr, sc, ls;
};

// Per lane C = A B with the epilogue, split when the plan says so (`split`:
// scratch, `split_ls` floats a lane).
template <int EPI>
cudaError_t run_gemm(int lanes, int M, int N, int K, const Mat& A, const Mat& B,
                     const Epi& ep, float* split, long long split_ls,
                     cudaStream_t stream) {
  const Plan p = plan(M, N, K);
  if (static_cast<long long>(p.slices) * lanes > 65535) return cudaErrorInvalidValue;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, p.slices * lanes);
  gemm_kernel<EPI><<<grid, kThreads, 0, stream>>>(
      M, N, K, p.chunk, p.slices, A.p, A.sr, A.sc, A.ls, B.p, B.sr, B.sc, B.ls, ep,
      split, split_ls);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p.slices == 1) return err;
  const dim3 fgrid(elementwise_blocks(static_cast<long long>(M) * N), lanes);
  finish_kernel<EPI><<<fgrid, 256, 0, stream>>>(M, N, p.slices, split, split_ls, ep);
  return cudaGetLastError();
}

inline int head_blocks(int batch) { return (batch + kHeadRows - 1) / kHeadRows; }

}  // namespace

#define MAMDR_CHECK(call)                                   \
  do {                                                      \
    const cudaError_t err_ = (call);                        \
    if (err_ != cudaSuccess) return static_cast<int>(err_); \
  } while (0)

// Floats of scratch that mamdr_fused_tower_grad needs for each lane
// (split-K partials and the head's per-block partials, used one after
// another).
extern "C" long long mamdr_fused_tower_scratch(int n_layers, const int* dims,
                                               int batch) {
  const int hid = dims[n_layers];
  long long most = static_cast<long long>(head_blocks(batch)) * (2 + hid);
  for (int i = 0; i < n_layers; ++i) {
    const int K = dims[i], N = dims[i + 1];
    const long long need[3] = {split_floats(batch, N, K), split_floats(K, N, batch),
                               split_floats(batch, K, N)};
    for (long long v : need) most = v > most ? v : most;
  }
  return most;
}

// Every tensor carries a leading lane axis of `lanes` (1 for the single-lane
// step) and is contiguous; w_, b_, dw_, db_, z_, h_, dz_ hold one pointer
// per layer. split_ holds lanes * mamdr_fused_tower_scratch(...) floats.
extern "C" int mamdr_fused_tower_grad(
    int lanes, int n_layers, const int* dims, int batch, const void* x_,
    const void* label, const void* weight, const void* seeds_, void* const* w_,
    void* const* b_, const void* wl_, float rate, float scale, void* loss, void* dx,
    void* const* dw_, void* const* db_, void* dwl, void* const* z_,
    void* const* h_, void* const* dz_, void* dlog_, void* split_, void* stream_) {
  if (lanes < 1 || lanes > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const float* x = static_cast<const float*>(x_);
  const float* wl = static_cast<const float*>(wl_);
  const int* seeds = static_cast<const int*>(seeds_);
  float* split = static_cast<float*>(split_);
  float* dlog = static_cast<float*>(dlog_);
  const long long split_ls = mamdr_fused_tower_scratch(n_layers, dims, batch);
  const long long B = batch;
  auto W = [&](int i) { return static_cast<const float*>(w_[i]); };
  auto Zs = [&](int i) { return static_cast<float*>(z_[i]); };
  auto Hs = [&](int i) { return static_cast<float*>(h_[i]); };
  auto DZ = [&](int i) { return static_cast<float*>(dz_[i]); };
  auto epi = [&](float* out, const float* bias, float* h, const float* z, int layer) {
    return Epi{out, bias, h, z, seeds, layer, rate, scale, n_layers};
  };

  // forward
  for (int i = 0; i < n_layers; ++i) {
    const long long K = dims[i], N = dims[i + 1];
    const float* in = i == 0 ? x : Hs(i - 1);
    MAMDR_CHECK(run_gemm<kForward>(
        lanes, batch, N, K, Mat{in, K, 1, B * K}, Mat{W(i), N, 1, K * N},
        epi(Zs(i), static_cast<const float*>(b_[i]), Hs(i), nullptr, i), split,
        split_ls, stream));
  }

  // head: loss, dlogits, dWl, dz of the last hidden layer
  const int last = n_layers - 1, hid = dims[n_layers], nb = head_blocks(batch);
  float* part = split;
  float* dwl_part = split + 2 * nb;
  const dim3 hgrid(nb, lanes);
  head_rows_kernel<<<hgrid, kHeadThreads, 0, stream>>>(
      batch, hid, Hs(last), wl, static_cast<const float*>(label),
      static_cast<const float*>(weight), dlog, part, split_ls);
  MAMDR_CHECK(cudaGetLastError());
  head_grad_kernel<<<hgrid, kHeadThreads, 0, stream>>>(
      batch, hid, nb, part, Hs(last), wl, Zs(last), seeds, last, n_layers, rate, scale,
      dlog, static_cast<float*>(loss), dwl_part, DZ(last), split_ls);
  MAMDR_CHECK(cudaGetLastError());
  const dim3 wgrid(elementwise_blocks(hid), lanes);
  finish_kernel<kStore><<<wgrid, 256, 0, stream>>>(
      1, hid, nb, dwl_part, split_ls,
      epi(static_cast<float*>(dwl), nullptr, nullptr, nullptr, 0));
  MAMDR_CHECK(cudaGetLastError());

  // backward
  for (int i = n_layers - 1; i >= 0; --i) {
    const long long K = dims[i], N = dims[i + 1];
    const float* act = i == 0 ? x : Hs(i - 1);
    // dW_i [K,N] = act^T [K,B] dz_i [B,N]
    MAMDR_CHECK(run_gemm<kStore>(
        lanes, K, N, batch, Mat{act, 1, K, B * K}, Mat{DZ(i), N, 1, B * N},
        epi(static_cast<float*>(dw_[i]), nullptr, nullptr, nullptr, i), split,
        split_ls, stream));
    const dim3 cgrid((N + 31) / 32, lanes);
    colsum_kernel<<<cgrid, 1024, 0, stream>>>(batch, N, DZ(i),
                                              static_cast<float*>(db_[i]));
    MAMDR_CHECK(cudaGetLastError());
    // dh [B,K] = dz_i [B,N] W_i^T [N,K]: dz of the layer below, or dx
    const Mat dz{DZ(i), N, 1, B * N}, wt{W(i), 1, N, K * N};
    if (i > 0) {
      MAMDR_CHECK(run_gemm<kBackward>(
          lanes, batch, K, N, dz, wt,
          epi(DZ(i - 1), nullptr, nullptr, Zs(i - 1), i - 1), split, split_ls, stream));
    } else {
      MAMDR_CHECK(run_gemm<kStore>(
          lanes, batch, K, N, dz, wt,
          epi(static_cast<float*>(dx), nullptr, nullptr, nullptr, 0), split, split_ls,
          stream));
    }
  }
  return 0;
}
