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
// row * h_i + col (as _hash_keep).
//
// Bound on an H100 SXM: operations. At the main path's shapes (B 1024,
// dims 384-256-128-64-1) one call does about 0.86 GFLOP of float32
// products (forward, dW and dh, as the Pallas CostEstimate counts them).
// They run on the tensor cores as three TF32 products each (below), so the
// least time is 3 x 0.86 GFLOP at the published 495 TFLOP/s of dense TF32,
// about 5.2 us (12.8 us at the 67 TFLOP/s float32 rate outside the tensor
// cores), against about 1.3 us for its ~4.3 MB of device-memory traffic.
//
// Design. What the Pallas kernel is for is keeping every activation out of
// device memory; it holds the whole batch in VMEM in one grid step. One SM
// cannot hold the batch (or W1: 384 KB against 227 KB of shared memory),
// but it can hold a slab of rows. A call is two launches:
//   1. slab_kernel, grid (row slabs, lanes). A block takes a slab of 64, 32
//      or 16 rows of one lane (the wrapper's plan: the largest that fits
//      shared memory and still gives every SM a block; the slab changes no
//      bit of the result) and keeps every h_i in shared memory (448 floats a
//      row at the main path's dims). It sums the lane's weights itself in a
//      fixed order (the loss's denominator), runs the forward with each W_i
//      streamed through shared memory in 32-deep k-tiles (cp.async, three
//      stages; more, tried, bought nothing; a lane's 0.56 MB of weights stay
//      in the 50 MB L2; the slab's x, needed by the first product only, comes
//      through the same stages), the head per row, and the backward with W_i
//      read transposed in place, each dz_i overwriting h_i in shared memory:
//      dz_i is nonzero exactly where h_i > 0 (the unit passed its ReLU and
//      was kept), so h_i itself is the dropout-and-ReLU mask and neither z_i
//      nor a second hash is needed. It writes dx from the last product's registers, and for the
//      second launch h_i, dz_i, the per-row dlogits and per 16 rows the
//      partial sums of the loss. The larger the slab, the less often a
//      lane's weights are read from L2 (once per slab in each direction)
//      and the more rows share each weight fragment's load and split.
//   2. dw_kernel, grid (blocks, lanes): one 64x64 output tile of some dW_i
//      per block, reduced over the whole batch in k order (no split-K, so no
//      partials through device memory; a 128x128 tile reads h and dz half as
//      often, but its 270 blocks at 30 lanes, two to an SM, do not fit one
//      wave of the card and it measured slower); further blocks take 8
//      columns each of the db_i (column sums of dz_i) and of dWl (h_k^T
//      dlogits), and one thread sums the loss partials in row order.
// The products are mma.sync.m16n8k8 TF32 on the tensor cores with error
// compensation ("3xTF32"): every float32 operand v is split into
// hi = tf32(v) and lo = tf32(v - hi), and lo*hi + hi*lo + hi*hi are
// accumulated in float32; the dropped lo*lo term and lo's own rounding are
// about 2^-21 relative, so the result is float32-accurate where one TF32
// product keeps three digits.
// Fragments are loaded from shared memory by the threads, which is what lets
// W^T and h^T be read in place (wgmma takes TF32 operands K-major only).
// Every reduction has one fixed order and no atomics, so two calls give the
// same bits. Measured on an H100 (700 W) at the main path's shapes and 30
// lanes (mamdr_tpu_torch/k1_ablation.py), the slab kernel spends about two
// fifths of its time on the tensor-core products, a fifth on the weight
// tiles' way from L2 (all SMs streaming at once get about 2 TB/s between
// them), an eighth on the operand splits and the rest on fragment loads,
// epilogues and the step from tile to tile; wgmma with A from registers and
// the weights staged by TMA is the further step.
//
// Lanes. Every operand may carry a leading lane axis L (the Domain-
// Regularization phase trains one independent model per query domain, all
// advancing together): x [L,B,in], W_i [L,in,out], b_i [L,out], seeds
// [L,n_layers], loss [L], and so on, each contiguous, so a lane's stride is
// its per-lane element count. The lane is grid y of both launches; a block
// offsets its pointers to its lane once and then does exactly what the
// single-lane call does (the same tiles, the lane-local dropout counter with
// the lane's own seeds, max(sum(w), 1) per lane, the same reduction orders),
// so lane l of a batched call is bit-equal to a single-lane call on lane l's
// operands.
//
// C interface for ctypes: pointer arrays are host arrays of device
// pointers; returns the first cudaError_t of the launches.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLayers = 8;
constexpr int kMaxSharedBytes = 232448;  // 227 KB: the most a block may opt into on sm_90

// slab_kernel: 8 warps; the streamed operand in tiles of kBK x kBN
constexpr int kSlabThreads = 256;
constexpr int kBN = 128, kBK = 32, kStages = 3;
constexpr int kLdKN = kBN + 8;  // tile rows over k (W as stored): stride 8 mod 32, no bank conflicts
constexpr int kLdNK = kBK + 4;  // tile rows over n (W read transposed): stride 4 mod 32
constexpr int kLdX = kBK + 4;   // a k-tile of the slab's x: rows over the slab's rows
constexpr int kWTileFloats = kBN * kLdNK > kBK * kLdKN ? kBN * kLdNK : kBK * kLdKN;
// a stage: a weight tile, then a k-tile of x (used by the first layer's forward)
__host__ __device__ constexpr int stage_floats(int slab_rows) {
  return kWTileFloats + slab_rows * kLdX;
}
constexpr int kLossRows = 16;   // rows per partial sum of the loss, whatever the slab
// dw_kernel: 4 warps, a 64x64 tile, both operands in tiles of kDwBK x 64
constexpr int kDwThreads = 128;
constexpr int kTile = 64, kDwBK = 32, kDwStages = 4;
constexpr int kLdT = kTile + 8;
constexpr int kDwStageFloats = 2 * kDwBK * kLdT;
constexpr int kSumCols = 8, kSumGroups = kDwThreads / kSumCols;  // column-sum blocks

__host__ __device__ inline long long up4(long long v) { return (v + 3) / 4 * 4; }

// Timing-only builds of mamdr_tpu_torch/k1_ablation.py, which take one part
// of the work out and compute wrong results: -DMAMDR_K1_NO_TILE_LOADS skips
// the streamed tiles' copies, -DMAMDR_K1_FIRST_PASS=2 (or 3) leaves one (or
// none) of the three TF32 product passes. The port's own build defines neither.
#ifdef MAMDR_K1_NO_TILE_LOADS
constexpr bool kLoadTiles = false;
#else
constexpr bool kLoadTiles = true;
#endif
#ifndef MAMDR_K1_FIRST_PASS
#define MAMDR_K1_FIRST_PASS 0
#endif

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// _hash_keep: uniform from the top 24 bits of fmix32(counter * 2654435761 + seed)
__device__ __forceinline__ bool hash_keep(uint32_t seed, uint32_t counter, float rate) {
  const uint32_t x = fmix32(counter * 2654435761u + seed);
  const float u = static_cast<float>(x >> 8) * (1.0f / 16777216.0f);
  return u >= rate;
}

// ---- asynchronous copies into shared memory, zero-filling what is not read ----

__device__ __forceinline__ void cp_async16(float* smem, const float* src, int src_bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* smem, const float* src, int src_bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One 4-float chunk of a staged tile: n of its floats (0..4) lie inside the
// matrix and are copied from src, the rest are zeros. `base` is any address
// inside the matrix (given to copies that read nothing). `vec`: one 16-byte
// copy (a 16-byte aligned src), else four 4-byte ones.
__device__ __forceinline__ void stage_chunk(float* dst, const float* src, const float* base,
                                            int n, bool vec) {
  n = n < 0 ? 0 : (n > 4 ? 4 : n);
  if (vec) {
    cp_async16(dst, n > 0 ? src : base, 4 * n);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) cp_async4(dst + j, j < n ? src + j : base, j < n ? 4 : 0);
  }
}

// Stage a tile of TR x TC floats of a row-major matrix (row stride ldg)
// whose origin is g into s (row stride lds). Rows from r_valid and columns
// from c_valid on lie outside the matrix and are filled with zeros. `vec`
// needs ldg % 4 == 0 and a 16-byte aligned origin. Every one of the block's
// THREADS threads calls it and takes the same chunks of every tile.
template <int TR, int TC, int THREADS>
__device__ __forceinline__ void stage(float* s, int lds, const float* g, const float* base,
                                      int ldg, int r_valid, int c_valid, bool vec) {
  constexpr int kChunksPerRow = TC / 4, kChunks = TR * kChunksPerRow;
#pragma unroll
  for (int q = 0; q < (kChunks + THREADS - 1) / THREADS; ++q) {
    const int ch = threadIdx.x + q * THREADS;
    if (kChunks % THREADS == 0 || ch < kChunks) {
      const int r = ch / kChunksPerRow, c = (ch % kChunksPerRow) * 4;
      stage_chunk(s + r * lds + c, g + r * ldg + c, base, r < r_valid ? c_valid - c : 0, vec);
    }
  }
}

// rows x cols of s (row stride lds) to the row-major g (row stride cols).
__device__ __forceinline__ void store_rows(const float* s, int lds, float* g, int rows,
                                           int cols, bool vec) {
  if (vec) {
    const int chunks_per_row = cols / 4;
    for (int ch = threadIdx.x; ch < rows * chunks_per_row; ch += blockDim.x) {
      const int r = ch / chunks_per_row, c = (ch % chunks_per_row) * 4;
      *reinterpret_cast<float4*>(g + static_cast<long long>(r) * cols + c) =
          *reinterpret_cast<const float4*>(s + r * lds + c);
    }
  } else {
    for (int e = threadIdx.x; e < rows * cols; e += blockDim.x) {
      const int r = e / cols, c = e % cols;
      g[static_cast<long long>(r) * cols + c] = s[r * lds + c];
    }
  }
}

// ---- error-compensated TF32 on the tensor cores ----

// v = hi + lo exactly. hi is v rounded to TF32's 11 significant bits by
// Veltkamp's splitting (three float32 operations; cvt.rna.tf32.f32 would do,
// but conversions issue at a quarter of the float32 rate and two a value made
// them this kernel's limit). lo = v - hi goes to the tensor core as it is: it
// reads a TF32 operand's top 19 bits, so lo counts to 11 bits too and what is
// lost is about 2^-21 |v|. Finite |v| below 2^114 (c must not overflow).
__device__ __forceinline__ void tf32_split(float v, uint32_t& hi, uint32_t& lo) {
  const float c = __fmul_rn(v, 8193.0f);  // 2^13 + 1; _rn: never contracted into an fma
  const float h = __fsub_rn(c, __fsub_rn(c, v));
  hi = __float_as_uint(h);
  lo = __float_as_uint(__fsub_rn(v, h));
}

// c[16x8] += a[16x8] b[8x8]; thread (g = lane / 4, t = lane % 4) holds
// a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4); b0 (k t, n g),
// b1 (k t+4, n g); c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1).
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A warp's step of 8 along k: acc[i][j] += a[i] b[j] over its MSUB x NSUB
// subtiles as the three products of split operands, small terms first. Each
// pass runs over all subtiles before the next, so that an mma never waits
// for the one just issued (it would: they share an accumulator).
template <int MSUB, int NSUB>
__device__ __forceinline__ void mma_3xtf32(float (&acc)[MSUB][NSUB][4],
                                           const uint32_t (&ah)[MSUB][4],
                                           const uint32_t (&al)[MSUB][4],
                                           const uint32_t (&bh)[NSUB][2],
                                           const uint32_t (&bl)[NSUB][2]) {
#pragma unroll
  for (int pass = MAMDR_K1_FIRST_PASS; pass < 3; ++pass)
#pragma unroll
    for (int j = 0; j < NSUB; ++j)
#pragma unroll
      for (int i = 0; i < MSUB; ++i)
        mma_tf32(acc[i][j], pass == 0 ? al[i] : ah[i], pass == 1 ? bl[j] : bh[j]);
}

// ---- what both kernels are told ----

struct Tower {
  int n_layers, batch;
  int dims[kMaxLayers + 1];
  float rate, scale;
  // one lane's operands; a lane's stride is its element count
  const float *x, *label, *weight, *wl;
  const int* seeds;
  const float* w[kMaxLayers];
  const float* b[kMaxLayers];
  float *loss, *dx, *dwl;
  float* dw[kMaxLayers];
  float* db[kMaxLayers];
  float* z[kMaxLayers];  // pre-activations, written only when not null (checks)
  // workspace: ws_lane floats a lane; h, dz of layer i, the dlogits, the loss
  // partials (n_part of them, then the denominator) at these offsets
  float* ws;
  long long ws_lane, h_off[kMaxLayers], dz_off[kMaxLayers], dlog_off, part_off;
  int n_part;
  // shared memory of slab_kernel, in floats: activation i (h_i, i >= 1; x is
  // streamed) at act_off[i] with row stride lda[i]; then the stages; then the
  // head's scratch
  int lda[kMaxLayers + 1], act_off[kMaxLayers + 1], stage_off, head_off;
  // 16-byte copies allowed: bit i activation i (x, h_i, dz_i), bit 16 + i W_i
  unsigned vec;

  __device__ __forceinline__ bool act_vec(int i) const { return (vec >> i) & 1u; }
  __device__ __forceinline__ bool w_vec(int i) const { return (vec >> (16 + i)) & 1u; }
  __device__ __forceinline__ float* lane_ws(int lane) const { return ws + lane * ws_lane; }
};

// ---- launch 1: a slab of rows through forward, head and backward ----

// Forward epilogue of layer i: bias, ReLU, dropout; h into shared memory.
struct ForwardEpi {
  float* out;  // [rows][ldo] in shared memory
  int ldo;
  const float* bias;
  float* z_out;  // this lane's [B, width] in device memory, or null
  uint32_t seed;
  float rate, scale;
  int row0, batch, width;
  __device__ __forceinline__ void operator()(int r, int c, float v) const {
    const float z = v + bias[c];
    const int row = row0 + r;
    if (z_out != nullptr && row < batch) z_out[static_cast<long long>(row) * width + c] = z;
    float a = fmaxf(z, 0.0f);
    if (rate > 0.0f)
      a = hash_keep(seed, static_cast<uint32_t>(row) * static_cast<uint32_t>(width) +
                              static_cast<uint32_t>(c), rate) ? a * scale : 0.0f;
    out[r * ldo + c] = a;
  }
};

// Backward epilogue: v is dh of the activation held at io, which holds h
// (positive exactly where the unit passed its ReLU and was kept) and becomes
// dz.
struct BackwardEpi {
  float* io;
  int ld;
  float scale;
  __device__ __forceinline__ void operator()(int r, int c, float v) const {
    float* p = io + r * ld + c;
    *p = *p > 0.0f ? v * scale : 0.0f;
  }
};

// The last backward product: v is dx, written straight to device memory
// (x's slab is not kept in shared memory, so there is no buffer to fill).
struct DxEpi {
  float* dx;  // the slab's first row
  int width, rows;
  __device__ __forceinline__ void operator()(int r, int c, float v) const {
    if (r < rows) dx[static_cast<long long>(r) * width + c] = v;
  }
};

// The slab's x, streamed in k-tiles beside the first layer's weight tiles.
struct XStream {
  const float* x;     // the slab's first row (row stride ld)
  const float* base;  // the lane's x
  int ld, rows;       // rows of the slab that exist
  bool vec;
};

// out[R, N] = A[R, K] op(W) for the slab of R = 16 * MSUB * WARPS_M rows. W is
// streamed from device memory: W [K, N] as stored (kT false) or W [N, K] read
// transposed (kT true), row stride ldw either way. A is in shared memory (row
// stride lda, zero beyond K) or, with kStreamA, the slab's x, whose k-tiles
// come through the stages beside W's. 8 warps as WARPS_M x WARPS_N, a warp
// 16 * MSUB rows by kBN / WARPS_N columns of a 128-column chunk; chunks and
// k-tiles form one sequence of tiles through the stages, so the pipeline
// never drains between chunks. epi(r, c, v) takes every element once. Ends
// with the block in step.
template <int WARPS_M, int MSUB, bool kT, bool kStreamA, class Epi>
__device__ __forceinline__ void slab_gemm(const float* A, int lda, const XStream& xs, int K,
                                          int N, const float* W, int ldw, bool vec,
                                          float* stages, const Epi& epi) {
  constexpr int R = 16 * MSUB * WARPS_M;
  constexpr int kStageFloats = stage_floats(R);
  constexpr int WARPS_N = kSlabThreads / 32 / WARPS_M;
  static_assert(kBN % (8 * WARPS_N) == 0, "a whole number of 8-column subtiles a warp");
  constexpr int WN = kBN / WARPS_N;
  constexpr int NSUB = WN / 8;
  const int warp = threadIdx.x / 32, ln = threadIdx.x % 32, g = ln / 4, t = ln % 4;
  const int wm = warp % WARPS_M, wn = warp / WARPS_M;
  const int k_tiles = (K + kBK - 1) / kBK;
  const int total = k_tiles * ((N + kBN - 1) / kBN);

  // The next tile to fetch: k-tile i_kt of chunk i_nc, into stage i_st.
  int i_tile = 0, i_nc = 0, i_kt = 0, i_st = 0;
  auto issue = [&]() {
    if (kLoadTiles && i_tile < total) {
      float* s = stages + i_st * kStageFloats;
      if (!kT)
        stage<kBK, kBN, kSlabThreads>(s, kLdKN, W + i_kt * kBK * ldw + i_nc * kBN, W, ldw,
                                      K - i_kt * kBK, N - i_nc * kBN, vec);
      else
        stage<kBN, kBK, kSlabThreads>(s, kLdNK, W + i_nc * kBN * ldw + i_kt * kBK, W, ldw,
                                      N - i_nc * kBN, K - i_kt * kBK, vec);
      if (kStreamA)
        stage<R, kBK, kSlabThreads>(s + kWTileFloats, kLdX, xs.x + i_kt * kBK, xs.base, xs.ld,
                                    xs.rows, K - i_kt * kBK, xs.vec);
      if (++i_kt == k_tiles) { i_kt = 0; ++i_nc; }
      if (++i_st == kStages) i_st = 0;
      ++i_tile;
    }
    cp_async_commit();  // one group per tile, empty past the end
  };

  float acc[MSUB][NSUB][4];
#pragma unroll
  for (int i = 0; i < MSUB; ++i)
#pragma unroll
    for (int j = 0; j < NSUB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  for (int s = 0; s < kStages - 1; ++s) issue();
  int nc = 0, kt = 0, st = 0;  // the tile at hand
  for (int tile = 0; tile < total; ++tile) {
    cp_async_wait<kStages - 2>();  // this thread's part of the tile has landed
    __syncthreads();               // everyone's has, and the stage refilled next is free
    issue();
    const float* s = stages + st * kStageFloats;
    const int n_warp = nc * kBN + wn * WN;  // this warp's first column
    if (n_warp < N) {
      // this thread's first row of A, at the tile's first k
      const int a_ld = kStreamA ? kLdX : lda;
      const float* a_row = (kStreamA ? s + kWTileFloats : A + kt * kBK) +
                           (wm * MSUB * 16 + g) * a_ld + t;
      // No test on k or on the subtile's columns in here: beyond K and N both
      // operands hold zeros, and straight-line code lets the loads of one
      // step of 8 overlap the products of the one before.
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 8) {
        uint32_t ah[MSUB][4], al[MSUB][4], bh[NSUB][2], bl[NSUB][2];
#pragma unroll
        for (int i = 0; i < MSUB; ++i) {
          const float* a = a_row + i * 16 * a_ld + kk;
          tf32_split(a[0], ah[i][0], al[i][0]);
          tf32_split(a[8 * a_ld], ah[i][1], al[i][1]);
          tf32_split(a[4], ah[i][2], al[i][2]);
          tf32_split(a[8 * a_ld + 4], ah[i][3], al[i][3]);
        }
#pragma unroll
        for (int j = 0; j < NSUB; ++j) {
          const int col = wn * WN + j * 8 + g;  // within the chunk
          const float b0 = kT ? s[col * kLdNK + kk + t] : s[(kk + t) * kLdKN + col];
          const float b1 = kT ? s[col * kLdNK + kk + t + 4] : s[(kk + t + 4) * kLdKN + col];
          tf32_split(b0, bh[j][0], bl[j][0]);
          tf32_split(b1, bh[j][1], bl[j][1]);
        }
        mma_3xtf32<MSUB, NSUB>(acc, ah, al, bh, bl);
      }
      if (kt == k_tiles - 1) {
#pragma unroll
        for (int i = 0; i < MSUB; ++i)
#pragma unroll
          for (int j = 0; j < NSUB; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = (wm * MSUB + i) * 16 + g + 8 * (e >> 1);
              const int c = n_warp + j * 8 + 2 * t + (e & 1);
              if (c < N) epi(r, c, acc[i][j][e]);
              acc[i][j][e] = 0.0f;
            }
      }
    }
    if (++kt == k_tiles) { kt = 0; ++nc; }
    if (++st == kStages) st = 0;
  }
  cp_async_wait<0>();
  __syncthreads();
}

template <int WARPS_M, int MSUB>
__global__ void __launch_bounds__(kSlabThreads, 1) slab_kernel(const Tower p) {
  constexpr int R = 16 * MSUB * WARPS_M;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, warp = tid / 32, ln = tid % 32;
  const int lane = blockIdx.y, row0 = blockIdx.x * R;
  const int rows = min(R, p.batch - row0);  // of this slab that exist
  const int nl = p.n_layers, B = p.batch;
  float* stages = smem + p.stage_off;
  float* s_dlog = smem + p.head_off;  // [R]
  float* s_loss = s_dlog + R;         // [R]
  float* s_red = s_loss + R;          // [warps], then the denominator
  float* ws = p.lane_ws(lane);
  const float* x = p.x + static_cast<long long>(lane) * B * p.dims[0];
  const float* label = p.label + static_cast<long long>(lane) * B;
  const float* weight = p.weight + static_cast<long long>(lane) * B;
  const float* wl = p.wl + static_cast<long long>(lane) * p.dims[nl];
  const int* seeds = p.seeds + static_cast<long long>(lane) * nl;
  auto act = [&](int i) { return smem + p.act_off[i]; };

  // Activations start as zeros: the products read every row to the end of
  // its last k-tile.
  for (int e = tid * 4; e < p.stage_off; e += kSlabThreads * 4)
    *reinterpret_cast<float4*>(smem + e) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);

  // max(sum of the lane's weights, 1), the same in every block of the lane
  {
    float s = 0.0f;
    for (int b = tid; b < B; b += kSlabThreads) s += weight[b];
    for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
    if (ln == 0) s_red[warp] = s;
    __syncthreads();
    if (tid == 0) {
      float total = 0.0f;
      for (int q = 0; q < kSlabThreads / 32; ++q) total += s_red[q];
      s_red[kSlabThreads / 32] = fmaxf(total, 1.0f);
    }
  }
  __syncthreads();
  const float denom = s_red[kSlabThreads / 32];
  const XStream xs{x + static_cast<long long>(row0) * p.dims[0], x, p.dims[0], rows,
                   p.act_vec(0)};

  // forward
  for (int i = 0; i < nl; ++i) {
    const int K = p.dims[i], N = p.dims[i + 1];
    ForwardEpi epi{act(i + 1), p.lda[i + 1],
                   p.b[i] + static_cast<long long>(lane) * N,
                   p.z[i] != nullptr ? p.z[i] + static_cast<long long>(lane) * B * N : nullptr,
                   static_cast<uint32_t>(seeds[i]), p.rate, p.scale, row0, B, N};
    const float* w = p.w[i] + static_cast<long long>(lane) * K * N;
    if (i == 0)
      slab_gemm<WARPS_M, MSUB, false, true>(nullptr, 0, xs, K, N, w, N, p.w_vec(i), stages, epi);
    else
      slab_gemm<WARPS_M, MSUB, false, false>(act(i), p.lda[i], xs, K, N, w, N, p.w_vec(i),
                                             stages, epi);
    store_rows(act(i + 1), p.lda[i + 1],
               ws + p.h_off[i] + static_cast<long long>(row0) * N, rows, N, p.act_vec(i + 1));
  }

  // head: a warp per row; logits, BCE, dlogits
  const int hid = p.dims[nl];
  const float* hl = act(nl);
  const int ldh = p.lda[nl];
  for (int r = warp; r < R; r += kSlabThreads / 32) {
    float dot = 0.0f;
    for (int j = ln; j < hid; j += 32) dot = fmaf(hl[r * ldh + j], wl[j], dot);
    for (int off = 16; off > 0; off >>= 1) dot += __shfl_down_sync(0xffffffffu, dot, off);
    if (ln == 0) {
      float bce_w = 0.0f, dlog = 0.0f;
      if (r < rows) {
        const float l = dot, y = label[row0 + r], w = weight[row0 + r];
        // sigmoid(l) - y as (1 - y) - sigmoid(-|l|) for l >= 0, so y = 1
        // does not cancel a sigmoid rounded near 1; sigmoid(-|l|) is taken
        // as torch.sigmoid takes it, 1 / (1 + exp(|l|))
        const float e = expf(-fabsf(l)), s = 1.0f / (1.0f + expf(fabsf(l)));
        bce_w = (fmaxf(l, 0.0f) - l * y + log1pf(e)) * w;
        dlog = (l >= 0.0f ? (1.0f - y) - s : s - y) * w / denom;
      }
      s_loss[r] = bce_w;
      s_dlog[r] = dlog;
    }
  }
  __syncthreads();  // also: h of the last layer is in device memory before dz overwrites it
  if (tid < rows) ws[p.dlog_off + row0 + tid] = s_dlog[tid];
  if (tid < R / kLossRows && row0 + tid * kLossRows < B) {
    float s = 0.0f;
    for (int r = 0; r < kLossRows; ++r) s += s_loss[tid * kLossRows + r];
    ws[p.part_off + row0 / kLossRows + tid] = s;
  }
  if (blockIdx.x == 0 && tid == 0) ws[p.part_off + p.n_part] = denom;
  // dz of the last hidden layer, over its h: dh = dlog wl^T through the masks
  {
    float* io = act(nl);
    for (int e = tid; e < R * hid; e += kSlabThreads) {
      const int r = e / hid, c = e % hid;
      float* q = io + r * ldh + c;
      *q = *q > 0.0f ? (s_dlog[r] * wl[c]) * p.scale : 0.0f;
    }
  }
  __syncthreads();
  store_rows(act(nl), ldh, ws + p.dz_off[nl - 1] + static_cast<long long>(row0) * hid, rows,
             hid, p.act_vec(nl));

  // backward: dh_i = dz_{i+1} W_i^T, then dz_i over h_i, or dx
  for (int i = nl - 1; i >= 0; --i) {
    const int K = p.dims[i + 1], N = p.dims[i];
    const float* w = p.w[i] + static_cast<long long>(lane) * N * K;
    if (i > 0) {
      slab_gemm<WARPS_M, MSUB, true, false>(act(i + 1), p.lda[i + 1], xs, K, N, w, K,
                                            p.w_vec(i), stages,
                                            BackwardEpi{act(i), p.lda[i], p.scale});
      store_rows(act(i), p.lda[i], ws + p.dz_off[i - 1] + static_cast<long long>(row0) * N,
                 rows, N, p.act_vec(i));
    } else {
      slab_gemm<WARPS_M, MSUB, true, false>(
          act(1), p.lda[1], xs, K, N, w, K, p.w_vec(0), stages,
          DxEpi{p.dx + (static_cast<long long>(lane) * B + row0) * N, N, rows});
    }
  }
}

// ---- launch 2: weight gradients, bias gradients, dWl and the loss ----

// dW [M, N] tile (tm, tn) = act^T [M, B] dz [B, N], reduced over the batch.
__device__ __forceinline__ void dw_tile(const float* act, int M, bool vec_a, const float* dz,
                                        int N, bool vec_b, int batch, int tm, int tn,
                                        float* dw, float* stages) {
  // 4 warps as 2 x 2, a warp 32 x 32 of the tile
  constexpr int MSUB = 2, NSUB = 4;
  const int warp = threadIdx.x / 32, ln = threadIdx.x % 32, g = ln / 4, t = ln % 4;
  const int wm = warp % 2, wn = warp / 2;
  const int m0 = tm * kTile, n0 = tn * kTile;
  const int k_tiles = (batch + kDwBK - 1) / kDwBK;

  auto issue = [&](int kt) {
    if (kLoadTiles && kt < k_tiles) {
      float* sa = stages + (kt % kDwStages) * kDwStageFloats;
      float* sb = sa + kDwBK * kLdT;
      const long long b0 = static_cast<long long>(kt) * kDwBK;
      stage<kDwBK, kTile, kDwThreads>(sa, kLdT, act + b0 * M + m0, act, M, batch - kt * kDwBK,
                                    M - m0, vec_a);
      stage<kDwBK, kTile, kDwThreads>(sb, kLdT, dz + b0 * N + n0, dz, N, batch - kt * kDwBK,
                                    N - n0, vec_b);
    }
    cp_async_commit();
  };

  float acc[MSUB][NSUB][4];
#pragma unroll
  for (int i = 0; i < MSUB; ++i)
#pragma unroll
    for (int j = 0; j < NSUB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  for (int s = 0; s < kDwStages - 1; ++s) issue(s);
  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<kDwStages - 2>();
    __syncthreads();
    issue(kt + kDwStages - 1);
    const float* sa = stages + (kt % kDwStages) * kDwStageFloats;
    const float* sb = sa + kDwBK * kLdT;
#pragma unroll
    for (int kk = 0; kk < kDwBK; kk += 8) {  // rows past the batch are zeros
      uint32_t ah[MSUB][4], al[MSUB][4], bh[NSUB][2], bl[NSUB][2];
#pragma unroll
      for (int i = 0; i < MSUB; ++i) {
        const int m = (wm * MSUB + i) * 16 + g;
        tf32_split(sa[(kk + t) * kLdT + m], ah[i][0], al[i][0]);
        tf32_split(sa[(kk + t) * kLdT + m + 8], ah[i][1], al[i][1]);
        tf32_split(sa[(kk + t + 4) * kLdT + m], ah[i][2], al[i][2]);
        tf32_split(sa[(kk + t + 4) * kLdT + m + 8], ah[i][3], al[i][3]);
      }
#pragma unroll
      for (int j = 0; j < NSUB; ++j) {
        const int n = wn * (NSUB * 8) + j * 8 + g;
        tf32_split(sb[(kk + t) * kLdT + n], bh[j][0], bl[j][0]);
        tf32_split(sb[(kk + t + 4) * kLdT + n], bh[j][1], bl[j][1]);
      }
      mma_3xtf32<MSUB, NSUB>(acc, ah, al, bh, bl);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < MSUB; ++i)
#pragma unroll
    for (int j = 0; j < NSUB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + (wm * MSUB + i) * 16 + g + 8 * (e >> 1);
        const int n = n0 + wn * (NSUB * 8) + j * 8 + 2 * t + (e & 1);
        if (m < M && n < N) dw[static_cast<long long>(m) * N + n] = acc[i][j][e];
      }
}

// out[c] = sum_b src[b, c] (times wgt[b] if kWeighted) for 8 columns from
// c0: 16 row groups of 8 independent chains each, then fixed-order sums.
template <bool kWeighted>
__device__ __forceinline__ void col_sum(const float* src, int batch, int cols, int c0,
                                        const float* wgt, float* out, float* scratch) {
  const int c = threadIdx.x % kSumCols, rg = threadIdx.x / kSumCols;
  const int col = c0 + c;
  float a[8];
#pragma unroll
  for (int u = 0; u < 8; ++u) a[u] = 0.0f;
  if (col < cols) {
    for (int b0 = rg; b0 < batch; b0 += kSumGroups * 8) {
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int b = b0 + kSumGroups * u;
        if (b < batch) {
          const float v = src[static_cast<long long>(b) * cols + col];
          a[u] = kWeighted ? fmaf(v, wgt[b], a[u]) : a[u] + v;
        }
      }
    }
  }
  scratch[rg * kSumCols + c] = ((a[0] + a[1]) + (a[2] + a[3])) + ((a[4] + a[5]) + (a[6] + a[7]));
  __syncthreads();
  if (rg == 0 && col < cols) {
    float s = 0.0f;
    for (int q = 0; q < kSumGroups; ++q) s += scratch[q * kSumCols + c];
    out[col] = s;
  }
}

__global__ void __launch_bounds__(kDwThreads) dw_kernel(const Tower p) {
  extern __shared__ __align__(16) float smem[];
  const int lane = blockIdx.y, nl = p.n_layers, B = p.batch;
  const float* ws = p.lane_ws(lane);
  int idx = blockIdx.x;
  for (int i = 0; i < nl; ++i) {  // the tiles of dW_i
    const int M = p.dims[i], N = p.dims[i + 1];
    const int tiles_n = (N + kTile - 1) / kTile;
    const int tiles = ((M + kTile - 1) / kTile) * tiles_n;
    if (idx < tiles) {
      const float* act = i == 0 ? p.x + static_cast<long long>(lane) * B * M : ws + p.h_off[i - 1];
      dw_tile(act, M, p.act_vec(i), ws + p.dz_off[i], N, p.act_vec(i + 1), B, idx / tiles_n,
              idx % tiles_n, p.dw[i] + static_cast<long long>(lane) * M * N, smem);
      return;
    }
    idx -= tiles;
  }
  for (int i = 0; i < nl; ++i) {  // db_i, 8 columns a block
    const int N = p.dims[i + 1];
    const int blocks = (N + kSumCols - 1) / kSumCols;
    if (idx < blocks) {
      col_sum<false>(ws + p.dz_off[i], B, N, idx * kSumCols, nullptr,
                     p.db[i] + static_cast<long long>(lane) * N, smem);
      return;
    }
    idx -= blocks;
  }
  // dWl = h_k^T dlogits, 8 columns a block; the first of them also the loss
  const int hid = p.dims[nl];
  col_sum<true>(ws + p.h_off[nl - 1], B, hid, idx * kSumCols, ws + p.dlog_off,
                p.dwl + static_cast<long long>(lane) * hid, smem);
  if (idx == 0 && threadIdx.x == 0) {
    float s = 0.0f;
    for (int q = 0; q < p.n_part; ++q) s += ws[p.part_off + q];
    p.loss[lane] = s / ws[p.part_off + p.n_part];
  }
}

// ---- host side ----

int g_launches = 0;  // CUDA launches issued by this library so far

// The workspace of one lane, in floats.
void lay_out_workspace(Tower& p) {
  long long off = 0;
  for (int i = 0; i < p.n_layers; ++i) {
    p.h_off[i] = off;
    off += up4(static_cast<long long>(p.batch) * p.dims[i + 1]);
  }
  for (int i = 0; i < p.n_layers; ++i) {
    p.dz_off[i] = off;
    off += up4(static_cast<long long>(p.batch) * p.dims[i + 1]);
  }
  p.dlog_off = off;
  off += up4(p.batch);
  p.n_part = (p.batch + kLossRows - 1) / kLossRows;
  p.part_off = off;
  off += up4(p.n_part + 1);
  p.ws_lane = off;
}

// slab_kernel's shared memory for slabs of slab_rows rows; returns its bytes.
long long lay_out_slab(Tower& p, int slab_rows) {
  int off = 0;
  p.lda[0] = p.act_off[0] = 0;  // x is streamed, not kept
  for (int i = 1; i <= p.n_layers; ++i) {
    // whole k-tiles (the products read each row to the end of its last one),
    // and 4 mod 32 so that a fragment load hits 32 banks
    p.lda[i] = (p.dims[i] + kBK - 1) / kBK * kBK + 4;
    p.act_off[i] = off;
    off += slab_rows * p.lda[i];
  }
  p.stage_off = off;
  p.head_off = off + kStages * stage_floats(slab_rows);
  return 4LL * (p.head_off + 2 * slab_rows + kSlabThreads / 32 + 4);
}

bool fill_dims(Tower& p, int n_layers, const int* dims, int batch) {
  if (n_layers < 1 || n_layers > kMaxLayers || batch < 1) return false;
  p.n_layers = n_layers;
  p.batch = batch;
  for (int i = 0; i <= n_layers; ++i) {
    if (dims[i] < 1) return false;
    p.dims[i] = dims[i];
  }
  return true;
}

bool aligned16(const void* q) { return reinterpret_cast<uintptr_t>(q) % 16 == 0; }

template <class Kernel>
cudaError_t allow_shared(Kernel kernel, long long bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

#define MAMDR_CHECK(call)                                   \
  do {                                                      \
    const cudaError_t err_ = (call);                        \
    if (err_ != cudaSuccess) return static_cast<int>(err_); \
  } while (0)

// Floats of workspace that mamdr_fused_tower_grad needs for each lane, or -1
// for dims it does not take.
extern "C" long long mamdr_fused_tower_scratch(int n_layers, const int* dims, int batch) {
  Tower p;
  if (!fill_dims(p, n_layers, dims, batch)) return -1;
  lay_out_workspace(p);
  return p.ws_lane;
}

// Bytes of shared memory a slab_kernel block takes with slabs of slab_rows
// rows, or -1 for dims it does not take.
extern "C" long long mamdr_fused_tower_shared(int n_layers, const int* dims, int slab_rows) {
  Tower p;
  if (!fill_dims(p, n_layers, dims, 1)) return -1;
  return lay_out_slab(p, slab_rows);
}

// CUDA launches issued so far by mamdr_fused_tower_grad in this process.
extern "C" int mamdr_fused_tower_launch_count() { return g_launches; }

// Every tensor carries a leading lane axis of `lanes` (1 for the single-lane
// step) and is contiguous; w_, b_, dw_, db_ hold one pointer per layer, z_
// too or is null. workspace_ holds workspace_floats floats, 16-byte aligned:
// at least lanes * mamdr_fused_tower_scratch(...), or the call is refused.
// slab_rows is 64, 32 or 16 (the wrapper's plan).
extern "C" int mamdr_fused_tower_grad(
    int lanes, int n_layers, const int* dims, int batch, int slab_rows, const void* x_,
    const void* label, const void* weight, const void* seeds_, void* const* w_,
    void* const* b_, const void* wl_, float rate, float scale, void* loss, void* dx,
    void* const* dw_, void* const* db_, void* dwl, void* const* z_, void* workspace_,
    long long workspace_floats, void* stream_) {
  Tower p;
  if (lanes < 1 || lanes > 65535 || !fill_dims(p, n_layers, dims, batch) ||
      (slab_rows != 64 && slab_rows != 32 && slab_rows != 16) || !aligned16(workspace_))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  p.rate = rate;
  p.scale = scale;
  p.x = static_cast<const float*>(x_);
  p.label = static_cast<const float*>(label);
  p.weight = static_cast<const float*>(weight);
  p.wl = static_cast<const float*>(wl_);
  p.seeds = static_cast<const int*>(seeds_);
  p.loss = static_cast<float*>(loss);
  p.dx = static_cast<float*>(dx);
  p.dwl = static_cast<float*>(dwl);
  p.ws = static_cast<float*>(workspace_);
  p.vec = 0;
  for (int i = 0; i < kMaxLayers; ++i) {
    const bool on = i < n_layers;
    p.w[i] = on ? static_cast<const float*>(w_[i]) : nullptr;
    p.b[i] = on ? static_cast<const float*>(b_[i]) : nullptr;
    p.dw[i] = on ? static_cast<float*>(dw_[i]) : nullptr;
    p.db[i] = on ? static_cast<float*>(db_[i]) : nullptr;
    p.z[i] = on && z_ != nullptr ? static_cast<float*>(z_[i]) : nullptr;
    if (on && dims[i + 1] % 4 == 0) {
      p.vec |= 1u << (i + 1);  // h_i and dz_i in the workspace
      if (aligned16(p.w[i])) p.vec |= 1u << (16 + i);
    }
  }
  if (dims[0] % 4 == 0 && aligned16(p.x)) p.vec |= 1u;
  lay_out_workspace(p);
  const long long slab_bytes = lay_out_slab(p, slab_rows);
  if (slab_bytes > kMaxSharedBytes || workspace_floats < lanes * p.ws_lane)
    return static_cast<int>(cudaErrorInvalidValue);

  const dim3 grid1((batch + slab_rows - 1) / slab_rows, lanes);
  if (slab_rows == 64) {
    MAMDR_CHECK(allow_shared(slab_kernel<2, 2>, slab_bytes));
    slab_kernel<2, 2><<<grid1, kSlabThreads, slab_bytes, stream>>>(p);
  } else if (slab_rows == 32) {
    MAMDR_CHECK(allow_shared(slab_kernel<2, 1>, slab_bytes));
    slab_kernel<2, 1><<<grid1, kSlabThreads, slab_bytes, stream>>>(p);
  } else {
    MAMDR_CHECK(allow_shared(slab_kernel<1, 1>, slab_bytes));
    slab_kernel<1, 1><<<grid1, kSlabThreads, slab_bytes, stream>>>(p);
  }
  ++g_launches;
  MAMDR_CHECK(cudaGetLastError());

  int blocks = (dims[n_layers] + kSumCols - 1) / kSumCols;  // dWl
  for (int i = 0; i < n_layers; ++i)
    blocks += ((dims[i] + kTile - 1) / kTile) * ((dims[i + 1] + kTile - 1) / kTile) +
              (dims[i + 1] + kSumCols - 1) / kSumCols;
  const long long dw_bytes = 4LL * kDwStages * kDwStageFloats;
  MAMDR_CHECK(allow_shared(dw_kernel, dw_bytes));
  dw_kernel<<<dim3(blocks, lanes), kDwThreads, dw_bytes, stream>>>(p);
  ++g_launches;
  return static_cast<int>(cudaGetLastError());
}
