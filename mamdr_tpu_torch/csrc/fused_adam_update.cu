// Kernel K4: the train step's flat Adam, its apply and its all-pad gate in
// one streaming pass over the trainable leaves of one tower or of L lanes.
//
// For every element of every trainable leaf, in lane l:
//
//   mu'  = b1 * mu + (1 - b1) * g
//   nu'  = b2 * nu + (1 - b2) * (g * g)
//   step = (-lr * (mu' / bc1[l])) / (sqrt(nu' / bc2[l]) + eps)
//   p'   = p + step
//   and where has_data[l] is 0 (the lane's batch is all padding):
//   p', mu', nu' = p, mu, nu
//
// p, g and p' are a leaf each (numel elements a lane, lanes one after the
// other); mu and nu are the flat [L, n] slots in leaf order, leaf i at slot
// offset off_i of each lane's n. p, mu and nu may also be one lane read by
// every lane (lane stride 0: a lane state broadcast from one tower before
// its first step). Outputs are fresh buffers: the train state is
// functional, nothing is written in place. bc1 = 1 - b1^count and
// bc2 = 1 - b2^count (count after the increment) come from the caller's own
// PyTorch ops, one a lane.
//
// It replaces no TPU kernel: the JAX package leaves flat Adam, the update
// and the all-pad gate to XLA, which fuses them into one loop
// (mamdr_tpu/train/flat_optimizer.py, mamdr_tpu/train/steps.py:148-165).
// The port ran them as eager PyTorch: a torch.cat of the gradients, about
// 18 elementwise ops over [L, n], an add a leaf, and three torch.where
// passes (params, mu, nu) — about 43 reads and writes of an [L, n] slab a
// step where 7 are needed. With trainable 100000 x 128 user and item tables
// a lane holds 25.7M floats (103 MB), so at 7 lanes one slab is 721 MB.
//
// Bound on an H100 SXM: bytes. Each element reads p, g, mu, nu and writes
// p', mu', nu': 28 bytes, 5.045 GB a step at 7 lanes, 1.506 ms at
// 3.35 TB/s. The arithmetic (three IEEE divisions and a square root an
// element) stays well under the SMs' issue rate at that byte rate.
//
// Design: the work is a flat space of tiles, kTile elements of one leaf in
// one lane; block b takes tile b % tiles of lane b / tiles and finds its
// leaf by the descriptors' first tiles. A thread holds kUnroll float4 of
// each of p, g, mu and nu (16-byte loads, neighbouring threads on
// neighbouring addresses) before it computes and stores, so enough bytes are
// in flight to cover the card's memory latency. Loads and stores are
// streaming (evict-first): nothing is read twice. A lane whose batch is all
// padding copies p, mu and nu without reading g. A leaf whose elements a
// lane, slot offset, slot count or base addresses do not keep float4s
// aligned takes a scalar path of the same arithmetic (kUnroll * 4 elements a
// thread), so any leaf order is taken as it is.
//
// The arithmetic is flat_optimizer.FlatAdam's and apply_updates', operation
// for operation, in float32 with round-to-nearest intrinsics that nvcc never
// contracts into a fused multiply-add: the results equal PyTorch's
// elementwise kernels bit for bit. The scalars arrive as float32, cast from
// the Python floats as PyTorch casts a scalar operand.
//
// The descriptors travel by value in the kernel's parameters (a
// __grid_constant__ struct, read with a dynamic index without a copy to
// local memory); up to kMaxLeaves leaves a launch.
//
// C interface for ctypes: returns the cudaError_t of the launch.

#include <cuda_runtime.h>

#include <cstdint>

namespace mamdr_k4 {

constexpr int kMaxLeaves = 48;  // the Plan stays under 4 KB of parameters
constexpr int kThreads = 256;
constexpr int kUnroll = 4;                     // float4 of each operand a thread
constexpr int kTile = kThreads * kUnroll * 4;  // elements a block

struct Leaf {
  const float* p;      // [lanes, numel], lanes p_stride apart
  const float* g;      // [lanes, numel]
  float* out;          // [lanes, numel]
  long long numel;     // elements of one lane
  long long p_stride;  // elements between p's lanes: numel, or 0 (one lane read by all)
  long long slot;      // the leaf's first slot in a lane's n
  long long tile0;     // the leaf's first tile in a lane
  int vec;             // 1: float4 path (every address float4-aligned)
  int pad;
};

// What the wrapper fills in (ops/fused_adam_update.py::_Plan mirrors it).
struct Plan {
  Leaf leaf[kMaxLeaves];
  const float* mu;
  const float* nu;
  float* mu_out;
  float* nu_out;
  const float* bc1;                // [lanes]
  const float* bc2;                // [lanes]
  const unsigned char* has_data;   // [lanes] bool
  long long slots;                 // n: slots of one lane (mu_out, nu_out: lanes n apart)
  long long mu_stride;             // elements between mu's lanes: n, or 0
  long long nu_stride;             // elements between nu's lanes: n, or 0
  long long tiles;                 // tiles of one lane over this launch's leaves
  int n_leaves;
  int lanes;
  float b1, c1, b2, c2, neg_lr, eps;  // c1 = 1 - b1, c2 = 1 - b2, neg_lr = -lr
};

}  // namespace mamdr_k4

namespace {

using mamdr_k4::kMaxLeaves;
using mamdr_k4::kThreads;
using mamdr_k4::kTile;
using mamdr_k4::kUnroll;
using mamdr_k4::Leaf;
using mamdr_k4::Plan;

struct Coef {
  float b1, c1, b2, c2, neg_lr, eps, bc1, bc2;
};

__device__ __forceinline__ void adam(const Coef& k, float p, float g, float m, float v,
                                     float& po, float& mo, float& vo) {
  mo = __fadd_rn(__fmul_rn(k.b1, m), __fmul_rn(k.c1, g));
  vo = __fadd_rn(__fmul_rn(k.b2, v), __fmul_rn(k.c2, __fmul_rn(g, g)));
  const float mh = __fdiv_rn(mo, k.bc1);
  const float vh = __fdiv_rn(vo, k.bc2);
  po = __fadd_rn(p, __fdiv_rn(__fmul_rn(k.neg_lr, mh), __fadd_rn(__fsqrt_rn(vh), k.eps)));
}

__device__ __forceinline__ void adam4(const Coef& k, const float4& p, const float4& g,
                                      const float4& m, const float4& v, float4& po, float4& mo,
                                      float4& vo) {
  adam(k, p.x, g.x, m.x, v.x, po.x, mo.x, vo.x);
  adam(k, p.y, g.y, m.y, v.y, po.y, mo.y, vo.y);
  adam(k, p.z, g.z, m.z, v.z, po.z, mo.z, vo.z);
  adam(k, p.w, g.w, m.w, v.w, po.w, mo.w, vo.w);
}

__global__ void __launch_bounds__(kThreads)
    adam_update_kernel(const __grid_constant__ Plan plan) {
  const long long lane = blockIdx.x / plan.tiles;
  const long long t = blockIdx.x - lane * plan.tiles;
  int i = 0;
  while (i + 1 < plan.n_leaves && plan.leaf[i + 1].tile0 <= t) ++i;
  const Leaf& lf = plan.leaf[i];
  const long long e0 = (t - lf.tile0) * kTile;
  const int count = static_cast<int>(min(static_cast<long long>(kTile), lf.numel - e0));
  const long long pb = lane * lf.p_stride + e0;              // p
  const long long gb = lane * lf.numel + e0;                 // g, out
  const long long mb = lane * plan.mu_stride + lf.slot + e0;  // mu
  const long long vb = lane * plan.nu_stride + lf.slot + e0;  // nu
  const long long ob = lane * plan.slots + lf.slot + e0;     // mu_out, nu_out
  const bool has = plan.has_data[lane] != 0;
  const Coef k{plan.b1, plan.c1, plan.b2, plan.c2, plan.neg_lr, plan.eps,
               plan.bc1[lane], plan.bc2[lane]};

  if (lf.vec) {
    const float4* p4 = reinterpret_cast<const float4*>(lf.p + pb);
    const float4* g4 = reinterpret_cast<const float4*>(lf.g + gb);
    const float4* m4 = reinterpret_cast<const float4*>(plan.mu + mb);
    const float4* v4 = reinterpret_cast<const float4*>(plan.nu + vb);
    float4* po4 = reinterpret_cast<float4*>(lf.out + gb);
    float4* mo4 = reinterpret_cast<float4*>(plan.mu_out + ob);
    float4* vo4 = reinterpret_cast<float4*>(plan.nu_out + ob);
    const int n4 = count / 4;  // numel and kTile are multiples of 4 here
    float4 p[kUnroll], g[kUnroll], m[kUnroll], v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = u * kThreads + threadIdx.x;
      if (j < n4) {
        p[u] = __ldcs(p4 + j);
        m[u] = __ldcs(m4 + j);
        v[u] = __ldcs(v4 + j);
        if (has) g[u] = __ldcs(g4 + j);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = u * kThreads + threadIdx.x;
      if (j < n4) {
        if (has) adam4(k, p[u], g[u], m[u], v[u], p[u], m[u], v[u]);
        __stcs(po4 + j, p[u]);
        __stcs(mo4 + j, m[u]);
        __stcs(vo4 + j, v[u]);
      }
    }
    return;
  }

  constexpr int kScalar = kUnroll * 4;
  float p[kScalar], g[kScalar], m[kScalar], v[kScalar];
#pragma unroll
  for (int u = 0; u < kScalar; ++u) {
    const int j = u * kThreads + threadIdx.x;
    if (j < count) {
      p[u] = __ldcs(lf.p + pb + j);
      m[u] = __ldcs(plan.mu + mb + j);
      v[u] = __ldcs(plan.nu + vb + j);
      if (has) g[u] = __ldcs(lf.g + gb + j);
    }
  }
#pragma unroll
  for (int u = 0; u < kScalar; ++u) {
    const int j = u * kThreads + threadIdx.x;
    if (j < count) {
      if (has) adam(k, p[u], g[u], m[u], v[u], p[u], m[u], v[u]);
      __stcs(lf.out + gb + j, p[u]);
      __stcs(plan.mu_out + ob + j, m[u]);
      __stcs(plan.nu_out + ob + j, v[u]);
    }
  }
}

}  // namespace

// sizeof(Plan) and the tile: the wrapper checks its mirror against both.
extern "C" int mamdr_adam_update_plan_bytes() { return static_cast<int>(sizeof(Plan)); }
extern "C" int mamdr_adam_update_tile() { return kTile; }
extern "C" int mamdr_adam_update_max_leaves() { return kMaxLeaves; }

// blocks is lanes * tiles (the wrapper's adam_plan): one block a tile.
extern "C" int mamdr_adam_update(const Plan* plan, long long blocks, void* stream) {
  const Plan& p = *plan;
  if (p.n_leaves < 1 || p.n_leaves > kMaxLeaves || p.lanes < 1 || p.tiles < 1 ||
      p.slots < 1 || (p.mu_stride != 0 && p.mu_stride != p.slots) ||
      (p.nu_stride != 0 && p.nu_stride != p.slots) || p.mu == nullptr || p.nu == nullptr ||
      p.mu_out == nullptr || p.nu_out == nullptr || p.bc1 == nullptr || p.bc2 == nullptr ||
      p.has_data == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (blocks != static_cast<long long>(p.lanes) * p.tiles || blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  auto misaligned = [](const void* a) { return reinterpret_cast<std::uintptr_t>(a) % 16 != 0; };
  const bool slots_aligned = !(misaligned(p.mu) || misaligned(p.nu) || misaligned(p.mu_out) ||
                               misaligned(p.nu_out) || p.slots % 4 != 0);
  long long tile = 0;
  for (int i = 0; i < p.n_leaves; ++i) {
    const Leaf& lf = p.leaf[i];
    if (lf.p == nullptr || lf.g == nullptr || lf.out == nullptr || lf.numel < 1 ||
        (lf.p_stride != 0 && lf.p_stride != lf.numel) || lf.tile0 != tile || lf.slot < 0 ||
        lf.slot + lf.numel > p.slots ||
        (lf.vec && (lf.numel % 4 != 0 || lf.slot % 4 != 0 || !slots_aligned ||
                    misaligned(lf.p) || misaligned(lf.g) || misaligned(lf.out))))
      return static_cast<int>(cudaErrorInvalidValue);
    tile += (lf.numel + kTile - 1) / kTile;
  }
  if (tile != p.tiles) return static_cast<int>(cudaErrorInvalidValue);
  adam_update_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
