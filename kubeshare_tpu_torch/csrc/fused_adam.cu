// Fused Adam step for Hopper (sm_90a): one multi-tensor launch updates a
// whole tree of (p, g, m, v) leaves in place.
//
// Replaces: kubeshare_tpu/ops/fused_adam.py, `_kernel` (the Pallas TPU
// kernel launched by `_fused_flat` through `pl.pallas_call`, once per leaf
// by `adam_update_tree`).
//
// What bounds it on the card: bytes. Per fp32 parameter the step reads p,
// g, m, v and writes p, m, v: 7 x 4 = 28 bytes for about 15 floating-point
// operations, far below the ~20 operations per byte where an H100's fp32
// units would become the limit. mnist's 824,458 parameters move ~23 MB a
// step, ~7 us at 3.35 TB/s; the transformer's 5,322,240 in 46 leaves ~149
// MB, ~45 us.
//
// What the design does about it:
// - one launch per step, not one per leaf: a tree of many small leaves
//   (46 for the transformer, most of a few hundred elements) spent more
//   in launches and their host calls than in moving bytes. The launch
//   takes a table of the leaves' pointers and sizes by value, as a
//   __grid_constant__ kernel parameter (about 3 KB of the 4 KB a launch
//   may carry), so nothing is copied to the device before it and no
//   device table has to outlive it. A tree of more than kTableLeaves
//   leaves takes one launch per kTableLeaves (the wrapper splits it);
// - the grid walks fixed chunks of kChunk elements over all leaves, a
//   chunk's leaf found by a binary search over the table's prefix counts,
//   so small and large leaves share the card evenly;
// - every tensor is read once and written once, in place (the TPU kernel's
//   input_output_aliases), so the step allocates nothing;
// - a leaf whose four pointers are 16-byte aligned moves 16-byte vectors
//   (float4), so a warp issues fully coalesced 512-byte transactions, and
//   its ragged end (n % 4) is done as scalars in its last chunk; a leaf
//   that is not aligned (a view that starts mid-storage) is done as
//   scalars, in the same launch;
// - the step count t is read from a device pointer, like the TPU kernel's
//   SMEM scalar: in the proxy's fused loop Adam's count lives on the card,
//   and passing t by value would cost a host sync (.item()) every step.
// The JAX kernel's padding to (8, 128) tiles is not carried over: a CUDA
// grid masks its own ragged edge.
//
// Arithmetic: exactly `_adam_math` of the JAX package and of the plain
// PyTorch version in ops/fused_adam.py, in the same order, in fp32. Built
// without --use_fast_math (IEEE division and sqrtf) and with --fmad=false,
// so every operation rounds where the plain version's rounds.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct AdamHyper {
  float lr, b1, b2, one_minus_b1, one_minus_b2, eps;
};

// leaves one launch takes; ops/fused_adam.py TABLE_LEAVES says the same
constexpr int kTableLeaves = 64;
// elements a block takes at a time (a multiple of 4: float4 runs never
// cross a chunk)
constexpr long long kChunk = 2048;
constexpr int kThreads = 256;
// grid-stride cap: 132 SMs x 8 resident blocks of 256 threads
constexpr int kMaxBlocks = 132 * 8;

struct AdamTable {
  float* p[kTableLeaves];
  const float* g[kTableLeaves];
  float* m[kTableLeaves];
  float* v[kTableLeaves];
  long long n[kTableLeaves];
  int chunk0[kTableLeaves + 1];  // first chunk of each leaf; [count]: total
  unsigned long long vec;        // bit i: leaf i is 16-byte aligned
  int count;
};

__device__ __forceinline__ void adam_elem(float& p, float g, float& m,
                                          float& v, float bc1, float bc2,
                                          const AdamHyper& h) {
  float m_new = h.b1 * m + h.one_minus_b1 * g;
  float v_new = h.b2 * v + h.one_minus_b2 * (g * g);
  float m_hat = m_new / bc1;
  float v_hat = v_new / bc2;
  p = p - h.lr * m_hat / (sqrtf(v_hat) + h.eps);
  m = m_new;
  v = v_new;
}

__device__ __forceinline__ void bias_corrections(const float* step,
                                                 const AdamHyper& h,
                                                 float* bc1, float* bc2) {
  float t = __ldg(step);
  *bc1 = 1.0f - powf(h.b1, t);
  *bc2 = 1.0f - powf(h.b2, t);
}

__device__ __forceinline__ void adam_scalar(float* p, const float* g,
                                            float* m, float* v,
                                            long long j, float bc1,
                                            float bc2, const AdamHyper& h) {
  float pj = p[j], mj = m[j], vj = v[j];
  adam_elem(pj, __ldg(&g[j]), mj, vj, bc1, bc2, h);
  p[j] = pj;
  m[j] = mj;
  v[j] = vj;
}

__global__ void __launch_bounds__(kThreads)
    adam_multi_tensor_kernel(const __grid_constant__ AdamTable t,
                             const float* __restrict__ step, AdamHyper h) {
  float bc1, bc2;
  bias_corrections(step, h, &bc1, &bc2);
  const int total = t.chunk0[t.count];
  for (int c = blockIdx.x; c < total; c += gridDim.x) {
    // the chunk's leaf: the last one whose first chunk is at or before c
    int lo = 0, hi = t.count - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) / 2;
      if (t.chunk0[mid] <= c) {
        lo = mid;
      } else {
        hi = mid - 1;
      }
    }
    float* p = t.p[lo];
    const float* g = t.g[lo];
    float* m = t.m[lo];
    float* v = t.v[lo];
    const long long begin = (long long)(c - t.chunk0[lo]) * kChunk;
    const long long end =
        begin + kChunk < t.n[lo] ? begin + kChunk : t.n[lo];
    if ((t.vec >> lo) & 1ull) {
      const long long v0 = begin / 4, v1 = end / 4;
      float4* p4 = reinterpret_cast<float4*>(p);
      const float4* g4 = reinterpret_cast<const float4*>(g);
      float4* m4 = reinterpret_cast<float4*>(m);
      float4* v4 = reinterpret_cast<float4*>(v);
      for (long long i = v0 + threadIdx.x; i < v1; i += kThreads) {
        float4 pp = p4[i];
        float4 gg = __ldg(&g4[i]);
        float4 mm = m4[i];
        float4 vv = v4[i];
        adam_elem(pp.x, gg.x, mm.x, vv.x, bc1, bc2, h);
        adam_elem(pp.y, gg.y, mm.y, vv.y, bc1, bc2, h);
        adam_elem(pp.z, gg.z, mm.z, vv.z, bc1, bc2, h);
        adam_elem(pp.w, gg.w, mm.w, vv.w, bc1, bc2, h);
        p4[i] = pp;
        m4[i] = mm;
        v4[i] = vv;
      }
      const long long j = v1 * 4 + threadIdx.x;  // at most 3 tail elements
      if (j < end) adam_scalar(p, g, m, v, j, bc1, bc2, h);
    } else {
      for (long long j = begin + threadIdx.x; j < end; j += kThreads) {
        adam_scalar(p, g, m, v, j, bc1, bc2, h);
      }
    }
  }
}

}  // namespace

extern "C" {

// One Adam step over n_leaves <= kTableLeaves fp32 leaves, in place on
// each leaf's p, m and v. `ptrs` holds 4 * n_leaves device pointers, leaf
// by leaf: p, g, m, v; `sizes` holds each leaf's element count. `step`
// points at one fp32 on the device: the 1-based step count t. One launch
// on `stream`; does not synchronize; returns cudaGetLastError().
int kst_fused_adam_multi(void* const* ptrs, const long long* sizes,
                         int n_leaves, const void* step, float lr, float b1,
                         float b2, float one_minus_b1, float one_minus_b2,
                         float eps, void* stream) {
  if (n_leaves < 0 || n_leaves > kTableLeaves) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  AdamTable t = {};
  long long chunks = 0;
  for (int i = 0; i < n_leaves; ++i) {
    if (sizes[i] < 0) return static_cast<int>(cudaErrorInvalidValue);
    t.p[i] = static_cast<float*>(ptrs[4 * i]);
    t.g[i] = static_cast<const float*>(ptrs[4 * i + 1]);
    t.m[i] = static_cast<float*>(ptrs[4 * i + 2]);
    t.v[i] = static_cast<float*>(ptrs[4 * i + 3]);
    t.n[i] = sizes[i];
    const uintptr_t any = reinterpret_cast<uintptr_t>(ptrs[4 * i]) |
                          reinterpret_cast<uintptr_t>(ptrs[4 * i + 1]) |
                          reinterpret_cast<uintptr_t>(ptrs[4 * i + 2]) |
                          reinterpret_cast<uintptr_t>(ptrs[4 * i + 3]);
    if (any % 16 == 0) t.vec |= 1ull << i;
    t.chunk0[i] = static_cast<int>(chunks);
    chunks += (sizes[i] + kChunk - 1) / kChunk;
    if (chunks > 0x7fffffffLL) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  t.chunk0[n_leaves] = static_cast<int>(chunks);
  t.count = n_leaves;
  if (chunks == 0) return 0;
  AdamHyper h{lr, b1, b2, one_minus_b1, one_minus_b2, eps};
  const int blocks = chunks < kMaxBlocks ? static_cast<int>(chunks)
                                         : kMaxBlocks;
  adam_multi_tensor_kernel<<<blocks, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      t, static_cast<const float*>(step), h);
  return static_cast<int>(cudaGetLastError());
}

int kst_fused_adam_table_leaves(void) { return kTableLeaves; }

const char* kst_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
