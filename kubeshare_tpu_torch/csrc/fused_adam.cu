// Fused Adam step for Hopper (sm_90a): one in-place pass over p, g, m, v.
//
// Replaces: kubeshare_tpu/ops/fused_adam.py, `_kernel` (the Pallas TPU
// kernel launched by `_fused_flat` through `pl.pallas_call`).
//
// What bounds it on the card: bytes. Per fp32 parameter the step reads p,
// g, m, v and writes p, m, v: 7 x 4 = 28 bytes for about 15 floating-point
// operations, far below the ~20 operations per byte where an H100's fp32
// units would become the limit. mnist's 824,458 parameters move ~23 MB a
// step, ~7 us at 3.35 TB/s.
//
// What the design does about it:
// - every tensor is read once and written once, in place (the TPU kernel's
//   input_output_aliases), so the step allocates nothing;
// - each thread moves 16-byte vectors (float4) of p, g, m and v, so a warp
//   issues fully coalesced 512-byte transactions; a ragged end (n % 4) is
//   done by the first threads of the grid as scalars, in the same launch;
// - the step count t is read from a device pointer, like the TPU kernel's
//   SMEM scalar: in the proxy's fused loop Adam's count lives on the card,
//   and passing t by value would cost a host sync (.item()) every step;
// - one launch per leaf, as adam_update_tree launches once per leaf on the
//   TPU. A multi-tensor launch over a pointer table would save launches on
//   trees of many small leaves; that is later work.
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

// p, g, m, v all 16-byte aligned: float4 body plus scalar tail.
__global__ void adam_vec4_kernel(float* __restrict__ p,
                                 const float* __restrict__ g,
                                 float* __restrict__ m,
                                 float* __restrict__ v,
                                 const float* __restrict__ step,
                                 long long n, AdamHyper h) {
  float bc1, bc2;
  bias_corrections(step, h, &bc1, &bc2);
  const long long nvec = n / 4;
  const long long tid = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  float4* p4 = reinterpret_cast<float4*>(p);
  const float4* g4 = reinterpret_cast<const float4*>(g);
  float4* m4 = reinterpret_cast<float4*>(m);
  float4* v4 = reinterpret_cast<float4*>(v);
  for (long long i = tid; i < nvec; i += stride) {
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
  const long long j = nvec * 4 + tid;  // at most 3 tail elements
  if (j < n) {
    float pj = p[j], mj = m[j], vj = v[j];
    adam_elem(pj, __ldg(&g[j]), mj, vj, bc1, bc2, h);
    p[j] = pj;
    m[j] = mj;
    v[j] = vj;
  }
}

// Any alignment (a view that starts mid-storage): scalar grid-stride loop.
__global__ void adam_scalar_kernel(float* __restrict__ p,
                                   const float* __restrict__ g,
                                   float* __restrict__ m,
                                   float* __restrict__ v,
                                   const float* __restrict__ step,
                                   long long n, AdamHyper h) {
  float bc1, bc2;
  bias_corrections(step, h, &bc1, &bc2);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < n; i += stride) {
    float pi = p[i], mi = m[i], vi = v[i];
    adam_elem(pi, __ldg(&g[i]), mi, vi, bc1, bc2, h);
    p[i] = pi;
    m[i] = mi;
    v[i] = vi;
  }
}

constexpr int kThreads = 256;
// grid-stride cap: 132 SMs x 8 resident blocks of 256 threads
constexpr long long kMaxBlocks = 132 * 8;

}  // namespace

extern "C" {

// One Adam step over n fp32 elements, in place on p, m and v. `step`
// points at one fp32 on the device: the 1-based step count t. Launches on
// `stream`, does not synchronize, returns cudaGetLastError().
int kst_fused_adam(void* p, const void* g, void* m, void* v,
                   const void* step, long long n, float lr, float b1,
                   float b2, float one_minus_b1, float one_minus_b2,
                   float eps, void* stream) {
  if (n <= 0) return 0;
  AdamHyper h{lr, b1, b2, one_minus_b1, one_minus_b2, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t any = reinterpret_cast<uintptr_t>(p) |
                        reinterpret_cast<uintptr_t>(g) |
                        reinterpret_cast<uintptr_t>(m) |
                        reinterpret_cast<uintptr_t>(v);
  if (any % 16 == 0) {
    long long work = n / 4 > 0 ? n / 4 : 1;  // >= one thread for the tail
    long long blocks = (work + kThreads - 1) / kThreads;
    if (blocks > kMaxBlocks) blocks = kMaxBlocks;
    adam_vec4_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
        static_cast<float*>(p), static_cast<const float*>(g),
        static_cast<float*>(m), static_cast<float*>(v),
        static_cast<const float*>(step), n, h);
  } else {
    long long blocks = (n + kThreads - 1) / kThreads;
    if (blocks > kMaxBlocks) blocks = kMaxBlocks;
    adam_scalar_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
        static_cast<float*>(p), static_cast<const float*>(g),
        static_cast<float*>(m), static_cast<float*>(v),
        static_cast<const float*>(step), n, h);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* kst_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
