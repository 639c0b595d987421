// Flash attention for Hopper (sm_90a): forward, dQ and dK/dV.
//
// Replaces the three Pallas TPU kernels of kubeshare_tpu/ops/flash_attention.py
// behind one custom_vjp:
// - flash_fwd_mma_kernel (bf16 inputs) and flash_fwd_kernel (fp32 inputs)
//                     <- `_kernel`          (launched by `_flash_fwd`)
// - flash_dq_kernel   <- `_bwd_dq_kernel`   (launched by `_flash_bwd`)
// - flash_dkv_kernel  <- `_bwd_dkv_kernel`  (launched by `_flash_bwd`)
//
// What bounds them on the card: bytes. At the transformer's shape (q, k, v
// (8, 256, 8, 32) bf16, causal) the forward reads q, k and v once (3 x 1 MB)
// and writes O in fp32 (2 MB) and the lse (64 KB): about 5.3 MB, 1.6 us at
// 3.35 TB/s. Its arithmetic is 2 x 2 x 32 operations on each of the ~2.1 M
// visible (q, k) pairs, 0.27 us of bf16 tensor-core work. At long context
// (1, 8192, 8, 32) the operations bound it: 34 G of them, 35 us. The
// backward passes are bound the same way.
//
// The bf16 forward (flash_fwd_mma_kernel), the transformer's main path,
// runs on the tensor cores:
// - one block of 4 warps per (b*h row, 64-row q tile); each warp owns 16
//   q rows, held in registers as mma fragments (ldmatrix) for the whole
//   k loop, and skips a k tile none of its rows sees. The q tiles are
//   launched heaviest first (the causal rows that see the most keys), so
//   the long rows do not form a tail;
// - k/v tiles of 64 keys move through a two-stage ring in shared memory
//   with 16-byte cp.async copies, the next tile in flight while the
//   current one is computed. A shared row is padded to an odd number of
//   16-byte pieces, so the eight rows an ldmatrix phase reads fall in
//   distinct banks. q, k or v rows that are not 16-byte aligned take the
//   same kernel with plain loads (kAsync = false), chosen at launch;
// - S = Q.K^T is mma.sync m16n8k16 (bf16 in, fp32 accumulate); bf16
//   products are exact in fp32, and the scale is applied to the fp32
//   product (q is not rounded to bf16 after scaling: 1/sqrt(32) is not a
//   power of two). Head dim 8 zero-pads the depth to 16;
// - the online softmax runs on the accumulator fragments in registers,
//   row max and sum across the quad of threads that holds a row
//   (__shfl_xor_sync); the scale goes into the exponent, so a score costs
//   one fused multiply-add and one ex2.approx: p = 2^(s scale log2(e) -
//   m scale log2(e));
// - O += P.V is two mma.sync against the same V fragment: P_hi = bf16(P)
//   and P_lo = bf16(P - P_hi). V is exact in bf16 and P_hi + P_lo keeps
//   ~16 bits of P, so O keeps the fp32 tolerance that rounding P to bf16
//   (2^-9 relative) would break;
// - ragged q/k edges and the causal/window band are masked on the
//   fragments, zero-filled padding keys included (their score is set to
//   the mask floor, not left at 0); fully masked k tiles are skipped.
//
// The fp32 forward (flash_fwd_kernel, off the main path) and the backward
// passes are the simple first versions: every pair is computed in fp32 on
// the CUDA cores (67 TFLOP/s, not the tensor cores), so they run far above
// the bound. What they keep from the flash schedule is the memory
// argument: no (s x s) score matrix ever reaches device memory, every
// output has exactly one writer (no atomics), and fully masked tiles are
// skipped.
//
// How the TPU grid translates. Pallas walks the innermost grid dimension in
// order with the scratch carried across it; here one block loops over that
// dimension itself:
// - forward: one block per (b*h, q tile), looping over k tiles; the running
//   max, sum and accumulator of each query row live in registers;
// - dQ: one block per (b*h, q tile), looping over k tiles;
// - dK/dV: one block per (b*hk, k tile), looping over the kv head's group of
//   q heads x q tiles, so the GQA group sum stays in registers and dK/dV are
//   kv-sized. k and v are never expanded: q row (bi, hq) reads kv head
//   hq / group (`_kv_row_map`).
// The simple kernels' block has kTile = 64 threads, one per query row
// (fp32 forward, dQ) or key row (dK/dV). k/v (or q/dO) tiles of 64 rows are
// staged in shared memory as fp32 and read by every thread of the block at
// once (broadcast).
//
// Tiles: the kernel's tile is its own (64 x 64), not the caller's
// block_q/block_k, which are checked by the wrapper exactly as the JAX
// `_blocks` checks them. The result does not depend on the tile: a masked
// score contributes exactly 0 (the TPU kernel's `where` guards), so
// skipping a dead tile (`_live_fwd` with this kernel's tile) or masking
// inside a live one gives the same sums; only the order of fp32 additions
// differs.
//
// Semantics kept from the TPU kernels:
// - scores are fp32 products of the inputs times the scale (`_score_tile`);
// - the mask floor is MASK_VALUE = -1e30, not -inf; the running max starts
//   there, and alpha = m > MASK/2 ? exp(m - m_new) : 0,
//   p = s > MASK/2 ? exp(s - m_new) : 0;
// - a row with nothing visible gives O = 0 and lse = m + log(1);
// - dQ multiplies by scale once, at the end; dK takes it through the
//   pre-scaled Qs; D = rowsum(dO * O) - g_lse comes from the caller;
// - O and lse are fp32; dQ, dK and dV are written in q's, k's and v's type.
// The backward passes rebuild P from the forward's lse with their own fp32
// score formula, so forward and backward agree to fp32 rounding.
//
// Head dims 8 and 32: 32 at the transformer's full width, 8 in its small
// preset. Other head dims are refused (cudaErrorInvalidValue); a model that
// needs one adds its case to by_head_dim (at 64 the dK/dV pass would hold
// 4 x 64 fp32 values a thread and spill).
//
// Built without --use_fast_math and with --fmad=false (ops/build.py): expf
// and logf are the accurate library versions, the bf16 forward's fused
// multiply-adds are written out (__fmaf_rn) and its ex2.approx is good to
// ~2^-22; all of them and the summation order differ from torch's, so the
// kernels are held to their plain versions with a tolerance
// (ops/flash_attention.py says which).
//
// Tried on the card and not kept: 8-warp blocks of 128 q rows (slower at
// the main shape, no faster at seq 8192), and splitting a block's k tiles
// between two groups of 4 warps with a merge at the end (a little faster
// at the main shape, slower at seq 8192).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kMask = -1e30f;  // MASK_VALUE of ops/attention.py
constexpr int kTile = 64;        // threads per block; rows of a staged tile
constexpr int kChunk = 16;       // keys per online-softmax update

struct Strides {
  long long b, s, h;  // in elements; the head dim is dense
};

struct Shape {
  int b, h, hk, group, s_q, s_kv;
  int causal, window;  // window 0: no band
  float scale;
};

struct Args {
  const void *q, *k, *v;
  const float *dout, *lse_in, *dcap;
  float *o, *lse;
  void *dq, *dk, *dv;
  Strides sq, sk, sv, sdo;
  Shape sh;
};

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// `_live_fwd` for any q rows: does k tile kt hold a key that one of q rows
// [r0, r1] sees?
__device__ __forceinline__ bool rows_live(int r0, int r1, int kt,
                                          const Shape& sh) {
  if (!sh.causal) return true;
  const long long k_first = (long long)kt * kTile;
  return k_first <= r1 &&
         (sh.window <= 0 || k_first + kTile - 1 > (long long)r0 - sh.window);
}

// `_live_fwd` at this kernel's tile: does k tile kt meet q tile qt's band?
__device__ __forceinline__ bool tile_live(int qt, int kt, const Shape& sh) {
  return rows_live(qt * kTile, qt * kTile + kTile - 1, kt, sh);
}

// `_score_tile`'s mask: same-origin causal, query i sees keys (i - window, i]
__device__ __forceinline__ bool visible(int qpos, int kpos, const Shape& sh) {
  if (!sh.causal) return true;
  return qpos >= kpos && (sh.window <= 0 || qpos - kpos < sh.window);
}

// Rows [row0, row0 + kTile) of head hh of batch bi of a (b, s, heads, D)
// strided tensor, as fp32 times `mul`, into a shared tile; rows past n are 0.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float (*dst)[D + 1],
                                          const T* base, Strides st,
                                          int bi, int hh, int row0, int n,
                                          float mul) {
  for (int idx = threadIdx.x; idx < kTile * D; idx += kTile) {
    const int r = idx / D, c = idx % D;
    const int pos = row0 + r;
    float x = 0.f;
    if (pos < n) {
      x = to_f32(base[bi * st.b + pos * st.s + hh * st.h + c]) * mul;
    }
    dst[r][c] = x;
  }
}

// A shared tile into rows [row0, row0 + kTile) of head hh of batch bi of a
// dense (b, n, heads, D) tensor.
template <typename T, int D>
__device__ __forceinline__ void store_tile(T* base, float (*src)[D + 1],
                                           int bi, int hh, int heads,
                                           int row0, int n) {
  for (int idx = threadIdx.x; idx < kTile * D; idx += kTile) {
    const int r = idx / D, c = idx % D;
    const int pos = row0 + r;
    if (pos < n) {
      base[(((long long)bi * n + pos) * heads + hh) * D + c] =
          from_f32<T>(src[r][c]);
    }
  }
}

template <int D>
__device__ __forceinline__ float dot(const float* a, const float* b) {
  float s = 0.f;
#pragma unroll
  for (int d = 0; d < D; ++d) s += a[d] * b[d];
  return s;
}

// Forward, fp32 inputs: one block per (b*h row, q tile), looping over the k
// tiles.
template <typename T, int D>
__global__ void __launch_bounds__(kTile) flash_fwd_kernel(Args a) {
  __shared__ float ks[kTile][D + 1];
  __shared__ float vs[kTile][D + 1];
  const Shape& sh = a.sh;
  const int row = blockIdx.x;  // bi * h + hq
  const int qt = blockIdx.y;
  const int bi = row / sh.h, hq = row % sh.h, hkv = hq / sh.group;
  const int qpos = qt * kTile + threadIdx.x;
  const bool valid = qpos < sh.s_q;

  // the q tile (scaled in fp32) goes through shared memory, so its loads
  // are coalesced; each thread then keeps its own row
  load_tile<T, D>(ks, static_cast<const T*>(a.q), a.sq, bi, hq, qt * kTile,
                  sh.s_q, sh.scale);
  __syncthreads();
  float qr[D], acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = ks[threadIdx.x][d];
    acc[d] = 0.f;
  }
  float m = kMask, l = 0.f;

  const int n_kt = (sh.s_kv + kTile - 1) / kTile;
  for (int kt = 0; kt < n_kt; ++kt) {
    if (!tile_live(qt, kt, sh)) continue;  // the same for the whole block
    __syncthreads();  // every reader of the previous tile is done
    load_tile<T, D>(ks, static_cast<const T*>(a.k), a.sk, bi, hkv,
                    kt * kTile, sh.s_kv, 1.f);
    load_tile<T, D>(vs, static_cast<const T*>(a.v), a.sv, bi, hkv,
                    kt * kTile, sh.s_kv, 1.f);
    __syncthreads();
    if (!valid) continue;
    for (int c = 0; c < kTile; c += kChunk) {
      float p[kChunk];
      float cmax = kMask;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const int kpos = kt * kTile + c + j;
        float s = kMask;
        if (kpos < sh.s_kv && visible(qpos, kpos, sh)) {
          s = dot<D>(qr, ks[c + j]);
        }
        p[j] = s;
        cmax = fmaxf(cmax, s);
      }
      const float m_new = fmaxf(m, cmax);
      const float alpha = m > 0.5f * kMask ? expf(m - m_new) : 0.f;
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        p[j] = p[j] > 0.5f * kMask ? expf(p[j] - m_new) : 0.f;
        psum += p[j];
      }
      l = l * alpha + psum;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        float x = acc[d] * alpha;
#pragma unroll
        for (int j = 0; j < kChunk; ++j) x += p[j] * vs[c + j][d];
        acc[d] = x;
      }
      m = m_new;
    }
  }

  const float den = l > 0.f ? l : 1.f;
  __syncthreads();
#pragma unroll
  for (int d = 0; d < D; ++d) ks[threadIdx.x][d] = acc[d] / den;
  if (valid) a.lse[(long long)row * sh.s_q + qpos] = m + logf(den);
  __syncthreads();
  store_tile<float, D>(a.o, ks, bi, hq, sh.h, qt * kTile, sh.s_q);
}

// dQ: one block per (b*h row, q tile), looping over the k tiles.
// dS = P * (dO . V^T - D); dQ = scale * dS . K.
template <typename T, int D>
__global__ void __launch_bounds__(kTile) flash_dq_kernel(Args a) {
  __shared__ float ks[kTile][D + 1];
  __shared__ float vs[kTile][D + 1];
  const Shape& sh = a.sh;
  const int row = blockIdx.x;
  const int qt = blockIdx.y;
  const int bi = row / sh.h, hq = row % sh.h, hkv = hq / sh.group;
  const int qpos = qt * kTile + threadIdx.x;
  const bool valid = qpos < sh.s_q;

  load_tile<T, D>(ks, static_cast<const T*>(a.q), a.sq, bi, hq, qt * kTile,
                  sh.s_q, sh.scale);
  load_tile<float, D>(vs, a.dout, a.sdo, bi, hq, qt * kTile, sh.s_q, 1.f);
  __syncthreads();
  float qr[D], dor[D], acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = ks[threadIdx.x][d];
    dor[d] = vs[threadIdx.x][d];
    acc[d] = 0.f;
  }
  const long long rix = (long long)row * sh.s_q + qpos;
  const float lse = valid ? a.lse_in[rix] : 0.f;
  const float dcap = valid ? a.dcap[rix] : 0.f;

  const int n_kt = (sh.s_kv + kTile - 1) / kTile;
  for (int kt = 0; kt < n_kt; ++kt) {
    if (!tile_live(qt, kt, sh)) continue;
    __syncthreads();
    load_tile<T, D>(ks, static_cast<const T*>(a.k), a.sk, bi, hkv,
                    kt * kTile, sh.s_kv, 1.f);
    load_tile<T, D>(vs, static_cast<const T*>(a.v), a.sv, bi, hkv,
                    kt * kTile, sh.s_kv, 1.f);
    __syncthreads();
    if (!valid) continue;
    for (int j = 0; j < kTile; ++j) {
      const int kpos = kt * kTile + j;
      // a masked score gives P = exp(MASK - L) = 0 and dS = 0: skipped
      if (kpos >= sh.s_kv || !visible(qpos, kpos, sh)) continue;
      const float p = expf(dot<D>(qr, ks[j]) - lse);
      const float ds = p * (dot<D>(dor, vs[j]) - dcap);
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] += ds * ks[j][d];
    }
  }

  __syncthreads();
#pragma unroll
  for (int d = 0; d < D; ++d) ks[threadIdx.x][d] = sh.scale * acc[d];
  __syncthreads();
  store_tile<T, D>(static_cast<T*>(a.dq), ks, bi, hq, sh.h, qt * kTile,
                   sh.s_q);
}

// dK/dV: one block per (b*hk row, k tile), looping over the kv head's group
// of q heads x q tiles. dV = P^T . dO; dK = dS^T . Qs (Qs pre-scaled).
template <typename T, int D>
__global__ void __launch_bounds__(kTile) flash_dkv_kernel(Args a) {
  __shared__ float qs[kTile][D + 1];
  __shared__ float dos[kTile][D + 1];
  __shared__ float ls[kTile];
  __shared__ float dcs[kTile];
  const Shape& sh = a.sh;
  const int row = blockIdx.x;  // bi * hk + hkv
  const int kt = blockIdx.y;
  const int bi = row / sh.hk, hkv = row % sh.hk;
  const int kpos = kt * kTile + threadIdx.x;
  const bool valid = kpos < sh.s_kv;

  load_tile<T, D>(qs, static_cast<const T*>(a.k), a.sk, bi, hkv, kt * kTile,
                  sh.s_kv, 1.f);
  load_tile<T, D>(dos, static_cast<const T*>(a.v), a.sv, bi, hkv,
                  kt * kTile, sh.s_kv, 1.f);
  __syncthreads();
  float kr[D], vr[D], dk[D], dv[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    kr[d] = qs[threadIdx.x][d];
    vr[d] = dos[threadIdx.x][d];
    dk[d] = 0.f;
    dv[d] = 0.f;
  }

  const int n_qt = (sh.s_q + kTile - 1) / kTile;
  for (int t = 0; t < sh.group * n_qt; ++t) {
    const int hq = hkv * sh.group + t / n_qt;
    const int qt = t % n_qt;
    if (!tile_live(qt, kt, sh)) continue;
    __syncthreads();
    load_tile<T, D>(qs, static_cast<const T*>(a.q), a.sq, bi, hq,
                    qt * kTile, sh.s_q, sh.scale);
    load_tile<float, D>(dos, a.dout, a.sdo, bi, hq, qt * kTile, sh.s_q, 1.f);
    {
      const int pos = qt * kTile + threadIdx.x;
      const long long rix = ((long long)bi * sh.h + hq) * sh.s_q + pos;
      ls[threadIdx.x] = pos < sh.s_q ? a.lse_in[rix] : 0.f;
      dcs[threadIdx.x] = pos < sh.s_q ? a.dcap[rix] : 0.f;
    }
    __syncthreads();
    if (!valid) continue;
    for (int i = 0; i < kTile; ++i) {
      const int qpos = qt * kTile + i;
      if (qpos >= sh.s_q || !visible(qpos, kpos, sh)) continue;
      const float p = expf(dot<D>(qs[i], kr) - ls[i]);
#pragma unroll
      for (int d = 0; d < D; ++d) dv[d] += p * dos[i][d];
      const float ds = p * (dot<D>(dos[i], vr) - dcs[i]);
#pragma unroll
      for (int d = 0; d < D; ++d) dk[d] += ds * qs[i][d];
    }
  }

  __syncthreads();
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qs[threadIdx.x][d] = dk[d];
    dos[threadIdx.x][d] = dv[d];
  }
  __syncthreads();
  store_tile<T, D>(static_cast<T*>(a.dk), qs, bi, hkv, sh.hk, kt * kTile,
                   sh.s_kv);
  store_tile<T, D>(static_cast<T*>(a.dv), dos, bi, hkv, sh.hk, kt * kTile,
                   sh.s_kv);
}

// --- bf16 forward on the tensor cores ----------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;  // 16 q rows each: a block takes kTile q rows
constexpr int kMmaThreads = kWarps * 32;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; zero-filled when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ldmatrix: lane l gives the shared address of one 16-byte row (rows of
// matrix i from lanes 8i..8i+7); r[i] gets matrix i's fragment: row l/4,
// columns 2(l%4) and 2(l%4)+1 (.trans: the transposed element pair)
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_u32(p))
      : "memory");
}

// d += a (16 x 16, row) . b (16 x 8, col), bf16 in, fp32 accumulate.
// Fragments (g = lane / 4, t = lane % 4): a = {A[g][2t..], A[g+8][2t..],
// A[g][2t+8..], A[g+8][2t+8..]}; b = {B[2t..][g], B[2t+8..][g]};
// d = {D[g][2t], D[g][2t+1], D[g+8][2t], D[g+8][2t+1]}.
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (x0, x1) as bf16 pairs hi = bf16(x) and lo = bf16(x - hi), the low
// element in the low half, as an mma fragment register holds them
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const __nv_bfloat162 r =
      __floats2bfloat162_rn(x0 - __low2float(h), x1 - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&r);
}

// 2^x, flushing a subnormal result to 0 (an exponent that small weighs
// nothing beside the row's largest term, 2^0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// does every one of q rows [r0, r1] see every key of k tile kt, all
// inside s_kv?
__device__ __forceinline__ bool rows_full(int r0, int r1, int kt,
                                          const Shape& sh) {
  const long long k_first = (long long)kt * kTile;
  const long long k_last = k_first + kTile - 1;
  if (k_last >= sh.s_kv) return false;
  if (!sh.causal) return true;
  return k_last <= r0 && (sh.window <= 0 || r1 - k_first < sh.window);
}

// Rows [row0, row0 + kTile) of head hh of batch bi of a (b, s, heads, D)
// bf16 strided tensor into a shared tile of kRow-element rows; rows past
// n are zero. kAsync: 16-byte cp.async copies (rows 16-byte aligned),
// else plain loads.
template <int D, int kRow, bool kAsync>
__device__ __forceinline__ void load_bf16_tile(bf16* dst, const bf16* base,
                                               Strides st, int bi, int hh,
                                               int row0, int n) {
  constexpr int kPieces = D / 8;  // 16-byte pieces of a row
  for (int idx = threadIdx.x; idx < kTile * kPieces; idx += kMmaThreads) {
    const int r = idx / kPieces, c = (idx % kPieces) * 8;
    const int pos = row0 + r;
    const bool valid = pos < n;
    const bf16* src = base + bi * st.b + (long long)(valid ? pos : 0) * st.s +
                      hh * st.h + c;
    bf16* d = dst + r * kRow + c;
    if constexpr (kAsync) {
      cp_async16(d, src, valid);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) d[e] = valid ? src[e] : __float2bfloat16(0.f);
    }
  }
}

// Forward, bf16 inputs: one block of kWarps warps per (b*h row, q tile),
// looping over the live k tiles.
template <int D, bool kAsync>
__global__ void __launch_bounds__(kMmaThreads)
    flash_fwd_mma_kernel(Args a) {
  static_assert(D == 8 || D % 16 == 0, "head dim 8 or a multiple of 16");
  // a shared row is an odd number of 16-byte pieces: the eight rows of an
  // ldmatrix phase then start in distinct banks
  constexpr int kRow = (D / 8) % 2 ? D : D + 8;
  constexpr int kSteps = (D + 15) / 16;  // depth steps of S = Q.K^T
  constexpr int kNs = kTile / 8;         // n tiles of S (8 keys each)
  constexpr int kNo = D / 8;             // n tiles of O (8 dims each)
  __shared__ __align__(16) bf16 qs[kTile * kRow];
  __shared__ __align__(16) bf16 ks[2][kTile * kRow];
  __shared__ __align__(16) bf16 vs[2][kTile * kRow];

  const Shape& sh = a.sh;
  const int row = blockIdx.x;  // bi * h + hq
  const int q_first = (gridDim.y - 1 - blockIdx.y) * kTile;  // heaviest first
  const int bi = row / sh.h, hq = row % sh.h, hkv = hq / sh.group;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tq = lane % 4;
  const int w_first = q_first + warp * 16;  // this warp's rows: 16 from here
  const int qpos0 = w_first + lane / 4;     // this thread's: qpos0, qpos0 + 8
  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* k = static_cast<const bf16*>(a.k);
  const bf16* v = static_cast<const bf16*>(a.v);

  // the k tiles some row of the block sees are one run [kt_lo, kt_hi]
  const int q_last = q_first + kTile - 1;
  const int n_kt = (sh.s_kv + kTile - 1) / kTile;
  int kt_lo = 0;
  while (kt_lo < n_kt && !rows_live(q_first, q_last, kt_lo, sh)) ++kt_lo;
  int kt_hi = kt_lo - 1;
  while (kt_hi + 1 < n_kt && rows_live(q_first, q_last, kt_hi + 1, sh)) {
    ++kt_hi;
  }

  load_bf16_tile<D, kRow, kAsync>(qs, q, a.sq, bi, hq, q_first, sh.s_q);
  if (kt_lo <= kt_hi) {
    load_bf16_tile<D, kRow, kAsync>(ks[0], k, a.sk, bi, hkv, kt_lo * kTile,
                                    sh.s_kv);
    load_bf16_tile<D, kRow, kAsync>(vs[0], v, a.sv, bi, hkv, kt_lo * kTile,
                                    sh.s_kv);
  }
  cp_async_commit();

  float o[kNo][4];
#pragma unroll
  for (int nd = 0; nd < kNo; ++nd) {
#pragma unroll
    for (int c = 0; c < 4; ++c) o[nd][c] = 0.f;
  }
  float m[2] = {kMask, kMask};  // running max of the unscaled scores
  float l[2] = {0.f, 0.f};      // this thread's part of the running sum
  uint32_t qf[kSteps][4];
  const float scale2 = sh.scale * kLog2e;  // exp(scale s) = 2^(scale2 s)

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int stage = (kt - kt_lo) & 1;
    if (kt < kt_hi) {  // the next tile lands while this one is computed
      load_bf16_tile<D, kRow, kAsync>(ks[stage ^ 1], k, a.sk, bi, hkv,
                                      (kt + 1) * kTile, sh.s_kv);
      load_bf16_tile<D, kRow, kAsync>(vs[stage ^ 1], v, a.sv, bi, hkv,
                                      (kt + 1) * kTile, sh.s_kv);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (kt == kt_lo) {  // this warp's 16 q rows, once
      const bf16* qrow = qs + (warp * 16 + lane % 16) * kRow;
      if constexpr (D == 8) {
        uint32_t r[2];
        ldsm_x2(r, qrow);
        qf[0][0] = r[0];
        qf[0][1] = r[1];
        qf[0][2] = 0u;  // depth 8..15: zero padding
        qf[0][3] = 0u;
      } else {
#pragma unroll
        for (int s = 0; s < kSteps; ++s) {
          ldsm_x4(qf[s], qrow + 16 * s + (lane / 16) * 8);
        }
      }
    }
    if (rows_live(w_first, w_first + 15, kt, sh)) {  // warp-uniform
      // S = Q.K^T for this warp's 16 rows x 64 keys
      float sc[kNs][4];
#pragma unroll
      for (int j = 0; j < kNs; ++j) {
#pragma unroll
        for (int c = 0; c < 4; ++c) sc[j][c] = 0.f;
      }
      const bf16* kst = ks[stage];
      if constexpr (D == 8) {
#pragma unroll
        for (int j = 0; j < kNs; j += 4) {
          uint32_t b[4];  // n tiles j..j+3, depth 0..7
          ldsm_x4(b, kst + (8 * j + lane) * kRow);
#pragma unroll
          for (int e = 0; e < 4; ++e) mma_bf16(sc[j + e], qf[0], b[e], 0u);
        }
      } else {
#pragma unroll
        for (int s = 0; s < kSteps; ++s) {
#pragma unroll
          for (int j = 0; j < kNs; j += 2) {
            uint32_t b[4];  // n tiles j, j+1 at depth 16s..16s+15
            ldsm_x4(b, kst + (8 * j + lane % 8 + (lane / 16) * 8) * kRow +
                           16 * s + ((lane / 8) % 2) * 8);
            mma_bf16(sc[j], qf[s], b[0], b[1]);
            mma_bf16(sc[j + 1], qf[s], b[2], b[3]);
          }
        }
      }

      // mask, padding keys past s_kv included
      if (!rows_full(w_first, w_first + 15, kt, sh)) {
#pragma unroll
        for (int j = 0; j < kNs; ++j) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int kpos = kt * kTile + 8 * j + 2 * tq + (c & 1);
            const int qpos = qpos0 + (c >> 1) * 8;
            if (kpos >= sh.s_kv || !visible(qpos, kpos, sh)) {
              sc[j][c] = kMask;
            }
          }
        }
      }

      // online softmax; a row lives in the quad of lanes 4g..4g+3. The
      // scale goes into the exponent: p = 2^(scale2 s - scale2 m), one
      // fused multiply-add and one ex2 a score
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = kMask;
#pragma unroll
        for (int j = 0; j < kNs; ++j) {
          mx = fmaxf(mx, fmaxf(sc[j][2 * r], sc[j][2 * r + 1]));
        }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[r], mx);
        const float ms = m_new * scale2;
        const float alpha =
            m[r] > 0.5f * kMask ? ex2(__fmaf_rn(m[r], scale2, -ms)) : 0.f;
        m[r] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < kNs; ++j) {
#pragma unroll
          for (int c = 2 * r; c < 2 * r + 2; ++c) {
            const float p = sc[j][c] > 0.5f * kMask
                                ? ex2(__fmaf_rn(sc[j][c], scale2, -ms))
                                : 0.f;
            sc[j][c] = p;
            sum += p;
          }
        }
        l[r] = l[r] * alpha + sum;
#pragma unroll
        for (int nd = 0; nd < kNo; ++nd) {
          o[nd][2 * r] *= alpha;
          o[nd][2 * r + 1] *= alpha;
        }
      }

      // O += (P_hi + P_lo).V, 16 keys at a time
      const bf16* vst = vs[stage];
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
        uint32_t hi[4], lo[4];
        split_bf16(sc[2 * kk][0], sc[2 * kk][1], hi[0], lo[0]);
        split_bf16(sc[2 * kk][2], sc[2 * kk][3], hi[1], lo[1]);
        split_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1], hi[2], lo[2]);
        split_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3], hi[3], lo[3]);
        if constexpr (D == 8) {
          uint32_t b[2];
          ldsm_x2_trans(b, vst + (16 * kk + lane % 16) * kRow);
          mma_bf16(o[0], lo, b[0], b[1]);
          mma_bf16(o[0], hi, b[0], b[1]);
        } else {
#pragma unroll
          for (int nd = 0; nd < kNo; nd += 2) {
            uint32_t b[4];  // n tiles nd, nd+1 at keys 16kk..16kk+15
            ldsm_x4_trans(
                b, vst + (16 * kk + lane % 8 + ((lane / 8) % 2) * 8) * kRow +
                       8 * nd + (lane / 16) * 8);
            mma_bf16(o[nd], lo, b[0], b[1]);
            mma_bf16(o[nd], hi, b[0], b[1]);
            mma_bf16(o[nd + 1], lo, b[2], b[3]);
            mma_bf16(o[nd + 1], hi, b[2], b[3]);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with this stage
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = qpos0 + 8 * r;
    if (qpos >= sh.s_q) continue;
    const float den = l[r] > 0.f ? l[r] : 1.f;
    float* orow = a.o + (((long long)bi * sh.s_q + qpos) * sh.h + hq) * D;
#pragma unroll
    for (int nd = 0; nd < kNo; ++nd) {
      *reinterpret_cast<float2*>(orow + 8 * nd + 2 * tq) =
          make_float2(o[nd][2 * r] / den, o[nd][2 * r + 1] / den);
    }
    if (tq == 0) {  // lse = scale m + log l; an empty row: MASK + log 1
      a.lse[(long long)row * sh.s_q + qpos] =
          (m[r] > 0.5f * kMask ? m[r] * sh.scale : kMask) + logf(den);
    }
  }
}

// cp.async needs every q, k and v row 16-byte aligned
bool rows_aligned(const Args& a) {
  const Strides st[3] = {a.sq, a.sk, a.sv};
  const void* base[3] = {a.q, a.k, a.v};
  for (int i = 0; i < 3; ++i) {
    if (reinterpret_cast<uintptr_t>(base[i]) % 16) return false;
    if (st[i].b % 8 || st[i].s % 8 || st[i].h % 8) return false;
  }
  return true;
}

enum Pass { kFwd, kDq, kDkv };

template <typename T, int D>
int launch(Pass pass, const Args& a, cudaStream_t stream) {
  const Shape& sh = a.sh;
  const unsigned q_tiles = (sh.s_q + kTile - 1) / kTile;
  const unsigned k_tiles = (sh.s_kv + kTile - 1) / kTile;
  switch (pass) {
    case kFwd:
      if constexpr (std::is_same<T, bf16>::value) {
        const dim3 grid(sh.b * sh.h, q_tiles);
        if (rows_aligned(a)) {
          flash_fwd_mma_kernel<D, true><<<grid, kMmaThreads, 0, stream>>>(a);
        } else {
          flash_fwd_mma_kernel<D, false><<<grid, kMmaThreads, 0, stream>>>(a);
        }
      } else {
        flash_fwd_kernel<T, D>
            <<<dim3(sh.b * sh.h, q_tiles), kTile, 0, stream>>>(a);
      }
      break;
    case kDq:
      flash_dq_kernel<T, D>
          <<<dim3(sh.b * sh.h, q_tiles), kTile, 0, stream>>>(a);
      break;
    case kDkv:
      flash_dkv_kernel<T, D>
          <<<dim3(sh.b * sh.hk, k_tiles), kTile, 0, stream>>>(a);
      break;
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int by_head_dim(Pass pass, const Args& a, int d, cudaStream_t stream) {
  switch (d) {
    case 8: return launch<T, 8>(pass, a, stream);
    case 32: return launch<T, 32>(pass, a, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// strides: 12 values, (b, s, h) of q, k, v and dO in that order
Args make_args(const long long* strides, int b, int h, int hk, int s_q,
               int s_kv, int causal, int window, float scale) {
  Args a = {};
  a.sq = {strides[0], strides[1], strides[2]};
  a.sk = {strides[3], strides[4], strides[5]};
  a.sv = {strides[6], strides[7], strides[8]};
  a.sdo = {strides[9], strides[10], strides[11]};
  a.sh = {b, h, hk, hk > 0 ? h / hk : 0, s_q, s_kv, causal, window, scale};
  return a;
}

int run(Pass pass, const Args& a, int is_bf16, int d, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.sh.b <= 0 || a.sh.s_q <= 0 || a.sh.s_kv <= 0) return 0;
  if (a.sh.hk <= 0 || a.sh.h % a.sh.hk) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return is_bf16 ? by_head_dim<__nv_bfloat16>(pass, a, d, s)
              : by_head_dim<float>(pass, a, d, s);
}

}  // namespace

extern "C" {

// All three launch on `stream`, do not synchronize, and return
// cudaGetLastError(). q, k, v are (b, s, heads, d) in bf16 (is_bf16 = 1) or
// fp32 (is_bf16 = 0), strided as `strides` says with a dense head dim; dO is
// fp32, strided; lse and dcap are dense fp32 (b*h, s_q); O is dense fp32
// (b, s_q, h, d); dQ, dK, dV are dense, in the inputs' type.

int kst_flash_fwd(const void* q, const void* k, const void* v, void* o,
                  void* lse, const long long* strides, int is_bf16, int b,
                  int h, int hk, int s_q, int s_kv, int d, int causal,
                  int window, float scale, void* stream) {
  Args a = make_args(strides, b, h, hk, s_q, s_kv, causal, window, scale);
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = static_cast<float*>(o);
  a.lse = static_cast<float*>(lse);
  return run(kFwd, a, is_bf16, d, stream);
}

int kst_flash_dq(const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* dcap,
                 void* dq, const long long* strides, int is_bf16, int b, int h,
                 int hk, int s_q, int s_kv, int d, int causal, int window,
                 float scale, void* stream) {
  Args a = make_args(strides, b, h, hk, s_q, s_kv, causal, window, scale);
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = static_cast<const float*>(dout);
  a.lse_in = static_cast<const float*>(lse);
  a.dcap = static_cast<const float*>(dcap);
  a.dq = dq;
  return run(kDq, a, is_bf16, d, stream);
}

int kst_flash_dkv(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* dcap,
                  void* dk, void* dv, const long long* strides, int is_bf16,
                  int b, int h, int hk, int s_q, int s_kv, int d, int causal,
                  int window, float scale, void* stream) {
  Args a = make_args(strides, b, h, hk, s_q, s_kv, causal, window, scale);
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = static_cast<const float*>(dout);
  a.lse_in = static_cast<const float*>(lse);
  a.dcap = static_cast<const float*>(dcap);
  a.dk = dk;
  a.dv = dv;
  return run(kDkv, a, is_bf16, d, stream);
}

const char* kst_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
