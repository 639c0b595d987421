// Flash attention for Hopper (sm_90a): forward, dQ and dK/dV.
//
// Replaces the three Pallas TPU kernels of kubeshare_tpu/ops/flash_attention.py
// behind one custom_vjp:
// - flash_fwd_kernel  <- `_kernel`          (launched by `_flash_fwd`)
// - flash_dq_kernel   <- `_bwd_dq_kernel`   (launched by `_flash_bwd`)
// - flash_dkv_kernel  <- `_bwd_dkv_kernel`  (launched by `_flash_bwd`)
//
// What bounds them on the card: bytes. At the transformer's shape (q, k, v
// (8, 256, 8, 32) bf16, causal) the forward reads q, k and v once (3 x 1 MB)
// and writes O in fp32 (2 MB) and the lse (64 KB): about 5.3 MB, 1.6 us at
// 3.35 TB/s. Its arithmetic is 2 x 2 x 32 operations on each of the ~2.1 M
// visible (q, k) pairs, 0.27 us of bf16 tensor-core work. The backward
// passes are bound the same way.
//
// What this design does about it: it is the simple, exact first version.
// Every pair is computed in fp32 on the CUDA cores (67 TFLOP/s, not the
// tensor cores), so these kernels run far above that bound; wgmma, TMA and
// a bf16 tensor-core design are later work. What it keeps from the flash
// schedule is the memory argument: no (s x s) score matrix ever reaches
// device memory, every output has exactly one writer (no atomics), and
// fully masked tiles are skipped.
//
// How the TPU grid translates. Pallas walks the innermost grid dimension in
// order with the scratch carried across it; here one block loops over that
// dimension itself:
// - forward: one block per (b*h, q tile), looping over k tiles; the running
//   max, sum and accumulator of each query row live in its thread's
//   registers;
// - dQ: one block per (b*h, q tile), looping over k tiles;
// - dK/dV: one block per (b*hk, k tile), looping over the kv head's group of
//   q heads x q tiles, so the GQA group sum stays in registers and dK/dV are
//   kv-sized. k and v are never expanded: q row (bi, hq) reads kv head
//   hq / group (`_kv_row_map`).
// A block has kTile = 64 threads, one per query row (forward, dQ) or key row
// (dK/dV). k/v (or q/dO) tiles of 64 rows are staged in shared memory as
// fp32 and read by every thread of the block at once (broadcast).
//
// Tiles: the kernel's tile is its own (64 x 64, keys taken 16 at a time by
// the online softmax), not the caller's block_q/block_k, which are checked
// by the wrapper exactly as the JAX `_blocks` checks them. The result does
// not depend on the tile: a masked score contributes exactly 0 (the TPU
// kernel's `where` guards), so skipping a dead tile (`_live_fwd` with this
// kernel's tile) or masking inside a live one gives the same sums; only the
// order of fp32 additions differs.
//
// Semantics kept from the TPU kernels:
// - inputs are cast to fp32 in the kernel, and q is scaled in fp32 before the
//   score product (`_score_tile`);
// - the mask floor is MASK_VALUE = -1e30, not -inf; the running max starts
//   there, and alpha = m > MASK/2 ? exp(m - m_new) : 0,
//   p = s > MASK/2 ? exp(s - m_new) : 0;
// - a row with nothing visible gives O = 0 and lse = m + log(1);
// - dQ multiplies by scale once, at the end; dK takes it through the
//   pre-scaled Qs; D = rowsum(dO * O) - g_lse comes from the caller;
// - O and lse are fp32; dQ, dK and dV are written in q's, k's and v's type.
//
// Head dims 8 and 32: 32 at the transformer's full width, 8 in its small
// preset. Other head dims are refused (cudaErrorInvalidValue); a model that
// needs one adds its case to by_head_dim (at 64 the dK/dV pass would hold
// 4 x 64 fp32 values a thread and spill).
//
// Built without --use_fast_math and with --fmad=false (ops/build.py): expf
// and logf are the IEEE-accurate library versions, but they and the
// summation order differ from torch's, so the kernel is held to its plain
// version with a tolerance (ops/flash_attention.py says which).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

// `_live_fwd` at this kernel's tile: does k tile kt meet q tile qt's band?
__device__ __forceinline__ bool tile_live(int qt, int kt, const Shape& sh) {
  if (!sh.causal) return true;
  bool live = (long long)kt * kTile <= (long long)(qt + 1) * kTile - 1;
  if (sh.window > 0) {
    live = live && ((long long)(kt + 1) * kTile - 1 >
                    (long long)qt * kTile - sh.window);
  }
  return live;
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

// Forward: one block per (b*h row, q tile), looping over the k tiles.
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

enum Pass { kFwd, kDq, kDkv };

template <typename T, int D>
int launch(Pass pass, const Args& a, cudaStream_t stream) {
  const Shape& sh = a.sh;
  const unsigned q_tiles = (sh.s_q + kTile - 1) / kTile;
  const unsigned k_tiles = (sh.s_kv + kTile - 1) / kTile;
  switch (pass) {
    case kFwd:
      flash_fwd_kernel<T, D>
          <<<dim3(sh.b * sh.h, q_tiles), kTile, 0, stream>>>(a);
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

int run(Pass pass, const Args& a, int bf16, int d, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.sh.b <= 0 || a.sh.s_q <= 0 || a.sh.s_kv <= 0) return 0;
  if (a.sh.hk <= 0 || a.sh.h % a.sh.hk) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return bf16 ? by_head_dim<__nv_bfloat16>(pass, a, d, s)
              : by_head_dim<float>(pass, a, d, s);
}

}  // namespace

extern "C" {

// All three launch on `stream`, do not synchronize, and return
// cudaGetLastError(). q, k, v are (b, s, heads, d) in bf16 (bf16 = 1) or
// fp32 (bf16 = 0), strided as `strides` says with a dense head dim; dO is
// fp32, strided; lse and dcap are dense fp32 (b*h, s_q); O is dense fp32
// (b, s_q, h, d); dQ, dK, dV are dense, in the inputs' type.

int kst_flash_fwd(const void* q, const void* k, const void* v, void* o,
                  void* lse, const long long* strides, int bf16, int b,
                  int h, int hk, int s_q, int s_kv, int d, int causal,
                  int window, float scale, void* stream) {
  Args a = make_args(strides, b, h, hk, s_q, s_kv, causal, window, scale);
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = static_cast<float*>(o);
  a.lse = static_cast<float*>(lse);
  return run(kFwd, a, bf16, d, stream);
}

int kst_flash_dq(const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* dcap,
                 void* dq, const long long* strides, int bf16, int b, int h,
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
  return run(kDq, a, bf16, d, stream);
}

int kst_flash_dkv(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* dcap,
                  void* dk, void* dv, const long long* strides, int bf16,
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
  return run(kDkv, a, bf16, d, stream);
}

const char* kst_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
