// Flash attention for Hopper (sm_90a): forward, dQ and dK/dV.
//
// Replaces the three Pallas TPU kernels of kubeshare_tpu/ops/flash_attention.py
// behind one custom_vjp. Each pass has a tensor-core kernel for bf16 inputs
// (the transformer's main path) and a CUDA-core kernel for fp32 inputs; the
// bf16 ones are this file's mma.sync kernels at head dims up to 32, and
// Hopper's own wgmma kernels from 33 to 256 (flash_forward_wide.cuh,
// flash_backward_wide.cuh):
// - flash_fwd_mma_kernel, flash_fwd_wgmma_kernel, flash_fwd_kernel
//                     <- `_kernel`          (launched by `_flash_fwd`)
// - flash_dq_mma_kernel, flash_dq_wgmma_kernel, flash_dq_kernel
//                     <- `_bwd_dq_kernel`   (launched by `_flash_bwd`)
// - flash_dkv_mma_kernel, flash_dkv_wgmma_kernel, flash_dkv_kernel
//                     <- `_bwd_dkv_kernel`  (launched by `_flash_bwd`)
//
// What bounds them on the card: bytes. At the transformer's shape (q, k, v
// (8, 256, 8, 32) bf16, causal) the forward reads q, k and v once (3 x 1 MB)
// and writes O in fp32 (2 MB) and the lse (64 KB): about 5.3 MB, 1.6 us at
// 3.35 TB/s. Its arithmetic is 2 x 2 x 32 operations on each of the ~2.1 M
// visible (q, k) pairs, 0.27 us of bf16 tensor-core work. At long context
// (1, 8192, 8, 32) the operations bound it: 34 G of them, 35 us. The
// backward passes are bound the same way, with three (dQ) and four (dK/dV)
// products a pair instead of two. At head dim 128 the bytes and the
// operations grow fourfold: (8, 256, 8, 128) moves 21 MB in the forward,
// 6.3 us, and (1, 8192, 8, 128) is 137 G operations, 139 us.
//
// The mma.sync kernels (bf16 at head dims up to 32) share one design:
// - one block of 4 warps per (b*h row, 64-row tile); each warp owns 16 rows
//   of the tile (q rows for the forward and dQ, keys for dK/dV), held in
//   registers as mma fragments (ldmatrix) for the whole loop, and skips a
//   tile none of its rows meets. The tiles are launched heaviest first:
//   the causal q tiles that see the most keys, the key tiles that the most
//   q tiles see;
// - the tiles walked by the loop (k/v for the forward and dQ, q/dO for
//   dK/dV) move through a two-stage ring in shared memory, the next tile in
//   flight while the current one is computed: bf16 rows by 16-byte
//   cp.async copies, fp32 dO rows read into registers ahead and split into
//   shared memory after the compute. A shared row is padded to an odd
//   number of 16-byte pieces, so the eight rows an ldmatrix phase reads
//   fall in distinct banks. q, k or v rows that are not 16-byte aligned
//   take the same kernel with plain loads (kAsync = false), chosen at
//   launch;
// - every product is mma.sync m16n8k16 (bf16 in, fp32 accumulate). bf16
//   products are exact in fp32, and the scale is applied to the fp32
//   product (q is not rounded to bf16 after scaling: 1/sqrt(32) is not a
//   power of two). Head dim 8 zero-pads the depth to 16;
// - the exponent takes the scale: p = 2^(s scale log2(e) - m scale log2(e))
//   in the forward, P = 2^(s scale log2(e) - lse log2(e)) in the backward,
//   one fused multiply-add and one ex2.approx a score;
// - ragged edges and the causal/window band are masked on the fragments,
//   zero-filled padding rows included (their score is set to the mask
//   floor, not left at 0); only tiles not wholly visible pay for it.
//
// Which products are split, and why. The outputs are held to their fp32
// plain versions at one bf16 ulp (KERNEL_TOL in ops/flash_attention.py),
// and an operand rounded to bf16 once costs 2^-9 of each term. An fp32
// operand x therefore goes in as two bf16 parts, hi = bf16(x) and lo =
// bf16(x - hi), one mma.sync each; hi + lo keeps ~16 bits of x:
// - P, whenever it is an A operand: the forward's O = P.V and dV = P^T.dO
//   (the wgmma kernels at 64 and 128 keep this split; rounded once, P
//   puts 3-5% of O outside even the bf16 tolerance, see
//   flash_forward_wide.cuh);
// - dS, an A operand of dQ = dS.K and dK = dS^T.Q. These sums cancel
//   heavily (without an lse cotangent every row of dS sums to 0), so one
//   rounding of dS moves 6.5% of dQ's and 4.4% of dK's bf16 outputs by
//   more than one ulp at the main shape (tests/test_torch_attention.py
//   emulates this arithmetic);
// - dO, which the interface passes in fp32 (on the main path it is the
//   gradient of a bf16 cast, so its lo part is 0, but nothing relies on
//   that): split once when its tile is staged, for dP = dO.V^T and dV.
//   For dV both operands are split: P_hi dO_hi + P_hi dO_lo + P_lo dO_hi,
//   the lo.lo product (~2^-18) dropped.
// q, k and v are bf16 and exact, so S = Q.K^T, dP and dK's Q and dQ's K
// take one product each.
//
// dQ (flash_dq_mma_kernel): a block per (b*h, q tile); each warp holds Q
// and dO (hi, lo) of its 16 q rows and their lse and D in registers, and
// walks the live k/v tiles: S = Q.K^T, P, dP = dO.V^T, dS = P (dP - D),
// dQ += dS.K (K through ldmatrix.trans); scale once, at the end.
//
// dK/dV (flash_dkv_mma_kernel): a block per (b*hk, key tile); each warp
// holds K and V of its 16 keys and walks the kv head's group of q heads x
// the live q tiles, so the GQA group sum stays in registers. It computes
// the transposed tiles, keys on the rows: S^T = K.Q^T, P^T with the lse by
// column (from shared memory, beside D), dV += P^T.dO, dP^T = V.dO^T, dS^T
// = P^T (dP^T - D), dK += dS^T.Q (dO and Q through ldmatrix.trans). P^T and
// dS^T turn from accumulator layout into A fragments in registers. dK is
// scaled at the end: the plain version's dS^T.(scale Q) in another order.
//
// The fp32 kernels (flash_fwd_kernel, flash_dq_kernel, flash_dkv_kernel,
// off the main path) are the simple first versions: every pair is computed
// in fp32 on the CUDA cores (67 TFLOP/s, not the tensor cores), so they run
// far above the bound. What they keep from the flash schedule is the
// memory argument: no (s x s) score matrix ever reaches device memory,
// every output has exactly one writer (no atomics), and fully masked tiles
// are skipped.
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
// Each pass has one writer per output, as the TPU kernels: dQ is not folded
// into the dK/dV pass with atomics, whose order would change the sums from
// run to run. The fp32 kernels' block has kTile = 64 rows of threads, one
// thread a query row (forward, dQ) or key row (dK/dV) up to head dim 32,
// D / 16 from 64. k/v (or q/dO) tiles of 64 rows are staged in shared
// memory as fp32 and read by every thread of the block at once
// (broadcast).
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
//   p = s > MASK/2 ? exp(s - m_new) : 0; the backward's P is 0 there too;
// - a row with nothing visible gives O = 0 and lse = m + log(1);
// - dQ multiplies by scale once, at the end; dK takes it through the
//   pre-scaled Qs (fp32 kernel) or at the end (bf16 kernel); D =
//   rowsum(dO * O) - g_lse comes from the caller;
// - O and lse are fp32; dQ, dK and dV are written in q's, k's and v's type.
// The backward passes rebuild P from the forward's lse with their own fp32
// score formula, so forward and backward agree to fp32 rounding.
//
// Head dims: any d from 1 to 256, as the JAX kernel takes any. The kernels
// are built for the instance widths 8, 16, 32, 64, 128 and 256, and d runs
// on the narrowest instance D >= d (ops/flash_attention.py
// `instance_head_dim`), given the true d (Shape::d): every load reads the
// columns from d on as 0 (a cp.async piece that d cuts copies its part and
// zero-fills the rest; TMA's tensor maps have d as their innermost extent,
// so a box past it is zero-filled, and still counts its whole bytes on the
// barrier), zero columns add exactly 0 to every product, and every store
// writes the columns below d of a dense row of d. The scale is the one
// passed in, from the true d. 32 is the transformer's full width, 8 its
// small preset, 16, 64 (GPT-2), 128 (Llama, Mistral) and 256 (Gemma)
// init(dim=128), 512, 1024 and 2048 under its 8 heads; Phi-2's 80 and
// Phi-3-mini's 96 run on 128. This file builds the library of 8, 16 and
// 32; flash_attention_wide.cu builds it again with KST_FLASH_WIDE defined,
// a library of 64 and 128, and flash_attention_256.cu with KST_FLASH_256,
// a library of 256, so that three nvcc processes share the compile
// (ops/flash_attention.py loads the library of the instance). What the
// wide ones change:
// - shared memory is dynamic in every kernel; past the 48 KB a function
//   gets by default the launch raises the function's limit first
//   (launch_kernel, launch_wide), once per device;
// - the three bf16 passes from 64 are not this file's mma.sync kernels but
//   Hopper's own, on wgmma, TMA and setmaxnreg: the forward
//   flash_forward_wide.cuh's, dQ and dK/dV flash_backward_wide.cuh's
//   (launch() sends them there in those two libraries), so the mma.sync
//   passes take head dims up to 32 only: each warp holds its rows' A
//   operands (Q and dO, or K and V) as fragments for the whole loop, and
//   dK/dV reads its next fp32 dO tile ahead in registers;
// - the fp32 kernels give a row several threads from 64 (row_threads: one
//   per 16 dims, each holding its slice), the dot products summed over the
//   row's threads by shuffles; one thread a row would hold 2 x 128 fp32
//   values in dK/dV and spill. At 256 that is 1,024 threads a block, 64
//   registers a thread, and all three spill (dK/dV, holding 4 x 16 values
//   a thread, the most): these kernels are off the main path and kept
//   simple.
//
// Built without --use_fast_math and with --fmad=false (ops/build.py): expf
// and logf are the accurate library versions, the bf16 kernels' fused
// multiply-adds are written out (__fmaf_rn) and their ex2.approx is good to
// ~2^-22; all of them and the summation order differ from torch's, so the
// kernels are held to their plain versions with a tolerance
// (ops/flash_attention.py says which).
//
// Tried on the card for the mma.sync forward (then at every head dim) and
// not kept: 8-warp blocks of 128 q rows (slower at the main shape, no
// faster at seq 8192), and splitting a block's k tiles between two groups
// of 4 warps with a merge at the end (a little faster at the main shape,
// slower at seq 8192). flash_forward_wide.cuh says what was tried for the
// wgmma forward.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr float kMask = -1e30f;  // MASK_VALUE of ops/attention.py
constexpr int kTile = 64;        // rows of a tile; fp32 kernels' threads
constexpr int kChunk = 16;       // keys per online-softmax update

struct Strides {
  long long b, s, h;  // in elements; the head dim is dense
};

struct Shape {
  int b, h, hk, group, s_q, s_kv;
  int causal, window;  // window 0: no band
  float scale;
  int d;  // the true head dim: the instance's columns from d on read as 0
};

struct Args {
  const void *q, *k, *v;
  const float *dout, *lse_in, *dcap;
  float *o, *lse;
  void *dq, *dk, *dv;
  Strides sq, sk, sv, sdo;
  Shape sh;
  // the wide bf16 backward (flash_backward_wide.cuh): dO's bf16 parts,
  // dense, and which (b*h row, 64-row q tile) has a nonzero lo part
  const void *do_hi, *do_lo;
  const int* lo_live;
};

// `_live_fwd` for any rows: does one of q rows [q0, q1] see one of keys
// [k0, k1]?
__device__ __forceinline__ bool band_meets(int q0, int q1, int k0, int k1,
                                           const Shape& sh) {
  return !sh.causal ||
         (k0 <= q1 && (sh.window <= 0 || q0 - k1 < sh.window));
}

// `_live_fwd` at this kernel's tile: does k tile kt meet q tile qt's band?
__device__ __forceinline__ bool tile_live(int qt, int kt, const Shape& sh) {
  return band_meets(qt * kTile, qt * kTile + kTile - 1, kt * kTile,
                    kt * kTile + kTile - 1, sh);
}

// `_score_tile`'s mask: same-origin causal, query i sees keys (i - window, i]
__device__ __forceinline__ bool visible(int qpos, int kpos, const Shape& sh) {
  if (!sh.causal) return true;
  return qpos >= kpos && (sh.window <= 0 || qpos - kpos < sh.window);
}

// threads a query (or key) row of the fp32 kernels: one up to head dim 32,
// which holds the whole row's D (or 2 D) accumulators; from 64 one per 16
// dims, each holding its slice, the dot products summed over the row's
// threads by shuffles (one thread would hold 2 x 128 fp32 values and spill)
template <int D>
__host__ __device__ constexpr int row_threads() {
  return D >= 64 ? D / 16 : 1;
}

// dynamic shared memory: every kernel carves its tiles from here (past
// 48 KB only after the launch raises the function's limit)
extern __shared__ __align__(16) unsigned char smem_raw[];

// the lanes of this thread's row group, T consecutive lanes of a warp
template <int T>
__device__ __forceinline__ unsigned row_mask() {
  if constexpr (T == 1) {
    return 1u << (threadIdx.x % 32);
  } else {
    return ((1u << T) - 1) << ((threadIdx.x % 32) & ~(T - 1));
  }
}

// x summed over the row group's T lanes (butterfly: every lane gets the
// same sum, bit for bit)
template <int T>
__device__ __forceinline__ float row_sum(float x, unsigned mask) {
#pragma unroll
  for (int o = T / 2; o > 0; o /= 2) x += __shfl_xor_sync(mask, x, o);
  return x;
}

// Rows [row0, row0 + kTile) of head hh of batch bi of a (b, s, heads, dd)
// strided tensor, as fp32 times `mul`, into a shared tile of D columns by
// the block's NT threads; rows past n and columns from dd on are 0.
template <int D, int NT>
__device__ __forceinline__ void load_tile(float (*dst)[D + 1],
                                          const float* base, Strides st,
                                          int bi, int hh, int row0, int n,
                                          int dd, float mul) {
  for (int idx = threadIdx.x; idx < kTile * D; idx += NT) {
    const int r = idx / D, c = idx % D;
    const int pos = row0 + r;
    float x = 0.f;
    if (pos < n && c < dd) {
      x = base[bi * st.b + pos * st.s + hh * st.h + c] * mul;
    }
    dst[r][c] = x;
  }
}

// A shared tile's first dd columns into rows [row0, row0 + kTile) of head
// hh of batch bi of a dense (b, n, heads, dd) tensor.
template <int D, int NT>
__device__ __forceinline__ void store_tile(float* base, float (*src)[D + 1],
                                           int bi, int hh, int heads,
                                           int row0, int n, int dd) {
  for (int idx = threadIdx.x; idx < kTile * D; idx += NT) {
    const int r = idx / D, c = idx % D;
    const int pos = row0 + r;
    if (pos < n && c < dd) {
      base[(((long long)bi * n + pos) * heads + hh) * dd + c] = src[r][c];
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

// bytes of dynamic shared memory of the fp32 kernels: two (kTile x D)
// tiles, and for dK/dV the q rows' lse and D
template <int D>
constexpr int f32_smem(bool rows) {
  return (2 * kTile * (D + 1) + (rows ? 2 * kTile : 0)) * 4;
}

// Forward, fp32 inputs: one block per (b*h row, q tile), looping over the k
// tiles. Each query row has row_threads<D>() threads, each owning DP dims.
template <int D>
__global__ void __launch_bounds__(kTile * row_threads<D>())
    flash_fwd_kernel(Args a) {
  constexpr int T = row_threads<D>(), DP = D / T, NT = kTile * T;
  float (*ks)[D + 1] = reinterpret_cast<float (*)[D + 1]>(smem_raw);
  float (*vs)[D + 1] = ks + kTile;
  const Shape& sh = a.sh;
  const int row = blockIdx.x;  // bi * h + hq
  const int qt = blockIdx.y;
  const int bi = row / sh.h, hq = row % sh.h, hkv = hq / sh.group;
  const int r = threadIdx.x / T, d0 = (threadIdx.x % T) * DP;
  const unsigned mask = row_mask<T>();
  const int qpos = qt * kTile + r;
  const bool valid = qpos < sh.s_q;

  // the q tile (scaled in fp32) goes through shared memory, so its loads
  // are coalesced; each thread then keeps its own row (slice)
  load_tile<D, NT>(ks, static_cast<const float*>(a.q), a.sq, bi, hq,
                   qt * kTile, sh.s_q, sh.d, sh.scale);
  __syncthreads();
  float qr[DP], acc[DP];
#pragma unroll
  for (int d = 0; d < DP; ++d) {
    qr[d] = ks[r][d0 + d];
    acc[d] = 0.f;
  }
  float m = kMask, l = 0.f;

  const int n_kt = (sh.s_kv + kTile - 1) / kTile;
  for (int kt = 0; kt < n_kt; ++kt) {
    if (!tile_live(qt, kt, sh)) continue;  // the same for the whole block
    __syncthreads();  // every reader of the previous tile is done
    load_tile<D, NT>(ks, static_cast<const float*>(a.k), a.sk, bi, hkv,
                     kt * kTile, sh.s_kv, sh.d, 1.f);
    load_tile<D, NT>(vs, static_cast<const float*>(a.v), a.sv, bi, hkv,
                     kt * kTile, sh.s_kv, sh.d, 1.f);
    __syncthreads();
    if (!valid) continue;  // the same for the row's threads
    for (int c = 0; c < kTile; c += kChunk) {
      float p[kChunk];
      float cmax = kMask;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const int kpos = kt * kTile + c + j;
        float s = kMask;
        if (kpos < sh.s_kv && visible(qpos, kpos, sh)) {
          s = row_sum<T>(dot<DP>(qr, &ks[c + j][d0]), mask);
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
      for (int d = 0; d < DP; ++d) {
        float x = acc[d] * alpha;
#pragma unroll
        for (int j = 0; j < kChunk; ++j) x += p[j] * vs[c + j][d0 + d];
        acc[d] = x;
      }
      m = m_new;
    }
  }

  const float den = l > 0.f ? l : 1.f;
  __syncthreads();
#pragma unroll
  for (int d = 0; d < DP; ++d) ks[r][d0 + d] = acc[d] / den;
  if (valid && d0 == 0) a.lse[(long long)row * sh.s_q + qpos] = m + logf(den);
  __syncthreads();
  store_tile<D, NT>(a.o, ks, bi, hq, sh.h, qt * kTile, sh.s_q, sh.d);
}

// dQ, fp32 inputs: one block per (b*h row, q tile), looping over the k
// tiles. dS = P * (dO . V^T - D); dQ = scale * dS . K.
template <int D>
__global__ void __launch_bounds__(kTile * row_threads<D>())
    flash_dq_kernel(Args a) {
  constexpr int T = row_threads<D>(), DP = D / T, NT = kTile * T;
  float (*ks)[D + 1] = reinterpret_cast<float (*)[D + 1]>(smem_raw);
  float (*vs)[D + 1] = ks + kTile;
  const Shape& sh = a.sh;
  const int row = blockIdx.x;
  const int qt = blockIdx.y;
  const int bi = row / sh.h, hq = row % sh.h, hkv = hq / sh.group;
  const int r = threadIdx.x / T, d0 = (threadIdx.x % T) * DP;
  const unsigned mask = row_mask<T>();
  const int qpos = qt * kTile + r;
  const bool valid = qpos < sh.s_q;

  load_tile<D, NT>(ks, static_cast<const float*>(a.q), a.sq, bi, hq,
                   qt * kTile, sh.s_q, sh.d, sh.scale);
  load_tile<D, NT>(vs, a.dout, a.sdo, bi, hq, qt * kTile, sh.s_q, sh.d,
                   1.f);
  __syncthreads();
  float qr[DP], dor[DP], acc[DP];
#pragma unroll
  for (int d = 0; d < DP; ++d) {
    qr[d] = ks[r][d0 + d];
    dor[d] = vs[r][d0 + d];
    acc[d] = 0.f;
  }
  const long long rix = (long long)row * sh.s_q + qpos;
  const float lse = valid ? a.lse_in[rix] : 0.f;
  const float dcap = valid ? a.dcap[rix] : 0.f;

  const int n_kt = (sh.s_kv + kTile - 1) / kTile;
  for (int kt = 0; kt < n_kt; ++kt) {
    if (!tile_live(qt, kt, sh)) continue;
    __syncthreads();
    load_tile<D, NT>(ks, static_cast<const float*>(a.k), a.sk, bi, hkv,
                     kt * kTile, sh.s_kv, sh.d, 1.f);
    load_tile<D, NT>(vs, static_cast<const float*>(a.v), a.sv, bi, hkv,
                     kt * kTile, sh.s_kv, sh.d, 1.f);
    __syncthreads();
    if (!valid) continue;
    for (int j = 0; j < kTile; ++j) {
      const int kpos = kt * kTile + j;
      // a masked score gives P = exp(MASK - L) = 0 and dS = 0: skipped
      if (kpos >= sh.s_kv || !visible(qpos, kpos, sh)) continue;
      const float p =
          expf(row_sum<T>(dot<DP>(qr, &ks[j][d0]), mask) - lse);
      const float ds =
          p * (row_sum<T>(dot<DP>(dor, &vs[j][d0]), mask) - dcap);
#pragma unroll
      for (int d = 0; d < DP; ++d) acc[d] += ds * ks[j][d0 + d];
    }
  }

  __syncthreads();
#pragma unroll
  for (int d = 0; d < DP; ++d) ks[r][d0 + d] = sh.scale * acc[d];
  __syncthreads();
  store_tile<D, NT>(static_cast<float*>(a.dq), ks, bi, hq, sh.h, qt * kTile,
                    sh.s_q, sh.d);
}

// dK/dV, fp32 inputs: one block per (b*hk row, k tile), looping over the
// kv head's group of q heads x q tiles. dV = P^T . dO; dK = dS^T . Qs (Qs
// pre-scaled).
template <int D>
__global__ void __launch_bounds__(kTile * row_threads<D>())
    flash_dkv_kernel(Args a) {
  constexpr int T = row_threads<D>(), DP = D / T, NT = kTile * T;
  float (*qs)[D + 1] = reinterpret_cast<float (*)[D + 1]>(smem_raw);
  float (*dos)[D + 1] = qs + kTile;
  float* ls = reinterpret_cast<float*>(dos + kTile);
  float* dcs = ls + kTile;
  const Shape& sh = a.sh;
  const int row = blockIdx.x;  // bi * hk + hkv
  const int kt = blockIdx.y;
  const int bi = row / sh.hk, hkv = row % sh.hk;
  const int r = threadIdx.x / T, d0 = (threadIdx.x % T) * DP;
  const unsigned mask = row_mask<T>();
  const int kpos = kt * kTile + r;
  const bool valid = kpos < sh.s_kv;

  load_tile<D, NT>(qs, static_cast<const float*>(a.k), a.sk, bi, hkv,
                   kt * kTile, sh.s_kv, sh.d, 1.f);
  load_tile<D, NT>(dos, static_cast<const float*>(a.v), a.sv, bi, hkv,
                   kt * kTile, sh.s_kv, sh.d, 1.f);
  __syncthreads();
  float kr[DP], vr[DP], dk[DP], dv[DP];
#pragma unroll
  for (int d = 0; d < DP; ++d) {
    kr[d] = qs[r][d0 + d];
    vr[d] = dos[r][d0 + d];
    dk[d] = 0.f;
    dv[d] = 0.f;
  }

  const int n_qt = (sh.s_q + kTile - 1) / kTile;
  for (int t = 0; t < sh.group * n_qt; ++t) {
    const int hq = hkv * sh.group + t / n_qt;
    const int qt = t % n_qt;
    if (!tile_live(qt, kt, sh)) continue;
    __syncthreads();
    load_tile<D, NT>(qs, static_cast<const float*>(a.q), a.sq, bi, hq,
                     qt * kTile, sh.s_q, sh.d, sh.scale);
    load_tile<D, NT>(dos, a.dout, a.sdo, bi, hq, qt * kTile, sh.s_q, sh.d,
                     1.f);
    if (threadIdx.x < kTile) {
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
      const float p =
          expf(row_sum<T>(dot<DP>(&qs[i][d0], kr), mask) - ls[i]);
#pragma unroll
      for (int d = 0; d < DP; ++d) dv[d] += p * dos[i][d0 + d];
      const float ds =
          p * (row_sum<T>(dot<DP>(&dos[i][d0], vr), mask) - dcs[i]);
#pragma unroll
      for (int d = 0; d < DP; ++d) dk[d] += ds * qs[i][d0 + d];
    }
  }

  __syncthreads();
#pragma unroll
  for (int d = 0; d < DP; ++d) {
    qs[r][d0 + d] = dk[d];
    dos[r][d0 + d] = dv[d];
  }
  __syncthreads();
  store_tile<D, NT>(static_cast<float*>(a.dk), qs, bi, hkv, sh.hk,
                    kt * kTile, sh.s_kv, sh.d);
  store_tile<D, NT>(static_cast<float*>(a.dv), dos, bi, hkv, sh.hk,
                    kt * kTile, sh.s_kv, sh.d);
}

// --- bf16 kernels on the tensor cores ----------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;  // 16 rows each: a block takes kTile rows
constexpr int kMmaThreads = kWarps * 32;
constexpr int kNs = kTile / 8;  // n tiles (8 columns each) of a 16 x 64 tile
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kMmaThreads == 2 * kTile, "load_rows: a thread a row, twice");

// elements of a shared row: an odd number of 16-byte pieces, so the eight
// rows of an ldmatrix phase start in distinct banks
template <int D>
__host__ __device__ constexpr int smem_row() {
  return (D / 8) % 2 ? D : D + 8;
}

// depth steps of a product over the head dim (head dim 8: one, zero-padded)
template <int D>
__host__ __device__ constexpr int depth_steps() {
  return (D + 15) / 16;
}

// fp32 elements of a (kTile x D) tile a thread loads
template <int D>
__host__ __device__ constexpr int tile_share() {
  return kTile * D / kMmaThreads;
}

// a two-stage ring of shared tiles of n elements from p: ring[i] is stage
// i's (plain pointer arithmetic, where an array of two pointers indexed
// by the loop's stage would go to local memory)
template <typename T>
struct Ring {
  T* p;
  int n;
  __device__ __forceinline__ T* operator[](int i) const { return p + i * n; }
};

// elements of one bf16 shared tile (kTile rows of smem_row<D>())
template <int D>
__host__ __device__ constexpr int tile_elems() {
  return kTile * smem_row<D>();
}

// bytes of dynamic shared memory of the bf16 kernels, by pass: the
// forward's q tile and k/v rings (5 tiles); dQ's q, dO hi/lo and k/v rings
// (7); dK/dV's k, v and q, dO hi/lo rings (8) and the q rows' lse and D
// (two stages)
template <int D>
constexpr int mma_smem(int pass) {
  const int tile = tile_elems<D>() * 2;
  if (pass == 0) return 5 * tile;
  if (pass == 1) return 7 * tile;
  return 8 * tile + 4 * kTile * 4;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous: the first `bytes` (0 to 16)
// copied, the rest zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
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

// does every q of [q0, q1] see every key of [k0, k1], all inside s_q and
// s_kv?
__device__ __forceinline__ bool pairs_full(int q0, int q1, int k0, int k1,
                                           const Shape& sh) {
  if (q1 >= sh.s_q || k1 >= sh.s_kv) return false;
  if (!sh.causal) return true;
  return k1 <= q0 && (sh.window <= 0 || q1 - k0 < sh.window);
}

// A 16 x 64 score tile in accumulator layout, its rows from row0 and its
// columns from col0 (q rows x keys, or keys x q columns when !rows_are_q):
// the floor for every pair that is not visible or lies past s_q or s_kv
__device__ __forceinline__ void mask_tile(float (&s)[kNs][4], int row0,
                                          int col0, bool rows_are_q,
                                          const Shape& sh, int lane) {
#pragma unroll
  for (int j = 0; j < kNs; ++j) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int r = row0 + lane / 4 + (c >> 1) * 8;
      const int col = col0 + 8 * j + 2 * (lane % 4) + (c & 1);
      const int qpos = rows_are_q ? r : col;
      const int kpos = rows_are_q ? col : r;
      if (qpos >= sh.s_q || kpos >= sh.s_kv || !visible(qpos, kpos, sh)) {
        s[j][c] = kMask;
      }
    }
  }
}

// The run [lo, hi] of the n_other tiles that meet the kTile rows from r0:
// k tiles for q rows (rows_are_q), else q tiles for keys; empty: hi < lo
__device__ __forceinline__ void live_run(int r0, int n_other, bool rows_are_q,
                                         const Shape& sh, int& lo, int& hi) {
  auto meets = [&](int t) {
    const int t0 = t * kTile, t1 = t0 + kTile - 1;
    return rows_are_q ? band_meets(r0, r0 + kTile - 1, t0, t1, sh)
                      : band_meets(t0, t1, r0, r0 + kTile - 1, sh);
  };
  lo = 0;
  while (lo < n_other && !meets(lo)) ++lo;
  hi = lo - 1;
  while (hi + 1 < n_other && meets(hi + 1)) ++hi;
}

// Rows [row0, row0 + kTile) of head hh of batch bi of a (b, s, heads, dd)
// bf16 strided tensor into a shared tile of D columns in kRow-element rows;
// rows past n and columns from dd on are zero. kAsync: 16-byte cp.async
// copies (rows 16-byte aligned, and dd is D: launch() takes this route only
// at the instance's own width, so no piece is cut), else plain loads.
template <int D, int kRow, bool kAsync>
__device__ __forceinline__ void load_bf16_tile(bf16* dst, const bf16* base,
                                               Strides st, int bi, int hh,
                                               int row0, int n, int dd) {
  constexpr int kPieces = D / 8;  // 16-byte pieces of a row
  for (int idx = threadIdx.x; idx < kTile * kPieces; idx += kMmaThreads) {
    const int r = idx / kPieces, c = (idx % kPieces) * 8;
    const int pos = row0 + r;
    bf16* d = dst + r * kRow + c;
    if constexpr (kAsync) {
      const bool valid = pos < n;
      const bf16* src = base + bi * st.b +
                        (long long)(valid ? pos : 0) * st.s + hh * st.h + c;
      cp_async16(d, src, valid ? 16 : 0);
    } else {
      // elements of this piece that lie in the tensor: 0 to 8
      const int live = pos < n ? min(max(dd - c, 0), 8) : 0;
      const bf16* src = base + bi * st.b +
                        (long long)(live ? pos : 0) * st.s + hh * st.h +
                        (live ? c : 0);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        d[e] = e < live ? src[e] : __float2bfloat16(0.f);
      }
    }
  }
}

// Rows [row0, row0 + kTile) of head hh of batch bi of a (b, s, heads, dd)
// fp32 strided tensor into registers: x[i] is element threadIdx.x + i *
// kMmaThreads of the (kTile x D) tile; rows past n and columns from dd on
// are zero
template <int D>
__device__ __forceinline__ void load_f32_tile(float (&x)[tile_share<D>()],
                                              const float* base, Strides st,
                                              int bi, int hh, int row0,
                                              int n, int dd) {
#pragma unroll
  for (int i = 0; i < tile_share<D>(); ++i) {
    const int idx = threadIdx.x + i * kMmaThreads;
    const int pos = row0 + idx / D;
    x[i] = pos < n && (dd >= D || idx % D < dd)
               ? base[bi * st.b + (long long)pos * st.s + hh * st.h + idx % D]
               : 0.f;
  }
}

// x, as load_f32_tile left it, into two shared tiles of kRow-element rows:
// hi = bf16(x) and lo = bf16(x - hi)
template <int D, int kRow>
__device__ __forceinline__ void store_split_tile(
    bf16* hi, bf16* lo, const float (&x)[tile_share<D>()]) {
#pragma unroll
  for (int i = 0; i < tile_share<D>(); ++i) {
    const int idx = threadIdx.x + i * kMmaThreads;
    const int at = (idx / D) * kRow + idx % D;
    const bf16 h = __float2bfloat16_rn(x[i]);
    hi[at] = h;
    lo[at] = __float2bfloat16_rn(x[i] - __bfloat162float(h));
  }
}

// The lse (times log2 e) and D of q rows [q0, q0 + kTile) of q head hq
// into shared memory, one thread a value; rows past s_q are 0
__device__ __forceinline__ void load_rows(float* ls, float* dcs,
                                          const Args& a, int bi, int hq,
                                          int q0) {
  const Shape& sh = a.sh;
  const int i = threadIdx.x % kTile;
  const int pos = q0 + i;
  const long long rix = ((long long)bi * sh.h + hq) * sh.s_q + pos;
  if (threadIdx.x < kTile) {
    ls[i] = pos < sh.s_q ? a.lse_in[rix] * kLog2e : 0.f;
  } else {
    dcs[i] = pos < sh.s_q ? a.dcap[rix] : 0.f;
  }
}

// A fragments of 16 rows x D of a shared tile of kRow-element rows, from
// `rows`, the first of them
template <int D, int kRow>
__device__ __forceinline__ void load_a(uint32_t (&f)[depth_steps<D>()][4],
                                       const bf16* rows, int lane) {
  const bf16* r = rows + (lane % 16) * kRow;
  if constexpr (D == 8) {
    uint32_t x[2];
    ldsm_x2(x, r);
    f[0][0] = x[0];
    f[0][1] = x[1];
    f[0][2] = 0u;  // depth 8..15: zero padding
    f[0][3] = 0u;
  } else {
#pragma unroll
    for (int s = 0; s < depth_steps<D>(); ++s) {
      ldsm_x4(f[s], r + 16 * s + (lane / 16) * 8);
    }
  }
}

// acc (16 x 64) += A (16 x D, fragments) . B^T, B the 64 rows x D of a
// shared tile of kRow-element rows: S = Q.K^T, dP = dO.V^T, S^T = K.Q^T,
// dP^T = V.dO^T
template <int D, int kRow>
__device__ __forceinline__ void mma_abt(
    float (&acc)[kNs][4], const uint32_t (&a)[depth_steps<D>()][4],
    const bf16* b, int lane) {
  if constexpr (D == 8) {
#pragma unroll
    for (int j = 0; j < kNs; j += 4) {
      uint32_t x[4];  // n tiles j..j+3, depth 0..7
      ldsm_x4(x, b + (8 * j + lane) * kRow);
#pragma unroll
      for (int e = 0; e < 4; ++e) mma_bf16(acc[j + e], a[0], x[e], 0u);
    }
  } else {
#pragma unroll
    for (int s = 0; s < depth_steps<D>(); ++s) {
#pragma unroll
      for (int j = 0; j < kNs; j += 2) {
        uint32_t x[4];  // n tiles j, j+1 at depth 16s..16s+15
        ldsm_x4(x, b + (8 * j + lane % 8 + (lane / 16) * 8) * kRow + 16 * s +
                       ((lane / 8) % 2) * 8);
        mma_bf16(acc[j], a[s], x[0], x[1]);
        mma_bf16(acc[j + 1], a[s], x[2], x[3]);
      }
    }
  }
}

// acc (16 x D) += X . B, X (16 x 64) fp32 in accumulator layout, taken as
// bf16 hi + lo, and B the 64 rows x D of a shared tile of kRow-element rows
// (ldmatrix.trans): O += P.V, dQ += dS.K, dV += P^T.dO, dK += dS^T.Q. With
// kLoB, B is itself split (b hi, b_lo lo) and X_hi.B_lo is added; X_lo.B_lo
// is dropped. Per accumulator: X_lo.B, X_hi.B_lo, X_hi.B, small first.
template <int D, int kRow, bool kLoB>
__device__ __forceinline__ void mma_xb(float (&acc)[D / 8][4],
                                       const float (&x)[kNs][4],
                                       const bf16* b, const bf16* b_lo,
                                       int lane) {
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk) {
    uint32_t hi[4], lo[4];
    split_bf16(x[2 * kk][0], x[2 * kk][1], hi[0], lo[0]);
    split_bf16(x[2 * kk][2], x[2 * kk][3], hi[1], lo[1]);
    split_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1], hi[2], lo[2]);
    split_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3], hi[3], lo[3]);
    if constexpr (D == 8) {
      const int at = (16 * kk + lane % 16) * kRow;
      uint32_t y[2];
      ldsm_x2_trans(y, b + at);
      mma_bf16(acc[0], lo, y[0], y[1]);
      if constexpr (kLoB) {
        uint32_t z[2];
        ldsm_x2_trans(z, b_lo + at);
        mma_bf16(acc[0], hi, z[0], z[1]);
      }
      mma_bf16(acc[0], hi, y[0], y[1]);
    } else {
#pragma unroll
      for (int nd = 0; nd < D / 8; nd += 2) {
        // n tiles nd, nd+1 at rows 16kk..16kk+15
        const int at = (16 * kk + lane % 8 + ((lane / 8) % 2) * 8) * kRow +
                       8 * nd + (lane / 16) * 8;
        uint32_t y[4];
        ldsm_x4_trans(y, b + at);
        mma_bf16(acc[nd], lo, y[0], y[1]);
        mma_bf16(acc[nd + 1], lo, y[2], y[3]);
        if constexpr (kLoB) {
          uint32_t z[4];
          ldsm_x4_trans(z, b_lo + at);
          mma_bf16(acc[nd], hi, z[0], z[1]);
          mma_bf16(acc[nd + 1], hi, z[2], z[3]);
        }
        mma_bf16(acc[nd], hi, y[0], y[1]);
        mma_bf16(acc[nd + 1], hi, y[2], y[3]);
      }
    }
  }
}

// One of this thread's two rows of a 16 x D accumulator (half 0: row
// lane / 4, half 1: 8 below), times mul, as bf16 into `out`, that row's
// first element: its columns below dd. Where the row holds all D columns
// and dd is even, as 4-byte pairs; else the columns below dd one by one.
// The test is made once a row (a pair at a time it cost the wgmma passes
// 1-3% at the LM's shapes).
template <int D>
__device__ __forceinline__ void store_row_bf16(bf16* out,
                                                const float (&acc)[D / 8][4],
                                                int half, float mul,
                                                int lane, int dd) {
  if (!(dd & 1) && dd >= D) {
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * nd + 2 * (lane % 4)) =
          __floats2bfloat162_rn(mul * acc[nd][2 * half],
                                mul * acc[nd][2 * half + 1]);
    }
  } else {
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      const int c = 8 * nd + 2 * (lane % 4);
      if (c < dd) out[c] = __float2bfloat16_rn(mul * acc[nd][2 * half]);
      if (c + 1 < dd) {
        out[c + 1] = __float2bfloat16_rn(mul * acc[nd][2 * half + 1]);
      }
    }
  }
}

// x(nd), a float2, into columns 8 nd + 2 tq and the next of a fp32 row
// (nd < N / 8): where the row holds all N columns and dd is even, as
// 8-byte pairs; else the columns below dd one by one (the test once a
// row, as store_row_bf16)
template <int N, typename F>
__device__ __forceinline__ void store_row_f32(float* row, int tq, int dd,
                                              F x) {
  if (!(dd & 1) && dd >= N) {
#pragma unroll
    for (int nd = 0; nd < N / 8; ++nd) {
      *reinterpret_cast<float2*>(row + 8 * nd + 2 * tq) = x(nd);
    }
  } else {
#pragma unroll
    for (int nd = 0; nd < N / 8; ++nd) {
      const int c = 8 * nd + 2 * tq;
      const float2 v = x(nd);
      if (c < dd) row[c] = v.x;
      if (c + 1 < dd) row[c + 1] = v.y;
    }
  }
}

// Forward, bf16 inputs: one block of kWarps warps per (b*h row, q tile),
// looping over the live k tiles.
template <int D, bool kAsync>
__global__ void __launch_bounds__(kMmaThreads)
    flash_fwd_mma_kernel(Args a) {
  static_assert(D == 8 || D == 16 || D == 32,
                "head dims 8 to 32 (from 64: flash_forward_wide.cuh)");
  constexpr int kRow = smem_row<D>();
  constexpr int kNo = D / 8;  // n tiles of O (8 dims each)
  constexpr int kT = tile_elems<D>();
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  const Ring<bf16> ks{qs + kT, kT}, vs{qs + 3 * kT, kT};

  const Shape& sh = a.sh;
  // the true head dim: D itself on the cp.async route (launch() takes it
  // only at the instance's own width), so its masks fold away
  const int dd = kAsync ? D : sh.d;
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
  int kt_lo, kt_hi;
  live_run(q_first, (sh.s_kv + kTile - 1) / kTile, true, sh, kt_lo, kt_hi);

  load_bf16_tile<D, kRow, kAsync>(qs, q, a.sq, bi, hq, q_first, sh.s_q,
                                  dd);
  if (kt_lo <= kt_hi) {
    load_bf16_tile<D, kRow, kAsync>(ks[0], k, a.sk, bi, hkv, kt_lo * kTile,
                                    sh.s_kv, dd);
    load_bf16_tile<D, kRow, kAsync>(vs[0], v, a.sv, bi, hkv, kt_lo * kTile,
                                    sh.s_kv, dd);
  }
  cp_async_commit();

  float o[kNo][4] = {};
  float m[2] = {kMask, kMask};  // running max of the unscaled scores
  float l[2] = {0.f, 0.f};      // this thread's part of the running sum
  uint32_t qf[depth_steps<D>()][4];
  const float scale2 = sh.scale * kLog2e;  // exp(scale s) = 2^(scale2 s)

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int stage = (kt - kt_lo) & 1;
    if (kt < kt_hi) {  // the next tile lands while this one is computed
      load_bf16_tile<D, kRow, kAsync>(ks[stage ^ 1], k, a.sk, bi, hkv,
                                      (kt + 1) * kTile, sh.s_kv, dd);
      load_bf16_tile<D, kRow, kAsync>(vs[stage ^ 1], v, a.sv, bi, hkv,
                                      (kt + 1) * kTile, sh.s_kv, dd);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (kt == kt_lo) load_a<D, kRow>(qf, qs + warp * 16 * kRow, lane);
    const int k_first = kt * kTile;
    if (band_meets(w_first, w_first + 15, k_first, k_first + kTile - 1,
                   sh)) {  // warp-uniform
      // S = Q.K^T for this warp's 16 rows x 64 keys
      float sc[kNs][4] = {};
      mma_abt<D, kRow>(sc, qf, ks[stage], lane);
      if (!pairs_full(w_first, w_first + 15, k_first, k_first + kTile - 1,
                      sh)) {
        mask_tile(sc, w_first, k_first, true, sh, lane);
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

      // O += (P_hi + P_lo).V
      mma_xb<D, kRow, false>(o, sc, vs[stage], nullptr, lane);
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
    float* orow = a.o + (((long long)bi * sh.s_q + qpos) * sh.h + hq) * dd;
    store_row_f32<D>(orow, tq, dd, [&](int nd) {
      return make_float2(o[nd][2 * r] / den, o[nd][2 * r + 1] / den);
    });
    if (tq == 0) {  // lse = scale m + log l; an empty row: MASK + log 1
      a.lse[(long long)row * sh.s_q + qpos] =
          (m[r] > 0.5f * kMask ? m[r] * sh.scale : kMask) + logf(den);
    }
  }
}

// dQ, bf16 inputs: one block of kWarps warps per (b*h row, q tile),
// looping over the live k/v tiles. dS = P (dO.V^T - D); dQ = scale dS.K.
template <int D, bool kAsync>
__global__ void __launch_bounds__(kMmaThreads)
    flash_dq_mma_kernel(Args a) {
  static_assert(D == 8 || D == 16 || D == 32,
                "head dims 8 to 32 (from 64: flash_backward_wide.cuh)");
  constexpr int kRow = smem_row<D>();
  constexpr int kSteps = depth_steps<D>();
  constexpr int kT = tile_elems<D>();
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  const Ring<bf16> dos{qs + kT, kT};  // dO: hi, lo
  const Ring<bf16> ks{qs + 3 * kT, kT}, vs{qs + 5 * kT, kT};

  const Shape& sh = a.sh;
  const int dd = kAsync ? D : sh.d;  // as in flash_fwd_mma_kernel
  const int row = blockIdx.x;  // bi * h + hq
  const int q_first = (gridDim.y - 1 - blockIdx.y) * kTile;  // heaviest first
  const int bi = row / sh.h, hq = row % sh.h, hkv = hq / sh.group;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int w_first = q_first + warp * 16;  // this warp's rows: 16 from here
  const int qpos0 = w_first + lane / 4;     // this thread's: qpos0, qpos0 + 8
  const bf16* k = static_cast<const bf16*>(a.k);
  const bf16* v = static_cast<const bf16*>(a.v);

  int kt_lo, kt_hi;
  live_run(q_first, (sh.s_kv + kTile - 1) / kTile, true, sh, kt_lo, kt_hi);

  load_bf16_tile<D, kRow, kAsync>(qs, static_cast<const bf16*>(a.q), a.sq,
                                  bi, hq, q_first, sh.s_q, dd);
  if (kt_lo <= kt_hi) {
    load_bf16_tile<D, kRow, kAsync>(ks[0], k, a.sk, bi, hkv, kt_lo * kTile,
                                    sh.s_kv, dd);
    load_bf16_tile<D, kRow, kAsync>(vs[0], v, a.sv, bi, hkv, kt_lo * kTile,
                                    sh.s_kv, dd);
  }
  cp_async_commit();
  {
    float x[tile_share<D>()];
    load_f32_tile<D>(x, a.dout, a.sdo, bi, hq, q_first, sh.s_q, dd);
    store_split_tile<D, kRow>(dos[0], dos[1], x);
  }
  // this thread's rows qpos0 and qpos0 + 8: lse (times log2 e) and D
  float lse2[2], dc[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = qpos0 + 8 * r;
    const long long rix = (long long)row * sh.s_q + qpos;
    lse2[r] = qpos < sh.s_q ? a.lse_in[rix] * kLog2e : 0.f;
    dc[r] = qpos < sh.s_q ? a.dcap[rix] : 0.f;
  }

  float acc[D / 8][4] = {};
  // Q; dO hi, lo: held for the whole loop
  uint32_t qf[kSteps][4], dof[2][kSteps][4];
  const bf16* q_rows = qs + warp * 16 * kRow;
  const bf16* do_rows[2] = {dos[0] + warp * 16 * kRow,
                            dos[1] + warp * 16 * kRow};
  const float scale2 = sh.scale * kLog2e;

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int stage = (kt - kt_lo) & 1;
    if (kt < kt_hi) {  // the next tile lands while this one is computed
      load_bf16_tile<D, kRow, kAsync>(ks[stage ^ 1], k, a.sk, bi, hkv,
                                      (kt + 1) * kTile, sh.s_kv, dd);
      load_bf16_tile<D, kRow, kAsync>(vs[stage ^ 1], v, a.sv, bi, hkv,
                                      (kt + 1) * kTile, sh.s_kv, dd);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (kt == kt_lo) {  // this warp's Q and dO, once
      load_a<D, kRow>(qf, q_rows, lane);
      load_a<D, kRow>(dof[0], do_rows[0], lane);
      load_a<D, kRow>(dof[1], do_rows[1], lane);
    }
    const int k_first = kt * kTile;
    if (band_meets(w_first, w_first + 15, k_first, k_first + kTile - 1,
                   sh)) {  // warp-uniform
      // S = Q.K^T, then P = 2^(S scale2 - lse2): 16 q rows x 64 keys
      float p[kNs][4] = {};
      mma_abt<D, kRow>(p, qf, ks[stage], lane);
      if (!pairs_full(w_first, w_first + 15, k_first, k_first + kTile - 1,
                      sh)) {
        mask_tile(p, w_first, k_first, true, sh, lane);
      }
      // dP = (dO_lo + dO_hi).V^T
      float ds[kNs][4] = {};
      mma_abt<D, kRow>(ds, dof[1], vs[stage], lane);
      mma_abt<D, kRow>(ds, dof[0], vs[stage], lane);
#pragma unroll
      for (int j = 0; j < kNs; ++j) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int r = c >> 1;
          const float pc = p[j][c] > 0.5f * kMask
                               ? ex2(__fmaf_rn(p[j][c], scale2, -lse2[r]))
                               : 0.f;
          ds[j][c] = pc * (ds[j][c] - dc[r]);
        }
      }
      // dQ += (dS_hi + dS_lo).K
      mma_xb<D, kRow, false>(acc, ds, ks[stage], nullptr, lane);
    }
    __syncthreads();  // every warp is done with this stage
  }

  bf16* dq = static_cast<bf16*>(a.dq);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = qpos0 + 8 * r;
    if (qpos >= sh.s_q) continue;
    store_row_bf16<D>(
        dq + (((long long)bi * sh.s_q + qpos) * sh.h + hq) * dd, acc, r,
        sh.scale, lane, dd);
  }
}

// dK/dV, bf16 inputs: one block of kWarps warps per (b*hk row, key tile),
// looping over the kv head's group of q heads x the live q tiles, keys on
// the rows. dV = P^T.dO; dS^T = P^T (V.dO^T - D); dK = scale dS^T.Q.
template <int D, bool kAsync>
__global__ void __launch_bounds__(kMmaThreads)
    flash_dkv_mma_kernel(Args a) {
  static_assert(D == 8 || D == 16 || D == 32,
                "head dims 8 to 32 (from 64: flash_backward_wide.cuh)");
  constexpr int kRow = smem_row<D>();
  constexpr int kSteps = depth_steps<D>();
  constexpr int kT = tile_elems<D>();
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + kT;
  const Ring<bf16> qs{ks + 2 * kT, kT};
  const Ring<bf16> doh{ks + 4 * kT, kT}, dol{ks + 6 * kT, kT};  // dO hi, lo
  float* rows = reinterpret_cast<float*>(ks + 8 * kT);
  const Ring<float> ls{rows, kTile};               // the q rows' lse log2 e
  const Ring<float> dcs{rows + 2 * kTile, kTile};  // and D

  const Shape& sh = a.sh;
  const int dd = kAsync ? D : sh.d;  // as in flash_fwd_mma_kernel
  const int row = blockIdx.x;  // bi * hk + hkv
  // causal: key tile 0 is seen by the most q tiles, and launches first
  const int k_first = blockIdx.y * kTile;
  const int bi = row / sh.hk, hkv = row % sh.hk;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tq = lane % 4;
  const int w_first = k_first + warp * 16;  // this warp's keys: 16 from here
  const int kpos0 = w_first + lane / 4;     // this thread's: kpos0, kpos0 + 8
  const bf16* q = static_cast<const bf16*>(a.q);

  // the q tiles that meet this key tile are one run [qt_lo, qt_hi], the
  // same for every q head; the loop walks (q head, q tile) head-major
  int qt_lo, qt_hi;
  live_run(k_first, (sh.s_q + kTile - 1) / kTile, false, sh, qt_lo, qt_hi);
  const int n_live = qt_hi - qt_lo + 1;
  const int n_it = n_live > 0 ? sh.group * n_live : 0;
  const int hq0 = hkv * sh.group;

  load_bf16_tile<D, kRow, kAsync>(ks, static_cast<const bf16*>(a.k), a.sk,
                                  bi, hkv, k_first, sh.s_kv, dd);
  load_bf16_tile<D, kRow, kAsync>(vs, static_cast<const bf16*>(a.v), a.sv,
                                  bi, hkv, k_first, sh.s_kv, dd);
  // the q tile's dO is read ahead in registers and split into shared
  // memory once the tile before it is computed
  float x[tile_share<D>()];
  if (n_it > 0) {
    load_bf16_tile<D, kRow, kAsync>(qs[0], q, a.sq, bi, hq0, qt_lo * kTile,
                                    sh.s_q, dd);
    load_rows(ls[0], dcs[0], a, bi, hq0, qt_lo * kTile);
    load_f32_tile<D>(x, a.dout, a.sdo, bi, hq0, qt_lo * kTile, sh.s_q, dd);
    store_split_tile<D, kRow>(doh[0], dol[0], x);
  }
  cp_async_commit();

  float dk[D / 8][4] = {}, dv[D / 8][4] = {};
  // K and V: held for the whole loop
  uint32_t kf[kSteps][4], vf[kSteps][4];
  const bf16* k_rows = ks + warp * 16 * kRow;
  const bf16* v_rows = vs + warp * 16 * kRow;
  const float scale2 = sh.scale * kLog2e;

  for (int it = 0; it < n_it; ++it) {
    const int stage = it & 1;
    const int q_first = (qt_lo + it % n_live) * kTile;
    const bool more = it + 1 < n_it;
    if (more) {  // the next tile lands while this one is computed
      const int hq = hq0 + (it + 1) / n_live;
      const int q_next = (qt_lo + (it + 1) % n_live) * kTile;
      load_bf16_tile<D, kRow, kAsync>(qs[stage ^ 1], q, a.sq, bi, hq,
                                      q_next, sh.s_q, dd);
      cp_async_commit();
      load_rows(ls[stage ^ 1], dcs[stage ^ 1], a, bi, hq, q_next);
      load_f32_tile<D>(x, a.dout, a.sdo, bi, hq, q_next, sh.s_q, dd);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (it == 0) {  // this warp's 16 keys of K and V, once
      load_a<D, kRow>(kf, k_rows, lane);
      load_a<D, kRow>(vf, v_rows, lane);
    }
    if (w_first < sh.s_kv &&
        band_meets(q_first, q_first + kTile - 1, w_first, w_first + 15,
                   sh)) {  // warp-uniform
      // S^T = K.Q^T, then P^T = 2^(S^T scale2 - lse2), the lse by column:
      // 16 keys x 64 q
      float p[kNs][4] = {};
      mma_abt<D, kRow>(p, kf, qs[stage], lane);
      if (!pairs_full(q_first, q_first + kTile - 1, w_first, w_first + 15,
                      sh)) {
        mask_tile(p, w_first, q_first, false, sh, lane);
      }
#pragma unroll
      for (int j = 0; j < kNs; ++j) {
        const float2 l2 =
            *reinterpret_cast<const float2*>(&ls[stage][8 * j + 2 * tq]);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float lc = c & 1 ? l2.y : l2.x;
          p[j][c] = p[j][c] > 0.5f * kMask
                        ? ex2(__fmaf_rn(p[j][c], scale2, -lc))
                        : 0.f;
        }
      }
      // dV += (P_hi + P_lo).(dO_hi + dO_lo), lo.lo dropped
      mma_xb<D, kRow, true>(dv, p, doh[stage], dol[stage], lane);
      // dP^T = V.(dO_lo + dO_hi)^T, then dS^T = P^T (dP^T - D), D by column
      float ds[kNs][4] = {};
      mma_abt<D, kRow>(ds, vf, dol[stage], lane);
      mma_abt<D, kRow>(ds, vf, doh[stage], lane);
#pragma unroll
      for (int j = 0; j < kNs; ++j) {
        const float2 d2 =
            *reinterpret_cast<const float2*>(&dcs[stage][8 * j + 2 * tq]);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          ds[j][c] = p[j][c] * (ds[j][c] - (c & 1 ? d2.y : d2.x));
        }
      }
      // dK += (dS_hi + dS_lo)^T.Q, scaled at the end
      mma_xb<D, kRow, false>(dk, ds, qs[stage], nullptr, lane);
    }
    if (more) store_split_tile<D, kRow>(doh[stage ^ 1], dol[stage ^ 1], x);
    __syncthreads();  // every warp is done with this stage
  }

  bf16* dk_out = static_cast<bf16*>(a.dk);
  bf16* dv_out = static_cast<bf16*>(a.dv);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kpos = kpos0 + 8 * r;
    if (kpos >= sh.s_kv) continue;
    const long long at =
        (((long long)bi * sh.s_kv + kpos) * sh.hk + hkv) * dd;
    store_row_bf16<D>(dk_out + at, dk, r, sh.scale, lane, dd);
    store_row_bf16<D>(dv_out + at, dv, r, 1.f, lane, dd);
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

// the libraries of the wgmma instances: 64 and 128, and 256
#if defined(KST_FLASH_WIDE) || defined(KST_FLASH_256)
#define KST_FLASH_WGMMA
#endif

#ifdef KST_FLASH_WGMMA
// the wide bf16 forward (flash_forward_wide.cuh) and backward passes
// (flash_backward_wide.cuh)
template <int D>
int launch_wide_fwd(const Args& a, cudaStream_t stream);
template <int D>
int launch_wide_bwd(Pass pass, const Args& a, cudaStream_t stream);
#endif

// Launch kernel K with `bytes` of dynamic shared memory. Past the 48 KB a
// function gets by default, its limit is raised first, once per device; a
// failed raise returns its error and nothing is launched.
template <void (*K)(Args)>
int launch_kernel(dim3 grid, int threads, int bytes, const Args& a,
                  cudaStream_t stream) {
  static std::atomic<unsigned long long> raised{0};  // a bit per device
  if (bytes > 48 * 1024) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    const unsigned long long bit = 1ull << (dev % 64);
    if (!(raised.load() & bit)) {
      err = cudaFuncSetAttribute(
          K, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
      if (err != cudaSuccess) return static_cast<int>(err);
      raised.fetch_or(bit);
    }
  }
  K<<<grid, threads, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// bf16 inputs launch the tensor-core kernels (the cp.async instantiation
// when every q, k and v row is 16-byte aligned and d is the instance's own
// width, else plain loads), fp32 the CUDA-core ones
template <int D>
int launch(Pass pass, const Args& args, bool bf16_in, cudaStream_t stream) {
  Args a = args;
  const Shape& sh = a.sh;
  const dim3 q_grid(sh.b * sh.h, (sh.s_q + kTile - 1) / kTile);
  const dim3 k_grid(sh.b * sh.hk, (sh.s_kv + kTile - 1) / kTile);
  // (the wide library's bf16 passes choose their own load route)
  [[maybe_unused]] const bool al =
      bf16_in && rows_aligned(a) && a.sh.d == D;
  const int f32_threads = kTile * row_threads<D>();
  switch (pass) {
    case kFwd:
      if (!bf16_in) {
        return launch_kernel<flash_fwd_kernel<D>>(q_grid, f32_threads,
                                                  f32_smem<D>(false), a,
                                                  stream);
      }
#ifdef KST_FLASH_WGMMA
      return launch_wide_fwd<D>(a, stream);
#else
      if (al) {
        return launch_kernel<flash_fwd_mma_kernel<D, true>>(
            q_grid, kMmaThreads, mma_smem<D>(0), a, stream);
      }
      return launch_kernel<flash_fwd_mma_kernel<D, false>>(
          q_grid, kMmaThreads, mma_smem<D>(0), a, stream);
#endif
    case kDq:
      if (!bf16_in) {
        return launch_kernel<flash_dq_kernel<D>>(q_grid, f32_threads,
                                                 f32_smem<D>(false), a,
                                                 stream);
      }
#ifdef KST_FLASH_WGMMA
      return launch_wide_bwd<D>(kDq, a, stream);
#else
      if (al) {
        return launch_kernel<flash_dq_mma_kernel<D, true>>(
            q_grid, kMmaThreads, mma_smem<D>(1), a, stream);
      }
      return launch_kernel<flash_dq_mma_kernel<D, false>>(
          q_grid, kMmaThreads, mma_smem<D>(1), a, stream);
#endif
    case kDkv:
      if (!bf16_in) {
        return launch_kernel<flash_dkv_kernel<D>>(k_grid, f32_threads,
                                                  f32_smem<D>(true), a,
                                                  stream);
      }
#ifdef KST_FLASH_WGMMA
      return launch_wide_bwd<D>(kDkv, a, stream);
#else
      if (al) {
        return launch_kernel<flash_dkv_mma_kernel<D, true>>(
            k_grid, kMmaThreads, mma_smem<D>(2), a, stream);
      }
      return launch_kernel<flash_dkv_mma_kernel<D, false>>(
          k_grid, kMmaThreads, mma_smem<D>(2), a, stream);
#endif
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// strides: 12 values, (b, s, h) of q, k, v and dO in that order
Args make_args(const long long* strides, int b, int h, int hk, int s_q,
               int s_kv, int d, int causal, int window, float scale) {
  Args a = {};
  a.sq = {strides[0], strides[1], strides[2]};
  a.sk = {strides[3], strides[4], strides[5]};
  a.sv = {strides[6], strides[7], strides[8]};
  a.sdo = {strides[9], strides[10], strides[11]};
  a.sh = {b, h, hk, hk > 0 ? h / hk : 0, s_q, s_kv, causal, window, scale,
          d};
  return a;
}

// launch<D> on the narrowest instance D of Ds (ascending) that holds the
// head dim d; past the widest, refused
template <int... Ds>
int run_dims(Pass pass, const Args& a, int is_bf16, int d,
             cudaStream_t s) {
  int rc = static_cast<int>(cudaErrorInvalidValue);
  ((d >= 1 && d <= Ds ? (rc = launch<Ds>(pass, a, is_bf16, s), true)
                      : false) ||
   ...);
  return rc;
}

int run(Pass pass, const Args& a, int is_bf16, int d, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.sh.b <= 0 || a.sh.s_q <= 0 || a.sh.s_kv <= 0) return 0;
  if (a.sh.hk <= 0 || a.sh.h % a.sh.hk) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#if defined(KST_FLASH_256)
  return run_dims<256>(pass, a, is_bf16, d, s);
#elif defined(KST_FLASH_WIDE)
  return run_dims<64, 128>(pass, a, is_bf16, d, s);
#else
  return run_dims<8, 16, 32>(pass, a, is_bf16, d, s);
#endif
}

}  // namespace

extern "C" {

// All three launch on `stream`, do not synchronize, and return
// cudaGetLastError(). q, k, v are (b, s, heads, d) in bf16 (is_bf16 = 1) or
// fp32 (is_bf16 = 0), strided as `strides` says with a dense head dim; dO is
// fp32, strided; lse and dcap are dense fp32 (b*h, s_q); O is dense fp32
// (b, s_q, h, d); dQ, dK, dV are dense, in the inputs' type. d runs on the
// library's narrowest instance that holds it (a d past its widest is
// refused: cudaErrorInvalidValue). The bf16 backward of the wgmma
// libraries reads dO as kst_flash_prep leaves it instead (do_hi, do_lo,
// lo_live; null elsewhere).

int kst_flash_fwd(const void* q, const void* k, const void* v, void* o,
                  void* lse, const long long* strides, int is_bf16, int b,
                  int h, int hk, int s_q, int s_kv, int d, int causal,
                  int window, float scale, void* stream) {
  Args a = make_args(strides, b, h, hk, s_q, s_kv, d, causal, window,
                     scale);
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
                 float scale, void* stream, const void* do_hi,
                 const void* do_lo, const void* lo_live) {
  Args a = make_args(strides, b, h, hk, s_q, s_kv, d, causal, window,
                     scale);
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = static_cast<const float*>(dout);
  a.lse_in = static_cast<const float*>(lse);
  a.dcap = static_cast<const float*>(dcap);
  a.dq = dq;
  a.do_hi = do_hi;
  a.do_lo = do_lo;
  a.lo_live = static_cast<const int*>(lo_live);
  return run(kDq, a, is_bf16, d, stream);
}

int kst_flash_dkv(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* dcap,
                  void* dk, void* dv, const long long* strides, int is_bf16,
                  int b, int h, int hk, int s_q, int s_kv, int d, int causal,
                  int window, float scale, void* stream, const void* do_hi,
                  const void* do_lo, const void* lo_live) {
  Args a = make_args(strides, b, h, hk, s_q, s_kv, d, causal, window,
                     scale);
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = static_cast<const float*>(dout);
  a.lse_in = static_cast<const float*>(lse);
  a.dcap = static_cast<const float*>(dcap);
  a.dk = dk;
  a.dv = dv;
  a.do_hi = do_hi;
  a.do_lo = do_lo;
  a.lo_live = static_cast<const int*>(lo_live);
  return run(kDkv, a, is_bf16, d, stream);
}

// an entry point's error code as text (from 20000: a failed
// cuTensorMapEncodeTiled, its CUresult added)
const char* kst_error_string(int err) {
  if (err >= 20000) {
    return "cuTensorMapEncodeTiled failed (CUresult: the code less 20000)";
  }
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
