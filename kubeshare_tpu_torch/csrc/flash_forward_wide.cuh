// The bf16 flash forward at the instances 64, 128 and 256 (head dims 33 to
// 256), designed for Hopper (sm_90a): wgmma for both products, TMA for the
// tiles, setmaxnreg for the registers, and the softmax of one tile run
// under the tensor cores' work on another. Included by
// flash_attention_wide.cu and flash_attention_256.cu after
// flash_backward_wide.cuh, whose barrier, copy, descriptor, wgmma and
// tensor-map helpers it uses as they are; launch() in flash_attention.cu
// sends the wide bf16 forward here.
//
// - flash_fwd_wgmma_kernel  <- `_kernel` (kubeshare_tpu/ops/
//                              flash_attention.py:80, launched by
//                              `_flash_fwd`)
//
// What bounds it. At the LM's (8, 256, 8, 128) causal, bytes: q, k and v
// in bf16 (4.2 MB each), O in fp32 (8.4 MB) and the lse, 21 MB, 6.3 us at
// 3.35 TB/s, against 1.1 us of its two products (2 x 2 x 128 operations on
// each of the 2.1 M visible pairs) at 989 TFLOP/s; at head dim 64 half of
// each. At (1, 8192, 8, 128), operations: 268 M visible pairs, 137 G
// operations, 0.139 ms, against 84 MB (0.025 ms).
//
// Why P stays split. O is held to its fp32 plain version at KERNEL_TOL
// (ops/flash_attention.py). P rounded to bf16 once, as FlashAttention-3
// does, costs up to 2^-9 of each term of O = P.V, and puts a few percent
// of O outside even the bf16 tolerance (1e-4, 2^-7) at (1, 256, 4, 64) and
// (1, 256, 4, 128) (tests/test_torch_attention.py, `test_unsplit_p_breaks_
// the_forward_tolerance`, emulates this arithmetic). So O += P.V takes P as
// two bf16 parts, hi = bf16(P) and lo = bf16(P - hi), as the mma.sync
// kernels do: three products a (q, k) pair where the function has two,
// 0.208 ms of tensor-core work at seq 8192 where the bound counts 0.139.
//
// The design (after FlashAttention-3's forward):
// - a block of 384 threads owns 128 q rows of one (b, h) row: a producer
//   warpgroup that loads the tiles (setmaxnreg 40 registers, 56 with
//   plain loads) and two consumer warpgroups of 64 q rows each (232, or
//   224), which share every k/v tile it loads. Blocks launch heaviest
//   first (the causal q rows that see the most keys), and a block walks
//   the run of 64-key tiles that its rows meet (live_run_rows); at the
//   LM's (8, 256, 8, D) that is 128 blocks on the 132 SMs;
// - the producer's thread 0 loads the two Q tiles once and keeps a ring of
//   kFwdStages k/v stages in flight by TMA (128-byte swizzle, a full and
//   an empty mbarrier a stage; three tensor maps encoded at launch). Rows
//   that are not 16-byte aligned take the same kernel with plain loads by
//   the producer's 128 threads into the same layout (kTma = false);
// - a consumer computes S = Q.K^T for its 64 rows x 64 keys as an SS wgmma
//   (m64n64k16, Q and K K-major in shared memory), runs the online softmax
//   on the accumulator in registers, splits P into bf16 hi and lo parts
//   in registers and adds O += P_lo.V, then P_hi.V, as RS wgmmas
//   (m64nDk16, V read as the MN-major B operand). O (D / 2 fp32 values a
//   thread) stays in registers for the whole loop;
// - the overlap: a consumer starts S for tile n and O += P.V for tile n - 1
//   as two batches and waits for the first only, so tile n's softmax runs
//   while the tensor cores add tile n - 1 to O (at a consumer's first tile
//   P is 0 and that P.V adds exactly 0: one code path for every tile). The
//   two consumers start their batches as each is ready, without turns;
// - a k/v stage is free once its P.V is done, a tile later, so the ring has
//   three stages: the producer loads tile n + 2 while tile n + 1's S and
//   tile n's P.V run;
// - a consumer skips a tile its 64 rows do not meet (it still waits for the
//   stage and frees it), and masks, by selects, only a tile that one of
//   its rows does not fully see (pairs_full; a template argument picks the
//   code, so that no branch sits in the softmax);
// - O and the lse go out in fp32 from the accumulator, one writer each,
//   as the mma.sync kernel writes them.
// O is not written while a batch runs: where it was (rescaled between
// the starts of the two batches), ptxas serialized every wgmma (C7518),
// and the kernel took 1.6x as long at seq 8192.
//
// Tried on the card (NVIDIA H100 80GB HBM3, 700 W; scripts/torch_flash_ab.py
// against copies of this kernel) and not kept: the two consumers taking
// turns to start their batches through two named barriers (no faster at
// any shape); two stages (10-47% slower); k and v on barriers of their
// own, so that S starts before V lands (2% faster at (8, 256, 8, 128), 8%
// slower at seq 8192), and with them four stages (6% slower again at seq
// 8192); waiting for both batches before the softmax (3% slower at seq
// 8192); a code path of its own for a consumer's first tile, without the
// P.V of P = 0 (2% faster at (8, 256, 8, 128), 4% slower at seq 8192).
//
// At 256 (Gemma's head dim) a consumer's 64 x 256 fp32 O would be 128
// registers a thread beside S and P's parts, so the block splits as the
// backward's does (flash_backward_wide.cuh, split_cols): one row group of
// 64 q rows, whose softmax both consumers run (the same bits), each adding
// P.V for one half of V's columns and writing that half of O; the first
// consumer writes the lse. The block's shared memory is then one 32 KB Q
// tile and three k/v stages of 64 KB, 225 KB of the 227 it can have.
//
// The semantics are the mma.sync kernel's, operation for operation: the
// scale folded into the exponent (p = 2^(s scale log2 e - m scale log2 e),
// one fused multiply-add and one ex2 a score), the running max from the
// mask floor kMask, alpha and p set to 0 below kMask / 2, l = 1 for an
// empty row, lse = scale m + log l (kMask + log 1 for an empty row). Only
// the order of the fp32 sums inside the tensor cores differs, and O = acc
// / l is taken as acc times a rounded 1 / l.

namespace {

constexpr int kFwdStages = 3;    // the ring of k/v stages
// setmaxnreg with plain loads: the producer's 128 threads copy the tiles
// themselves, and at 40 registers they spilled at head dim 128
constexpr int kPlainProducerRegs = 56, kPlainConsumerRegs = 224;
static_assert(kPlainProducerRegs * 128 + kPlainConsumerRegs * 256 ==
                  168 * 384,
              "setmaxnreg: the two roles share the block's registers");

// dynamic shared memory: the row groups' Q tiles, a k and a v tile a
// stage, the barriers (full and empty a stage, once), and 1 KB to align
// the tiles to the swizzle's 1,024 bytes
template <int D>
constexpr int fwd_smem() {
  return (row_groups<D>() + 2 * kFwdStages) * tile_bytes<D>() +
         8 * (2 * kFwdStages + 1) + 1024;
}

// wait until at most one of this warpgroup's committed batches is running
__device__ __forceinline__ void wg_wait_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// o *= alpha, row by row (a thread's two rows: c 0, 1 and c 2, 3)
template <int N>
__device__ __forceinline__ void rescale(float (&o)[N][4],
                                        const float (&alpha)[2]) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
#pragma unroll
    for (int c = 0; c < 4; ++c) o[j][c] *= alpha[c >> 1];
  }
}

// The online softmax of a 64 x 64 score tile in accumulator layout (a row
// lives in the quad of lanes 4g..4g+3): the new running max m, the factor
// alpha that rescales the rows' earlier sums, P in each score's own
// register, and this thread's part of the running sum l
__device__ __forceinline__ void online_softmax(float (&sc)[kNs][4],
                                               float (&m)[2], float (&l)[2],
                                               float (&alpha)[2],
                                               float scale2) {
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
    // alpha = m > kMask / 2 ? 2^(m scale2 - ms) : 0, by predicates: a
    // branch here, while a P.V batch runs, serializes every wgmma
    alpha[r] = m[r];
    p_in_place(alpha[r], scale2, ms);
    m[r] = m_new;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kNs; ++j) {
#pragma unroll
      for (int c = 2 * r; c < 2 * r + 2; ++c) {
        p_in_place(sc[j][c], scale2, ms);
        sum += sc[j][c];
      }
    }
    l[r] = l[r] * alpha[r] + sum;
  }
}

// O += P_lo.V, then P_hi.V, committed, not waited for: P's parts are A
// operands in registers, V (descriptor low word v) the MN-major B
template <int D>
__device__ __forceinline__ void pv_batch(float (&o)[D / 8][4],
                                         uint32_t (&p_hi)[4][4],
                                         uint32_t (&p_lo)[4][4], uint32_t v) {
  keep(o);
  keep(p_hi);
  keep(p_lo);
  wg_fence();
  rs_steps<D>(o, p_lo, v);
  rs_steps<D>(o, p_hi, v);
  wg_commit();
}

// after pv_batch's wait: its registers are the products' again
template <int D>
__device__ __forceinline__ void pv_done(float (&o)[D / 8][4],
                                        uint32_t (&p_hi)[4][4],
                                        uint32_t (&p_lo)[4][4]) {
  keep(o);
  keep(p_hi);
  keep(p_lo);
}

// mask_tile for a consumer's q rows, by selects: the floor for keys past
// s_kv or outside the band. Rows past s_q are zero-filled, give finite
// scores and are never stored. (mask_tile behind a branch for each warp
// made the kernel 6-10% slower at the LM's shapes)
__device__ __forceinline__ void mask_scores(float (&s)[kNs][4], int row0,
                                            int col0, const Shape& sh,
                                            int lane) {
  const bool band = sh.causal != 0, windowed = band & (sh.window > 0);
#pragma unroll
  for (int j = 0; j < kNs; ++j) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int qpos = row0 + lane / 4 + (c >> 1) * 8;
      const int kpos = col0 + 8 * j + 2 * (lane % 4) + (c & 1);
      const bool off = (kpos >= sh.s_kv) | (band & (kpos > qpos)) |
                       (windowed & (qpos - kpos >= sh.window));
      s[j][c] = off ? kMask : s[j][c];
    }
  }
}

// What a consumer carries from tile to tile: O, the running max and sum
// of its rows, the last softmax's rescale of O and that tile's P as bf16
// hi and lo A operands
template <int D>
struct FwdRows {
  float o[D / 8][4];
  float m[2];      // running max of the unscaled scores
  float l[2];      // this thread's part of the running sum
  float alpha[2];  // the rescale of O that the pending P goes with
  uint32_t p_hi[4][4], p_lo[4][4];
};

// A live tile: S = Q.K^T over the head dim D for it (q_w and k the
// descriptor low words of the consumer's Q and the tile's K) and O += P.V
// for the tile before (v the descriptor low word of its V's N columns
// that the consumer's O holds, O first rescaled) as two batches; this
// tile's softmax while the second runs, then P's parts. No branch from
// the first batch's fence to the last wait (kMasked picks the code
// before). At a consumer's first tile P and alpha are 0, and the P.V adds
// exactly 0
template <int D, int N, bool kMasked>
__device__ __forceinline__ void live_tile(FwdRows<N>& t, uint32_t q_w,
                                          uint32_t k, uint32_t v,
                                          int r_first, int k_first,
                                          const Shape& sh, int lane,
                                          float scale2) {
  float sc[kNs][4] = {};
  // O rescaled before the first batch: ptxas serializes every wgmma
  // (C7518) if O is written between a batch's start and its wait
  rescale(t.o, t.alpha);
  keep(t.o);
  keep(sc);
  wg_fence();
  ss_steps<D>(sc, q_w, k);
  wg_commit();
  pv_batch<N>(t.o, t.p_hi, t.p_lo, v);
  wg_wait_one();  // S; P.V runs on under the softmax
  keep(sc);
  if constexpr (kMasked) mask_scores(sc, r_first, k_first, sh, lane);
  online_softmax(sc, t.m, t.l, t.alpha, scale2);
  wg_wait_all();
  pv_done<N>(t.o, t.p_hi, t.p_lo);
  split_a(sc, t.p_hi, t.p_lo);
}

// after a consumer's last live tile: O += P.V for it
template <int N>
__device__ __forceinline__ void last_pv(FwdRows<N>& t, uint32_t v) {
  rescale(t.o, t.alpha);
  pv_batch<N>(t.o, t.p_hi, t.p_lo, v);
  wg_wait_all();
  pv_done<N>(t.o, t.p_hi, t.p_lo);
}

// Forward, bf16 inputs, the instances 64 to 256: a block per (b*h row, 64
// q rows a row group), the rows' Q loaded once, the live k/v tiles
// streamed. O = softmax(scale Q.K^T).V and lse, both fp32.
template <int D, bool kTma>
__global__ void __launch_bounds__(kBwdThreads, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ WideParams p) {
  constexpr int kT = tile_bytes<D>();
  constexpr int kG = row_groups<D>(), kN = out_cols<D>();
  const Args& a = p.a;
  const Shape& sh = a.sh;
  unsigned char* sp;
  const uint32_t base = aligned_smem(sp);
  // the row groups' Q, then stage s's k and v at base + (kG + 2s) tiles
  const uint32_t bars = base + (kG + 2 * kFwdStages) * kT;  // full, empty
  const uint32_t once = bars + 16 * kFwdStages;
  auto k_tile = [&](int s) { return base + (kG + 2 * s) * kT; };
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kFwdStages + s); };

  const int row = blockIdx.x;  // bi * h + hq
  // heaviest first
  const int q_first = (gridDim.y - 1 - blockIdx.y) * kG * kTile;
  const int bi = row / sh.h, hq = row % sh.h, hkv = hq / sh.group;
  const int n_kt = (sh.s_kv + kTile - 1) / kTile;
  int kt_lo, kt_hi;
  live_run_rows(q_first, kG * kTile, n_kt, true, sh, kt_lo, kt_hi);
  const int n_it = kt_hi - kt_lo + 1;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kFwdStages; ++s) {
      mbar_init(full(s), kTma ? 1 : 128);
      mbar_init(empty(s), 2 * 128);  // every consumer
    }
    mbar_init(once, kTma ? 1 : 128);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        kTma ? kProducerRegs : kPlainProducerRegs));
    if constexpr (kTma) {
      if (threadIdx.x != 0) return;
      // the second row group's Q only where it has rows
      const int q_tiles = kG > 1 && q_first + kTile < sh.s_q ? 2 : 1;
      mbar_expect(once, q_tiles * kT);
      for (int w = 0; w < q_tiles; ++w) {
        tma_tile<D>(base + w * kT, &p.tq, once, hq, q_first + w * kTile, bi);
      }
      for (int i = 0; i < n_it; ++i) {
        const int s = i % kFwdStages, k0 = (kt_lo + i) * kTile;
        mbar_wait(empty(s), ((i / kFwdStages) & 1) ^ 1);
        mbar_expect(full(s), 2 * kT);
        tma_tile<D>(k_tile(s), &p.tk, full(s), hkv, k0, bi);
        tma_tile<D>(k_tile(s) + kT, &p.tv, full(s), hkv, k0, bi);
      }
    } else {
      for (int w = 0; w < kG; ++w) {
        plain_tile<D>(sp + w * kT, static_cast<const bf16*>(a.q), a.sq, bi,
                      hq, q_first + w * kTile, sh.s_q, sh.d);
      }
      fence_async_shared();
      mbar_arrive(once);
      for (int i = 0; i < n_it; ++i) {
        const int s = i % kFwdStages, k0 = (kt_lo + i) * kTile;
        mbar_wait(empty(s), ((i / kFwdStages) & 1) ^ 1);
        unsigned char* st = sp + (k_tile(s) - base);
        plain_tile<D>(st, static_cast<const bf16*>(a.k), a.sk, bi, hkv, k0,
                      sh.s_kv, sh.d);
        plain_tile<D>(st + kT, static_cast<const bf16*>(a.v), a.sv, bi, hkv,
                      k0, sh.s_kv, sh.d);
        fence_async_shared();
        mbar_arrive(full(s));
      }
    }
    return;
  }

  // a consumer: 64 q rows (row group rg), which meet the run [c_lo, c_hi]
  // of the block's k tiles (none when they lie past s_q), and the kN
  // columns of O from c0
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
      kTma ? kConsumerRegs : kPlainConsumerRegs));
  const int cw = threadIdx.x / 128 - 1;
  const int rg = kG > 1 ? cw : 0, c0 = split_cols<D>() ? cw * kN : 0;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int w_first = q_first + rg * kTile;  // this consumer's rows
  const int r_first = w_first + warp * 16;   // this warp's: 16 from here
  const int qpos0 = r_first + lane / 4;      // this thread's: and + 8
  int c_lo = kt_hi + 1, c_hi = kt_hi;
  if (w_first < sh.s_q) {
    live_run_rows(w_first, kTile, n_kt, true, sh, c_lo, c_hi);
  }
  const uint32_t q_w = kdesc(base + rg * kT);
  const uint32_t v_off = kT + (c0 / 64) * kBox;  // V's columns from c0
  const float scale2 = sh.scale * kLog2e;  // exp(scale s) = 2^(scale2 s)
  FwdRows<kN> t;
#pragma unroll
  for (int j = 0; j < kN / 8; ++j) {
#pragma unroll
    for (int c = 0; c < 4; ++c) t.o[j][c] = 0.f;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    t.m[r] = kMask;
    t.l[r] = 0.f;
    t.alpha[r] = 0.f;
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int c = 0; c < 4; ++c) t.p_hi[kk][c] = t.p_lo[kk][c] = 0u;
  }
  mbar_wait(once, 0);

  for (int i = 0; i < n_it; ++i) {
    const int s = i % kFwdStages, kt = kt_lo + i;
    const int k_first = kt * kTile;
    mbar_wait(full(s), (i / kFwdStages) & 1);
    if (kt < c_lo || kt > c_hi) {  // a tile this consumer does not meet
      mbar_arrive(empty(s));
      continue;
    }
    // the tile before, whose P.V is still to add (a live one: the run has
    // no gaps); at the first, this tile's V against P = 0
    const bool first = kt == c_lo;
    const int prev = first ? s : (i + kFwdStages - 1) % kFwdStages;
    const uint32_t k = kdesc(k_tile(s)), v = mndesc(k_tile(prev) + v_off);
    if (!pairs_full(w_first, w_first + kTile - 1, k_first,
                    k_first + kTile - 1, sh)) {
      live_tile<D, kN, true>(t, q_w, k, v, r_first, k_first, sh, lane,
                             scale2);
    } else {
      live_tile<D, kN, false>(t, q_w, k, v, r_first, k_first, sh, lane,
                              scale2);
    }
    if (!first) mbar_arrive(empty(prev));  // the tile before's stage
    if (kt == c_hi) {
      last_pv<kN>(t, mndesc(k_tile(s) + v_off));
      mbar_arrive(empty(s));
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    t.l[r] += __shfl_xor_sync(0xffffffffu, t.l[r], 1);
    t.l[r] += __shfl_xor_sync(0xffffffffu, t.l[r], 2);
  }
  const int tq = lane % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = qpos0 + 8 * r;
    if (qpos >= sh.s_q) continue;
    const float den = t.l[r] > 0.f ? t.l[r] : 1.f;
    // O = acc / l as acc times 1 / l, rounded (an ulp from the quotient;
    // D / 2 IEEE divisions a thread took ~5% of the time at the LM's shapes)
    const float inv = __frcp_rn(den);
    float* orow =
        a.o + (((long long)bi * sh.s_q + qpos) * sh.h + hq) * sh.d + c0;
    store_row_f32<kN>(orow, tq, sh.d - c0, [&](int nd) {
      return make_float2(t.o[nd][2 * r] * inv, t.o[nd][2 * r + 1] * inv);
    });
    // lse = scale m + log l; an empty row: MASK + log 1 (split columns:
    // both consumers hold it, the first writes it)
    if (tq == 0 && c0 == 0) {
      a.lse[(long long)row * sh.s_q + qpos] =
          (t.m[r] > 0.5f * kMask ? t.m[r] * sh.scale : kMask) + logf(den);
    }
  }
}

// The wide bf16 forward, on TMA or plain loads (tma_route). A failed map
// encode, attribute raise or launch returns its error; nothing falls back.
template <int D>
int launch_wide_fwd(const Args& a, cudaStream_t stream) {
  const Shape& sh = a.sh;
  WideParams p;
  std::memset(&p, 0, sizeof(p));
  p.a = a;
  const bool tma = tma_route(a);
  if (tma) {
    EncodeTiled enc;
    int rc = encoder(&enc);
    const int d = sh.d;
    if (!rc) rc = encode_rows(enc, &p.tq, a.q, a.sq, sh.b, sh.s_q, sh.h, d);
    if (!rc) rc = encode_rows(enc, &p.tk, a.k, a.sk, sh.b, sh.s_kv, sh.hk, d);
    if (!rc) rc = encode_rows(enc, &p.tv, a.v, a.sv, sh.b, sh.s_kv, sh.hk, d);
    if (rc) return rc;
  }
  constexpr int kRows = row_groups<D>() * kTile;  // q rows of a block
  const dim3 grid(sh.b * sh.h, (sh.s_q + kRows - 1) / kRows);
  return tma ? launch_wide<flash_fwd_wgmma_kernel<D, true>>(
                   grid, fwd_smem<D>(), p, stream)
             : launch_wide<flash_fwd_wgmma_kernel<D, false>>(
                   grid, fwd_smem<D>(), p, stream);
}

}  // namespace
