// The bf16 flash backward at the instances 64, 128 and 256 (head dims 33
// to 256), designed for Hopper (sm_90a): wgmma for every product, TMA for
// the tiles, setmaxnreg for the registers. Included by
// flash_attention_wide.cu and flash_attention_256.cu after
// flash_attention.cu, whose helpers (Args, Shape, the band and mask
// functions, split_bf16, store_row_bf16) it shares; launch() there sends
// the wide bf16 dQ and dK/dV passes here.
//
// - flash_dq_wgmma_kernel   <- `_bwd_dq_kernel`  (kubeshare_tpu/ops/
//                              flash_attention.py, launched by _flash_bwd)
// - flash_dkv_wgmma_kernel  <- `_bwd_dkv_kernel`
// - flash_prep_kernel       replaces no TPU kernel: it is the backward's
//   prologue. The JAX code computes D = rowsum(dO o O) - g_lse with XLA
//   (kubeshare_tpu/ops/flash_attention.py `_flash_bwd`) and its kernels
//   read dO in fp32; here one pass over dO and O writes D, dO as two bf16
//   parts hi = bf16(dO) and lo = bf16(dO - hi) (the split that keeps the
//   products inside one bf16 ulp, see flash_attention.cu), and a flag for
//   each (b*h row, 64-row q tile) saying whether its lo part has a nonzero
//   value. Both passes then read bf16 tiles and split nothing in their
//   loops, and where dO is exact in bf16 (on every main path it is the
//   gradient of a bf16 cast) they skip the lo products: a product with a
//   zero operand adds exactly 0, so the sums are bit for bit those of not
//   skipping.
//
// What bounds them. At (1, 8192, 8, 128) causal, operations: dQ does 3
// products of 2 x 128 operations on each of the 268 M visible pairs (0.21
// ms at 989 TFLOP/s), dK/dV 4 (0.28 ms). At the LM's (8, 256, 8, 128),
// bytes: q, k, v, dO's hi part (its lo part only in flagged tiles), lse,
// D and the outputs, 6.3 and 7.6 us at 3.35 TB/s; the prologue moves dO
// and O in fp32 and dO's parts in bf16, 25 MB, 7.5 us.
//
// The design (after FlashAttention-3's backward):
// - a block of 384 threads: a producer warpgroup that loads the tiles and
//   two consumer warpgroups of 64 rows each (q rows for dQ, keys for
//   dK/dV), so a block owns 128 rows and both consumers share each loaded
//   tile. setmaxnreg gives the producer 40 registers and each consumer
//   232 (40 x 128 + 232 x 256 = 168 x 384, the block's whole file; at 24
//   the plain-load producers spill);
// - every product is wgmma.mma_async m64nNk16, bf16 in and fp32
//   accumulate. Q, K, V and dO are K-major operands read from shared
//   memory through descriptors (the scores S = Q.K^T and dP = dO.V^T, or
//   S^T = K.Q^T and dP^T = V.dO^T); P and dS (hi and lo) are A operands in
//   registers, converted from the accumulator layout (which is mma.sync's
//   A layout, warp by warp), against K, Q or dO read as MN-major B
//   operands (dQ += dS.K, dV += P^T.dO), but for dK += dS^T.Q, whose A
//   goes through shared memory (see registers);
// - tiles live in shared memory as TMA writes them with 128-byte swizzle:
//   a 64-row tile is D / 64 boxes of 64 rows x 128 bytes (8 KB each), the
//   16-byte pieces of row r XOR-ed with r % 8, which is the layout both
//   operand kinds of wgmma read without bank conflicts;
// - one producer thread keeps a two-stage ring of tiles in flight by TMA
//   (k and v for dQ; q, dO hi and, where its flag is set, dO lo for dK/dV),
//   each stage with a full and an empty mbarrier; the rows the consumers
//   keep for the whole loop (Q and dO, or K and V) arrive once, first. The
//   tensor maps are encoded at launch (cuTensorMapEncodeTiled, fetched
//   from libcuda by cudaGetDriverEntryPoint) and passed as
//   __grid_constant__ parameters. q, k or v rows that are not 16-byte
//   aligned take the same kernel with plain loads by the producer's 128
//   threads into the same swizzled layout (kTma = false), chosen at launch
//   as the forward chooses cp.async;
// - registers: at 128, dK/dV holds dK and dV for its 64 keys (64 + 64 a
//   thread) beside S^T and dP^T (32 + 32); P^T's parts stay in registers
//   as A operands, dS^T's go through a shared tile of the consumer's (held
//   too, ptxas spilled); P is made in each score's own register;
// - each pass keeps one writer per output (no atomics), the heaviest-first
//   order of the blocks and the live-tile runs of flash_attention.cu; a
//   consumer skips a tile its 64 rows do not meet, and masks only a tile
//   one of its warps does not fully see.
//
// The instance 256 (Gemma's head dim) keeps this design with two changes,
// because 64 rows x 256 columns pass both the registers and the shared
// memory that served 128:
// - registers: a consumer's 64 x 256 fp32 accumulator alone is 128
//   registers a thread (dK and dV together 256, past setmaxnreg's 232). So
//   at 256 the two consumers take the SAME 64 rows, and each the half of
//   the head dim its outputs' columns are (split_cols): both compute the
//   scores S and dP over the whole head dim (the same bits: the same
//   operands in the same order), and each adds dS.K, P^T.dO and dS^T.Q
//   against its 128 columns of K, dO and Q (the B operand's descriptor
//   starts two boxes on). A consumer's registers are then the 128
//   instance's: 64 + 64 for dK and dV beside S^T and dP^T. The scores are
//   computed twice, a third more products;
// - shared memory: a 64-row tile is 32 KB. A block owns 64 rows (one row
//   group, row_groups), so dQ holds Q and dO's two parts (96 KB) and a
//   ring of two k/v stages (128 KB), 225 KB of the 227 a block can have;
//   dK/dV holds K and V (64 KB) and ONE stage of q and dO's parts (96 KB;
//   two would pass 227 KB), so its producer loads the next tile only once
//   the consumers are done with this one (ring_stages).
// A padded head dim (80 and 96 on 128, 200 on 256) does the instance's
// tensor work on zero columns: 80 on 128 does 1.6x the products of an
// exact kernel.
//
// The sums: each product's 16 terms go through the tensor core's fp32
// accumulation as in the mma.sync kernels. dS's and P's parts go in small
// first, a part over all its depth steps before the next (dQ, dK: dS lo
// then hi; dV: P lo.dO hi then P hi.dO hi); dO's lo products, where a tile
// has them, come last, in a batch of their own (dP: hi then lo; dV: then P
// hi.dO lo), so that no branch sits inside a batch of wgmma.

#include <cuda.h>  // CUtensorMap; the encoder itself comes from libcuda

#include <cstring>

namespace {

constexpr int kBwdThreads = 384;  // a producer warpgroup, two consumers
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr int kBox = 64 * 128;    // bytes of a 64-row x 64-column box
constexpr int kRowBytes = 1024;   // a stage's lse, D and lo flag (dK/dV)
// dK/dV: each consumer's dS^T, hi and lo, two 64 x 64 bf16 tiles
constexpr int kDsBytes = 2 * 2 * kBox;

static_assert(kProducerRegs * 128 + kConsumerRegs * 256 == 168 * 384,
              "setmaxnreg: the two roles share the block's registers");

// bytes of a 64-row bf16 tile of head dim D
template <int D>
__host__ __device__ constexpr int tile_bytes() {
  return kTile * D * 2;
}

// How a block of the wgmma kernels (these and the forward) splits its work:
// up to 128 the two consumers own 64 rows each, two row groups a block; at
// 256 both own the same 64 rows and each one half of the output columns
// (the note at the top)
template <int D>
__host__ __device__ constexpr bool split_cols() {
  static_assert(D == 64 || D == 128 || D == 256, "the wgmma instances");
  return D > 128;
}
template <int D>
__host__ __device__ constexpr int row_groups() {
  return split_cols<D>() ? 1 : 2;
}
// a consumer's output columns (the N of its dQ, dK, dV or O products)
template <int D>
__host__ __device__ constexpr int out_cols() {
  return split_cols<D>() ? D / 2 : D;
}
// the ring of streamed tiles: two stages, one for dK/dV at 256
template <int D>
__host__ __device__ constexpr int ring_stages(Pass pass) {
  return split_cols<D>() && pass == kDkv ? 1 : 2;
}

// dynamic shared memory: the rows' tiles, the ring, (dK/dV) each stage's
// rows and the dS^T tiles, the barriers, and 1 KB to align the tiles to
// the swizzle's 1,024 bytes
template <int D>
constexpr int wide_smem(Pass pass) {
  const int g = row_groups<D>(), st = ring_stages<D>(pass);
  const int tiles = pass == kDq ? 3 * g + 2 * st : 2 * g + 3 * st;
  return tiles * tile_bytes<D>() +
         (pass == kDkv ? st * kRowBytes + kDsBytes : 0) + 8 * (2 * st + 1) +
         1024;
}

// what the wide backward kernels take: the tensor maps (kTma), the
// pass's Args (dO through do_hi, do_lo and lo_live)
struct WideParams {
  CUtensorMap tq, tk, tv, thi, tlo;
  Args a;
};

// --- barriers, copies, products ----------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// block until the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred done;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// arrive, and expect `bytes` more from TMA copies before the phase ends
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// this thread's shared-memory writes, visible to wgmma (the async proxy)
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// one 64 x 64 box of rows [row0, row0 + 64) of head hh of batch bi,
// columns [c0, c0 + 64), into shared `dst`; rows past the tensor's end
// are zero-filled
__device__ __forceinline__ void tma_box(uint32_t dst, const CUtensorMap* map,
                                        uint32_t bar, int c0, int hh,
                                        int row0, int bi) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(hh),
      "r"(row0), "r"(bi)
      : "memory");
}

// a 64-row tile: its D / 64 boxes
template <int D>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int hh, int row0,
                                         int bi) {
#pragma unroll
  for (int cb = 0; cb < D / 64; ++cb) {
    tma_box(dst + cb * kBox, map, bar, cb * 64, hh, row0, bi);
  }
}

// The same tile by plain loads of the producer's 128 threads, into the
// layout TMA writes: element (r, c) at box c / 64, row r, 16-byte piece
// (c % 64) / 8 XOR r % 8. Rows past n and columns from dd on are zero.
template <int D>
__device__ __forceinline__ void plain_tile(unsigned char* dst,
                                           const bf16* base, Strides st,
                                           int bi, int hh, int row0, int n,
                                           int dd) {
  constexpr int kCols = D < 128 ? D : 128;  // columns a pass of the rows
  constexpr int kStep = 128 / kCols;  // rows a pass: a thread keeps a column
#pragma unroll
  for (int c0 = 0; c0 < D; c0 += kCols) {
    const int c = c0 + threadIdx.x % kCols, cc = c % 64;
    const bf16* col = base + bi * st.b + hh * st.h + c;
    unsigned char* out = dst + (c / 64) * kBox + (cc % 8) * 2;
    // the rows this column reads: none past the head dim
    const int n_in = c < dd ? n : row0;
    // two loads in flight a thread: unrolled further, the producers' 40
    // registers spilled (at every instance, with or without the mask)
#pragma unroll 2
    for (int r = threadIdx.x / kCols; r < kTile; r += kStep) {
      const int pos = row0 + r;
      const bf16 x =
          pos < n_in ? col[(long long)pos * st.s] : __float2bfloat16(0.f);
      *reinterpret_cast<bf16*>(out + r * 128 + (((cc / 8) ^ (r % 8)) * 16)) =
          x;
    }
  }
}

// wgmma descriptors of 128-byte-swizzled bf16 operands. A descriptor's
// low word holds the start address >> 4 and the leading byte offset >> 4
// (bits 16..29), its high word the stride byte offset >> 4 (1,024 bytes:
// the next 8 rows) and the swizzle (bit 30). The kernels keep the low word
// of each tile's start; each product adds its depth step's offset and the
// high word inside its asm, so a descriptor costs no registers of its own
// (kept whole, ptxas held a dozen 64-bit descriptors and spilled dK/dV at
// 128).
constexpr uint32_t kDescHi = (1024 >> 4) | (1u << 30);

// the low word of a K-major tile (64 rows, the head dim contiguous; LBO
// unused) at shared address addr
__device__ __forceinline__ uint32_t kdesc(uint32_t addr) {
  return (addr >> 4) | (1u << 16);
}

// the low word of a 64-row tile as an MN-major B operand (its rows are the
// product's depth, the head dim its N): the next 64 columns one box on
// (LBO)
__device__ __forceinline__ uint32_t mndesc(uint32_t addr) {
  return (addr >> 4) | ((kBox >> 4) << 16);
}

// depth step kk's offset (16-byte units): K-major, box kk / 4 and 32 bytes
// a step inside it; MN-major, rows 16kk..16kk+15
__host__ __device__ constexpr uint32_t k_step(int kk) {
  return (kk / 4) * (kBox >> 4) + (kk % 4) * 2;
}
__host__ __device__ constexpr uint32_t mn_step(int kk) {
  return kk * (16 * 128 >> 4);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Pin registers that an asynchronous wgmma reads or writes, before its
// fence and after its wait (CUTLASS's warpgroup_fence_operand): their
// values are made before the fence, and the compiler may neither read them
// before the wait nor reuse them before it
template <int N>
__device__ __forceinline__ void keep(float (&x)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
#pragma unroll
    for (int c = 0; c < 4; ++c) asm volatile("" : "+f"(x[j][c])::"memory");
  }
}

__device__ __forceinline__ void keep(uint32_t (&x)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int c = 0; c < 4; ++c) asm volatile("" : "+r"(x[j][c])::"memory");
  }
}

#define KST_ACC(d, j) \
  "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])

// d (64 x 64) += A . B^T, A and B K-major in shared memory: a and b the
// tiles' descriptor low words, OffA and OffB the depth step's offsets
template <uint32_t OffA, uint32_t OffB>
__device__ __forceinline__ void wgmma_ss(float (&d)[kNs][4], uint32_t a,
                                         uint32_t b) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b32 al, bl, hi;\n.reg .b64 da, db;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "add.u32 al, %32, %35;\nadd.u32 bl, %33, %36;\nmov.b32 hi, %37;\n"
      "mov.b64 da, {al, hi};\nmov.b64 db, {bl, hi};\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, da, db, p, 1, 1, 0, 0;\n}\n"
      : KST_ACC(d, 0), KST_ACC(d, 1), KST_ACC(d, 2), KST_ACC(d, 3),
        KST_ACC(d, 4), KST_ACC(d, 5), KST_ACC(d, 6), KST_ACC(d, 7)
      : "r"(a), "r"(b), "r"(1), "n"(OffA), "n"(OffB), "n"(kDescHi));
}

// d (64 x N) += A . B, A (64 x 16) in registers (mma.sync's A layout, warp
// by warp), B an MN-major shared tile: b its descriptor low word, OffB the
// depth step's offset
template <int N, uint32_t OffB>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 8][4],
                                         const uint32_t (&a)[4], uint32_t b) {
  if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\n.reg .b32 bl, hi;\n.reg .b64 db;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "add.u32 bl, %36, %38;\nmov.b32 hi, %39;\nmov.b64 db, {bl, hi};\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31}, {%32, %33, %34, %35}, db, p, 1, 1, 1;\n}\n"
        : KST_ACC(d, 0), KST_ACC(d, 1), KST_ACC(d, 2), KST_ACC(d, 3),
          KST_ACC(d, 4), KST_ACC(d, 5), KST_ACC(d, 6), KST_ACC(d, 7)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b), "r"(1),
          "n"(OffB), "n"(kDescHi));
  } else {
    static_assert(N == 128, "wgmma_rs: N 64 or 128");
    asm volatile(
        "{\n.reg .pred p;\n.reg .b32 bl, hi;\n.reg .b64 db;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "add.u32 bl, %68, %70;\nmov.b32 hi, %71;\nmov.b64 db, {bl, hi};\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
        "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
        "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, db, p, 1, 1, 1;\n}\n"
        : KST_ACC(d, 0), KST_ACC(d, 1), KST_ACC(d, 2), KST_ACC(d, 3),
          KST_ACC(d, 4), KST_ACC(d, 5), KST_ACC(d, 6), KST_ACC(d, 7),
          KST_ACC(d, 8), KST_ACC(d, 9), KST_ACC(d, 10), KST_ACC(d, 11),
          KST_ACC(d, 12), KST_ACC(d, 13), KST_ACC(d, 14), KST_ACC(d, 15)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b), "r"(1),
          "n"(OffB), "n"(kDescHi));
  }
}

// d (64 x N) += A . B, A (64 x 16) a K-major shared tile and B an
// MN-major one (descriptor low words a, b; the depth step's offsets OffA,
// OffB)
template <int N, uint32_t OffA, uint32_t OffB>
__device__ __forceinline__ void wgmma_st(float (&d)[N / 8][4], uint32_t a,
                                         uint32_t b) {
  if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\n.reg .b32 al, bl, hi;\n.reg .b64 da, db;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "add.u32 al, %32, %35;\nadd.u32 bl, %33, %36;\nmov.b32 hi, %37;\n"
        "mov.b64 da, {al, hi};\nmov.b64 db, {bl, hi};\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31}, da, db, p, 1, 1, 0, 1;\n}\n"
        : KST_ACC(d, 0), KST_ACC(d, 1), KST_ACC(d, 2), KST_ACC(d, 3),
          KST_ACC(d, 4), KST_ACC(d, 5), KST_ACC(d, 6), KST_ACC(d, 7)
        : "r"(a), "r"(b), "r"(1), "n"(OffA), "n"(OffB), "n"(kDescHi));
  } else {
    static_assert(N == 128, "wgmma_st: N 64 or 128");
    asm volatile(
        "{\n.reg .pred p;\n.reg .b32 al, bl, hi;\n.reg .b64 da, db;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "add.u32 al, %64, %67;\nadd.u32 bl, %65, %68;\nmov.b32 hi, %69;\n"
        "mov.b64 da, {al, hi};\nmov.b64 db, {bl, hi};\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
        "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
        "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, da, db, p, 1, 1, "
        "0, 1;\n}\n"
        : KST_ACC(d, 0), KST_ACC(d, 1), KST_ACC(d, 2), KST_ACC(d, 3),
          KST_ACC(d, 4), KST_ACC(d, 5), KST_ACC(d, 6), KST_ACC(d, 7),
          KST_ACC(d, 8), KST_ACC(d, 9), KST_ACC(d, 10), KST_ACC(d, 11),
          KST_ACC(d, 12), KST_ACC(d, 13), KST_ACC(d, 14), KST_ACC(d, 15)
        : "r"(a), "r"(b), "r"(1), "n"(OffA), "n"(OffB), "n"(kDescHi));
  }
}

// d += A.B^T over the head dim's depth steps, A and B K-major tiles
// (descriptor low words a and b)
template <int D, int KK = 0>
__device__ __forceinline__ void ss_steps(float (&d)[kNs][4], uint32_t a,
                                         uint32_t b) {
  if constexpr (KK < D / 16) {
    wgmma_ss<k_step(KK), k_step(KK)>(d, a, b);
    ss_steps<D, KK + 1>(d, a, b);
  }
}

// d += A.B over the 64 rows of B, an MN-major tile, A a 64 x 64 K-major
// one (descriptor low words a, b)
template <int N, int KK = 0>
__device__ __forceinline__ void st_steps(float (&d)[N / 8][4], uint32_t a,
                                         uint32_t b) {
  if constexpr (KK < 4) {
    wgmma_st<N, k_step(KK), mn_step(KK)>(d, a, b);
    st_steps<N, KK + 1>(d, a, b);
  }
}

// d += X.B over the 64 rows of B, an MN-major tile (descriptor low word b),
// X's four depth steps as A operands
template <int N, int KK = 0>
__device__ __forceinline__ void rs_steps(float (&d)[N / 8][4],
                                         const uint32_t (&x)[4][4],
                                         uint32_t b) {
  if constexpr (KK < 4) {
    wgmma_rs<N, mn_step(KK)>(d, x[KK], b);
    rs_steps<N, KK + 1>(d, x, b);
  }
}

#undef KST_ACC

// s := P = 2^(s scale2 - l2) in s's own register; 0 where s is masked (s
// <= MASK / 2: the exponent -10000 flushes to 0 under ftz), as the
// kernels' `masked ? 0 : 2^x` gives. In C++ the select of 0 put P in a new
// register beside S's, and dK/dV at head dim 128 spilled
__device__ __forceinline__ void p_in_place(float& s, float scale2,
                                           float l2) {
  asm("{\n.reg .pred live;\n"
      "setp.gt.f32 live, %0, 0fF0C9F2CA;\n"  // 0.5f * kMask
      "@live fma.rn.f32 %0, %0, %1, %2;\n"
      "@!live mov.f32 %0, 0fC61C4000;\n"     // -10000
      "ex2.approx.ftz.f32 %0, %0;\n}\n"
      : "+f"(s)
      : "f"(scale2), "f"(-l2));
}

// x (64 x 64 fp32, accumulator layout) as bf16 A operands, one per depth
// step of 16 columns: hi = bf16(x), lo = bf16(x - hi)
__device__ __forceinline__ void split_a(const float (&x)[kNs][4],
                                        uint32_t (&hi)[4][4],
                                        uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    split_bf16(x[2 * kk][0], x[2 * kk][1], hi[kk][0], lo[kk][0]);
    split_bf16(x[2 * kk][2], x[2 * kk][3], hi[kk][1], lo[kk][1]);
    split_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1], hi[kk][2], lo[kk][2]);
    split_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3], hi[kk][3], lo[kk][3]);
  }
}

// The score products of a tile, committed and waited for: sc += A_s.B_s^T
// and dp += A_hi.B_hi^T, every operand a K-major shared tile (S = Q.K^T
// and dP = dO.V^T, or S^T = K.Q^T and dP^T = V.dO^T; descriptor low
// words); then, where dO has a lo part, dp += A_lo.B_lo^T as a batch of
// its own. No branch sits between a batch's fence and its commit (ptxas
// serializes wgmma there), and there is one copy of the code (two,
// specialised on the lo part, spilled at 128)
template <int D>
__device__ __forceinline__ void scores_batch(float (&sc)[kNs][4],
                                             float (&dp)[kNs][4],
                                             uint32_t a_s, uint32_t b_s,
                                             uint32_t a_hi, uint32_t b_hi,
                                             bool lo, uint32_t a_lo,
                                             uint32_t b_lo) {
  keep(sc);
  keep(dp);
  wg_fence();
  ss_steps<D>(sc, a_s, b_s);
  ss_steps<D>(dp, a_hi, b_hi);
  wg_commit();
  if (lo) {
    wg_fence();
    ss_steps<D>(dp, a_lo, b_lo);
    wg_commit();
  }
  wg_wait_all();
  keep(sc);
  keep(dp);
}

// dK/dV's update: dV += P_lo.dO_hi + P_hi.dO_hi, P's parts in registers,
// and dK += dS_lo.Q + dS_hi.Q, dS's parts shared K-major tiles (ds_lo,
// ds_hi), dO and Q as MN-major B (descriptor low words); then, where dO
// has a lo part, dV += P_hi.dO_lo as a batch of its own
template <int D>
__device__ __forceinline__ void dkv_batch(
    float (&dk)[D / 8][4], float (&dv)[D / 8][4], uint32_t (&p_hi)[4][4],
    uint32_t (&p_lo)[4][4], uint32_t ds_hi, uint32_t ds_lo, uint32_t dohi,
    uint32_t qs, bool lo, uint32_t dolo) {
  keep(dk);
  keep(dv);
  keep(p_hi);
  keep(p_lo);
  wg_fence();
  rs_steps<D>(dv, p_lo, dohi);
  rs_steps<D>(dv, p_hi, dohi);
  st_steps<D>(dk, ds_lo, qs);
  st_steps<D>(dk, ds_hi, qs);
  wg_commit();
  if (lo) {
    wg_fence();
    rs_steps<D>(dv, p_hi, dolo);
    wg_commit();
  }
  wg_wait_all();
  keep(dk);
  keep(dv);
  keep(p_hi);
  keep(p_lo);
}

// dS^T (accumulator layout) as bf16 hi and lo parts into a consumer's two
// shared tiles (64 keys x 64 q each, K-major with the 128-byte swizzle:
// element (r, c) at row r, 16-byte piece c / 8 XOR r % 8), the A operand
// of dK += dS^T.Q. A warp's 32 stores of a pair fall in 32 banks
__device__ __forceinline__ void store_ds(const float (&ds)[kNs][4],
                                         unsigned char* hi, int warp,
                                         int lane) {
#pragma unroll
  for (int j = 0; j < kNs; ++j) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = warp * 16 + lane / 4 + 8 * r;
      const int at = row * 128 + ((j ^ (row % 8)) * 16) + (lane % 4) * 4;
      uint32_t h, l;
      split_bf16(ds[j][2 * r], ds[j][2 * r + 1], h, l);
      *reinterpret_cast<uint32_t*>(hi + at) = h;
      *reinterpret_cast<uint32_t*>(hi + kBox + at) = l;
    }
  }
}

// live_run for `rows` rows from r0: the run [lo, hi] of the n_other
// 64-row tiles that meet them (k tiles for q rows, else q tiles for keys)
__device__ __forceinline__ void live_run_rows(int r0, int rows, int n_other,
                                              bool rows_are_q,
                                              const Shape& sh, int& lo,
                                              int& hi) {
  auto meets = [&](int t) {
    const int t0 = t * kTile, t1 = t0 + kTile - 1;
    return rows_are_q ? band_meets(r0, r0 + rows - 1, t0, t1, sh)
                      : band_meets(t0, t1, r0, r0 + rows - 1, sh);
  };
  lo = 0;
  while (lo < n_other && !meets(lo)) ++lo;
  hi = lo - 1;
  while (hi + 1 < n_other && meets(hi + 1)) ++hi;
}

// the shared window, aligned up to 1,024 bytes: (shared address, pointer)
__device__ __forceinline__ uint32_t aligned_smem(unsigned char*& p) {
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t at = (raw + 1023) & ~1023u;
  p = smem_raw + (at - raw);
  return at;
}

__device__ __forceinline__ void init_barriers(uint32_t bars, int full_count,
                                              int once_count, int stages) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(bars + 8 * s, full_count);
      mbar_init(bars + 8 * (stages + s), 2 * 128);  // every consumer
    }
    mbar_init(bars + 16 * stages, once_count);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// dO's parts, dense (b, s_q, h, d) bf16 at the true head dim: their
// strides
__host__ __device__ __forceinline__ Strides dense_strides(const Shape& sh) {
  return {static_cast<long long>(sh.s_q) * sh.h * sh.d,
          static_cast<long long>(sh.h) * sh.d, sh.d};
}

// dQ, bf16 inputs, the instances 64 to 256: a block per (b*h row, 64 q rows
// a row group), the rows' Q and dO parts loaded once, the live k/v tiles
// streamed. dS = P (dO.V^T - D); dQ = scale dS.K.
template <int D, bool kTma>
__global__ void __launch_bounds__(kBwdThreads, 1)
    flash_dq_wgmma_kernel(const __grid_constant__ WideParams p) {
  constexpr int kT = tile_bytes<D>();
  constexpr int kG = row_groups<D>(), kN = out_cols<D>();
  constexpr int kSt = ring_stages<D>(kDq);
  const Args& a = p.a;
  const Shape& sh = a.sh;
  unsigned char* sp;
  const uint32_t base = aligned_smem(sp);
  // Q, dO hi and dO lo of the row groups, then the k and v rings
  const uint32_t q_s = base, hi_s = base + kG * kT, lo_s = base + 2 * kG * kT;
  const uint32_t k_s = base + 3 * kG * kT, v_s = k_s + kSt * kT;
  const uint32_t bars = v_s + kSt * kT;  // full, empty, once
  const uint32_t once = bars + 16 * kSt;

  const int row = blockIdx.x;  // bi * h + hq
  // heaviest first
  const int q_first = (gridDim.y - 1 - blockIdx.y) * kG * kTile;
  const int bi = row / sh.h, hq = row % sh.h, hkv = hq / sh.group;
  int kt_lo, kt_hi;
  live_run_rows(q_first, kG * kTile, (sh.s_kv + kTile - 1) / kTile, true, sh,
                kt_lo, kt_hi);
  const int n_qt = (sh.s_q + kTile - 1) / kTile;
  auto lo_live = [&](int w) {  // does row group w's dO have a lo part?
    const int t = q_first / kTile + w;
    return t < n_qt && a.lo_live[row * n_qt + t] != 0;
  };
  init_barriers(bars, kTma ? 1 : 128, kTma ? 1 : 128, kSt);

  if (threadIdx.x < 128) {  // the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    const bool lo0 = lo_live(0), lo1 = kG > 1 && lo_live(1);
    if constexpr (kTma) {
      if (threadIdx.x != 0) return;
      mbar_expect(once, (2 * kG + lo0 + lo1) * kT);
      for (int w = 0; w < kG; ++w) {
        const int r0 = q_first + w * kTile;
        tma_tile<D>(q_s + w * kT, &p.tq, once, hq, r0, bi);
        tma_tile<D>(hi_s + w * kT, &p.thi, once, hq, r0, bi);
        if (w ? lo1 : lo0) tma_tile<D>(lo_s + w * kT, &p.tlo, once, hq, r0, bi);
      }
      for (int kt = kt_lo; kt <= kt_hi; ++kt) {
        const int i = kt - kt_lo, s = i % kSt;
        mbar_wait(bars + 8 * (kSt + s), ((i / kSt) & 1) ^ 1);
        mbar_expect(bars + 8 * s, 2 * kT);
        tma_tile<D>(k_s + s * kT, &p.tk, bars + 8 * s, hkv, kt * kTile, bi);
        tma_tile<D>(v_s + s * kT, &p.tv, bars + 8 * s, hkv, kt * kTile, bi);
      }
    } else {
      const Strides sd = dense_strides(sh);
      const bf16* hi = static_cast<const bf16*>(a.do_hi);
      const bf16* lo = static_cast<const bf16*>(a.do_lo);
      for (int w = 0; w < kG; ++w) {
        const int r0 = q_first + w * kTile;
        plain_tile<D>(sp + w * kT, static_cast<const bf16*>(a.q), a.sq, bi,
                      hq, r0, sh.s_q, sh.d);
        plain_tile<D>(sp + (kG + w) * kT, hi, sd, bi, hq, r0, sh.s_q, sh.d);
        if (w ? lo1 : lo0) {
          plain_tile<D>(sp + (2 * kG + w) * kT, lo, sd, bi, hq, r0, sh.s_q,
                        sh.d);
        }
      }
      fence_async_shared();
      mbar_arrive(once);
      for (int kt = kt_lo; kt <= kt_hi; ++kt) {
        const int i = kt - kt_lo, s = i % kSt;
        mbar_wait(bars + 8 * (kSt + s), ((i / kSt) & 1) ^ 1);
        plain_tile<D>(sp + (3 * kG + s) * kT, static_cast<const bf16*>(a.k),
                      a.sk, bi, hkv, kt * kTile, sh.s_kv, sh.d);
        plain_tile<D>(sp + (3 * kG + kSt + s) * kT,
                      static_cast<const bf16*>(a.v), a.sv, bi, hkv,
                      kt * kTile, sh.s_kv, sh.d);
        fence_async_shared();
        mbar_arrive(bars + 8 * s);
      }
    }
    return;
  }

  // a consumer: 64 q rows (row group rg), its kN output columns from c0
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int cw = threadIdx.x / 128 - 1;
  const int rg = kG > 1 ? cw : 0, c0 = split_cols<D>() ? cw * kN : 0;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int w_first = q_first + rg * kTile;  // this consumer's rows
  const int r_first = w_first + warp * 16;   // this warp's: 16 from here
  const int qpos0 = r_first + lane / 4;      // this thread's: and + 8
  const bool lo = lo_live(rg);
  const bool rows_in = w_first < sh.s_q;
  float lse2[2], dc[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = qpos0 + 8 * r;
    const long long rix = (long long)row * sh.s_q + qpos;
    lse2[r] = qpos < sh.s_q ? a.lse_in[rix] * kLog2e : 0.f;
    dc[r] = qpos < sh.s_q ? a.dcap[rix] : 0.f;
  }
  // descriptor low words of this consumer's Q and dO parts
  const uint32_t q_w = kdesc(q_s + rg * kT), hi_w = kdesc(hi_s + rg * kT);
  const uint32_t lo_w = kdesc(lo_s + rg * kT);
  const uint32_t col_off = (c0 / 64) * kBox;  // K's columns from c0
  const float scale2 = sh.scale * kLog2e;
  float acc[kN / 8][4] = {};
  mbar_wait(once, 0);

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int i = kt - kt_lo, s = i % kSt;
    mbar_wait(bars + 8 * s, (i / kSt) & 1);
    const int k_first = kt * kTile;
    const uint32_t ks = k_s + s * kT, vs = v_s + s * kT;  // addresses
    if (rows_in && band_meets(w_first, w_first + kTile - 1, k_first,
                              k_first + kTile - 1, sh)) {  // consumer-wide
      // S = Q.K^T and dP = (dO_hi + dO_lo).V^T: 64 q rows x 64 keys
      float sc[kNs][4] = {}, ds[kNs][4] = {};
      scores_batch<D>(sc, ds, q_w, kdesc(ks), hi_w, kdesc(vs), lo, lo_w,
                      kdesc(vs));
      if (!pairs_full(r_first, r_first + 15, k_first, k_first + kTile - 1,
                      sh)) {
        mask_tile(sc, r_first, k_first, true, sh, lane);
      }
      // P = 2^(S scale2 - lse2); dS = P (dP - D)
#pragma unroll
      for (int j = 0; j < kNs; ++j) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int r = c >> 1;
          p_in_place(sc[j][c], scale2, lse2[r]);
          ds[j][c] = sc[j][c] * (ds[j][c] - dc[r]);
        }
      }
      // dQ += (dS_lo + dS_hi).K, K read as the MN-major B
      uint32_t ds_hi[4][4], ds_lo[4][4];
      split_a(ds, ds_hi, ds_lo);
      keep(acc);
      keep(ds_hi);
      keep(ds_lo);
      wg_fence();
      rs_steps<kN>(acc, ds_lo, mndesc(ks + col_off));
      rs_steps<kN>(acc, ds_hi, mndesc(ks + col_off));
      wg_commit();
      wg_wait_all();
      keep(acc);
      keep(ds_hi);
      keep(ds_lo);
    }
    mbar_arrive(bars + 8 * (kSt + s));  // this stage is free
  }

  bf16* dq = static_cast<bf16*>(a.dq);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = qpos0 + 8 * r;
    if (qpos >= sh.s_q) continue;
    store_row_bf16<kN>(
        dq + (((long long)bi * sh.s_q + qpos) * sh.h + hq) * sh.d + c0, acc,
        r, sh.scale, lane, sh.d - c0);
  }
}

// dK/dV, bf16 inputs, the instances 64 to 256: a block per (b*hk row, 64
// keys a row group), its K and V loaded once, the kv head's group of q
// heads x the live q tiles streamed (q, dO hi, dO lo where set, and the q
// rows' lse and D), keys on the rows. dV = P^T.dO; dS^T = P^T (V.dO^T -
// D); dK = scale dS^T.Q.
template <int D, bool kTma>
__global__ void __launch_bounds__(kBwdThreads, 1)
    flash_dkv_wgmma_kernel(const __grid_constant__ WideParams p) {
  constexpr int kT = tile_bytes<D>();
  constexpr int kG = row_groups<D>(), kN = out_cols<D>();
  constexpr int kSt = ring_stages<D>(kDkv);
  const Args& a = p.a;
  const Shape& sh = a.sh;
  unsigned char* sp;
  const uint32_t base = aligned_smem(sp);
  // K and V of the row groups, then the ring: stage s is q, dO hi, dO lo
  // at base + (2 kG + 3s) tiles; each stage's rows after the tiles
  const uint32_t rows_s = base + (2 * kG + 3 * kSt) * kT;
  const uint32_t ds_s = rows_s + kSt * kRowBytes;  // dS^T hi, lo by WG
  const uint32_t bars = ds_s + kDsBytes;  // full, empty, once
  const uint32_t once = bars + 16 * kSt;
  auto stage_tile = [&](int s, int part) {
    return base + (2 * kG + 3 * s + part) * kT;
  };
  // a stage's rows: lse log2 e [64], D [64], the dO lo flag
  auto stage_rows = [&](int s) {
    return reinterpret_cast<float*>(sp + (2 * kG + 3 * kSt) * kT +
                                    s * kRowBytes);
  };

  const int row = blockIdx.x;  // bi * hk + hkv
  // causal: the first keys are seen by the most q tiles, and launch first
  const int k_first = blockIdx.y * kG * kTile;
  const int bi = row / sh.hk, hkv = row % sh.hk;
  const int n_qt = (sh.s_q + kTile - 1) / kTile;
  int qt_lo, qt_hi;
  live_run_rows(k_first, kG * kTile, n_qt, false, sh, qt_lo, qt_hi);
  const int n_live = qt_hi - qt_lo + 1;
  const int n_it = n_live > 0 ? sh.group * n_live : 0;
  const int hq0 = hkv * sh.group;
  init_barriers(bars, kTma ? 32 : 128, kTma ? 1 : 128, kSt);

  if (threadIdx.x < 128) {  // the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    // kTma: warp 0 (lane 0 the copies); else all 128 threads
    constexpr int kPn = kTma ? 32 : 128;
    if (threadIdx.x >= kPn) return;
    const int t = threadIdx.x;
    if constexpr (kTma) {
      if (t == 0) {
        mbar_expect(once, 2 * kG * kT);
        for (int w = 0; w < kG; ++w) {
          const int r0 = k_first + w * kTile;
          tma_tile<D>(base + w * kT, &p.tk, once, hkv, r0, bi);
          tma_tile<D>(base + (kG + w) * kT, &p.tv, once, hkv, r0, bi);
        }
      }
    } else {
      for (int w = 0; w < kG; ++w) {
        const int r0 = k_first + w * kTile;
        plain_tile<D>(sp + w * kT, static_cast<const bf16*>(a.k), a.sk, bi,
                      hkv, r0, sh.s_kv, sh.d);
        plain_tile<D>(sp + (kG + w) * kT, static_cast<const bf16*>(a.v),
                      a.sv, bi, hkv, r0, sh.s_kv, sh.d);
      }
      fence_async_shared();
      mbar_arrive(once);
    }
    const Strides sd = dense_strides(sh);
    for (int it = 0; it < n_it; ++it) {
      const int s = it % kSt;
      const int hq = hq0 + it / n_live, qt = qt_lo + it % n_live;
      const int q_first = qt * kTile;
      const int qrow = bi * sh.h + hq;
      mbar_wait(bars + 8 * (kSt + s), ((it / kSt) & 1) ^ 1);
      // the q rows' lse (times log2 e) and D; rows past s_q are 0
      float* rw = stage_rows(s);
      for (int i = t; i < 2 * kTile; i += kPn) {
        const int pos = q_first + i % kTile;
        const long long rix = (long long)qrow * sh.s_q + pos;
        rw[i] = pos >= sh.s_q ? 0.f
                : i < kTile   ? a.lse_in[rix] * kLog2e
                              : a.dcap[rix];
      }
      const int lo = a.lo_live[qrow * n_qt + qt];
      if (t == 0) reinterpret_cast<int*>(rw)[2 * kTile] = lo;
      if constexpr (kTma) {
        if (t != 0) {
          mbar_arrive(bars + 8 * s);
          continue;
        }
        mbar_expect(bars + 8 * s, (2 + (lo != 0)) * kT);
        tma_tile<D>(stage_tile(s, 0), &p.tq, bars + 8 * s, hq, q_first, bi);
        tma_tile<D>(stage_tile(s, 1), &p.thi, bars + 8 * s, hq, q_first, bi);
        if (lo) {
          tma_tile<D>(stage_tile(s, 2), &p.tlo, bars + 8 * s, hq, q_first,
                      bi);
        }
      } else {
        unsigned char* st = sp + (2 * kG + 3 * s) * kT;
        plain_tile<D>(st, static_cast<const bf16*>(a.q), a.sq, bi, hq,
                      q_first, sh.s_q, sh.d);
        plain_tile<D>(st + kT, static_cast<const bf16*>(a.do_hi), sd, bi, hq,
                      q_first, sh.s_q, sh.d);
        if (lo) {
          plain_tile<D>(st + 2 * kT, static_cast<const bf16*>(a.do_lo), sd,
                        bi, hq, q_first, sh.s_q, sh.d);
        }
        fence_async_shared();
        mbar_arrive(bars + 8 * s);
      }
    }
    return;
  }

  // a consumer: 64 keys (row group rg), its kN output columns from c0
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int cw = threadIdx.x / 128 - 1;
  const int rg = kG > 1 ? cw : 0, c0 = split_cols<D>() ? cw * kN : 0;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int tq = lane % 4;
  const int w_first = k_first + rg * kTile;  // this consumer's keys
  const int r_first = w_first + warp * 16;   // this warp's: 16 from here
  const int kpos0 = r_first + lane / 4;      // this thread's: and + 8
  // descriptor low words of this consumer's K and V
  const uint32_t k_w = kdesc(base + rg * kT);
  const uint32_t v_w = kdesc(base + (kG + rg) * kT);
  const uint32_t col_off = (c0 / 64) * kBox;  // Q's and dO's from c0
  const float scale2 = sh.scale * kLog2e;
  float dk[kN / 8][4] = {}, dv[kN / 8][4] = {};
  mbar_wait(once, 0);

  for (int it = 0; it < n_it; ++it) {
    const int s = it % kSt;
    mbar_wait(bars + 8 * s, (it / kSt) & 1);
    const int q_first = (qt_lo + it % n_live) * kTile;
    if (w_first < sh.s_kv &&
        band_meets(q_first, q_first + kTile - 1, w_first,
                   w_first + kTile - 1, sh)) {  // consumer-wide
      const float* ls = stage_rows(s);
      const float* dcs = ls + kTile;
      const bool lo = reinterpret_cast<const int*>(ls)[2 * kTile] != 0;
      const uint32_t qs = stage_tile(s, 0), dohi = stage_tile(s, 1);
      const uint32_t dolo = stage_tile(s, 2);
      // S^T = K.Q^T and dP^T = V.(dO_hi + dO_lo)^T: 64 keys x 64 q
      float sc[kNs][4] = {}, ds[kNs][4] = {};
      scores_batch<D>(sc, ds, k_w, kdesc(qs), v_w, kdesc(dohi), lo, v_w,
                      kdesc(dolo));
      if (!pairs_full(q_first, q_first + kTile - 1, r_first, r_first + 15,
                      sh)) {
        mask_tile(sc, r_first, q_first, false, sh, lane);
      }
      // P^T = 2^(S^T scale2 - lse2) and dS^T = P^T (dP^T - D), the lse
      // and D by column
#pragma unroll
      for (int j = 0; j < kNs; ++j) {
        // the column's lse and D loaded where they are used: hoisted, the
        // 32 loads held as many registers beside dK, dV, S^T and dP^T
        asm volatile("" ::: "memory");
        const float2 l2 = *reinterpret_cast<const float2*>(&ls[8 * j + 2 * tq]);
        const float2 d2 =
            *reinterpret_cast<const float2*>(&dcs[8 * j + 2 * tq]);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          p_in_place(sc[j][c], scale2, c & 1 ? l2.y : l2.x);
          ds[j][c] = sc[j][c] * (ds[j][c] - (c & 1 ? d2.y : d2.x));
        }
      }
      // P^T's parts stay in registers; dS^T's go through this consumer's
      // shared tiles (in registers too, 192 values a thread at head dim
      // 128 with dK and dV, and ptxas spilled), visible to wgmma once the
      // consumer's four warps have written them
      uint32_t p_hi[4][4], p_lo[4][4];
      split_a(sc, p_hi, p_lo);
      store_ds(ds, sp + (ds_s - base) + cw * 2 * kBox, warp, lane);
      fence_async_shared();
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
      // dV += P_lo.dO_hi + P_hi.dO_hi (+ P_hi.dO_lo); dK += (dS_lo +
      // dS_hi).Q, scaled at the end
      const uint32_t ds_w = ds_s + cw * 2 * kBox;
      dkv_batch<kN>(dk, dv, p_hi, p_lo, kdesc(ds_w), kdesc(ds_w + kBox),
                    mndesc(dohi + col_off), mndesc(qs + col_off), lo,
                    mndesc(dolo + col_off));
    }
    mbar_arrive(bars + 8 * (kSt + s));  // this stage is free
  }

  bf16* dk_out = static_cast<bf16*>(a.dk);
  bf16* dv_out = static_cast<bf16*>(a.dv);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kpos = kpos0 + 8 * r;
    if (kpos >= sh.s_kv) continue;
    const long long at =
        (((long long)bi * sh.s_kv + kpos) * sh.hk + hkv) * sh.d + c0;
    store_row_bf16<kN>(dk_out + at, dk, r, sh.scale, lane, sh.d - c0);
    store_row_bf16<kN>(dv_out + at, dv, r, 1.f, lane, sh.d - c0);
  }
}

// --- the prologue --------------------------------------------------------------

struct PrepArgs {
  const float* dout;  // (b, s_q, h, d) fp32, strided, the head dim dense
  Strides sdo;
  const float* o;      // (b, s_q, h, d) fp32 dense
  const float* g_lse;  // (b, s_q, h) fp32 dense, or null: none
  bf16 *hi, *lo;       // (b, s_q, h, d) bf16 dense
  int* lo_live;        // (b*h, q tiles of 64)
  float* dcap;         // (b*h, s_q) fp32
  int h, s_q, d;       // d: the true head dim, at most the instance's D
};

// One block of 256 threads per (b*h row, 64 q rows): dO's parts, the lo
// flag of the rows, and D. A row's kLanes threads (D / 4, at most a warp)
// each take kVals of its values, kLanes apart, so a warp's loads and
// stores are contiguous; a thread starts the loads of all its rows before
// it uses one (the pass is bound by bytes, and a row at a time left it
// waiting on each load). Columns from the true d on are neither read nor
// written: they add 0 to D and set no flag. kExact: d is D, and the column
// tests fold away.
template <int D, bool kExact>
__global__ void __launch_bounds__(256) flash_prep_kernel(PrepArgs p) {
  constexpr int kLanes = D / 4 < 32 ? D / 4 : 32;  // threads a row
  constexpr int kVals = D / kLanes;                // values a thread a row
  constexpr int kRowsPer = 256 / kLanes;           // rows a pass
  constexpr int kRows = kTile / kRowsPer;          // a thread's rows
  const int dd = kExact ? D : p.d;  // the true head dim
  const int row = blockIdx.x, bi = row / p.h, hh = row % p.h;
  const int q0 = blockIdx.y * kTile + threadIdx.x / kLanes;
  const int c0 = threadIdx.x % kLanes;
  float x[kRows][kVals], y[kRows][kVals];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int pos = q0 + i * kRowsPer;
    const float* src = p.dout + bi * p.sdo.b + (long long)pos * p.sdo.s +
                       hh * p.sdo.h + c0;
    const float* on =
        p.o + (((long long)bi * p.s_q + pos) * p.h + hh) * dd + c0;
#pragma unroll
    for (int e = 0; e < kVals; ++e) {
      const bool in = pos < p.s_q && c0 + e * kLanes < dd;
      x[i][e] = in ? src[e * kLanes] : 0.f;
      y[i][e] = in ? on[e * kLanes] : 0.f;
    }
  }
  bool nz = false;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int pos = q0 + i * kRowsPer;
    const long long at =
        (((long long)bi * p.s_q + pos) * p.h + hh) * dd + c0;
    float dot = 0.f;
#pragma unroll
    for (int e = 0; e < kVals; ++e) {
      const bf16 h = __float2bfloat16_rn(x[i][e]);
      const bf16 l = __float2bfloat16_rn(x[i][e] - __bfloat162float(h));
      if (pos < p.s_q && c0 + e * kLanes < dd) {
        p.hi[at + e * kLanes] = h;
        p.lo[at + e * kLanes] = l;
      }
      nz |= (__bfloat16_as_ushort(l) & 0x7fff) != 0;
      dot = dot + x[i][e] * y[i][e];
    }
#pragma unroll
    for (int o = kLanes / 2; o > 0; o /= 2) {
      dot += __shfl_xor_sync(0xffffffffu, dot, o);
    }
    if (c0 == 0 && pos < p.s_q) {
      const long long rix = (long long)row * p.s_q + pos;
      p.dcap[rix] =
          p.g_lse ? dot - p.g_lse[((long long)bi * p.s_q + pos) * p.h + hh]
                  : dot;
    }
  }
  nz = __syncthreads_or(nz);
  if (threadIdx.x == 0) p.lo_live[row * gridDim.y + blockIdx.y] = nz;
}

// flash_prep_kernel on the narrowest instance D of Ds (ascending) that
// holds p.d (its exact function at D's own width); past the widest,
// refused
template <int D>
int launch_prep_at(const PrepArgs& p, dim3 grid, cudaStream_t s) {
  if (p.d == D) {
    flash_prep_kernel<D, true><<<grid, 256, 0, s>>>(p);
  } else {
    flash_prep_kernel<D, false><<<grid, 256, 0, s>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int... Ds>
int launch_prep(const PrepArgs& p, dim3 grid, cudaStream_t s) {
  int rc = static_cast<int>(cudaErrorInvalidValue);
  ((p.d >= 1 && p.d <= Ds ? (rc = launch_prep_at<Ds>(p, grid, s), true)
                          : false) ||
   ...);
  return rc;
}

// --- launches ------------------------------------------------------------------

// codes past cudaError_t's: a failed cuTensorMapEncodeTiled (its CUresult
// added) and a libcuda without it
constexpr int kEncodeError = 20000;

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, fetched once (the library links
// only the runtime)
int encoder(EncodeTiled* out) {
  static std::atomic<EncodeTiled> fn{nullptr};
  EncodeTiled f = fn.load();
  if (f == nullptr) {
    void* sym = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &sym, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &sym, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return static_cast<int>(err);
    if (found != cudaDriverEntryPointSuccess || sym == nullptr) {
      return kEncodeError + CUDA_ERROR_NOT_FOUND;
    }
    f = reinterpret_cast<EncodeTiled>(sym);
    fn.store(f);
  }
  *out = f;
  return 0;
}

// The map of a (b, s, heads, d) bf16 tensor with (b, s, h) strides st:
// dims innermost first (d, heads, s, b), boxes of 64 columns x 1 head x 64
// rows, 128-byte swizzle, rows past s and columns past d (the true head
// dim) zero-filled; a box counts its whole bytes on the barrier, filled or
// not
int encode_rows(EncodeTiled enc, CUtensorMap* map, const void* ptr,
                Strides st, int b, int s, int heads, int d) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st.h) * 2,
                                 static_cast<cuuint64_t>(st.s) * 2,
                                 static_cast<cuuint64_t>(st.b) * 2};
  const cuuint32_t box[4] = {64, 1, kTile, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult res = enc(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : kEncodeError + static_cast<int>(res);
}

// Launch a wide backward kernel with `bytes` of dynamic shared memory,
// raising the function's limit first, once per device (launch_kernel's
// rule for a WideParams kernel)
template <void (*K)(const WideParams)>
int launch_wide(dim3 grid, int bytes, const WideParams& p,
                cudaStream_t stream) {
  static std::atomic<unsigned long long> raised{0};  // a bit per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long bit = 1ull << (dev % 64);
  if (!(raised.load() & bit)) {
    err = cudaFuncSetAttribute(K, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    raised.fetch_or(bit);
  }
  K<<<grid, kBwdThreads, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// TMA for the wgmma kernels: every q, k and v row 16-byte aligned, and
// rows of the true d a multiple of 16 bytes (dO's dense parts; else their
// map cannot be encoded); plain loads otherwise
bool tma_route(const Args& a) {
  return rows_aligned(a) && a.sh.d % 8 == 0;
}

// The wide bf16 dQ or dK/dV pass, on TMA or plain loads (tma_route). A
// failed map encode, attribute raise or launch returns its error; nothing
// falls back.
template <int D>
int launch_wide_bwd(Pass pass, const Args& a, cudaStream_t stream) {
  if (a.do_hi == nullptr || a.do_lo == nullptr || a.lo_live == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Shape& sh = a.sh;
  WideParams p;
  std::memset(&p, 0, sizeof(p));
  p.a = a;
  const bool tma = tma_route(a);
  if (tma) {
    EncodeTiled enc;
    int rc = encoder(&enc);
    const Strides sd = dense_strides(sh);
    const int d = sh.d;
    if (!rc) rc = encode_rows(enc, &p.tq, a.q, a.sq, sh.b, sh.s_q, sh.h, d);
    if (!rc) rc = encode_rows(enc, &p.tk, a.k, a.sk, sh.b, sh.s_kv, sh.hk, d);
    if (!rc) rc = encode_rows(enc, &p.tv, a.v, a.sv, sh.b, sh.s_kv, sh.hk, d);
    if (!rc) rc = encode_rows(enc, &p.thi, a.do_hi, sd, sh.b, sh.s_q, sh.h, d);
    if (!rc) rc = encode_rows(enc, &p.tlo, a.do_lo, sd, sh.b, sh.s_q, sh.h, d);
    if (rc) return rc;
  }
  constexpr int kRows = row_groups<D>() * kTile;  // rows of a block
  if (pass == kDq) {
    const dim3 grid(sh.b * sh.h, (sh.s_q + kRows - 1) / kRows);
    return tma ? launch_wide<flash_dq_wgmma_kernel<D, true>>(
                     grid, wide_smem<D>(kDq), p, stream)
               : launch_wide<flash_dq_wgmma_kernel<D, false>>(
                     grid, wide_smem<D>(kDq), p, stream);
  }
  const dim3 grid(sh.b * sh.hk, (sh.s_kv + kRows - 1) / kRows);
  return tma ? launch_wide<flash_dkv_wgmma_kernel<D, true>>(
                   grid, wide_smem<D>(kDkv), p, stream)
             : launch_wide<flash_dkv_wgmma_kernel<D, false>>(
                   grid, wide_smem<D>(kDkv), p, stream);
}

}  // namespace

extern "C" {

// The backward's prologue on `stream` (does not synchronize; returns
// cudaGetLastError()): dO (b, s_q, h, d) fp32 with (b, s, h) strides
// do_strides into hi and lo, dense bf16; lo_live (b*h, ceil(s_q / 64))
// int32; D = rowsum(dO * O) into dcap (b*h, s_q) fp32, O dense fp32 as
// the forward writes it, less g_lse ((b, s_q, h) dense fp32) when given.
// d runs on the library's narrowest instance that holds it (64 or 128, or
// 256); a d past its widest is refused.
int kst_flash_prep(const void* dout, const long long* do_strides,
                   const void* o, const void* g_lse, void* hi, void* lo,
                   void* lo_live, void* dcap, int b, int h, int s_q, int d,
                   void* stream) {
  if (b <= 0 || h <= 0 || s_q <= 0) return 0;
  if (o == nullptr || dcap == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  PrepArgs p = {static_cast<const float*>(dout),
                {do_strides[0], do_strides[1], do_strides[2]},
                static_cast<const float*>(o),
                static_cast<const float*>(g_lse),
                static_cast<bf16*>(hi),
                static_cast<bf16*>(lo),
                static_cast<int*>(lo_live),
                static_cast<float*>(dcap),
                h,
                s_q,
                d};
  const dim3 grid(b * h, (s_q + kTile - 1) / kTile);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#ifdef KST_FLASH_256
  return launch_prep<256>(p, grid, s);
#else
  return launch_prep<64, 128>(p, grid, s);
#endif
}

}  // extern "C"
