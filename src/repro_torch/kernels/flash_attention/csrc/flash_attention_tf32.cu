// flash_attention_tf32: causal or non-causal GQA attention for float32
// inputs on Hopper (sm_90a), on the tensor cores in 3xTF32 (wgmma .tf32),
// fed by TMA.
//
//   out[b, i, h, :] = softmax_j(q[b, i, h, :] . k[b, j, h / G, :] * scale)
//                     . v[b, j, h / G, :]        with G = H / K
//
// q (B, Sq, H, D), k and v (B, Sk, K, D), float32, D in {16, 32, 64, 128,
// 240},
// any strides with the last dimension contiguous (strides a multiple of 4
// elements, 16-byte-aligned bases). out (B, Sq, H, D) float32 through its
// strides. The function is the one of flash_attention.cu and
// flash_attention_sm90.cu: the causal mask is aligned bottom-right (row i sees
// keys j <= i + Sk - Sq), a masked score takes the reference's fill -2e38 and
// a key past the end -inf, so a row with no visible key (only when Sq > Sk)
// averages every value, and a tile holding such a row scans all of Sk.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py
// (_flash_kernel, line 28) for float32 inputs at these head dims.
//
// Accuracy: one TF32 product keeps ~11 bits of each factor and misses the
// reference's 2e-6. Each factor x is split into hi = tf32(x), rounded to
// nearest with ties away (cvt.rna), and lo = x - hi (exact in f32; the tensor
// core reads its top 19 bits); x.y ~ hi.hi' + hi.lo' + lo.hi' drops lo.lo'
// (~2^-22 |x.y|) and the bits of lo past tf32 (~2^-21). Sums stay in f32.
// ref.attention_3xtf32_model is this arithmetic in plain PyTorch.
//
// Bounds on an H100 SXM at qwen2-0.5b's f32 prefill shape (B=1, S=32768,
// H=14, K=2, D=64, causal: S(S+1)/2 * H = 7.52e9 visible (query, key) pairs,
// 4 * D flops a pair for QK^T and PV = 1.924e12):
//  * three TF32 passes: 5.77e12 flops at 494.7 TFLOP/s dense TF32 = 11.67 ms;
//  * exponentials: one exp2 a pair on the MUFU unit (16 a clock an SM) =
//    1.80 ms at the 1980 MHz maximum SM clock;
//  * the f32 work on the CUDA cores (the FMA kernel's floor): 1.924e12 at
//    67 TFLOP/s = 28.72 ms;
//  * bytes: q, k, v and out once, 0.27 GB, and the prep's 0.1 GB of reads
//    and writes, ~0.11 ms at 3.35 TB/s.
// So it is bound by the tensor cores' TF32 rate.
//
// Design:
//  * prep kernel (flash_tf32_prep): wgmma reads a .tf32 B operand only
//    K-major (the transpose bit is for 16-bit types) and TMA does not
//    transpose, so one pass over k and v writes, for each (batch, kv head),
//    K_hi and K_lo as (Skp, DP) rows (DP = D rounded up to 32: whole
//    128-byte swizzle rows) and V^T_hi and V^T_lo as (D, Skp) rows, keys
//    contiguous, Skp = Sk padded to the key tile and to the prep's 32 keys,
//    padding zero. Within each group of 8
//    keys V^T stores keys in the order 0 2 4 6 1 3 5 7 (ref.KEY_ORDER): the
//    k-step's register A fragment holds columns t and t + 4 of P where the
//    accumulator of S holds 2t and 2t + 1, so permuting V's keys the same way
//    lets P pass from the S accumulator to the P V wgmma without a shuffle.
//    The wrapper allocates the scratch (torch.empty); 4 x 16.8 MB at the
//    prefill's shape, ~0.03 ms of writes.
//  * main kernel (flash_tf32_kernel), one CTA per (128-query tile, head,
//    batch), two consumer warpgroups of 64 rows and no producer warpgroup
//    (as the bf16 kernel's D = 240 instance: 256 threads keep up to 255
//    registers): thread 0 loads the first STAGES tiles, and the last of the 8
//    warps to release a ring stage (a count in shared memory) loads its next
//    tile. A stage holds K_hi, K_lo, V^T_hi and V^T_lo of BK keys as
//    128-byte-swizzled boxes of 32 floats (64 KB at D = 64, BK = 64).
//  * Q is split into hi and lo in registers once (D registers a thread) and is
//    the register A operand of wgmma m64nBKk8 .tf32: S = Q_hi K_lo^T +
//    Q_lo K_hi^T + Q_hi K_hi^T, the small terms first, into one f32
//    accumulator.
//  * online softmax on the accumulator fragment in the log2 domain: each
//    score times scale * log2(e), ex2.approx, the running max starting at the
//    fill -2e38 (so exp2(m_prev - m_new) is never exp2(-inf + inf)), a row's
//    max reduced over the 4 lanes that share it, its sum per lane until the
//    epilogue; masks only on tiles that cross the causal diagonal or Sk.
//  * P is split into hi and lo in registers and is the A operand of wgmma
//    m64nDk8 .tf32 against V^T in shared memory: T = P_hi V_lo + P_lo V_hi +
//    P_hi V_hi into a fresh accumulator each tile, then O = O *
//    exp2(m_prev - m_new) + T in f32 with round-to-nearest adds. The tensor
//    core rounds its f32 sums toward zero: with O itself as the wgmma
//    accumulator the bias grew with Sk (24 truncating adds a tile onto all
//    of O) past 2e-6 as Sk grew; T's 24 adds start from the small
//    terms, so its bias stays near 2^-22 of T. O lives in
//    registers, or at D = 128, where Q's 128 and T's 64 registers leave no
//    room, in shared memory (each thread its own slice). The epilogue
//    divides by the row sum and stores f32 through out's strides.
//  * each warpgroup runs QK^T, wait, softmax, PV, wait; the two run unsynced,
//    so one's softmax runs while the other's wgmmas do.
//  * GQA by index (the scratch is per kv head); the KV loop ends at the
//    tile's causal limit; query tiles are issued longest-first (grid.x =
//    heads, grid.y = query tiles in reverse).
// Per head dim (Shape<D>): BK keys a tile, K_STAGES and STAGES ring stages of
// K and of V^T, NC consumer warpgroups, whether O (O_SMEM) or Q (Q_SMEM) lives
// in shared memory, and PV_N columns of O a P V wgmma. Registers decide: Q hi
// + lo take D, T D / 2, S and P hi + lo BK (S is reused) and O in registers
// D / 2, so D = 128 takes 32-key tiles (64 KB a stage, like D = 64's 64 keys)
// and O in shared memory.
//
// D = 240 (gemma3-12b's global layers). Bounds at its prefill shape (B=1,
// S=8192, H=16, K=8, causal: 5.37e8 visible pairs, 4 * 240 flops a pair =
// 5.155e11 flops): three TF32 passes 3.13 ms at 494.7 TFLOP/s, exponentials
// 0.13 ms, bytes ~0.11 ms; the tensor cores bound it. The design above does
// not fit there (255 registers a thread of a 256-thread CTA, of which the
// live set keeps to 240; 232,448 B of shared memory a block):
//  * registers: Q's hi and lo as the register A operand take D = 240, the
//    whole budget; the tile's P V accumulator T (m64n240) 120; O 120;
//  * shared memory: a K row pads to DP = 256 floats (240 is 7.5 boxes of 32);
//    a ring stage of BK keys (K_hi, K_lo, V^T_hi, V^T_lo) takes 2 BK 256 4 +
//    2 240 BK 4 = 3,968 BK bytes (126,976 at BK = 32, 63,488 at 16); Q's hi
//    and lo 2,048 BQ (262,144 at BQ = 128, 131,072 at 64); Q once in f32
//    960 BQ (122,880 at BQ = 128, 61,440 at 64); O 61,440 a 64-row
//    warpgroup.
// So the D = 240 instance keeps BQ = 128 rows and two consumer warpgroups
// that share the ring (a key's 3,968 bytes of L2 reads feed 128 rows: ~22
// bytes a clock an SM at the TF32 rate, half of what 64-row CTAs need; one
// 64-row warpgroup a CTA took 45 % longer in tools/flash_tf32_variants.py),
// and:
//  * Q in f32, each thread's A fragment of a k-step as one 16-byte word:
//    the first Q_REG = 5 k-steps in registers (20), the other 25 in shared
//    memory (102,400 B, a conflict-free load each), split into hi and lo in
//    registers right before their wgmmas, Q_GROUP = 3 k-steps at a time: one
//    wgmma fence, commit and wait a group instead of a k-step. Q_hi K_lo^T
//    and Q_lo K_hi^T sum into one accumulator; a group's Q_hi K_hi^T goes
//    to a fresh one, added into an f32 sum, rounded to nearest, once the
//    group is done; the small terms join the sum last
//    (ref.attention_3xtf32_model's order). The tensor core's adds round
//    toward zero, in proportion to the partial sum: one accumulator over all
//    30 k-steps of Q_hi K_hi^T would bias the scores by ~30 such roundings of
//    |S| (up to ~60 at D = 240), a group's by 3 of its own smaller sum;
//  * 32-key tiles, one ring stage each of K_hi and K_lo (65,536 B) and of
//    V^T_hi and V^T_lo (61,440 B): 230,656 B in all with the alignment pad
//    and barriers, which is why 5 k-steps of Q stay in registers. K(j + 1)
//    loads while tile j's softmax and P V run, V(j + 1) while tile j + 1's
//    Q K^T runs. 16-key tiles (Q all in shared memory, two V^T stages)
//    took 8.13 ms against 5.77 at gemma3's global shape, the per-tile and
//    per-k-step work of Q's split and the softmax spread over half the keys
//    (tools/flash_tf32_variants.py, an H100 80GB HBM3 at 700 W);
//  * P V in thirds of m64n80k8 (PV_N = 80), each into a fresh T of 40
//    registers, then O[:, third] = O * alpha + T; O in registers (120).
// Live registers: in P V, O 120 + T 40 + P's hi and lo 32; in Q K^T, O 120 +
// S, the group's Q_hi K_hi^T and their sum 48 + the group's Q hi and lo 24;
// Q's 20 throughout; plus indices (ptxas: 255, no spill).
#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float MASKED = -2.0e38f;    // the reference's masked-score fill
constexpr int ERR_TENSOR_MAP = 10000; // + CUresult of cuTensorMapEncodeTiled
constexpr int SMEM_MAX = 232448;      // dynamic shared memory a block may use
constexpr int PREP_KEYS = 32;         // keys per prep block
constexpr int PREP_THREADS = 256;

// Per head dim: BK keys per KV tile, K_STAGES and STAGES ring stages of K and
// V^T, NC consumer warpgroups of 64 query rows, O_SMEM (1: O in shared
// memory), Q_SMEM (1: Q in f32 in shared memory, split per k-step; else its
// hi and lo in registers), PV_N columns of O a P V wgmma, and at Q_SMEM
// Q_GROUP k-steps of Q K^T a wgmma group and Q_REG k-steps of Q in
// registers (tests/test_torch_flash_tf32.py reads these lines)
template <int D> struct Shape;
template <> struct Shape<16> { static constexpr int BK = 64, STAGES = 2,
  K_STAGES = 2, NC = 2, O_SMEM = 0, Q_SMEM = 0, PV_N = 16; };
template <> struct Shape<32> { static constexpr int BK = 64, STAGES = 2,
  K_STAGES = 2, NC = 2, O_SMEM = 0, Q_SMEM = 0, PV_N = 32; };
template <> struct Shape<64> { static constexpr int BK = 64, STAGES = 2,
  K_STAGES = 2, NC = 2, O_SMEM = 0, Q_SMEM = 0, PV_N = 64; };
template <> struct Shape<128> { static constexpr int BK = 32, STAGES = 2,
  K_STAGES = 2, NC = 2, O_SMEM = 1, Q_SMEM = 0, PV_N = 128; };
template <> struct Shape<240> { static constexpr int BK = 32, STAGES = 1,
  K_STAGES = 1, NC = 2, O_SMEM = 0, Q_SMEM = 1, PV_N = 80, Q_GROUP = 3,
  Q_REG = 5; };

// k-steps of Q kept in f32 registers (the first Q_REG; at Q_SMEM only)
template <class S>
constexpr int q_reg() {
  if constexpr (S::Q_SMEM) return S::Q_REG;
  else return 0;
}

template <int D>
struct Cfg : Shape<D> {
  using S = Shape<D>;
  static constexpr int THREADS = 128 * S::NC;      // no producer warpgroup
  static constexpr int BQ = 64 * S::NC;            // query rows per CTA
  static constexpr int DP = (D + 31) / 32 * 32;    // K scratch row (floats)
  static constexpr int K_BOXES = DP / 32;          // 32-float boxes of a row
  static constexpr int K_BOX = S::BK * 128;        // BK rows x 128 bytes
  static constexpr int K_TILE = K_BOXES * K_BOX;   // K_hi or K_lo of a tile
  static constexpr int V_KEYS = S::BK < 32 ? S::BK : 32;  // keys a V^T box row
  static constexpr int V_SWIZZLE = V_KEYS * 4;     // its bytes: 128 or 64
  static constexpr int V_BOXES = S::BK / V_KEYS;   // boxes of a V^T tile
  static constexpr int V_BOX = D * V_SWIZZLE;      // D rows x 128 (64) bytes
  static constexpr int V_TILE = V_BOXES * V_BOX;   // V^T_hi or V^T_lo
  static constexpr int K_STAGE = 2 * K_TILE, V_STAGE = 2 * V_TILE;
  static constexpr int O_BYTES = S::O_SMEM ? THREADS * D / 2 * 4 : 0;
  static constexpr int Q_REG = q_reg<S>();
  static constexpr int Q_BYTES =
      S::Q_SMEM ? THREADS * (D / 8 - Q_REG) * 16 : 0;
  static constexpr int KEY_PAD = S::BK < PREP_KEYS ? PREP_KEYS : S::BK;
  // K ring | V^T ring | O | Q | barriers and release counts; +1024 to align
  static constexpr int SMEM = S::K_STAGES * K_STAGE + S::STAGES * V_STAGE +
                              O_BYTES + Q_BYTES + 1024 + 256;
  static_assert(SMEM <= SMEM_MAX, "shared memory");
  static_assert(D % 16 == 0 && D <= (S::Q_SMEM ? 256 : 128), "head dim");
  static_assert((S::BK == 16 || S::BK % 32 == 0) && S::BK <= 64,
                "keys per tile");
  static_assert(K_BOX % 1024 == 0 && V_BOX % 1024 == 0, "box alignment");
  static_assert(D % S::PV_N == 0 && S::PV_N % 8 == 0, "P V split");
  static_assert(S::NC == 1 || S::NC == 2, "consumer warpgroups");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// One warp's release of a ring stage: a count in shared memory; true for the
// last of `n` warps of this use, which then reloads the stage (the fences
// order the warps' reads before the reload).
__device__ __forceinline__ bool last_release(uint32_t* count, uint32_t n) {
  __threadfence_block();
  const uint32_t old = atomicAdd(count, 1u);
  __threadfence_block();
  return (old + 1) % n == 0;
}

// Wait until the phase with parity `parity` has completed. A wait that
// never ends (a protocol fault) traps after ~2^26 polls instead of hanging
// the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t n = 0;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (n == (1u << 26)) __trap();
  }
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major operand swizzled in rows of SW
// bytes (128 or 64) whose atoms (8 rows) are aligned to 8 SW bytes: SBO 8 SW
// between 8-row groups, LBO unused, layout 1 (128-byte swizzle) or 2 (64).
template <int SW = 128>
__device__ __forceinline__ uint64_t make_desc(uint32_t addr) {
  static_assert(SW == 128 || SW == 64, "swizzle");
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(8 * SW >> 4) << 32) | ((SW == 128 ? 1ull : 2ull) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of wgmma operand registers
// across a wgmma issue or wait (the hardware uses them asynchronously).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j]) :: "memory");
}

// d[8] (+)= A (64 x 8 tf32, registers) . B (8 x 16, shared, K-major)
__device__ __forceinline__ void mma_tf32(float (&d)[8],
                                         const uint32_t (&a)[4],
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d[16] (+)= A (64 x 8 tf32, registers) . B (8 x 32, shared, K-major)
__device__ __forceinline__ void mma_tf32(float (&d)[16],
                                         const uint32_t (&a)[4],
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d[32] (+)= A (64 x 8 tf32, registers) . B (8 x 64, shared, K-major)
__device__ __forceinline__ void mma_tf32(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d[64] (+)= A (64 x 8 tf32, registers) . B (8 x 128, shared, K-major)
__device__ __forceinline__ void mma_tf32(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d[40] (+)= A (64 x 8 tf32, registers) . B (8 x 80, shared, K-major)
__device__ __forceinline__ void mma_tf32(float (&d)[40],
                                         const uint32_t (&a)[4],
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, {%40, %41, %42, %43}, %44, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d[60] (+)= A (64 x 8 tf32, registers) . B (8 x 120, shared, K-major)
__device__ __forceinline__ void mma_tf32(float (&d)[60],
                                         const uint32_t (&a)[4],
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %65, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n120k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59"
      "}, {%60, %61, %62, %63}, %64, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// x = hi + lo: hi = tf32(x) rounded to nearest, ties away (its low 13 bits
// zero), lo = x - hi exactly (the tensor core reads its top 19 bits)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// Online softmax of one 64 x BK score tile (NS = BK / 2 registers a thread;
// register i of lane `lane` in warp w holds row 16w + lane/4 + 8((i >> 1) & 1)
// and column 8(i >> 2) + 2(lane & 3) + (i & 1)) in place: s becomes p, the
// running max m and per-lane sum l of the thread's two rows are updated, and
// alpha returns the factor by which O must be rescaled.
template <bool MASK, int NS>
__device__ __forceinline__ void softmax_tile(float (&s)[NS], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             float c, int k0, int row_lo,
                                             int lane, int Sk, int causal,
                                             int shift) {
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    float x = s[i] * c;
    if constexpr (MASK) {
      const int col = k0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
      const int row = row_lo + 8 * ((i >> 1) & 1);
      if (col >= Sk) x = -INFINITY;                     // past the end
      else if (causal && col > row + shift) x = MASKED;
    }
    s[i] = x;
  }
  // two partial chains per row (registers i & 3 of each group of 4)
  float mx[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < NS; ++i) mx[i & 3] = fmaxf(mx[i & 3], s[i]);
  mx[0] = fmaxf(mx[0], mx[1]);     // row lo
  mx[1] = fmaxf(mx[2], mx[3]);     // row hi
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    alpha[r] = ex2(m[r] - m_new);
    m[r] = m_new;
  }
  float sum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const float p = ex2(s[i] - m[(i >> 1) & 1]);
    s[i] = p;
    sum[i & 3] += p;
  }
  l[0] = l[0] * alpha[0] + (sum[0] + sum[1]);
  l[1] = l[1] * alpha[1] + (sum[2] + sum[3]);
}

struct Params {
  const float* q;
  long long qsb, qss, qsh;   // q's element strides (b, s, h)
  float* out;
  long long osb, oss, osh;   // out's element strides (b, s, h)
  int H, KH, Sq, Sk, causal;
  float c;                   // scale * log2(e)
};

// A consumer warpgroup's loop over KV tiles j: QK^T(j), wait, softmax(j),
// PV(j), wait.
template <int D>
__global__ void __launch_bounds__(Cfg<D>::THREADS, 1)
flash_tf32_kernel(const __grid_constant__ CUtensorMap tmk,
                  const __grid_constant__ CUtensorMap tmv, const Params prm) {
  using C = Cfg<D>;
  constexpr int KST = C::K_STAGES, VST = C::STAGES;
  constexpr int BK = C::BK, BQ = C::BQ, THREADS = C::THREADS;
  constexpr int KQ = D / 8;        // k-steps of QK^T
  constexpr int KP = BK / 8;       // k-steps of P V
  constexpr int VK = C::V_KEYS / 8;    // k-steps of P V a V^T box row holds
  constexpr int PV_N = C::PV_N, NT = PV_N / 2;   // T's columns and registers
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  auto at = [&](uint32_t addr) {
    return smem_raw + (addr - smem_u32(smem_raw));
  };
  // K ring (K_hi | K_lo a stage), V^T ring (V^T_hi | V^T_lo), O, Q, barriers
  auto k_hi = [&](int s) { return base + s * C::K_STAGE; };
  auto v_hi = [&](int s) { return base + KST * C::K_STAGE + s * C::V_STAGE; };
  const uint32_t o_base = base + KST * C::K_STAGE + VST * C::V_STAGE;
  // O at O_SMEM: element i of thread x at o_smem[i * THREADS + x]
  float* const o_smem = reinterpret_cast<float*>(at(o_base));
  // Q at Q_SMEM: thread x's A fragment of k-step kk >= Q_REG at
  // q_smem[(kk - Q_REG) THREADS + x]
  float4* const q_smem = reinterpret_cast<float4*>(at(o_base + C::O_BYTES));
  const uint32_t k_full = o_base + C::O_BYTES + C::Q_BYTES;
  const uint32_t v_full = k_full + 8 * KST;
  uint32_t* const k_count = reinterpret_cast<uint32_t*>(at(v_full + 8 * VST));
  uint32_t* const v_count = k_count + KST;

  const int h = blockIdx.x, b = blockIdx.z;
  const int n_qt = (prm.Sq + BQ - 1) / BQ;
  const int q0 = (n_qt - 1 - (int)blockIdx.y) * BQ;   // longest tiles first
  const int kh = h / (prm.H / prm.KH);
  const int bh = b * prm.KH + kh;                      // the scratch's row
  const int shift = prm.Sk - prm.Sq;    // row i sees keys j <= i + shift
  int kv_end = prm.Sk;
  if (prm.causal && q0 + shift >= 0)    // else some row sees no key: all Sk
    kv_end = min(prm.Sk, min(q0 + BQ, prm.Sq) + shift);
  const int n_kv = (kv_end + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < KST; ++s) {
      mbar_init(k_full + 8 * s, 1);
      k_count[s] = 0;
    }
    for (int s = 0; s < VST; ++s) {
      mbar_init(v_full + 8 * s, 1);
      v_count[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // TMA loads of tile j's K_hi and K_lo into K stage j % KST, and of its
  // V^T_hi and V^T_lo into V stage j % VST; the maps' fourth coordinate picks
  // hi (0) or lo (1)
  auto load_k = [&](int j) {
    const int s = j % KST;
    mbar_expect_tx(k_full + 8 * s, 2 * C::K_TILE);
    for (int part = 0; part < 2; ++part)
      for (int c = 0; c < C::K_BOXES; ++c)
        tma_load(k_hi(s) + part * C::K_TILE + c * C::K_BOX, &tmk,
                 k_full + 8 * s, 32 * c, j * BK, bh, part);
  };
  auto load_v = [&](int j) {
    const int s = j % VST;
    mbar_expect_tx(v_full + 8 * s, 2 * C::V_TILE);
    for (int part = 0; part < 2; ++part)
      for (int c = 0; c < C::V_BOXES; ++c)
        tma_load(v_hi(s) + part * C::V_TILE + c * C::V_BOX, &tmv,
                 v_full + 8 * s, j * BK + C::V_KEYS * c, 0, bh, part);
  };
  if (threadIdx.x == 0) {
    for (int j = 0; j < min(KST, n_kv); ++j) load_k(j);
    for (int j = 0; j < min(VST, n_kv); ++j) load_v(j);
  }

  const int wg = threadIdx.x / 128;
  const int t = threadIdx.x % 128;
  const int warp = t / 32, lane = t % 32;
  const int row0 = q0 + 64 * wg;               // the warpgroup's first row
  const int row_lo = row0 + 16 * warp + lane / 4;   // and row_lo + 8
  const int tq = lane & 3;

  // Q as the register A operand of k-step kk (columns 8kk .. 8kk + 7):
  // a0 (row_lo, 8kk + tq), a1 (row_lo + 8, same), a2 and a3 at column + 4;
  // split into hi and lo once (registers), or kept in f32 (Q_SMEM: the
  // first QR k-steps in registers, the rest in shared memory, each thread's
  // own words, which only it reads back)
  constexpr bool Q_SMEM = C::Q_SMEM;
  constexpr int QR = C::Q_REG;
  uint32_t qh[Q_SMEM ? 1 : KQ][4], ql[Q_SMEM ? 1 : KQ][4];
  float4 qr[QR > 0 ? QR : 1];
  {
    const float* qb = prm.q + b * prm.qsb + h * prm.qsh;
#pragma unroll
    for (int kk = 0; kk < KQ; ++kk) {
      float x[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = row_lo + 8 * (r & 1);
        const int col = 8 * kk + tq + 4 * (r >> 1);
        x[r] = row < prm.Sq ? __ldg(qb + (long long)row * prm.qss + col) : 0.f;
      }
      if constexpr (Q_SMEM) {
        const float4 x4 = make_float4(x[0], x[1], x[2], x[3]);
        if (kk < QR) qr[kk < QR ? kk : 0] = x4;
        else q_smem[(kk - QR) * THREADS + threadIdx.x] = x4;
      } else {
#pragma unroll
        for (int r = 0; r < 4; ++r) split_tf32(x[r], qh[kk][r], ql[kk][r]);
      }
    }
  }

  // O's element i (row row_lo + 8((i >> 1) & 1), column 8(i >> 2) + 2 tq +
  // (i & 1)) in registers, or in shared memory (O_SMEM); T the P V of a
  // tile's PV_N columns
  constexpr bool O_SMEM = C::O_SMEM;
  float o[O_SMEM ? 1 : D / 2], tv[NT];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) {
    if constexpr (O_SMEM) o_smem[i * THREADS + threadIdx.x] = 0.f;
    else o[i] = 0.f;
  }
  float s[BK / 2];
  uint32_t ph[KP][4], pl[KP][4];
  float m[2] = {MASKED, MASKED}, l[2] = {0.f, 0.f}, alpha[2];

  for (int j = 0; j < n_kv; ++j) {
    const int sk = j % KST, sv = j % VST;
    mbar_wait(k_full + 8 * sk, (j / KST) & 1);
    // k-step kk reads 32 bytes of each key row: box kk / 4, offset kk % 4
    const uint32_t kb = k_hi(sk);
    auto k_desc = [&](int part, int kk) {
      return make_desc(kb + part * C::K_TILE + (kk / 4) * C::K_BOX +
                       (kk % 4) * 32);
    };
    if constexpr (Q_SMEM) {
      // per group g of G k-steps: Q's f32 fragments split into hi and lo;
      // Q_hi K_lo^T and Q_lo K_hi^T into s; the group's Q_hi K_hi^T into a
      // fresh hh, added into hh_sum in f32 once the group is done (while a
      // warpgroup waits for it, the other one's wgmmas run)
      constexpr int G = C::Q_GROUP, NG = KQ / G;
      static_assert(KQ % G == 0, "k-step groups");
      uint32_t qb[G][2][4];
      float hh[BK / 2], hh_sum[BK / 2];
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        if (g > 0) {
          wgmma_wait0();                   // group g - 1 is done
          fence_regs(hh);
#pragma unroll
          for (int i = 0; i < BK / 2; ++i)
            hh_sum[i] = g == 1 ? hh[i] : hh_sum[i] + hh[i];
        }
#pragma unroll
        for (int j = 0; j < G; ++j) {
          const int kk = g * G + j;
          const float4 x = kk < QR ? qr[kk < QR ? kk : 0]
                                   : q_smem[(kk - QR) * THREADS + threadIdx.x];
          split_tf32(x.x, qb[j][0][0], qb[j][1][0]);
          split_tf32(x.y, qb[j][0][1], qb[j][1][1]);
          split_tf32(x.z, qb[j][0][2], qb[j][1][2]);
          split_tf32(x.w, qb[j][0][3], qb[j][1][3]);
          fence_regs(qb[j]);
        }
        fence_regs(s);
        fence_regs(hh);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < G; ++j) {
          const int kk = g * G + j;
          mma_tf32(s, qb[j][0], k_desc(1, kk), kk > 0);   // Q_hi K_lo^T
          mma_tf32(s, qb[j][1], k_desc(0, kk), 1);        // Q_lo K_hi^T
          mma_tf32(hh, qb[j][0], k_desc(0, kk), j > 0);   // Q_hi K_hi^T
        }
        wgmma_commit();
      }
      wgmma_wait0();
      fence_regs(s);
      fence_regs(hh);
#pragma unroll
      for (int i = 0; i < BK / 2; ++i)
        s[i] += NG == 1 ? hh[i] : hh_sum[i] + hh[i];
    } else {
      fence_regs(s);
      fence_regs(qh);
      fence_regs(ql);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KQ; ++kk)      // Q_hi K_lo^T
        mma_tf32(s, qh[kk], k_desc(1, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < KQ; ++kk)      // Q_lo K_hi^T
        mma_tf32(s, ql[kk], k_desc(0, kk), 1);
#pragma unroll
      for (int kk = 0; kk < KQ; ++kk)      // Q_hi K_hi^T
        mma_tf32(s, qh[kk], k_desc(0, kk), 1);
      wgmma_commit();
      wgmma_wait0();
      fence_regs(s);
    }
    if (lane == 0 && j + KST < n_kv && last_release(k_count + sk, 4 * C::NC))
      load_k(j + KST);                     // the last warp done with K

    const int k0 = j * BK;
    if (k0 + BK > prm.Sk || (prm.causal && k0 + BK - 1 > row0 + shift))
      softmax_tile<true>(s, m, l, alpha, prm.c, k0, row_lo, lane, prm.Sk,
                         prm.causal, shift);
    else
      softmax_tile<false>(s, m, l, alpha, prm.c, k0, row_lo, lane, prm.Sk,
                          prm.causal, shift);
    // P as the A operand of k-step kk (keys 8kk .. 8kk + 7 in KEY_ORDER):
    // a0 = key 2 tq of row_lo, a1 the same of row_lo + 8, a2 and a3 key
    // 2 tq + 1: accumulator registers 4kk, 4kk + 2, 4kk + 1, 4kk + 3
#pragma unroll
    for (int kk = 0; kk < KP; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        split_tf32(s[4 * kk + 2 * (r & 1) + (r >> 1)], ph[kk][r], pl[kk][r]);

    mbar_wait(v_full + 8 * sv, (j / VST) & 1);
    // V^T rows n0 .. n0 + PV_N - 1; k-step kk: box kk / VK, offset kk % VK
    const uint32_t vb = v_hi(sv);
#pragma unroll
    for (int n0 = 0; n0 < D; n0 += PV_N) {
      auto v_desc = [&](int part, int kk) {
        return make_desc<C::V_SWIZZLE>(vb + part * C::V_TILE +
                                       (kk / VK) * C::V_BOX +
                                       n0 * C::V_SWIZZLE + (kk % VK) * 32);
      };
      fence_regs(tv);
      fence_regs(ph);
      fence_regs(pl);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KP; ++kk)      // P_hi V_lo
        mma_tf32(tv, ph[kk], v_desc(1, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < KP; ++kk)      // P_lo V_hi
        mma_tf32(tv, pl[kk], v_desc(0, kk), 1);
#pragma unroll
      for (int kk = 0; kk < KP; ++kk)      // P_hi V_hi
        mma_tf32(tv, ph[kk], v_desc(0, kk), 1);
      wgmma_commit();
      wgmma_wait0();
      fence_regs(tv);
      // O = O * alpha + T, rounded to nearest
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        const float a = alpha[(i >> 1) & 1];
        const int io = n0 / 2 + i;
        if constexpr (O_SMEM) {
          float& x = o_smem[io * THREADS + threadIdx.x];
          x = fmaf(x, a, tv[i]);
        } else {
          o[io] = fmaf(o[io], a, tv[i]);
        }
      }
    }
    if (lane == 0 && j + VST < n_kv && last_release(v_count + sv, 4 * C::NC))
      load_v(j + VST);                     // ... and with V
  }

  // epilogue: the row sums reduce over the 4 lanes of a row
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / l[r];
  }
  float* ob = prm.out + b * prm.osb + h * prm.osh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_lo + 8 * r;
    if (row >= prm.Sq) continue;
    float* orow = ob + (long long)row * prm.oss;
#pragma unroll
    for (int g = 0; g < D / 8; ++g) {
      const int i = 4 * g + 2 * r;
      float x0, x1;
      if constexpr (O_SMEM) {
        x0 = o_smem[i * THREADS + threadIdx.x];
        x1 = o_smem[(i + 1) * THREADS + threadIdx.x];
      } else {
        x0 = o[i];
        x1 = o[i + 1];
      }
      *reinterpret_cast<float2*>(orow + 8 * g + 2 * tq) =
          make_float2(x0 * inv[r], x1 * inv[r]);
    }
  }
}

// The scratch of one launch, for each (batch, kv head) bh: K_hi and K_lo
// (part, bh, Skp, DP) and V^T_hi and V^T_lo (part, bh, D, Skp), hi =
// tf32(x), lo = x - hi, zero past Sk and past D. One block per 32 keys of
// one (kv head, batch).
template <int D>
__global__ void __launch_bounds__(PREP_THREADS)
flash_tf32_prep(const float* __restrict__ k, const float* __restrict__ v,
                float* __restrict__ kt, float* __restrict__ vt, int KH,
                int Sk, int Skp, long long ksb, long long kss, long long ksh,
                long long vsb, long long vss, long long vsh) {
  constexpr int DP = Cfg<D>::DP;
  __shared__ float sv[PREP_KEYS][D + 1];
  const int kh = blockIdx.y, b = blockIdx.z;
  const int key0 = blockIdx.x * PREP_KEYS;
  const long long bh = (long long)b * KH + kh;
  const long long BHn = (long long)gridDim.z * KH;
  const float* kb = k + b * ksb + kh * ksh;
  const float* vb = v + b * vsb + kh * vsh;
  float* khi = kt + bh * Skp * DP;
  float* klo = khi + BHn * Skp * DP;
  float* vhi = vt + bh * D * Skp;
  float* vlo = vhi + BHn * D * Skp;
  for (int e = threadIdx.x; e < PREP_KEYS * DP; e += PREP_THREADS) {
    const int r = e / DP, c = e % DP, key = key0 + r;
    const float x = (key < Sk && c < D) ? __ldg(kb + key * kss + c) : 0.f;
    uint32_t hi, lo;
    split_tf32(x, hi, lo);
    khi[(long long)key * DP + c] = __uint_as_float(hi);
    klo[(long long)key * DP + c] = __uint_as_float(lo);
  }
  for (int e = threadIdx.x; e < PREP_KEYS * D; e += PREP_THREADS) {
    const int r = e / D, c = e % D, key = key0 + r;
    sv[r][c] = key < Sk ? __ldg(vb + key * vss + c) : 0.f;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < PREP_KEYS * D; e += PREP_THREADS) {
    const int d = e / PREP_KEYS, p = e % PREP_KEYS;
    // storage position p of a group of 8 keys holds key KEY_ORDER[p % 8],
    // KEY_ORDER = 0 2 4 6 1 3 5 7
    const int q8 = p & 7;
    const float x = sv[(p & ~7) + (q8 < 4 ? 2 * q8 : 2 * q8 - 7)][d];
    uint32_t hi, lo;
    split_tf32(x, hi, lo);
    vhi[(long long)d * Skp + key0 + p] = __uint_as_float(hi);
    vlo[(long long)d * Skp + key0 + p] = __uint_as_float(lo);
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// 4-D map over a dense float32 scratch of dims (inner, rows, bh, part);
// box (box_inner, box_rows, 1, 1), box_inner floats of 128 (32 floats) or 64
// (16) bytes, swizzled to match
int make_map(CUtensorMap* map, const float* ptr, int inner, int rows, int BH,
             int box_inner, int box_rows) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t dims[4] = {(cuuint64_t)inner, (cuuint64_t)rows,
                              (cuuint64_t)BH, 2};
  const cuuint64_t row = (cuuint64_t)inner * 4;
  const cuuint64_t strides[3] = {row, row * rows, row * rows * BH};
  const cuuint32_t box[4] = {(cuuint32_t)box_inner, (cuuint32_t)box_rows,
                             1, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                   const_cast<float*>(ptr), dims, strides, box, estr,
                   CU_TENSOR_MAP_INTERLEAVE_NONE,
                   box_inner == 32 ? CU_TENSOR_MAP_SWIZZLE_128B
                                   : CU_TENSOR_MAP_SWIZZLE_64B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_TENSOR_MAP + (int)r;
}

// Sk padded to the key tile and to the prep's blocks of 32 keys
template <int D>
int skp_of(int Sk) {
  constexpr int PAD = Cfg<D>::KEY_PAD;
  return (Sk + PAD - 1) / PAD * PAD;
}

// The scratch's float offset of V^T (after K_hi and K_lo)
template <int D>
long long vt_offset(int B, int KH, int Sk) {
  return 2LL * B * KH * skp_of<D>(Sk) * Cfg<D>::DP;
}

template <int D>
int prep(const void* k, const void* v, float* scratch, int B, int KH, int Sk,
         const long long* st, cudaStream_t stream) {
  const int Skp = skp_of<D>(Sk);
  const dim3 grid(Skp / PREP_KEYS, KH, B);
  flash_tf32_prep<D><<<grid, PREP_THREADS, 0, stream>>>(
      static_cast<const float*>(k), static_cast<const float*>(v), scratch,
      scratch + vt_offset<D>(B, KH, Sk), KH, Sk, Skp, st[3], st[4], st[5],
      st[6], st[7], st[8]);
  return (int)cudaGetLastError();
}

template <int D>
int launch(const void* k, const void* v, float* scratch, const long long* st,
           Params prm, int B, cudaStream_t stream) {
  using C = Cfg<D>;
  int e = prep<D>(k, v, scratch, B, prm.KH, prm.Sk, st, stream);
  if (e != 0) return e;
  const int Skp = skp_of<D>(prm.Sk), BH = B * prm.KH;
  CUtensorMap tk, tv;
  e = make_map(&tk, scratch, C::DP, Skp, BH, 32, C::BK);
  if (e == 0)
    e = make_map(&tv, scratch + vt_offset<D>(B, prm.KH, prm.Sk), Skp, D, BH,
                 C::V_KEYS, D);
  if (e != 0) return e;
  const void* fn = (const void*)flash_tf32_kernel<D>;
  cudaError_t ce = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (ce != cudaSuccess) return (int)ce;
  const dim3 grid(prm.H, (prm.Sq + C::BQ - 1) / C::BQ, B);
  flash_tf32_kernel<D><<<grid, C::THREADS, C::SMEM, stream>>>(tk, tv, prm);
  return (int)cudaGetLastError();
}

}  // namespace

// The prep kernel alone (for checking its layout): k and v (B, Sk, KH, D)
// with element strides st[3..8] (k b,s,h | v b,s,h); scratch as the wrapper
// allocates it (kernel_tf32.scratch_floats). Returns a cudaError_t.
extern "C" int flash_attention_tf32_prep(const void* k, const void* v,
                                         void* scratch, int D, int B, int KH,
                                         int Sk, const void* strides,
                                         void* stream) {
  const long long* st = static_cast<const long long*>(strides);
  float* sc = static_cast<float*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return prep<16>(k, v, sc, B, KH, Sk, st, s);
    case 32:
      return prep<32>(k, v, sc, B, KH, Sk, st, s);
    case 64:
      return prep<64>(k, v, sc, B, KH, Sk, st, s);
    case 128:
      return prep<128>(k, v, sc, B, KH, Sk, st, s);
    case 240:
      return prep<240>(k, v, sc, B, KH, Sk, st, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// strides: 12 element strides on the host (q b,s,h | k b,s,h | v b,s,h |
// out b,s,h). scale_log2 = scale * log2(e). Runs the prep kernel, then the
// attention kernel, on `stream`. Returns 0 on success, a cudaError_t, or
// 10000 + the CUresult of a refused tensor map.
extern "C" int flash_attention_tf32_launch(
    const void* q, const void* k, const void* v, void* out, void* scratch,
    int D, int B, int H, int KH, int Sq, int Sk, const void* strides,
    float scale_log2, int causal, void* stream) {
  const long long* st = static_cast<const long long*>(strides);
  const Params prm{static_cast<const float*>(q), st[0], st[1], st[2],
                   static_cast<float*>(out), st[9], st[10], st[11],
                   H, KH, Sq, Sk, causal, scale_log2};
  float* sc = static_cast<float*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return launch<16>(k, v, sc, st, prm, B, s);
    case 32:
      return launch<32>(k, v, sc, st, prm, B, s);
    case 64:
      return launch<64>(k, v, sc, st, prm, B, s);
    case 128:
      return launch<128>(k, v, sc, st, prm, B, s);
    case 240:
      return launch<240>(k, v, sc, st, prm, B, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
