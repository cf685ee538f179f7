// flash_attention_sm90: causal or non-causal GQA attention for bfloat16
// inputs on Hopper (sm_90a), on the tensor cores (wgmma) fed by TMA.
//
//   out[b, i, h, :] = softmax_j(q[b, i, h, :] . k[b, j, h / G, :] * scale)
//                     . v[b, j, h / G, :]        with G = H / K
//
// q (B, Sq, H, D), k and v (B, Sk, K, D), bfloat16, D in {16, 32, 64, 128,
// 240}, any strides with the last dimension contiguous (strides a multiple of
// 8 elements, 16-byte-aligned bases: what a TMA tensor map takes). out
// (B, Sq, H, D) float32 through its strides. The function is the one of
// flash_attention_tf32.cu (the float32 inputs' kernel) and of the reference's
// attention_ref: the causal mask is aligned bottom-right (row i sees keys
// j <= i + Sk - Sq), a masked score takes the reference's fill -2e38 and a
// key past the end -inf, so a row with no visible key (only when Sq > Sk)
// averages every value and a tile holding such a row scans all of Sk. The fill stays
// -2e38 after the scale is folded into log2(e), and the running max starts
// at -2e38, so exp2(m_prev - m_new) is never exp2(-inf + inf).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py
// (_flash_kernel, line 28) for bfloat16 inputs, as flash_attention_tf32.cu
// does for float32 ones.
//
// Bounds on an H100 SXM (132 SMs) at the prefill's shape (B=1, S=32768,
// H=14, K=2, D=64, causal: S(S+1)/2 * H = 7.52e9 visible (query, key)
// pairs):
//  * tensor operations: 4 * D flops a pair (QK^T and PV) = 1.924e12 at
//    989 TFLOP/s dense bf16 = 1.95 ms (2.92 ms for the 6 * D flops a pair
//    that the split P below executes);
//  * exponentials: one exp2 a pair on the MUFU unit, 16 a clock an SM, so
//    7.52e9 / (16 * 132 * f_sm) = 1.80 ms at the 1980 MHz maximum SM clock,
//    2.16 ms at the 1650 MHz that nvidia-smi read as the kernel was timed.
// Both are floors of the same order, so one warpgroup's softmax has to run
// while another's wgmma does; the bytes (q, k, v read once, out written
// once: 0.18 GB, 0.05 ms) are not a bound. At gemma3-12b's global layer
// (B=1, S=8192, H=16, K=8, D=240, causal: 5.37e8 pairs) the tensor work is
// 4 * 240 flops a pair = 515.5 GFLOP, 0.52 ms (0.78 ms for the split's
// 6 * D), and exp2 0.14 ms: there the tensor cores alone bound it.
//
// Design (one CTA per (query tile, head, batch)):
//  * warpgroup 0 is the producer (D = 240 has none, below): it gives up
//    registers (setmaxnreg 24) and one thread issues TMA loads: the Q tile
//    once, then K and V tiles of BK keys (128; 64 at D = 240) through a
//    ring of STAGES buffers with full/empty mbarriers. Tensor maps are 4-D
//    over (D, heads, S, B) with a box of (64, 1, rows, 1) and the 128-byte
//    swizzle (one 64-column bf16 row is 128 bytes; D = 128 takes two boxes,
//    D = 240 four, the fourth reading columns 192..255). TMA zero-fills
//    rows past the end and columns past D, and counts a box's full bytes
//    towards the barrier's transaction count, zero-filled ones included.
//  * NC consumer warpgroups own 64 query rows each (BQ = 64 * NC) and take
//    the registers the producer gave up (setmaxnreg). S = Q K^T is wgmma
//    m64nBKk16 over D/16 steps (15 at D = 240: columns 240..255 are zero),
//    both operands in shared memory (K-major), accumulated in f32
//    registers.
//  * online softmax on the accumulator fragment: scale * log2(e) is folded
//    into one FFMA a score before ex2.approx; a row's max reduces over the 4
//    lanes that share it, its sum stays per lane until the epilogue. Masks
//    are evaluated only on tiles that cross the causal diagonal or the end
//    of Sk.
//  * O += P V: P goes to bf16 in registers as the register A operand of
//    wgmma m64n64k16 (m64n240k16 at D = 240; "RS"); V is the B operand from
//    shared memory, MN-major (its D is contiguous), so the transposed-B bit
//    is set. P is split into hi = bf16(p) and lo = bf16(p - hi) and both are
//    multiplied by V, so P V keeps p to 2^-18 as the reference kernel's f32
//    P does; one bf16 P (2^-9) moves a bf16 model's logits measurably
//    (chip_smoke.py's full-width check). O stays in f32 registers, is
//    rescaled by exp2(m_prev - m_new), and the epilogue divides by the row
//    sum and stores f32 through out's strides.
//  * schedule: each consumer warpgroup runs QK^T, wait, softmax, PV, wait;
//    the warpgroups run unsynced, so one's softmax runs while another's
//    wgmma does. On an H100 at the prefill's shape this beat FA3's
//    schedules (softmax(j) beside PV(j-1) inside a warpgroup, turns at the
//    tensor cores through named barriers) run with two consumers; that
//    overlap keeps P(j-1), S(j) and O live at once, which spills at three
//    consumers' 160 registers (PERF.md, Findings). D = 64 runs three
//    consumers (BQ = 192, 512 threads, 128 x 24 + 384 x 160 registers),
//    D = 128 two (BQ = 128, 384 threads, 128 x 24 + 256 x 240), where three
//    spill. D = 240 runs two with BK = 64 and one m64n240k16 P V wgmma a
//    k-step (V's four boxes as four swizzle atoms, LBO apart, the last read
//    to column 239): O takes 120 registers, S 32 and P hi + lo 32 (at
//    BK = 128, S and P would need 64 more), and nothing past D is stored.
//    Beside a producer, ptxas kept the consumers' code within the 168
//    registers a thread that __launch_bounds__ allows 384 threads (three
//    warps on one SM sub-partition; so it does for one producer warp beside
//    8 consumer warps), whatever setmaxnreg grants, and spilled and
//    serialized the wgmmas (tools/flash_sm90_variants.py builds that
//    design). So D = 240 has no producer: 256 threads at up to 255
//    registers; thread 0 loads Q and the first STAGES tiles, and the last
//    of the 8 consumer warps to release a stage (a shared-memory count)
//    loads the stage's next tile into it.
//  * causal work skip: the KV loop ends at the tile's causal limit; query
//    tiles are issued longest-first (grid.x = heads, grid.y = query tiles
//    in reverse), so the tiles of unequal length run in LPT order.
// One CTA fills an SM's registers, so shared memory holds a deeper ring (4
// stages at D = 16, 32 and 64, 2 at D = 128 and 240: at D = 240, Q's four
// boxes take 64 KB and a stage of K and V 64 KB, 193 KB of the 227 KB a
// block may use; three stages, or BK = 128, do not fit).
//
// D = 16 and 32 (the smoke configurations' and the reference tests' head
// dims) are bound by the exponentials, not the tensor cores. At gemma3-12b's
// global shape with these head dims (B=1, S=8192, H=16, K=8, causal: 5.37e8
// visible pairs) exp2 takes 5.37e8 / (16 * 132 * 1.98 GHz) = 0.128 ms, the
// split P's 6 * D flops a pair 0.052 / 0.104 ms, the bytes ~0.005 ms; and
// beside each exp2 a pair costs ~6 more issue slots (FFMA, max, sum, the
// split's pack, unpack, subtract), so the issue rate (one warp instruction a
// clock a sub-partition) is a floor of the same order. The design:
//  * boxes exactly D wide: (D, 1, rows, 1) with the 32-byte (D = 16) or
//    64-byte (D = 32) swizzle, so TMA moves and shared memory holds no zero
//    columns; QK^T is D / 16 = 1 or 2 k-steps of m64nBKk16 (K-major, SBO 8
//    rows of 2 D bytes), P V one m64nDk16 a k-step (V MN-major, one swizzle
//    atom of D columns, SBO 8 rows, 16 rows of 2 D bytes a k-step);
//  * O is 8 (D 16) or 16 (D 32) registers a thread, so S and P fit beside it
//    at 128-key tiles; S's first k-step writes fresh registers (scale-d 0)
//    and nothing pins S or P across a tile, so they need not live at once;
//  * four consumer warpgroups (BQ = 256), which the small O leaves room
//    for: the work is bound by latency, not by a unit's rate (issue and
//    MUFU were each under half busy), so more warps beside each other win.
//    Beside a producer warpgroup, a CTA of 640 threads launches with 96
//    registers a thread and setmaxnreg only moves registers within that
//    pool, so the consumers get 112 (asking for 120 waits forever); at 112
//    ptxas spilled (D 32: 200 bytes; D 16: none in one build, 420 bytes in
//    another). So both run without a producer: 512 threads at up to 128
//    registers, the consumers reloading the ring as at D = 240 (D 16 was
//    4 % faster with a producer, 0.299 against 0.311 ms, when it did not
//    spill). A warpgroup skips the tiles past its own causal limit,
//    which are masked for all its rows. P is split into hi and lo, the ring
//    has 4 stages. tools/flash_sm90_variants.py --part small builds and
//    times the designs not kept (tools/flash_sm90_small_variants.patch adds
//    their switches to a copy of this file): on an H100 at gemma3's global
//    shape three consumers took 0.34 / 0.37 ms (D 16 / 32), two 0.40 /
//    0.43; 64-column 128-byte-swizzled boxes 0.40 / 0.41; FA3's
//    intra-warpgroup overlap (S, P and O live at once) 0.38-0.47 /
//    0.46-0.51; a staggered start of the warpgroups moved two consumers
//    with 256-key tiles from 0.40 to 0.33 but three or four by 2 % at most
//    (PERF.md, Findings).
// The launch allocates nothing;
// tensor maps are encoded on the host at each launch with
// cuTensorMapEncodeTiled, looked up with cudaGetDriverEntryPointByVersion
// (no -lcuda).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float MASKED = -2.0e38f;    // the reference's masked-score fill
constexpr int ERR_TENSOR_MAP = 10000; // + CUresult of cuTensorMapEncodeTiled
constexpr int SMEM_MAX = 232448;      // dynamic shared memory a block may use

// Per head dim: NC consumer warpgroups of 64 query rows each, the producer's
// warps (4: warpgroup 0, which gives registers to the consumers through
// setmaxnreg; 0: none, the consumers reload the ring themselves), the
// registers each consumer thread has, BK keys per KV tile, STAGES ring
// buffers and PV_N columns of O per P V wgmma (tests/test_torch_flash_sm90.py
// reads these lines)
template <int D> struct Shape;
template <> struct Shape<64> { static constexpr int NC = 3,
  PRODUCER_WARPS = 4, CONSUMER_REGS = 160, BK = 128, STAGES = 4, PV_N = 64; };
template <> struct Shape<128> { static constexpr int NC = 2,
  PRODUCER_WARPS = 4, CONSUMER_REGS = 240, BK = 128, STAGES = 2, PV_N = 64; };
template <> struct Shape<240> { static constexpr int NC = 2,
  PRODUCER_WARPS = 0, CONSUMER_REGS = 255, BK = 64, STAGES = 2, PV_N = 240; };
template <> struct Shape<16> { static constexpr int NC = 4,
  PRODUCER_WARPS = 0, CONSUMER_REGS = 128, BK = 128, STAGES = 4, PV_N = 16; };
template <> struct Shape<32> { static constexpr int NC = 4,
  PRODUCER_WARPS = 0, CONSUMER_REGS = 128, BK = 128, STAGES = 4, PV_N = 32; };

template <int D>
struct Cfg : Shape<D> {
  using S = Shape<D>;
  static constexpr int BQ = 64 * S::NC;                // query rows per CTA
  static constexpr int THREADS = 128 * S::NC + 32 * S::PRODUCER_WARPS;
  static constexpr bool PRODUCER = S::PRODUCER_WARPS > 0;
  // columns a box: D at D = 16 and 32 (one box a row, swizzled in rows of
  // 2 D bytes), else 64 (128-byte swizzle)
  static constexpr int BOX = D < 64 ? D : 64;
  static constexpr int ROW = 2 * BOX;                  // a box row's bytes
  // D = 16 and 32: S's first k-step writes fresh registers and P is not
  // pinned before Q K^T, so S and P need not live at once (the older
  // instances keep the code they were measured with)
  static constexpr bool SMALL = D < 64;
  static constexpr int CHUNKS = (D + BOX - 1) / BOX;   // boxes a row
  static constexpr int O_CHUNKS = (D + S::PV_N - 1) / S::PV_N;  // P V wgmmas
  static constexpr int Q_BOX = BQ * ROW;               // one Q box's bytes
  static constexpr int BOX_BYTES = S::BK * ROW;        // BK rows of a box
  static constexpr int TILE_BYTES = CHUNKS * BOX_BYTES;  // K or V tile
  // Q | K[STAGES] | V[STAGES] | barriers; +1024 to align the base
  static constexpr int SMEM =
      CHUNKS * Q_BOX + 2 * S::STAGES * TILE_BYTES + 1024 + 256;
  static_assert(SMEM <= SMEM_MAX, "shared memory");
  // with setmaxnreg the producer keeps 24 registers a thread and the
  // consumers take what it gives up: the CTA keeps the pool it launched with,
  // THREADS times the count __launch_bounds__ caps (a multiple of 8; an
  // increase past the pool waits forever). Without, every thread has the
  // kernel's count
  static constexpr int POOL = THREADS * (65536 / THREADS / 8 * 8);
  static_assert(PRODUCER ? 128 * S::NC * S::CONSUMER_REGS + 128 * 24 <= POOL
                         : THREADS * S::CONSUMER_REGS <= 65536,
                "registers");
  static_assert(S::PRODUCER_WARPS == 4 || S::PRODUCER_WARPS == 0,
                "producer");
  static_assert(!PRODUCER ||
                    (S::CONSUMER_REGS % 8 == 0 && S::CONSUMER_REGS <= 240),
                "setmaxnreg");
  static_assert(ROW == 32 || ROW == 64 || ROW == 128, "a swizzle's row");
  static_assert(CHUNKS * BOX >= D && D % 16 == 0, "head dim");
  // an O chunk starts at a box: a box a chunk, or one chunk of all D (at
  // most the tile's columns; columns past D are computed, never stored)
  static_assert(S::PV_N % 16 == 0 && S::PV_N <= 256 &&
                (O_CHUNKS == 1 ? S::PV_N <= CHUNKS * BOX
                               : S::PV_N == BOX && O_CHUNKS * BOX == D),
                "P V width");
  static_assert(S::BK == 64 || S::BK == 128, "keys per tile");
  static_assert(BQ <= 256, "a TMA box's rows");
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

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// One consumer warp's release of a ring stage without a producer: a count
// in shared memory; true for the last of `n` warps of this use, which then
// reloads the stage (the fences order the warps' reads before the reload).
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

// wgmma shared-memory descriptor of an operand swizzled in rows of SW bytes
// (128, 64 or 32: layout 1, 2 or 3 in bits 62-63) whose atoms (8 rows of SW
// bytes) are aligned to 8 SW bytes. `stride` is the byte distance between
// 8-row groups (SBO); `lead` the distance between atoms along the contiguous
// dimension (LBO; unused for a K-major operand and for an MN-major one one
// atom wide).
template <int SW = 128>
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lead,
                                              uint32_t stride) {
  static_assert(SW == 128 || SW == 64 || SW == 32, "swizzle");
  constexpr uint64_t layout = SW == 128 ? 1 : SW == 64 ? 2 : 3;
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lead >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((stride >> 4) & 0x3FFF) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across a wgmma issue or wait (the hardware writes them asynchronously).
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

// d[64] (+)= A (64 x 16, shared) . B (16 x 128, shared), both K-major
__device__ __forceinline__ void wgmma_qk(float (&d)[64], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
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
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[32] (+)= A (64 x 16, shared) . B (16 x 64, shared), both K-major
__device__ __forceinline__ void wgmma_qk(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[32] += A (64 x 16 bf16, registers) . B (16 x 64, shared, MN-major)
__device__ __forceinline__ void wgmma_pv(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[120] += A (64 x 16 bf16, registers) . B (16 x 240, shared, MN-major:
// 4 swizzle atoms of 64 columns, LBO apart)
__device__ __forceinline__ void wgmma_pv(float (&d)[120],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %125, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n240k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119"
      "}, {%120, %121, %122, %123}, %124, p, 1, 1, 1;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64] = A (64 x 16, shared) . B (16 x 128, shared), both K-major; the
// accumulator's old values are not read (scale-d 0), so they need not live
__device__ __forceinline__ void wgmma_qk_first(float (&d)[64], uint64_t da,
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]),
        "=f"(d[5]), "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]),
        "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]),
        "=f"(d[15]), "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]),
        "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]),
        "=f"(d[30]), "=f"(d[31]), "=f"(d[32]), "=f"(d[33]), "=f"(d[34]),
        "=f"(d[35]), "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]),
        "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]), "=f"(d[44]),
        "=f"(d[45]), "=f"(d[46]), "=f"(d[47]), "=f"(d[48]), "=f"(d[49]),
        "=f"(d[50]), "=f"(d[51]), "=f"(d[52]), "=f"(d[53]), "=f"(d[54]),
        "=f"(d[55]), "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]),
        "=f"(d[60]), "=f"(d[61]), "=f"(d[62]), "=f"(d[63])
      : "l"(da), "l"(db), "r"(0));
}

// d[8] += A (64 x 16 bf16, registers) . B (16 x 16, shared, MN-major: one
// swizzle atom of 16 columns)
__device__ __forceinline__ void wgmma_pv(float (&d)[8],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[16] += A (64 x 16 bf16, registers) . B (16 x 32, shared, MN-major: one
// swizzle atom of 32 columns)
__device__ __forceinline__ void wgmma_pv(float (&d)[16],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// Accumulator fragment of an m64nN wgmma: register i of lane `lane` in
// warp w holds row 16w + lane/4 + 8 * ((i >> 1) & 1) and column
// 8 * (i >> 2) + 2 * (lane & 3) + (i & 1).
struct Rows {
  int lo;        // this thread's first row (the second is lo + 8)
  int lane;
};

// Online softmax of one 64 x BK score tile (NS = BK / 2 registers a
// thread) in place: s becomes p, the running max m and per-lane sum l of
// each of the thread's two rows are updated, and alpha returns the factor
// by which O must be rescaled.
template <bool MASK, int NS>
__device__ __forceinline__ void softmax_tile(float (&s)[NS], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             float c, int k0, Rows rw, int Sk,
                                             int causal, int shift) {
  if constexpr (MASK) {
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int col = k0 + 8 * (i >> 2) + 2 * (rw.lane & 3) + (i & 1);
      const int row = rw.lo + 8 * ((i >> 1) & 1);
      float x = s[i] * c;
      if (col >= Sk) x = -INFINITY;                     // past the end
      else if (causal && col > row + shift) x = MASKED;
      s[i] = x;
    }
  }
  // two partial chains per row (registers i & 3 of each group of 4)
  float mx[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < NS; ++i) mx[i & 3] = fmaxf(mx[i & 3], s[i]);
  mx[0] = fmaxf(mx[0], mx[1]);     // row lo
  mx[1] = fmaxf(mx[2], mx[3]);     // row hi
  float mc[2];          // the new max in the log2 domain, negated
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    // unmasked tiles hold raw scores: c > 0, so max(s) * c = max(s * c)
    const float m_new = fmaxf(m[r], MASK ? mx[r] : mx[r] * c);
    alpha[r] = ex2(m[r] - m_new);
    m[r] = m_new;
    mc[r] = -m_new;
  }
  float sum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const int r = (i >> 1) & 1;
    const float p = MASK ? ex2(s[i] + mc[r]) : ex2(fmaf(s[i], c, mc[r]));
    s[i] = p;
    sum[i & 3] += p;
  }
  l[0] = l[0] * alpha[0] + (sum[0] + sum[1]);
  l[1] = l[1] * alpha[1] + (sum[2] + sum[3]);
}

struct Params {
  float* out;
  long long osb, oss, osh;   // out's element strides (b, s, h)
  int H, KH, Sq, Sk, causal;
  float c;                   // scale * log2(e)
};

// S = Q K^T for one warpgroup: 64 query rows at qa (Q boxes Q_BOX bytes
// apart), BK keys at kb (K boxes BOX_BYTES apart); D / 16 k-steps of 32
// bytes, ROW / 32 to a swizzled row of ROW bytes (four to a 128-byte row).
// FRESH: the first k-step writes S without reading it.
template <int D, int ROW, int Q_BOX, int BOX_BYTES, bool FRESH, int NS>
__device__ __forceinline__ void issue_qk(float (&s)[NS], uint32_t qa,
                                         uint32_t kb) {
  constexpr int PER_ROW = ROW / 32;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t col = (kk % PER_ROW) * 32;
    const uint64_t da = make_desc<ROW>(qa + (kk / PER_ROW) * Q_BOX + col, 16,
                                       8 * ROW);
    const uint64_t db = make_desc<ROW>(
        kb + (kk / PER_ROW) * BOX_BYTES + col, 16, 8 * ROW);
    if constexpr (FRESH) {        // S's first k-step: fresh registers
      if (kk == 0) {
        wgmma_qk_first(s, da, db);
        continue;
      }
    }
    wgmma_qk(s, da, db, kk > 0);
  }
}

// P as wgmma's register A fragments, one per k-step of 16 keys: hi =
// bf16(p) and lo = bf16(p - hi), so that hi + lo holds p to ~2^-16 and P V
// keeps the f32 P of the reference kernel at twice the PV tensor work
template <int BK>
struct PFrag {
  uint32_t hi[BK / 16][4];
  uint32_t lo[BK / 16][4];
};

// O += P V for one warpgroup: V's BK keys at vb, a box's columns in rows
// of ROW bytes (boxes BOX_BYTES apart), 16 keys (16 ROW bytes: 2048 for
// 64-column boxes) a k-step; one wgmma of NO * 2 columns (a box, or at D =
// 240 all four, the last read to column 239; at D = 16 and 32 the one box
// of D columns) per O chunk, hi and lo
template <int OC, int NO, int BK, int ROW, int BOX_BYTES>
__device__ __forceinline__ void issue_pv(float (&o)[OC][NO],
                                         const PFrag<BK>& p, uint32_t vb) {
#pragma unroll
  for (int c = 0; c < OC; ++c)
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t dv = make_desc<ROW>(vb + c * BOX_BYTES + kk * 16 * ROW,
                                         BOX_BYTES, 8 * ROW);
      wgmma_pv(o[c], p.hi[kk], dv);
      wgmma_pv(o[c], p.lo[kk], dv);
    }
}

// The softmax of tile j (BK = 2 NS keys) for the warpgroup whose first row
// is row0; masks only where the tile crosses the causal diagonal or the end
// of Sk.
template <int NS>
__device__ __forceinline__ void softmax_step(float (&s)[NS], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             const Params& prm, int j,
                                             int row0, Rows rw, int shift) {
  constexpr int BK = 2 * NS;
  const int k0 = j * BK;
  if (k0 + BK > prm.Sk || (prm.causal && k0 + BK - 1 > row0 + shift))
    softmax_tile<true>(s, m, l, alpha, prm.c, k0, rw, prm.Sk, prm.causal,
                       shift);
  else
    softmax_tile<false>(s, m, l, alpha, prm.c, k0, rw, prm.Sk, prm.causal,
                        shift);
}

// O *= alpha (per row), then P = bf16(s) as wgmma's register A fragments:
// the accumulator layout of S's columns 16kk..16kk+15 is the A layout of
// the k-step kk, so the conversion moves no data between lanes.
template <int OC, int NO, int BK>
__device__ __forceinline__ void rescale_and_pack(float (&o)[OC][NO],
                                                 PFrag<BK>& p,
                                                 const float (&s)[BK / 2],
                                                 const float (&alpha)[2]) {
#pragma unroll
  for (int c = 0; c < OC; ++c)
#pragma unroll
    for (int i = 0; i < NO; ++i) o[c][i] *= alpha[(i >> 1) & 1];
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float a = s[8 * kk + 2 * r], b = s[8 * kk + 2 * r + 1];
      const uint32_t h = pack_bf16(a, b);
      p.hi[kk][r] = h;
      // bf16 -> f32 is exact: the high half's bits
      p.lo[kk][r] = pack_bf16(a - __uint_as_float(h << 16),
                              b - __uint_as_float(h & 0xffff0000u));
    }
}

template <int OC, int NO>
__device__ __forceinline__ void fence_o(float (&o)[OC][NO]) {
#pragma unroll
  for (int c = 0; c < OC; ++c) fence_regs(o[c]);
}

// wgmma.fence, with the registers a wgmma batch reads pinned before it, so
// that no write to them is scheduled after the fence
template <int OC, int NO, int BK>
__device__ __forceinline__ void fence_operands(float (&s)[BK / 2],
                                               float (&o)[OC][NO],
                                               PFrag<BK>& p) {
  fence_regs(s);
  fence_o(o);
  fence_regs(p.hi);
  fence_regs(p.lo);
  wgmma_fence();
}

// The same before P V where S need not live on (D = 16 and 32): O and P
// pinned, then wgmma.fence
template <int OC, int NO, int BK>
__device__ __forceinline__ void fence_pv_operands(float (&o)[OC][NO],
                                                  PFrag<BK>& p) {
  fence_o(o);
  fence_regs(p.hi);
  fence_regs(p.lo);
  wgmma_fence();
}

// A consumer warpgroup's loop over KV tiles j: QK^T(j), wait, softmax(j),
// PV(j), wait.
template <int D>
__global__ void __launch_bounds__(Cfg<D>::THREADS, 1)
flash_sm90_kernel(const __grid_constant__ CUtensorMap tmq,
                  const __grid_constant__ CUtensorMap tmk,
                  const __grid_constant__ CUtensorMap tmv, const Params prm) {
  using C = Cfg<D>;
  constexpr int NC = C::NC;
  constexpr int ST = C::STAGES;
  constexpr int CH = C::CHUNKS;
  constexpr int BQ = C::BQ;
  constexpr int BK = C::BK;
  constexpr int BOX_BYTES = C::BOX_BYTES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t sK = sQ + CH * C::Q_BOX;                 // + stage * TILE
  const uint32_t sV = sK + ST * C::TILE_BYTES;
  const uint32_t bars = sV + ST * C::TILE_BYTES;
  // barriers: q_full | k_full[ST] | k_empty[ST] | v_full[ST] | v_empty[ST],
  // then the release counts of K's and V's stages (without a producer)
  const uint32_t q_full = bars;
  const uint32_t k_full = bars + 8, k_empty = k_full + 8 * ST;
  const uint32_t v_full = k_empty + 8 * ST, v_empty = v_full + 8 * ST;
  uint32_t* const k_count = reinterpret_cast<uint32_t*>(
      smem_raw + (v_empty + 8 * ST - smem_u32(smem_raw)));
  uint32_t* const v_count = k_count + ST;

  const int h = blockIdx.x, b = blockIdx.z;
  const int n_qt = (prm.Sq + BQ - 1) / BQ;
  const int q0 = (n_qt - 1 - (int)blockIdx.y) * BQ;   // longest tiles first
  const int kh = h / (prm.H / prm.KH);
  const int shift = prm.Sk - prm.Sq;    // row i sees keys j <= i + shift
  int kv_end = prm.Sk;
  if (prm.causal && q0 + shift >= 0)    // else some row sees no key: all Sk
    kv_end = min(prm.Sk, min(q0 + BQ, prm.Sq) + shift);
  const int n_kv = (kv_end + BK - 1) / BK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, 4 * NC);  // one arrival per consumer warp
      mbar_init(v_empty + 8 * s, 4 * NC);
      k_count[s] = v_count[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // TMA loads of Q and of K's and V's tile j into stage j % ST
  auto load_q = [&] {
    mbar_expect_tx(q_full, CH * C::Q_BOX);
    for (int c = 0; c < CH; ++c)
      tma_load(sQ + c * C::Q_BOX, &tmq, q_full, C::BOX * c, h, q0, b);
  };
  auto load_k = [&](int j) {
    const int s = j % ST;
    mbar_expect_tx(k_full + 8 * s, C::TILE_BYTES);
    for (int c = 0; c < CH; ++c)
      tma_load(sK + s * C::TILE_BYTES + c * BOX_BYTES, &tmk, k_full + 8 * s,
               C::BOX * c, kh, j * BK, b);
  };
  auto load_v = [&](int j) {
    const int s = j % ST;
    mbar_expect_tx(v_full + 8 * s, C::TILE_BYTES);
    for (int c = 0; c < CH; ++c)
      tma_load(sV + s * C::TILE_BYTES + c * BOX_BYTES, &tmv, v_full + 8 * s,
               C::BOX * c, kh, j * BK, b);
  };
  constexpr bool PRODUCER = C::PRODUCER;
  if (!PRODUCER && threadIdx.x == 0) {
    load_q();
    for (int j = 0; j < min(ST, n_kv); ++j) {
      load_k(j);
      load_v(j);
    }
  }

  const int wg = threadIdx.x / 128;
  const int cw = PRODUCER ? wg - 1 : wg;      // consumer 0 .. NC-1
  if (PRODUCER && wg == 0) {
    // ------------------------------------------------------------ producer
    if constexpr (PRODUCER)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      load_q();
      for (int j = 0; j < n_kv; ++j) {
        const uint32_t ph = (j / ST) & 1;
        mbar_wait(k_empty + 8 * (j % ST), ph ^ 1);
        load_k(j);
        mbar_wait(v_empty + 8 * (j % ST), ph ^ 1);
        load_v(j);
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    if constexpr (PRODUCER)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                   :: "n"(C::CONSUMER_REGS));
    const int t = threadIdx.x - 128 * wg;
    const int warp = t / 32, lane = t % 32;
    const int row0 = q0 + 64 * cw;               // the warpgroup's first row
    const Rows rw{row0 + 16 * warp + lane / 4, lane};
    // the warpgroup's 64 rows of Q: 64 rows x ROW bytes into each box
    const uint32_t qa = sQ + 64 * C::ROW * cw;

    constexpr int OC = C::O_CHUNKS, NO = C::PV_N / 2;
    float o[OC][NO];       // O's columns PV_N * c + 8 * (i >> 2) + ...
#pragma unroll
    for (int c = 0; c < OC; ++c)
#pragma unroll
      for (int i = 0; i < NO; ++i) o[c][i] = 0.f;
    float s[BK / 2];
    PFrag<BK> p;
    float m[2] = {MASKED, MASKED}, l[2] = {0.f, 0.f}, alpha[2];

    mbar_wait(q_full, 0);
    if constexpr (!C::SMALL) {
      for (int j = 0; j < n_kv; ++j) {
        const int sj = j % ST;
        const uint32_t ph = (j / ST) & 1;
        mbar_wait(k_full + 8 * sj, ph);
        fence_operands(s, o, p);
        issue_qk<D, C::ROW, C::Q_BOX, BOX_BYTES, false>(
            s, qa, sK + sj * C::TILE_BYTES);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
        if (lane == 0) {                           // this warp is done with K
          if constexpr (PRODUCER)
            mbar_arrive(k_empty + 8 * sj);
          else if (j + ST < n_kv && last_release(k_count + sj, 4 * NC))
            load_k(j + ST);
        }
        softmax_step(s, m, l, alpha, prm, j, row0, rw, shift);
        rescale_and_pack(o, p, s, alpha);
        mbar_wait(v_full + 8 * sj, ph);
        fence_operands(s, o, p);
        issue_pv<OC, NO, BK, C::ROW, BOX_BYTES>(o, p,
                                                sV + sj * C::TILE_BYTES);
        wgmma_commit();
        wgmma_wait<0>();
        fence_o(o);
        if (lane == 0) {                           // ... and with V
          if constexpr (PRODUCER)
            mbar_arrive(v_empty + 8 * sj);
          else if (j + ST < n_kv && last_release(v_count + sj, 4 * NC))
            load_v(j + ST);
        }
      }
    } else {
      // D = 16 and 32: S written fresh by its first k-step, P pinned until
      // its P V wgmmas are done
      auto release_k = [&](int j) {              // this warp is done with K
        if (lane == 0) {
          if constexpr (PRODUCER)
            mbar_arrive(k_empty + 8 * (j % ST));
          else if (j + ST < n_kv && last_release(k_count + j % ST, 4 * NC))
            load_k(j + ST);
        }
      };
      auto release_v = [&](int j) {              // ... and with V
        if (lane == 0) {
          if constexpr (PRODUCER)
            mbar_arrive(v_empty + 8 * (j % ST));
          else if (j + ST < n_kv && last_release(v_count + j % ST, 4 * NC))
            load_v(j + ST);
        }
      };
      // QK^T(j), wait, softmax(j), PV(j), wait. Tiles past the warpgroup's
      // own causal limit are masked for all its rows (they would add
      // exp2(-2e38 - m) = 0), so it only releases them
      int kv_wg = prm.Sk;
      if (prm.causal && row0 + shift >= 0)
        kv_wg = min(prm.Sk, min(row0 + 64, prm.Sq) + shift);
      const int n_wg = min(n_kv, (kv_wg + BK - 1) / BK);     // >= 1
      for (int j = 0; j < n_kv; ++j) {
        const int sj = j % ST;
        const uint32_t ph = (j / ST) & 1;
        mbar_wait(k_full + 8 * sj, ph);
        if (j >= n_wg) {
          release_k(j);
          mbar_wait(v_full + 8 * sj, ph);
          release_v(j);
          continue;
        }
        wgmma_fence();
        issue_qk<D, C::ROW, C::Q_BOX, BOX_BYTES, true>(
            s, qa, sK + sj * C::TILE_BYTES);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
        release_k(j);
        softmax_step(s, m, l, alpha, prm, j, row0, rw, shift);
        rescale_and_pack(o, p, s, alpha);
        mbar_wait(v_full + 8 * sj, ph);
        fence_pv_operands(o, p);
        issue_pv<OC, NO, BK, C::ROW, BOX_BYTES>(o, p,
                                                sV + sj * C::TILE_BYTES);
        wgmma_commit();
        wgmma_wait<0>();
        fence_o(o);
        fence_regs(p.hi);
        fence_regs(p.lo);
        release_v(j);
      }
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
      const int row = rw.lo + 8 * r;
      if (row >= prm.Sq) continue;
      float* orow = ob + (long long)row * prm.oss;
#pragma unroll
      for (int c = 0; c < OC; ++c)
#pragma unroll
        for (int g = 0; g < NO / 4; ++g) {
          if (C::PV_N * c + 8 * g >= D) continue;  // a column past D
          const int i = 4 * g + 2 * r;
          *reinterpret_cast<float2*>(orow + C::PV_N * c + 8 * g +
                                     2 * (lane & 3)) =
              make_float2(o[c][i] * inv[r], o[c][i + 1] * inv[r]);
        }
    }
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

// 4-D map over (D, heads, S, B) of a bf16 tensor with element strides
// (sb, ss, sh, 1); box (cols, 1, rows, 1), swizzled in rows of 2 cols bytes
// (128, 64 or 32), zero fill.
int make_map(CUtensorMap* map, const void* ptr, int D, int heads, int S,
             int B, const long long* st, int rows, int cols) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st[2] * 2, (cuuint64_t)st[1] * 2,
                                 (cuuint64_t)st[0] * 2};
  const cuuint32_t box[4] = {(cuuint32_t)cols, 1, (cuuint32_t)rows, 1};
  const CUtensorMapSwizzle swizzle = cols == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : cols == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                  : CU_TENSOR_MAP_SWIZZLE_32B;
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                   const_cast<void*>(ptr), dims, strides, box, estr,
                   CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_TENSOR_MAP + (int)r;
}

template <int D>
int launch(const void* q, const void* k, const void* v, const long long* st,
           Params prm, int B, cudaStream_t stream) {
  using C = Cfg<D>;
  CUtensorMap tq, tk, tv;
  int e = make_map(&tq, q, D, prm.H, prm.Sq, B, st, C::BQ, C::BOX);
  if (e == 0)
    e = make_map(&tk, k, D, prm.KH, prm.Sk, B, st + 3, C::BK, C::BOX);
  if (e == 0)
    e = make_map(&tv, v, D, prm.KH, prm.Sk, B, st + 6, C::BK, C::BOX);
  if (e != 0) return e;
  const void* fn = (const void*)flash_sm90_kernel<D>;
  cudaError_t ce = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (ce != cudaSuccess) return (int)ce;
  const dim3 grid(prm.H, (prm.Sq + C::BQ - 1) / C::BQ, B);
  flash_sm90_kernel<D><<<grid, C::THREADS, C::SMEM, stream>>>(tq, tk, tv, prm);
  return (int)cudaGetLastError();
}

}  // namespace

// strides: 12 element strides on the host (q b,s,h | k b,s,h | v b,s,h |
// out b,s,h). scale_log2 = scale * log2(e) >= 0. Returns 0 on success, a
// cudaError_t, or 10000 + the CUresult of a refused tensor map.
extern "C" int flash_attention_sm90_launch(
    const void* q, const void* k, const void* v, void* out, int D, int B,
    int H, int KH, int Sq, int Sk, const void* strides, float scale_log2,
    int causal, void* stream) {
  const long long* st = static_cast<const long long*>(strides);
  const Params prm{static_cast<float*>(out), st[9], st[10], st[11], H, KH,
                   Sq, Sk, causal, scale_log2};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return launch<16>(q, k, v, st, prm, B, s);
    case 32:
      return launch<32>(q, k, v, st, prm, B, s);
    case 64:
      return launch<64>(q, k, v, st, prm, B, s);
    case 128:
      return launch<128>(q, k, v, st, prm, B, s);
    case 240:
      return launch<240>(q, k, v, st, prm, B, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
