// flash_attention: causal or non-causal GQA attention on Hopper (sm_90a).
//
//   out[b, i, h, :] = softmax_j(q[b, i, h, :] . k[b, j, h / G, :] * scale)
//                     . v[b, j, h / G, :]        with G = H / K
//
// q (B, Sq, H, D), k and v (B, Sk, K, D), float32 or bfloat16, any strides
// with the last dimension contiguous (strides a multiple of 4 elements,
// 16-byte-aligned base). out (B, Sq, H, D) float32, written in place of the
// caller's buffer. The causal mask is aligned bottom-right, as the
// reference's attention_ref (tril(k = Sk - Sq)): row i sees keys
// j <= i + Sk - Sq. A masked score takes the reference's fill -2e38, so a
// row with no key at all (only when Sq > Sk) averages every value with
// equal weight, exactly as the reference's softmax does.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py
// (_flash_kernel, launched by flash_attention_bhsd). That kernel walks a
// (B, H, Sq/BQ, Sk/BK) grid with the KV axis innermost and carries the
// online-softmax state in VMEM scratch between grid steps; its causal mask
// is aligned top-left (qpos >= kpos), which equals the reference only when
// Sq == Sk.
//
// Bound on the H100: with causal masking the work is ~2*B*H*Sq*Sk*D
// multiply-adds in all (QK^T and PV, half the square each), against
// B*(Sq*H + 2*Sk*K)*D*elt + 4*B*Sq*H*D bytes, so at the main path's shape
// (B=1, S=32768, H=14, K=2, D=64) it is bound by operations by three
// orders of magnitude. This first design computes in float32 on the CUDA
// cores (FMA, no tensor cores), so that a float32 input meets the
// reference's 2e-6: its floor is the card's non-tensor f32 rate.
//
// Design (one CTA per (query tile, head, batch)):
//  * 128 threads own a 64-row query tile: thread (tr, tc) = (tid / 8,
//    tid % 8) owns rows 4*tr .. 4*tr+3; of each 64-key tile it scores keys
//    tc + 8*j (j < 8), and of the output it owns the columns
//    (jv*8 + tc)*VEC + e, so the 8 lanes that share a row are one
//    quarter-warp and reduce by shuffles.
//  * Q, and per step one K and one V tile, are staged in shared memory,
//    widened to float32, rows padded by 4 floats (conflict-free float4
//    reads). P goes through shared memory between QK^T and PV.
//  * The online softmax keeps the running max, sum and accumulator in
//    float32 registers, with expf (no fast math).
//  * The KV loop ends at the tile's causal limit (the TPU kernel's `live`
//    skip); tails in Sq and Sk are masked, so no block size has to divide S.
//  * GQA by index: head h reads kv head h / (H / K); K and V are never
//    repeated. Query tiles are issued last-first, so the longest causal
//    rows start first.
//  * Head dims 16, 32, 64, 128 and 240 (gemma3's global layers). At 240 a
//    row's 240 output columns are 8 lanes x 15 float2 vectors, and the
//    shared tiles take (64*244 + 2*64*244 + 64*68)*4 = 204,800 bytes of the
//    227 KB an SM offers.
// The launch allocates nothing; the caller passes the output buffer.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;          // query rows per CTA
constexpr int BK = 64;          // keys per KV tile
constexpr int THREADS = 128;    // 16 row groups x 8 lanes
constexpr int RM = BQ / 16;     // rows per thread
constexpr int CN = BK / 8;      // scores per row per thread
constexpr int LDP = BK + 4;     // row stride of the P tile
constexpr float MASKED = -2.0e38f;   // the reference's fill for a masked score

// element strides: q b,s,h | k b,s,h | v b,s,h | out b,s,h
struct Strides {
  long long s[12];
};

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  // bfloat16 -> float32 is exact: the high half of the float's bits
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

// rows [r0, r0 + 64) of one head (row stride `rs` elements) -> float32 tile
// with row stride D + 4; rows at or beyond n are zero
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long rs, int r0, int n) {
  constexpr int V = D / 4;
  constexpr int LD = D + 4;
  for (int e = threadIdx.x; e < 64 * V; e += THREADS) {
    const int r = e / V, c = (e % V) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < n) x = load4(src + (long long)(r0 + r) * rs + c);
    *reinterpret_cast<float4*>(dst + r * LD + c) = x;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, float* __restrict__ out,
                 int H, int KH, int Sq, int Sk, const Strides st,
                 float scale, int causal) {
  constexpr int LD = D + 4;
  // output columns per vector: 8 lanes x VEC columns must tile D exactly
  // (gemma3's D = 240 takes VEC 2, NV 15)
  constexpr int VEC = D % 32 == 0 ? 4 : 2;
  constexpr int NV = D / (8 * VEC);      // vectors per row per thread
  static_assert(D % (8 * VEC) == 0, "8 lanes x VEC columns must tile D");
  static_assert(D % 4 == 0, "tiles are staged as float4");
  extern __shared__ __align__(16) float smem[];
  float* sq = smem;                 // [BQ][LD]
  float* sk = sq + BQ * LD;         // [BK][LD]
  float* sv = sk + BK * LD;         // [BK][LD]
  float* sp = sv + BK * LD;         // [BQ][LDP]

  const int n_qt = (Sq + BQ - 1) / BQ;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KH);
  const int tr = threadIdx.x >> 3, tc = threadIdx.x & 7;
  const int shift = Sk - Sq;        // row i sees keys j <= i + shift

  const T* qh = q + b * st.s[0] + h * st.s[2];
  const T* kb = k + b * st.s[3] + kh * st.s[5];
  const T* vb = v + b * st.s[6] + kh * st.s[8];
  float* oh = out + b * st.s[9] + h * st.s[11];

  int kv_end = Sk;
  if (causal && q0 + shift >= 0)    // else some row sees no key: all of Sk
    kv_end = min(Sk, min(q0 + BQ, Sq) + shift);

  load_tile<T, D>(sq, qh, st.s[1], q0, Sq);

  float m[RM], l[RM], acc[RM][NV * VEC];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = MASKED;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NV * VEC; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    load_tile<T, D>(sk, kb, st.s[4], k0, Sk);
    load_tile<T, D>(sv, vb, st.s[7], k0, Sk);
    __syncthreads();

    // scores of this thread's 4 rows x 8 keys
    float s[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qa[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i)
        qa[i] = *reinterpret_cast<const float4*>(sq + (tr * RM + i) * LD + d);
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const float4 kv =
            *reinterpret_cast<const float4*>(sk + (tc + 8 * j) * LD + d);
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          s[i][j] = fmaf(qa[i].x, kv.x, s[i][j]);
          s[i][j] = fmaf(qa[i].y, kv.y, s[i][j]);
          s[i][j] = fmaf(qa[i].z, kv.z, s[i][j]);
          s[i][j] = fmaf(qa[i].w, kv.w, s[i][j]);
        }
      }
    }

    // online softmax over this tile, per row
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int qi = q0 + tr * RM + i;
      float mx = MASKED;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const int kj = k0 + tc + 8 * j;
        float x = s[i][j] * scale;
        if (kj >= Sk) x = -INFINITY;                  // past the end: no key
        else if (causal && kj > qi + shift) x = MASKED;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        sp[(tr * RM + i) * LDP + tc + 8 * j] = p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NV * VEC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    // acc += P . V
#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float4 pr[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i)
        pr[i] = *reinterpret_cast<const float4*>(sp + (tr * RM + i) * LDP + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* vr = sv + (kk + u) * LD;
#pragma unroll
        for (int jv = 0; jv < NV; ++jv) {
          float w[VEC];
          if constexpr (VEC == 4) {
            const float4 t =
                *reinterpret_cast<const float4*>(vr + (jv * 8 + tc) * 4);
            w[0] = t.x; w[1] = t.y; w[2] = t.z; w[3] = t.w;
          } else {
            const float2 t =
                *reinterpret_cast<const float2*>(vr + (jv * 8 + tc) * 2);
            w[0] = t.x; w[1] = t.y;
          }
#pragma unroll
          for (int i = 0; i < RM; ++i) {
            const float p = u == 0 ? pr[i].x : u == 1 ? pr[i].y
                          : u == 2 ? pr[i].z : pr[i].w;
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              acc[i][jv * VEC + e] = fmaf(p, w[e], acc[i][jv * VEC + e]);
          }
        }
      }
    }
    __syncthreads();   // the next tile overwrites sk, sv and sp
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int qi = q0 + tr * RM + i;
    if (qi >= Sq) continue;
    const float inv = 1.f / l[i];
    float* orow = oh + (long long)qi * st.s[10];
#pragma unroll
    for (int jv = 0; jv < NV; ++jv) {
      const int c = (jv * 8 + tc) * VEC;
      if constexpr (VEC == 4) {
        *reinterpret_cast<float4*>(orow + c) = make_float4(
            acc[i][jv * 4] * inv, acc[i][jv * 4 + 1] * inv,
            acc[i][jv * 4 + 2] * inv, acc[i][jv * 4 + 3] * inv);
      } else {
        *reinterpret_cast<float2*>(orow + c) =
            make_float2(acc[i][jv * 2] * inv, acc[i][jv * 2 + 1] * inv);
      }
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int H, int KH, int Sq, int Sk, const Strides& st, float scale,
           int causal, cudaStream_t stream) {
  constexpr int LD = D + 4;
  const size_t smem = sizeof(float) * ((size_t)BQ * LD + 2 * BK * LD
                                       + (size_t)BQ * LDP);
  const void* fn = (const void*)flash_fwd_kernel<T, D>;
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<float*>(out), H, KH, Sq, Sk, st,
      scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// strides: 12 element strides on the host (q b,s,h | k b,s,h | v b,s,h |
// out b,s,h). Returns a cudaError_t (0 on success).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int is_bf16,
                                      int D, int B, int H, int KH, int Sq,
                                      int Sk, const void* strides,
                                      float scale, int causal,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Strides st;
  for (int i = 0; i < 12; ++i)
    st.s[i] = static_cast<const long long*>(strides)[i];
#define FLASH_CASE(DIM)                                                      \
  case DIM:                                                                  \
    return is_bf16 ? launch<__nv_bfloat16, DIM>(q, k, v, out, B, H, KH, Sq,  \
                                                Sk, st, scale, causal, s)    \
                   : launch<float, DIM>(q, k, v, out, B, H, KH, Sq, Sk, st,  \
                                        scale, causal, s);
  switch (D) {
    FLASH_CASE(16)
    FLASH_CASE(32)
    FLASH_CASE(64)
    FLASH_CASE(128)
    FLASH_CASE(240)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef FLASH_CASE
}
