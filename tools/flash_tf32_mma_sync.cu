// flash_tf32_mma_sync: the design that tools/flash_tf32_variants.py compares
// with the shipped float32 flash kernel (src/repro_torch/kernels/
// flash_attention/csrc/flash_attention_tf32.cu). Same function, same 3xTF32
// arithmetic (hi = tf32 rounded to nearest, lo = x - hi truncated by the
// tensor core, products as hi.lo + lo.hi + hi.hi, the small terms first, a
// fresh accumulator for each tile's P V added to O with round-to-nearest
// f32), but on mma.sync.m16n8k8 .tf32 with no prep kernel: K and V tiles are
// staged in shared memory untransposed as float32 (rows padded by 4 floats,
// so the B fragment loads below are free of bank conflicts) and every warp
// splits the B fragments it loads into hi and lo itself. P V's B fragment
// holds V's keys 2t and 2t + 1 where the A layout wants t and t + 4, so
// the key order of the k-step is permuted as the shipped kernel's prep does
// (0 2 4 6 1 3 5 7), by the loads instead of a stored copy.
//
// Head dim 64 only (the comparison's shape); q (B, Sq, H, 64), k and v
// (B, Sk, K, 64) float32 with the last dimension contiguous, strides a
// multiple of 4 elements; out (B, Sq, H, 64) float32. Causal mask aligned
// bottom-right, fill -2e38, as the package's kernels.
//
// One CTA of 4 warps per (64-query tile, head, batch), 16 rows a warp, one
// K and V tile of 64 keys at a time (2 x 17 KB), two CTAs an SM.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int D = 64, BQ = 64, BK = 64, THREADS = 128, LD = D + 4;
constexpr float MASKED = -2.0e38f;

struct Strides {
  long long s[12];     // q b,s,h | k b,s,h | v b,s,h | out b,s,h
};

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// c (16 x 8, f32) += a (16 x 8, tf32, row) . b (8 x 8, tf32, col)
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void __launch_bounds__(THREADS, 2)
flash_tf32_mma_sync_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           float* __restrict__ out, int H, int KH, int Sq,
                           int Sk, const Strides st, float c, int causal) {
  __shared__ __align__(16) float sk[BK][LD];
  __shared__ __align__(16) float sv[BK][LD];
  const int h = blockIdx.x, b = blockIdx.z;
  const int n_qt = (Sq + BQ - 1) / BQ;
  const int q0 = (n_qt - 1 - (int)blockIdx.y) * BQ;   // longest tiles first
  const int kh = h / (H / KH);
  const int shift = Sk - Sq;
  int kv_end = Sk;
  if (causal && q0 + shift >= 0) kv_end = min(Sk, min(q0 + BQ, Sq) + shift);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row0 = q0 + 16 * warp, row_lo = row0 + g;

  uint32_t qh[D / 8][4], ql[D / 8][4];
  const float* qb = q + b * st.s[0] + h * st.s[2];
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = row_lo + 8 * (r & 1), col = 8 * kk + t + 4 * (r >> 1);
      const float x = row < Sq ? __ldg(qb + row * st.s[1] + col) : 0.f;
      split_tf32(x, qh[kk][r], ql[kk][r]);
    }
  const float* kb = k + b * st.s[3] + kh * st.s[5];
  const float* vb = v + b * st.s[6] + kh * st.s[8];

  float o[D / 8][4] = {};
  float m[2] = {MASKED, MASKED}, l[2] = {0.f, 0.f};
  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();                       // the last tile's reads are done
    for (int e = threadIdx.x; e < BK * D / 4; e += THREADS) {
      const int r = e / (D / 4), col = (e % (D / 4)) * 4, key = k0 + r;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f), y = x;
      if (key < Sk) {
        x = __ldg(reinterpret_cast<const float4*>(kb + key * st.s[4] + col));
        y = __ldg(reinterpret_cast<const float4*>(vb + key * st.s[7] + col));
      }
      *reinterpret_cast<float4*>(&sk[r][col]) = x;
      *reinterpret_cast<float4*>(&sv[r][col]) = y;
    }
    __syncthreads();

    // S: accumulator register 4 nb + r holds row row_lo + 8 (r >> 1), key
    // k0 + 8 nb + 2 t + (r & 1)
    float s[BK / 2];
#pragma unroll
    for (int nb = 0; nb < BK / 8; ++nb) {
      uint32_t bh[D / 8][2], bl[D / 8][2];
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          split_tf32(sk[8 * nb + g][8 * kk + t + 4 * e], bh[kk][e],
                     bl[kk][e]);
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) mma(acc, qh[kk], bl[kk]);
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) mma(acc, ql[kk], bh[kk]);
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) mma(acc, qh[kk], bh[kk]);
#pragma unroll
      for (int r = 0; r < 4; ++r) s[4 * nb + r] = acc[r] * c;
    }
    if (k0 + BK > Sk || (causal && k0 + BK - 1 > row0 + shift)) {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int col = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
        const int row = row_lo + 8 * ((i >> 1) & 1);
        if (col >= Sk) s[i] = -INFINITY;
        else if (causal && col > row + shift) s[i] = MASKED;
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < BK / 2; ++i)
        if (((i >> 1) & 1) == r) mx = fmaxf(mx, s[i]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      alpha[r] = ex2(m[r] - m_new);
      m[r] = m_new;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      s[i] = ex2(s[i] - m[(i >> 1) & 1]);
      sum[(i >> 1) & 1] += s[i];
    }
    l[0] = l[0] * alpha[0] + sum[0];
    l[1] = l[1] * alpha[1] + sum[1];

    // P as the A fragment of k-step kk (keys in the order 0 2 4 6 1 3 5 7)
    uint32_t ph[BK / 8][4], pl[BK / 8][4];
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        split_tf32(s[4 * kk + 2 * (r & 1) + (r >> 1)], ph[kk][r], pl[kk][r]);
#pragma unroll
    for (int nb = 0; nb < D / 8; ++nb) {
      uint32_t vh[BK / 8][2], vl[BK / 8][2];
#pragma unroll
      for (int kk = 0; kk < BK / 8; ++kk)
#pragma unroll
        for (int e = 0; e < 2; ++e)   // keys 2t (b0) and 2t + 1 (b1)
          split_tf32(sv[8 * kk + 2 * t + e][8 * nb + g], vh[kk][e],
                     vl[kk][e]);
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < BK / 8; ++kk) mma(acc, ph[kk], vl[kk]);
#pragma unroll
      for (int kk = 0; kk < BK / 8; ++kk) mma(acc, pl[kk], vh[kk]);
#pragma unroll
      for (int kk = 0; kk < BK / 8; ++kk) mma(acc, ph[kk], vh[kk]);
#pragma unroll
      for (int r = 0; r < 4; ++r)
        o[nb][r] = fmaf(o[nb][r], alpha[r >> 1], acc[r]);
    }
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / l[r];
  }
  float* ob = out + b * st.s[9] + h * st.s[11];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_lo + 8 * r;
    if (row >= Sq) continue;
#pragma unroll
    for (int nb = 0; nb < D / 8; ++nb)
      *reinterpret_cast<float2*>(ob + row * st.s[10] + 8 * nb + 2 * t) =
          make_float2(o[nb][2 * r] * inv[r], o[nb][2 * r + 1] * inv[r]);
  }
}

}  // namespace

// strides: 12 element strides (q b,s,h | k b,s,h | v b,s,h | out b,s,h);
// scale_log2 = scale * log2(e). Returns a cudaError_t (0 on success).
extern "C" int flash_tf32_mma_sync_launch(const void* q, const void* k,
                                          const void* v, void* out, int D_,
                                          int B, int H, int KH, int Sq,
                                          int Sk, const void* strides,
                                          float scale_log2, int causal,
                                          void* stream) {
  if (D_ != D) return (int)cudaErrorInvalidValue;
  Strides st;
  for (int i = 0; i < 12; ++i)
    st.s[i] = static_cast<const long long*>(strides)[i];
  const dim3 grid(H, (Sq + BQ - 1) / BQ, B);
  flash_tf32_mma_sync_kernel<<<grid, THREADS, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), H, KH, Sq, Sk,
      st, scale_log2, causal);
  return (int)cudaGetLastError();
}
