// segment_sums: the group-locking reduction on Hopper (sm_90a).
//
//   sums[g, :] = sum over n with seg_ids[n] == g of updates[n, :]
//
// seg_ids (N,) int32 in any order; ids outside [0, G) are dropped.
// updates (N, D) float32 or float16, row-major and contiguous. sums (G, D)
// float32.
//
// Replaces the Pallas TPU kernel src/repro/kernels/grouped_scatter/kernel.py
// (_seg_matmul_kernel, launched by segment_sums). That kernel folds the
// groups as a blocked one-hot MXU matmul, which does G times the necessary
// work (G*N*D multiply-adds instead of N*D adds). On Hopper the function is
// memory-bound: it must read every update row whose id is valid once, the
// ids once and write the sums once, about valid_rows*D*elt + 4*N + 4*G*D
// bytes. At N=262144, D=512, G=256, f32 and every row valid that is ~538 MB,
// ~0.16 ms at the H100 SXM's 3.35 TB/s.
//
// Design: order the rows by group, then reduce runs in registers. No float
// atomics, so the result is deterministic; sums are taken in f64 and rounded
// once, because a hot group of the main path sums ~50,000 updates, where an
// f32 running sum drifts by ~1e-3 on elements that cancel to O(1).
//  1. hist_kernel: per chunk of rows, the count of each group (integer
//     shared-memory atomics: exact, so their order does not matter).
//  2. scan_kernel (one block): per group, the exclusive prefix of its counts
//     over chunks, and the exclusive prefix of the group totals (gstart;
//     gstart[G] = number of valid rows).
//  3. scatter_kernel (one warp per chunk): a stable counting sort. Walking
//     the chunk 32 rows at a time, __match_any_sync ranks equal groups
//     within the warp; perm[pos] = row and sg[pos] = group.
//  4. reduce_sorted_kernel: block (b, dt) owns sorted positions
//     [b*rb, b*rb+rb) and BD columns; each thread owns one column, stages
//     positions in shared memory, keeps ROWS row loads in flight and adds
//     into an f64 register run. A group wholly inside the block is written
//     straight to sums; the block's first group, if it began earlier, goes
//     to head[b], its last, if it goes on later, to tail[b].
//  5. combine_kernel: groups that span blocks b0..b1 sum tail[b0] and
//     head[b0+1..b1] in block order; empty groups are written as 0.
// No shared-memory tile per group, so the reduce runs at full occupancy (the
// previous design's f64 tile of 256 groups left 2 warps an SM). The launch
// allocates nothing; the caller passes every buffer.
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int HIST_THREADS = 256;
constexpr int SCAN_THREADS = 1024;
constexpr int BD = 128;      // reduce: columns per block == threads per block
constexpr int STAGE = 256;   // reduce: sorted positions staged per step
constexpr int ROWS = 32;     // reduce: independent row loads in flight
constexpr int COMBINE_THREADS = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

__global__ void hist_kernel(const int32_t* __restrict__ seg, int64_t N, int G,
                            int64_t chunk, int32_t* __restrict__ counts) {
  extern __shared__ int hist[];    // [G]
  for (int g = threadIdx.x; g < G; g += blockDim.x) hist[g] = 0;
  __syncthreads();
  const int64_t n0 = (int64_t)blockIdx.x * chunk;
  const int64_t n1 = min64(N, n0 + chunk);
  for (int64_t n = n0 + threadIdx.x; n < n1; n += blockDim.x) {
    const int s = seg[n];
    if (s >= 0 && s < G) atomicAdd(&hist[s], 1);
  }
  __syncthreads();
  for (int g = threadIdx.x; g < G; g += blockDim.x)
    counts[(int64_t)blockIdx.x * G + g] = hist[g];
}

// counts (n_chunks, G): in, per-chunk counts; out, each chunk's offset
// within its group. gstart (G + 1): out, group start positions.
__global__ void scan_kernel(int32_t* __restrict__ counts, int n_chunks, int G,
                            int32_t* __restrict__ gstart) {
  __shared__ int part[SCAN_THREADS];
  const int t = threadIdx.x;
  for (int g = t; g < G; g += SCAN_THREADS) {
    int run = 0;
    for (int c = 0; c < n_chunks; ++c) {
      const int64_t i = (int64_t)c * G + g;
      const int v = counts[i];
      counts[i] = run;
      run += v;
    }
    gstart[g] = run;
  }
  __syncthreads();
  const int per = (G + SCAN_THREADS - 1) / SCAN_THREADS;
  const int lo = min(G, t * per);
  const int hi = min(G, lo + per);
  int s = 0;
  for (int g = lo; g < hi; ++g) s += gstart[g];
  part[t] = s;
  __syncthreads();
  if (t == 0) {
    int run = 0;
    for (int i = 0; i < SCAN_THREADS; ++i) {
      const int v = part[i];
      part[i] = run;
      run += v;
    }
    gstart[G] = run;
  }
  __syncthreads();
  int run = part[t];
  for (int g = lo; g < hi; ++g) {
    const int v = gstart[g];
    gstart[g] = run;
    run += v;
  }
}

// One warp per chunk; the walk is in row order, so the sort is stable.
__global__ void scatter_kernel(const int32_t* __restrict__ seg, int64_t N,
                               int G, int64_t chunk,
                               const int32_t* __restrict__ offs,
                               const int32_t* __restrict__ gstart,
                               int32_t* __restrict__ perm,
                               int32_t* __restrict__ sg) {
  extern __shared__ int placed[];  // [G] rows of each group placed so far
  const int lane = threadIdx.x;
  for (int g = lane; g < G; g += 32) placed[g] = 0;
  __syncwarp();
  const int64_t n0 = (int64_t)blockIdx.x * chunk;
  const int64_t n1 = min64(N, n0 + chunk);
  const int32_t* base = offs + (int64_t)blockIdx.x * G;
  const unsigned below = (1u << lane) - 1u;
  for (int64_t nb = n0; nb < n1; nb += 32) {
    const int64_t n = nb + lane;
    int g = -1;
    if (n < n1) {
      const int s = seg[n];
      if (s >= 0 && s < G) g = s;
    }
    const unsigned peers = __match_any_sync(0xffffffffu, g);
    if (g >= 0) {
      const int pos = gstart[g] + base[g] + placed[g] + __popc(peers & below);
      perm[pos] = (int32_t)n;
      sg[pos] = g;
    }
    __syncwarp();
    if (g >= 0 && (peers & below) == 0) placed[g] += __popc(peers);
    __syncwarp();
  }
}

template <typename T>
__global__ void __launch_bounds__(BD)
reduce_sorted_kernel(const T* __restrict__ upd,
                     const int32_t* __restrict__ perm,
                     const int32_t* __restrict__ sg,
                     const int32_t* __restrict__ gstart, int G, int D,
                     int64_t rb, float* __restrict__ out,
                     double* __restrict__ head, double* __restrict__ tail) {
  __shared__ int srow[STAGE];
  __shared__ int sgrp[STAGE];
  const int t = threadIdx.x;
  const int col = blockIdx.y * BD + t;
  const bool col_ok = col < D;
  const int64_t b = blockIdx.x;
  const int64_t p0 = b * rb;
  const int64_t p1 = min64((int64_t)gstart[G], p0 + rb);
  if (p0 >= p1) return;            // uniform over the block
  const int gf = sg[p0];
  const int gl = sg[p1 - 1];

  int cur = -1;
  double run = 0.0;
  auto flush = [&]() {
    if (!col_ok || cur < 0) return;
    if (cur == gf && gstart[cur] < p0)
      head[b * D + col] = run;
    else if (cur == gl && gstart[cur + 1] > p1)
      tail[b * D + col] = run;
    else
      out[(int64_t)cur * D + col] = (float)run;
  };
  for (int64_t pb = p0; pb < p1; pb += STAGE) {
    __syncthreads();               // previous stage fully consumed
    for (int k = t; k < STAGE; k += BD) {
      const int64_t p = pb + k;
      if (p < p1) {
        srow[k] = perm[p];
        sgrp[k] = sg[p];
      }
    }
    __syncthreads();
    const int cnt = (int)min64(STAGE, p1 - pb);
    for (int j0 = 0; j0 < cnt; j0 += ROWS) {
      float v[ROWS];
#pragma unroll
      for (int u = 0; u < ROWS; ++u) {
        const int j = j0 + u;
        v[u] = (j < cnt && col_ok)
                   ? to_f32(upd[(int64_t)srow[j] * D + col]) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < ROWS; ++u) {
        const int j = j0 + u;
        if (j >= cnt) break;
        const int g = sgrp[j];
        if (g != cur) {
          flush();
          cur = g;
          run = 0.0;
        }
        run += (double)v[u];
      }
    }
  }
  flush();
}

__global__ void combine_kernel(const int32_t* __restrict__ gstart, int G,
                               int D, int64_t rb,
                               const double* __restrict__ head,
                               const double* __restrict__ tail,
                               float* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (int64_t)G * D) return;
  const int g = (int)(i / D);
  const int col = (int)(i % D);
  const int64_t s = gstart[g];
  const int64_t e = gstart[g + 1];
  if (s == e) {
    out[i] = 0.f;
    return;
  }
  const int64_t b0 = s / rb;
  const int64_t b1 = (e - 1) / rb;
  if (b0 == b1) return;            // written by reduce_sorted_kernel
  double acc = tail[b0 * D + col];
  for (int64_t b = b0 + 1; b <= b1; ++b) acc += head[b * D + col];
  out[i] = (float)acc;
}

cudaError_t smem_attr(const void* fn, size_t bytes) {
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace

// C entry for ctypes. Returns the first cudaError_t met (0 = ok).
// Buffers: counts (n_chunks*G int32), gstart (G+1 int32), perm and sg
// (N int32 each), head and tail (n_blocks*D double each), out (G*D float).
// Rows are sorted in n_chunks chunks of `chunk` rows and reduced in
// n_blocks blocks of rb sorted positions.
extern "C" int segment_sums_launch(const void* seg, const void* upd,
                                   void* out, long long N, int D, int G,
                                   int is_half, void* counts, int n_chunks,
                                   long long chunk, void* gstart, void* perm,
                                   void* sg, void* head, void* tail,
                                   int n_blocks, long long rb,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* s = static_cast<const int32_t*>(seg);
  int32_t* cnt = static_cast<int32_t*>(counts);
  int32_t* gs = static_cast<int32_t*>(gstart);
  int32_t* pm = static_cast<int32_t*>(perm);
  int32_t* sgp = static_cast<int32_t*>(sg);
  double* hd = static_cast<double*>(head);
  double* tl = static_cast<double*>(tail);
  float* o = static_cast<float*>(out);
  const size_t smem = (size_t)G * sizeof(int);
  cudaError_t e;
  if ((e = smem_attr((const void*)hist_kernel, smem)) != cudaSuccess)
    return (int)e;
  if ((e = smem_attr((const void*)scatter_kernel, smem)) != cudaSuccess)
    return (int)e;

  hist_kernel<<<n_chunks, HIST_THREADS, smem, st>>>(s, N, G, chunk, cnt);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  scan_kernel<<<1, SCAN_THREADS, 0, st>>>(cnt, n_chunks, G, gs);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  scatter_kernel<<<n_chunks, 32, smem, st>>>(s, N, G, chunk, cnt, gs, pm,
                                             sgp);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const dim3 grid(n_blocks, (D + BD - 1) / BD);
  if (is_half)
    reduce_sorted_kernel<__half><<<grid, BD, 0, st>>>(
        static_cast<const __half*>(upd), pm, sgp, gs, G, D, rb, o, hd, tl);
  else
    reduce_sorted_kernel<float><<<grid, BD, 0, st>>>(
        static_cast<const float*>(upd), pm, sgp, gs, G, D, rb, o, hd, tl);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const long long GD = (long long)G * D;
  combine_kernel<<<(unsigned)((GD + COMBINE_THREADS - 1) / COMBINE_THREADS),
                   COMBINE_THREADS, 0, st>>>(gs, G, D, rb, hd, tl, o);
  return (int)cudaGetLastError();
}
