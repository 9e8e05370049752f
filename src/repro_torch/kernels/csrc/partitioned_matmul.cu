// Multi-tenant partitioned weight-stationary GEMM for Hopper (sm_90a).
//
// Two kernels over the same operands as repro's Pallas pair:
//   xs (E, T, K) and w (K, N), both float32 or both bfloat16, row-major;
//   out (T, N) float32; owner (N / block_n,) int32 maps each column block to
//   the tenant whose x rows it multiplies (the paper's vertical slice).
// A column block owned by tenant e is live for rows < ceil(valid_t[e] /
// block_t) * block_t and for reduction depth ceil(valid_k[e] / block_k) *
// block_k; a tenant with zero depth has no live rows (repro's
// _live_extents).  Everything outside that is zero in the output.
//
// The CTA tile is the kernel's own, not the partition block: 64 x 64 outputs
// with a 32-deep K slice staged in shared memory, 256 threads, each
// accumulating a 4 x 4 register micro-tile in float32.  A CTA never crosses
// a column-block edge (a block of block_n columns is cut into
// ceil(block_n / 64) CTA columns, masked at the block's last column), so one
// CTA always reads one tenant's x.  Rows and depth are masked at the live
// bounds, so any partition block size is valid.
//
// Arithmetic is IEEE float32 FFMA for both operand types (bfloat16 is
// widened on its way into shared memory): no TF32, no tensor cores.
// wgmma, TMA and a persistent schedule are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int BM = 64;        // output rows (T) per CTA
constexpr int BN = 64;        // output columns (N) per CTA
constexpr int BK = 32;        // reduction depth per shared-memory stage
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each

struct Smem {
  float a[BK][BM + 1];  // x slice, k-major; +1 keeps the transposing store
                        // free of bank conflicts
  float b[BK][BN];      // w slice
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Stage x[row0:+BM, k0:+BK] and w[k0:+BK, col0:+BN] (zero outside the live
// bounds) and accumulate their product into the thread's micro-tile.
// Thread (tx, ty) owns rows ty + 16 i and columns tx + 16 j.
template <typename T>
__device__ __forceinline__ void mac_stage(const T* __restrict__ x,
                                          const T* __restrict__ w, Smem& s,
                                          float (&acc)[4][4], int row0,
                                          int row_end, int col0, int col_end,
                                          int k0, int k_end, int K, int N) {
  const int tid = threadIdx.x;
  {
    // x: k fastest across the warp, so the global load is coalesced
    const int k = tid % BK;
    const int gk = k0 + k;
#pragma unroll
    for (int i = 0; i < BM * BK / THREADS; ++i) {
      const int r = tid / BK + i * (THREADS / BK);
      const int gr = row0 + r;
      float v = 0.f;
      if (gr < row_end && gk < k_end) v = to_f32(x[(size_t)gr * K + gk]);
      s.a[k][r] = v;
    }
  }
  {
    const int c = tid % BN;
    const int gc = col0 + c;
#pragma unroll
    for (int i = 0; i < BK * BN / THREADS; ++i) {
      const int k = tid / BN + i * (THREADS / BN);
      const int gk = k0 + k;
      float v = 0.f;
      if (gk < k_end && gc < col_end) v = to_f32(w[(size_t)gk * N + gc]);
      s.b[k][c] = v;
    }
  }
  __syncthreads();
  const int tx = tid % 16;
  const int ty = tid / 16;
#pragma unroll 8
  for (int k = 0; k < BK; ++k) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = s.a[k][ty + 16 * i];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = s.b[k][tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
  __syncthreads();
}

// Write the micro-tile: rows below row_end get the sum, rows from row_end to
// row_limit get zero (row_limit == row_end writes live rows only).
__device__ __forceinline__ void store_tile(float* __restrict__ out,
                                           const float (&acc)[4][4], int row0,
                                           int row_end, int row_limit,
                                           int col0, int col_end, int N) {
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= row_limit) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx + 16 * j;
      if (c < col_end) out[(size_t)r * N + c] = r < row_end ? acc[i][j] : 0.f;
    }
  }
}

// Dense kernel.  Replaces repro/kernels/partitioned_matmul.py
// _dense_kernel / _dense_call: every (n, t) output tile is scheduled, dead
// ones included, and each K step is gated by liveness as pl.when(live) gates
// the MXU there.  Bound on this card: the live work of the main path is small
// (under 10 GFLOP per call), so the compulsory bytes bound the call; inside a
// CTA the float32 FFMA loop and its shared-memory reads bound each K step.
// Design: the TPU carries the accumulator across sequential grid steps in
// VMEM; blocks on the card run in no order, so each CTA runs its own K loop
// with the accumulator in registers.  There is no scalar prefetch, so each
// CTA reads owner / valid_t / valid_k itself.  Dead steps skip their loads
// and MACs; the tile is written whole, zeros included.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    dense_kernel(const T* __restrict__ xs, const T* __restrict__ w,
                 float* __restrict__ out, const int* __restrict__ owner,
                 const int* __restrict__ valid_t,
                 const int* __restrict__ valid_k, int Tn, int K, int N,
                 int block_t, int block_k, int block_n, int sub) {
  __shared__ Smem s;
  const int nb = blockIdx.x / sub;
  const int col0 = nb * block_n + (blockIdx.x % sub) * BN;
  const int col_end = min(col0 + BN, (nb + 1) * block_n);
  const int row0 = blockIdx.y * BM;
  const int e = owner[nb];
  const int vt = min(max(valid_t[e], 0), Tn);
  const int vk = min(max(valid_k[e], 0), K);
  const int kl = (vk + block_k - 1) / block_k;
  const int row_end = kl > 0 ? (vt + block_t - 1) / block_t * block_t : 0;
  const int k_end = kl * block_k;
  const T* x = xs + (size_t)e * Tn * K;

  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += BK) {
    // Mul_En rung (b): a dead step is scheduled but fires no MAC
    if (row0 < row_end && k0 < k_end)
      mac_stage(x, w, s, acc, row0, row_end, col0, col_end, k0, k_end, K, N);
  }
  store_tile(out, acc, row0, row_end, Tn, col0, col_end, N);
}

// Compact kernel.  Replaces repro/kernels/partitioned_matmul.py
// _compact_kernel / _compact_call: only live output tiles are launched, one
// CTA per entry of a run list the host builds from the live extents, and
// each CTA's K loop covers exactly its live depth.  Bound on this card: as
// for the dense kernel; the design removes the dead CTAs and dead K steps
// instead of gating them.  Design: the TPU walks live (n, t, k) triples on
// a sequential grid with the accumulator in VMEM; here the K run lives
// inside one CTA.  The TPU zeroes unvisited tiles with a host mask; here the
// wrapper zeroes the output before the launch and a CTA writes live rows
// only.  Run entry i is four int32: CTA column index, CTA row index, live
// depth k_end and live row bound row_end.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    compact_kernel(const T* __restrict__ xs, const T* __restrict__ w,
                   float* __restrict__ out, const int* __restrict__ runs,
                   const int* __restrict__ owner, int Tn, int K, int N,
                   int block_n, int sub) {
  __shared__ Smem s;
  const int* run = runs + 4 * (size_t)blockIdx.x;
  const int ct = run[0];
  const int row0 = run[1] * BM;
  const int k_end = run[2];
  const int row_end = run[3];
  const int nb = ct / sub;
  const int col0 = nb * block_n + (ct % sub) * BN;
  const int col_end = min(col0 + BN, (nb + 1) * block_n);
  const T* x = xs + (size_t)owner[nb] * Tn * K;

  float acc[4][4] = {};
  for (int k0 = 0; k0 < k_end; k0 += BK)
    mac_stage(x, w, s, acc, row0, row_end, col0, col_end, k0, k_end, K, N);
  store_tile(out, acc, row0, row_end, row_end, col0, col_end, N);
}

}  // namespace

extern "C" {

// CTA geometry and static shared memory, read by the Python wrapper so the
// run list and the shared-memory check follow this file.
int pm_geometry(int* bm, int* bn, int* bk, int* smem_bytes) {
  *bm = BM;
  *bn = BN;
  *bk = BK;
  *smem_bytes = (int)sizeof(Smem);
  return 0;
}

// Each launcher returns cudaGetLastError() after its launch (0 = success).
int pm_dense(int bf16, const void* xs, const void* w, void* out,
             const void* owner, const void* valid_t, const void* valid_k,
             int T, int K, int N, int block_t, int block_k, int block_n,
             void* stream) {
  const int sub = (block_n + BN - 1) / BN;
  const dim3 grid((N / block_n) * sub, (T + BM - 1) / BM);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* own = static_cast<const int*>(owner);
  const int* vt = static_cast<const int*>(valid_t);
  const int* vk = static_cast<const int*>(valid_k);
  float* o = static_cast<float*>(out);
  if (bf16) {
    dense_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(xs),
        static_cast<const __nv_bfloat16*>(w), o, own, vt, vk, T, K, N,
        block_t, block_k, block_n, sub);
  } else {
    dense_kernel<float><<<grid, THREADS, 0, st>>>(
        static_cast<const float*>(xs), static_cast<const float*>(w), o, own,
        vt, vk, T, K, N, block_t, block_k, block_n, sub);
  }
  return static_cast<int>(cudaGetLastError());
}

int pm_compact(int bf16, const void* xs, const void* w, void* out,
               const void* runs, int n_runs, const void* owner, int T, int K,
               int N, int block_n, void* stream) {
  const int sub = (block_n + BN - 1) / BN;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* r = static_cast<const int*>(runs);
  const int* own = static_cast<const int*>(owner);
  float* o = static_cast<float*>(out);
  if (bf16) {
    compact_kernel<__nv_bfloat16><<<n_runs, THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(xs),
        static_cast<const __nv_bfloat16*>(w), o, r, own, T, K, N, block_n,
        sub);
  } else {
    compact_kernel<float><<<n_runs, THREADS, 0, st>>>(
        static_cast<const float*>(xs), static_cast<const float*>(w), o, r,
        own, T, K, N, block_n, sub);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
