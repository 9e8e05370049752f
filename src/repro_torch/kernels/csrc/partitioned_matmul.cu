// Multi-tenant partitioned weight-stationary GEMM for Hopper (sm_90a).
//
// Two kernels, dense and compact, over one launch table (struct Params,
// passed by value as a __grid_constant__ parameter):
//   * the base address of every buffer the launch touches;
//   * per tenant: its x (a buffer, an element offset, row stride ldx), its
//     live rows and live depth, and the rows of the caller's output;
//   * per column segment (a run of columns owned by one tenant: a partition
//     block, or several adjacent blocks of one owner, or one tenant's whole
//     w): its tenant, its w (row-major from the segment's first column,
//     row stride ldw), its live columns, its f32 output (row stride ldo) and
//     its first CTA: a segment's CTAs are one contiguous range of the launch.
// Everything but the buffer addresses depends only on the shapes, so the
// host packs a table once per geometry and a call writes the addresses.
// Column c of segment s is x[tenant(s)] @ w_s[:, c] for rows below the
// tenant's live rows, zero for the rest of the caller's output rows; the
// reduction runs over the tenant's live depth only.  Operands are read in
// place: nothing is padded, stacked or concatenated, and every edge (rows,
// depth, columns) is masked here, at any alignment.
//
// Tiles.  A CTA owns a 64 x 64 output tile of one segment and runs its
// whole K loop with the accumulator in registers.  K slices go through a
// 3-stage shared-memory ring: slice k+2 is in flight while slice k is
// multiplied.  Where a tenant's x (or a segment's w) has a 16-byte aligned
// tile origin and row pitch, a slice is copied with 16-byte cp.async
// (zero-filled past the live edge); at 4-byte alignment (every float32
// tensor, bfloat16 rows of even length) with 4-byte cp.async; bfloat16 rows
// on 2-byte boundaries are loaded element by element into registers before
// the multiply and stored to shared memory after it, so the loads still
// overlap the arithmetic.  The choice is made per CTA, not per element.
//   * bfloat16: 128 threads, 4 warps of 32 x 32, bf16 mma.sync m16n8k16 with
//     f32 accumulation, fragments from ldmatrix (.trans for w, whose rows
//     are N-contiguous); shared rows padded by 16 bytes so ldmatrix has no
//     bank conflicts.  Products of bf16 values are exact in f32.
//   * float32: IEEE FFMA (no TF32), an 8 x 8 register micro-tile a thread,
//     x kept k-contiguous so the inner loop reads float4s.  128 threads in
//     two groups of 64 that split every K slice between them and add their
//     partial tiles through shared memory at the end: a deep tile gets four
//     warps, not two.
//
// Writes.  Every output byte is written at most once, and only bytes of the
// caller's output: a live tile writes its sums (zeros in its rows past the
// live rows); the zeros of dead rows are written with 16-byte stores where
// the output allows them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <cstring>
#include <type_traits>

namespace {

constexpr int BM = 64;          // output rows per CTA tile
constexpr int BN = 64;          // output columns per CTA tile
constexpr int ZERO_ROWS = 256;  // rows of one compact zero-fill CTA
constexpr int STAGES = 3;       // shared-memory ring depth
constexpr int MAX_TENANTS = 64;
constexpr int MAX_SEGMENTS = 256;
constexpr int MAX_BUFFERS = 3 * MAX_TENANTS;

struct Tenant {
  long long x_off;  // x[r][k] is element x_off + r * ldx + k of bufs[x]
  int x;
  int ldx;
  int rows;      // live rows (0 when the depth is 0)
  int depth;     // live reduction depth
  int out_rows;  // rows of the caller's output
  int reserved;
};

struct Segment {
  long long w_off;    // w[k][c] is element w_off + k * ldw + c of bufs[w]
  long long out_off;  // out[r][c] is float out_off + r * ldo + c of bufs[out]
  int w;
  int out;
  int ldw;
  int ldo;
  int cols;    // live columns
  int tenant;  // index into Params::tenants
  int first;   // first CTA of the segment's range
  int reserved;
};

struct Params {
  int n_segments;
  int grid_rows;  // dense: row tiles scheduled per column tile
  void* bufs[MAX_BUFFERS];
  Tenant tenants[MAX_TENANTS];
  Segment segments[MAX_SEGMENTS];
};

template <typename T>
struct Cfg;

template <>
struct Cfg<float> {
  static constexpr int THREADS = 128;
  static constexpr int MIN_BLOCKS = 3;  // at most 170 registers a thread
  static constexpr int BK = 16;
  static constexpr int AP = BK + 4;  // shared row pitch of the x slice
  static constexpr int BP = BN + 4;  // shared row pitch of the w slice
};

template <>
struct Cfg<__nv_bfloat16> {
  static constexpr int THREADS = 128;
  static constexpr int MIN_BLOCKS = 4;  // at most 128 registers a thread
  static constexpr int BK = 32;
  static constexpr int AP = BK + 8;
  static constexpr int BP = BN + 8;
};

template <typename T>
__host__ __device__ constexpr int stage_elems() {
  return BM * Cfg<T>::AP + Cfg<T>::BK * Cfg<T>::BP;
}

template <typename T>
__host__ __device__ constexpr int smem_bytes() {
  return STAGES * stage_elems<T>() * (int)sizeof(T);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ bool aligned16(const void* p, int ld, int item) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0 && (ld * item) % 16 == 0;
}

// How a K slice of an operand reaches shared memory, from its tile origin
// and row pitch.
enum Path { CP16, CP4, REGS };

template <typename T>
__device__ __forceinline__ Path copy_path(const T* p, int ld) {
  if (aligned16(p, ld, sizeof(T))) return CP16;
  const bool a4 = (reinterpret_cast<uintptr_t>(p) & 3) == 0;
  if (a4 && (ld * (int)sizeof(T)) % 4 == 0) return CP4;
  return REGS;  // bfloat16 rows on 2-byte boundaries
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
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

// Copies an R x C tile of a row-major global matrix into shared memory
// (row pitch P), 16-byte chunks, zero past (r_lim, c_lim).  `async` uses
// 16-byte cp.async and needs 16-byte aligned rows, `async4` 4-byte cp.async
// and 4-byte aligned rows; `fetch` + `store` go through registers at any
// alignment.
template <typename T, int R, int C, int P, int THREADS>
struct TileCopy {
  using Bits = typename std::conditional<sizeof(T) == 4, unsigned int,
                                         unsigned short>::type;
  static constexpr int V = 16 / sizeof(T);  // elements per chunk
  static constexpr int CPR = C / V;         // chunks per row
  static constexpr int N = R * CPR / THREADS;
  static_assert(C % V == 0 && (R * CPR) % THREADS == 0, "tile split");

  union Chunk {
    uint4 u;
    Bits b[V];
  };
  Chunk reg[N];

  __device__ __forceinline__ void async(T* s, const T* g, int ld, int r_lim,
                                        int c_lim) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int i = threadIdx.x + j * THREADS;
      const int r = i / CPR, c = (i % CPR) * V;
      const int n = r < r_lim ? max(0, min(c_lim - c, V)) : 0;
      const T* src = n > 0 ? g + (size_t)r * ld + c : g;
      cp_async16(s + r * P + c, src, n * (int)sizeof(T));
    }
  }

  __device__ __forceinline__ void async4(T* s, const T* g, int ld, int r_lim,
                                         int c_lim) {
    constexpr int E = 4 / sizeof(T);  // elements per 4-byte copy
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int i = threadIdx.x + j * THREADS;
      const int r = i / CPR, c = (i % CPR) * V;
#pragma unroll
      for (int q = 0; q < V; q += E) {
        const int n = r < r_lim ? max(0, min(c_lim - c - q, E)) : 0;
        const T* src = n > 0 ? g + (size_t)r * ld + c + q : g;
        cp_async4(s + r * P + c + q, src, n * (int)sizeof(T));
      }
    }
  }

  __device__ __forceinline__ void fetch(const T* g, int ld, int r_lim,
                                        int c_lim) {
    const Bits* gb = reinterpret_cast<const Bits*>(g);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int i = threadIdx.x + j * THREADS;
      const int r = i / CPR, c = (i % CPR) * V;
      const bool row_ok = r < r_lim;
#pragma unroll
      for (int q = 0; q < V; ++q)
        reg[j].b[q] =
            row_ok && c + q < c_lim ? __ldg(gb + (size_t)r * ld + c + q) : 0;
    }
  }

  __device__ __forceinline__ void store(T* s) const {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int i = threadIdx.x + j * THREADS;
      const int r = i / CPR, c = (i % CPR) * V;
      *reinterpret_cast<uint4*>(s + r * P + c) = reg[j].u;
    }
  }
};

// One output value: the sum in live rows, zero in the caller's other rows.
__device__ __forceinline__ void put(float* o, int ldo, int r, int c, float v,
                                    int rows, int r_end, int c_end) {
  if (r < r_end && c < c_end) o[(size_t)r * ldo + c] = r < rows ? v : 0.f;
}

// ---------------------------------------------------------------------------
// float32: FFMA on an 8 x 8 micro-tile.  Thread (g, tx, ty) = (tid / 64,
// tid % 8, tid % 64 / 8) owns rows ty + 8 i and columns 4 tx + 32 j + q of
// group g's partial tile; group g sums k = 8 h + 4 g + q of every slice.
// ---------------------------------------------------------------------------

struct AccF32 {
  static constexpr int RP = BN + 4;  // row pitch of the partial-tile swap
  float v[8][8];

  __device__ __forceinline__ void mac(const float* As, const float* Bs) {
    constexpr int AP = Cfg<float>::AP, BP = Cfg<float>::BP;
    const int g = threadIdx.x / 64, t = threadIdx.x % 64;
    const int tx = t % 8, ty = t / 8;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int kk = 8 * h + 4 * g;
      float4 a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a[i] = *reinterpret_cast<const float4*>(As + (ty + 8 * i) * AP + kk);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float* brow = Bs + (kk + q) * BP + 4 * tx;
        const float4 b0 = *reinterpret_cast<const float4*>(brow);
        const float4 b1 = *reinterpret_cast<const float4*>(brow + 32);
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float av = (&a[i].x)[q];
#pragma unroll
          for (int j = 0; j < 8; ++j) v[i][j] = fmaf(av, b[j], v[i][j]);
        }
      }
    }
  }

  // group 1 adds its partial tile into group 0's through shared memory (the
  // pipeline's, free once every thread is past its last slice)
  __device__ __forceinline__ void finish(void* smem) {
    static_assert(BM * RP * 4 <= smem_bytes<float>(), "swap fits");
    float* red = static_cast<float*>(smem);
    const int g = threadIdx.x / 64, t = threadIdx.x % 64;
    const int tx = t % 8, ty = t / 8;
    __syncthreads();
    if (g == 1) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          *reinterpret_cast<float4*>(red + (ty + 8 * i) * RP + 4 * tx + 32 * j) =
              make_float4(v[i][4 * j], v[i][4 * j + 1], v[i][4 * j + 2],
                          v[i][4 * j + 3]);
    }
    __syncthreads();
    if (g == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float4 r = *reinterpret_cast<const float4*>(
              red + (ty + 8 * i) * RP + 4 * tx + 32 * j);
          v[i][4 * j] += r.x;
          v[i][4 * j + 1] += r.y;
          v[i][4 * j + 2] += r.z;
          v[i][4 * j + 3] += r.w;
        }
    }
  }

  // o points at the tile's origin; r_end / c_end bound the caller's output.
  // Group 0 holds the sums.
  __device__ __forceinline__ void write(float* o, int ldo, int rows,
                                        int r_end, int c_end) const {
    if (threadIdx.x >= 64) return;
    const int tx = threadIdx.x % 8, ty = threadIdx.x / 8;
    const bool vec = aligned16(o, ldo, 4);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = ty + 8 * i;
      if (r >= r_end) continue;
      const bool live = r < rows;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = 4 * tx + 32 * j;
        const float* s = &v[i][4 * j];
        if (vec && c + 4 <= c_end) {
          *reinterpret_cast<float4*>(o + (size_t)r * ldo + c) =
              live ? make_float4(s[0], s[1], s[2], s[3])
                   : make_float4(0.f, 0.f, 0.f, 0.f);
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            put(o, ldo, r, c + q, s[q], rows, r_end, c_end);
        }
      }
    }
  }
};

// ---------------------------------------------------------------------------
// bfloat16: mma.sync m16n8k16; warp (wm, wn) = (warp / 2, warp % 2) owns
// rows 32 wm + 16 mi + ... and columns 32 wn + 8 ni + ...
// ---------------------------------------------------------------------------

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

struct AccBf16 {
  float v[2][4][4];

  __device__ __forceinline__ void finish(void*) {}

  __device__ __forceinline__ void mac(const __nv_bfloat16* As,
                                      const __nv_bfloat16* Bs) {
    constexpr int AP = Cfg<__nv_bfloat16>::AP, BP = Cfg<__nv_bfloat16>::BP;
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    const int wm = warp / 2, wn = warp % 2;
    // ldmatrix row addresses: lanes 0-15 give rows 0-15 of the first 8
    // columns, lanes 16-31 the same rows of the next 8
    const int lr = lane % 16, lc = (lane / 16) * 8;
#pragma unroll
    for (int kk = 0; kk < Cfg<__nv_bfloat16>::BK; kk += 16) {
      unsigned a[2][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldsm_x4(a[mi], As + (32 * wm + 16 * mi + lr) * AP + kk + lc);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        unsigned r[4];
        ldsm_x4_trans(r, Bs + (kk + lr) * BP + 32 * wn + 16 * np + lc);
        b[2 * np][0] = r[0];
        b[2 * np][1] = r[1];
        b[2 * np + 1][0] = r[2];
        b[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_bf16(v[mi][ni], a[mi], b[ni][0], b[ni][1]);
    }
  }

  __device__ __forceinline__ void write(float* o, int ldo, int rows,
                                        int r_end, int c_end) const {
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    const int wm = warp / 2, wn = warp % 2;
    const bool vec = (reinterpret_cast<uintptr_t>(o) & 7) == 0 && ldo % 2 == 0;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 32 * wm + 16 * mi + lane / 4 + 8 * h;
        if (r >= r_end) continue;
        const bool live = r < rows;
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int c = 32 * wn + 8 * ni + 2 * (lane % 4);
          const float s0 = v[mi][ni][2 * h], s1 = v[mi][ni][2 * h + 1];
          if (vec && c + 2 <= c_end) {
            *reinterpret_cast<float2*>(o + (size_t)r * ldo + c) =
                live ? make_float2(s0, s1) : make_float2(0.f, 0.f);
          } else {
            put(o, ldo, r, c, s0, rows, r_end, c_end);
            put(o, ldo, r, c + 1, s1, rows, r_end, c_end);
          }
        }
      }
  }
};

template <typename T>
struct Acc;
template <>
struct Acc<float> {
  using type = AccF32;
};
template <>
struct Acc<__nv_bfloat16> {
  using type = AccBf16;
};

// Zero rows [0, r_end) x columns [0, c_end) of a tile at o.
template <int THREADS>
__device__ __forceinline__ void zero_fill(float* o, int ldo, int r_end,
                                          int c_end) {
  constexpr int Q = BN / 4;  // float4s per tile row
  const bool vec = aligned16(o, ldo, 4);
  for (int i = threadIdx.x; i < r_end * Q; i += THREADS) {
    const int r = i / Q, c = (i % Q) * 4;
    float* p = o + (size_t)r * ldo + c;
    if (vec && c + 4 <= c_end) {
      *reinterpret_cast<float4*>(p) = make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      for (int q = 0; q < 4 && c + q < c_end; ++q) p[q] = 0.f;
    }
  }
}

// One live tile: rows [0, rows) of x (at its tile origin) times columns
// [0, c_end) of w (at its tile origin) over depth `depth`, written at o.
template <typename T>
__device__ __forceinline__ void live_tile(const T* x, int ldx, int rows,
                                          int depth, const T* w, int ldw,
                                          float* o, int ldo, int r_end,
                                          int c_end) {
  using C = Cfg<T>;
  constexpr int BK = C::BK;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  auto sa = [&](int s) { return smem + s * stage_elems<T>(); };
  auto sb = [&](int s) { return smem + s * stage_elems<T>() + BM * C::AP; };

  const int ktiles = (depth + BK - 1) / BK;
  const Path pa = copy_path(x, ldx), pb = copy_path(w, ldw);
  TileCopy<T, BM, BK, C::AP, C::THREADS> ca;
  TileCopy<T, BK, BN, C::BP, C::THREADS> cb;

  // start the copy of K slice kt into stage s
  auto start = [&](int kt, int s) {
    const int k0 = kt * BK;
    const T* ga = x + k0;
    const T* gb = w + (size_t)k0 * ldw;
    if (pa == CP16)
      ca.async(sa(s), ga, ldx, rows, depth - k0);
    else if (pa == CP4)
      ca.async4(sa(s), ga, ldx, rows, depth - k0);
    else if constexpr (sizeof(T) == 2)
      ca.fetch(ga, ldx, rows, depth - k0);
    if (pb == CP16)
      cb.async(sb(s), gb, ldw, depth - k0, c_end);
    else if (pb == CP4)
      cb.async4(sb(s), gb, ldw, depth - k0, c_end);
    else if constexpr (sizeof(T) == 2)
      cb.fetch(gb, ldw, depth - k0, c_end);
  };
  // land the register-staged part of slice kt in stage s
  auto land = [&](int s) {
    if constexpr (sizeof(T) == 2) {
      if (pa == REGS) ca.store(sa(s));
      if (pb == REGS) cb.store(sb(s));
    }
  };

  typename Acc<T>::type acc = {};
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ktiles) {
      start(s, s);
      land(s);
    }
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // slice kt is in; every thread is done with kt - 1
    const int nk = kt + STAGES - 1;
    const bool more = nk < ktiles;
    if (more) start(nk, nk % STAGES);
    cp_async_commit();
    acc.mac(sa(kt % STAGES), sb(kt % STAGES));
    if (more) land(nk % STAGES);
  }
  cp_async_wait<0>();
  acc.finish(smem_raw);
  acc.write(o, ldo, rows, r_end, c_end);
}

// The segment whose range holds CTA b: the last one starting at or before
// b (ranges are in segment order; an empty range starts where the next
// one does, so it is never the last one at or before a CTA it lacks).
__device__ __forceinline__ int find_segment(const Params& p, int b) {
  int lo = 0, hi = p.n_segments - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (p.segments[mid].first <= b)
      lo = mid;
    else
      hi = mid - 1;
  }
  return lo;
}

// A segment's range: its BM x BN tiles, row tile fastest (dense: grid_rows
// of them per column tile, compact: the live ones), then, compact only, its
// ZERO_ROWS x BN zero-fill tiles for the caller's rows below the live ones.
template <typename T, bool DENSE>
__device__ __forceinline__ void run_cta(const Params& p) {
  const Segment& sg = p.segments[find_segment(p, blockIdx.x)];
  const Tenant& tn = p.tenants[sg.tenant];
  const int live_tiles = (tn.rows + BM - 1) / BM;
  const int row_tiles = DENSE ? p.grid_rows : live_tiles;
  const int col_tiles = (sg.cols + BN - 1) / BN;
  int local = blockIdx.x - sg.first;
  int row0, col0, tile_rows = BM;
  if (local < row_tiles * col_tiles) {
    row0 = local % row_tiles * BM;
    col0 = local / row_tiles * BN;
  } else {
    local -= row_tiles * col_tiles;
    const int dead = tn.out_rows - live_tiles * BM;
    const int fill_tiles = (dead + ZERO_ROWS - 1) / ZERO_ROWS;
    row0 = live_tiles * BM + local % fill_tiles * ZERO_ROWS;
    col0 = local / fill_tiles * BN;
    tile_rows = ZERO_ROWS;
  }
  if (row0 >= tn.out_rows) return;  // dense: not a tile of the output
  const int r_end = min(tile_rows, tn.out_rows - row0);
  const int c_end = min(BN, sg.cols - col0);
  float* o = static_cast<float*>(p.bufs[sg.out]) + sg.out_off +
             (size_t)row0 * sg.ldo + col0;
  if (row0 >= tn.rows) {  // dead: zeros, and no K loop
    zero_fill<Cfg<T>::THREADS>(o, sg.ldo, r_end, c_end);
    return;
  }
  const T* x = static_cast<const T*>(p.bufs[tn.x]) + tn.x_off +
               (size_t)row0 * tn.ldx;
  const T* w = static_cast<const T*>(p.bufs[sg.w]) + sg.w_off + col0;
  live_tile<T>(x, tn.ldx, tn.rows - row0, tn.depth, w, sg.ldw, o, sg.ldo,
               r_end, c_end);
}

// Dense kernel.  Replaces repro/kernels/partitioned_matmul.py _dense_kernel
// / _dense_call: every tile of the padded (rows, columns) grid is scheduled,
// dead ones included, as the TPU grid walks every block and pl.when(live)
// gates the MXU.  A dead CTA skips the K loop and writes zeros where the
// caller's output has the tile, else exits.  Bound on this card: the bytes
// (operands read once plus the output written once) for bf16; for f32 the
// FFMA work of the live tiles.  The TPU carries the accumulator across
// sequential grid steps in VMEM; CTAs run in no order, so each CTA runs its
// own K loop with the accumulator in registers.
template <typename T>
__global__ void __launch_bounds__(Cfg<T>::THREADS, Cfg<T>::MIN_BLOCKS)
    dense_kernel(__grid_constant__ const Params p) {
  run_cta<T, true>(p);
}

// Compact kernel.  Replaces repro/kernels/partitioned_matmul.py
// _compact_kernel / _compact_call: only live tiles are launched, one CTA
// each, found from the per-segment prefix of CTA counts in the table (the
// TPU's scalar-prefetched index tables); each K loop covers exactly the
// live depth.  Where the caller's output has dead rows (the stacked API's
// (T, N) output), zero-fill CTAs of ZERO_ROWS x BN in the same launch write
// them, each segment's after its live tiles, so the stores overlap the
// arithmetic; every output byte is written once and nothing zeroes the
// output first.  Bound: as for the dense kernel.
template <typename T>
__global__ void __launch_bounds__(Cfg<T>::THREADS, Cfg<T>::MIN_BLOCKS)
    compact_kernel(__grid_constant__ const Params p) {
  run_cta<T, false>(p);
}

template <typename T>
int launch(bool dense, const Params& p, int grid, cudaStream_t st) {
  if (dense)
    dense_kernel<T><<<grid, Cfg<T>::THREADS, smem_bytes<T>(), st>>>(p);
  else
    compact_kernel<T><<<grid, Cfg<T>::THREADS, smem_bytes<T>(), st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The table's layout and the tile geometry, read by the Python wrapper so
// the table it packs follows this file.
int pm_layout(int* v) {
  v[0] = (int)sizeof(Params);
  v[1] = (int)offsetof(Params, bufs);
  v[2] = (int)offsetof(Params, tenants);
  v[3] = (int)sizeof(Tenant);
  v[4] = (int)offsetof(Params, segments);
  v[5] = (int)sizeof(Segment);
  v[6] = MAX_BUFFERS;
  v[7] = MAX_TENANTS;
  v[8] = MAX_SEGMENTS;
  v[9] = BM;
  v[10] = BN;
  v[11] = ZERO_ROWS;
  v[12] = smem_bytes<float>();
  v[13] = smem_bytes<__nv_bfloat16>();
  v[14] = Cfg<float>::BK;
  v[15] = Cfg<__nv_bfloat16>::BK;
  return 0;
}

// params: sizeof(Params) bytes laid out as struct Params.  Returns
// cudaGetLastError() after the launch (0 = success).
int pm_launch(int dense, int bf16, const void* params, int grid,
              void* stream) {
  Params p;
  std::memcpy(&p, params, sizeof(Params));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(dense != 0, p, grid, st)
              : launch<float>(dense != 0, p, grid, st);
}

}  // extern "C"
