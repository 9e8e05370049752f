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
//     its first tile: a segment's tiles are one contiguous range of the
//     launch.
// Everything but the buffer addresses depends only on the shapes, so the
// host packs a table once per geometry and a call writes the addresses.
// Column c of segment s is x[tenant(s)] @ w_s[:, c] for rows below the
// tenant's live rows, zero for the rest of the caller's output rows; the
// reduction runs over the tenant's live depth only.  Operands are read in
// place: nothing is padded, stacked or concatenated, and every edge (rows,
// depth, columns) is masked here, at any alignment.
//
// Tiles.  A segment is cut into CTA tiles, row tile fastest.
//   * float32: a CTA owns a 64 x 64 output tile and runs its whole K loop
//     with the accumulator in registers.  K slices go through a 3-stage
//     shared-memory ring: slice k+2 is in flight while slice k is
//     multiplied.  Where a tenant's x (or a segment's w) has a 16-byte
//     aligned tile origin and row pitch, a slice is copied with 16-byte
//     cp.async (zero-filled past the live edge), else with 4-byte cp.async.
//     IEEE FFMA (no TF32), an 8 x 8 register micro-tile a thread, x kept
//     k-contiguous so the inner loop reads float4s.  128 threads in two
//     groups of 64 that split every K slice between them and add their
//     partial tiles through shared memory at the end: a deep tile gets four
//     warps, not two.
//   * bfloat16: a segment's tiles are 128 x 128, with 64 rows where its
//     tenant has at most 64 live rows and 64 columns where it has at most 64
//     columns, so a batch-1 tenant or a narrow layer gets a tile that fits
//     it; a launch whose tiles would then be too few to fill the card takes
//     64 x 64 tiles throughout.  The host decides and the table carries each
//     segment's tile (Segment::shape).  One persistent CTA an
//     SM walks the launch's tiles (b, b + grid, ...).  A producer warpgroup
//     fills a 6-stage ring of K slices of 64 in the 128-byte-swizzled
//     layout the wgmma descriptors name: x (T, K) as the K-major A operand,
//     w (K, N), N-contiguous, as the MN-major B operand.  Two consumer
//     warpgroups of 64 rows each issue wgmma.mma_async m64nNk16 (N = the
//     tile's columns) from the ring with the f32 sums in registers, and
//     write them from there.  Full and empty mbarriers run the ring; there
//     is no CTA-wide barrier after the set-up, so the producer runs ahead
//     into the next tile's slices while the consumers store a tile.
//     Feeds: where an operand's origin and row pitch are 16-byte aligned,
//     one producer thread loads its slices by TMA, from a tensor map the
//     launcher encodes (zero past the live extents); else, the staged feed:
//     the aligned 16-byte chunks that cover each row are copied by
//     cp.async, and once they are in, each consumer thread funnel-shifts a
//     row into place, masks it and fences it for wgmma's async proxy; the
//     two consumer warpgroups meet on a named barrier before they multiply,
//     so the producer only issues copies.
//     Products of bf16 values are exact in f32.
// Writes.  Every output byte is written at most once, and only bytes of the
// caller's output: a live tile writes its sums (zeros in its rows past the
// live rows); the zeros of dead rows are written with 16-byte stores where
// the output allows them.  One launch a call, whatever the alignments.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <cstring>
#include <type_traits>

namespace {

constexpr int BM = 64;          // output rows of a float32 tile
constexpr int BN = 64;          // output columns of a float32 tile
constexpr int ZERO_ROWS = 256;  // rows of one compact zero-fill tile
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
  int first;   // first tile of the segment's range
  int shape;   // bfloat16: its tiles' edges, bit 0 rows and bit 1 columns
               // (set: 128, clear: 64)
};

struct Params {
  int n_segments;
  int grid_rows;  // dense: the padded grid's rows, in 64-row tiles
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
  static constexpr int THREADS = 384;  // a producer and two consumer warpgroups
  static constexpr int MIN_BLOCKS = 1;  // at most 168 registers a thread
  static constexpr int BK = 64;         // one 128-byte swizzle row of x
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

template <typename T>
struct Acc;
template <>
struct Acc<float> {
  using type = AccF32;
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

// The segment whose range holds tile b: the last one starting at or before
// b (ranges are in segment order; an empty range starts where the next
// one does, so it is never the last one at or before a tile it lacks).
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

// ---------------------------------------------------------------------------
// bfloat16: wgmma tiles fed through an mbarrier ring, persistent CTAs.
// Thread 128 g + t: g = 0 the producer warpgroup, g = 1, 2 the consumer
// warpgroups, which own rows 64 (g - 1) ... of a tile.
// ---------------------------------------------------------------------------

constexpr int WIDE = 128;     // tile edges, as the table's Segment::shape
constexpr int NARROW = 64;    // gives them
constexpr int RING = 6;       // stages
constexpr int LAG = RING - 4;  // slices a producer thread keeps in flight
                               // before it reports the oldest landed: the
                               // other stages let the consumers settle and
                               // multiply while the producer issues
constexpr int X_BYTES = WIDE * 128;  // x slice: WIDE rows of 128 bytes
constexpr int W_BLOCK = 64 * 128;    // w slice, 64 columns: 64 rows of 128 B
constexpr int W_BYTES = (WIDE / 64) * W_BLOCK;
constexpr int SPILL = WIDE * 16;  // the ninth 16-byte chunk of each staged row
constexpr int RING_STAGE = X_BYTES + W_BYTES + 2 * SPILL;
constexpr int MAX_MAPS = 24;

// The tensor maps (TMA descriptors) of one bfloat16 launch, encoded by the
// launcher from the table: x_map[i] (w_map[i]) names tenant i's x (segment
// i's w), -1 where the operand has none (its origin or row pitch is off 16
// bytes, or the launch has used MAX_MAPS) and is staged instead.
struct Maps {
  signed char x_map[MAX_TENANTS];
  signed char w_map[MAX_SEGMENTS];
  CUtensorMap maps[MAX_MAPS];
};

__device__ __forceinline__ void bar_init(unsigned bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// The barrier's current phase also waits for `bytes` more of TMA writes.
__device__ __forceinline__ void bar_expect(unsigned bar, int bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// Waits for the phase of parity `parity` of the barrier to complete.
__device__ __forceinline__ void bar_wait(unsigned bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// The thread's shared-memory writes become visible to wgmma's async proxy.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A box of `map` at (c0, c1) into shared memory at dst; its bytes count
// toward the barrier's phase.
__device__ __forceinline__ void tma_load(unsigned dst, const CUtensorMap* map,
                                         unsigned bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void cp16(unsigned dst, const void* src,
                                     int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void ld_shared(unsigned src, unsigned* v) {
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v[0]), "=r"(v[1]), "=r"(v[2]), "=r"(v[3])
               : "r"(src)
               : "memory");
}

__device__ __forceinline__ void st_shared(unsigned dst, unsigned a, unsigned b,
                                          unsigned c, unsigned d) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst),
               "r"(a), "r"(b), "r"(c), "r"(d)
               : "memory");
}

// A 128-byte-swizzled operand in shared memory, as TMA writes it and wgmma
// reads it: 16-byte chunk c of row r of a 1024-byte aligned block of 8-row
// groups lies at 128 r + 16 (c ^ r % 8).  `lead` and `stride` are the byte
// offsets the descriptor names (between 64-column blocks of an MN-major
// operand, between 8-row groups).
__device__ __forceinline__ uint64_t smem_desc(unsigned addr, unsigned lead,
                                              unsigned stride) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         (uint64_t)((lead & 0x3FFFF) >> 4) << 16 |
         (uint64_t)((stride & 0x3FFFF) >> 4) << 32 | 1ull << 62;
}

// wgmma.mma_async m64nNk16, A (x) K-major and B (w) MN-major from shared
// memory, f32 sums in d; `acc` 0 starts the sums anew.
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t a, uint64_t b,
                                          int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(acc));
}

__device__ __forceinline__ void wgmma_n64(float (&d)[64], uint64_t a, uint64_t b,
                                          int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of the sums across a
// wgmma fence or wait.
__device__ __forceinline__ void hold(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// One operand of a K slice, as rows of 64 bf16 values.  x (W false): row q
// is row q of the tile at the slice's depth; `rows` = the tile's rows, `lim`
// its live rows, `cols` the depth left.  w (W true): row q is row q % 64 of
// the slice at columns 64 (q / 64) ... of the tile; `rows` = the tile's
// columns, `lim` the depth left, `cols` the live columns.  In the stage at
// s, row q is 128 swizzled bytes at at(q); its ninth chunk, while staged,
// at spill + 16 q.
template <bool W>
struct Operand {
  const __nv_bfloat16* g;  // the slice's origin
  int ld, rows, lim, cols;
  unsigned s, spill;

  __device__ __forceinline__ const __nv_bfloat16* row(int q) const {
    return W ? g + (size_t)(q % 64) * ld + 64 * (q / 64) : g + (size_t)q * ld;
  }
  __device__ __forceinline__ unsigned at(int q) const {
    return W ? s + (q / 64) * W_BLOCK + 128 * (q % 64) : s + 128 * q;
  }
  __device__ __forceinline__ int live(int q) const {  // live values of row q
    if (W) return q % 64 < lim ? max(0, min(cols - 64 * (q / 64), 64)) : 0;
    return q < lim ? min(cols, 64) : 0;
  }
};

// A live tile's operands as its K loop reads them: x from row0 of the tile
// (`rows` of its `bm` rows live), w from col0 (`cols` of its `bn` columns
// live), each staged (`sx`, `sw`) or loaded by TMA.
struct Feed {
  const __nv_bfloat16* x;
  const __nv_bfloat16* w;
  int ldx, ldw, bm, bn, rows, cols, depth;
  bool sx, sw;
};

// The x (w) operand of the tile's K slice at depth k0 in the stage at st.
__device__ __forceinline__ Operand<false> x_slice(const Feed& f, int k0,
                                                  unsigned st) {
  return {f.x + k0, f.ldx, f.bm, f.rows, f.depth - k0, st,
          st + X_BYTES + W_BYTES};
}

__device__ __forceinline__ Operand<true> w_slice(const Feed& f, int k0,
                                                 unsigned st) {
  return {f.w + (size_t)k0 * f.ldw, f.ldw, f.bn, f.depth - k0, f.cols,
          st + X_BYTES, st + X_BYTES + W_BYTES + SPILL};
}

// A segment as the bfloat16 walk sees it, worked out in shared memory at the
// start: its tenant's live and output rows, its columns, its tiles' rows
// and columns, and where its live tiles and its zero-writing tiles start in
// the walk.
struct Walk {
  int rows, out_rows, cols, bm, bn, live_first, dead_first;
};

// The ring (1024-byte aligned, for the swizzle), its full and empty
// barriers, and each segment's `Walk` (and one for the walk's extent).
__host__ __device__ constexpr int ring_bytes() {
  return 1024 + RING * RING_STAGE + 2 * RING * 8 +
         (MAX_SEGMENTS + 1) * (int)sizeof(Walk);
}

// The staged feed, for rows at any 2-byte boundary: the 9 aligned 16-byte
// chunks that cover each row, 9 threads a row, by cp.async (zero where a
// chunk holds no live value; a chunk that does lies in the page of that
// value).  Chunks 0-7 land where the row's swizzled chunks go, chunk 8 in
// the spill area; `realign` shifts them into place once they are in.
template <bool W>
__device__ __forceinline__ void stage(const Operand<W>& op, int t) {
#pragma unroll
  for (int j = 0; j < 9; ++j) {
    const int i = t + 128 * j, q = i / 9, c = i - 9 * q;
    if (q >= op.rows) break;
    const uintptr_t a = reinterpret_cast<uintptr_t>(op.row(q));
    const int mis = static_cast<int>(a & 15), n = op.live(q);
    const bool live = n > 0 && 16 * c < mis + 2 * n;
    const unsigned at = op.at(q);
    const unsigned dst =
        c < 8 ? at + ((c ^ ((at >> 7) & 7)) << 4) : op.spill + 16 * q;
    cp16(dst, live ? reinterpret_cast<const void*>(a - mis + 16 * c) : op.g,
         live ? 16 : 0);
  }
}

// A producer thread's chunks of a staged operand's K slices in one tile, as
// `stage` copies them, worked out once a tile: chunk j lands `dst[j]` bytes
// past the stage's x slice and is read from `src[j]` bytes past the slice's
// origin.  Both stay put from slice to slice, since the origin moves by 128
// bytes (x) or 64 rows (w) a slice; so does which chunks hold a live value
// (bit j of `live`), in every slice of the full depth of 64.
struct Chunks {
  int src[9];
  unsigned dst[9];
  unsigned live;
  int n;  // the thread's chunks: those of rows below the tile's
};

// `op`'s chunks, for an operand whose slices are of full depth and whose
// stage lies at 0; -1 in n where a row's offset overflows an int.
template <bool W>
__device__ __forceinline__ Chunks chunks(const Operand<W>& op, int t) {
  Chunks ch;
  ch.live = 0;
  ch.n = 0;
  const uintptr_t g = reinterpret_cast<uintptr_t>(op.g);
  const bool fits = (long long)op.ld * 128 < (1ll << 30);
#pragma unroll
  for (int j = 0; j < 9; ++j) {
    const int i = t + 128 * j, q = i / 9, c = i - 9 * q;
    ch.src[j] = 0;
    ch.dst[j] = 0;
    if (q < op.rows) {
      ch.n = j + 1;
      const uintptr_t a = reinterpret_cast<uintptr_t>(op.row(q));
      const int mis = static_cast<int>(a & 15), n = op.live(q);
      if (n > 0 && 16 * c < mis + 2 * n) ch.live |= 1u << j;
      ch.src[j] = static_cast<int>(a - mis + 16 * c - g);
      const unsigned at = op.at(q);
      ch.dst[j] = c < 8 ? at + ((c ^ ((at >> 7) & 7)) << 4) : op.spill + 16 * q;
    }
  }
  if (!fits) ch.n = -1;
  return ch;
}

// `stage` of a slice of full depth from the thread's chunks: the slice's
// origin g, its stage's x slice at sx.
__device__ __forceinline__ void stage(const Chunks& ch, const void* g,
                                      unsigned sx) {
  const char* o = static_cast<const char*>(g);
#pragma unroll
  for (int j = 0; j < 9; ++j) {
    if (j >= ch.n) break;
    const bool live = ch.live >> j & 1;
    cp16(sx + ch.dst[j], live ? o + ch.src[j] : o, live ? 16 : 0);
  }
}

// Row t of a staged operand, in place: its 9 chunks from shared memory,
// funnel-shifted down by the row's offset from a 16-byte boundary, zero
// from its live count on, back as 8 swizzled chunks.  Every chunk of the
// slice must be in (its full barrier).
template <bool W>
__device__ __forceinline__ void realign(const Operand<W>& op, int t) {
  if (t >= op.rows) return;
  const int n = op.live(t);
  const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(op.row(t)) & 15);
  if (n == 0 || (mis == 0 && n == 64)) return;  // zero-filled, or in place
  const unsigned at = op.at(t);
  const int r = (at >> 7) & 7;
  unsigned v[36];
#pragma unroll
  for (int c = 0; c < 8; ++c) ld_shared(at + ((c ^ r) << 4), v + 4 * c);
  ld_shared(op.spill + 16 * t, v + 32);
  // word j of the row is bytes [mis + 4 j, mis + 4 j + 4) of the chunks
  const bool w1 = mis & 4, w2 = mis & 8, half = mis & 2;
  unsigned u[35], q[33], o[32];
#pragma unroll
  for (int j = 0; j < 35; ++j) u[j] = w1 ? v[j + 1] : v[j];
#pragma unroll
  for (int j = 0; j < 33; ++j) q[j] = w2 ? u[j + 2] : u[j];
#pragma unroll
  for (int j = 0; j < 32; ++j)
    o[j] = half ? __funnelshift_r(q[j], q[j + 1], 16) : q[j];
  if (n < 64) {
#pragma unroll
    for (int j = 0; j < 32; ++j)
      o[j] = 2 * j + 1 < n ? o[j] : 2 * j < n ? o[j] & 0xffffu : 0u;
  }
#pragma unroll
  for (int c = 0; c < 8; ++c)
    st_shared(at + ((c ^ r) << 4), o[4 * c], o[4 * c + 1], o[4 * c + 2],
              o[4 * c + 3]);
}

// A bfloat16 tile of the walk: segment `seg`, origin (row0, col0), shape
// bm x bn, r_end x c_end of it in the caller's output; `live` where it
// runs a K loop, else it writes zeros.
struct WideTile {
  int seg, row0, col0, bm, bn, r_end, c_end;
  bool live;
};

// A segment's tiles: its live tiles (row tile fastest) and its dead ones,
// which write zeros: dense, the row tiles below the live rows down to the
// caller's rows; compact, ZERO_ROWS-row zero-fill tiles.  The dense grid's
// tiles past the caller's rows are scheduled (counted) but never walked.
__device__ __forceinline__ void segment_tiles(const Walk& sg, bool dense,
                                              int& live, int& dead) {
  const int bm = sg.bm, bn = sg.bn;
  const int col_tiles = (sg.cols + bn - 1) / bn;
  const int live_rows = (sg.rows + bm - 1) / bm;
  const int below = sg.out_rows - live_rows * bm;
  live = live_rows * col_tiles;
  dead = col_tiles * (dense ? (below + bm - 1) / bm
                            : max(0, (below + ZERO_ROWS - 1) / ZERO_ROWS));
}

// Tile b of the walk over n segments: every segment's live tiles, in
// segment order (the deepest tenant's first), then every segment's dead
// ones, so the CTAs share the live work whatever the grid mode.
__device__ __forceinline__ WideTile wide_tile(const Walk* walk, int n,
                                              int live_tiles, bool dense,
                                              int b) {
  const bool live = b < live_tiles;
  int lo = 0, hi = n - 1;
  while (lo < hi) {  // the last segment whose tiles of the kind start at b
    const int mid = (lo + hi + 1) / 2;
    if ((live ? walk[mid].live_first : walk[mid].dead_first) <= b)
      lo = mid;
    else
      hi = mid - 1;
  }
  const Walk sg = walk[lo];
  WideTile w;
  w.seg = lo;
  w.live = live;
  w.bm = sg.bm;
  w.bn = sg.bn;
  const int live_rows = (sg.rows + w.bm - 1) / w.bm;
  int tile_rows = w.bm;
  if (live) {
    const int local = b - sg.live_first;
    w.row0 = local % live_rows * w.bm;
    w.col0 = local / live_rows * w.bn;
  } else {
    const int local = b - sg.dead_first;
    const int below = sg.out_rows - live_rows * w.bm;
    if (!dense) tile_rows = ZERO_ROWS;
    const int dead_rows = (below + tile_rows - 1) / tile_rows;
    w.row0 = live_rows * w.bm + local % dead_rows * tile_rows;
    w.col0 = local / dead_rows * w.bn;
  }
  w.r_end = min(tile_rows, sg.out_rows - w.row0);
  w.c_end = min(w.bn, sg.cols - w.col0);
  return w;
}

// Tile w's feed, as the producer and the consumers both see it.
__device__ __forceinline__ Feed feed(const Params& p, const Maps& m,
                                     const WideTile& w) {
  const Segment& sg = p.segments[w.seg];
  const Tenant& tn = p.tenants[sg.tenant];
  Feed f;
  f.x = static_cast<const __nv_bfloat16*>(p.bufs[tn.x]) + tn.x_off +
        (size_t)w.row0 * tn.ldx;
  f.w = static_cast<const __nv_bfloat16*>(p.bufs[sg.w]) + sg.w_off + w.col0;
  f.ldx = tn.ldx;
  f.ldw = sg.ldw;
  f.bm = w.bm;
  f.bn = w.bn;
  f.rows = min(tn.rows - w.row0, w.bm);
  f.cols = w.c_end;
  f.depth = tn.depth;
  f.sx = m.x_map[sg.tenant] < 0;
  f.sw = m.w_map[w.seg] < 0;
  return f;
}

// The consumers' part of a K slice with staged operands: once its chunks
// are in, the 256 consumer threads shift its staged rows into place (x's in
// warpgroup 0 and w's in warpgroup 1, a row a thread), fence them for
// wgmma's async proxy and meet, so either warpgroup may multiply.
__device__ __forceinline__ void settle(const Feed& f, int k0, unsigned st,
                                      int g, int t) {
  if (g == 0) {
    if (f.sx) realign(x_slice(f, k0, st), t);
  } else if (f.sw) {
    realign(w_slice(f, k0, st), t);
  }
  fence_async_shared();
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// The K loop of tile f in consumer warpgroup g, over slices [item, item +
// its slices) of the ring: wait for a slice (and settle it, if staged),
// issue its four k16 steps, and release the slice before it once its
// products are done.  N = 0: the tile has no rows for g, which settles the
// slices and passes them on.
template <int N>
__device__ __forceinline__ void consume(float (&acc)[64], unsigned base,
                                        unsigned bars, int g, int t, int item,
                                        const Feed& f) {
  const int ktiles = (f.depth + 63) / 64;
  int prev = 0;
  for (int kt = 0; kt < ktiles; ++kt, ++item) {
    const int s = item % RING;
    const unsigned st = base + s * RING_STAGE;
    bar_wait(bars + 8 * s, (item / RING) & 1);
    if (f.sx || f.sw) settle(f, 64 * kt, st, g, t);
    if constexpr (N == 0) {
      if (t == 0) bar_arrive(bars + 8 * (RING + s));
    } else {
      const unsigned sx = st + g * 64 * 128, sw = st + X_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t a = smem_desc(sx + 32 * kk, 16, 1024);
        const uint64_t b = smem_desc(sw + 2048 * kk, W_BLOCK, 1024);
        if constexpr (N == WIDE)
          wgmma_n128(acc, a, b, kt | kk);
        else
          wgmma_n64(acc, a, b, kt | kk);
      }
      wgmma_commit();
      if (kt > 0) {
        wgmma_wait<1>();
        if (t == 0) bar_arrive(bars + 8 * (RING + prev));
      }
      prev = s;
    }
  }
  if constexpr (N != 0) {
    wgmma_wait<0>();
    hold(acc);
    if (t == 0) bar_arrive(bars + 8 * (RING + prev));
  }
}

// Consumer warpgroup g's 64 rows of a tile at o: the sums in live rows,
// zero in the caller's other rows.  m64nNk16's layout: warp w, lane l
// holds rows 16 w + l / 4 (+ 8) and columns 8 i + 2 (l % 4) (+ 1).
template <int N>
__device__ __forceinline__ void write_tile(const float (&acc)[64], float* o,
                                           int ldo, int rows, int r_end,
                                           int c_end, int g, int t) {
  const int lane = t % 32, warp = t / 32;
  const bool vec = (reinterpret_cast<uintptr_t>(o) & 7) == 0 && ldo % 2 == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 64 * g + 16 * warp + lane / 4 + 8 * h;
    if (r >= r_end) continue;
    const bool live = r < rows;
#pragma unroll
    for (int i = 0; i < N / 8; ++i) {
      const int c = 8 * i + 2 * (lane % 4);
      const float s0 = acc[4 * i + 2 * h], s1 = acc[4 * i + 2 * h + 1];
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

// Zeros in rows [0, r_end) x columns [0, c_end) of a tile at o, by the 256
// consumer threads (this one `tid`).
__device__ __forceinline__ void zero_tile(float* o, int ldo, int r_end,
                                          int c_end, int tid) {
  constexpr int Q = WIDE / 4;  // float4s per tile row
  const bool vec = aligned16(o, ldo, 4);
  for (int i = tid; i < r_end * Q; i += 256) {
    const int r = i / Q, c = (i % Q) * 4;
    float* p = o + (size_t)r * ldo + c;
    if (vec && c + 4 <= c_end) {
      *reinterpret_cast<float4*>(p) = make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      for (int q = 0; q < 4 && c + q < c_end; ++q) p[q] = 0.f;
    }
  }
}

template <bool DENSE>
__device__ __forceinline__ void run_ring(const Params& p, const Maps& m) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const unsigned base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const unsigned bars = base + RING * RING_STAGE;  // RING full, RING empty
  Walk* walk = reinterpret_cast<Walk*>(
      smem_raw + (bars + 16 * RING - smem_addr(smem_raw)));
  const int n_segments = p.n_segments;
  if (threadIdx.x == 0) {
    int live = 0, dead = 0;
    for (int i = 0; i < n_segments; ++i) {
      const Segment& sg = p.segments[i];
      const Tenant& tn = p.tenants[sg.tenant];
      Walk& wk = walk[i];
      const int bm = sg.shape & 1 ? WIDE : NARROW;
      const int bn = sg.shape & 2 ? WIDE : NARROW;
      wk = Walk{tn.rows, tn.out_rows, sg.cols, bm, bn, live, dead};
      int l, d;
      segment_tiles(wk, DENSE, l, d);
      live += l;
      dead += d;
    }
    for (int i = 0; i < n_segments; ++i) walk[i].dead_first += live;
    walk[n_segments].live_first = live;  // past the last segment: the
    walk[n_segments].dead_first = live + dead;  // walk's extent
    for (int s = 0; s < RING; ++s) {
      bar_init(bars + 8 * s, 128);        // every producer thread (+ TMA bytes)
      bar_init(bars + 8 * (RING + s), 2);  // one thread a consumer group
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int live_tiles = walk[n_segments].live_first;
  const int tiles = walk[n_segments].dead_first;
  const int g = threadIdx.x / 128, t = threadIdx.x % 128;
  int item = 0;  // K slices through the ring so far
  if (g == 0) {
    // A slice with staged operands (bit 1: x, bit 2: w) is reported full
    // once the slice LAG after it is issued and its chunks are in; the
    // consumers shift them into place.  A slice all by TMA is reported as
    // it is issued: its bytes complete the phase.  pend[0] is the newest.
    int pend[LAG + 1];
    auto report = [&](int pd) {
      if (pd & 3) {
        fence_async_shared();
        bar_arrive(bars + 8 * (pd >> 2));
      }
    };
    for (int b = blockIdx.x; b < live_tiles; b += gridDim.x) {
      const WideTile w = wide_tile(walk, n_segments, live_tiles, DENSE, b);
      const int xm = m.x_map[p.segments[w.seg].tenant], wm = m.w_map[w.seg];
      const Feed f = feed(p, m, w);
      // the staged operands' chunks in slices of full depth
      Chunks cx, cw;
      cx.n = cw.n = -1;
      if (f.sx && f.depth >= 64) cx = chunks(x_slice(f, 0, 0), t);
      if (f.sw && f.depth >= 64) cw = chunks(w_slice(f, 0, 0), t);
      for (int k0 = 0; k0 < f.depth; k0 += 64, ++item) {
        const int s = item % RING;
        bar_wait(bars + 8 * (RING + s), ((item / RING) & 1) ^ 1);
        const unsigned full = bars + 8 * s;
        const unsigned sx = base + s * RING_STAGE, sw = sx + X_BYTES;
        if (t == 0) {
          if (!f.sx || !f.sw)
            bar_expect(full, (f.sx ? 0 : X_BYTES) +
                                 (f.sw ? 0 : w.bn / 64 * W_BLOCK));
          if (!f.sx) tma_load(sx, &m.maps[xm], full, k0, w.row0);
          if (!f.sw)
            for (int c = 0; c < w.bn; c += 64)
              tma_load(sw + c / 64 * W_BLOCK, &m.maps[wm], full, w.col0 + c,
                       k0);
        }
        const bool whole = f.depth - k0 >= 64;
        if (f.sx) {
          const Operand<false> xo = x_slice(f, k0, sx);
          if (whole && cx.n >= 0)
            stage(cx, xo.g, sx);
          else
            stage(xo, t);
        }
        if (f.sw) {
          const Operand<true> wo = w_slice(f, k0, sx);
          if (whole && cw.n >= 0)
            stage(cw, wo.g, sx);
          else
            stage(wo, t);
        }
        cp_async_commit();
#pragma unroll
        for (int i = LAG; i > 0; --i) pend[i] = pend[i - 1];
        pend[0] = s << 2 | f.sx | f.sw << 1;
        if ((pend[0] & 3) == 0) bar_arrive(full);
        if (item >= LAG) {
          cp_async_wait<LAG>();
          report(pend[LAG]);
        }
      }
    }
    cp_async_wait<0>();
#pragma unroll
    for (int i = LAG - 1; i >= 0; --i)
      if (i < item) report(pend[i]);
    return;
  }
  const int c = g - 1;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int b = blockIdx.x; b < tiles; b += gridDim.x) {
    const WideTile w = wide_tile(walk, n_segments, live_tiles, DENSE, b);
    const Segment& sg = p.segments[w.seg];
    const Tenant& tn = p.tenants[sg.tenant];
    float* o = static_cast<float*>(p.bufs[sg.out]) + sg.out_off +
               (size_t)w.row0 * sg.ldo + w.col0;
    if (!w.live) {  // dead: zeros, and no K loop
      zero_tile(o, sg.ldo, w.r_end, w.c_end, threadIdx.x - 128);
      continue;
    }
    const int ktiles = (tn.depth + 63) / 64;
    const Feed f = feed(p, m, w);
    const int rows = tn.rows - w.row0;
    if (c == 1 && w.bm == NARROW) {  // no rows here
      consume<0>(acc, base, bars, c, t, item, f);
    } else if (w.bn == WIDE) {
      consume<WIDE>(acc, base, bars, c, t, item, f);
      write_tile<WIDE>(acc, o, sg.ldo, rows, w.r_end, w.c_end, c, t);
    } else {
      consume<NARROW>(acc, base, bars, c, t, item, f);
      write_tile<NARROW>(acc, o, sg.ldo, rows, w.r_end, w.c_end, c, t);
    }
    item += ktiles;
  }
}

// Dense kernel.  Replaces repro/kernels/partitioned_matmul.py _dense_kernel
// / _dense_call: every tile of the padded (rows, columns) grid is scheduled,
// dead ones included, as the TPU grid walks every block and pl.when(live)
// gates the MXU.  A dead tile skips the K loop and writes zeros where the
// caller's output has the tile, else is skipped.  Bound on this card: the
// bytes (operands read once plus the output written once) where a layer is
// shallow, the bf16 tensor-core rate where it is deep (GNMT's waves in the
// benchmark's light cell); for f32 the FFMA work of the live tiles.  The
// TPU carries the accumulator across sequential grid steps in VMEM; CTAs
// run in no order, so each tile's K loop keeps its accumulator in
// registers.  bfloat16 reaches the tensor cores' rate only through wgmma
// fed from shared memory: a CTA is a producer warpgroup that keeps a ring of
// K slices in flight (TMA where the rows allow it) and two consumer
// warpgroups that multiply out of it, and the CTAs are persistent, so a
// tile's stores overlap the next tile's loads.
template <typename T>
__global__ void __launch_bounds__(Cfg<T>::THREADS, Cfg<T>::MIN_BLOCKS)
    dense_kernel(__grid_constant__ const Params p) {
  run_cta<T, true>(p);
}

template <typename T>
__global__ void __launch_bounds__(Cfg<T>::THREADS, Cfg<T>::MIN_BLOCKS)
    dense_kernel(__grid_constant__ const Params p,
                 __grid_constant__ const Maps m) {
  run_ring<true>(p, m);
}

// Compact kernel.  Replaces repro/kernels/partitioned_matmul.py
// _compact_kernel / _compact_call: only live tiles are launched, found from
// the per-segment prefix of tile counts in the table (the TPU's
// scalar-prefetched index tables); each K loop covers exactly the live
// depth.  Where the caller's output has dead rows (the stacked API's (T, N)
// output), zero-fill tiles of ZERO_ROWS x the tile's columns in the same
// launch write them, each segment's after its live tiles, so the stores
// overlap the arithmetic; every output byte is written once and nothing
// zeroes the output first.  Bound and design: as for the dense kernel.
template <typename T>
__global__ void __launch_bounds__(Cfg<T>::THREADS, Cfg<T>::MIN_BLOCKS)
    compact_kernel(__grid_constant__ const Params p) {
  run_cta<T, false>(p);
}

template <typename T>
__global__ void __launch_bounds__(Cfg<T>::THREADS, Cfg<T>::MIN_BLOCKS)
    compact_kernel(__grid_constant__ const Params p,
                   __grid_constant__ const Maps m) {
  run_ring<false>(p, m);
}

template <typename T>
int launch(bool dense, const Params& p, int grid, cudaStream_t st) {
  if (dense)
    dense_kernel<T><<<grid, Cfg<T>::THREADS, smem_bytes<T>(), st>>>(p);
  else
    compact_kernel<T><<<grid, Cfg<T>::THREADS, smem_bytes<T>(), st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// The driver's tensor-map encoder, found once (nothing links libcuda).
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
    const bool ok = err == cudaSuccess && found == cudaDriverEntryPointSuccess;
    return ok ? reinterpret_cast<EncodeTiled>(f) : nullptr;
  }();
  return fn;
}

// Map `*m` over `cols` x `rows` bfloat16 values at g, row pitch ld values,
// in boxes of 64 x box_rows, 128-byte swizzled, zero outside: true where
// the operand allows TMA (a 16-byte aligned origin and row pitch).  A map
// is a function of these arguments alone, so maps are kept by them (the
// driver takes microseconds to encode one): a hit is the same map.
bool encode(CUtensorMap* m, const char* g, int cols, int rows, int ld,
            int box_rows) {
  const EncodeTiled fn = encoder();
  if (!fn || (reinterpret_cast<uintptr_t>(g) & 15) || (ld * 2) % 16)
    return false;
  struct Kept {
    const char* g;
    int cols, rows, ld, box_rows;
    CUtensorMap map;
  };
  thread_local Kept kept[256];  // direct-mapped on the arguments
  const uint64_t h = (reinterpret_cast<uintptr_t>(g) >> 4) ^
                     (uint64_t)cols << 20 ^ (uint64_t)rows << 36 ^
                     (uint64_t)ld << 8 ^ (uint64_t)box_rows;
  Kept& k = kept[(h * 0x9E3779B97F4A7C15ull) >> 56];
  if (k.g == g && k.cols == cols && k.rows == rows && k.ld == ld &&
      k.box_rows == box_rows) {
    *m = k.map;
    return true;
  }
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t pitch[1] = {(cuuint64_t)ld * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t step[2] = {1, 1};
  if (fn(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<char*>(g), dims,
         pitch, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  k = Kept{g, cols, rows, ld, box_rows, *m};
  return true;
}

// A map for each live tenant's x and each live segment's w that allows one,
// in launch order, until MAX_MAPS are used.
void encode_maps(const Params& p, Maps& m) {
  std::memset(m.x_map, -1, sizeof m.x_map);
  std::memset(m.w_map, -1, sizeof m.w_map);
  bool tried[MAX_TENANTS] = {};
  int n = 0;
  for (int i = 0; i < p.n_segments && n < MAX_MAPS; ++i) {
    const Segment& sg = p.segments[i];
    const Tenant& tn = p.tenants[sg.tenant];
    if (tn.rows <= 0) continue;
    if (!tried[sg.tenant]) {
      tried[sg.tenant] = true;
      const char* x = static_cast<const char*>(p.bufs[tn.x]) + 2 * tn.x_off;
      if (encode(&m.maps[n], x, tn.depth, tn.rows, tn.ldx, WIDE))
        m.x_map[sg.tenant] = static_cast<signed char>(n++);
    }
    const char* w = static_cast<const char*>(p.bufs[sg.w]) + 2 * sg.w_off;
    if (n < MAX_MAPS && encode(&m.maps[n], w, sg.cols, tn.depth, sg.ldw, 64))
      m.w_map[i] = static_cast<signed char>(n++);
  }
}

constexpr int MAX_DEVICES = 64;

// Launches the bfloat16 kernels over `tiles` tiles: one persistent CTA an
// SM at most.  Their shared memory is set once a device; a device whose
// blocks cannot have it is refused.
int launch_ring(bool dense, const Params& p, int tiles, cudaStream_t st) {
  static int sms[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= MAX_DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
  using Kernel = void (*)(const Params, const Maps);
  const Kernel dense_k = dense_kernel<__nv_bfloat16>;
  const Kernel compact_k = compact_kernel<__nv_bfloat16>;
  if (!sms[dev]) {
    int limit = 0, n = 0;
    cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (limit < ring_bytes() || n <= 0)
      return static_cast<int>(cudaErrorInvalidConfiguration);
    const auto attr = cudaFuncAttributeMaxDynamicSharedMemorySize;
    err = cudaFuncSetAttribute(dense_k, attr, ring_bytes());
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(compact_k, attr, ring_bytes());
    if (err != cudaSuccess) return static_cast<int>(err);
    sms[dev] = n;
  }
  Maps m;
  encode_maps(p, m);
  const int grid = tiles < sms[dev] ? tiles : sms[dev];
  (dense ? dense_k : compact_k)<<<grid, Cfg<__nv_bfloat16>::THREADS,
                                  ring_bytes(), st>>>(p, m);
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
  v[11] = WIDE;
  v[12] = WIDE;
  v[13] = NARROW;
  v[14] = ZERO_ROWS;
  v[15] = smem_bytes<float>();
  v[16] = ring_bytes();
  v[17] = Cfg<float>::BK;
  v[18] = Cfg<__nv_bfloat16>::BK;
  return 0;
}

// params: sizeof(Params) bytes laid out as struct Params; tiles: the
// table's tiles.  Returns cudaGetLastError() after the launch (0 =
// success).
int pm_launch(int dense, int bf16, const void* params, int tiles,
              void* stream) {
  Params p;
  std::memcpy(&p, params, sizeof(Params));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_ring(dense != 0, p, tiles, st)
              : launch<float>(dense != 0, p, tiles, st);
}

}  // extern "C"
