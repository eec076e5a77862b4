// Shared skeletons of the lane-recurrence kernels (adpcm.cu, qoa.cu, flac.cu,
// iir.cu, dfpwm.cu's encoder): one thread owns one lane and runs its
// recurrence over every sample of the call, with the lane's state in
// registers. (dfpwm.cu's decoder keeps a ring of its own: a byte in, eight
// samples out.)
//
// Layout. The wrappers keep the JAX wrappers' lane-major layout: input
// In[L, T], output Out[L, T], both row-major. A thread reading its own row
// would make every warp load touch 32 rows, so a block stages a tile of each
// of its rows in shared memory (a warp loads consecutive elements of one
// row), runs the recurrence out of shared memory, and writes the results
// back along the rows. Building the input time-major in the engine instead
// would have cost an extra transpose pass over device memory per step on
// the torch side.
//
// Two skeletons, both pipelined: a block is one warp and keeps asynchronous
// copies (cp.async) two tiles ahead of the one its lanes compute.
//   - ring_rows, the pipelined one for 4-byte elements (flac.cu: (g);
//     iir.cu: (h); dfpwm.cu's encoder: (c)): a ring of ASYNC_STAGES tiles per
//     block of ASYNC_LANES lanes, filled by asynchronous copies (cp.async)
//     two tiles ahead of the one being computed, which the lane updates in
//     place and a caller's function then stores, so a block always has loads
//     and stores in flight while it computes. scan_rows_async is ring_rows
//     with the store of the whole updated tile, 4-byte elements out as they
//     came in ((g), (h)); the encoder leaves 32 bytes at the head of each row
//     and stores those. A tile row is 68 words, 4 more than a multiple of 32:
//     rows start on 16-byte boundaries and a quarter warp's 16-byte accesses
//     cover all 32 banks, whether eight lanes touch their own rows or eight
//     threads run along one row. A block is one warp, so 7168 rows (one FLAC
//     fleet step) make 224 blocks for the card's 132 SMs, and 32768 rows 7.8
//     blocks per SM, whose 26 KB rings fit the SM's shared memory together.
//     Rows on 16-byte boundaries move 16 bytes a copy. Rows off that grid
//     are no edge: a 44.1 kHz FLAC lane's 4096-sample block resamples to
//     4458 samples, so half of a mixed fleet's lowpass rows are such. They
//     move 8 bytes a copy where the rows start on 8-byte boundaries (an even
//     length, as 4458), else 4, a warp along consecutive bytes of one row,
//     each thread keeping its column and stepping down the rows by
//     constants, as the wide copies do; inside the tile they sit on the same
//     16-byte grid, so the lanes' code is one. (window_rows' tiles, cut on
//     the grid of device memory, need no narrow copies: once it takes 4-byte
//     elements these three kernels can ride it and ring_rows can go.)
//   - window_rows, the pipelined one for 1- and 2-byte elements, with an
//     output side (adpcm.cu: the IMA decode (d), uint8 in, int16 out, and
//     the MS ADPCM decode (e), int8 in, int16 out; qoa.cu: (f), int16 in
//     place). Rows of such elements start anywhere: an
//     MS ADPCM block's 1010 nibbles put every row on a 2-byte boundary, and
//     cp.async moves 4 bytes at least, aligned. So a row's tiles are cut on
//     the 16-byte grid of device memory, not at the row's first sample: tile
//     n of a row is the WIN_TILE (128) elements from the 16-byte boundary at
//     or before its start plus 128 n, every copy in is one aligned 16-byte
//     cp.async whatever T and the base are, and a lane finds its first
//     sample ``lead`` elements into its first tile. Tiles in which every row
//     of the block has all its elements (all but the first and the last of a
//     row, and the first too where rows start on the grid) run the lane's
//     group() on each 16-byte word of its row, 16-byte shared accesses in
//     and out, and leave by 16-byte stores: the output tile sits on the same
//     grid, since sample j of tile n goes to out + (row start - lead) + 128 n
//     + j. In the two edge tiles a copied word may hold a neighbour row's
//     elements beside the row's own (only where it would reach past the
//     tensor itself is it copied element by element); the lane runs group()
//     on its whole words and steps through the split one between the row's
//     bounds; the store writes whole words where all their samples are the
//     row's and single elements else, so nothing outside a row is written.
//     The edge copies and stores are __noinline__ functions that keep the
//     tile loop short, and the addresses of the whole-tile copies and stores
//     are worked out once a call (row_chunks). A block's 32 rows as one
//     contiguous span, copied linearly, was the other way to reach rows off
//     the grid; it needs the whole rows in shared memory (97 KB a warp for
//     1010-sample rows: two warps an SM, and the recurrence's chain is hidden
//     by warps in flight alone) and a second path for long rows, so the
//     windows were taken. The ring is WIN_STAGES input tiles; where the
//     output is wider than the input the lane writes into one output tile
//     beside it (its stores are on their way before the barrier that lets the
//     next tile's results land), else the tile is updated in place: 22,528 bytes
//     of dynamic shared memory a one-warp block for (d) and (e), 26,112 for
//     (f). Tiles of 128 samples, not 64: the work between
//     two barriers (copies started, tile stored) is spread over twice the
//     samples, and a row's pieces in device memory are twice as long.
//
// Index arithmetic is 64-bit: the engine's QOA fleet alone hands one call
// 147,456 lanes x 5120 samples.

#pragma once

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

namespace aukit {

// int32 arithmetic that wraps, as JAX's and torch's int32 ops do (signed
// overflow is undefined behaviour in C++, so it goes through uint32).
__device__ __forceinline__ int wadd(int a, int b) {
  return static_cast<int>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}
__device__ __forceinline__ int wsub(int a, int b) {
  return static_cast<int>(static_cast<uint32_t>(a) - static_cast<uint32_t>(b));
}
__device__ __forceinline__ int wmul(int a, int b) {
  return static_cast<int>(static_cast<uint32_t>(a) * static_cast<uint32_t>(b));
}
__device__ __forceinline__ int clamp_int(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// -- the pipelined skeleton ---------------------------------------------------------

constexpr int ASYNC_LANES = 32;   // threads (= lanes) per block: one warp
constexpr int ASYNC_TILE = 64;    // samples per lane per tile
constexpr int ASYNC_STAGES = 3;   // tiles in the ring: one computing, two in flight
constexpr int ASYNC_STRIDE = ASYNC_TILE + 4;  // 4-byte words per tile row
constexpr int ASYNC_CHUNKS = ASYNC_TILE / 4;  // 16-byte chunks per tile row

inline int async_blocks(int lanes) { return (lanes + ASYNC_LANES - 1) / ASYNC_LANES; }

// The widest copy, in 4-byte elements (4, 2 or 1), that rows of T elements
// from the bases a and b allow: every row of both must start on its boundary.
inline int copy_width(long long T, const void* a, const void* b) {
  const auto aligned = [&](int bytes) {
    return reinterpret_cast<uintptr_t>(a) % bytes == 0 && reinterpret_cast<uintptr_t>(b) % bytes == 0;
  };
  return T % 4 == 0 && aligned(16) ? 4 : T % 2 == 0 && aligned(8) ? 2 : 1;
}

// An asynchronous copy of WIDTH 4-byte elements (4, 2 or 1) from device to
// shared memory.
template <int WIDTH>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if (WIDTH == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst), "l"(gmem) : "memory");
  } else if (WIDTH == 2) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(dst), "l"(gmem) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst), "l"(gmem) : "memory");
  }
}

// Starts the copies of nt elements of each of nlanes rows into a tile, WIDTH
// elements a copy. Consecutive threads take consecutive pieces of one row:
// a thread keeps its column and walks down the rows, so the addresses of a
// pass differ from the last pass's by constants.
template <int WIDTH, typename Elem>
__device__ __forceinline__ void fetch_tile(Elem* tile, const Elem* __restrict__ src, long long T,
                                           int nlanes, int nt) {
  constexpr int PER_ROW = ASYNC_TILE / WIDTH;            // copies per row
  if constexpr (WIDTH == 4) {
    constexpr int ROWS = ASYNC_LANES / PER_ROW;          // rows per pass: 2
    const int c = (threadIdx.x % PER_ROW) * WIDTH, r0 = threadIdx.x / PER_ROW;
    if (c >= nt) return;
#pragma unroll
    for (int k = 0; k < ASYNC_LANES / ROWS; ++k) {
      const int r = r0 + k * ROWS;
      if (r < nlanes) cp_async<WIDTH>(tile + r * ASYNC_STRIDE + c, src + r * T + c);
    }
  } else {
#pragma unroll
    for (int h = 0; h < PER_ROW / ASYNC_LANES; ++h) {
      const int c = (threadIdx.x + h * ASYNC_LANES) * WIDTH;
      if (c >= nt) break;
#pragma unroll 8
      for (int r = 0; r < ASYNC_LANES; ++r) {
        if (r < nlanes) cp_async<WIDTH>(tile + r * ASYNC_STRIDE + c, src + r * T + c);
      }
    }
  }
}

// The way back: nt elements of each of nlanes rows of a tile to device
// memory, WIDTH elements a store.
template <int WIDTH, typename Elem>
__device__ __forceinline__ void store_tile(const Elem* tile, Elem* __restrict__ dst, long long T,
                                           int nlanes, int nt) {
  constexpr int PER_ROW = ASYNC_TILE / WIDTH;
  if constexpr (WIDTH == 4) {
    constexpr int ROWS = ASYNC_LANES / PER_ROW;
    const int c = (threadIdx.x % PER_ROW) * 4, r0 = threadIdx.x / PER_ROW;
    if (c >= nt) return;
#pragma unroll
    for (int k = 0; k < ASYNC_LANES / ROWS; ++k) {
      const int r = r0 + k * ROWS;
      if (r < nlanes) {
        *reinterpret_cast<int4*>(dst + r * T + c) =
            *reinterpret_cast<const int4*>(tile + r * ASYNC_STRIDE + c);
      }
    }
  } else {
#pragma unroll
    for (int h = 0; h < PER_ROW / ASYNC_LANES; ++h) {
      const int c = (threadIdx.x + h * ASYNC_LANES) * WIDTH;
      if (c >= nt) break;
#pragma unroll 8
      for (int r = 0; r < ASYNC_LANES; ++r) {
        if (r >= nlanes) continue;
        if (WIDTH == 2) {
          *reinterpret_cast<int2*>(dst + r * T + c) =
              *reinterpret_cast<const int2*>(tile + r * ASYNC_STRIDE + c);
        } else {
          dst[r * T + c] = tile[r * ASYNC_STRIDE + c];
        }
      }
    }
  }
}

// The copies of rows off the 16-byte grid, 8 or 4 bytes each, as calls: the
// tile loop of a kernel then holds the 16-byte copy loops and one call, and
// stays as short as it is for rows on the grid (inlined, the unrolled narrow
// loops cost the LPC restore 3-6% at 16 and 32 taps on 16-byte rows, on an
// H100).
template <typename Elem>
__device__ __noinline__ void fetch_tile_off_grid(int width, Elem* tile, const Elem* src,
                                                 long long T, int nlanes, int nt) {
  if (width == 2) {
    fetch_tile<2>(tile, src, T, nlanes, nt);
  } else {
    fetch_tile<1>(tile, src, T, nlanes, nt);
  }
}

template <typename Elem>
__device__ __noinline__ void store_tile_off_grid(int width, const Elem* tile, Elem* dst,
                                                 long long T, int nlanes, int nt) {
  if (width == 2) {
    store_tile<2>(tile, dst, T, nlanes, nt);
  } else {
    store_tile<1>(tile, dst, T, nlanes, nt);
  }
}

// Runs lane.tile(row, t0) over this thread's lane, tile by tile: row points
// at the lane's ASYNC_TILE elements of the tile that starts at element t0
// (16-byte aligned; elements past T are undefined), which the lane updates
// in place. After every lane of the block has done so,
// store(tile, lane0, nlanes, t0, nt) writes out what it wants of the tile's
// nlanes rows of nt valid elements (row r at tile + r * ASYNC_STRIDE is lane
// lane0 + r); all threads call it. Elem is a 4-byte type. Every thread of
// the block must call ring_rows (it synchronises the block); threads past
// the last lane copy but do not compute. The rows arrive ``width`` elements
// a copy (copy_width: 4 for rows on 16-byte boundaries, 2 on 8-byte ones).
template <typename Elem, typename Lane, typename Store>
__device__ __forceinline__ void ring_rows(const Elem* __restrict__ in, int lanes, long long T,
                                          int width, Lane& lane, Store store) {
  static_assert(sizeof(Elem) == 4, "tiles are rows of 4-byte words");
  __shared__ int4 ring[ASYNC_STAGES][ASYNC_LANES * ASYNC_STRIDE / 4];

  const int tid = threadIdx.x;
  const int lane0 = blockIdx.x * ASYNC_LANES;
  const int nlanes = min(ASYNC_LANES, lanes - lane0);
  const long long ntiles = (T + ASYNC_TILE - 1) / ASYNC_TILE;

  // one commit group per tile, also past the end, so the groups count alike
  const auto fetch = [&](long long n, int stage) {
    if (n < ntiles) {
      const long long t0 = n * ASYNC_TILE;
      const int nt = static_cast<int>(min(static_cast<long long>(ASYNC_TILE), T - t0));
      Elem* tile = reinterpret_cast<Elem*>(ring[stage]);
      const Elem* src = in + static_cast<long long>(lane0) * T + t0;
      if (width == 4) {
        fetch_tile<4>(tile, src, T, nlanes, nt);
      } else {
        fetch_tile_off_grid(width, tile, src, T, nlanes, nt);
      }
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };

  fetch(0, 0);
  fetch(1, 1);
  int stage = 0;  // of tile n
  for (long long n = 0; n < ntiles; ++n) {
    const long long t0 = n * ASYNC_TILE;
    const int nt = static_cast<int>(min(static_cast<long long>(ASYNC_TILE), T - t0));
    Elem* tile = reinterpret_cast<Elem*>(ring[stage]);
    asm volatile("cp.async.wait_group 1;" ::: "memory");  // tile n has landed
    __syncthreads();  // for every thread; and tile n - 1 is stored: its stage is free
    fetch(n + 2, (stage + 2) % ASYNC_STAGES);
    if (tid < nlanes) lane.tile(tile + tid * ASYNC_STRIDE, t0);
    __syncthreads();
    store(tile, lane0, nlanes, t0, nt);
    stage = (stage + 1) % ASYNC_STAGES;
  }
}

// ring_rows with every updated tile stored to out[L, T]; rows move
// ``width`` elements a copy either way: copy_width of both bases.
template <typename Elem, typename Lane>
__device__ __forceinline__ void scan_rows_async(const Elem* __restrict__ in,
                                                Elem* __restrict__ out, int lanes, long long T,
                                                int width, Lane& lane) {
  ring_rows(in, lanes, T, width, lane,
            [=](const Elem* tile, int lane0, int nlanes, long long t0, int nt) {
              Elem* dst = out + static_cast<long long>(lane0) * T + t0;
              if (width == 4) {
                store_tile<4>(tile, dst, T, nlanes, nt);
              } else {
                store_tile_off_grid(width, tile, dst, T, nlanes, nt);
              }
            });
}

// -- the pipelined skeleton with an output side -------------------------------------

constexpr int WIN_LANES = 32;   // threads (= lanes) per block: one warp
constexpr int WIN_TILE = 128;   // samples per lane per tile
constexpr int WIN_STAGES = 3;   // input tiles in the ring: one computing, two in flight

// A tile row of 1- or 2-byte elements: WIN_TILE of them and 16 bytes of
// padding, so rows start on 16-byte boundaries and a quarter warp's 16-byte
// accesses cover all 32 banks (rows of 36 and 68 words).
template <typename E>
struct WinRow {
  static_assert(sizeof(E) <= 2, "4-byte elements ride ring_rows");
  static constexpr int PER_CHUNK = 16 / static_cast<int>(sizeof(E));  // elements in 16 bytes
  static constexpr int CHUNKS = WIN_TILE / PER_CHUNK;                 // 16-byte chunks a row
  static constexpr int PITCH = WIN_TILE + PER_CHUNK;                  // elements a shared row
  static constexpr int PASS_ROWS = WIN_LANES / CHUNKS;  // rows a warp covers, a chunk a thread
  static constexpr int INT4S = WIN_LANES * PITCH / PER_CHUNK;         // 16-byte words a tile
  // a warp's copy passes cover whole rows: CHUNKS passes of PASS_ROWS rows
  static_assert(PASS_ROWS >= 1 && WIN_LANES % CHUNKS == 0,
                "a tile row's 16-byte chunks must divide the warp");
};

inline int window_blocks(int lanes) { return (lanes + WIN_LANES - 1) / WIN_LANES; }

// The dynamic shared memory of a block of window_rows<In, Out>: the ring of
// input tiles and, where the output is another type, one tile of results.
template <typename In, typename Out>
constexpr int window_shared_bytes() {
  return 16 * (WIN_STAGES * WinRow<In>::INT4S +
               (std::is_same<In, Out>::value ? 0 : WinRow<Out>::INT4S));
}

// The launch setting of a kernel whose blocks keep a ring in shared memory
// (window_rows, dfpwm.cu's decoder): as much of the SM as shared memory as
// the rings can use (a ring is under the 48 KB a block may ask for by
// default). It holds for the kernel from then on: a launcher keeps the
// result in a function-local static and sets it once.
template <typename Kernel>
inline cudaError_t prefer_shared_carveout(Kernel kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

// Whether the output tiles of window_rows lie on the 16-byte grid: they
// start where the input tiles do, in samples.
template <typename In, typename Out>
inline bool window_wide_out(const In* in, const Out* out) {
  static_assert(sizeof(Out) % sizeof(In) == 0, "an output element is 1 or 2 input elements wide");
  return (reinterpret_cast<uintptr_t>(out) -
          reinterpret_cast<uintptr_t>(in) * (sizeof(Out) / sizeof(In))) % 16 == 0;
}

// Elements between the 16-byte boundary at or before p and p.
template <typename E>
__device__ __forceinline__ int grid_lead(const E* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) & 15) / sizeof(E));
}

// For each pass p of a thread over a tile's rows (rows r0 + p * PASS_ROWS,
// its chunk c of each): where that chunk of the row's tile 0 lies in ``base``,
// whose rows sit on the 16-byte grid as the rows of ``in`` do. Rows past the
// block's last take its place.
template <typename E, typename In>
__device__ __forceinline__ void row_chunks(E* (&at)[WinRow<E>::CHUNKS], E* base,
                                           const In* __restrict__ in, int lane0, int nlanes,
                                           long long T) {
  using W = WinRow<E>;
  const int c = (threadIdx.x % W::CHUNKS) * W::PER_CHUNK, r0 = threadIdx.x / W::CHUNKS;
#pragma unroll
  for (int p = 0; p < W::CHUNKS; ++p) {
    const long long e0 = static_cast<long long>(lane0 + min(r0 + p * W::PASS_ROWS, nlanes - 1)) * T;
    at[p] = base + e0 - grid_lead(in + e0) + c;
  }
}

// The copies of tile n of a block's rows, every 16-byte word of it inside
// the tensor: 16 bytes a copy, a thread keeping its chunk and walking down
// the rows. src[p] is this thread's chunk of tile 0 of the row of its pass p
// (row_chunks); rows past the block's last repeat it, into tile rows that
// no lane reads.
template <typename In>
__device__ __forceinline__ void fetch_window(In* tile,
                                             const In* const (&src)[WinRow<In>::CHUNKS],
                                             long long n) {
  using W = WinRow<In>;
  In* dst = tile + (threadIdx.x / W::CHUNKS) * W::PITCH + (threadIdx.x % W::CHUNKS) * W::PER_CHUNK;
#pragma unroll
  for (int p = 0; p < W::CHUNKS; ++p) {
    cp_async<4>(dst + p * W::PASS_ROWS * W::PITCH, src[p] + n * WIN_TILE);
  }
}

// The same for a tile that reaches past the tensor: only the rows' own
// elements, whole chunks by cp.async, split ones element by element.
template <typename In>
__device__ __noinline__ void fetch_window_edge(In* tile, const In* in, int lane0, int nlanes,
                                               long long T, long long n) {
  using W = WinRow<In>;
  const int c = (threadIdx.x % W::CHUNKS) * W::PER_CHUNK, r0 = threadIdx.x / W::CHUNKS;
  for (int p = 0; p < W::CHUNKS; ++p) {
    const int r = r0 + p * W::PASS_ROWS;
    if (r >= nlanes) break;
    const In* row = in + static_cast<long long>(lane0 + r) * T;
    const long long first = grid_lead(row) - n * WIN_TILE;  // the row's first sample, in the tile
    const int lo = static_cast<int>(max(first, 0LL));
    const int hi = static_cast<int>(min(first + T, static_cast<long long>(WIN_TILE)));
    const In* src = row - first;  // the tile's element 0
    In* dst = tile + r * W::PITCH;
    if (c >= lo && c + W::PER_CHUNK <= hi) {
      cp_async<4>(dst + c, src + c);
    } else {
      for (int j = max(c, lo); j < min(c + W::PER_CHUNK, hi); ++j) dst[j] = src[j];
    }
  }
}

// The way back of a tile whose rows are whole and whose output lies on the
// 16-byte grid: 16 bytes a store, to dst[p] (row_chunks of the output) plus
// n tiles.
template <typename Out>
__device__ __forceinline__ void store_window(const Out* tile,
                                             Out* const (&dst)[WinRow<Out>::CHUNKS], int nlanes,
                                             long long n) {
  using W = WinRow<Out>;
  const int r0 = threadIdx.x / W::CHUNKS;
  const Out* src = tile + r0 * W::PITCH + (threadIdx.x % W::CHUNKS) * W::PER_CHUNK;
#pragma unroll
  for (int p = 0; p < W::CHUNKS; ++p) {
    if (r0 + p * W::PASS_ROWS < nlanes) {
      *reinterpret_cast<int4*>(dst[p] + n * WIN_TILE) =
          *reinterpret_cast<const int4*>(src + p * W::PASS_ROWS * W::PITCH);
    }
  }
}

// The same for a tile at a row's edge, or off the grid (wide false): only
// the row's own samples, whole chunks 16 bytes a store where wide, the rest
// element by element.
template <typename In, typename Out>
__device__ __noinline__ void store_window_edge(const Out* tile, const In* in, Out* out, int lane0,
                                               int nlanes, long long T, long long n, bool wide) {
  using W = WinRow<Out>;
  const int c = (threadIdx.x % W::CHUNKS) * W::PER_CHUNK, r0 = threadIdx.x / W::CHUNKS;
  for (int p = 0; p < W::CHUNKS; ++p) {
    const int r = r0 + p * W::PASS_ROWS;
    if (r >= nlanes) break;
    const long long e0 = static_cast<long long>(lane0 + r) * T;
    const long long first = grid_lead(in + e0) - n * WIN_TILE;
    const int lo = static_cast<int>(max(first, 0LL));
    const int hi = static_cast<int>(min(first + T, static_cast<long long>(WIN_TILE)));
    Out* dst = out + e0 - first;  // where the tile's element 0 would go
    const Out* src = tile + r * W::PITCH;
    if (wide && c >= lo && c + W::PER_CHUNK <= hi) {
      *reinterpret_cast<int4*>(dst + c) = *reinterpret_cast<const int4*>(src + c);
    } else {
      for (int j = max(c, lo); j < min(c + W::PER_CHUNK, hi); ++j) dst[j] = src[j];
    }
  }
}

// Runs the lane over the T samples of this thread's row of in[L, T] and
// writes out[L, T]. lane.group(x, y) takes the samples of one 16-byte word
// at x (16 of one byte, 8 of two; shared memory, 16-byte aligned) to as many
// results at y (aligned likewise; y == x where In and Out are one type: the
// tile is updated in place); lane.step(sample) -> result takes one, for the
// split word at each end of a row. ``wide_out``: window_wide_out(in, out),
// else every store is an element. Every thread of the block (one warp) must
// call it; threads past the last lane copy but do not compute.
template <typename In, typename Out, typename Lane>
__device__ __forceinline__ void window_rows(const In* __restrict__ in, Out* __restrict__ out,
                                            int lanes, long long T, bool wide_out, Lane& lane) {
  using WI = WinRow<In>;
  using WO = WinRow<Out>;
  constexpr bool IN_PLACE = std::is_same<In, Out>::value;
  extern __shared__ int4 window_shared[];  // window_shared_bytes<In, Out>() of them
  int4(*ring)[WI::INT4S] = reinterpret_cast<int4(*)[WI::INT4S]>(window_shared);
  int4* results = window_shared + WIN_STAGES * WI::INT4S;

  const int tid = threadIdx.x;
  const int lane0 = blockIdx.x * WIN_LANES;
  const int nlanes = min(WIN_LANES, lanes - lane0);
  const bool active = tid < nlanes;
  // this lane's first sample is ``lead`` elements into its first tile
  const int lead = active ? grid_lead(in + static_cast<long long>(lane0 + tid) * T) : 0;
  const int lead_max = __reduce_max_sync(0xffffffffu, lead);
  const int lead_min = __reduce_min_sync(0xffffffffu, active ? lead : WI::PER_CHUNK);
  const long long ntiles = (lead_max + T + WIN_TILE - 1) / WIN_TILE;
  // tiles [whole_lo, whole_hi) are whole: every row of the block has all its
  // WIN_TILE samples in them
  const long long whole_lo = lead_max == 0 ? 0 : 1, whole_hi = (lead_min + T) / WIN_TILE;
  // tiles [inside_lo, inside_hi) lie inside the tensor with every 16-byte
  // word of every row of the block (beside a row's own elements they hold
  // its neighbours'): all but the first tile of a tensor that starts off the
  // grid and the last tiles of its last rows
  const long long row0 = static_cast<long long>(lane0) * T;
  const long long row1 = static_cast<long long>(lane0 + nlanes - 1) * T;
  const long long inside_lo = row0 - grid_lead(in + row0) < 0 ? 1 : 0;
  const long long inside_hi =
      (static_cast<long long>(lanes) * T - (row1 - grid_lead(in + row1))) / WIN_TILE;
  // the addresses a thread copies from and stores to, once a call
  const In* src[WI::CHUNKS];
  Out* dst[WO::CHUNKS];
  row_chunks(src, in, in, lane0, nlanes, T);
  row_chunks(dst, out, in, lane0, nlanes, T);

  // one commit group per tile, also past the end, so the groups count alike
  const auto fetch = [&](long long n, int stage) {
    if (n < ntiles) {
      In* tile = reinterpret_cast<In*>(ring[stage]);
      if (n >= inside_lo && n < inside_hi) {
        fetch_window(tile, src, n);
      } else {
        fetch_window_edge(tile, in, lane0, nlanes, T, n);
      }
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };

  fetch(0, 0);
  fetch(1, 1);
  int stage = 0;  // of tile n
  for (long long n = 0; n < ntiles; ++n) {
    In* tile = reinterpret_cast<In*>(ring[stage]);
    Out* done = IN_PLACE ? reinterpret_cast<Out*>(tile) : reinterpret_cast<Out*>(results);
    const bool full = n >= whole_lo && n < whole_hi;
    asm volatile("cp.async.wait_group 1;" ::: "memory");  // tile n has landed
    __syncthreads();  // for every thread; and tile n - 1 is stored: its tiles are free
    fetch(n + 2, (stage + 2) % WIN_STAGES);
    if (active) {
      const In* x = tile + tid * WI::PITCH;
      Out* y = done + tid * WO::PITCH;
      constexpr int G = WI::PER_CHUNK;  // samples a group
      if (full) {
#pragma unroll 4
        for (int g = 0; g < WIN_TILE; g += G) lane.group(x + g, y + g);
      } else {
        // a row's first or last tile: whole groups as ever, the split one
        // sample by sample between the row's bounds
        const long long first = lead - n * WIN_TILE;
        const int lo = static_cast<int>(max(first, 0LL));
        const int hi = static_cast<int>(min(first + T, static_cast<long long>(WIN_TILE)));
#pragma unroll 1
        for (int g = 0; g < WIN_TILE; g += G) {
          if (g >= lo && g + G <= hi) {
            lane.group(x + g, y + g);
          } else {
            for (int j = max(g, lo); j < min(g + G, hi); ++j) y[j] = lane.step(x[j]);
          }
        }
      }
    }
    __syncthreads();
    if (full && wide_out) {
      store_window(done, dst, nlanes, n);
    } else {
      store_window_edge(done, in, out, lane0, nlanes, T, n, wide_out);
    }
    stage = (stage + 1) % WIN_STAGES;
  }
}

}  // namespace aukit
