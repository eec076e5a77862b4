// Shared skeletons of the lane-recurrence kernels (adpcm.cu, qoa.cu, flac.cu,
// iir.cu): one thread owns one lane and runs its recurrence over every
// sample of the call, with the lane's state in registers.
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
// Two skeletons:
//   - scan_rows, the first one (adpcm.cu, qoa.cu: kernels (d), (e), (f)): one
//     input and one output tile per block of SCAN_LANES lanes; load, barrier,
//     compute, barrier, store, barrier, 4 bytes a thread and instruction,
//     nothing asynchronous. Every tile row is padded by 4 bytes, so with
//     64-sample tiles a row is an odd number of 4-byte words (17 for bytes,
//     33 for int16, 65 for int32 and float) and the per-lane row accesses hit
//     32 distinct banks. Its kernels reach 7-10% of their byte bounds on an
//     H100 (PERF.md): between the barriers a block has no bytes in flight,
//     and at a few thousand rows nothing hides that. Their outputs are wider than
//     their inputs, so they need an output ring beside the in-place one; each
//     moves in its own change, and the last one deletes scan_rows.
//   - ring_rows, the pipelined one (flac.cu: (g); iir.cu: (h); dfpwm.cu's
//     encoder: (c)): a ring of ASYNC_STAGES tiles per block of ASYNC_LANES
//     lanes, filled by asynchronous copies (cp.async) two tiles ahead of the
//     one being computed, which the lane updates in place and a caller's
//     function then stores, so a block always has loads and stores in flight
//     while it computes. scan_rows_async is ring_rows with the store of the
//     whole updated tile, 4-byte elements out as they came in ((g), (h));
//     the encoder leaves 32 bytes at the head of each row and stores those.
//     A tile row is 68 words, 4 more than a multiple of 32: rows start on
//     16-byte boundaries and a quarter warp's 16-byte accesses cover all 32
//     banks, whether eight lanes touch their own rows or eight threads run
//     along one row. A block is one warp, so 7168 rows (one FLAC fleet step)
//     make 224 blocks for the card's 132 SMs, and 32768 rows 7.8 blocks per
//     SM, whose 26 KB rings fit the SM's shared memory together.
//     Rows on 16-byte boundaries move 16 bytes a copy. Rows off that grid
//     are no edge: a 44.1 kHz FLAC lane's 4096-sample block resamples to
//     4458 samples, so half of a mixed fleet's lowpass rows are such. They
//     move 8 bytes a copy where the rows start on 8-byte boundaries (an even
//     length, as 4458), else 4, a warp along consecutive bytes of one row,
//     each thread keeping its column and stepping down the rows by
//     constants, as the wide copies do; inside the tile they sit on the same
//     16-byte grid, so the lanes' code is one.
//
// Index arithmetic is 64-bit: the engine's QOA fleet alone hands one call
// 147,456 lanes x 5120 samples.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace aukit {

constexpr int SCAN_LANES = 64;  // threads (= lanes) per block
constexpr int SCAN_TILE = 64;   // samples per lane per shared tile

// elements per shared tile row: SCAN_TILE plus 4 bytes of padding
template <typename T>
struct TileStride {
  static constexpr int value = SCAN_TILE + 4 / static_cast<int>(sizeof(T));
};

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

inline int scan_blocks(int lanes) { return (lanes + SCAN_LANES - 1) / SCAN_LANES; }

// Runs lane.step(x) -> Out over the T samples of this thread's lane. Every
// thread of the block must call it (it synchronises the block); threads past
// the last lane stage and store but do not step.
template <typename In, typename Out, typename Lane>
__device__ __forceinline__ void scan_rows(const In* __restrict__ in,
                                          Out* __restrict__ out, int lanes,
                                          long long T, Lane& lane) {
  constexpr int IN_STRIDE = TileStride<In>::value;
  constexpr int OUT_STRIDE = TileStride<Out>::value;
  __shared__ In in_tile[SCAN_LANES * IN_STRIDE];
  __shared__ Out out_tile[SCAN_LANES * OUT_STRIDE];

  const int tid = threadIdx.x;
  const int lane0 = blockIdx.x * SCAN_LANES;
  const int nlanes = min(SCAN_LANES, lanes - lane0);
  const bool active = tid < nlanes;

  for (long long t0 = 0; t0 < T; t0 += SCAN_TILE) {
    const int nt = static_cast<int>(min(static_cast<long long>(SCAN_TILE), T - t0));
    for (int i = tid; i < nlanes * SCAN_TILE; i += SCAN_LANES) {
      const int r = i / SCAN_TILE, c = i % SCAN_TILE;
      if (c < nt) in_tile[r * IN_STRIDE + c] = in[static_cast<long long>(lane0 + r) * T + t0 + c];
    }
    __syncthreads();
    if (active) {
      const In* row_in = in_tile + tid * IN_STRIDE;
      Out* row_out = out_tile + tid * OUT_STRIDE;
#pragma unroll 4
      for (int j = 0; j < nt; ++j) row_out[j] = lane.step(row_in[j]);
    }
    __syncthreads();
    for (int i = tid; i < nlanes * SCAN_TILE; i += SCAN_LANES) {
      const int r = i / SCAN_TILE, c = i % SCAN_TILE;
      if (c < nt) out[static_cast<long long>(lane0 + r) * T + t0 + c] = out_tile[r * OUT_STRIDE + c];
    }
    __syncthreads();  // the next tile overwrites both shared tiles
  }
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

}  // namespace aukit
