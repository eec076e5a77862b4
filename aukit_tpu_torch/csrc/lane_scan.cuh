// Shared skeleton of the lane-recurrence kernels (adpcm.cu, qoa.cu, flac.cu,
// iir.cu): one thread owns one lane and runs its recurrence over every
// sample of the call, with the lane's state in registers.
//
// Layout. The wrappers keep the JAX wrappers' lane-major layout: input
// In[L, T], output Out[L, T], both row-major. A thread reading its own row
// would make every warp load touch 32 rows, so a block of SCAN_LANES lanes
// stages SCAN_TILE samples of each of its rows in shared memory first (a
// warp loads consecutive elements of one row), runs the recurrence out of
// shared memory, and writes the results back through a second shared tile,
// again along the rows. Every tile row is padded by 4 bytes, so with
// 64-sample tiles a row is an odd number of 4-byte words (17 for bytes, 33
// for int16, 65 for int32 and float) and the per-lane row accesses hit 32
// distinct banks. Building
// the input time-major in the engine instead would have cost an extra
// transpose pass over device memory per step on the torch side.
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

}  // namespace aukit
