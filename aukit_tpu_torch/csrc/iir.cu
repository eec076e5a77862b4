// Zero-state one-pole lowpass kernel for Hopper (sm_90a), bound to Python
// through a plain C interface (kernels/_build.py loads it with ctypes;
// kernels/iir_cuda.py is the wrapper that checks and launches).
//
// Replaces the Pallas TPU kernel
//   - aukit_iir_zero <- aukit_tpu/kernels/iir_pallas.py iir_zero_grouped
//     (_iir_kernel), and its wrapper iir_zero_lanes
//
// The recurrence, per row (one resampled FLAC block of one channel):
//   y[t] = a*x[t] + c*y[t-1],  y[-1] = 0,  a = f32(alpha), c = f32(1 - alpha)
// The FLAC fleet recovers the chain across blocks outside the kernel.
//
// Rounding. The JAX kernel's body is a fori_loop over groups of 8 samples,
// and XLA's CPU backend (the JAX package's reference on any machine without
// a TPU) contracts a*x + c*y into one fused multiply-add in a way that
// depends on the sample's place in the group: the first sample of each
// group of 8 (t % 8 == 0) rounds a*x and fuses c*y into the add; the other
// seven round c*y and fuse a*x. This kernel writes exactly those
// __fmaf_rn/__fmul_rn calls; the library is built with --fmad=false, so
// nvcc contracts nothing else. The plain version (iir_cuda.iir_zero_ref)
// does the same through fma_ref.
//
// Design. One thread owns one row with its state in a register. What
// bounds it on the H100 is the bytes: a sample is 4 bytes in, 4 out, and a
// multiply and a fused multiply-add on the chain (some 16 us of chain for a
// 4096-sample row), so the kernel is as fast as its rows keep moving. They
// move through the pipelined skeleton of lane_scan.cuh (scan_rows_async, as
// the LPC restore): tiles of 64 samples a row arrive by asynchronous copies
// two tiles ahead, are filtered in place and leave again, in blocks of one
// warp so that a fleet step's few thousand rows reach every SM. A lane runs
// a tile as eight unrolled groups of 8, read and written as 16-byte words of
// shared memory; tiles start at multiples of 64, so the place in the group
// of 8 (which multiply fuses) is known when the kernel is compiled and costs
// no instruction. Rows off the 16-byte grid (a 44.1 kHz lane's blocks
// resample to 4458 samples) move 8 or 4 bytes a copy and run the same lane
// code.

#include "lane_scan.cuh"

namespace {

struct IirLane {
  float a, c, y;

  // One group of 8: x[0] is a sample whose index is a multiple of 8.
  __device__ __forceinline__ void group(float* x) {
    float4 u = *reinterpret_cast<const float4*>(x);
    float4 v = *reinterpret_cast<const float4*>(x + 4);
    u.x = y = __fmaf_rn(c, y, __fmul_rn(a, u.x));
    u.y = y = __fmaf_rn(a, u.y, __fmul_rn(c, y));
    u.z = y = __fmaf_rn(a, u.z, __fmul_rn(c, y));
    u.w = y = __fmaf_rn(a, u.w, __fmul_rn(c, y));
    v.x = y = __fmaf_rn(a, v.x, __fmul_rn(c, y));
    v.y = y = __fmaf_rn(a, v.y, __fmul_rn(c, y));
    v.z = y = __fmaf_rn(a, v.z, __fmul_rn(c, y));
    v.w = y = __fmaf_rn(a, v.w, __fmul_rn(c, y));
    *reinterpret_cast<float4*>(x) = u;
    *reinterpret_cast<float4*>(x + 4) = v;
  }

  // One tile of the row, in place. Samples past the row's end hold whatever
  // the ring held; they are filtered too and never stored.
  __device__ __forceinline__ void tile(float* row, long long) {
#pragma unroll
    for (int g = 0; g < aukit::ASYNC_TILE; g += 8) group(row + g);
  }
};

__global__ void __launch_bounds__(aukit::ASYNC_LANES)
iir_zero_kernel(const float* __restrict__ x, float* __restrict__ out, int lanes, long long T,
                float a, float c, int width) {
  IirLane st{a, c, 0.0f};
  aukit::scan_rows_async(x, out, lanes, T, width, st);
}

}  // namespace

// x/out f32[L,T] contiguous; a = f32(alpha), c = f32(1 - alpha). Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int aukit_iir_zero(const void* x, void* out, int lanes, long long T, float a, float c,
                              void* stream) {
  // 32768 rows are 7.8 blocks per SM: their rings need the SM's whole shared memory
  cudaFuncSetAttribute(iir_zero_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                       cudaSharedmemCarveoutMaxShared);
  iir_zero_kernel<<<aukit::async_blocks(lanes), aukit::ASYNC_LANES, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), lanes, T, a, c,
      aukit::copy_width(T, x, out));
  return static_cast<int>(cudaGetLastError());
}
