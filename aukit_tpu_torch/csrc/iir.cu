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
// Design. One thread owns one row with its state in registers; rows are
// staged through shared memory (lane_scan.cuh). Per sample a row reads and
// writes 4 bytes and runs one dependent multiply-add, so at tens of
// thousands of rows the chain's latency, hidden by the warps in flight,
// bounds it before device memory does.

#include "lane_scan.cuh"

namespace {

struct IirLane {
  float a, c, y;
  int t;  // place of the next sample in its group of 8

  __device__ __forceinline__ float step(float x) {
    y = t == 0 ? __fmaf_rn(c, y, __fmul_rn(a, x)) : __fmaf_rn(a, x, __fmul_rn(c, y));
    t = (t + 1) & 7;
    return y;
  }
};

__global__ void __launch_bounds__(aukit::SCAN_LANES)
iir_zero_kernel(const float* __restrict__ x, float* __restrict__ out, int lanes, long long T,
                float a, float c) {
  IirLane st{a, c, 0.0f, 0};
  aukit::scan_rows(x, out, lanes, T, st);
}

}  // namespace

// x/out f32[L,T] contiguous; a = f32(alpha), c = f32(1 - alpha). Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int aukit_iir_zero(const void* x, void* out, int lanes, long long T, float a, float c,
                              void* stream) {
  iir_zero_kernel<<<aukit::scan_blocks(lanes), aukit::SCAN_LANES, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), lanes, T, a, c);
  return static_cast<int>(cudaGetLastError());
}
