// Elementwise float32 fused multiply-add for Hopper (sm_90a), bound to
// Python through a plain C interface (kernels/fma_cuda.py is the wrapper).
//
// No Pallas kernel corresponds to it. The JAX package's engine step is one
// jitted computation, and XLA compiles every float multiply that feeds an
// add into one fused multiply-add, rounded once: the resample's
// p1 + (p2 - p1) * frac, the FIR's prev + alpha * (s - prev), the volume
// ramp's g0 + slope * t, the cubic and sinc interpolators' sums
// (aukit_tpu/ops/resample.py, aukit_tpu/parallel/pipeline.py:97-101).
// torch runs a multiply and an add as two ops, each rounded, so dsp_chain
// calls this kernel where XLA fuses, and its int8 windows equal the JAX
// engine's bit for bit.
//
// Design. out[r, c] = fmaf(x, y, z) over a 2-D [rows, cols] output, each
// operand read through its own (row, column) strides, so the broadcasts of
// dsp_chain (a per-column fraction, a per-row gain, a scalar alpha) need no
// materialised copy. Memory-bound: 4 bytes written per element and at most
// 12 read; grid.x covers columns, grid.y strides over rows. __fmaf_rn is
// the IEEE fused multiply-add, whatever --fmad says.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

struct Operand {
  const float* p;
  long long rs, cs;  // row and column strides, in elements (0 = broadcast)
  __device__ __forceinline__ float at(long long r, long long c) const { return p[r * rs + c * cs]; }
};

__global__ void __launch_bounds__(THREADS)
fma_kernel(Operand x, Operand y, Operand z, float* __restrict__ out, long long rows,
           long long cols) {
  const long long c = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (c >= cols) return;
  for (long long r = blockIdx.y; r < rows; r += gridDim.y) {
    out[r * cols + c] = __fmaf_rn(x.at(r, c), y.at(r, c), z.at(r, c));
  }
}

}  // namespace

// out f32[rows, cols] contiguous; x, y, z f32 with (row, column) strides.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int aukit_fma(const void* x, long long xrs, long long xcs, const void* y,
                         long long yrs, long long ycs, const void* z, long long zrs,
                         long long zcs, void* out, long long rows, long long cols,
                         void* stream) {
  const dim3 grid(static_cast<unsigned>((cols + THREADS - 1) / THREADS),
                  static_cast<unsigned>(rows < 65535 ? rows : 65535));
  fma_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      Operand{static_cast<const float*>(x), xrs, xcs},
      Operand{static_cast<const float*>(y), yrs, ycs},
      Operand{static_cast<const float*>(z), zrs, zcs}, static_cast<float*>(out), rows, cols);
  return static_cast<int>(cudaGetLastError());
}
