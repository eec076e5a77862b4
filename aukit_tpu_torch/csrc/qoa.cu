// QOA LMS reconstruction kernel for Hopper (sm_90a), bound to Python through
// a plain C interface (kernels/_build.py loads it with ctypes;
// kernels/qoa_cuda.py is the wrapper that checks and launches).
//
// Replaces the Pallas TPU kernel
//   - aukit_qoa_lms <- aukit_tpu/kernels/qoa_pallas.py qoa_lms_grouped (_qoa_kernel)
//
// Design. QOA frames carry their LMS state in-band, so the engine hands this
// kernel one lane per (frame, channel), 5120 samples each. The 4-tap LMS is
// a sequential recurrence per lane: one thread owns one lane with its eight
// state words (4 history, 4 weights) in registers and loops over the T
// samples it is given, with no time grid, no n_valid guard and no
// TIME_TILE/UNROLL. Rows are staged through shared memory (lane_scan.cuh).
//
// Bounds on the H100. Per sample a lane reads 2 bytes and writes 2; the
// dependent chain (four multiplies summed, a shift, a clamped add; the
// weight updates run beside it) bounds it before the bytes do, hidden only
// by the warps in flight.
//
// Exactness. int32 wraparound is the spec: the reference's signed_rshift
// coerces through bit32. The products, their sum and the weight updates run
// in uint32 (wadd/wmul), are read back as int32, and only then shifted
// arithmetically by 13. Signed overflow would be undefined behaviour in C++.

#include "lane_scan.cuh"

namespace {

using aukit::clamp_int;
using aukit::wadd;
using aukit::wmul;

// One sample of _qoa_kernel (qoa_pallas.py:48-76).
struct QoaLane {
  int h[4], w[4];

  __device__ __forceinline__ int16_t step(int16_t dq16) {
    const int dq = dq16;
    const int sum = wadd(wadd(wmul(w[0], h[0]), wmul(w[1], h[1])),
                         wadd(wmul(w[2], h[2]), wmul(w[3], h[3])));
    const int recon = clamp_int((sum >> 13) + dq, -32768, 32767);
    const int delta = dq >> 4;
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = wadd(w[i], h[i] < 0 ? -delta : delta);
    h[0] = h[1];
    h[1] = h[2];
    h[2] = h[3];
    h[3] = recon;
    return static_cast<int16_t>(recon);
  }
};

__global__ void __launch_bounds__(aukit::SCAN_LANES)
qoa_lms_kernel(const int16_t* __restrict__ dq, const int32_t* __restrict__ state_in,
               int16_t* __restrict__ out, int32_t* __restrict__ state_out, int lanes,
               long long T) {
  const int lane = blockIdx.x * aukit::SCAN_LANES + threadIdx.x;
  const bool active = lane < lanes;
  QoaLane st{};
  if (active) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      st.h[i] = state_in[i * lanes + lane];
      st.w[i] = state_in[(4 + i) * lanes + lane];
    }
  }
  aukit::scan_rows(dq, out, lanes, T, st);
  if (active) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      state_out[i * lanes + lane] = st.h[i];
      state_out[(4 + i) * lanes + lane] = st.w[i];
    }
  }
}

}  // namespace

// dq i16[L,T], state_in/state_out i32[8,L] (h0..h3, w0..w3), out i16[L,T];
// all contiguous. Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int aukit_qoa_lms(const void* dq, const void* state_in, void* out, void* state_out,
                             int lanes, long long T, void* stream) {
  qoa_lms_kernel<<<aukit::scan_blocks(lanes), aukit::SCAN_LANES, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(dq), static_cast<const int32_t*>(state_in),
      static_cast<int16_t*>(out), static_cast<int32_t*>(state_out), lanes, T);
  return static_cast<int>(cudaGetLastError());
}
