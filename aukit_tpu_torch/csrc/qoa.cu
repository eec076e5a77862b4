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
// TIME_TILE/UNROLL. Residuals in and samples out are both int16, so the rows
// move through the pipelined skeleton of lane_scan.cuh in place
// (window_rows): tiles of 128 samples a row arrive by 16-byte asynchronous
// copies two tiles ahead, a lane reads its tile as 16-byte words of shared
// memory, unpacks two residuals a register, runs the LMS, packs two samples
// back, and the tile leaves by 16-byte stores, in blocks of one warp (26 KB
// of ring each, eight an SM). Rows of any length from any 2-byte
// boundary take the same path: the tiles lie on the 16-byte grid of device
// memory, and only a row's first and last tile step sample by sample.
//
// The lane's arithmetic. The history shift is register renaming in the
// unrolled tile. A weight moves by +-(dq >> 4) with the sign of its history
// sample; the sign is kept beside the history as +-1 (two instructions when
// a sample is made), so each weight update is one multiply-add where a
// compare, a select and an add would be three instructions; (sum >> 13) + dq
// compiles to one shift-and-add. The chain from sample to sample is the last
// tap's multiply-add, that shift-and-add and the two-sided clamp.
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
  int sg[4];  // -1 where h[i] < 0, else 1

  __device__ __forceinline__ void signs() {
#pragma unroll
    for (int i = 0; i < 4; ++i) sg[i] = (h[i] >> 31) | 1;
  }

  __device__ __forceinline__ int sample(int dq) {
    const int sum = wadd(wadd(wmul(w[0], h[0]), wmul(w[1], h[1])),
                         wadd(wmul(w[2], h[2]), wmul(w[3], h[3])));
    const int recon = clamp_int((sum >> 13) + dq, -32768, 32767);
    const int delta = dq >> 4;
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = wadd(w[i], wmul(sg[i], delta));
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      h[i] = h[i + 1];
      sg[i] = sg[i + 1];
    }
    h[3] = recon;
    sg[3] = (recon >> 31) | 1;
    return recon;
  }

  __device__ __forceinline__ int16_t step(int16_t dq) {
    return static_cast<int16_t>(sample(dq));
  }

  // Two residuals of one register to two samples of one register.
  __device__ __forceinline__ int pair(int v) {
    const int a = sample(static_cast<int16_t>(v));
    const int b = sample(v >> 16);
    return __byte_perm(a, b, 0x5410);
  }

  // The 8 residuals of one 16-byte word.
  __device__ __forceinline__ void group(const int16_t* x, int16_t* y) {
    int4 v = *reinterpret_cast<const int4*>(x);
    v.x = pair(v.x);
    v.y = pair(v.y);
    v.z = pair(v.z);
    v.w = pair(v.w);
    *reinterpret_cast<int4*>(y) = v;
  }
};

__global__ void __launch_bounds__(aukit::WIN_LANES)
qoa_lms_kernel(const int16_t* __restrict__ dq, const int32_t* __restrict__ state_in,
               int16_t* __restrict__ out, int32_t* __restrict__ state_out, int lanes,
               long long T, bool wide_out) {
  const int lane = blockIdx.x * aukit::WIN_LANES + threadIdx.x;
  const bool active = lane < lanes;
  QoaLane st{};
  if (active) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      st.h[i] = state_in[i * lanes + lane];
      st.w[i] = state_in[(4 + i) * lanes + lane];
    }
  }
  st.signs();
  aukit::window_rows(dq, out, lanes, T, wide_out, st);
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
  // the fleet's 147,456 lanes are 35 blocks an SM: as many rings as fit
  static const cudaError_t prepared = aukit::prefer_shared_carveout(qoa_lms_kernel);
  if (prepared != cudaSuccess) return static_cast<int>(prepared);
  const auto* in = static_cast<const int16_t*>(dq);
  auto* res = static_cast<int16_t*>(out);
  qoa_lms_kernel<<<aukit::window_blocks(lanes), aukit::WIN_LANES,
                   aukit::window_shared_bytes<int16_t, int16_t>(),
                   static_cast<cudaStream_t>(stream)>>>(
      in, static_cast<const int32_t*>(state_in), res, static_cast<int32_t*>(state_out), lanes, T,
      aukit::window_wide_out(in, res));
  return static_cast<int>(cudaGetLastError());
}
