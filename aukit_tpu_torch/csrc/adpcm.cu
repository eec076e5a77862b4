// IMA ADPCM and Microsoft ADPCM block-lane decode kernels for Hopper
// (sm_90a), bound to Python through a plain C interface (kernels/_build.py
// loads them with ctypes; kernels/adpcm_cuda.py is the wrapper that checks
// and launches).
//
// Replaces two Pallas TPU kernels:
//   - aukit_ima_decode     <- aukit_tpu/kernels/ima_pallas.py     ima_decode_grouped (_ima_kernel)
//   - aukit_msadpcm_decode <- aukit_tpu/kernels/msadpcm_pallas.py msadpcm_decode_grouped (_ms_kernel)
//
// Design. Both formats carry their predictor state in every block header,
// so the engine hands these kernels one lane per (block, channel): many
// short lanes (504 samples for IMA at block_align 256, 1010 for MS at 512).
// Each lane is a sequential integer recurrence, so one thread owns one lane
// with its state in registers and loops over the T samples it is given;
// there is no time grid, no n_valid guard and no TIME_TILE/UNROLL (the
// kernel decodes exactly T samples). Rows are staged through shared memory
// (lane_scan.cuh): the IMA decode on the first skeleton, scan_rows; the MS
// ADPCM decode on the pipelined window_rows, whose output side it has (a
// byte in, an int16 out: the lane reads 16 nibbles as one 16-byte word of
// shared memory and writes their samples as two). Its engine rows, 1010
// bytes, start on 2-byte boundaries, off every grid an asynchronous copy
// knows; window_rows cuts the tiles on the 16-byte grid of device memory
// instead of at the row's start, so such rows move 16 bytes a copy like any
// other, and only a row's first and last tile step sample by sample.
//
// Bounds on the H100. Per sample a lane reads 1 byte and writes 2, so at
// the engine's hundreds of thousands of lanes the bytes would allow ~1e12
// samples/s; the dependent chain per sample (IMA: a shared-memory table
// load, the index update and a clamped add; MS: the newest sample's
// multiply-add, a shift, the add of nibble x delta and a two-sided clamp;
// the delta's own chain, table load, multiply, shift, clamp, runs beside it)
// bounds a warp, hidden only by the warps in flight. IMA's 89-entry step
// table and MS ADPCM's 16 adaption factors live in shared memory: each lane
// looks up its own entry, and __constant__ memory would serialise the warp's
// divergent addresses (MS ADPCM's 16 entries of 8 bytes, the nibble's value
// beside its factor, never conflict: a bank pair each).
//
// Exactness. int32 semantics of the Pallas kernels: arithmetic right
// shifts (floors), clamps, and int32 wraparound on adds and multiplies
// (wadd/wmul) where JAX would wrap. IMA clamps the step-table LOOKUP to
// [0, 88] while the raw index feeds that step's index update. MS uses the
// header delta raw for the first sample, even when negative; the >= 16
// floor and the 1<<20 cap apply from the first update.

#include "lane_scan.cuh"

namespace {

using aukit::clamp_int;
using aukit::wadd;
using aukit::wmul;
using aukit::wsub;

constexpr int DELTA_CAP = 1 << 20;

__constant__ int IMA_STEP[89] = {
    7,     8,     9,     10,    11,    12,    13,    14,    16,    17,
    19,    21,    23,    25,    28,    31,    34,    37,    41,    45,
    50,    55,    60,    66,    73,    80,    88,    97,    107,   118,
    130,   143,   157,   173,   190,   209,   230,   253,   279,   307,
    337,   371,   408,   449,   494,   544,   598,   658,   724,   796,
    876,   963,   1060,  1166,  1282,  1411,  1552,  1707,  1878,  2066,
    2272,  2499,  2749,  3024,  3327,  3660,  4026,  4428,  4871,  5358,
    5894,  6484,  7132,  7845,  8630,  9493,  10442, 11487, 12635, 13899,
    15289, 16818, 18500, 20350, 22385, 24623, 27086, 29794, 32767};

// One sample of _ima_kernel (ima_pallas.py:49-63).
struct ImaLane {
  const int* tbl;  // the step table, in shared memory
  int pred, sidx;

  __device__ __forceinline__ int16_t step(uint8_t nib8) {
    const int nib = nib8;
    const int step = tbl[clamp_int(sidx, 0, 88)];
    const int m = nib & 7;
    sidx = clamp_int(wadd(sidx, m < 4 ? -1 : (m - 3) * 2), 0, 88);
    const int diff = ((m * step) >> 2) + (step >> 3);
    pred = clamp_int(nib >= 8 ? wsub(pred, diff) : wadd(pred, diff), -32768, 32767);
    return static_cast<int16_t>(pred);
  }
};

// The adaption factor by nib & 15 (_adapt, msadpcm_pallas.py:39-45: 230 and
// the cumulative thresholds on |nib|; nibble -8 is index 8).
__constant__ int MS_ADAPT[16] = {230, 230, 230, 230, 307, 409, 512, 614,
                                 768, 614, 512, 409, 307, 230, 230, 230};

// One sample of _ms_kernel (msadpcm_pallas.py:59-78).
struct MsLane {
  const int2* table;  // (signed nibble, MS_ADAPT) by nib & 15, in shared memory
  int s1, s2, delta, c1, c2;

  __device__ __forceinline__ int sample(int nib, int adapt) {
    const int lin = wadd(wmul(s1, c1), wmul(s2, c2)) >> 8;
    const int pred = clamp_int(wadd(lin, wmul(nib, delta)), -32768, 32767);
    delta = clamp_int(wmul(adapt, delta) >> 8, 16, DELTA_CAP);
    s2 = s1;
    s1 = pred;
    return pred;
  }

  __device__ __forceinline__ int16_t step(int8_t nib) {
    return static_cast<int16_t>(sample(nib, table[nib & 15].y));
  }

  // Four nibbles of one register to four samples of two. One 8-byte load
  // gives a nibble's sign-extended value and its adaption factor: its
  // address is the nibble's byte of (v << 3) & 0x78787878.
  __device__ __forceinline__ int2 quad(unsigned v) {
    const unsigned at = (v << 3) & 0x78787878u;
    const char* base = reinterpret_cast<const char*>(table);
    const int2 e0 = *reinterpret_cast<const int2*>(base + (at & 0xff));
    const int2 e1 = *reinterpret_cast<const int2*>(base + __byte_perm(at, 0, 0x4441));
    const int2 e2 = *reinterpret_cast<const int2*>(base + __byte_perm(at, 0, 0x4442));
    const int2 e3 = *reinterpret_cast<const int2*>(base + (at >> 24));
    const int a = sample(e0.x, e0.y);
    const int b = sample(e1.x, e1.y);
    const int c = sample(e2.x, e2.y);
    const int d = sample(e3.x, e3.y);
    return make_int2(__byte_perm(a, b, 0x5410), __byte_perm(c, d, 0x5410));
  }

  // The 16 nibbles of one 16-byte word.
  __device__ __forceinline__ void group(const int8_t* x, int16_t* y) {
    const int4 v = *reinterpret_cast<const int4*>(x);
    const int2 a = quad(v.x), b = quad(v.y), c = quad(v.z), d = quad(v.w);
    reinterpret_cast<int4*>(y)[0] = make_int4(a.x, a.y, b.x, b.y);
    reinterpret_cast<int4*>(y)[1] = make_int4(c.x, c.y, d.x, d.y);
  }
};

__global__ void __launch_bounds__(aukit::SCAN_LANES)
ima_decode_kernel(const uint8_t* __restrict__ nibbles, const int32_t* __restrict__ state_in,
                  int16_t* __restrict__ out, int32_t* __restrict__ state_out, int lanes,
                  long long T) {
  __shared__ int tbl[89];
  for (int i = threadIdx.x; i < 89; i += blockDim.x) tbl[i] = IMA_STEP[i];
  __syncthreads();
  const int lane = blockIdx.x * aukit::SCAN_LANES + threadIdx.x;
  const bool active = lane < lanes;
  ImaLane st{tbl, 0, 0};
  if (active) {
    st.pred = state_in[lane];
    st.sidx = state_in[lanes + lane];
  }
  aukit::scan_rows(nibbles, out, lanes, T, st);
  if (active) {
    state_out[lane] = st.pred;
    state_out[lanes + lane] = st.sidx;
  }
}

__global__ void __launch_bounds__(aukit::WIN_LANES)
msadpcm_decode_kernel(const int8_t* __restrict__ nibbles, const int32_t* __restrict__ state_in,
                      const int32_t* __restrict__ coefs, int16_t* __restrict__ out,
                      int32_t* __restrict__ state_out, int lanes, long long T, bool wide_out) {
  __shared__ int2 table[16];
  if (threadIdx.x < 16) {
    table[threadIdx.x] = make_int2(static_cast<int>(threadIdx.x ^ 8) - 8, MS_ADAPT[threadIdx.x]);
  }
  __syncthreads();
  const int lane = blockIdx.x * aukit::WIN_LANES + threadIdx.x;
  const bool active = lane < lanes;
  MsLane st{table, 0, 0, 0, 0, 0};
  if (active) {
    st.s1 = state_in[lane];
    st.s2 = state_in[lanes + lane];
    st.delta = state_in[2 * lanes + lane];
    st.c1 = coefs[lane];
    st.c2 = coefs[lanes + lane];
  }
  aukit::window_rows(nibbles, out, lanes, T, wide_out, st);
  if (active) {
    state_out[lane] = st.s1;
    state_out[lanes + lane] = st.s2;
    state_out[2 * lanes + lane] = st.delta;
  }
}

}  // namespace

// nibbles u8[L,T] (0..15), state_in/state_out i32[2,L] (predictor,
// step_index), out i16[L,T]; all contiguous. Returns cudaGetLastError()
// after the launch (0 = launched).
extern "C" int aukit_ima_decode(const void* nibbles, const void* state_in, void* out,
                                void* state_out, int lanes, long long T, void* stream) {
  ima_decode_kernel<<<aukit::scan_blocks(lanes), aukit::SCAN_LANES, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(nibbles), static_cast<const int32_t*>(state_in),
      static_cast<int16_t*>(out), static_cast<int32_t*>(state_out), lanes, T);
  return static_cast<int>(cudaGetLastError());
}

// nibbles i8[L,T] (-8..7), state_in/state_out i32[3,L] (sample1, sample2,
// delta), coefs i32[2,L] (c1, c2), out i16[L,T]; all contiguous.
extern "C" int aukit_msadpcm_decode(const void* nibbles, const void* state_in,
                                    const void* coefs, void* out, void* state_out, int lanes,
                                    long long T, void* stream) {
  // the fleet's 180,224 lanes are 43 blocks an SM: as many rings as fit
  static const cudaError_t prepared = aukit::window_prepare(msadpcm_decode_kernel);
  if (prepared != cudaSuccess) return static_cast<int>(prepared);
  const auto* in = static_cast<const int8_t*>(nibbles);
  auto* res = static_cast<int16_t*>(out);
  msadpcm_decode_kernel<<<aukit::window_blocks(lanes), aukit::WIN_LANES,
                          aukit::window_shared_bytes<int8_t, int16_t>(),
                          static_cast<cudaStream_t>(stream)>>>(
      in, static_cast<const int32_t*>(state_in), static_cast<const int32_t*>(coefs), res,
      static_cast<int32_t*>(state_out), lanes, T, aukit::window_wide_out(in, res));
  return static_cast<int>(cudaGetLastError());
}
