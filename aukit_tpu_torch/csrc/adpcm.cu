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
// kernel decodes exactly T samples). Both ride the pipelined skeleton
// window_rows of lane_scan.cuh, with its output side (a byte in, an int16
// out: the lane reads 16 nibbles as one 16-byte word of shared memory and
// writes their samples as two). The engine's rows, 504 and 1010 bytes, are
// off the 16-byte grid (every other IMA row, every MS row); window_rows cuts
// the tiles on the 16-byte grid of device memory instead of at the row's
// start, so such rows move 16 bytes a copy like any other, and only a row's
// first and last tile step through a split word sample by sample.
//
// Bounds on the H100. Per sample a lane reads 1 byte and writes 2, so at
// the engine's hundreds of thousands of lanes the bytes bound a launch
// (0.163 ms for the block fleet's 360,448 x 504 IMA lanes); at 16384 lanes a
// scheduler has one warp, which issues an integer instruction every other
// cycle, so there the instructions a sample bound it. The dependent chains
// a sample (IMA: the index's add and clamp, the predictor's add and clamp;
// MS: the newest sample's multiply-add, a shift, the add of nibble x delta
// and a two-sided clamp; the delta's own chain, table load, multiply, shift,
// clamp, runs beside it) are shorter than a sample's instructions. The
// lookups live in shared memory: each lane looks up its own entry, and
// __constant__ memory would serialise the warp's divergent addresses (MS
// ADPCM's 16 entries of 8 bytes, the nibble's value beside its factor,
// never conflict: a bank pair each).
//
// IMA's lookup is one load a sample: the signed difference by (step index,
// nibble), 89 x 16 words (5,696 bytes, built at compile time, copied into
// each block's shared memory beside its first tiles), so the step, the
// nibble's three conditional adds and its sign are gone from the sample.
// The load's address comes off the index chain (add, two-sided clamp),
// which is arithmetic: the index delta by nibble is a 4-bit field of one
// constant, picked by a funnel shift by 4 x nibble. So the loads run ahead
// of the predictor's chain (add, two-sided clamp). A table of (difference,
// next index) puts the load's latency on the index chain: built and timed,
// it took half as long again, at the block fleet's launch (360,448 x 504)
// and at 16384 x 8192 (PERF.md section 6).
//
// Exactness. int32 semantics of the Pallas kernels: arithmetic right
// shifts (floors), clamps, and int32 wraparound on adds and multiplies
// (wadd/wmul) where JAX would wrap. IMA clamps the step-table LOOKUP to
// [0, 88] while the raw index feeds that step's index update; an index is
// in range after one update, so the lane clamps its incoming index once for
// the first lookup and looks every later one up by the updated index. IMA
// reads any byte as the Pallas kernel does, magnitude nib & 7 and negative
// from 8 up; bytes above 15 (outside the codec's nibbles) are folded onto
// that column of the table first.
// MS uses the header delta raw for the first sample, even when negative;
// the >= 16 floor and the 1<<20 cap apply from the first update.

#include "lane_scan.cuh"

namespace {

using aukit::clamp_int;
using aukit::wadd;
using aukit::wmul;
using aukit::wsub;

constexpr int DELTA_CAP = 1 << 20;

constexpr int IMA_STEPS = 89;
constexpr int IMA_NIBBLES = 16;
constexpr int IMA_STEP[IMA_STEPS] = {
    7,     8,     9,     10,    11,    12,    13,    14,    16,    17,
    19,    21,    23,    25,    28,    31,    34,    37,    41,    45,
    50,    55,    60,    66,    73,    80,    88,    97,    107,   118,
    130,   143,   157,   173,   190,   209,   230,   253,   279,   307,
    337,   371,   408,   449,   494,   544,   598,   658,   724,   796,
    876,   963,   1060,  1166,  1282,  1411,  1552,  1707,  1878,  2066,
    2272,  2499,  2749,  3024,  3327,  3660,  4026,  4428,  4871,  5358,
    5894,  6484,  7132,  7845,  8630,  9493,  10442, 11487, 12635, 13899,
    15289, 16818, 18500, 20350, 22385, 24623, 27086, 29794, 32767};

// The signed difference of _ima_kernel (ima_pallas.py:55-62) by (step index,
// nibble): step = IMA_STEP[index], m = nibble & 7, diff = ((m * step) >> 2)
// + (step >> 3), negative for nibbles 8..15.
struct alignas(16) ImaTable {
  int diff[IMA_STEPS * IMA_NIBBLES];
};

constexpr ImaTable ima_table() {
  ImaTable t{};
  for (int i = 0; i < IMA_STEPS; ++i) {
    for (int nib = 0; nib < IMA_NIBBLES; ++nib) {
      const int step = IMA_STEP[i], m = nib & 7;
      const int diff = ((m * step) >> 2) + (step >> 3);
      t.diff[i * IMA_NIBBLES + nib] = nib >= 8 ? -diff : diff;
    }
  }
  return t;
}

__device__ const ImaTable IMA_TABLE = ima_table();
constexpr int IMA_TABLE_INT4S = static_cast<int>(sizeof(ImaTable) / 16);

// The index delta by m = nibble & 7 (-1, -1, -1, -1, 2, 4, 6, 8), plus one,
// as 4-bit fields: field m is bits 4m..4m+3. A funnel shift right by 4 x
// nibble (mod 32: 4m) brings it to bits 0..3.
constexpr unsigned IMA_DELTA_FIELDS = 0x97530000u;

// Four bytes to their columns of the table: (nib >= 8) << 3 | (nib & 7).
// Bit 7 of ((nib & 0x78) + 0x78) | nib is nib >= 8 (no carry leaves a byte).
__device__ __forceinline__ unsigned ima_columns(unsigned v) {
  return (v & 0x07070707u) | ((((v & 0x78787878u) + 0x78787878u) | v) & 0x80808080u) >> 4;
}

// One sample of _ima_kernel (ima_pallas.py:49-63).
struct ImaLane {
  const int* diff;  // the (index, nibble) table, in shared memory
  int pred, sidx;
  int look;  // the next lookup's index: the incoming sidx clamped, then sidx

  // nib4 = 4 x column: the nibble's byte offset in a row of the table.
  __device__ __forceinline__ int sample(unsigned nib4) {
    const int d = *reinterpret_cast<const int*>(reinterpret_cast<const char*>(diff) +
                                                look * (4 * IMA_NIBBLES) + nib4);
    const int delta = (__funnelshift_r(IMA_DELTA_FIELDS, IMA_DELTA_FIELDS, nib4) & 15) - 1;
    sidx = clamp_int(wadd(sidx, delta), 0, IMA_STEPS - 1);
    look = sidx;
    pred = clamp_int(wadd(pred, d), -32768, 32767);
    return pred;
  }

  __device__ __forceinline__ int16_t step(uint8_t nib) {
    return static_cast<int16_t>(sample(ima_columns(nib) << 2));
  }

  // Four nibbles of one register to four samples of two.
  __device__ __forceinline__ int2 quad(unsigned v) {
    const unsigned n4 = (v << 2) & 0x3c3c3c3cu;
    const int a = sample(n4 & 0xff);
    const int b = sample(__byte_perm(n4, 0, 0x4441));
    const int c = sample(__byte_perm(n4, 0, 0x4442));
    const int d = sample(n4 >> 24);
    return make_int2(__byte_perm(a, b, 0x5410), __byte_perm(c, d, 0x5410));
  }

  // The 16 nibbles of one 16-byte word.
  __device__ __forceinline__ void group(const uint8_t* x, int16_t* y) {
    uint4 v = *reinterpret_cast<const uint4*>(x);
    if ((v.x | v.y | v.z | v.w) & 0xf0f0f0f0u) {
      v = make_uint4(ima_columns(v.x), ima_columns(v.y), ima_columns(v.z), ima_columns(v.w));
    }
    const int2 a = quad(v.x), b = quad(v.y), c = quad(v.z), d = quad(v.w);
    reinterpret_cast<int4*>(y)[0] = make_int4(a.x, a.y, b.x, b.y);
    reinterpret_cast<int4*>(y)[1] = make_int4(c.x, c.y, d.x, d.y);
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

__global__ void __launch_bounds__(aukit::WIN_LANES)
ima_decode_kernel(const uint8_t* __restrict__ nibbles, const int32_t* __restrict__ state_in,
                  int16_t* __restrict__ out, int32_t* __restrict__ state_out, int lanes,
                  long long T, bool wide_out) {
  // The table, 16 bytes a copy, as one commit group before window_rows'
  // first tiles: window_rows waits for every group but the newest and
  // synchronises the block before its lanes read anything, so the table has
  // landed by then.
  __shared__ int4 diff[IMA_TABLE_INT4S];
  for (int i = threadIdx.x; i < IMA_TABLE_INT4S; i += aukit::WIN_LANES) {
    aukit::cp_async<4>(diff + i, reinterpret_cast<const int4*>(&IMA_TABLE) + i);
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
  const int lane = blockIdx.x * aukit::WIN_LANES + threadIdx.x;
  const bool active = lane < lanes;
  ImaLane st{reinterpret_cast<const int*>(diff), 0, 0, 0};
  if (active) {
    st.pred = state_in[lane];
    st.sidx = state_in[lanes + lane];
    st.look = clamp_int(st.sidx, 0, IMA_STEPS - 1);
  }
  aukit::window_rows(nibbles, out, lanes, T, wide_out, st);
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

// nibbles u8[L,T] (0..15; any other byte reads as the plain version reads
// it), state_in/state_out i32[2,L] (predictor, step_index), out i16[L,T];
// all contiguous. Returns cudaGetLastError()
// after the launch (0 = launched).
extern "C" int aukit_ima_decode(const void* nibbles, const void* state_in, void* out,
                                void* state_out, int lanes, long long T, void* stream) {
  // the fleet's 360,448 lanes are 85 blocks an SM: as many rings as fit
  static const cudaError_t prepared = aukit::prefer_shared_carveout(ima_decode_kernel);
  if (prepared != cudaSuccess) return static_cast<int>(prepared);
  const auto* in = static_cast<const uint8_t*>(nibbles);
  auto* res = static_cast<int16_t*>(out);
  ima_decode_kernel<<<aukit::window_blocks(lanes), aukit::WIN_LANES,
                      aukit::window_shared_bytes<uint8_t, int16_t>(),
                      static_cast<cudaStream_t>(stream)>>>(
      in, static_cast<const int32_t*>(state_in), res, static_cast<int32_t*>(state_out), lanes,
      T, aukit::window_wide_out(in, res));
  return static_cast<int>(cudaGetLastError());
}

// nibbles i8[L,T] (-8..7), state_in/state_out i32[3,L] (sample1, sample2,
// delta), coefs i32[2,L] (c1, c2), out i16[L,T]; all contiguous.
extern "C" int aukit_msadpcm_decode(const void* nibbles, const void* state_in,
                                    const void* coefs, void* out, void* state_out, int lanes,
                                    long long T, void* stream) {
  // the fleet's 180,224 lanes are 43 blocks an SM: as many rings as fit
  static const cudaError_t prepared = aukit::prefer_shared_carveout(msadpcm_decode_kernel);
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
