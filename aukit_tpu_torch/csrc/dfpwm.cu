// DFPWM1a lane-batched decode and encode kernels for Hopper (sm_90a), bound
// to Python through a plain C interface (kernels/_build.py loads this file
// with ctypes; kernels/dfpwm_cuda.py is the wrapper that checks and launches).
//
// Replaces the three Pallas TPU kernels of aukit_tpu/kernels/dfpwm_pallas.py:
//   - dfpwm_decode      <- dfpwm_decode_grouped     (_decode_kernel, _decode_tile)
//   - dfpwm_decode_dsp  <- dfpwm_decode_dsp_grouped (_decode_dsp_kernel)
//   - dfpwm_encode      <- dfpwm_encode_grouped     (_encode_kernel)
//
// Design. DFPWM is strictly sequential in time and independent across
// streams ("lanes"), so one thread owns one lane: its five int32 state words
// (charge, strength, previous bit, previous charge, lowpass) live in registers
// for the whole call and a loop over every byte replaces the Pallas
// sequential grid axis and its VMEM state scratch. The kernel decodes exactly
// the bytes it is given: the TPU's [32,128] lane tiles, TIME_TILE/UNROLL,
// the n_valid padding guard and the fast-tile split have no counterpart.
//
// Layout. The wrapper keeps the JAX wrappers' lane-major layout (bytes
// u8[L,B] in, samples i8[L,8B] out). A thread reading its own row would make
// every warp load touch 32 rows, so a block of LANES lanes stages TILE_BYTES
// bytes of each of its rows in shared memory first (a warp loads 32
// consecutive bytes of one row), and writes its samples back through a
// second shared tile as 4-byte words along each row. Both tiles have an odd
// row stride in words, so the per-lane row accesses hit 32 distinct banks.
// The cost is two __syncthreads per tile and 18 KB of shared memory per block.
//
// Bounds on the H100. Per 8 samples a lane reads 1 byte and writes 8, and
// each sample is a chain of a few dozen dependent integer ops (the predictor,
// the strength slew, the antijerk average, the lowpass), plus the float
// epilogue for dfpwm_decode_dsp. With enough lanes in flight that would make
// it bound by the int8 writes at large L. Lanes in flight: one thread per
// lane gives 32768 lanes = 1024 warps, about 8 per SM over 132 SMs, and the
// dependent chain is hidden only by those warps and by the ILP across the 8
// unrolled bit steps, so at that width the chain's latency may bound it
// first. LANES = 64 gives 512 blocks at 32768 lanes, 3.9 per SM, so the last
// wave is balanced. PERF.md has the measured share of write bandwidth.
// Speed is later work.
//
// Exactness. Integer semantics are those of _decode_tile (int32, arithmetic
// right shifts -- what nvcc does for signed >>, round-half-up at PREC). The
// epilogue is compared bit for bit with the JAX engine's jitted step, where
// XLA fuses each multiply that feeds an add into one fused multiply-add: the
// smoothing prev + alpha*(cur - prev) and the ramp g0 + slope*t are
// __fmaf_rn here, every other op a separately rounded _rn intrinsic, the
// normalisation an IEEE division. The build passes --fmad=false, so nvcc
// contracts nothing else, and never --use_fast_math.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int PREC = 10;
constexpr int PREC_HALF = 1 << (PREC - 1);
constexpr int STRENGTH_MAX = (1 << PREC) - 1;
constexpr int STRENGTH_MIN = 1 << (PREC - 7);
constexpr int LOWPASS_NUM = 140;

constexpr int LANES = 64;                       // threads (= lanes) per block
constexpr int TILE_BYTES = 32;                  // bytes per lane per tile
constexpr int IN_STRIDE = TILE_BYTES + 4;       // 9 words: odd
constexpr int OUT_WORDS = TILE_BYTES * 2;       // 8 int8 samples = 2 words per byte
constexpr int OUT_STRIDE = OUT_WORDS + 1;       // 65 words: odd

struct Lane {
  int q, s, lb, pq, lp;
};

// The predictor the decoder and the encoder share (_decode_tile,
// dfpwm_pallas.py:42-52; _encode_kernel, :307-314): moves the charge q toward
// the bit's target at strength s and slews s. Returns bit == previous bit.
__device__ __forceinline__ bool predict(int& q, int& s, int lb, int bit) {
  const int target = bit ? 127 : -128;
  int nq = q + ((s * (target - q) + PREC_HALF) >> PREC);
  if (nq == q && nq != target) nq += bit ? 1 : -1;
  const bool same = bit == lb;
  int ns = s;
  if (ns != (same ? STRENGTH_MAX : 0)) ns += same ? 1 : -1;
  s = max(ns, STRENGTH_MIN);
  q = nq;
  return same;
}

// One bit of _decode_tile (dfpwm_pallas.py:42-59); returns the new lowpass.
__device__ __forceinline__ int decode_bit(Lane& st, int bit) {
  const bool same = predict(st.q, st.s, st.lb, bit);
  const int aj = same ? st.q : ((st.q + st.pq + 1) >> 1);
  st.lp += ((aj - st.lp) * LOWPASS_NUM + 0x80) >> 8;
  st.lb = bit;
  st.pq = st.q;
  return st.lp;
}

__device__ __forceinline__ float norm8(int v) {
  return __fdiv_rn(static_cast<float>(v), v < 0 ? 128.0f : 127.0f);
}

// DSP: the fused epilogue of _decode_dsp_kernel (dfpwm_pallas.py:178-213).
// GAIN: the per-lane volume ramp g0 + slope * t (compiled out when false).
template <bool DSP, bool GAIN>
__global__ void __launch_bounds__(LANES)
dfpwm_decode_kernel(const uint8_t* __restrict__ bytes,
                    const int32_t* __restrict__ state_in,
                    int8_t* __restrict__ out, int32_t* __restrict__ state_out,
                    int lanes, long long nbytes, float alpha,
                    const bool* __restrict__ mask,
                    const float* __restrict__ gain0,
                    const float* __restrict__ gain_slope) {
  __shared__ uint32_t in_tile[LANES * IN_STRIDE / 4];
  __shared__ uint32_t out_tile[LANES * OUT_STRIDE];
  const uint8_t* in_b = reinterpret_cast<const uint8_t*>(in_tile);

  const int tid = threadIdx.x;
  const int lane0 = blockIdx.x * LANES;
  const int nlanes = min(LANES, lanes - lane0);
  const bool active = tid < nlanes;
  const int lane = lane0 + tid;

  Lane st{0, 0, 0, 0, 0};
  if (active) {
    st.q = state_in[lane];
    st.s = state_in[lanes + lane];
    st.lb = state_in[2 * lanes + lane];
    st.pq = state_in[3 * lanes + lane];
    st.lp = state_in[4 * lanes + lane];
  }
  // epilogue state: the previous raw sample is the incoming lowpass word
  float prevf = norm8(st.lp);
  const bool live = !DSP || !active || mask == nullptr || mask[lane];
  float g0 = 1.0f, gs = 0.0f;
  if (GAIN && active) {
    g0 = gain0[lane];
    gs = gain_slope[lane];
  }

  for (long long b0 = 0; b0 < nbytes; b0 += TILE_BYTES) {
    const int nb = static_cast<int>(min(static_cast<long long>(TILE_BYTES), nbytes - b0));
    uint8_t* in_w = reinterpret_cast<uint8_t*>(in_tile);
    for (int i = tid; i < nlanes * TILE_BYTES; i += LANES) {
      const int r = i / TILE_BYTES, c = i % TILE_BYTES;
      if (c < nb) in_w[r * IN_STRIDE + c] = bytes[(lane0 + r) * nbytes + b0 + c];
    }
    __syncthreads();
    if (active) {
      for (int j = 0; j < nb; ++j) {
        const int byte = in_b[tid * IN_STRIDE + j];
        uint32_t words[2] = {0u, 0u};
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int v = decode_bit(st, (byte >> k) & 1);
          int q8 = v;
          if (DSP) {
            const float f = norm8(v);
            float o = __fmaf_rn(alpha, __fsub_rn(f, prevf), prevf);
            if (GAIN) {
              const float t = static_cast<float>((b0 + j) * 8 + k);
              o = __fmul_rn(o, __fmaf_rn(gs, t, g0));
            }
            o = __fmul_rn(o, o < 0.0f ? 128.0f : 127.0f);
            o = fminf(fmaxf(o, -128.0f), 127.0f);
            q8 = live ? static_cast<int>(o) : 0;  // truncates, like astype(int8)
            prevf = f;
          }
          words[k >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(q8)) << (8 * (k & 3));
        }
        out_tile[tid * OUT_STRIDE + 2 * j] = words[0];
        out_tile[tid * OUT_STRIDE + 2 * j + 1] = words[1];
      }
    }
    __syncthreads();
    const int words = 2 * nb;
    for (int i = tid; i < nlanes * words; i += LANES) {
      const int r = i / words, c = i % words;
      uint32_t* row = reinterpret_cast<uint32_t*>(out + ((lane0 + r) * nbytes + b0) * 8);
      row[c] = out_tile[r * OUT_STRIDE + c];
    }
    __syncthreads();  // the next tile overwrites both shared tiles
  }

  if (active) {
    state_out[lane] = st.q;
    state_out[lanes + lane] = st.s;
    state_out[2 * lanes + lane] = st.lb;
    state_out[3 * lanes + lane] = st.pq;
    state_out[4 * lanes + lane] = st.lp;
  }
}

// The encoder (_encode_kernel, dfpwm_pallas.py:288-344), the decoder's
// mirror: here the input is the wide side, 8 int8 levels in for each byte
// out. A block stages 8 * TILE_BYTES levels of each of its rows as 4-byte
// words along the row (every row starts on a word: N is a multiple of 8 and
// the wrapper hands over a word-aligned base), one thread encodes its lane
// out of shared memory with the three state words (charge, strength,
// previous bit) in registers, and the bytes go back through a second tile
// along the rows. The level tile's row stride is 65 words, odd, so the
// per-lane reads hit 32 distinct banks. The bit is 1 iff level > charge, or
// level == charge == 127 (silence then encodes to alternating bits); 8 bits
// pack LSB first. Per byte out the lane moves 9 bytes and runs 8 dependent
// predictor steps of ~24 integer operations: at 32768 lanes (8 warps per SM)
// the chain's latency bounds it before the bytes do, as in the decoder.
constexpr int LEVEL_WORDS = TILE_BYTES * 2;     // 8 int8 levels = 2 words per byte out
constexpr int LEVEL_STRIDE = LEVEL_WORDS + 1;   // 65 words: odd

__global__ void __launch_bounds__(LANES)
dfpwm_encode_kernel(const int8_t* __restrict__ levels,
                    const int32_t* __restrict__ state_in,
                    uint8_t* __restrict__ out, int32_t* __restrict__ state_out,
                    int lanes, long long nbytes) {
  __shared__ uint32_t level_tile[LANES * LEVEL_STRIDE];
  __shared__ uint32_t byte_tile[LANES * IN_STRIDE / 4];
  uint8_t* byte_w = reinterpret_cast<uint8_t*>(byte_tile);

  const int tid = threadIdx.x;
  const int lane0 = blockIdx.x * LANES;
  const int nlanes = min(LANES, lanes - lane0);
  const bool active = tid < nlanes;
  const int lane = lane0 + tid;

  int q = 0, s = 0, lb = 0;
  if (active) {
    q = state_in[lane];
    s = state_in[lanes + lane];
    lb = state_in[2 * lanes + lane];
  }

  for (long long b0 = 0; b0 < nbytes; b0 += TILE_BYTES) {
    const int nb = static_cast<int>(min(static_cast<long long>(TILE_BYTES), nbytes - b0));
    const int words = 2 * nb;
    for (int i = tid; i < nlanes * LEVEL_WORDS; i += LANES) {
      const int r = i / LEVEL_WORDS, c = i % LEVEL_WORDS;
      if (c < words) {
        const uint32_t* row =
            reinterpret_cast<const uint32_t*>(levels + ((lane0 + r) * nbytes + b0) * 8);
        level_tile[r * LEVEL_STRIDE + c] = row[c];
      }
    }
    __syncthreads();
    if (active) {
      for (int j = 0; j < nb; ++j) {
        const uint32_t w[2] = {level_tile[tid * LEVEL_STRIDE + 2 * j],
                               level_tile[tid * LEVEL_STRIDE + 2 * j + 1]};
        int byte = 0;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int level = static_cast<int8_t>(w[k >> 2] >> (8 * (k & 3)));
          const int bit = (level > q || (level == q && q == 127)) ? 1 : 0;
          predict(q, s, lb, bit);
          lb = bit;
          byte |= bit << k;
        }
        byte_w[tid * IN_STRIDE + j] = static_cast<uint8_t>(byte);
      }
    }
    __syncthreads();
    for (int i = tid; i < nlanes * TILE_BYTES; i += LANES) {
      const int r = i / TILE_BYTES, c = i % TILE_BYTES;
      if (c < nb) out[(lane0 + r) * nbytes + b0 + c] = byte_w[r * IN_STRIDE + c];
    }
    __syncthreads();  // the next tile overwrites both shared tiles
  }

  if (active) {
    state_out[lane] = q;
    state_out[lanes + lane] = s;
    state_out[2 * lanes + lane] = lb;
  }
}

int blocks_for(int lanes) { return (lanes + LANES - 1) / LANES; }

}  // namespace

// bytes u8[L,B], state_in/state_out i32[5,L], out i8[L,8B]; all contiguous.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int aukit_dfpwm_decode(const void* bytes, const void* state_in,
                                  void* out, void* state_out, int lanes,
                                  long long nbytes, void* stream) {
  dfpwm_decode_kernel<false, false>
      <<<blocks_for(lanes), LANES, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const uint8_t*>(bytes), static_cast<const int32_t*>(state_in),
          static_cast<int8_t*>(out), static_cast<int32_t*>(state_out), lanes,
          nbytes, 0.0f, nullptr, nullptr, nullptr);
  return static_cast<int>(cudaGetLastError());
}

// As aukit_dfpwm_decode, with the fused epilogue. mask: bool[L] or null
// (all live). gain0/gain_slope: f32[L] each, or both null (no gain input).
extern "C" int aukit_dfpwm_decode_dsp(const void* bytes, const void* state_in,
                                      void* out, void* state_out, int lanes,
                                      long long nbytes, float alpha,
                                      const void* mask, const void* gain0,
                                      const void* gain_slope, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* b = static_cast<const uint8_t*>(bytes);
  const auto* si = static_cast<const int32_t*>(state_in);
  auto* o = static_cast<int8_t*>(out);
  auto* so = static_cast<int32_t*>(state_out);
  const auto* m = static_cast<const bool*>(mask);
  if (gain0 != nullptr) {
    dfpwm_decode_kernel<true, true><<<blocks_for(lanes), LANES, 0, s>>>(
        b, si, o, so, lanes, nbytes, alpha, m, static_cast<const float*>(gain0),
        static_cast<const float*>(gain_slope));
  } else {
    dfpwm_decode_kernel<true, false><<<blocks_for(lanes), LANES, 0, s>>>(
        b, si, o, so, lanes, nbytes, alpha, m, nullptr, nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}

// levels i8[L,8B] (word-aligned), state_in/state_out i32[3,L] (charge,
// strength, previous bit), out u8[L,B]; all contiguous. nbytes = B.
extern "C" int aukit_dfpwm_encode(const void* levels, const void* state_in,
                                  void* out, void* state_out, int lanes,
                                  long long nbytes, void* stream) {
  dfpwm_encode_kernel<<<blocks_for(lanes), LANES, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(levels), static_cast<const int32_t*>(state_in),
      static_cast<uint8_t*>(out), static_cast<int32_t*>(state_out), lanes, nbytes);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* aukit_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
