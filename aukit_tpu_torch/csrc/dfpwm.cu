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
// bytes of each of its rows in shared memory first and writes its samples
// back through a second shared tile, along each row. The decoder moves 16
// bytes an instruction wherever the rows allow it: it loads a row's tile as
// 16-byte words when the row length is a multiple of 16, a lane writes the
// 16 samples of two bytes as one 16-byte word into the sample tile, and the
// tile goes out as 16-byte stores when the row length is even (every row of
// samples then starts on a 16-byte boundary). The sample tile's row stride
// is 68 words, 4 more than a multiple of 32, so a quarter warp's 16-byte
// accesses cover all 32 banks whether eight lanes write their own rows or
// eight threads read along one row. Odd row lengths take 4-byte stores and
// byte loads; the ragged last tile runs the same code with a shorter count.
// The encoder keeps its 4-byte staging and its odd strides.
//
// What bounds the decoder on the H100 (measured: PERF.md). Per 8 samples a
// lane reads 1 byte and writes 8, far under the memory rate: instructions
// bound it. A sample's recurrence compiles to 26 instructions (19 on the
// integer pipe, which starts a warp's instruction every other cycle, 7
// multiply-adds on the float pipe), of which 8 form the chain from one
// charge to the next. One thread per lane gives 32768 lanes = 1024 warps,
// two per scheduler, so the chain's latency and the integer pipe bound it
// together, and the lanes are the only parallelism the recurrence has.
// LANES = 64 gives 512 blocks at 32768 lanes, 3.9 per SM (32 or 64 lanes a
// block time the same). The barriers (three per tile of 256 samples a lane)
// cost nothing beside a tile's ~7000 instructions.
//
// The fused epilogue (dfpwm_decode_dsp) is off that chain: it reads only the
// sequence of lowpass words. So its cost is instruction slots, and its design
// is to spend few, and those on the float pipe, the load unit and the
// conversion unit, which the recurrence leaves idle:
//   - the normalisation v / (v < 0 ? 128 : 127) is a lookup in a 256-entry
//     table in shared memory that each block fills with the same IEEE
//     division. A lane whose charge, previous charge and lowpass start in
//     [-128, 127] and whose strength starts in [0, 1023] keeps its lowpass
//     word in [-128, 127] for ever (every update moves a word toward a
//     target in that range), so the range is checked once per call and lane,
//     not per sample; any other lane divides, as the plain version does;
//   - the rail 128 or 127 is 127.5 - copysign(0.5, o): one bit operation and
//     one exact float add instead of a compare and a select;
//   - clamp, truncation and cast are one conversion float -> int32 toward
//     zero (it saturates, NaN gives 0) and, per two samples, one packing
//     conversion int32 -> int8 that saturates to [-128, 127]: the same
//     result as clamp(-128, 127) then truncation for every float, and as the
//     plain version's cast of NaN;
//   - the ramp's time is a float advanced by an exact + 1.0f while the call
//     has at most 2^24 samples a lane, and converted from the 64-bit index
//     beyond that;
//   - a masked lane's words are and-ed with zero once per byte.
// The compiler merges the two conversions into one packing conversion per
// two samples (F2IP); the epilogue compiles to 8.6 instructions a sample,
// where the one that divided, clamped and selected took 35.
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
// the encoder's tiles
constexpr int IN_STRIDE = TILE_BYTES + 4;       // 9 words: odd
constexpr int OUT_WORDS = TILE_BYTES * 2;       // 8 int8 samples = 2 words per byte
// the decoder's tiles: rows of 16-byte words
constexpr int DEC_IN_STRIDE = TILE_BYTES + 16;  // bytes; 12 words
constexpr int DEC_OUT_STRIDE = OUT_WORDS + 4;   // 68 words: 4 more than a multiple of 32
constexpr int DEC_OUT_VECS = OUT_WORDS / 4;     // 16-byte words per row of the sample tile
constexpr long long RAMP_EXACT_SAMPLES = 1LL << 24;  // a float counts this far by + 1.0f

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

// A lane whose words start in these ranges keeps them there: the charge
// moves toward -128 or 127 by at most the distance (strength <= 1023 of
// 1024), the antijerk average lies between two charges, the lowpass moves
// toward it by 140/256 of the distance.
__device__ __forceinline__ bool tame(const Lane& st) {
  const auto in8 = [](int v) { return static_cast<unsigned>(v + 128) < 256u; };
  return in8(st.q) && in8(st.pq) && in8(st.lp) &&
         static_cast<unsigned>(st.s) <= static_cast<unsigned>(STRENGTH_MAX);
}

// d = bytes {sat8(lo), sat8(hi), upper's low 16 bits}, lowest byte first.
__device__ __forceinline__ uint32_t pack_sat8(int lo, int hi, uint32_t upper) {
  uint32_t d;
  asm("cvt.pack.sat.s8.s32.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(hi), "r"(lo), "r"(upper));
  return d;
}

// The fused epilogue's state of one lane. RAMP: 0 no gain input, 1 the
// ramp's time counted in float, 2 converted from the 64-bit sample index.
struct Dsp {
  float prevf, alpha, g0, gs, t;
  uint32_t live;  // all ones, or zero for a masked lane
};

// Decodes one byte into 8 samples as two words, lowest byte first. DSP: the
// fused epilogue of _decode_dsp_kernel (dfpwm_pallas.py:178-213). TABLE: the
// lane is tame, so norm8 is tab[lp + 128].
template <bool DSP, int RAMP, bool TABLE>
__device__ __forceinline__ void decode_byte(Lane& st, Dsp& e, const float* __restrict__ tab,
                                            int byte, long long sample0, uint32_t& w0,
                                            uint32_t& w1) {
  int v[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int lp = decode_bit(st, (byte >> k) & 1);
    if (DSP) {
      const float f = TABLE ? tab[lp + 128] : norm8(lp);
      float o = __fmaf_rn(e.alpha, __fsub_rn(f, e.prevf), e.prevf);
      if (RAMP == 1) {
        o = __fmul_rn(o, __fmaf_rn(e.gs, e.t, e.g0));
        e.t = __fadd_rn(e.t, 1.0f);
      } else if (RAMP == 2) {
        o = __fmul_rn(o, __fmaf_rn(e.gs, static_cast<float>(sample0 + k), e.g0));
      }
      // 128 for o < 0, else 127 (-0.0 and a negative NaN take 128: their
      // products are the same -0.0 and NaN)
      const float half = __uint_as_float((__float_as_uint(o) & 0x80000000u) | 0x3f000000u);
      o = __fmul_rn(o, __fsub_rn(127.5f, half));
      v[k] = __float2int_rz(o);  // saturates to int32; NaN -> 0
      e.prevf = f;
    } else {
      v[k] = lp;
    }
  }
  if (DSP) {
    // saturation to int8 here and to int32 above equal clamp(-128, 127)
    // before the truncation
    w0 = pack_sat8(v[0], v[1], pack_sat8(v[2], v[3], 0u)) & e.live;
    w1 = pack_sat8(v[4], v[5], pack_sat8(v[6], v[7], 0u)) & e.live;
  } else {
    // the raw lowpass word wraps to int8, as astype(int8) does
    w0 = __byte_perm(__byte_perm(v[0], v[1], 0x0040), __byte_perm(v[2], v[3], 0x0040), 0x5410);
    w1 = __byte_perm(__byte_perm(v[4], v[5], 0x0040), __byte_perm(v[6], v[7], 0x0040), 0x5410);
  }
}

// One lane's nb bytes of a tile: in (its row of the byte tile) -> out (its
// row of the sample tile), two bytes per 16-byte word.
template <bool DSP, int RAMP, bool TABLE>
__device__ __forceinline__ void decode_row(Lane& st, Dsp& e, const float* __restrict__ tab,
                                           const uint8_t* __restrict__ in,
                                           uint32_t* __restrict__ out, int nb,
                                           long long sample0) {
  int j = 0;
  for (; j + 1 < nb; j += 2) {
    const int pair = *reinterpret_cast<const uint16_t*>(in + j);
    uint4 w;
    decode_byte<DSP, RAMP, TABLE>(st, e, tab, pair & 0xff, sample0 + 8 * j, w.x, w.y);
    decode_byte<DSP, RAMP, TABLE>(st, e, tab, pair >> 8, sample0 + 8 * j + 8, w.z, w.w);
    *reinterpret_cast<uint4*>(out + 2 * j) = w;
  }
  if (j < nb) {
    uint2 w;
    decode_byte<DSP, RAMP, TABLE>(st, e, tab, in[j], sample0 + 8 * j, w.x, w.y);
    *reinterpret_cast<uint2*>(out + 2 * j) = w;
  }
}

// vec_in: rows of bytes start on 16-byte boundaries (nbytes % 16 == 0 and the
// base does); vec_out: rows of samples do (nbytes even). The launcher decides.
template <bool DSP, int RAMP>
__global__ void __launch_bounds__(LANES)
dfpwm_decode_kernel(const uint8_t* __restrict__ bytes,
                    const int32_t* __restrict__ state_in,
                    int8_t* __restrict__ out, int32_t* __restrict__ state_out,
                    int lanes, long long nbytes, float alpha,
                    const bool* __restrict__ mask,
                    const float* __restrict__ gain0,
                    const float* __restrict__ gain_slope, bool vec_in, bool vec_out) {
  __shared__ uint4 in_tile[LANES * DEC_IN_STRIDE / 16];
  __shared__ uint4 out_tile[LANES * DEC_OUT_STRIDE / 4];
  __shared__ float norm_tab[DSP ? 256 : 1];
  uint8_t* in_b = reinterpret_cast<uint8_t*>(in_tile);
  uint32_t* out_w = reinterpret_cast<uint32_t*>(out_tile);

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
  Dsp e{norm8(st.lp), alpha, 1.0f, 0.0f, 0.0f, 0xffffffffu};
  if (DSP && active && mask != nullptr && !mask[lane]) e.live = 0u;
  if (RAMP != 0 && active) {
    e.g0 = gain0[lane];
    e.gs = gain_slope[lane];
  }
  const bool table = DSP && tame(st);
  if (DSP) {
    for (int i = tid; i < 256; i += LANES) norm_tab[i] = norm8(i - 128);
  }

  for (long long b0 = 0; b0 < nbytes; b0 += TILE_BYTES) {
    const int nb = static_cast<int>(min(static_cast<long long>(TILE_BYTES), nbytes - b0));
    if (vec_in) {
#pragma unroll
      for (int k = 0; k < TILE_BYTES / 16; ++k) {
        const int i = tid + k * LANES;
        const int r = i / (TILE_BYTES / 16), c = i % (TILE_BYTES / 16);
        if (r < nlanes && 16 * c < nb) {
          in_tile[r * (DEC_IN_STRIDE / 16) + c] =
              *reinterpret_cast<const uint4*>(bytes + (lane0 + r) * nbytes + b0 + 16 * c);
        }
      }
    } else {
      for (int i = tid; i < nlanes * TILE_BYTES; i += LANES) {
        const int r = i / TILE_BYTES, c = i % TILE_BYTES;
        if (c < nb) in_b[r * DEC_IN_STRIDE + c] = bytes[(lane0 + r) * nbytes + b0 + c];
      }
    }
    __syncthreads();  // also: the table is filled before the first tile
    if (active) {
      const uint8_t* row_in = in_b + tid * DEC_IN_STRIDE;
      uint32_t* row_out = out_w + tid * DEC_OUT_STRIDE;
      if (table) {
        decode_row<DSP, RAMP, true>(st, e, norm_tab, row_in, row_out, nb, b0 * 8);
      } else {
        decode_row<DSP, RAMP, false>(st, e, norm_tab, row_in, row_out, nb, b0 * 8);
      }
    }
    __syncthreads();
    if (vec_out) {
      // nbytes is even and b0 a multiple of 32, so nb is even: nb / 2 words
#pragma unroll
      for (int k = 0; k < DEC_OUT_VECS; ++k) {
        const int i = tid + k * LANES;
        const int r = i / DEC_OUT_VECS, c = i % DEC_OUT_VECS;
        if (r < nlanes && 2 * c < nb) {
          uint4* row = reinterpret_cast<uint4*>(out + ((lane0 + r) * nbytes + b0) * 8);
          row[c] = out_tile[r * (DEC_OUT_STRIDE / 4) + c];
        }
      }
    } else {
      const int words = 2 * nb;
      for (int i = tid; i < nlanes * words; i += LANES) {
        const int r = i / words, c = i % words;
        uint32_t* row = reinterpret_cast<uint32_t*>(out + ((lane0 + r) * nbytes + b0) * 8);
        row[c] = out_w[r * DEC_OUT_STRIDE + c];
      }
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

// Launches the decoder's instantiation for this call: the ramp's time in
// float while it is exact, 16-byte staging where the rows allow it.
template <bool DSP>
int launch_decode(const void* bytes, const void* state_in, void* out, void* state_out, int lanes,
                  long long nbytes, float alpha, const void* mask, const void* gain0,
                  const void* gain_slope, void* stream) {
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const bool vec_in = nbytes % 16 == 0 && aligned(bytes);
  const bool vec_out = nbytes % 2 == 0 && aligned(out);
  const auto run = [&](auto kernel) {
    kernel<<<blocks_for(lanes), LANES, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(bytes), static_cast<const int32_t*>(state_in),
        static_cast<int8_t*>(out), static_cast<int32_t*>(state_out), lanes, nbytes, alpha,
        static_cast<const bool*>(mask), static_cast<const float*>(gain0),
        static_cast<const float*>(gain_slope), vec_in, vec_out);
  };
  if constexpr (DSP) {
    if (gain0 != nullptr) {
      if (nbytes * 8 <= RAMP_EXACT_SAMPLES) {
        run(dfpwm_decode_kernel<true, 1>);
      } else {
        run(dfpwm_decode_kernel<true, 2>);
      }
      return static_cast<int>(cudaGetLastError());
    }
  }
  run(dfpwm_decode_kernel<DSP, 0>);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bytes u8[L,B], state_in/state_out i32[5,L], out i8[L,8B]; all contiguous.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int aukit_dfpwm_decode(const void* bytes, const void* state_in,
                                  void* out, void* state_out, int lanes,
                                  long long nbytes, void* stream) {
  return launch_decode<false>(bytes, state_in, out, state_out, lanes, nbytes, 0.0f, nullptr,
                              nullptr, nullptr, stream);
}

// As aukit_dfpwm_decode, with the fused epilogue. mask: bool[L] or null
// (all live). gain0/gain_slope: f32[L] each, or both null (no gain input).
extern "C" int aukit_dfpwm_decode_dsp(const void* bytes, const void* state_in,
                                      void* out, void* state_out, int lanes,
                                      long long nbytes, float alpha,
                                      const void* mask, const void* gain0,
                                      const void* gain_slope, void* stream) {
  return launch_decode<true>(bytes, state_in, out, state_out, lanes, nbytes, alpha, mask, gain0,
                             gain_slope, stream);
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
