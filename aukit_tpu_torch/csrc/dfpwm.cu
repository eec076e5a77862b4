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
// every warp load touch 32 rows, so a block of one warp stages TILE_BYTES
// bytes of each of its rows in shared memory and writes its samples back
// through a tile of samples, along each row. The byte tiles come through a
// ring of DEC_STAGES, fetched by cp.async 16 bytes a copy two tiles ahead of
// the one being decoded (rows whose length is a multiple of 16 from an
// aligned base; any other row is copied byte by byte, at the same point of
// the loop). A lane decodes two bytes into one 16-byte word of the sample
// tile, whose rows are 68 words, 4 more than a multiple of 32, so a quarter
// warp's 16-byte accesses cover all 32 banks whether eight lanes write their
// own rows or eight threads read along one row. The warp then stores the
// tile 16 bytes a store (even row lengths from an aligned base, so that
// every row of samples starts on a 16-byte boundary; 4 bytes else) and goes
// on to the next tile while those stores are on their way; the ragged last
// tile runs the same code with a shorter count. Only the warp's own barrier
// (__syncwarp) orders the tiles. The ring is the decoder's own, not
// lane_scan.cuh's window_rows: a byte in gives eight samples out, and an
// output side eight times as wide as window_rows' 128-element tiles would
// be 32 KB a warp; here the bytes' tile is 32 a row and the samples' 256.
// The encoder (below, at its kernel) runs on the pipelined skeleton
// ring_rows of lane_scan.cuh: its wide side is the input.
//
// What bounds the decoder on the H100 (measured: PERF.md). Per 8 samples a
// lane reads 1 byte and writes 8, far under the memory rate: instructions
// bound it. One thread per lane gives 32768 lanes = 1024 warps, two per
// scheduler, and the mixed fleet's 16384 lanes one, which issues an
// instruction every other cycle at best and hides nothing behind another
// warp: so the design spends few instructions a sample and keeps the chains
// from one sample to the next shorter than those instructions.
//   - A tame lane (charge, previous charge and lowpass in [-128, 127],
//     strength in [0, 1023], previous bit 0 or 1: every state a stream
//     produces, and a tame lane stays tame; tested once a call) takes a
//     short step. A byte's bit flips (bit ^ previous bit) are spread once
//     into masks, one PRMT a sample takes out the next, and the target
//     (127 or -128, all ones apart) flips with them, so nothing selects on
//     the bit. t = strength * (target - charge) + 512, the move is t >> 10
//     added to the charge (one LEA.HI), and the stall nudge (a move of 0
//     short of the target becomes one step toward it) is
//     min(max(target, charge - 1), charge + 1), taken where t lies in
//     [0, 1023]. The strength is clamp(strength + 1 + 2 * flip mask, 8,
//     1023), the antijerk a mask select. The tame step compiles to 19.9
//     instructions a sample, 13.9 on the integer pipe (predict()'s: 25.7);
//     its chain from charge to charge is subtract, multiply-add, compare,
//     shift-and-add.
//   - Any other lane runs predict(), exact for every int32 state.
// A block's work split over two warps (one running the charge and the
// strength, one the antijerk, the lowpass and the stores, charges handed
// over in shared memory) was slower at 16384 and at 32768 lanes (PERF.md):
// it adds instructions, and two warps a scheduler already fill the integer
// pipe.
//
// The fused epilogue (dfpwm_decode_dsp) is off that chain: it reads only the
// sequence of lowpass words. So its cost is instruction slots, and its design
// is to spend few, and those on the float pipe, the load unit and the
// conversion unit, which the recurrence leaves idle:
//   - the normalisation v / (v < 0 ? 128 : 127) is a lookup in a 256-entry
//     table in shared memory that each block fills with the same IEEE
//     division. A tame lane keeps its lowpass word in [-128, 127] for ever
//     (every update moves a word toward a target in that range), so the
//     range is checked once per call and lane, not per sample; any other
//     lane divides, as the plain version does;
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
// two samples (F2IP); the epilogue compiles to 8.3 instructions a sample
// (the tame fused loop's 28.2 less the raw loop's 19.9), where the one that
// divided, clamped and selected took 35.
//
// Exactness. Integer semantics are those of _decode_tile (int32, arithmetic
// right shifts -- what nvcc does for signed >>, round-half-up at PREC). The
// epilogue is compared bit for bit with the JAX engine's jitted step, where
// XLA fuses each multiply that feeds an add into one fused multiply-add: the
// smoothing prev + alpha*(cur - prev) and the ramp g0 + slope*t are
// __fmaf_rn here, every other op a separately rounded _rn intrinsic, the
// normalisation an IEEE division. The build passes --fmad=false, so nvcc
// contracts nothing else, and never --use_fast_math.

#include "lane_scan.cuh"

namespace {

using aukit::clamp_int;

constexpr int PREC = 10;
constexpr int PREC_HALF = 1 << (PREC - 1);
constexpr int STRENGTH_MAX = (1 << PREC) - 1;
constexpr int STRENGTH_MIN = 1 << (PREC - 7);
constexpr int LOWPASS_NUM = 140;

constexpr int LANES = 32;                       // threads (= lanes) per block: one warp
constexpr int TILE_BYTES = 32;                  // bytes per lane per tile: 256 samples
constexpr int DEC_STAGES = 3;                   // byte tiles: one decoding, two in flight
constexpr int OUT_WORDS = TILE_BYTES * 2;       // 8 int8 samples = 2 words per byte
// the decoder's tiles: rows of 16-byte words
constexpr int DEC_IN_STRIDE = TILE_BYTES + 16;  // bytes; 12 words
constexpr int DEC_IN_VECS = TILE_BYTES / 16;    // 16-byte words per row of a byte tile
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

// One bit of a tame lane (see tame()): decode_bit's result in fewer
// instructions and a shorter chain. ``target``: the bit's, 127 or -128;
// ``flip``: bit ^ previous bit as a mask, 0 or -1, so nothing selects on it.
__device__ __forceinline__ int decode_bit_tame(Lane& st, int target, int flip) {
  // the move is t >> PREC; |t| < 2^19
  const int t = st.s * (target - st.q) + PREC_HALF;
  // a move of 0 short of the target is one step toward it; at the target, none
  const int nq = static_cast<unsigned>(t) < (1u << PREC) ? min(max(target, st.q - 1), st.q + 1)
                                                         : st.q + (t >> PREC);
  st.s = clamp_int(st.s + 1 + 2 * flip, STRENGTH_MIN, STRENGTH_MAX);
  // the antijerk average where the bit flipped, else the charge
  const int aj = (((nq + st.pq + 1) >> 1) & flip) | (nq & ~flip);
  st.lp += ((aj - st.lp) * LOWPASS_NUM + 0x80) >> 8;
  st.q = st.pq = nq;
  return st.lp;
}

// The 8 bits of a byte in two words, bit k in the top bit of byte k % 4 of
// word k / 4: the byte in every byte, bit k of byte k isolated, and a carry
// into the byte's top bit added (0x80 less the bit's weight).
__device__ __forceinline__ void spread_bits(int byte, uint32_t (&w)[2]) {
  const uint32_t x = static_cast<uint32_t>(byte) * 0x01010101u;
  w[0] = (x & 0x08040201u) + 0x787c7e7fu;
  w[1] = (x & 0x80402010u) + 0x00406070u;
}

// The top bit of byte k of w as a mask, 0 or -1: one PRMT (selector 8 + k
// replicates byte k's sign into every byte).
__device__ __forceinline__ int byte_sign(uint32_t w, int k) {
  int d;
  asm("prmt.b32 %0, %1, %1, %2;" : "=r"(d) : "r"(w), "r"(0x8888 + 0x1111 * k));
  return d;
}

__device__ __forceinline__ float norm8(int v) {
  return __fdiv_rn(static_cast<float>(v), v < 0 ? 128.0f : 127.0f);
}

// A lane whose words start in these ranges keeps them there: the charge
// moves toward -128 or 127 by at most the distance (strength <= 1023 of
// 1024), the antijerk average lies between two charges, the lowpass moves
// toward it by 140/256 of the distance, the strength stays in [8, 1023] and
// the previous bit is a bit. Such a lane takes decode_bit_tame, and the
// fused epilogue's table of its 256 lowpass words.
__device__ __forceinline__ bool tame(const Lane& st) {
  const auto in8 = [](int v) { return static_cast<unsigned>(v + 128) < 256u; };
  return in8(st.q) && in8(st.pq) && in8(st.lp) &&
         static_cast<unsigned>(st.s) <= static_cast<unsigned>(STRENGTH_MAX) &&
         static_cast<unsigned>(st.lb) <= 1u;
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
// fused epilogue of _decode_dsp_kernel (dfpwm_pallas.py:178-213). TAME: the
// lane is tame, so it takes decode_bit_tame and norm8 is tab[lp + 128].
template <bool DSP, int RAMP, bool TAME>
__device__ __forceinline__ void decode_byte(Lane& st, Dsp& e, const float* __restrict__ tab,
                                            int byte, long long sample0, uint32_t& w0,
                                            uint32_t& w1) {
  // bit k of flips: bit k of the byte differs from the bit before it, as
  // masks in the top bits of bytes (tame: the previous bit is a bit). The
  // target (127 or -128, all ones apart) flips with the bit.
  uint32_t flips[2];
  int target = 0;
  if (TAME) {
    spread_bits((byte ^ ((byte << 1) | st.lb)) & 0xff, flips);
    target = -st.lb ^ -128;
    st.lb = byte >> 7;
  }
  int v[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    int lp;
    if (TAME) {
      const int flip = byte_sign(flips[k / 4], k % 4);
      target ^= flip;
      lp = decode_bit_tame(st, target, flip);
    } else {
      lp = decode_bit(st, (byte >> k) & 1);
    }
    if (DSP) {
      const float f = TAME ? tab[lp + 128] : norm8(lp);
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
template <bool DSP, int RAMP, bool TAME>
__device__ __forceinline__ void decode_row(Lane& st, Dsp& e, const float* __restrict__ tab,
                                           const uint8_t* __restrict__ in,
                                           uint32_t* __restrict__ out, int nb,
                                           long long sample0) {
  int j = 0;
  for (; j + 1 < nb; j += 2) {
    const int pair = *reinterpret_cast<const uint16_t*>(in + j);
    uint4 w;
    decode_byte<DSP, RAMP, TAME>(st, e, tab, pair & 0xff, sample0 + 8 * j, w.x, w.y);
    decode_byte<DSP, RAMP, TAME>(st, e, tab, pair >> 8, sample0 + 8 * j + 8, w.z, w.w);
    *reinterpret_cast<uint4*>(out + 2 * j) = w;
  }
  if (j < nb) {
    uint2 w;
    decode_byte<DSP, RAMP, TAME>(st, e, tab, in[j], sample0 + 8 * j, w.x, w.y);
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
  __shared__ uint4 ring[DEC_STAGES][LANES * DEC_IN_STRIDE / 16];
  __shared__ uint4 out_tile[LANES * DEC_OUT_STRIDE / 4];
  __shared__ float norm_tab[DSP ? 256 : 1];
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
  const bool is_tame = tame(st);
  if (DSP) {
    for (int i = tid; i < 256; i += LANES) norm_tab[i] = norm8(i - 128);
  }

  // this thread's 16-byte piece (tid % DEC_IN_VECS) of its rows of every
  // byte tile, rows tid / DEC_IN_VECS + p * IN_PASS, and of every sample
  // tile, rows tid / DEC_OUT_VECS + p * OUT_PASS: addresses of tile 0, once
  constexpr int IN_PASS = LANES / DEC_IN_VECS, OUT_PASS = LANES / DEC_OUT_VECS;
  const int in_c = tid % DEC_IN_VECS, in_r = tid / DEC_IN_VECS;
  const int out_c = tid % DEC_OUT_VECS, out_r = tid / DEC_OUT_VECS;
  const uint8_t* src = bytes + static_cast<long long>(lane0 + in_r) * nbytes + 16 * in_c;
  uint4* dst = reinterpret_cast<uint4*>(out + static_cast<long long>(lane0 + out_r) * nbytes * 8) +
               out_c;
  const long long ntiles = (nbytes + TILE_BYTES - 1) / TILE_BYTES;

  // one commit group per tile, also past the end, so the groups count alike
  const auto fetch = [&](long long n, int stage) {
    if (n < ntiles) {
      const long long b0 = n * TILE_BYTES;
      const int nb = static_cast<int>(min(static_cast<long long>(TILE_BYTES), nbytes - b0));
      uint8_t* tile = reinterpret_cast<uint8_t*>(ring[stage]);
      if (vec_in) {
        if (16 * in_c < nb) {
#pragma unroll
          for (int p = 0; p < DEC_IN_VECS; ++p) {
            const int r = in_r + p * IN_PASS;
            if (r < nlanes) {
              aukit::cp_async<4>(tile + r * DEC_IN_STRIDE + 16 * in_c,
                                 src + p * IN_PASS * nbytes + b0);
            }
          }
        }
      } else {
        for (int i = tid; i < nlanes * TILE_BYTES; i += LANES) {
          const int r = i / TILE_BYTES, c = i % TILE_BYTES;
          if (c < nb) tile[r * DEC_IN_STRIDE + c] = bytes[(lane0 + r) * nbytes + b0 + c];
        }
      }
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };

  fetch(0, 0);
  fetch(1, 1);
  int stage = 0;  // of tile n
  for (long long n = 0; n < ntiles; ++n) {
    const long long b0 = n * TILE_BYTES;
    const int nb = static_cast<int>(min(static_cast<long long>(TILE_BYTES), nbytes - b0));
    asm volatile("cp.async.wait_group 1;" ::: "memory");  // this thread's copies of tile n
    // every lane's copies of tile n have landed; tile n - 1 is decoded and
    // stored: its byte stage and the sample tile are free (also: the table
    // is filled before the first tile)
    __syncwarp();
    fetch(n + 2, (stage + 2) % DEC_STAGES);
    if (active) {
      const uint8_t* row_in = reinterpret_cast<const uint8_t*>(ring[stage]) + tid * DEC_IN_STRIDE;
      uint32_t* row_out = out_w + tid * DEC_OUT_STRIDE;
      if (is_tame) {
        decode_row<DSP, RAMP, true>(st, e, norm_tab, row_in, row_out, nb, b0 * 8);
      } else {
        decode_row<DSP, RAMP, false>(st, e, norm_tab, row_in, row_out, nb, b0 * 8);
      }
    }
    __syncwarp();
    if (vec_out) {
      // nbytes is even and b0 a multiple of 32, so nb is even: nb / 2 words
      if (2 * out_c < nb) {
#pragma unroll
        for (int p = 0; p < LANES / OUT_PASS; ++p) {
          const int r = out_r + p * OUT_PASS;
          if (r < nlanes) {
            // OUT_PASS rows of 8 * nbytes samples are nbytes 16-byte words
            dst[p * OUT_PASS / 2 * nbytes + n * DEC_OUT_VECS] =
                out_tile[r * (DEC_OUT_STRIDE / 4) + out_c];
          }
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
    stage = (stage + 1) % DEC_STAGES;
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
// mirror: the input is the wide side, 8 int8 levels in for each byte out.
// The bit is 1 iff level > charge, or level == charge == 127 (silence then
// encodes to alternating bits); the predictor follows the bit as in the
// decoder; 8 bits pack LSB first. State: charge, strength, previous bit.
//
// What bounds it on the H100 (measured: PERF.md). A sample is 9/8 of a byte
// moved and one step of a recurrence whose bit depends on the charge, so a
// step is one dependent chain and the lanes are its only parallelism. A
// transcode window launches it on 16384 and on 8192 lanes, one warp or none
// a scheduler, where nothing hides a tile's loads or the chain's latency:
// hence the ring and the short chain below.
// With the levels arriving ahead of the lane, what is left is the step's own
// instructions: 22.8 a sample, 18.6 of them on the integer pipe, which starts
// a warp's instruction every other cycle. That is 35-45 cycles a sample a
// warp at every width: two warps a scheduler share the pipe (32768 lanes),
// one warp runs at its own pace (16384), and at 8192 lanes half of the
// schedulers have none, which no design of the kernel can fill.
//
// Design.
//   - The levels move through ring_rows (lane_scan.cuh): a row is its int8
//     levels as 4-byte words, a tile 64 words = 256 levels = 32 bytes out,
//     fetched by cp.async two tiles ahead (16 bytes a copy when the byte
//     count is even and the base aligned, so rows start on 16-byte
//     boundaries; 8 or 4 bytes otherwise), in blocks of one warp, so 8192
//     lanes are 256 blocks on 132 SMs. A lane reads 32 levels as two 16-byte words
//     of shared memory, leaves their 32 bits as one word at the head of its
//     row (behind its own reads), and the warp stores the 32 bytes of each
//     row 16 bytes a store (byte count a multiple of 16, aligned base), 4, or
//     a byte at a time, a thread keeping its column down the rows.
//   - The step of a tame lane (charge in [-128, 127], strength in [0, 1023],
//     previous bit 0 or 1: every state a stream produces, and a lane that
//     starts so stays so, see tame()) is written for a short chain: the
//     charge's next value is computed for both targets side by side (two
//     multiply-adds, two shifts), each with its stall nudge as one max or min
//     (the move toward 127 is never negative, so "a move of 0 short of the
//     target becomes 1" is max(move, min(distance, 1)); the mirror toward
//     -128), and the bit, level > charge or level == 127, is compared in
//     their shadow and selects one. The chain from charge to charge is then
//     subtract, multiply-add, shift, max, select, add: 6 instructions where
//     the predictor's compare -> target -> ... -> nudge compares had ~10.
//     The strength is clamp(strength + 1 - 2 * (bit ^ previous), 8, 1023).
//     The speculation costs instructions (22.8 a sample against 17.8 without
//     it) and still wins at every width (PERF.md). Any other lane runs the
//     decoder's predict(), exact for every int32 state; the state is tested
//     once a call.
constexpr int ENC_TILE_BYTES = aukit::ASYNC_TILE / 2;  // bytes out per lane per tile

struct Enc {
  int q, s, lb;
};

__device__ __forceinline__ bool tame(const Enc& st) {
  return static_cast<unsigned>(st.q + 128) < 256u &&
         static_cast<unsigned>(st.s) <= static_cast<unsigned>(STRENGTH_MAX) &&
         static_cast<unsigned>(st.lb) <= 1u;
}

// One sample -> its bit.
template <bool TAME>
__device__ __forceinline__ int encode_step(Enc& st, int level) {
  if (TAME) {
    // both targets' moves side by side, the bit's compare in their shadow.
    // The move toward 127 is >= 0 and toward -128 <= 0, so the stall nudge
    // (a move of 0 short of the target becomes 1) is a max or a min with the
    // distance clamped to one step.
    const int a1 = 127 - st.q, a0 = a1 - 255;
    const int d1 = (st.s * a1 + PREC_HALF) >> PREC, d0 = (st.s * a0 + PREC_HALF) >> PREC;
    const int m1 = max(d1, min(a1, 1)), m0 = min(d0, max(a0, -1));
    const int bit = (level > st.q || level == 127) ? 1 : 0;  // charge <= 127
    st.q += bit ? m1 : m0;
    st.s = min(max(st.s + 1 - 2 * (bit ^ st.lb), STRENGTH_MIN), STRENGTH_MAX);
    st.lb = bit;
    return bit;
  }
  const int bit = (level > st.q || (level == st.q && st.q == 127)) ? 1 : 0;
  predict(st.q, st.s, st.lb, bit);
  st.lb = bit;
  return bit;
}

// Byte k of w, sign-extended: one PRMT (selector 8 + k replicates byte k's sign).
__device__ __forceinline__ int sext_byte(uint32_t w, int k) {
  int d;
  asm("prmt.b32 %0, %1, %1, %2;" : "=r"(d) : "r"(w), "r"(0x8880 + 0x1111 * k));
  return d;
}

// WORDS words of 4 levels each -> their 4 * WORDS bits, first sample lowest.
template <bool TAME, int WORDS>
__device__ __forceinline__ uint32_t encode_words(Enc& st, const uint32_t (&w)[WORDS]) {
  uint32_t bits = 0;
#pragma unroll
  for (int i = 0; i < 4 * WORDS; ++i) {
    const int level = sext_byte(w[i >> 2], i & 3);
    bits |= static_cast<uint32_t>(encode_step<TAME>(st, level)) << i;
  }
  return bits;
}

struct EncLane {
  Enc st;
  long long nbytes;
  bool is_tame;

  template <bool TAME>
  __device__ __forceinline__ void run(uint32_t* row, int nb) {
    if (nb == ENC_TILE_BYTES) {
#pragma unroll 1
      for (int i = 0; i < ENC_TILE_BYTES / 4; ++i) {
        const uint4 u = *reinterpret_cast<const uint4*>(row + 8 * i);
        const uint4 v = *reinterpret_cast<const uint4*>(row + 8 * i + 4);
        const uint32_t w[8] = {u.x, u.y, u.z, u.w, v.x, v.y, v.z, v.w};
        row[i] = encode_words<TAME>(st, w);  // words 0..8i+7 are read: i is free
      }
    } else {  // the ragged last tile, a byte at a time
      uint8_t* out = reinterpret_cast<uint8_t*>(row);
#pragma unroll 1
      for (int j = 0; j < nb; ++j) {
        const uint32_t w[2] = {row[2 * j], row[2 * j + 1]};
        out[j] = static_cast<uint8_t>(encode_words<TAME>(st, w));
      }
    }
  }

  // One tile of the row: 64 words of levels in, ENC_TILE_BYTES bytes left at
  // the row's head. t0 counts words: byte t0 / 2 of the lane's output.
  __device__ __forceinline__ void tile(uint32_t* row, long long t0) {
    const int nb = static_cast<int>(min(static_cast<long long>(ENC_TILE_BYTES), nbytes - t0 / 2));
    if (is_tame) {
      run<true>(row, nb);
    } else {
      run<false>(row, nb);
    }
  }
};

// The bytes at the head of each of the tile's rows -> out[L, nbytes], WIDTH
// (16, 4 or 1) bytes a store; nb (a multiple of WIDTH) bytes a row.
template <int WIDTH>
__device__ __forceinline__ void store_bytes(const uint32_t* tile, uint8_t* __restrict__ dst,
                                            long long nbytes, int nlanes, int nb) {
  constexpr int PER_ROW = ENC_TILE_BYTES / WIDTH;          // stores per row
  constexpr int ROWS = aukit::ASYNC_LANES / PER_ROW;       // rows per pass
  const int c = (threadIdx.x % PER_ROW) * WIDTH, r0 = threadIdx.x / PER_ROW;
  if (c >= nb) return;
  const uint8_t* src = reinterpret_cast<const uint8_t*>(tile) + c;
#pragma unroll 8
  for (int k = 0; k < aukit::ASYNC_LANES / ROWS; ++k) {
    const int r = r0 + k * ROWS;
    if (r < nlanes) {
      const uint8_t* from = src + r * (aukit::ASYNC_STRIDE * 4);
      uint8_t* to = dst + r * nbytes + c;
      if (WIDTH == 16) {
        *reinterpret_cast<uint4*>(to) = *reinterpret_cast<const uint4*>(from);
      } else if (WIDTH == 4) {
        *reinterpret_cast<uint32_t*>(to) = *reinterpret_cast<const uint32_t*>(from);
      } else {
        *to = *from;
      }
    }
  }
}

// in_width: 4-byte words a copy of the levels (aukit::copy_width); out_width:
// 16, 4 or 1 bytes a store. The launcher decides both.
__global__ void __launch_bounds__(aukit::ASYNC_LANES)
dfpwm_encode_kernel(const uint32_t* __restrict__ levels,
                    const int32_t* __restrict__ state_in,
                    uint8_t* __restrict__ out, int32_t* __restrict__ state_out,
                    int lanes, long long nbytes, int in_width, int out_width) {
  const int lane = blockIdx.x * aukit::ASYNC_LANES + threadIdx.x;
  const bool active = lane < lanes;
  EncLane e{{0, 0, 0}, nbytes, true};
  if (active) {
    e.st.q = state_in[lane];
    e.st.s = state_in[lanes + lane];
    e.st.lb = state_in[2 * lanes + lane];
  }
  e.is_tame = tame(e.st);

  aukit::ring_rows(levels, lanes, 2 * nbytes, in_width, e,
                   [=](const uint32_t* tile, int lane0, int nlanes, long long t0, int nt) {
                     uint8_t* dst = out + static_cast<long long>(lane0) * nbytes + t0 / 2;
                     if (out_width == 16) {
                       store_bytes<16>(tile, dst, nbytes, nlanes, nt / 2);
                     } else if (out_width == 4) {
                       store_bytes<4>(tile, dst, nbytes, nlanes, nt / 2);
                     } else {
                       store_bytes<1>(tile, dst, nbytes, nlanes, nt / 2);
                     }
                   });

  if (active) {
    state_out[lane] = e.st.q;
    state_out[lanes + lane] = e.st.s;
    state_out[2 * lanes + lane] = e.st.lb;
  }
}

int blocks_for(int lanes) { return (lanes + LANES - 1) / LANES; }

// One launch of an instantiation of the decoder. 32768 lanes are 7.8 blocks
// an SM: their rings need the SM's shared memory as shared memory, set once
// a kernel (aukit::prefer_shared_carveout, kept in a function-local static).
template <bool DSP, int RAMP>
int run_decode(const void* bytes, const void* state_in, void* out, void* state_out, int lanes,
               long long nbytes, float alpha, const void* mask, const void* gain0,
               const void* gain_slope, void* stream, bool vec_in, bool vec_out) {
  static const cudaError_t prepared =
      aukit::prefer_shared_carveout(dfpwm_decode_kernel<DSP, RAMP>);
  if (prepared != cudaSuccess) return static_cast<int>(prepared);
  dfpwm_decode_kernel<DSP, RAMP><<<blocks_for(lanes), LANES, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(bytes), static_cast<const int32_t*>(state_in),
      static_cast<int8_t*>(out), static_cast<int32_t*>(state_out), lanes, nbytes, alpha,
      static_cast<const bool*>(mask), static_cast<const float*>(gain0),
      static_cast<const float*>(gain_slope), vec_in, vec_out);
  return static_cast<int>(cudaGetLastError());
}

// Launches the decoder's instantiation for this call: the ramp's time in
// float while it is exact, 16-byte staging where the rows allow it.
template <bool DSP>
int launch_decode(const void* bytes, const void* state_in, void* out, void* state_out, int lanes,
                  long long nbytes, float alpha, const void* mask, const void* gain0,
                  const void* gain_slope, void* stream) {
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const bool vec_in = nbytes % 16 == 0 && aligned(bytes);
  const bool vec_out = nbytes % 2 == 0 && aligned(out);
  if constexpr (DSP) {
    if (gain0 != nullptr) {
      if (nbytes * 8 <= RAMP_EXACT_SAMPLES) {
        return run_decode<true, 1>(bytes, state_in, out, state_out, lanes, nbytes, alpha, mask,
                                   gain0, gain_slope, stream, vec_in, vec_out);
      }
      return run_decode<true, 2>(bytes, state_in, out, state_out, lanes, nbytes, alpha, mask,
                                 gain0, gain_slope, stream, vec_in, vec_out);
    }
  }
  return run_decode<DSP, 0>(bytes, state_in, out, state_out, lanes, nbytes, alpha, mask, gain0,
                            gain_slope, stream, vec_in, vec_out);
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
  const auto aligned = [](const void* p, int n) { return reinterpret_cast<uintptr_t>(p) % n == 0; };
  // a row of levels is 2 * nbytes words
  const int in_width = aukit::copy_width(2 * nbytes, levels, levels);
  const int out_width = nbytes % 16 == 0 && aligned(out, 16) ? 16
                        : nbytes % 4 == 0 && aligned(out, 4) ? 4 : 1;
  // 32768 lanes are 7.8 blocks per SM: their rings need the SM's whole shared memory
  cudaFuncSetAttribute(dfpwm_encode_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                       cudaSharedmemCarveoutMaxShared);
  dfpwm_encode_kernel<<<aukit::async_blocks(lanes), aukit::ASYNC_LANES, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(levels), static_cast<const int32_t*>(state_in),
      static_cast<uint8_t*>(out), static_cast<int32_t*>(state_out), lanes, nbytes, in_width,
      out_width);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* aukit_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
