// The FLAC lanes' float64 DSP kernel for Hopper (sm_90a), bound to Python
// through a plain C interface (kernels/_build.py loads it with ctypes;
// kernels/flac_dsp_cuda.py is the wrapper that checks and launches).
//
// Replaces no TPU kernel: the JAX package runs this DSP on the host in
// numpy (aukit_tpu/stream/flac_fleet.py _host_dsp), and so did the port
// (stream/flac_fleet.py FlacFleet._host_dsp). It was added because that
// numpy route was a FLAC fleet step's longest stretch, the card idle all
// the while: a dozen single-threaded passes over float64 arrays and a
// Python loop over lanes, for work the card does in one pass.
//
// What it computes, per lane of one geometry group (the lanes whose frames
// this step share a rate, a channel count C and one block size n >= 2), its
// m blocks in time order, all in float64 and in the host route's operation
// order, so that every output and state is bit-equal to it:
//   1. stereo decorrelation by each block's own channel assignment (8-10,
//      read from a table of one a block: flac -m picks one a frame) and the
//      one-sided sign wrap of the restored int64 samples (codecs/flac.py
//      decorrelate_frames), then the division by 2^depth;
//   2. the block resample of block_resample_plan in the modes "none" and
//      "linear" (native/flacbits.cpp block_resample_rows: d = p2 - p1;
//      m = d * frac; v = p1 + m). Neither mode reads the history columns;
//   3. the lowpass in iir_scan_rows' recursive-doubling order: y = x *
//      alpha, y[0] += c * state, then passes y[i] += ck * y[i - shift] that
//      read the pass's input values, ck squared after each pass, stopping
//      when ck == 0.0. Each block starts from the previous block's last y;
//   4. the gain of FlacFleet._gain_vector (a scalar, or the ramp line
//      g0 + (g1 - g0) * min((done + t) / span, 1) while a ramp runs), the
//      scale y * (y < 0 ? 128 : 127) clipped to [-128, 127] (NaN passes, as
//      numpy's clip lets it), the channel handling (the first channel, the
//      channels' mean as numpy's mean sums them in order and divides, or
//      every channel), and the float32 cast.
// It writes each lane's last y of every channel (the lowpass state) and its
// last two decoded samples of every channel (the resample history).
// Every float operation is an explicit __d*_rn intrinsic and the library is
// built with --fmad=false: nothing is contracted.
//
// What bounds it on the H100: bytes. A sample is 8 bytes of int64 in and 4
// of float32 out (C outputs a sample when mono=False), about 0.18 ms for a
// step of the radio's 1024 lanes at 3.35 TB/s. The doubling passes are
// about log2(n) sweeps over shared memory a block (8 at 48 kHz, where ck
// underflows to 0.0 after c^128), so the arithmetic stays well below the
// card's float64 rate. Measured: 0.68 ms for that step (PERF.md), the
// lane's blocks one after another with a barrier a pass between them.
//
// Design. One thread block per lane walks the lane's blocks in order: the
// lowpass state chains from each block into the next, and the doubling
// order ties every sample to the state, so blocks of one lane cannot run
// apart. A block's C x out_len samples live in shared memory twice (the
// pass reads one copy and writes the other, which keeps the read-before-
// write order of numpy's out-of-place pass without a second barrier), plus
// C doubles of carried state: 64 KB a block at 48 kHz mono, three blocks an
// SM. The decode reads the int64 samples straight from device memory,
// neighbouring threads on neighbouring samples; the resample's two taps of
// one output are neighbours and come from the same cache line. Which input
// an output reads steps by a whole quotient from one of a thread's outputs
// to its next, so no sample pays an integer division.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
// 64 KB of shared memory a mono 48 kHz lane fits three blocks an SM; the
// registers are held to that too (80 a thread, none spilled: 0.68 ms against
// 0.84 at 94 and two blocks an SM, one radio step on the H100)
constexpr int BLOCKS_PER_SM = 3;
constexpr int LANE_INTS = 6;  // in_off, blocks, out_off, ramp_pos, ramp_len, asgn_off

__device__ __forceinline__ long long wrapping_add(long long a, long long b) {
  return static_cast<long long>(static_cast<unsigned long long>(a) +
                                static_cast<unsigned long long>(b));
}

__device__ __forceinline__ long long wrapping_sub(long long a, long long b) {
  return static_cast<long long>(static_cast<unsigned long long>(a) -
                                static_cast<unsigned long long>(b));
}

// One frame's restored subframes (frame-major, nsubs rows of n samples), as
// decorrelate_frames reads them: int64 arithmetic wraps as numpy's does.
// The division by 2^depth is a multiply by 2^-depth: both are exact for an
// integer (no rounding, no underflow at depth <= 32), so they give the same bits.
struct Frame {
  const long long* f;
  int n, asgn;
  long long half, full;
  double inv_scale;  // 2^-depth

  __device__ __forceinline__ double at(int ch, long long j) const {
    long long v;
    if (asgn <= 7) {
      v = f[static_cast<long long>(ch) * n + j];
    } else {
      const long long a = f[j], b = f[n + j];
      if (asgn == 8) {  // left/side
        v = ch == 0 ? a : wrapping_sub(a, b);
      } else if (asgn == 9) {  // side/right
        v = ch == 0 ? wrapping_add(a, b) : b;
      } else {  // mid/side
        const long long right = wrapping_sub(a, b >> 1);
        v = ch == 0 ? wrapping_add(right, b) : right;
      }
    }
    if (v >= half) v = wrapping_sub(v, full);
    return __dmul_rn(__ll2double_rn(v), inv_scale);
  }
};

__device__ __forceinline__ double scaled(double y, double g) {
  const double yg = __dmul_rn(y, g);
  const double s = __dmul_rn(yg, yg < 0.0 ? 128.0 : 127.0);
  return s < -128.0 ? -128.0 : (s > 127.0 ? 127.0 : s);
}

__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
flac_dsp_f64_kernel(const long long* __restrict__ in, const long long* __restrict__ lanes_i,
                    const int* __restrict__ asgns, const double* __restrict__ lanes_f,
                    float* __restrict__ out, double* __restrict__ state, int C, int n, int depth,
                    int rate, int out_rate, int out_len, int linear, int out_mode, double alpha) {
  extern __shared__ double smem[];
  const int W = C * out_len;
  double* carry = smem + 2 * W;
  const int lane = blockIdx.x, tid = threadIdx.x;
  const long long* li = lanes_i + static_cast<long long>(lane) * LANE_INTS;
  const long long in_off = li[0], m = li[1], out_off = li[2], ramp_pos = li[3],
                  ramp_len = li[4];
  const int* asgn = asgns + li[5];  // the lane's blocks' channel assignments
  const double* lf = lanes_f + static_cast<long long>(lane) * (2 + C);
  const double g0 = lf[0], g1 = lf[1];
  if (tid < C) carry[tid] = lf[2 + tid];
  const double c = __dsub_rn(1.0, alpha);
  // a block is C rows of n under every assignment: 8-10 come only at C = 2
  const long long block_in = static_cast<long long>(C) * n;
  const long long T = m * out_len;  // the lane's output samples a channel
  Frame fr{in + in_off, n, 0, 1LL << (depth - 1), 1LL << depth, ldexp(1.0, -depth)};
  const double rate_out = static_cast<double>(out_rate);
  // output i reads input f0 = i * rate / out_rate (remainder rem): a
  // thread's outputs step by THREADS, so f0 and rem step by whole quotients
  const long long step = static_cast<long long>(THREADS) * rate;
  const long long step_q = step / out_rate, step_r = step - step_q * out_rate;
  const long long first = static_cast<long long>(tid) * rate;
  const long long first_q = first / out_rate, first_r = first - first_q * out_rate;
  __syncthreads();

  for (long long r = 0; r < m; ++r) {
    fr.f = in + in_off + r * block_in;
    fr.asgn = asgn[r];  // one value for the whole thread block: no divergence
    // 1, 2: decode, resample, y = x * alpha, the carried state into y[0]
    for (int ch = 0; ch < C; ++ch) {
      double* y = smem + ch * out_len;
      long long f0 = first_q, rem = first_r;
#pragma unroll 4
      for (int i = tid; i < out_len; i += THREADS) {
        const double p1 = fr.at(ch, f0);
        double v = p1;
        if (linear && rem != 0) {
          const double frac = __ddiv_rn(__ll2double_rn(rem), rate_out);
          const double p2 = fr.at(ch, f0 + 1 <= n - 1 ? f0 + 1 : f0);
          v = __dadd_rn(p1, __dmul_rn(__dsub_rn(p2, p1), frac));
        }
        double yi = __dmul_rn(v, alpha);
        if (i == 0) yi = __dadd_rn(yi, __dmul_rn(c, carry[ch]));
        y[i] = yi;
        f0 += step_q;
        rem += step_r;
        if (rem >= out_rate) {
          rem -= out_rate;
          ++f0;
        }
      }
    }
    __syncthreads();
    // 3: the doubling passes, from one copy into the other
    double* src = smem;
    double* dst = smem + W;
    double ck = c;
    for (int shift = 1; shift < out_len; shift <<= 1) {
      if (ck == 0.0) break;  // every further pass would add exactly +0.0
      for (int ch = 0; ch < C; ++ch) {
        const double* s = src + ch * out_len;
        double* d = dst + ch * out_len;
        for (int i = tid; i < out_len; i += THREADS)
          d[i] = i >= shift ? __dadd_rn(s[i], __dmul_rn(ck, s[i - shift])) : s[i];
      }
      __syncthreads();
      double* t = src;
      src = dst;
      dst = t;
      ck = __dmul_rn(ck, ck);
    }
    // 4: gain, scale, channels, float32
    const long long pos = ramp_pos + r * out_len;
    const bool line = ramp_len > 0 && pos < ramp_len && !(g0 == g1);
    const double done = __ll2double_rn(pos), span = __ll2double_rn(ramp_len);
    const double dg = __dsub_rn(g1, g0);
    const long long col = out_off + r * out_len;
    for (int i = tid; i < out_len; i += THREADS) {
      double g = g1;
      if (line) {
        double x = __ddiv_rn(__dadd_rn(done, static_cast<double>(i)), span);
        if (x > 1.0) x = 1.0;  // numpy's minimum: NaN stays
        g = __dadd_rn(g0, __dmul_rn(dg, x));
      }
      if (out_mode == 2) {
        for (int ch = 0; ch < C; ++ch)
          out[col + ch * T + i] = __double2float_rn(scaled(src[ch * out_len + i], g));
      } else {
        double acc = scaled(src[i], g);
        if (out_mode == 1) {
          for (int ch = 1; ch < C; ++ch) acc = __dadd_rn(acc, scaled(src[ch * out_len + i], g));
          acc = __ddiv_rn(acc, static_cast<double>(C));
        }
        out[col + i] = __double2float_rn(acc);
      }
    }
    __syncthreads();
    if (tid < C) carry[tid] = src[tid * out_len + out_len - 1];
    __syncthreads();
  }
  if (tid < C) {  // fr still points at the last block
    double* st = state + static_cast<long long>(lane) * 3 * C;
    st[tid] = carry[tid];
    st[C + 2 * tid] = fr.at(tid, n - 2);
    st[C + 2 * tid + 1] = fr.at(tid, n - 1);
  }
}

}  // namespace

// restored i64[N]; lanes_i i64[L,6] (in_off, blocks >= 1, out_off,
// ramp_pos, ramp_len, asgn_off); asgns i32 (a lane's blocks' channel
// assignments from asgns[asgn_off]; 8-10 only where C = 2); lanes_f
// f64[L,2+C] (gain0, gain, the C lowpass states); out f32 (each lane's
// [C or 1, blocks*out_len] at out_off);
// state f64[L,3C] (the C new lowpass states, then the C pairs of last
// samples); all contiguous, the offsets checked by the wrapper. linear: 0
// for "none", 1 for "linear"; out_mode: 0 the first channel, 1 the mean, 2
// every channel. Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int aukit_flac_dsp_f64(const void* restored, const void* lanes_i, const void* asgns,
                                  const void* lanes_f, void* out, void* state, int lanes, int C,
                                  int n, int depth, int rate, int out_rate, int out_len,
                                  int linear, int out_mode, double alpha, void* stream) {
  const size_t smem = (2 * static_cast<size_t>(C) * out_len + C) * sizeof(double);
  cudaFuncSetAttribute(flac_dsp_f64_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  flac_dsp_f64_kernel<<<lanes, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(restored), static_cast<const long long*>(lanes_i),
      static_cast<const int*>(asgns), static_cast<const double*>(lanes_f),
      static_cast<float*>(out), static_cast<double*>(state), C, n, depth, rate, out_rate,
      out_len, linear, out_mode, alpha);
  return static_cast<int>(cudaGetLastError());
}
