// FLAC LPC restore kernel for Hopper (sm_90a), bound to Python through a
// plain C interface (kernels/_build.py loads it with ctypes;
// kernels/flac_cuda.py is the wrapper that checks and launches).
//
// Replaces the Pallas TPU kernel
//   - aukit_lpc_restore <- aukit_tpu/kernels/flac_pallas.py lpc_restore_grouped
//     (_lpc_kernel), and with it the wrappers lpc_restore_pallas,
//     lpc_restore_scan and lpc_restore_sharded
//
// The recurrence (aukit.lua:411-419), per subframe row:
//   v[i] += floor(sum_j c[j] * v[i-1-j] / 2^shift)   for order <= i < block
// with a signed shift (a negative one multiplies). Rows with order 0
// (verbatim, constant, padding), warmup samples (i < order) and tail padding
// (i >= block) pass through.
//
// Design. Subframes are independent, so the FLAC fleet hands this kernel
// every subframe of every stream of a step as one row each (7168 rows of
// 4096 samples in a step of the 2048-lane fleet, 32768 at bench scale). One
// thread owns one row: the order-K window of restored samples and the K
// coefficients sit in registers, K is a template parameter (4, 8, 16 or 32:
// the batch's maximum order, rounded up as _order_bucket does), and rows
// move through the pipelined skeleton of lane_scan.cuh (scan_rows_async):
// tiles of 64 samples a row arrive by asynchronous 16-byte copies two tiles
// ahead, are restored in place and leave by 16-byte stores, in blocks of
// one warp so that a fleet step's rows reach every SM.
//
// Arithmetic. The TPU has no 64-bit integers, so the Pallas kernel splits
// each product into int32 limbs; that is exact while |v| < 2^25 and
// |c| <= 2^15, which covers every FLAC stream of depth <= 24. Hopper has
// 64-bit integers: the products are summed in 64 bits (wrapping, as numpy's
// int64 einsum does) and the prediction is (sum << max(-shift, 0)) >>
// max(shift, 0), the rule of codecs/flac.py restore_lpc_batch. Inside the
// limb kernel's domain this equals it bit for bit. Outside it (a malformed
// stream whose unstable predictor drives a sample out of int32) the int32
// row wraps where the host's int64 restore does not. The kernel reports
// such a row: where ``wrapped`` is given it sets wrapped[row] to 1 if any
// restored sample's int64 value (res + pred, wrapping in 64 bits as the
// host's) differs from the int32 it stored, else 0. The test is off the
// chain from one sample to the next. The wide entry point,
// aukit_lpc_restore_wide, restores such rows again in int64 rows, one
// thread a row reading and writing device memory directly: the rows of
// malformed streams only, so nothing of the pipeline is spent on it.
// Shift amounts are clamped to 63, where numpy's would be undefined.
//
// What bounds it on the H100 (measured: PERF.md). A sample is 4 bytes in, 4
// out and K 64-bit multiply-adds: at K = 8 and 32768 rows the bytes bound
// it, if they keep moving while a row's chain runs; the skeleton's ring
// sees to that. What the design keeps short is the work per sample: a row
// restores K samples at a time with the window rotating through registers
// by renaming (no moves), each tap is one IMAD.WIDE (mad.wide.s32: see
// mad_wide), and where a whole tile lies inside the row's block with a
// shift of 0..31 (every tile but the first and the last of a FLAC subframe)
// the prediction's low word is one funnel shift and no per-sample test
// remains. The chain from one restored sample to the next is then
// multiply-add, 64-bit add, shift, add; the K - 1 older products do not
// wait for the newest sample (64-bit wrapping sums are associative, so any
// order is exact; ptxas sums them as a tree of 3-input adds whichever order
// the source gives). Tiles that hold a warmup, the block's end or another
// shift take the general step; tiles of rows that never update (order 0,
// or past the block) are left as they arrived. With few rows (a fleet
// step's 7168: one warp on two of every five schedulers) a row's own pace
// bounds it: one scheduler starts an IMAD.WIDE every ~4 cycles, ~5.6 cycles
// a tap with its add.

#include "lane_scan.cuh"

namespace {

// acc + a * b in 64 bits, wrapping: one IMAD.WIDE. Written as C++, nvcc
// widens the loop-invariant coefficients once and then multiplies 64 x 64
// bits, four instructions a tap.
__device__ __forceinline__ unsigned long long mad_wide(int a, int b, unsigned long long acc) {
  unsigned long long d;
  asm("mad.wide.s32 %0, %1, %2, %3;" : "=l"(d) : "r"(a), "r"(b), "l"(acc));
  return d;
}

// Whether res + pred, summed in 64 bits and wrapping as the host's int64
// restore does, differs from v, its low 32 bits as stored.
__device__ __forceinline__ bool leaves_int32(int res, long long pred, int v) {
  const unsigned long long full = static_cast<unsigned long long>(static_cast<long long>(res)) +
                                  static_cast<unsigned long long>(pred);
  return full != static_cast<unsigned long long>(static_cast<long long>(v));
}

template <int K>
struct LpcLane {
  int w[K];  // the K newest restored samples; between groups w[0] is the newest
  int c[K];
  int order, block, left, right;
  bool wrapped;  // a restored sample left int32 (its int64 value != the int32 stored)

  // Restores the K samples at p. Within the group the window rotates by
  // renaming: before sample s the newest is w[(K - s) % K], and sample s
  // overwrites the oldest, w[K - 1 - s]; after K samples w[0] is the newest
  // again. FAST: every sample updates and the shift is right, 0..31;
  // otherwise samples lo <= s < hi of the group update.
  template <bool FAST>
  __device__ __forceinline__ void group(int* p, int lo, int hi) {
#pragma unroll
    for (int n = 0; n < K; n += 4) {
      const int4 x = *reinterpret_cast<const int4*>(p + n);
      int r[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int s = n + m;
        unsigned long long acc = 0;  // oldest first: the newest sample's product comes last
#pragma unroll
        for (int j = K - 1; j >= 0; --j) acc = mad_wide(w[(K - s + j) % K], c[j], acc);
        // the low 32 bits of res + pred: the sum wraps as int32 (unsigned, so
        // no signed overflow)
        int v;
        if (FAST) {
          const unsigned pred = __funnelshift_r(static_cast<unsigned>(acc),
                                                static_cast<unsigned>(acc >> 32), right);
          v = static_cast<int>(static_cast<unsigned>(r[m]) + pred);
          wrapped |= leaves_int32(r[m], static_cast<long long>(acc) >> right, v);
        } else {
          const long long pred = static_cast<long long>(acc << left) >> right;
          const bool upd = s >= lo && s < hi;
          v = upd ? static_cast<int>(static_cast<unsigned>(r[m]) + static_cast<unsigned>(pred))
                  : r[m];
          wrapped |= upd && leaves_int32(r[m], pred, v);
        }
        w[K - 1 - s] = v;
        r[m] = v;
      }
      *reinterpret_cast<int4*>(p + n) = make_int4(r[0], r[1], r[2], r[3]);
    }
  }

  // One tile of the row, in place: row[s] is sample t0 + s.
  __device__ __forceinline__ void tile(int* row, long long t0) {
    if (order <= 0 || t0 >= block) return;  // no sample updates, now or later
    const int lo = static_cast<int>(min(max(order - t0, 0LL), 1LL * aukit::ASYNC_TILE));
    const int hi = static_cast<int>(min(block - t0, 1LL * aukit::ASYNC_TILE));
    if (lo == 0 && hi == aukit::ASYNC_TILE && left == 0 && right < 32) {
      for (int g = 0; g < aukit::ASYNC_TILE; g += K) group<true>(row + g, 0, 0);
    } else {
#pragma unroll 1
      for (int g = 0; g < aukit::ASYNC_TILE; g += K) group<false>(row + g, lo - g, hi - g);
    }
  }
};

template <int K>
__global__ void __launch_bounds__(aukit::ASYNC_LANES)
lpc_restore_kernel(const int32_t* __restrict__ vals, const int32_t* __restrict__ orders,
                   const int32_t* __restrict__ shifts, const int32_t* __restrict__ blocks,
                   const int32_t* __restrict__ coefs, int32_t* __restrict__ out,
                   int32_t* __restrict__ wrapped, int lanes, long long T, int width) {
  const int lane = blockIdx.x * aukit::ASYNC_LANES + threadIdx.x;
  LpcLane<K> st{};
  if (lane < lanes) {
    st.order = orders[lane];
    st.block = blocks[lane];
    const int shift = shifts[lane];
    st.left = min(max(-shift, 0), 63);
    st.right = min(max(shift, 0), 63);
#pragma unroll
    for (int j = 0; j < K; ++j) st.c[j] = coefs[static_cast<long long>(lane) * K + j];
  }
  aukit::scan_rows_async(vals, out, lanes, T, width, st);
  if (wrapped != nullptr && lane < lanes) wrapped[lane] = st.wrapped ? 1 : 0;
}

// The int64 restore of whole rows, one thread a row: v[i] += (sum_j c[j] *
// v[i-1-j] << left) >> right for order <= i < block, every sum and product
// wrapping in 64 bits as numpy's int64 restore does. Rows are read and
// written in device memory, their newest samples out of the L1 cache.
__global__ void lpc_restore_wide_kernel(const int64_t* __restrict__ vals,
                                        const int32_t* __restrict__ orders,
                                        const int32_t* __restrict__ shifts,
                                        const int32_t* __restrict__ blocks,
                                        const int32_t* __restrict__ coefs, int64_t* __restrict__ out,
                                        int lanes, long long T, int K) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  const int64_t* in = vals + static_cast<long long>(lane) * T;
  int64_t* row = out + static_cast<long long>(lane) * T;
  const int32_t* c = coefs + static_cast<long long>(lane) * K;
  const int order = orders[lane], shift = shifts[lane];
  const long long block = blocks[lane];
  const int left = min(max(-shift, 0), 63), right = min(max(shift, 0), 63);
  for (long long t = 0; t < T; ++t) {
    unsigned long long v = static_cast<unsigned long long>(in[t]);
    if (order > 0 && t >= order && t < block) {
      unsigned long long acc = 0;
      for (int j = 0; j < K && j < t; ++j) {
        acc += static_cast<unsigned long long>(static_cast<long long>(c[j])) *
               static_cast<unsigned long long>(row[t - 1 - j]);
      }
      v += static_cast<unsigned long long>(static_cast<long long>(acc << left) >> right);
    }
    row[t] = static_cast<int64_t>(v);
  }
}

template <int K>
void launch(const void* vals, const void* orders, const void* shifts, const void* blocks,
            const void* coefs, void* out, void* wrapped, int lanes, long long T,
            cudaStream_t stream) {
  // 32768 rows are 7.8 blocks per SM: their rings need the SM's whole shared memory
  cudaFuncSetAttribute(lpc_restore_kernel<K>, cudaFuncAttributePreferredSharedMemoryCarveout,
                       cudaSharedmemCarveoutMaxShared);
  lpc_restore_kernel<K><<<aukit::async_blocks(lanes), aukit::ASYNC_LANES, 0, stream>>>(
      static_cast<const int32_t*>(vals), static_cast<const int32_t*>(orders),
      static_cast<const int32_t*>(shifts), static_cast<const int32_t*>(blocks),
      static_cast<const int32_t*>(coefs), static_cast<int32_t*>(out),
      static_cast<int32_t*>(wrapped), lanes, T, aukit::copy_width(T, vals, out));
}

}  // namespace

// vals/out i32[L,T]; orders, shifts, blocks i32[L]; coefs i32[L,K]
// (coefficient j multiplies v[i-1-j]; 0 beyond the row's order); wrapped
// i32[L] or null; all contiguous. K is 4, 8, 16 or 32. Returns
// cudaGetLastError() after the launch (0 = launched),
// cudaErrorInvalidValue for any other K.
extern "C" int aukit_lpc_restore(const void* vals, const void* orders, const void* shifts,
                                 const void* blocks, const void* coefs, void* out, void* wrapped,
                                 int lanes, long long T, int K, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 4: launch<4>(vals, orders, shifts, blocks, coefs, out, wrapped, lanes, T, s); break;
    case 8: launch<8>(vals, orders, shifts, blocks, coefs, out, wrapped, lanes, T, s); break;
    case 16: launch<16>(vals, orders, shifts, blocks, coefs, out, wrapped, lanes, T, s); break;
    case 32: launch<32>(vals, orders, shifts, blocks, coefs, out, wrapped, lanes, T, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// vals/out i64[L,T]; the rest as aukit_lpc_restore's, with any K >= 1.
extern "C" int aukit_lpc_restore_wide(const void* vals, const void* orders, const void* shifts,
                                      const void* blocks, const void* coefs, void* out,
                                      int lanes, long long T, int K, void* stream) {
  constexpr int threads = 128;
  lpc_restore_wide_kernel<<<(lanes + threads - 1) / threads, threads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(vals), static_cast<const int32_t*>(orders),
      static_cast<const int32_t*>(shifts), static_cast<const int32_t*>(blocks),
      static_cast<const int32_t*>(coefs), static_cast<int64_t*>(out), lanes, T, K);
  return static_cast<int>(cudaGetLastError());
}
