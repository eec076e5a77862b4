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
// every subframe of every stream of a step as one row each (32768 rows of
// 4096 samples at bench scale). One thread owns one row: the order-K window
// of restored samples and the K coefficients sit in registers, K is a
// template parameter (4, 8, 16 or 32: the batch's maximum order, rounded up
// as _order_bucket does), and rows are staged through shared memory
// (lane_scan.cuh).
//
// Arithmetic. The TPU has no 64-bit integers, so the Pallas kernel splits
// each product into int32 limbs; that is exact while |v| < 2^25 and
// |c| <= 2^15, which covers every FLAC stream of depth <= 24. Hopper has
// 64-bit integers: the products are summed in 64 bits (wrapping, as numpy's
// int64 einsum does) and the prediction is (sum << max(-shift, 0)) >>
// max(shift, 0), the rule of codecs/flac.py restore_lpc_batch. Inside the
// limb kernel's domain this equals it bit for bit; outside it this kernel
// follows the int64 host restore, except that each restored sample is
// stored as int32 (wrapping) where the host keeps int64. Shift amounts are
// clamped to 63, where numpy's would be undefined.
//
// Bounds on the H100. Per sample a row reads and writes 4 bytes and does K
// 64-bit multiply-adds; at K = 8 and 32768 rows the dependent chain of the
// sum and the 64-bit multiplies bound it, hidden only by the warps in
// flight (~8 warps per SM at 32768 rows).

#include "lane_scan.cuh"

namespace {

template <int K>
struct LpcLane {
  int w[K];  // w[0] = the newest restored sample
  int c[K];
  int order, block, left, right;
  int i;  // index of the next sample within the row

  __device__ __forceinline__ int step(int res) {
    unsigned long long acc = 0;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      acc += static_cast<unsigned long long>(static_cast<long long>(w[j]) * c[j]);
    }
    const long long pred = static_cast<long long>(acc << left) >> right;
    const bool upd = order > 0 && i >= order && i < block;
    // the low 32 bits of res + pred: the sum wraps as int32 (unsigned, so no
    // signed overflow)
    const int v = upd ? static_cast<int>(static_cast<unsigned>(res) +
                                         static_cast<unsigned>(pred))
                      : res;
#pragma unroll
    for (int j = K - 1; j > 0; --j) w[j] = w[j - 1];
    w[0] = v;
    ++i;
    return v;
  }
};

template <int K>
__global__ void __launch_bounds__(aukit::SCAN_LANES)
lpc_restore_kernel(const int32_t* __restrict__ vals, const int32_t* __restrict__ orders,
                   const int32_t* __restrict__ shifts, const int32_t* __restrict__ blocks,
                   const int32_t* __restrict__ coefs, int32_t* __restrict__ out, int lanes,
                   long long T) {
  const int lane = blockIdx.x * aukit::SCAN_LANES + threadIdx.x;
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
  aukit::scan_rows(vals, out, lanes, T, st);
}

template <int K>
void launch(const void* vals, const void* orders, const void* shifts, const void* blocks,
            const void* coefs, void* out, int lanes, long long T, cudaStream_t stream) {
  lpc_restore_kernel<K><<<aukit::scan_blocks(lanes), aukit::SCAN_LANES, 0, stream>>>(
      static_cast<const int32_t*>(vals), static_cast<const int32_t*>(orders),
      static_cast<const int32_t*>(shifts), static_cast<const int32_t*>(blocks),
      static_cast<const int32_t*>(coefs), static_cast<int32_t*>(out), lanes, T);
}

}  // namespace

// vals/out i32[L,T]; orders, shifts, blocks i32[L]; coefs i32[L,K]
// (coefficient j multiplies v[i-1-j]; 0 beyond the row's order); all
// contiguous. K is 4, 8, 16 or 32. Returns cudaGetLastError() after the
// launch (0 = launched), cudaErrorInvalidValue for any other K.
extern "C" int aukit_lpc_restore(const void* vals, const void* orders, const void* shifts,
                                 const void* blocks, const void* coefs, void* out, int lanes,
                                 long long T, int K, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 4: launch<4>(vals, orders, shifts, blocks, coefs, out, lanes, T, s); break;
    case 8: launch<8>(vals, orders, shifts, blocks, coefs, out, lanes, T, s); break;
    case 16: launch<16>(vals, orders, shifts, blocks, coefs, out, lanes, T, s); break;
    case 32: launch<32>(vals, orders, shifts, blocks, coefs, out, lanes, T, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
