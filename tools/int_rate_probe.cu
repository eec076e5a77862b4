// What a Hopper SM's schedulers make of 32-bit integer instructions: the
// cycles between two dependent instructions (one chain a warp) and the
// cycles a warp instruction takes when nothing depends (eight chains a
// warp), for multiply-add, add, max, shift, and multiply-adds and maxes in
// turns, with one and with four warps a scheduler. The lane-recurrence
// kernels of aukit_tpu_torch/csrc are made of these; PERF.md holds their
// times against what is printed here.
//
// Build and run from the repository's root, on a machine with the card and
// the CUDA toolkit (the binary goes beside the kernels' build, a directory
// of the checkout that git ignores):
//
//     mkdir -p aukit_tpu_torch/_build && \
//     nvcc -gencode arch=compute_90a,code=sm_90a -O3 \
//         -o aukit_tpu_torch/_build/int_rate_probe tools/int_rate_probe.cu && \
//     aukit_tpu_torch/_build/int_rate_probe
//
// Every block is one warp; blocks = SMs x 4 x warps a scheduler, so each
// scheduler holds that many warps (the hardware spreads one-warp blocks
// evenly). A warp times itself with clock64(); the line gives the mean over
// warps of cycles / instructions, which needs no clock rate.

#include <cstdio>
#include <cuda_runtime.h>

enum Op { MAD, ADD, MAX, SHR, MAD_MAX };

template <int OP>
__device__ __forceinline__ int apply(int v, int b, int c, int chain) {
  int r;
  const int op = OP == MAD_MAX ? (chain % 2 ? MAX : MAD) : OP;
  if (op == MAD) {
    asm volatile("mad.lo.s32 %0, %1, %2, %3;" : "=r"(r) : "r"(v), "r"(b), "r"(c));
  } else if (op == ADD) {
    asm volatile("add.s32 %0, %1, %2;" : "=r"(r) : "r"(v), "r"(b));
  } else if (op == MAX) {
    asm volatile("max.s32 %0, %1, %2;" : "=r"(r) : "r"(v), "r"(c));
  } else {
    asm volatile("shr.s32 %0, %1, %2;" : "=r"(r) : "r"(v), "r"(c));
  }
  return r;
}

constexpr int UNROLL = 32;

template <int OP, int CHAINS>
__global__ void __launch_bounds__(32) probe(int* sink, long long* cycles, int iters, int b, int c) {
  int v[CHAINS];
#pragma unroll
  for (int i = 0; i < CHAINS; ++i) v[i] = threadIdx.x + i;
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
      for (int i = 0; i < CHAINS; ++i) v[i] = apply<OP>(v[i], b, c, i);
    }
  }
  const long long t1 = clock64();
  int sum = 0;
#pragma unroll
  for (int i = 0; i < CHAINS; ++i) sum += v[i];
  sink[blockIdx.x * 32 + threadIdx.x] = sum;
  if (threadIdx.x == 0) cycles[blockIdx.x] = t1 - t0;
}

template <int OP, int CHAINS>
void run(const char* name, int sms, int warps_per_scheduler) {
  const int blocks = sms * 4 * warps_per_scheduler, iters = 2000;
  int* sink;
  long long* cycles;
  cudaMalloc(&sink, blocks * 32 * sizeof(int));
  cudaMallocManaged(&cycles, blocks * sizeof(long long));
  for (int rep = 0; rep < 2; ++rep) {  // the first launch warms the clocks up
    probe<OP, CHAINS><<<blocks, 32>>>(sink, cycles, iters, 3, 1);
    cudaDeviceSynchronize();
  }
  double mean = 0;
  for (int i = 0; i < blocks; ++i) mean += static_cast<double>(cycles[i]) / blocks;
  const double per = mean / (static_cast<double>(iters) * UNROLL * CHAINS);
  printf("[int_rate] op=%s chains=%d warps_per_scheduler=%d cycles_per_instruction_a_warp=%.2f "
         "cycles_per_instruction_a_scheduler=%.2f error=%d\n",
         name, CHAINS, warps_per_scheduler, per, per / warps_per_scheduler,
         static_cast<int>(cudaGetLastError()));
  cudaFree(sink);
  cudaFree(cycles);
}

int main() {
  cudaDeviceProp prop;
  if (cudaGetDeviceProperties(&prop, 0) != cudaSuccess) {
    fprintf(stderr, "int_rate_probe: no CUDA device\n");
    return 1;
  }
  printf("[int_rate] device=\"%s\" sms=%d\n", prop.name, prop.multiProcessorCount);
  const int sms = prop.multiProcessorCount;
  for (int w : {1, 4}) {
    run<MAD, 1>("mad", sms, w);
    run<ADD, 1>("add", sms, w);
    run<MAX, 1>("max", sms, w);
    run<SHR, 1>("shr", sms, w);
    run<MAD, 8>("mad", sms, w);
    run<ADD, 8>("add", sms, w);
    run<MAX, 8>("max", sms, w);
    run<SHR, 8>("shr", sms, w);
    run<MAD_MAX, 8>("mad_max", sms, w);
  }
  return 0;
}
