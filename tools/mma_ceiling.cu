// The mma.sync ceiling of the card: each warp issues independent m16n8k8
// TF32 or m16n8k16 bf16 products into 8 accumulators, with no memory
// traffic, so the rate it reaches is what K7/K9 and K8 (which issue these
// instructions through csrc/mma_tc.cuh) can reach at most. Built and run by
// tools/mma_ceiling.py.

#include <cstdint>

#include <cuda_runtime.h>

#include "mma_tc.cuh"

template <bool BF16>
__global__ void __launch_bounds__(256) mma_ceiling_kernel(float* out, int iters) {
    float acc[8][4] = {};
    const uint32_t a[4] = {threadIdx.x, threadIdx.x * 3u, threadIdx.x * 5u, 7u};
    const uint32_t b0 = threadIdx.x * 11u, b1 = 13u;
    for (int it = 0; it < iters; ++it) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            if (BF16) tc::mma_bf16(acc[j], a, b0, b1);
            else tc::mma_tf32(acc[j], a, b0, b1);
        }
    }
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) s += acc[j][0] + acc[j][1] + acc[j][2] + acc[j][3];
    if (s == 1.2345f) out[threadIdx.x] = s;  // keeps the products live
}

extern "C" int mma_ceiling(int bf16, int blocks, int iters, float* out, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (bf16) mma_ceiling_kernel<true><<<blocks, 256, 0, s>>>(out, iters);
    else mma_ceiling_kernel<false><<<blocks, 256, 0, s>>>(out, iters);
    return (int)cudaGetLastError();
}
