// Probes of the float32 pieces of csrc/wgmma_tma.cuh on the card, for
// tools/wgmma_tf32_probe.py:
//
// tma_probe: one float32 box (32 elements x 8 rows x 1) of a 3-D map over
// (inner, rows, outer) with the 128-byte swizzle, at the given coordinates
// (negative or past the end: TMA's zero fill), its 1024 bytes of shared
// memory copied out as they landed.
//
// tf32_probe: one warpgroup, two products.
//   low bits: A (64 x 8) and B (8 x 8) K-major in shared memory (128-byte
//     rows, the swizzle applied by hand), A[m][0] = va[m], B[n][0] = 1, the
//     rest 0: d[m][n] = the tensor cores' tf32 of va[m]. m64n8k8, A and B
//     from shared memory.
//   fragments: A (64 x 8) from registers, in the fragment layout the
//     header states, B (16 x 8) from shared memory, small integers (exact in
//     any rounding): d = A B^T. m64n16k8.
// Outputs: low (64 x 8) and frag (64 x 16) row-major.

#include <cstdint>

#include <cuda_runtime.h>

#include "wgmma_tma.cuh"

namespace {

// the shared-memory writes of this thread visible to the async proxy (a
// wgmma operand that threads wrote, read after a barrier)
__device__ __forceinline__ void fence_proxy_async() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d (+)= A (64 x 8) * B (8 x 8)^T in tf32, A and B from shared memory
// (descs a, b); scale_d 0 overwrites d (the kernels take A from registers,
// wgmma_tma.cuh's wgmma_tf32_rs)
__device__ __forceinline__ void wgmma_tf32_ss8(float (&d)[4], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3}, "
        "%4, %5, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(a), "l"(b), "r"(scale_d));
}

__global__ void tma_probe_kernel(const __grid_constant__ CUtensorMap map, float* out, int c0, int c1,
                                 int c2, int rank) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const uint32_t base = wg::smem_u32(smem_raw);
    unsigned char* tile = smem_raw + (((base + 1023u) & ~1023u) - base);
    uint64_t* bar = reinterpret_cast<uint64_t*>(tile + 1024);
    if (threadIdx.x == 0) {
        wg::mbar_init(bar, 1);
        wg::fence_barrier_init();
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        wg::mbar_arrive_expect_tx(bar, 1024);
        if (rank == 3)
            wg::tma_load_3d(tile, &map, bar, c0, c1, c2);
        else
            wg::tma_load_2d(tile, &map, bar, c0, c1);
    }
    wg::mbar_wait(bar, 0);
    const float* t = reinterpret_cast<const float*>(tile);
    for (int i = threadIdx.x; i < 256; i += blockDim.x) out[i] = t[i];
}

// byte offset of (row r, float k) in a K-major tile of 128-byte rows, 128-byte swizzle
__device__ __forceinline__ int sw128(int r, int k) {
    const int off = r * 128 + k * 4;
    return off ^ (((off >> 7) & 7) << 4);
}

__global__ void tf32_probe_kernel(const float* va, const float* fa, const float* fb, float* low,
                                  float* frag) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const uint32_t base = wg::smem_u32(smem_raw);
    unsigned char* s = smem_raw + (((base + 1023u) & ~1023u) - base);
    unsigned char* a = s;             // 64 rows x 128 bytes
    unsigned char* b = s + 8192;      // 8 rows
    unsigned char* b2 = s + 9216;     // 16 rows
    const int tid = threadIdx.x;
    for (int i = tid; i < 64 * 32; i += 128) {
        const int r = i / 32, k = i % 32;
        *reinterpret_cast<float*>(a + sw128(r, k)) = k == 0 ? va[r] : 0.f;
    }
    for (int i = tid; i < 8 * 32; i += 128) {
        const int r = i / 32, k = i % 32;
        *reinterpret_cast<float*>(b + sw128(r, k)) = k == 0 ? 1.f : 0.f;
    }
    for (int i = tid; i < 16 * 32; i += 128) {
        const int r = i / 32, k = i % 32;
        *reinterpret_cast<float*>(b2 + sw128(r, k)) = k < 8 ? fb[r * 8 + k] : 0.f;
    }
    fence_proxy_async();
    __syncthreads();
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
    float d[4] = {0.f, 0.f, 0.f, 0.f};
    float e[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    const int r0 = 16 * warp + g;
    uint32_t af[4];
    af[0] = __float_as_uint(fa[r0 * 8 + t]);
    af[1] = __float_as_uint(fa[(r0 + 8) * 8 + t]);
    af[2] = __float_as_uint(fa[r0 * 8 + t + 4]);
    af[3] = __float_as_uint(fa[(r0 + 8) * 8 + t + 4]);
    wg::fence_acc(d);
    wg::fence_acc(e);
    wg::wgmma_fence();
    wgmma_tf32_ss8(d, wg::smem_desc(a, 128), wg::smem_desc(b, 128), 0);
    wg::wgmma_tf32_rs<16>(e, af, wg::smem_desc(b2, 128), 0);
    wg::wgmma_commit();
    wg::wgmma_wait<0>();
    wg::fence_acc(d);
    wg::fence_acc(e);
    // register 4 j + q: row 16 warp + g + 8 (q >= 2), column 8 j + 2 t + (q & 1)
    for (int q = 0; q < 4; ++q) {
        const int row = r0 + 8 * (q >> 1), col = 2 * t + (q & 1);
        low[row * 8 + col] = d[q];
    }
    for (int j = 0; j < 2; ++j)
        for (int q = 0; q < 4; ++q) {
            const int row = r0 + 8 * (q >> 1), col = 8 * j + 2 * t + (q & 1);
            frag[row * 16 + col] = e[4 * j + q];
        }
}

}  // namespace

extern "C" {

// x: (outer, rows, inner) float32 contiguous; out: 256 floats. rank 2:
// the map over (inner, rows x outer); swizzle 128 or 0 (none).
int tma_probe(const float* x, int inner, int rows, int outer, int c0, int c1, int c2, float* out,
              int rank, int swizzle) {
    CUtensorMap map;
    const uint64_t dims[3] = {(uint64_t)inner, (uint64_t)rows * (rank == 2 ? outer : 1),
                              (uint64_t)outer};
    const uint64_t strides[2] = {(uint64_t)inner * 4, (uint64_t)inner * rows * 4};
    const uint32_t box[3] = {32, 8, 1};
    if (!wg::encode_f32(&map, x, rank, dims, strides, box, swizzle)) return -1;
    const int smem = 1024 + 1024 + 64;
    cudaFuncSetAttribute(tma_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    tma_probe_kernel<<<1, 128, smem>>>(map, out, c0, c1, c2, rank);
    const cudaError_t err = cudaGetLastError();
    return err != cudaSuccess ? (int)err : (int)cudaDeviceSynchronize();
}

int tf32_probe(const float* va, const float* fa, const float* fb, float* low, float* frag) {
    const int smem = 1024 + 9216 + 2048;
    cudaFuncSetAttribute(tf32_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    tf32_probe_kernel<<<1, 128, smem>>>(va, fa, fb, low, frag);
    const cudaError_t err = cudaGetLastError();
    return err != cudaSuccess ? (int)err : (int)cudaDeviceSynchronize();
}

}  // extern "C"
