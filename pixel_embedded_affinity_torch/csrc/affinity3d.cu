// Fused embedding -> 3D shift-table affinity, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel pixel_embedded_affinity_tpu/ops/emb2aff_pallas.py
// ::_affinity_3d_kernel (pl.pallas_call in _fused_affinity_3d_impl, public
// entry fused_affinity_3d). Python wrapper: ops/emb2aff3d_cuda.py.
//
// What it computes. e: (B, D, H, W, C) with arbitrary element strides,
// float32 or bfloat16. Channel k has a shift s_k along axis k % 3 of
// (z, y, x):
//     a_k(p) = <n(p), n(p - s_k e_{k%3})>,  n = e / max(sqrt(|e|^2 + 1e-36), 1e-12),
// with the normalisation and the dot in float32 whatever the storage type,
// and a_k(p) = 0 where p - s_k e_{k%3} lies outside the volume.
// out: (B, K, D, H, W), contiguous, in the input's dtype.
//
// Bound. HBM bytes: each input element read once and each output written
// once. The serving tile batch, B=4 tiles of 18x160x160, C=16, K=12, float32,
// reads 118.0 MB and writes 88.5 MB: 61.6 us at 3.35 TB/s (one tile is a
// quarter of that). The arithmetic the function needs, 3*C + 2*C*K flops per
// voxel (each vector normalised once, one C-dot per channel), takes 11.9 us
// at the 67 TFLOP/s float32 rate, so bytes bound it.
//
// Design: one thread per output voxel, threads of a warp along x so that
// loads from the model's NCDHW layout (channel stride D*H*W, x stride 1)
// and the output stores coalesce; blocks of 32x8 over (x, y), one grid row
// per (b, z). The thread normalises its own vector once and, for each
// channel, loads the neighbour's C values (L1/L2 hits but for the first
// touch) and takes the dot of the raw values in four independent sums,
// scaled by one reciprocal of the neighbour's norm. Dividing each value by
// the norm instead, 13 x C divisions a voxel, took about half of the
// kernel's time on the H100. The TPU's row tiles, halo and front slab
// padding have no counterpart: a bounds check writes the zeros.
//
// The staged z-walk design, each voxel normalised once a block, the slice
// staged in shared memory with a halo of 9 and a walk along z with a
// four-slice ring, is tools/affinity_zwalk.cu; tools/affinity_zwalk.py
// holds the two against each other on the card. On an NVIDIA H100 80GB
// HBM3 at 700 W, B=4 18x160x160, C=16, float32, the NCDHW view, L2
// flushed, by CUDA graph replay, it took 0.2550-0.2595 ms against this
// kernel's 0.1750-0.1797 in the same run: its shared memory leaves 16
// warps an SM, each block waiting at two barriers a slice, where this
// kernel's 55 registers leave 32 warps of independent voxels that find
// their near neighbours in L1.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "affinity_load.cuh"

namespace {

using namespace affinity_load;

constexpr int kMaxShifts = 64;

struct Shifts {
    int s[kMaxShifts];
};

// n[c] = the C values at v in float32 (load_values); returns 1 /
// max(sqrt(sum n^2 + 1e-36), 1e-12), the inverse norm
template <typename T, int C, bool kContig>
__device__ __forceinline__ float load_vec(const T* __restrict__ v, int64_t sC, float* n) {
    load_values<T, C, kContig>(v, sC, n);
    float ss = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) ss += n[c] * n[c];
    return 1.f / fmaxf(sqrtf(ss + 1e-36f), 1e-12f);
}

template <typename T, int C, bool kContig>
__global__ void affinity3d_fwd_kernel(const T* __restrict__ e, T* __restrict__ out,
                                      int D, int H, int W, int K,
                                      int64_t sB, int64_t sD, int64_t sH, int64_t sW,
                                      int64_t sC, Shifts sh) {
    const int x = blockIdx.x * blockDim.x + threadIdx.x;
    const int y = blockIdx.y * blockDim.y + threadIdx.y;
    const int b = blockIdx.z / D;
    const int z = blockIdx.z - b * D;
    if (x >= W || y >= H) return;

    const T* p = e + b * sB + z * sD + y * sH + x * sW;
    float n0[C];
    const float inv0 = load_vec<T, C, kContig>(p, sC, n0);
#pragma unroll
    for (int c = 0; c < C; ++c) n0[c] *= inv0;

    const int64_t vol = (int64_t)D * H * W;
    T* o = out + (int64_t)b * K * vol + ((int64_t)z * H + y) * W + x;
    for (int k = 0; k < K; ++k) {
        const int s = sh.s[k];
        const int axis = k % 3;
        const int pos = axis == 0 ? z : (axis == 1 ? y : x);
        const int size = axis == 0 ? D : (axis == 1 ? H : W);
        const int64_t step = axis == 0 ? sD : (axis == 1 ? sH : sW);
        float a = 0.f;
        if (pos - s >= 0 && pos - s < size) {
            float n1[C], d[4] = {0.f, 0.f, 0.f, 0.f};
            const float inv = load_vec<T, C, kContig>(p - s * step, sC, n1);
#pragma unroll
            for (int c = 0; c < C; ++c) d[c % 4] += n0[c] * n1[c];
            a = ((d[0] + d[1]) + (d[2] + d[3])) * inv;
        }
        o[k * vol] = from_float<T>(a);
    }
}

template <typename T>
cudaError_t launch(const void* e, void* out, int B, int D, int H, int W, int C,
                   int64_t sB, int64_t sD, int64_t sH, int64_t sW, int64_t sC,
                   const Shifts& sh, int K, cudaStream_t stream) {
    const dim3 block(32, 8);
    const dim3 grid((W + block.x - 1) / block.x, (H + block.y - 1) / block.y, B * D);
    const T* ep = static_cast<const T*>(e);
    T* op = static_cast<T*>(out);
    const int64_t strides[5] = {sB, sD, sH, sW, sC};
    const bool contig = contiguous_vectors<T>(e, strides);
    if (C == 8 && contig)
        affinity3d_fwd_kernel<T, 8, true><<<grid, block, 0, stream>>>(
            ep, op, D, H, W, K, sB, sD, sH, sW, sC, sh);
    else if (C == 8)
        affinity3d_fwd_kernel<T, 8, false><<<grid, block, 0, stream>>>(
            ep, op, D, H, W, K, sB, sD, sH, sW, sC, sh);
    else if (C == 16 && contig)
        affinity3d_fwd_kernel<T, 16, true><<<grid, block, 0, stream>>>(
            ep, op, D, H, W, K, sB, sD, sH, sW, sC, sh);
    else if (C == 16)
        affinity3d_fwd_kernel<T, 16, false><<<grid, block, 0, stream>>>(
            ep, op, D, H, W, K, sB, sD, sH, sW, sC, sh);
    else
        return cudaErrorInvalidValue;
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. shifts: host array of K shifts, channel
// k along axis k % 3 of (z, y, x). Returns the cudaError_t of the launch (0
// on success).
int affinity3d_fwd(const void* e, void* out, int dtype,
                   int B, int D, int H, int W, int C,
                   int64_t sB, int64_t sD, int64_t sH, int64_t sW, int64_t sC,
                   const int32_t* shifts, int K, void* stream) {
    if (K < 1 || K > kMaxShifts || B < 1 || D < 1 || H < 1 || W < 1 ||
        (int64_t)B * D > 65535 || H > 65535 * 8)
        return (int)cudaErrorInvalidValue;
    Shifts sh;
    for (int k = 0; k < K; ++k) sh.s[k] = shifts[k];
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0)
        return (int)launch<float>(e, out, B, D, H, W, C, sB, sD, sH, sW, sC, sh, K, s);
    if (dtype == 1)
        return (int)launch<__nv_bfloat16>(e, out, B, D, H, W, C, sB, sD, sH, sW, sC, sh, K, s);
    return (int)cudaErrorInvalidValue;
}

}  // extern "C"
