// Fused embedding -> multi-offset affinity, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel pixel_embedded_affinity_tpu/ops/emb2aff_pallas.py
// ::_affinity_kernel (pl.pallas_call in _fused_affinity_2d_fwd_impl, public
// entry fused_affinity_2d). Python wrapper: ops/emb2aff_cuda.py.
//
// What it computes. e: (B, H, W, C) with arbitrary element strides, float32
// or bfloat16. For offset k,
//     a_k(p) = <n(p), n(p + o_k)>,  n = e / max(sqrt(|e|^2 + 1e-36), 1e-12),
// with the normalisation and the dot in float32 whatever the storage type,
// and a_k(p) = 0 where p + o_k lies outside the image ('valid' padding).
// out: (B, K, H, W), contiguous, in the input's dtype.
//
// Bound. HBM bytes: each input element read once and each output written
// once. At 544x544, C=16, K=10, float32 that is 18.9 MB read + 11.8 MB
// written = 30.8 MB per image, 9.2 us at 3.35 TB/s (half that for bfloat16
// in and out). The arithmetic, about 3*C + 2*C*K flops per pixel, needs
// ~1.6 us at the 67 TFLOP/s float32 rate, so bytes bound it.
//
// Design. One thread per output pixel, 32x8 blocks with a warp along x,
// so that a warp's load of one channel plane and its store of one output
// plane are each contiguous in the NCHW view the callers pass. The thread
// normalises its own vector once (load_unit: one reciprocal of the norm)
// and, for each offset, gathers the neighbour's raw values v plane-wise
// through the view's strides and takes a_k = <n, v> r with r = inv_norm(v),
// one reciprocal square root (affinity_load.cuh): no value is divided. The
// exact zeros need no branch: a zero neighbour gives <n, v> = 0, times r =
// 1e12, and a zero own vector n = 0. The repeats of a neighbour's loads
// (each pixel is gathered by K others) mostly hit L1/L2, not HBM; no
// shared-memory tile is staged, since its halo would be 27 pixels and the
// staged forms of the 3D kernels lost to this gather by 1.45-3.2x
// (tools/affinity_zwalk.cu).
//
// On an NVIDIA H100 80GB HBM3 at 700 W (544x544, C=16, neighbor 4's 10
// offsets, the NCHW view, L2 flushed, CUDA graph replay, median of 20;
// tools/wmse_ab.py, two runs beside the first version, which divided
// every value it normalised): float32 B=1 0.0344-0.0370 ms (before
// 0.0490-0.0520; bound 0.0092), B=4 0.0912-0.0920 (0.1575-0.1601; bound
// 0.0367), B=8 0.1668-0.1718 (0.2997-0.3090; bound 0.0735); bfloat16 by
// the same factors, B=1 0.0341-0.0346 (0.0485-0.0518). ptxas: 42
// registers in float32 at C=16, 40 in bfloat16, 32 at C=8, no spills
// (before 56, 53, 40). 32x4 blocks tied at B=1 and 8 and lost 4% at B=4 in
// float32; a cap of 40 registers (6 blocks an SM) spilled 4 bytes and lost
// up to 11%: neither ships.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "affinity_load.cuh"

namespace {

using namespace affinity_load;

constexpr int kMaxOffsets = 64;
constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

struct Offsets {
    int dy[kMaxOffsets];
    int dx[kMaxOffsets];
};

template <typename T, int C>
__global__ void __launch_bounds__(kBlockX * kBlockY)
affinity2d_fwd_kernel(const T* __restrict__ e, T* __restrict__ out, int H, int W, int K,
                      int64_t sB, int64_t sH, int64_t sW, int64_t sC, Offsets off) {
    const int x = blockIdx.x * kBlockX + threadIdx.x;
    const int y = blockIdx.y * kBlockY + threadIdx.y;
    const int b = blockIdx.z;
    if (x >= W || y >= H) return;

    const T* eb = e + b * sB;
    float n[C];
    load_unit<T, C, false>(eb + y * sH + x * sW, sC, false, n);

    const int64_t plane = (int64_t)H * W;
    T* o = out + (int64_t)b * K * plane + (int64_t)y * W + x;
    for (int k = 0; k < K; ++k) {
        const int yy = y + off.dy[k];
        const int xx = x + off.dx[k];
        float a = 0.f;
        if (yy >= 0 && yy < H && xx >= 0 && xx < W) {
            float v[C];
            const float r = load_scaled<T, C, false>(eb + yy * sH + xx * sW, sC, false, v);
            a = dot<C>(n, v) * r;
        }
        o[k * plane] = from_float<T>(a);
    }
}

template <typename T>
cudaError_t launch(const void* e, void* out, int B, int H, int W, int C,
                   int64_t sB, int64_t sH, int64_t sW, int64_t sC,
                   const Offsets& off, int K, cudaStream_t stream) {
    const dim3 block(kBlockX, kBlockY);
    const dim3 grid((W + kBlockX - 1) / kBlockX, (H + kBlockY - 1) / kBlockY, B);
    const T* ep = static_cast<const T*>(e);
    T* op = static_cast<T*>(out);
    switch (C) {
        case 8:
            affinity2d_fwd_kernel<T, 8><<<grid, block, 0, stream>>>(ep, op, H, W, K, sB, sH, sW, sC, off);
            break;
        case 16:
            affinity2d_fwd_kernel<T, 16><<<grid, block, 0, stream>>>(ep, op, H, W, K, sB, sH, sW, sC, off);
            break;
        default:
            return cudaErrorInvalidValue;
    }
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. offsets: host array of K (dy, dx) pairs.
// Returns the cudaError_t of the launch (0 on success).
int affinity2d_fwd(const void* e, void* out, int dtype,
                   int B, int H, int W, int C,
                   int64_t sB, int64_t sH, int64_t sW, int64_t sC,
                   const int32_t* offsets, int K, void* stream) {
    if (K < 1 || K > kMaxOffsets || B < 1 || H < 1 || W < 1 || B > 65535)
        return (int)cudaErrorInvalidValue;
    Offsets off;
    for (int k = 0; k < K; ++k) {
        off.dy[k] = offsets[2 * k];
        off.dx[k] = offsets[2 * k + 1];
    }
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0)
        return (int)launch<float>(e, out, B, H, W, C, sB, sH, sW, sC, off, K, s);
    if (dtype == 1)
        return (int)launch<__nv_bfloat16>(e, out, B, H, W, C, sB, sH, sW, sC, off, K, s);
    return (int)cudaErrorInvalidValue;
}

}  // extern "C"
