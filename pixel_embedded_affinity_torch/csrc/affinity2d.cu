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
// Design, the simple first version: one thread per output pixel, threads
// of a warp along x so the output stores coalesce. The thread keeps its own
// normalised vector in registers and, for each offset, loads the
// neighbour's C values, normalises them and takes the dot. What it gives
// up: every neighbour vector is loaded and normalised K times (the repeats
// mostly hit L1/L2, not HBM), and no shared-memory tile with a 27-pixel
// halo is staged.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxOffsets = 64;

struct Offsets {
    int dy[kMaxOffsets];
    int dx[kMaxOffsets];
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
    return __float2bfloat16(v);
}

// n[c] = v[c] / max(sqrt(sum v^2 + 1e-36), 1e-12), in float32
template <typename T, int C>
__device__ __forceinline__ void load_normalized(const T* __restrict__ v, int64_t sC, float* n) {
    float ss = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
        n[c] = to_float(v[c * sC]);
        ss += n[c] * n[c];
    }
    const float d = fmaxf(sqrtf(ss + 1e-36f), 1e-12f);
#pragma unroll
    for (int c = 0; c < C; ++c) n[c] = n[c] / d;
}

template <typename T, int C>
__global__ void affinity2d_fwd_kernel(const T* __restrict__ e, T* __restrict__ out,
                                      int H, int W, int K,
                                      int64_t sB, int64_t sH, int64_t sW, int64_t sC,
                                      Offsets off) {
    const int x = blockIdx.x * blockDim.x + threadIdx.x;
    const int y = blockIdx.y * blockDim.y + threadIdx.y;
    const int b = blockIdx.z;
    if (x >= W || y >= H) return;

    const T* eb = e + b * sB;
    float n0[C];
    load_normalized<T, C>(eb + y * sH + x * sW, sC, n0);

    const int64_t plane = (int64_t)H * W;
    T* o = out + (int64_t)b * K * plane + (int64_t)y * W + x;
    for (int k = 0; k < K; ++k) {
        const int yy = y + off.dy[k];
        const int xx = x + off.dx[k];
        float a = 0.f;
        if (yy >= 0 && yy < H && xx >= 0 && xx < W) {
            float n1[C];
            load_normalized<T, C>(eb + yy * sH + xx * sW, sC, n1);
#pragma unroll
            for (int c = 0; c < C; ++c) a += n0[c] * n1[c];
        }
        o[k * plane] = from_float<T>(a);
    }
}

template <typename T>
cudaError_t launch(const void* e, void* out, int B, int H, int W, int C,
                   int64_t sB, int64_t sH, int64_t sW, int64_t sC,
                   const Offsets& off, int K, cudaStream_t stream) {
    const dim3 block(32, 8);
    const dim3 grid((W + block.x - 1) / block.x, (H + block.y - 1) / block.y, B);
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
