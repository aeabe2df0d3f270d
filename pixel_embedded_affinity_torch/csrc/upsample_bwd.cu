// Backward of the x2 align-corners bilinear upsampling, without atomics, for
// Hopper (sm_90a).
//
// Replaces no TPU kernel. The models' decoders upsample by 2 in y and x
// with align_corners=True (models/common.py: the 2D bilinear upsampling and
// the 3D (1, 2, 2) trilinear one, whose z weights are exactly 1). PyTorch's
// own CUDA backward of F.interpolate scatters each output gradient into its
// four sources with atomic adds, so the sums land in another order on every
// run and two training runs from one seed drift apart (7.4e-5 to 1.3e-4 of
// the losses over a few steps on the H100). This kernel gathers instead:
// each input element sums, in a fixed order, the output gradients that read
// it, so a step gives the same bits on every run. Python wrapper:
// ops/upsample_cuda.py (the autograd Function whose forward is PyTorch's).
//
// What it computes. g: (P, OH, OW) contiguous (P = N*C, or N*C*D for the
// 3D case), OH = 2H, OW = 2W; out: (P, H, W) contiguous,
//     out[p, i, j] = sum_a ty[i, a] * sum_b tx[j, b] * g[p, 2i - 2 + a, 2j - 2 + b],
// a, b in 0..4, skipping zero taps, in increasing order. ty[i, a] is the
// weight with which the forward's output row 2i - 2 + a reads input row i
// (0 where it does not or lies outside), tx likewise for columns: only
// outputs 2i - 2 .. 2i + 2 can read input i (the align-corners source of
// output o, o (n - 1) / (2n - 1), lies in [o/2 - 1/2, o/2]). The wrapper
// takes the taps from the forward itself on the same device (PyTorch's
// CUDA and CPU kernels round the source index differently at some sizes),
// so the gradient is the transpose of the forward actually run. float32
// and bfloat16 storage accumulate in float32, float64 in float64.

// Bound. HBM bytes: g read once (4 elements an input element) and out
// written once, 5 x numel(out) x itemsize; the arithmetic (4 multiply-adds
// an output gradient) is far below the float32 rate. The CVPPP model's
// largest upsampling, its up4 input (B=2, 96 channels, 272^2 -> 544^2,
// float32), moves 2 x 96 x 272^2 x 20 bytes = 284 MB: 84.8 us at 3.35 TB/s.
//
// Design: one thread an input element, threads of a warp along x so the
// reads of g (a warp reads 68 consecutive values of each of its rows) and
// the stores coalesce; blocks of 32x8 over (x, y), planes along grid z with
// a stride loop. The 5 + 5 tap weights are read once a thread into
// registers and reused for every plane. Each output element is read by
// about four input elements, so L1 serves most of the reads.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTaps = 5;

template <typename T> struct Acc { using type = float; };
template <> struct Acc<double> { using type = double; };

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ double load(const double* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(double* p, double v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T>
__global__ void __launch_bounds__(256)
upsample_bwd_kernel(const T* __restrict__ g, T* __restrict__ out, int P, int H, int W,
                    const typename Acc<T>::type* __restrict__ ty,
                    const typename Acc<T>::type* __restrict__ tx) {
    using A = typename Acc<T>::type;
    const int j = blockIdx.x * blockDim.x + threadIdx.x;
    const int i = blockIdx.y * blockDim.y + threadIdx.y;
    if (i >= H || j >= W) return;
    const int OW = 2 * W;
    // only outputs 2i - 2 .. 2i + 2 can read input i; the taps stay in
    // registers (every index is known at compile time)
    A wy[kTaps], wx[kTaps];
#pragma unroll
    for (int a = 0; a < kTaps; ++a) {
        wy[a] = ty[i * kTaps + a];
        wx[a] = tx[j * kTaps + a];
    }
    const int OH = 2 * H;
    for (int p = blockIdx.z; p < P; p += gridDim.z) {
        const T* gp = g + (int64_t)p * OH * OW;
        A acc = (A)0;
#pragma unroll
        for (int a = 0; a < kTaps; ++a) {
            if (wy[a] == (A)0) continue;
            const T* row = gp + (int64_t)(2 * i - 2 + a) * OW + (2 * j - 2);
            A r = (A)0;
#pragma unroll
            for (int b = 0; b < kTaps; ++b)
                if (wx[b] != (A)0) r += wx[b] * load(row + b);
            acc += wy[a] * r;
        }
        store(out + ((int64_t)p * H + i) * W + j, acc);
    }
}

template <typename T>
cudaError_t launch(const void* g, void* out, int P, int H, int W, const void* ty,
                   const void* tx, cudaStream_t stream) {
    using A = typename Acc<T>::type;
    const dim3 block(32, 8);
    const dim3 grid((W + 31) / 32, (H + 7) / 8, P < 65535 ? P : 65535);
    upsample_bwd_kernel<T><<<grid, block, 0, stream>>>(
        static_cast<const T*>(g), static_cast<T*>(out), P, H, W, static_cast<const A*>(ty),
        static_cast<const A*>(tx));
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, 2 = float64. g: (P, 2H, 2W) and out:
// (P, H, W), both contiguous device arrays; ty: (H, 5) and tx: (W, 5), the
// tap weights in the accumulation type (float64 for float64, else float32).
// Returns the cudaError_t of the launch (0 on success).
int upsample_bwd(const void* g, void* out, int dtype, int P, int H, int W, const void* ty,
                 const void* tx, void* stream) {
    if (P < 1 || H < 1 || W < 1 || H > 65535 * 8) return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (dtype) {
        case 0: return (int)launch<float>(g, out, P, H, W, ty, tx, st);
        case 1: return (int)launch<__nv_bfloat16>(g, out, P, H, W, ty, tx, st);
        case 2: return (int)launch<double>(g, out, P, H, W, ty, tx, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // extern "C"
