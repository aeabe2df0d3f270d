// Direct 3x3 convolution with a per-channel scale/shift epilogue and an
// optional ReLU, on the tensor cores of Hopper (sm_90a). One source serves
// three TPU kernels:
//
//   K7  pixel_embedded_affinity_tpu/ops/conv3x3_pallas.py:106 conv3x3_fused
//   K9a pixel_embedded_affinity_tpu/ops/conv3x3_blocked.py:178 conv3x3_blocked
//   K9b pixel_embedded_affinity_tpu/ops/conv3x3_blocked.py:309 conv3x3_blocked_flat
//       (chained by conv3x3_blocked_chain)
//
// Python wrapper: ops/conv3x3_cuda.py.
//
// What it computes. x: (B, H, W, Cin) NHWC, contiguous; w: (3, 3, Cin,
// Cout) HWIO, contiguous, in x's dtype (float32 or bfloat16); scale, shift:
// (Cout,) float32. With off = 1 (SAME, K7 and K9a)
//     out[b, r, c, o] = sum_{dy, dx, i} w[dy, dx, i, o] x[b, r + dy - off, c + dx - off, i]
// accumulated in float32, x read as 0 outside the image, then
// y = acc * scale[o] + shift[o], ReLU if asked, stored in x's dtype; out is
// (B, H, W, Cout). With off = 0 (canvas mode, K9b) x is a zero-bordered
// canvas holding an image at (oy, ox); the conv centred one pixel down and
// right moves the image to (oy - 1, ox - 1), and every output element
// outside the rectangle [r0, r1) x [c0, c1) that the image now covers is
// written as an exact 0, so k chained launches need no re-pad. The TPU's
// blocked-pixel layout of K9a/K9b (128-lane rows) is a layout for its matrix
// unit and has no counterpart here.
//
// Precision and bound. float32 runs as 3xTF32 on the tensor cores: each
// operand is split into a TF32 high part and a TF32 remainder, and
// lo*hi + hi*lo + hi*hi (mma.sync m16n8k8) goes into a fresh float32 sum
// each k-step, which a rounding float32 add folds into the accumulator (the
// tensor cores truncate the sum they carry: one accumulator over K = 9 x 256
// drifted to 1.6e-5 of the largest output). On an H100 that keeps the result
// within 3e-6 of the largest output of cuDNN's float32 conv at Cin = 384,
// where one TF32 pass is ~3e-4 off (tests/test_torch_tensor_core.py
// emulates both). Its bound is 3 x 2 x 9 Cin Cout flops a pixel at 495 TFLOP/s
// (dense TF32): 0.033 ms at 136^2 64 -> 256, against 0.0072 ms of bytes
// (x read once, out written once at 3.35 TB/s). bfloat16 runs one pass of
// mma.sync m16n8k16 at 989 TFLOP/s (0.0055 ms there, bytes 0.0036).
// Operations bound the direct-stage convs; bytes the 3 -> 16 input conv.
//
// Design: an implicit GEMM. M is a tile of 8 x 16 output pixels, N a block
// of 64 output channels, K = 9 taps x Cin in chunks of 8 (float32) or 16
// (bf16) channels, one mma depth. 8 warps, each 2 output rows (two m16
// tiles whose 16 rows are 16 neighbouring pixels of one row) by 32
// channels (four n8 tiles). A chunk's (8 + 2) x (16 + 2) input tile and its
// 9 x chunk x 64 weights come to shared memory by cp.async (16-byte copies,
// zero-filled outside the image and past Cin/Cout; plain loads where Cin or
// Cout is not a multiple of 16 bytes, as for the 3 -> 16 input conv) in a
// ring of 3 stages: two chunks are in flight while the tensor cores work on
// a third. A tap is an offset of the A rows in the staged tile, so the 9
// taps read one tile. Shared memory: 3 x 29,376 bytes for either dtype
// (input rows padded to 12 floats / 24 bf16, weight rows to 72, which keeps
// the fragment loads free of bank conflicts, see mma_tc.cuh), so 2 blocks
// fit an SM; 136^2 64 -> 256 is 612 blocks, 68^2 128 -> 512 360. Float32
// fragments load by ld.shared and split in registers (the weights are not
// pre-split); bf16 fragments by ldmatrix (.trans for the weights).
//
// What it gives up: mma.sync, not wgmma, and cp.async, not TMA (a 3x3 halo
// tile is not one of wgmma's canonical shared-memory layouts without a
// repack, and mma.sync suffices to pass cuDNN); the TF32 split is redone
// for each fragment; float32 spills ~100 bytes a thread at the 128
// registers that 2 blocks an SM allow; a 136-wide image wastes 6% on its
// last column tile, and Cout < 64 (the 3 -> 16 conv) leaves warps idle.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_tc.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int TH = 8;             // output rows a block
constexpr int TW = 16;            // output columns a block (one m16 tile a row)
constexpr int NB = 64;            // output channels a block
constexpr int XH = TH + 2;        // staged input tile rows
constexpr int XW = TW + 2;        // staged input tile columns
constexpr int WS = NB + 8;        // weight row stride in shared memory
constexpr int STAGES = 3;

template <typename T> struct Cfg {
    static constexpr int CK = tc::Mma<T>::K;                     // channels a chunk
    static constexpr int XS = CK + (sizeof(T) == 4 ? 4 : 8);     // pixel stride
    static constexpr int VE = 16 / sizeof(T);                    // elements a 16-byte copy
    static constexpr int X_ELEMS = XH * XW * XS;
    static constexpr int W_ELEMS = 9 * CK * WS;
    static constexpr int STAGE = X_ELEMS + W_ELEMS;
    static constexpr size_t SMEM = (size_t)STAGES * STAGE * sizeof(T);
};

struct Geometry {
    int B, H, W, Cin, Cout;
    int off;             // 1: SAME; 0: canvas mode
    int r0, r1, c0, c1;  // output rectangle written; 0 outside
    int relu;
    int xvec, wvec;      // 16-byte copies for x / w
};

// Stage chunk k0's input tile (origin (y0, x0)) and weights into xs, ws.
template <typename T>
__device__ __forceinline__ void stage_chunk(T* xs, T* ws, const T* __restrict__ xb,
                                            const T* __restrict__ w, const Geometry& g, int k0,
                                            int y0, int x0, int o0) {
    using C = Cfg<T>;
    constexpr int NV = C::CK / C::VE;  // 16-byte vectors a pixel's chunk
    if (g.xvec) {
        for (int i = threadIdx.x; i < XH * XW * NV; i += kThreads) {
            const int p = i / NV, v = i % NV;
            const int yy = y0 + p / XW, xx = x0 + p % XW, ch = k0 + v * C::VE;
            const bool ok = yy >= 0 && yy < g.H && xx >= 0 && xx < g.W && ch < g.Cin;
            const T* src = ok ? xb + ((int64_t)yy * g.W + xx) * g.Cin + ch : xb;
            tc::cp_async16(xs + p * C::XS + v * C::VE, src, ok);
        }
    } else {
        for (int i = threadIdx.x; i < XH * XW * C::CK; i += kThreads) {
            const int p = i / C::CK, k = i % C::CK;
            const int yy = y0 + p / XW, xx = x0 + p % XW, ch = k0 + k;
            T v = tc::from_float<T>(0.f);
            if (yy >= 0 && yy < g.H && xx >= 0 && xx < g.W && ch < g.Cin)
                v = xb[((int64_t)yy * g.W + xx) * g.Cin + ch];
            xs[p * C::XS + k] = v;
        }
    }
    if (g.wvec) {
        constexpr int NVW = NB / C::VE;
        for (int i = threadIdx.x; i < 9 * C::CK * NVW; i += kThreads) {
            const int row = i / NVW, v = i % NVW;  // row = tap * CK + k
            const int tap = row / C::CK, ch = k0 + row % C::CK, oc = o0 + v * C::VE;
            const bool ok = ch < g.Cin && oc < g.Cout;
            const T* src = ok ? w + ((int64_t)tap * g.Cin + ch) * g.Cout + oc : w;
            tc::cp_async16(ws + row * WS + v * C::VE, src, ok);
        }
    } else {
        for (int i = threadIdx.x; i < 9 * C::CK * NB; i += kThreads) {
            const int row = i / NB, n = i % NB;
            const int tap = row / C::CK, ch = k0 + row % C::CK, oc = o0 + n;
            T v = tc::from_float<T>(0.f);
            if (ch < g.Cin && oc < g.Cout) v = w[((int64_t)tap * g.Cin + ch) * g.Cout + oc];
            ws[row * WS + n] = v;
        }
    }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
conv3x3_kernel(const T* __restrict__ x, const T* __restrict__ w,
               const float* __restrict__ scale, const float* __restrict__ shift,
               T* __restrict__ out, Geometry g) {
    using C = Cfg<T>;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* smem = reinterpret_cast<T*>(smem_raw);

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int wm = warp & 3, wn = warp >> 2;  // output rows 2 wm, 2 wm + 1; channels 32 wn
    const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
    const int n_co = (g.Cout + NB - 1) / NB;
    const int b = blockIdx.z / n_co;
    const int o0 = (blockIdx.z % n_co) * NB;
    const bool active = o0 + 32 * wn < g.Cout;

    int arow[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
        tc::lane_rows<T>(arow[i], [&](int r) { return (2 * wm + i) * XW + r; });

    float acc[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

    const T* xb = x + (int64_t)b * g.H * g.W * g.Cin;
    const int nch = (g.Cin + C::CK - 1) / C::CK;
    tc::pipeline<STAGES>(
        nch,
        [&](int c, int s) {
            T* xs = smem + s * C::STAGE;
            stage_chunk<T>(xs, xs + C::X_ELEMS, xb, w, g, c * C::CK, y0 - g.off, x0 - g.off, o0);
        },
        [&](int, int s) {
            if (!active) return;
            const T* xs = smem + s * C::STAGE;
            const T* ws = xs + C::X_ELEMS;
#pragma unroll 1
            for (int dy = 0; dy < 3; ++dy)
#pragma unroll
                for (int dx = 0; dx < 3; ++dx)
                    tc::mma_step<2, 4>(acc, xs, C::XS, arow, dy * XW + dx,
                                       ws + (3 * dy + dx) * C::CK * WS, WS, 32 * wn);
        });
    if (!active) return;

    const int gq = lane >> 2, t = lane & 3;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int yy = y0 + 2 * wm + i;
        if (yy >= g.H) continue;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int xx = x0 + gq + 8 * half;
            if (xx >= g.W) continue;
            const bool inside = yy >= g.r0 && yy < g.r1 && xx >= g.c0 && xx < g.c1;
            T* op = out + (((int64_t)b * g.H + yy) * g.W + xx) * g.Cout;
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int oc = o0 + 32 * wn + 8 * j + 2 * t + e;
                    if (oc >= g.Cout) continue;
                    float v = acc[i][j][2 * half + e] * scale[oc] + shift[oc];
                    if (g.relu) v = fmaxf(v, 0.f);
                    op[oc] = tc::from_float<T>(inside ? v : 0.f);
                }
        }
    }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const float* scale, const float* shift,
                   void* out, Geometry g, cudaStream_t stream) {
    using C = Cfg<T>;
    static bool configured = false;
    if (!configured) {
        const cudaError_t err = cudaFuncSetAttribute(
            conv3x3_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
        if (err != cudaSuccess) return err;
        configured = true;
    }
    g.xvec = g.Cin % C::VE == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
    g.wvec = g.Cout % C::VE == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
    const int n_co = (g.Cout + NB - 1) / NB;
    const dim3 grid((g.W + TW - 1) / TW, (g.H + TH - 1) / TH, g.B * n_co);
    if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidValue;
    conv3x3_kernel<T><<<grid, kThreads, C::SMEM, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(w), scale, shift,
        static_cast<T*>(out), g);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, w and out). off: 1 for SAME, 0 for
// the canvas mode; [r0, r1) x [c0, c1) the output rectangle kept (the whole
// output for SAME). Returns the cudaError_t of the launch (0 on success).
int conv3x3_fwd(const void* x, const void* w, const float* scale, const float* shift,
                void* out, int dtype, int B, int H, int W, int Cin, int Cout,
                int off, int r0, int r1, int c0, int c1, int relu, void* stream) {
    if (B < 1 || H < 1 || W < 1 || Cin < 1 || Cout < 1 || (off != 0 && off != 1))
        return (int)cudaErrorInvalidValue;
    const Geometry g{B, H, W, Cin, Cout, off, r0, r1, c0, c1, relu, 0, 0};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0) return (int)launch<float>(x, w, scale, shift, out, g, s);
    if (dtype == 1) return (int)launch<__nv_bfloat16>(x, w, scale, shift, out, g, s);
    return (int)cudaErrorInvalidValue;
}

}  // extern "C"
