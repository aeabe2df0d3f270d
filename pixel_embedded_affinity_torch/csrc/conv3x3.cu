// Direct 3x3 convolution with a per-channel scale/shift epilogue and an
// optional ReLU, for Hopper (sm_90a). One source serves three TPU kernels:
//
//   K7  pixel_embedded_affinity_tpu/ops/conv3x3_pallas.py::conv3x3_fused
//   K9a pixel_embedded_affinity_tpu/ops/conv3x3_blocked.py::conv3x3_blocked
//   K9b pixel_embedded_affinity_tpu/ops/conv3x3_blocked.py::conv3x3_blocked_flat
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
// Bound. Float32 has no tensor-core path with TF32 off, so the multiply-adds
// run on the CUDA cores: 2 * 9 * Cin * Cout flops a pixel at 67 TFLOP/s. At
// the fast forward's direct-stage shapes (136^2 and 68^2, Cin >= 64) that is
// 4-70x the time of the bytes (x read once, out written once at 3.35 TB/s):
// operations bound every one of them but the 3 -> 16 input conv.
//
// Design, the simple first version. A block of 256 threads computes an 8x16
// tile of output pixels for 64 output channels. Input channels go in chunks
// of 8: the chunk's (8 + 2) x (16 + 2) input tile and its 9 x 8 x 64 weights
// are staged in shared memory as float. Each warp owns 8 output channels,
// so all its lanes read the same weights (a broadcast, as float4); each lane
// owns one column and 4 consecutive rows, so the 3 vertical taps of a column
// share 6 input loads: 6 + 6 shared loads for 96 FMAs. The input plane's
// row stride is padded to 20 and its channel stride to 204 so these loads and
// the staging stores meet no bank conflicts. What it gives up: no cp.async or
// TMA double buffering (two barriers per chunk), no tensor cores, and blocks
// with Cout < 64 leave warps idle.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int TH = 8;                        // output rows a block
constexpr int TW = 16;                       // output columns a block
constexpr int CK = 8;                        // input channels a chunk
constexpr int NCO = 64;                      // output channels a block: 8 warps x 8
constexpr int XROW = TW + 4;                 // staged row stride (TW + 2 padded)
constexpr int XPLANE = (TH + 2) * XROW + 4;  // staged channel stride (padded)

struct Geometry {
    int B, H, W, Cin, Cout;
    int off;             // 1: SAME; 0: canvas mode
    int r0, r1, c0, c1;  // output rectangle written; 0 outside
    int relu;
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
    return __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
conv3x3_kernel(const T* __restrict__ x, const T* __restrict__ w,
               const float* __restrict__ scale, const float* __restrict__ shift,
               T* __restrict__ out, Geometry g) {
    __shared__ float xs[CK * XPLANE];
    __shared__ __align__(16) float ws[9 * CK * NCO];  // [tap][k][o]

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int x0 = blockIdx.x * TW;
    const int y0 = blockIdx.y * TH;
    const int n_co = (g.Cout + NCO - 1) / NCO;
    const int b = blockIdx.z / n_co;
    const int o0 = (blockIdx.z % n_co) * NCO;
    const int col = lane & 15;        // the lane's output column in the tile
    const int rb = (lane >> 4) * 4;   // the first of its 4 output rows
    const int ow = warp * 8;          // the warp's first output channel in the block
    const bool active = o0 + ow < g.Cout;

    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    const T* xb = x + (int64_t)b * g.H * g.W * g.Cin;
    for (int k0 = 0; k0 < g.Cin; k0 += CK) {
        __syncthreads();
        for (int i = tid; i < CK * (TH + 2) * (TW + 2); i += kThreads) {
            const int k = i % CK;
            const int p = i / CK;
            const int rr = p / (TW + 2), cc = p % (TW + 2);
            const int yy = y0 - g.off + rr, xx = x0 - g.off + cc, ch = k0 + k;
            float v = 0.f;
            if (yy >= 0 && yy < g.H && xx >= 0 && xx < g.W && ch < g.Cin)
                v = to_float(xb[((int64_t)yy * g.W + xx) * g.Cin + ch]);
            xs[k * XPLANE + rr * XROW + cc] = v;
        }
        for (int i = tid; i < 9 * CK * NCO; i += kThreads) {
            const int o = i % NCO;
            const int k = (i / NCO) % CK;
            const int tap = i / (NCO * CK);
            const int ch = k0 + k, oc = o0 + o;
            float v = 0.f;
            if (ch < g.Cin && oc < g.Cout)
                v = to_float(w[((int64_t)tap * g.Cin + ch) * g.Cout + oc]);
            ws[i] = v;
        }
        __syncthreads();
        if (!active) continue;
#pragma unroll 2
        for (int k = 0; k < CK; ++k) {
            const float* xk = xs + k * XPLANE + rb * XROW + col;
#pragma unroll
            for (int dx = 0; dx < 3; ++dx) {
                float xv[6];
#pragma unroll
                for (int r = 0; r < 6; ++r) xv[r] = xk[r * XROW + dx];
#pragma unroll
                for (int dy = 0; dy < 3; ++dy) {
                    const float4* wp = reinterpret_cast<const float4*>(
                        ws + ((dy * 3 + dx) * CK + k) * NCO + ow);
                    const float4 wa = wp[0], wb = wp[1];
                    const float wv[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
                    for (int i = 0; i < 4; ++i)
#pragma unroll
                        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(xv[i + dy], wv[j], acc[i][j]);
                }
            }
        }
    }
    if (!active) return;

    const int xx = x0 + col;
    float sc[8], sh[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        const int oc = o0 + ow + j;
        sc[j] = oc < g.Cout ? scale[oc] : 0.f;
        sh[j] = oc < g.Cout ? shift[oc] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int yy = y0 + rb + i;
        if (yy >= g.H || xx >= g.W) continue;
        const bool inside = yy >= g.r0 && yy < g.r1 && xx >= g.c0 && xx < g.c1;
        T* o = out + (((int64_t)b * g.H + yy) * g.W + xx) * g.Cout + o0 + ow;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            if (o0 + ow + j >= g.Cout) break;
            float v = acc[i][j] * sc[j] + sh[j];
            if (g.relu) v = fmaxf(v, 0.f);
            o[j] = from_float<T>(inside ? v : 0.f);
        }
    }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const float* scale, const float* shift,
                   void* out, const Geometry& g, cudaStream_t stream) {
    const int n_co = (g.Cout + NCO - 1) / NCO;
    const dim3 grid((g.W + TW - 1) / TW, (g.H + TH - 1) / TH, g.B * n_co);
    if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidValue;
    conv3x3_kernel<T><<<grid, kThreads, 0, stream>>>(
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
    const Geometry g{B, H, W, Cin, Cout, off, r0, r1, c0, c1, relu};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0) return (int)launch<float>(x, w, scale, shift, out, g, s);
    if (dtype == 1) return (int)launch<__nv_bfloat16>(x, w, scale, shift, out, g, s);
    return (int)cudaErrorInvalidValue;
}

}  // extern "C"
