// int8 serving on Hopper (sm_90a): two kernels, neither with a TPU site.
// The JAX package computes both outside Pallas (pixel_embedded_affinity_tpu/
// ops/quant.py: conv_i8 is an XLA conv with preferred_element_type=int32,
// quantize_act a jnp expression), and no PyTorch call computes an int8
// convolution on the card (F.conv2d refuses int8 there; torch._int_mm
// needs an im2col of kh x kw times the activation's bytes).
//
// Python wrapper: ops/conv_i8_cuda.py.
//
// I8c, conv_i8_fwd. x: (B, H, W, Cin) NHWC int8, contiguous; w: the packed
// (Cout, kh * kw * Cin) int8 weights, K order (dy, dx, ci) contiguous (the
// mma's col operand); scale: (Cout,) float32; shift: (Cout,) float32 or
// null. With the padding (pt, pb, pl, pr) the output is (B, Ho, Wo, Cout)
// float32, Ho = H + pt + pb - kh + 1, Wo = W + pl + pr - kw + 1:
//     acc[b, r, c, o] = sum_{dy, dx, i} w[o, dy, dx, i] x[b, r + dy - pt, c + dx - pl, i]
// in int32 (x read as 0 outside the image; exact: |acc| <= 127^2 kh kw Cin),
// then out = __fadd_rn(__fmul_rn(float(acc), scale[o]), shift[o]) with no
// contracted multiply-add, so the card's result equals the plain version's
// (acc converted to float32, times scale, plus shift) to the bit.
//
// Design: an implicit GEMM on the int8 tensor cores, mma.sync m16n8k32
// (s8 x s8 -> s32). M is a tile of 8 x 16 output pixels, N a block of 64
// output channels, K = kh kw taps x Cin in chunks of 32 channels (one mma
// depth). 8 warps, each 2 output rows (two m16 tiles whose 16 rows are 16
// neighbouring pixels of one row) by 32 channels (four n8 tiles). A chunk's
// (8 + kh - 1) x (16 + kw - 1) input tile and its kh kw x 64 x 32 weights
// come to shared memory by cp.async (16-byte copies, zero-filled outside
// the image, past Cin (the K tail) and past Cout; byte loads where Cin is not
// a multiple of 16) in a ring of 3 stages; a tap is an offset of the A rows
// in the staged tile. Rows are 48 bytes apart in shared memory (an odd
// multiple of 16: ldmatrix's 8 rows fall in 8 distinct 16-byte slots), and
// both operands load by ldmatrix (the s8 fragments sit at bf16's byte
// positions, mma_tc.cuh). A 3x3 stage is 36,288 bytes, 3 stages 108,864,
// two blocks an SM.
//
// Bound: 2 kh kw Cin Cout operations a pixel at 1,979 TOPS (dense int8)
// against the bytes (x once, out once as float32, w once) at 3.35 TB/s:
// the float32 output makes most of the 15 served sites bound by bytes.
// What it gives up: mma.sync, not wgmma; cp.async, not TMA; no persistent
// tile order; int8 output (a fused requantize) is not offered, since the
// JAX op returns float32.
//
// I8q, quantize_i8. x float32 or bfloat16, n elements -> int8:
// clip(rint(float(x) * inv), -127, 127), rounding half to even as
// jnp.round and torch.round do (rintf, not roundf). An elementwise pass,
// bound by its bytes (4 or 2 in, 1 out).

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_tc.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int TH = 8;        // output rows a block
constexpr int TW = 16;       // output columns a block (one m16 tile a row)
constexpr int NB = 64;       // output channels a block
constexpr int CK = 32;       // channels (bytes) a chunk: one mma depth
constexpr int RS = 48;       // shared-memory row stride in bytes
constexpr int STAGES = 3;
constexpr size_t kSmemLimit = 232448;

struct Geometry {
    int B, H, W, Cin, Cout, kh, kw, pt, pl, Ho, Wo;
    int XH, XW;          // staged input tile
    int x_bytes;         // a stage's input tile bytes
    int stage;           // a stage's bytes
    int vec;             // 16-byte copies (Cin % 16 == 0, aligned)
};

__device__ __forceinline__ void stage_chunk(int8_t* xs, int8_t* ws, const int8_t* __restrict__ xb,
                                            const int8_t* __restrict__ w, const Geometry& g,
                                            int k0, int y0, int x0, int o0) {
    const int taps = g.kh * g.kw;
    const int64_t kt = (int64_t)taps * g.Cin;  // a packed weight row
    if (g.vec) {
        for (int i = threadIdx.x; i < g.XH * g.XW * 2; i += kThreads) {
            const int p = i >> 1, v = i & 1;
            const int yy = y0 + p / g.XW, xx = x0 + p % g.XW, ch = k0 + 16 * v;
            const bool ok = yy >= 0 && yy < g.H && xx >= 0 && xx < g.W && ch < g.Cin;
            const int8_t* src = ok ? xb + ((int64_t)yy * g.W + xx) * g.Cin + ch : xb;
            tc::cp_async16(xs + p * RS + 16 * v, src, ok);
        }
        for (int i = threadIdx.x; i < taps * NB * 2; i += kThreads) {
            const int row = i >> 1, v = i & 1;  // row = tap * NB + n
            const int tap = row / NB, oc = o0 + row % NB, ch = k0 + 16 * v;
            const bool ok = oc < g.Cout && ch < g.Cin;
            const int8_t* src = ok ? w + oc * kt + (int64_t)tap * g.Cin + ch : w;
            tc::cp_async16(ws + row * RS + 16 * v, src, ok);
        }
    } else {
        for (int i = threadIdx.x; i < g.XH * g.XW * CK; i += kThreads) {
            const int p = i / CK, k = i % CK;
            const int yy = y0 + p / g.XW, xx = x0 + p % g.XW, ch = k0 + k;
            int8_t v = 0;
            if (yy >= 0 && yy < g.H && xx >= 0 && xx < g.W && ch < g.Cin)
                v = xb[((int64_t)yy * g.W + xx) * g.Cin + ch];
            xs[p * RS + k] = v;
        }
        for (int i = threadIdx.x; i < taps * NB * CK; i += kThreads) {
            const int row = i / CK, k = i % CK;
            const int tap = row / NB, oc = o0 + row % NB, ch = k0 + k;
            int8_t v = 0;
            if (oc < g.Cout && ch < g.Cin) v = w[oc * kt + (int64_t)tap * g.Cin + ch];
            ws[row * RS + k] = v;
        }
    }
}

__global__ void __launch_bounds__(kThreads, 2)
conv_i8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
               const float* __restrict__ scale, const float* __restrict__ shift,
               float* __restrict__ out, Geometry g) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    int8_t* smem = reinterpret_cast<int8_t*>(smem_raw);

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int wm = warp & 3, wn = warp >> 2;  // output rows 2 wm, 2 wm + 1; channels 32 wn
    const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
    const int n_co = (g.Cout + NB - 1) / NB;
    const int b = blockIdx.z / n_co;
    const int o0 = (blockIdx.z % n_co) * NB;
    const bool active = o0 + 32 * wn < g.Cout;

    int acc[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

    // the lane's ldmatrix rows: A pixel (lane & 15) of the m-tile's row,
    // byte half (lane >> 4); B channel 8 (lane >> 4) + (lane & 7) of an
    // n-tile pair, byte half (lane >> 3) & 1
    const int a_off = (lane & 15) * RS + (lane >> 4) * 16;
    const int b_off = (32 * wn + (lane & 7) + 8 * (lane >> 4)) * RS + ((lane >> 3) & 1) * 16;
    const int8_t* xb = x + (int64_t)b * g.H * g.W * g.Cin;
    const int nch = (g.Cin + CK - 1) / CK;
    tc::pipeline<STAGES>(
        nch,
        [&](int c, int s) {
            int8_t* xs = smem + s * g.stage;
            stage_chunk(xs, xs + g.x_bytes, xb, w, g, c * CK, y0 - g.pt, x0 - g.pl, o0);
        },
        [&](int, int s) {
            if (!active) return;
            const int8_t* xs = smem + s * g.stage;
            const int8_t* ws = xs + g.x_bytes;
#pragma unroll 1
            for (int dy = 0; dy < g.kh; ++dy)
#pragma unroll 1
                for (int dx = 0; dx < g.kw; ++dx) {
                    const int8_t* wt = ws + (dy * g.kw + dx) * NB * RS + b_off;
                    uint32_t bf[4][2];
#pragma unroll
                    for (int j = 0; j < 4; j += 2) {
                        uint32_t r[4];
                        tc::ldmatrix_x4(r, wt + 8 * j * RS);
                        bf[j][0] = r[0];
                        bf[j][1] = r[1];
                        bf[j + 1][0] = r[2];
                        bf[j + 1][1] = r[3];
                    }
#pragma unroll
                    for (int i = 0; i < 2; ++i) {
                        uint32_t a[4];
                        tc::ldmatrix_x4(a, xs + ((2 * wm + i + dy) * g.XW + dx) * RS + a_off);
#pragma unroll
                        for (int j = 0; j < 4; ++j) tc::mma_s8(acc[i][j], a, bf[j][0], bf[j][1]);
                    }
                }
        });
    if (!active) return;

    const int gq = lane >> 2, t = lane & 3;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int yy = y0 + 2 * wm + i;
        if (yy >= g.Ho) continue;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int xx = x0 + gq + 8 * half;
            if (xx >= g.Wo) continue;
            float* op = out + (((int64_t)b * g.Ho + yy) * g.Wo + xx) * g.Cout;
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int oc = o0 + 32 * wn + 8 * j + 2 * t + e;
                    if (oc >= g.Cout) continue;
                    if (!scale) {  // the accumulator itself
                        reinterpret_cast<int*>(op)[oc] = acc[i][j][2 * half + e];
                        continue;
                    }
                    float v = __fmul_rn(__int2float_rn(acc[i][j][2 * half + e]), scale[oc]);
                    if (shift) v = __fadd_rn(v, shift[oc]);
                    op[oc] = v;
                }
        }
    }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
quantize_kernel(const T* __restrict__ x, int8_t* __restrict__ out, float inv, int64_t n) {
    for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n;
         i += (int64_t)gridDim.x * kThreads) {
        const float v = __fmul_rn(tc::to_float(x[i]), inv);
        out[i] = (int8_t)__float2int_rn(fminf(fmaxf(v, -127.f), 127.f));
    }
}

}  // namespace

extern "C" {

// The padding is (top, bottom, left, right). With scale null, out receives
// the int32 accumulators (the same layout, 4 bytes each). Returns the cudaError_t of the
// launch (0 on success); cudaErrorInvalidValue for a shape it does not take
// (an empty output, a window whose stages exceed the shared memory).
int conv_i8_fwd(const void* x, const void* w, const float* scale, const float* shift,
                float* out, int B, int H, int W, int Cin, int Cout, int kh, int kw, int pt,
                int pb, int pl, int pr, void* stream) {
    const int Ho = H + pt + pb - kh + 1, Wo = W + pl + pr - kw + 1;
    if (B < 1 || H < 1 || W < 1 || Cin < 1 || Cout < 1 || kh < 1 || kw < 1 || pt < 0 ||
        pb < 0 || pl < 0 || pr < 0 || Ho < 1 || Wo < 1)
        return (int)cudaErrorInvalidValue;
    Geometry g{B, H, W, Cin, Cout, kh, kw, pt, pl, Ho, Wo, TH + kh - 1, TW + kw - 1, 0, 0, 0};
    g.x_bytes = g.XH * g.XW * RS;
    g.stage = g.x_bytes + kh * kw * NB * RS;
    const size_t smem = (size_t)STAGES * g.stage;
    if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
    g.vec = Cin % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
            reinterpret_cast<uintptr_t>(w) % 16 == 0;
    const cudaError_t err = cudaFuncSetAttribute(
        conv_i8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int n_co = (Cout + NB - 1) / NB;
    const dim3 grid((Wo + TW - 1) / TW, (Ho + TH - 1) / TH, B * n_co);
    if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidValue;
    conv_i8_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(x), static_cast<const int8_t*>(w), scale, shift, out, g);
    return (int)cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16 input; inv = 1 / scale in float32.
int quantize_i8(const void* x, void* out, int dtype, float inv, int64_t n, void* stream) {
    if (n < 1 || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
    const int64_t blocks = (n + kThreads - 1) / kThreads;
    const dim3 grid((unsigned)(blocks < 132 * 16 ? blocks : 132 * 16));
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    int8_t* o = static_cast<int8_t*>(out);
    if (dtype == 0)
        quantize_kernel<float><<<grid, kThreads, 0, s>>>(static_cast<const float*>(x), o, inv, n);
    else
        quantize_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
            static_cast<const __nv_bfloat16*>(x), o, inv, n);
    return (int)cudaGetLastError();
}

}  // extern "C"
