// One folded-BatchNorm residual block on the space-to-depth (s2d) layout,
// in one launch, for Hopper (sm_90a).
//
// Replaces the TPU kernel pixel_embedded_affinity_tpu/ops/s2d_block_pallas.py
// ::_block_kernel (pl.pallas_call in fused_s2d_block, K8). Python wrapper:
// ops/s2d_block_cuda.py.
//
// What it computes. The reference ResidualBlock relu(conv2(relu(conv1 x)) +
// project x), inference BatchNorm folded into the weights, on s2d tensors
// (B, H, W, 4C), channel order (py, px, c). x comes as one or two parts (a
// decoder's skip concat, never materialised): part p is (B, H, W, Kp)
// contiguous with its own conv1+project taps k1p_p (2, 2, Kp, 4 G1),
// G1 = c1 + c2, output groups (qy, qx, [c1 | c2]); k2 is (2, 2, 4 c1, 4 c2);
// shifts h1p (4 G1) and h2 (4 c2) are float32. Per axis, with P[j] = x[j - 1]
// (zero outside the image), V[j] = K[0] P[j] + K[1] P[j + 1], and output
// parity q = (qy, qx) at block pixel g is V[g + q]:
//     V1 = sum_p conv2x2(x_p, k1p_p) + h1p                   (float32)
//     y1_q[g, u] = relu(V1[g + qy, u + qx, q G1 : q G1 + c1]) stored in T,
//                  and exactly 0 where g or u lies outside the image (the
//                  reference's SAME conv2 sees zeros there, not relu(shift))
//     V2 = conv2x2(y1, k2) + h2
//     out_q[g, u] = relu(V2[g + qy, u + qx, q c2 : (q + 1) c2]
//                        + V1[g + qy, u + qx, q G1 + c1 : (q + 1) G1])
// out: (B, H, W, 4 c2) contiguous, T = float32 or bfloat16, accumulation in
// float32. c1 and c2 are 16, 32 or 64 (the cvppp model's s2d stages).
//
// Bound. With TF32 off there is no tensor-core path, so the multiply-adds
// run on the CUDA cores at 67 TFLOP/s: (4 taps x (sum Kp) x 4 G1 + 4 taps x
// 4 c1 x 4 c2) per s2d pixel, 1.7-34 G multiply-adds a block at 544^2. The
// bytes (x read once, out written once) take 5-120x less time: operations
// bound every block.
//
// Design, the simple first version. A block of 256 threads owns a 6 x 14
// tile of output s2d pixels and all 4 c2 channels. Phase A computes y1 on
// the tile plus its one-pixel ring (8 x 16 = 128 positions, 4 a lane) for
// all 4 c1 channels: each warp owns one parity (warps 2q, 2q + 1) and
// c1/16 groups of 8 channels, so its lanes read the same weights (float4
// broadcasts) while each lane reads its own positions. x goes in chunks of
// 8 channels: the chunk's 10 x 18 tile and its 4 x 8 x 4 c1 weights are
// staged in shared memory. y1 stays in shared memory for the whole block,
// channel-major (<= 128 KB at c1 = 64 in float32; the dynamic-shared-memory
// limit is raised). Phase B computes conv2 from it (4 c1 channels, weights
// staged in the same chunks) and the projection from x again (a second read
// of the x tile, from L2), 3 positions a lane, and applies the epilogue.
// What it gives up: the ring recomputes conv1 on 128 positions for 84
// outputs (1.52x), x is read twice, no tensor cores, no asynchronous copies,
// and at c1 = 64 one block fills an SM's shared memory.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int TH = 6;                  // output s2d rows a block
constexpr int TW = 14;                 // output s2d columns a block
constexpr int RW = TW + 2;             // ring width
constexpr int R = (TH + 2) * RW;       // ring positions: 128, 4 a lane
constexpr int XC = TW + 4;             // staged x tile: (TH + 4) x (TW + 4)
constexpr int XPLANE = (TH + 4) * XC;  // 180: its channel stride
constexpr int CK = 8;                  // channels a chunk
constexpr int NB = TH * TW;            // output positions: 84, 3 a lane

struct Args {
    const void* x[2];
    const void* k1p[2];
    int K[2];
    int n_parts;
    const void* k2;
    const float* h1p;
    const float* h2;
    void* out;
    int H, W;
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
    return __float2bfloat16(v);
}

// Stage channels [k0, k0 + CK) of x's (TH + 4) x (TW + 4) tile starting at
// (g0 - 2, u0 - 2), zero outside the image and past K.
template <typename T>
__device__ __forceinline__ void stage_x(float* xs, const T* __restrict__ xb, int K, int k0,
                                        int g0, int u0, int H, int W) {
    for (int i = threadIdx.x; i < CK * XPLANE; i += kThreads) {
        const int k = i % CK;
        const int p = i / CK;
        const int gy = g0 - 2 + p / XC, gx = u0 - 2 + p % XC, ch = k0 + k;
        float v = 0.f;
        if (gy >= 0 && gy < H && gx >= 0 && gx < W && ch < K)
            v = to_float(xb[((int64_t)gy * W + gx) * K + ch]);
        xs[k * XPLANE + p] = v;
    }
}

// Stage ws[tap][k][n], n < 4 NQ, from wt[tap][k0 + k][q * ldq + off + c]
// (n = q NQ + c), zero past K.
template <typename T, int NQ>
__device__ __forceinline__ void stage_w(float* ws, const T* __restrict__ wt, int K, int k0,
                                        int ldq, int off) {
    constexpr int N = 4 * NQ;
    for (int i = threadIdx.x; i < 4 * CK * N; i += kThreads) {
        const int n = i % N;
        const int k = (i / N) % CK;
        const int tap = i / (N * CK);
        const int ch = k0 + k;
        float v = 0.f;
        if (ch < K) v = to_float(wt[((int64_t)tap * K + ch) * (4 * ldq) + (n / NQ) * ldq + off + n % NQ]);
        ws[i] = v;
    }
}

// acc[j][i][c] += sum over the chunk's CK channels and the 4 taps (by, bx)
// of src[k * stride + base[i] + by * row + bx] * ws[tap][k][ch0 + 8 j + c],
// src staged x (float) or the resident y1 (T).
template <int NP, int MP, typename S>
__device__ __forceinline__ void accumulate(float (&acc)[NP][MP][8], const S* src, int stride,
                                           const int (&base)[MP], int row, const float* ws,
                                           int n, int ch0) {
#pragma unroll 2
    for (int k = 0; k < CK; ++k) {
#pragma unroll
        for (int tap = 0; tap < 4; ++tap) {
            const int d = (tap >> 1) * row + (tap & 1);
            float v[MP];
#pragma unroll
            for (int i = 0; i < MP; ++i) v[i] = to_float(src[k * stride + base[i] + d]);
#pragma unroll
            for (int j = 0; j < NP; ++j) {
                const float4* wp = reinterpret_cast<const float4*>(
                    ws + (tap * CK + k) * n + ch0 + 8 * j);
                const float4 wa = wp[0], wb = wp[1];
                const float wv[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
                for (int i = 0; i < MP; ++i)
#pragma unroll
                    for (int c = 0; c < 8; ++c) acc[j][i][c] = fmaf(v[i], wv[c], acc[j][i][c]);
            }
        }
    }
}

template <typename T, int C1, int C2>
__global__ void __launch_bounds__(kThreads, 1) s2d_block_kernel(Args a) {
    constexpr int G1 = C1 + C2;
    constexpr int NA = 4 * C1, NBW = 4 * C2;
    constexpr int PA = C1 / 16, PB = C2 / 16;  // channel groups of 8 a warp
    constexpr int NW = NA > NBW ? NA : NBW;
    extern __shared__ __align__(16) unsigned char smem[];
    float* ws = reinterpret_cast<float*>(smem);   // [4][CK][<= NW]
    float* xs = ws + 4 * CK * NW;                 // [CK][XPLANE]
    T* ys = reinterpret_cast<T*>(xs + CK * XPLANE);  // [4 c1][R]

    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int q = warp >> 1, qy = q >> 1, qx = q & 1;  // the warp's parity
    const int u0 = blockIdx.x * TW, g0 = blockIdx.y * TH, b = blockIdx.z;
    const int H = a.H, W = a.W;

    // ---- phase A: y1 on the ring, channels [8 PA warp, 8 PA (warp + 1))
    {
        float acc[PA][4][8];
#pragma unroll
        for (int j = 0; j < PA; ++j)
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int c = 0; c < 8; ++c) acc[j][i][c] = 0.f;
        int base[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int pos = lane + 32 * i;
            base[i] = (pos / RW + qy) * XC + pos % RW + qx;
        }
        for (int p = 0; p < a.n_parts; ++p) {
            const int K = a.K[p];
            const T* xb = static_cast<const T*>(a.x[p]) + (int64_t)b * H * W * K;
            const T* k1p = static_cast<const T*>(a.k1p[p]);
            for (int k0 = 0; k0 < K; k0 += CK) {
                __syncthreads();
                stage_x<T>(xs, xb, K, k0, g0, u0, H, W);
                stage_w<T, C1>(ws, k1p, K, k0, G1, 0);
                __syncthreads();
                accumulate<PA, 4>(acc, xs, XPLANE, base, XC, ws, NA, 8 * PA * warp);
            }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int pos = lane + 32 * i;
            const int gy = g0 - 1 + pos / RW, gx = u0 - 1 + pos % RW;
            const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
            for (int j = 0; j < PA; ++j)
#pragma unroll
                for (int c = 0; c < 8; ++c) {
                    const int ch = 8 * (PA * warp + j) + c;  // in (q, c1)
                    const float v = fmaxf(acc[j][i][c] + a.h1p[q * G1 + ch % C1], 0.f);
                    ys[ch * R + pos] = from_float<T>(inside ? v : 0.f);
                }
        }
    }

    // ---- phase B: conv2 from y1, the projection from x, the epilogue
    float acc[PB][3][8];
#pragma unroll
    for (int j = 0; j < PB; ++j)
#pragma unroll
        for (int i = 0; i < 3; ++i)
#pragma unroll
            for (int c = 0; c < 8; ++c) acc[j][i][c] = 0.f;
    int ybase[3], xbase[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
        const int pos = min(lane + 32 * i, NB - 1);
        const int r = pos / TW, c = pos % TW;
        ybase[i] = (r + qy) * RW + c + qx;
        xbase[i] = (r + 1 + qy) * XC + c + 1 + qx;
    }
    for (int k0 = 0; k0 < NA; k0 += CK) {
        __syncthreads();
        stage_w<T, C2>(ws, static_cast<const T*>(a.k2), NA, k0, C2, 0);
        __syncthreads();
        accumulate<PB, 3>(acc, ys + k0 * R, R, ybase, RW, ws, NBW, 8 * PB * warp);
    }
    for (int p = 0; p < a.n_parts; ++p) {
        const int K = a.K[p];
        const T* xb = static_cast<const T*>(a.x[p]) + (int64_t)b * H * W * K;
        const T* k1p = static_cast<const T*>(a.k1p[p]);
        for (int k0 = 0; k0 < K; k0 += CK) {
            __syncthreads();
            stage_x<T>(xs, xb, K, k0, g0, u0, H, W);
            stage_w<T, C2>(ws, k1p, K, k0, G1, C1);
            __syncthreads();
            accumulate<PB, 3>(acc, xs, XPLANE, xbase, XC, ws, NBW, 8 * PB * warp);
        }
    }
    T* out = static_cast<T*>(a.out);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
        const int pos = lane + 32 * i;
        if (pos >= NB) continue;
        const int gy = g0 + pos / TW, gx = u0 + pos % TW;
        if (gy >= H || gx >= W) continue;
        T* o = out + (((int64_t)b * H + gy) * W + gx) * NBW;
#pragma unroll
        for (int j = 0; j < PB; ++j)
#pragma unroll
            for (int c = 0; c < 8; ++c) {
                const int ch = 8 * (PB * warp + j) + c;  // in (q, c2)
                const float v = acc[j][i][c] + a.h2[ch] + a.h1p[q * G1 + C1 + ch % C2];
                o[ch] = from_float<T>(fmaxf(v, 0.f));
            }
    }
}

template <typename T, int C1, int C2>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
    constexpr int NW = 4 * (C1 > C2 ? C1 : C2);
    const size_t smem = (size_t)4 * CK * NW * sizeof(float) + (size_t)CK * XPLANE * sizeof(float)
                        + (size_t)4 * C1 * R * sizeof(T);
    cudaError_t err = cudaFuncSetAttribute(s2d_block_kernel<T, C1, C2>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((a.W + TW - 1) / TW, (a.H + TH - 1) / TH, B);
    s2d_block_kernel<T, C1, C2><<<grid, kThreads, smem, stream>>>(a);
    return cudaGetLastError();
}

template <typename T, int C1>
cudaError_t dispatch_c2(const Args& a, int B, int c2, cudaStream_t s) {
    switch (c2) {
        case 16: return launch<T, C1, 16>(a, B, s);
        case 32: return launch<T, C1, 32>(a, B, s);
        case 64: return launch<T, C1, 64>(a, B, s);
        default: return cudaErrorInvalidValue;
    }
}

template <typename T>
cudaError_t dispatch(const Args& a, int B, int c1, int c2, cudaStream_t s) {
    switch (c1) {
        case 16: return dispatch_c2<T, 16>(a, B, c2, s);
        case 32: return dispatch_c2<T, 32>(a, B, c2, s);
        case 64: return dispatch_c2<T, 64>(a, B, c2, s);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, k1p, k2, out). n_parts 1 or 2 (x1,
// k1p1, K1 unused with one part). Returns the cudaError_t of the launch.
int s2d_block_fwd(const void* x0, const void* k1p0, int K0,
                  const void* x1, const void* k1p1, int K1, int n_parts,
                  const void* k2, const float* h1p, const float* h2, void* out,
                  int dtype, int B, int H, int W, int c1, int c2, void* stream) {
    if (B < 1 || H < 1 || W < 1 || B > 65535 || n_parts < 1 || n_parts > 2 || K0 < 1
        || (n_parts == 2 && K1 < 1))
        return (int)cudaErrorInvalidValue;
    Args a{{x0, x1}, {k1p0, k1p1}, {K0, K1}, n_parts, k2, h1p, h2, out, H, W};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0) return (int)dispatch<float>(a, B, c1, c2, s);
    if (dtype == 1) return (int)dispatch<__nv_bfloat16>(a, B, c1, c2, s);
    return (int)cudaErrorInvalidValue;
}

}  // extern "C"
