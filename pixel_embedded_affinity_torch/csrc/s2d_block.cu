// One folded-BatchNorm residual block on the space-to-depth (s2d) layout,
// in one launch, on the tensor cores of Hopper (sm_90a).
//
// Replaces the TPU kernel pixel_embedded_affinity_tpu/ops/s2d_block_pallas.py:210
// (pl.pallas_call of _block_kernel in fused_s2d_block, K8). Python wrapper:
// ops/s2d_block_cuda.py.
//
// What it computes. The reference ResidualBlock relu(conv2(relu(conv1 x) ...)
// + project x), inference BatchNorm folded into the weights, on s2d
// tensors (B, H, W, 4C), channel order (py, px, c). The s2d tensor is the
// direct image (B, 2H, 2W, C) under an address map,
//     X[b, 2g + py, 2u + px, c] = x[b, g, u, (2 py + px) C + c],
// so the kernel reads and writes the s2d tensors through that map and
// computes the block at direct resolution with 3x3 taps (the TPU kernel's
// 2x2 parity form does 16/9 of these multiply-adds, 7 of its 16 parity
// taps being structural zeros). x comes as one or two parts (a decoder's
// skip concat, never materialised): part p is (B, H, W, 4 Kp) with its
// direct taps w1p_p (3, 3, Kp, 2c), output channels [conv1 | project]; w2
// is (3, 3, c, c); shifts h1, hp, h2 (c) are float32; c1 = cp = c2 = c in
// {16, 32, 64} (the cvppp model's s2d stages). With X_p the parts' direct
// images and SAME 3x3 convs:
//     y1  = relu(sum_p conv(X_p, w1p_p[..., :c]) + h1), rounded to T, and
//           exactly 0 outside the image (the reference's SAME conv2 sees
//           zeros there, not relu(h1))
//     out = relu(conv(y1, w2) + h2 + sum_p conv(X_p, w1p_p[..., c:]) + hp)
// stored through the map as (B, H, W, 4c); T = float32 or bfloat16,
// accumulation in float32.
//
// Precision and bound. float32 runs as 3xTF32 (mma.sync m16n8k8, three
// passes lo*hi + hi*lo + hi*hi into a fresh sum each k-step, see
// conv3x3.cu and mma_tc.cuh), bfloat16 as one pass of m16n8k16. The direct form's multiply-adds, 9 (sum Kp)(2c) + 9 c^2 a
// direct pixel, are 1.0006e11 flops for the five blocks of a 544^2 image:
// 0.606 ms at 3 passes of 495 TFLOP/s (float32), 0.101 ms at 989 (bf16);
// the bytes (x read once, out written once) take 0.10 and 0.05 ms, so
// operations bound every block.
//
// Design. A block of 256 threads owns a 16 x 16 tile of direct output
// pixels (8 x 8 s2d pixels) and all c channels.
//   Phase 1, conv1 as an implicit GEMM over the tile's 18 x 18 ring (324
//   positions, 21 m16 tiles, 1.27x the outputs; N = c, K = 9 taps x sum Kp):
//   the parts' 20 x 20 x-tiles and the conv1 weights come in chunks of 8
//   (float32) or 16 (bf16) channels by cp.async (16-byte copies through the
//   address map, zero-filled outside the image; plain loads where Kp is not
//   a multiple of 16 bytes, the 3-channel input block) into a ring of
//   stages; warp w takes ring tiles w, w + 8, w + 16. The epilogue writes
//   y1 = relu(acc + h1) in T, 0 outside the image, into shared memory.
//   Phase 2, one GEMM over the 16 x 16 tile (warp w: rows 2w, 2w + 1; N = c)
//   whose K runs over conv2's 9 x c taps with A read from the resident y1,
//   then over the projection's 9 x sum Kp taps with A from the x-tiles
//   again (staged anew from L2 or device memory). The projection
//   thus runs over the tile alone and shares conv2's accumulators; the
//   epilogue adds h2 + hp, applies the ReLU and stores through the map.
// Shared memory: y1 (324 x (c + 4) floats or 324 x (c + 8) bf16) and the
// stages (x-tile 400 x 12 floats or 400 x 24 bf16, weights 9 x chunk x
// (c + 8)); the 227 KB budget at c = 64 decides 3 stages and one block an
// SM there (float32 207,936 bytes, bf16 166,464), 2 stages and two blocks
// an SM at c = 32 (108,096; 87,360) and c = 16 (78,144; 67,776).
// Fragment strides as in mma_tc.cuh.
//
// What it gives up: mma.sync, not wgmma, and cp.async, not TMA (the halo
// tiles and the s2d address map are not wgmma/TMA canonical layouts without
// a repack); conv1 is recomputed on the ring (1.27x the tile's positions),
// x is read twice (the projection's pass), 8 warps take the 21 ring tiles
// in 24 slots (3 compute a clamped copy), and at c = 64 one block fills an
// SM, so 136^2 s2d blocks (289 tiles) run in 3 waves on 132 SMs.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_tc.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int TY = 16, TX = 16;           // direct output tile
constexpr int RY = TY + 2, RX = TX + 2;   // y1 ring
constexpr int NR = RY * RX;               // 324 ring positions
constexpr int MT1 = 3;                    // ring m16 tiles a warp: 21 over 8 warps
static_assert(8 * MT1 * 16 >= NR, "the warps' ring tiles cover the ring");
constexpr int XY = TY + 4, XX = TX + 4;   // staged x-tile, origin (Y0 - 2, X0 - 2)

template <typename T, int C> struct Cfg {
    static constexpr int CK = tc::Mma<T>::K;
    static constexpr int VE = 16 / sizeof(T);
    static constexpr int XS = CK + (sizeof(T) == 4 ? 4 : 8);  // x-tile pixel stride
    static constexpr int YS = C + (sizeof(T) == 4 ? 4 : 8);   // y1 position stride
    static constexpr int WS = C + 8;                          // weight row stride
    static constexpr int STAGES = C == 64 ? 3 : 2;
    static constexpr int X_ELEMS = XY * XX * XS;
    static constexpr int W_ELEMS = 9 * CK * WS;
    static constexpr int STAGE = X_ELEMS + W_ELEMS;
    static constexpr int Y_ELEMS = NR * YS;
    static constexpr size_t SMEM = (size_t)(Y_ELEMS + STAGES * STAGE) * sizeof(T);
    static constexpr int MIN_BLOCKS = C == 64 ? 1 : 2;
};

struct Args {
    const void* x[2];
    const void* w1p[2];
    int K[2];
    int n_parts;
    const void* w2;
    const float* h1;
    const float* hp;
    const float* h2;
    void* out;
    int H, W;   // s2d size; the direct image is 2H x 2W
    int xvec;   // 16-byte copies of x
};

// Chunk [k0, k0 + CK) of part x (Kd direct channels) at the block's x-tile,
// read through the s2d address map, into xs.
template <typename T, int C>
__device__ __forceinline__ void stage_x(T* xs, const T* __restrict__ xb, int Kd, int k0,
                                        int Y0, int X0, const Args& a) {
    using G = Cfg<T, C>;
    constexpr int NV = G::CK / G::VE;
    const int H2 = 2 * a.H, W2 = 2 * a.W, K4 = 4 * Kd;
    if (a.xvec) {
        for (int i = threadIdx.x; i < XY * XX * NV; i += kThreads) {
            const int p = i / NV, v = i % NV;
            const int Y = Y0 - 2 + p / XX, X = X0 - 2 + p % XX, ch = k0 + v * G::VE;
            const bool ok = Y >= 0 && Y < H2 && X >= 0 && X < W2 && ch < Kd;
            const T* src = ok ? xb + ((int64_t)(Y >> 1) * a.W + (X >> 1)) * K4
                                    + (2 * (Y & 1) + (X & 1)) * Kd + ch
                              : xb;
            tc::cp_async16(xs + p * G::XS + v * G::VE, src, ok);
        }
    } else {
        for (int i = threadIdx.x; i < XY * XX * G::CK; i += kThreads) {
            const int p = i / G::CK, k = i % G::CK;
            const int Y = Y0 - 2 + p / XX, X = X0 - 2 + p % XX, ch = k0 + k;
            T v = tc::from_float<T>(0.f);
            if (Y >= 0 && Y < H2 && X >= 0 && X < W2 && ch < Kd)
                v = xb[((int64_t)(Y >> 1) * a.W + (X >> 1)) * K4 + (2 * (Y & 1) + (X & 1)) * Kd + ch];
            xs[p * G::XS + k] = v;
        }
    }
}

// Rows [k0, k0 + CK) of the 9 taps of w (3, 3, Kd, ld), columns
// [col0, col0 + C), into ws[tap * CK + k][n]; zero past Kd.
template <typename T, int C>
__device__ __forceinline__ void stage_w(T* ws, const T* __restrict__ w, int Kd, int ld, int col0,
                                        int k0) {
    using G = Cfg<T, C>;
    constexpr int NV = C / G::VE;
    for (int i = threadIdx.x; i < 9 * G::CK * NV; i += kThreads) {
        const int row = i / NV, v = i % NV;
        const int tap = row / G::CK, ch = k0 + row % G::CK;
        const bool ok = ch < Kd;
        const T* src = ok ? w + ((int64_t)tap * Kd + ch) * ld + col0 + v * G::VE : w;
        tc::cp_async16(ws + row * G::WS + v * G::VE, src, ok);
    }
}

template <typename T, int C>
__global__ void __launch_bounds__(kThreads, Cfg<T, C>::MIN_BLOCKS) s2d_block_kernel(Args a) {
    using G = Cfg<T, C>;
    constexpr int NT = C / 8;  // n8 tiles
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* ys = reinterpret_cast<T*>(smem_raw);  // y1 [NR][YS]
    T* stages = ys + G::Y_ELEMS;

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int gq = lane >> 2, t = lane & 3;
    const int X0 = blockIdx.x * TX, Y0 = blockIdx.y * TY, b = blockIdx.z;
    const int H2 = 2 * a.H, W2 = 2 * a.W;
    const T* xb[2];
    int nck[2];
#pragma unroll
    for (int p = 0; p < 2; ++p) {
        const int K = p < a.n_parts ? a.K[p] : 0;
        xb[p] = static_cast<const T*>(a.x[p < a.n_parts ? p : 0]) + (int64_t)b * a.H * a.W * 4 * K;
        nck[p] = (K + G::CK - 1) / G::CK;
    }
    const int n_x = nck[0] + nck[1];  // x chunks over both parts
    // chunk j of the x chunks: its part and first channel
    auto part_of = [&](int j) { return j < nck[0] ? 0 : 1; };
    auto k0_of = [&](int j) { return (j < nck[0] ? j : j - nck[0]) * G::CK; };

    // ---- phase 1: conv1 over the ring -> y1
    {
        int arow[MT1][2];
#pragma unroll
        for (int i = 0; i < MT1; ++i)
            tc::lane_rows<T>(arow[i], [&](int r) {
                const int m = min((warp + 8 * i) * 16 + r, NR - 1);
                return (m / RX) * XX + m % RX;
            });
        float acc[MT1][NT][4];
#pragma unroll
        for (int i = 0; i < MT1; ++i)
#pragma unroll
            for (int j = 0; j < NT; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
        tc::pipeline<G::STAGES>(
            n_x,
            [&](int c, int s) {
                T* xs = stages + s * G::STAGE;
                const int p = part_of(c), k0 = k0_of(c);
                stage_x<T, C>(xs, xb[p], a.K[p], k0, Y0, X0, a);
                stage_w<T, C>(xs + G::X_ELEMS, static_cast<const T*>(a.w1p[p]), a.K[p], 2 * C,
                              0, k0);
            },
            [&](int, int s) {
                const T* xs = stages + s * G::STAGE;
                const T* ws = xs + G::X_ELEMS;
#pragma unroll 1
                for (int dy = 0; dy < 3; ++dy)
#pragma unroll
                    for (int dx = 0; dx < 3; ++dx)
                        tc::mma_step<MT1, NT>(acc, xs, G::XS, arow, dy * XX + dx,
                                              ws + (3 * dy + dx) * G::CK * G::WS, G::WS, 0);
            });
#pragma unroll
        for (int i = 0; i < MT1; ++i)
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int m = (warp + 8 * i) * 16 + gq + 8 * half;
                if (m >= NR) continue;
                const int Y = Y0 - 1 + m / RX, X = X0 - 1 + m % RX;
                const bool inside = Y >= 0 && Y < H2 && X >= 0 && X < W2;
#pragma unroll
                for (int j = 0; j < NT; ++j)
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        const int n = 8 * j + 2 * t + e;
                        const float v = fmaxf(acc[i][j][2 * half + e] + a.h1[n], 0.f);
                        ys[m * G::YS + n] = tc::from_float<T>(inside ? v : 0.f);
                    }
            }
    }
    // (the pipeline below syncs before its first compute, so y1 is complete)

    // ---- phase 2: conv2 from y1, then the projection from x, one GEMM
    int yrow[2][2], xrow[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        tc::lane_rows<T>(yrow[i], [&](int r) { return (2 * warp + i) * RX + r; });
        tc::lane_rows<T>(xrow[i], [&](int r) { return (2 * warp + i + 1) * XX + r + 1; });
    }
    float acc[2][NT][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    constexpr int n_y = C / G::CK;  // y1 chunks
    const T* w2 = static_cast<const T*>(a.w2);
    tc::pipeline<G::STAGES>(
        n_y + n_x,
        [&](int c, int s) {
            T* xs = stages + s * G::STAGE;
            if (c < n_y) {
                stage_w<T, C>(xs + G::X_ELEMS, w2, C, C, 0, c * G::CK);
            } else {
                const int p = part_of(c - n_y), k0 = k0_of(c - n_y);
                stage_x<T, C>(xs, xb[p], a.K[p], k0, Y0, X0, a);
                stage_w<T, C>(xs + G::X_ELEMS, static_cast<const T*>(a.w1p[p]), a.K[p], 2 * C,
                              C, k0);
            }
        },
        [&](int c, int s) {
            const T* xs = stages + s * G::STAGE;
            const T* ws = xs + G::X_ELEMS;
            if (c < n_y) {
#pragma unroll 1
                for (int dy = 0; dy < 3; ++dy)
#pragma unroll
                    for (int dx = 0; dx < 3; ++dx)
                        tc::mma_step<2, NT>(acc, ys + c * G::CK, G::YS, yrow, dy * RX + dx,
                                            ws + (3 * dy + dx) * G::CK * G::WS, G::WS, 0);
            } else {
#pragma unroll 1
                for (int dy = 0; dy < 3; ++dy)
#pragma unroll
                    for (int dx = 0; dx < 3; ++dx)
                        tc::mma_step<2, NT>(acc, xs, G::XS, xrow, dy * XX + dx,
                                            ws + (3 * dy + dx) * G::CK * G::WS, G::WS, 0);
            }
        });

    T* out = static_cast<T*>(a.out);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int Y = Y0 + 2 * warp + i;
        if (Y >= H2) continue;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int X = X0 + gq + 8 * half;
            if (X >= W2) continue;
            T* o = out + (((int64_t)b * a.H + (Y >> 1)) * a.W + (X >> 1)) * 4 * C
                   + (2 * (Y & 1) + (X & 1)) * C;
#pragma unroll
            for (int j = 0; j < NT; ++j)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int n = 8 * j + 2 * t + e;
                    const float v = acc[i][j][2 * half + e] + a.h2[n] + a.hp[n];
                    o[n] = tc::from_float<T>(fmaxf(v, 0.f));
                }
        }
    }
}

template <typename T, int C>
cudaError_t launch(Args a, int B, cudaStream_t stream) {
    using G = Cfg<T, C>;
    static bool configured = false;
    if (!configured) {
        const cudaError_t err = cudaFuncSetAttribute(
            s2d_block_kernel<T, C>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)G::SMEM);
        if (err != cudaSuccess) return err;
        configured = true;
    }
    a.xvec = 1;
    for (int p = 0; p < a.n_parts; ++p)
        if (a.K[p] % G::VE != 0 || reinterpret_cast<uintptr_t>(a.x[p]) % 16 != 0) a.xvec = 0;
    const dim3 grid((2 * a.W + TX - 1) / TX, (2 * a.H + TY - 1) / TY, B);
    if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidValue;
    s2d_block_kernel<T, C><<<grid, kThreads, G::SMEM, stream>>>(a);
    return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Args& a, int B, int c, cudaStream_t s) {
    switch (c) {
        case 16: return launch<T, 16>(a, B, s);
        case 32: return launch<T, 32>(a, B, s);
        case 64: return launch<T, 64>(a, B, s);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, w1p, w2, out). Part p: x_p (B, H, W,
// 4 Kp), w1p_p (3, 3, Kp, 2c); n_parts 1 or 2 (x1, w1p1, K1 unused with
// one part). w2 (3, 3, c, c); h1, hp, h2 (c) float32; out (B, H, W, 4c).
// The weights' pointers must be 16-byte aligned. Returns the cudaError_t
// of the launch.
int s2d_block_fwd(const void* x0, const void* w1p0, int K0,
                  const void* x1, const void* w1p1, int K1, int n_parts,
                  const void* w2, const float* h1, const float* hp, const float* h2,
                  void* out, int dtype, int B, int H, int W, int c, void* stream) {
    if (B < 1 || H < 1 || W < 1 || n_parts < 1 || n_parts > 2 || K0 < 1
        || (n_parts == 2 && K1 < 1))
        return (int)cudaErrorInvalidValue;
    const void* ws[3] = {w1p0, n_parts == 2 ? w1p1 : w1p0, w2};
    for (const void* p : ws)
        if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return (int)cudaErrorInvalidValue;
    Args a{{x0, x1}, {w1p0, w1p1}, {K0, n_parts == 2 ? K1 : 0}, n_parts, w2, h1, hp, h2, out,
           H, W, 0};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0) return (int)dispatch<float>(a, B, c, s);
    if (dtype == 1) return (int)dispatch<__nv_bfloat16>(a, B, c, s);
    return (int)cudaErrorInvalidValue;
}

}  // extern "C"
