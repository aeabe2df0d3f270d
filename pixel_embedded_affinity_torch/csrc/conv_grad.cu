// The float32 backward of the 2D models' stride-1 convolutions (1x1 and
// 3x3 SAME), with results that are the same bits on every run, on the
// tensor cores of Hopper (sm_90a):
//
//   CWg  dW[co, ci, kh, kw] = sum_{n, y, x} dy[n, co, y, x] x[n, ci, y + kh - p, x + kw - p]
//   CXg  dx[n, ci, y, x]    = sum_{co, kh, kw} dy[n, co, y - kh + p, x - kw + p] W[co, ci, kh, kw]
//
// with p = 1 for 3x3 and 0 for 1x1, every tensor NCHW (W is [Cout][Cin][k][k])
// float32 and contiguous, values outside the image read as 0. Python
// wrapper: ops/conv_grad_cuda.py; the autograd Function that calls it:
// models/common.py. No TPU kernel corresponds: the JAX package leaves the
// conv backward to XLA, whose float32 backward is deterministic. cuDNN's
// default float32 weight gradient splits its long reduction over blocks and
// adds the parts with atomics, in an order that changes from run to run (as
// does its input gradient at some shapes), and its deterministic algorithms
// cost 7-9% of a 2D training step; these two kernels give the 2D float32
// step the reproducibility that its 3D and bf16 steps have.
//
// CWg is an implicit GEMM with M = Cout, N = Cin k^2 and K = B H W, the
// pixels: K is long (591,872 at B = 2, 544^2) and M, N short, so K is cut
// into a number of splits that depends on the shape only
// (conv_wgrad_splits). A block takes a split's 128-pixel chunks in turn (a
// chunk stays inside one image) and a tile of 16 or 32 output channels by 8
// input channels x 9 taps (3x3) or 32 input channels (1x1); its 8 warps each
// take 16 of a chunk's pixels and the whole tile, so a block ends with 8
// partial tiles, which it adds in warp order through shared memory and
// writes to the split's slice of a workspace. A second kernel adds the
// splits' slices in split order, in float64. No atomics: the order of every
// sum is fixed by the shape, so two runs give the same bits whatever order
// the blocks run in. dy's chunk is staged as [co][128 pixels]; x's as
// [ci][kh][136]: the flat pixel range of the chunk moved by (kh - 1) rows
// and 4 columns, so a tap is a fixed offset of a staged row, the top and
// bottom image edges are the zeros outside [0, H W), and the left and right
// edges (a flat shift by one column wraps to the next row) are masked where
// the B fragments load.
//
// CXg is an implicit GEMM with M = pixels (128 a block, one image), N = Cin
// (16, 32 or 64 a block) and K = Cout k^2, all of K inside one block, so
// it is deterministic by construction. dy's K chunk of 8 output channels
// (3x3; 32 for 1x1) is staged as [co][kh][136] the same way, moved by
// (1 - kh) rows, and W's as [co tap][ci] for the B fragments.
//
// Both stage by cp.async in a ring of 3 stages (16-byte copies where W is a
// multiple of 4 and the tensors 16-byte aligned, else 4-byte ones) and
// multiply as 3xTF32 through mma.sync m16n8k8 (mma_tc.cuh: each operand
// split into a TF32 high part and a TF32 remainder, three products into a
// fresh float32 sum that a rounding add folds into the accumulator). On an
// H100, at the convs of a full-width CVPPP float32 step, CWg is within
// 6.3e-6 of the largest gradient of a float64 run and CXg within 6.3e-7;
// cuDNN's float32 backward (TF32 off) is within 1.3e-5 and 2.0e-6.
//
// Bound. By operations: 3 x 2 Cout Cin k^2 B H W flops at 495 TFLOP/s
// (dense TF32) for each kernel; up4_emb's 96 -> 32 3x3 at B = 2, 544^2 is
// 32.7 GFLOP, 0.198 ms. By bytes (x, dy, dW read or written once at 3.35
// TB/s) 0.113 ms there, so the wide convs are bound by operations and the
// 3 -> 16 input conv and the 1x1 heads by bytes.
//
// What it gives up: mma.sync and cp.async, not wgmma and TMA (the shifted,
// edge-masked B operand is not one of wgmma's shared-memory layouts); CWg's
// tile keeps 8 input channels so that its 72 accumulators a thread fit, at
// one block an SM; 3 or 1 of CWg's 8 input channels are live for the 3- and
// 1-channel image convs; the partial tiles cost a workspace of splits x
// Cout x Cin k^2 floats and a second launch.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_tc.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int PX = 128;            // pixels a chunk (CWg) or a tile (CXg)
constexpr int ROW = PX + 8;        // a staged shifted row: pixels -4 .. PX + 4
constexpr int ROWS = ROW + 4;      // its stride in shared memory
constexpr int PS = PX + 4;         // a staged unshifted row's stride (4 mod 32)
constexpr int STAGES = 3;
constexpr int kTargetBlocks = 4 * 132;  // CWg's split count aims at 4 blocks an SM

struct Shape {
    int B, Cin, Cout, H, W;
    int64_t HW;
    int cpi;   // chunks (tiles of PX pixels) an image
    int vec;   // 16-byte copies
};

// Stage `n` floats of the flat row src[start .. start + n) (n a multiple of
// 4, start a multiple of 4 when s.vec) into dst, zeros outside [0, HW) or
// where !ok. Every thread of the block calls it with its own `lane0`
// (thread index within the cooperating group) and group size `nthr`.
__device__ __forceinline__ void stage_row(float* dst, const float* __restrict__ src,
                                          int64_t start, int n, bool ok, const Shape& s,
                                          int lane0, int nthr) {
    if (s.vec) {
        for (int v = lane0; v < n / 4; v += nthr) {
            const int64_t i = start + 4 * v;
            const bool in = ok && i >= 0 && i + 4 <= s.HW;
            tc::cp_async16(dst + 4 * v, in ? src + i : src, in);
        }
    } else {
        for (int e = lane0; e < n; e += nthr) {
            const int64_t i = start + e;
            const bool in = ok && i >= 0 && i < s.HW;
            tc::cp_async4(dst + e, in ? src + i : src, in);
        }
    }
}

// ---------------------------------------------------------------- CWg

template <int KS> struct Wg;
template <> struct Wg<3> { static constexpr int NT = 9, CI = 8; };   // 72 columns: 8 ci x 9 taps
template <> struct Wg<1> { static constexpr int NT = 4, CI = 32; };  // 32 columns: 32 ci

template <int KS, int MT> struct WgCfg {
    static constexpr int KK = KS * KS;
    static constexpr int NT = Wg<KS>::NT, CI = Wg<KS>::CI, M = 16 * MT, N = 8 * NT;
    static constexpr int A_ELEMS = M * PS;                               // dy [co][px]
    static constexpr int B_ELEMS = KS == 3 ? CI * 3 * ROWS : CI * PS;    // x [ci][kh][row]
    static constexpr int STAGE = A_ELEMS + B_ELEMS;
    static constexpr int RED = kWarps * M * N;                           // the warps' tiles
    static constexpr size_t SMEM =
        sizeof(float) * (STAGES * STAGE > RED ? STAGES * STAGE : RED);
};

template <int KS, int MT>
__global__ void __launch_bounds__(kThreads, 1)
conv_wgrad_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                  float* __restrict__ work, Shape s, int splits) {
    using C = WgCfg<KS, MT>;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    float* smem = reinterpret_cast<float*>(smem_raw);

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int split = blockIdx.x, ci0 = blockIdx.y * C::CI, co0 = blockIdx.z * C::M;
    const int64_t chunks = (int64_t)s.B * s.cpi;
    const int64_t c_begin = chunks * split / splits, c_end = chunks * (split + 1) / splits;

    // the lane's B column (8 j + g) of each n-tile: its staged row offset,
    // and for 3x3 whether its tap reads the column left (kw = 0) or right
    // (kw = 2) of the pixel, which wraps across a row edge
    int boff[C::NT];
    unsigned left = 0, right = 0;
#pragma unroll
    for (int j = 0; j < C::NT; ++j) {
        const int col = 8 * j + g;
        if constexpr (KS == 3) {
            const int ci = col / 9, tap = col % 9, kh = tap / 3, kw = tap % 3;
            boff[j] = (ci * 3 + kh) * ROWS + kw + 3;
            left |= (kw == 0) << j;
            right |= (kw == 2) << j;
        } else {
            boff[j] = col * PS;
        }
    }

    float acc[MT][C::NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < C::NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

    tc::pipeline<STAGES>(
        (int)(c_end - c_begin),
        [&](int c, int st) {
            float* A = smem + st * C::STAGE;
            float* Bs = A + C::A_ELEMS;
            const int64_t chunk = c_begin + c;
            const int n = (int)(chunk / s.cpi);
            const int64_t q0 = (chunk % s.cpi) * PX;
            // dy: M rows of PX pixels, each warp whole rows, its lanes along
            // the row; x likewise
            for (int r = warp; r < C::M; r += kWarps) {
                const int co = co0 + r;
                stage_row(A + r * PS, dy + ((int64_t)n * s.Cout + (co < s.Cout ? co : 0)) * s.HW,
                          q0, PX, co < s.Cout, s, lane, 32);
            }
            if constexpr (KS == 3) {
                for (int r = warp; r < C::CI * 3; r += kWarps) {
                    const int ci = ci0 + r / 3, kh = r % 3;
                    stage_row(Bs + r * ROWS,
                              x + ((int64_t)n * s.Cin + (ci < s.Cin ? ci : 0)) * s.HW,
                              q0 + (int64_t)(kh - 1) * s.W - 4, ROW, ci < s.Cin, s, lane, 32);
                }
            } else {
                for (int r = warp; r < C::CI; r += kWarps) {
                    const int ci = ci0 + r;
                    stage_row(Bs + r * PS, x + ((int64_t)n * s.Cin + (ci < s.Cin ? ci : 0)) * s.HW,
                              q0, PX, ci < s.Cin, s, lane, 32);
                }
            }
        },
        [&](int c, int st) {
            const float* A = smem + st * C::STAGE;
            const float* Bs = A + C::A_ELEMS;
            const int64_t q0 = ((c_begin + c) % s.cpi) * PX;
#pragma unroll
            for (int k8 = 0; k8 < 2; ++k8) {
                const int i0 = 16 * warp + 8 * k8 + t;  // pixels i0 (b0, a0 a1) and i0 + 4
                bool zero0[2] = {false, false}, zero1[2] = {false, false};
                if constexpr (KS == 3) {
                    const int x0 = (int)((q0 + i0) % s.W), x1 = (int)((q0 + i0 + 4) % s.W);
                    zero0[0] = x0 == 0;
                    zero0[1] = x0 == s.W - 1;
                    zero1[0] = x1 == 0;
                    zero1[1] = x1 == s.W - 1;
                }
                uint32_t bh[C::NT][2], bl[C::NT][2];
#pragma unroll
                for (int j = 0; j < C::NT; ++j) {
                    float v0 = Bs[boff[j] + i0], v1 = Bs[boff[j] + i0 + 4];
                    if constexpr (KS == 3) {
                        const bool l = (left >> j) & 1, r = (right >> j) & 1;
                        if ((l && zero0[0]) || (r && zero0[1])) v0 = 0.f;
                        if ((l && zero1[0]) || (r && zero1[1])) v1 = 0.f;
                    }
                    tc::split_tf32(v0, bh[j][0], bl[j][0]);
                    tc::split_tf32(v1, bh[j][1], bl[j][1]);
                }
#pragma unroll
                for (int i = 0; i < MT; ++i) {
                    const float* r0 = A + (16 * i + g) * PS + i0;
                    const float* r1 = r0 + 8 * PS;
                    uint32_t ah[4], al[4];
                    tc::split_tf32(r0[0], ah[0], al[0]);
                    tc::split_tf32(r1[0], ah[1], al[1]);
                    tc::split_tf32(r0[4], ah[2], al[2]);
                    tc::split_tf32(r1[4], ah[3], al[3]);
#pragma unroll
                    for (int j = 0; j < C::NT; ++j) {
                        float d[4] = {0.f, 0.f, 0.f, 0.f};
                        tc::mma_tf32(d, al, bh[j][0], bh[j][1]);
                        tc::mma_tf32(d, ah, bl[j][0], bl[j][1]);
                        tc::mma_tf32(d, ah, bh[j][0], bh[j][1]);
#pragma unroll
                        for (int e = 0; e < 4; ++e) acc[i][j][e] += d[e];
                    }
                }
            }
        });

    // the 8 warps' tiles, added in warp order, into the split's slice
    float* red = smem;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < C::NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int row = 16 * i + g + 8 * (e >> 1), col = 8 * j + 2 * t + (e & 1);
                red[(warp * C::M + row) * C::N + col] = acc[i][j][e];
            }
    __syncthreads();
    const int ncol = s.Cin * C::KK, col0 = ci0 * C::KK;
    float* out = work + (int64_t)split * s.Cout * ncol;
    for (int e = threadIdx.x; e < C::M * C::N; e += kThreads) {
        const int row = e / C::N, col = e % C::N;
        if (co0 + row >= s.Cout || col0 + col >= ncol) continue;
        float sum = red[row * C::N + col];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) sum += red[(w * C::M + row) * C::N + col];
        out[(int64_t)(co0 + row) * ncol + col0 + col] = sum;
    }
}

// dW[e] = sum over the splits, in split order, of work[split][e], added in
// float64 and rounded once (up to 528 partials a value)
__global__ void __launch_bounds__(kThreads)
wgrad_sum_kernel(const float* __restrict__ work, float* __restrict__ dw, int64_t n, int splits) {
    const int64_t e = (int64_t)blockIdx.x * kThreads + threadIdx.x;
    if (e >= n) return;
    double sum = work[e];
    for (int p = 1; p < splits; ++p) sum += work[(int64_t)p * n + e];
    dw[e] = (float)sum;
}

// ---------------------------------------------------------------- CXg

template <int KS> struct Xg;
template <> struct Xg<3> { static constexpr int CO = 8; };   // K chunk: 8 co x 9 taps = 72
template <> struct Xg<1> { static constexpr int CO = 32; };  // 32 co

template <int KS, int NT> struct XgCfg {
    static constexpr int KK = KS * KS, CO = Xg<KS>::CO, KC = CO * KK, NB = 16 * NT;
    static constexpr int WS = NB + 8;  // 8 or 24 mod 32: conflict-free B fragments
    static constexpr int A_ELEMS = KS == 3 ? CO * 3 * ROWS : CO * PS;  // dy [co][kh][row]
    static constexpr int B_ELEMS = KC * WS;                              // W [co tap][ci]
    static constexpr int STAGE = A_ELEMS + B_ELEMS;
    static constexpr size_t SMEM = sizeof(float) * STAGES * STAGE;
};

template <int KS, int NT>
__global__ void __launch_bounds__(kThreads, 2)
conv_dgrad_kernel(const float* __restrict__ dy, const float* __restrict__ w,
                  float* __restrict__ dx, Shape s) {
    using C = XgCfg<KS, NT>;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    float* smem = reinterpret_cast<float*>(smem_raw);

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int wm = warp & 3, wn = warp >> 2;  // pixels 32 wm .. +32, channels NT 8 wn .. +8 NT
    const int n = blockIdx.x / s.cpi;
    const int64_t q0 = (int64_t)(blockIdx.x % s.cpi) * PX;
    const int ci0 = blockIdx.y * C::NB;

    // the lane's pixels (rows g and g + 8 of each m-tile) and whether each
    // sits on the left (x = 0) or right (x = W - 1) image edge
    int prow[2][2];
    bool at_left[2][2], at_right[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            prow[i][h] = 32 * wm + 16 * i + g + 8 * h;
            const int xx = (int)((q0 + prow[i][h]) % s.W);
            at_left[i][h] = xx == 0;
            at_right[i][h] = xx == s.W - 1;
        }

    float acc[2][NT][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

    const int64_t wstride = (int64_t)s.Cin * C::KK;  // W's co stride
    tc::pipeline<STAGES>(
        (s.Cout + C::CO - 1) / C::CO,
        [&](int c, int st) {
            float* A = smem + st * C::STAGE;
            float* Bs = A + C::A_ELEMS;
            const int cc0 = c * C::CO;
            if constexpr (KS == 3) {
                for (int r = warp; r < C::CO * 3; r += kWarps) {
                    const int co = cc0 + r / 3, kh = r % 3;
                    stage_row(A + r * ROWS,
                              dy + ((int64_t)n * s.Cout + (co < s.Cout ? co : 0)) * s.HW,
                              q0 - (int64_t)(kh - 1) * s.W - 4, ROW, co < s.Cout, s, lane, 32);
                }
            } else {
                for (int r = warp; r < C::CO; r += kWarps) {
                    const int co = cc0 + r;
                    stage_row(A + r * PS, dy + ((int64_t)n * s.Cout + (co < s.Cout ? co : 0)) * s.HW,
                              q0, PX, co < s.Cout, s, lane, 32);
                }
            }
            // W[co][ci][tap] -> Bs[co tap][ci]; consecutive threads read
            // consecutive (ci, tap) of one co
            for (int e = threadIdx.x; e < C::CO * C::NB * C::KK; e += kThreads) {
                const int col = e / (C::NB * C::KK), rem = e % (C::NB * C::KK);
                const int ci = rem / C::KK, tap = rem % C::KK;
                const int co = cc0 + col, cin = ci0 + ci;
                const bool ok = co < s.Cout && cin < s.Cin;
                tc::cp_async4(Bs + (col * C::KK + tap) * C::WS + ci,
                              ok ? w + co * wstride + (int64_t)cin * C::KK + tap : w, ok);
            }
        },
        [&](int, int st) {
            const float* A = smem + st * C::STAGE;
            const float* Bs = A + C::A_ELEMS;
#pragma unroll 1
            for (int k8 = 0; k8 < C::KC / 8; ++k8) {
                // the lane's two k (t and t + 4 of this k-step): staged offset
                // and tap column
                int koff[2], kw[2];
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int k = 8 * k8 + t + 4 * h;
                    if constexpr (KS == 3) {
                        const int co = k / 9, tap = k % 9, kh = tap / 3;
                        kw[h] = tap % 3;
                        koff[h] = (co * 3 + kh) * ROWS - kw[h] + 5;
                    } else {
                        kw[h] = 1;
                        koff[h] = k * PS;
                    }
                }
                uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
                for (int j = 0; j < NT; ++j) {
                    const int col = NT * 8 * wn + 8 * j + g;
                    tc::split_tf32(Bs[(8 * k8 + t) * C::WS + col], bh[j][0], bl[j][0]);
                    tc::split_tf32(Bs[(8 * k8 + t + 4) * C::WS + col], bh[j][1], bl[j][1]);
                }
#pragma unroll
                for (int i = 0; i < 2; ++i) {
                    uint32_t ah[4], al[4];
#pragma unroll
                    for (int q = 0; q < 4; ++q) {  // a0 (g, t) a1 (g + 8, t) a2 (g, t + 4) a3 (g + 8, t + 4)
                        const int h = q & 1, kk = q >> 1;
                        // dy's column x - kw + 1 leaves the row at x = W - 1
                        // (kw = 0) and at x = 0 (kw = 2)
                        const bool off = (kw[kk] == 0 && at_right[i][h]) ||
                                         (kw[kk] == 2 && at_left[i][h]);
                        const float v = off ? 0.f : A[koff[kk] + prow[i][h]];
                        tc::split_tf32(v, ah[q], al[q]);
                    }
#pragma unroll
                    for (int j = 0; j < NT; ++j) {
                        float d[4] = {0.f, 0.f, 0.f, 0.f};
                        tc::mma_tf32(d, al, bh[j][0], bh[j][1]);
                        tc::mma_tf32(d, ah, bl[j][0], bl[j][1]);
                        tc::mma_tf32(d, ah, bh[j][0], bh[j][1]);
#pragma unroll
                        for (int e = 0; e < 4; ++e) acc[i][j][e] += d[e];
                    }
                }
            }
        });

#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int64_t q = q0 + prow[i][h];
            if (q >= s.HW) continue;
#pragma unroll
            for (int j = 0; j < NT; ++j)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int ci = ci0 + NT * 8 * wn + 8 * j + 2 * t + e;
                    if (ci < s.Cin) dx[((int64_t)n * s.Cin + ci) * s.HW + q] = acc[i][j][2 * h + e];
                }
        }
}

// ---------------------------------------------------------------- launch

template <typename K>
cudaError_t configure(K kernel, size_t smem, bool& done) {
    if (done) return cudaSuccess;
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess) done = true;
    return err;
}

bool make_shape(Shape& s, int B, int Cin, int Cout, int H, int W, int ks, const void* a,
                const void* b, const void* c) {
    if (B < 1 || Cin < 1 || Cout < 1 || H < 1 || W < 1 || (ks != 1 && ks != 3)) return false;
    s = Shape{B, Cin, Cout, H, W, (int64_t)H * W, 0, 0};
    s.cpi = (int)((s.HW + PX - 1) / PX);
    const bool aligned = reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                         reinterpret_cast<uintptr_t>(b) % 16 == 0 &&
                         reinterpret_cast<uintptr_t>(c) % 16 == 0;
    s.vec = aligned && (ks == 1 ? s.HW % 4 == 0 : W % 4 == 0);
    return (int64_t)B * s.cpi <= 0x7fffffff;
}

int wg_tiles(int Cin, int Cout, int ks, int& co_blocks, int& ci_blocks) {
    const int m = Cout <= 16 ? 16 : 32, ci = ks == 3 ? Wg<3>::CI : Wg<1>::CI;
    co_blocks = (Cout + m - 1) / m;
    ci_blocks = (Cin + ci - 1) / ci;
    return m / 16;
}

template <int KS, int MT>
cudaError_t launch_wgrad(const float* x, const float* dy, float* work, const Shape& s,
                         int splits, int co_blocks, int ci_blocks, cudaStream_t stream) {
    using C = WgCfg<KS, MT>;
    static bool done = false;
    const cudaError_t err = configure(conv_wgrad_kernel<KS, MT>, C::SMEM, done);
    if (err != cudaSuccess) return err;
    conv_wgrad_kernel<KS, MT><<<dim3(splits, ci_blocks, co_blocks), kThreads, C::SMEM, stream>>>(
        x, dy, work, s, splits);
    return cudaGetLastError();
}

template <int KS, int NT>
cudaError_t launch_dgrad(const float* dy, const float* w, float* dx, const Shape& s,
                         cudaStream_t stream) {
    using C = XgCfg<KS, NT>;
    static bool done = false;
    const cudaError_t err = configure(conv_dgrad_kernel<KS, NT>, C::SMEM, done);
    if (err != cudaSuccess) return err;
    const dim3 grid((unsigned)((int64_t)s.B * s.cpi), (s.Cin + C::NB - 1) / C::NB);
    conv_dgrad_kernel<KS, NT><<<grid, kThreads, C::SMEM, stream>>>(dy, w, dx, s);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// CWg's number of K splits for a shape: enough blocks for 4 an SM of an
// H100, at most one chunk of 128 pixels a split. It depends on the shape
// only, so a shape's sums are always taken in one order.
int conv_wgrad_splits(int B, int Cin, int Cout, int H, int W, int ks) {
    int co_blocks, ci_blocks;
    wg_tiles(Cin, Cout, ks, co_blocks, ci_blocks);
    const int64_t chunks = (int64_t)B * (((int64_t)H * W + PX - 1) / PX);
    const int64_t tiles = (int64_t)co_blocks * ci_blocks;
    int64_t splits = (kTargetBlocks + tiles - 1) / tiles;
    if (splits > chunks) splits = chunks;
    return (int)(splits < 1 ? 1 : splits);
}

// dw (Cout, Cin, ks, ks) from x (B, Cin, H, W) and dy (B, Cout, H, W), all
// float32 contiguous; work holds splits x Cout x Cin x ks^2 floats. Two
// launches on `stream`; returns the cudaError_t of the launches (0 on
// success).
int conv_wgrad(const float* x, const float* dy, float* dw, float* work, int B, int Cin, int Cout,
               int H, int W, int ks, int splits, void* stream) {
    Shape s;
    if (!make_shape(s, B, Cin, Cout, H, W, ks, x, dy, work) || splits < 1 || splits > 65535 ||
        splits > (int64_t)B * s.cpi)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    int co_blocks, ci_blocks;
    const int mt = wg_tiles(Cin, Cout, ks, co_blocks, ci_blocks);
    if (co_blocks > 65535 || ci_blocks > 65535) return (int)cudaErrorInvalidValue;
    cudaError_t err;
    if (ks == 3)
        err = mt == 1 ? launch_wgrad<3, 1>(x, dy, work, s, splits, co_blocks, ci_blocks, st)
                      : launch_wgrad<3, 2>(x, dy, work, s, splits, co_blocks, ci_blocks, st);
    else
        err = mt == 1 ? launch_wgrad<1, 1>(x, dy, work, s, splits, co_blocks, ci_blocks, st)
                      : launch_wgrad<1, 2>(x, dy, work, s, splits, co_blocks, ci_blocks, st);
    if (err != cudaSuccess) return (int)err;
    const int64_t n = (int64_t)Cout * Cin * ks * ks;
    wgrad_sum_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0, st>>>(
        work, dw, n, splits);
    return (int)cudaGetLastError();
}

// dx (B, Cin, H, W) from dy (B, Cout, H, W) and w (Cout, Cin, ks, ks), all
// float32 contiguous. One launch on `stream`; returns its cudaError_t.
int conv_dgrad(const float* dy, const float* w, float* dx, int B, int Cin, int Cout, int H, int W,
               int ks, void* stream) {
    Shape s;
    if (!make_shape(s, B, Cin, Cout, H, W, ks, dy, w, dx) ||
        (Cin + 15) / 16 > 65535)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int nt = Cin <= 16 ? 1 : Cin <= 32 ? 2 : 4;
    cudaError_t err;
    if (ks == 3)
        err = nt == 1 ? launch_dgrad<3, 1>(dy, w, dx, s, st)
            : nt == 2 ? launch_dgrad<3, 2>(dy, w, dx, s, st) : launch_dgrad<3, 4>(dy, w, dx, s, st);
    else
        err = nt == 1 ? launch_dgrad<1, 1>(dy, w, dx, s, st)
            : nt == 2 ? launch_dgrad<1, 2>(dy, w, dx, s, st) : launch_dgrad<1, 4>(dy, w, dx, s, st);
    return (int)err;
}

}  // extern "C"
