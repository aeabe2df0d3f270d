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
// cost 7-9% of a 2D training step; these kernels give the 2D float32 step
// the reproducibility that its 3D and bf16 steps have.
//
// Bound. By operations: 3 x 2 Cout Cin k^2 B H W flops at 495 TFLOP/s
// (dense TF32) for each gradient; up4_emb's 96 -> 32 3x3 at B = 2, 544^2 is
// 32.7 GFLOP, 0.198 ms. By bytes (x, dy, dW read or written once at 3.35
// TB/s) 0.113 ms there, so the wide convs are bound by operations and the
// 3 -> 16 input conv and the 1x1 heads by bytes.
//
// Design (CXg at every shape with H W % 4 == 0, CWg where also its tile
// has work enough, wgrad_wgmma_shape; every other conv takes the mma.sync
// kernels below):
// implicit GEMMs on wgmma.mma_async m64nNk8 .tf32 (wgmma_tma.cuh) fed by
// TMA, a block of two consumer warpgroups and one producer warp (288
// threads, one block an SM, persistent over its work items, so the
// producer runs ahead into the next item). The A operand (64 rows a
// consumer warpgroup) comes from registers, B from shared memory. The
// producer's one thread loads each k-block into a ring of 4-8 stages
// through 3-D maps over (H W, C, B): the pixels flat, so a 3x3 tap is a
// flat shift of the pixel range, (kh - 1) W + kw - 1, and TMA's zero fill
// outside [0, H W) is the top and bottom padding. Full and empty mbarriers
// pace the ring. The tap's shifted range is the register operand: its
// boxes are loaded unswizzled from the shifted start rounded down to 16
// bytes (TMA takes no other innermost coordinate, tools/wgmma_tf32_probe.py),
// 4 pixels wider, and each thread reads its fragment at the shift, zero
// where the tap's column leaves the row (the left and right edges, where a
// flat shift wraps to the next row). Rows of 36 and 132 floats (4 mod 32
// words) keep the fragment loads off each other's banks.
//
// 3xTF32: the tensor cores read a float32 container as tf32 with its low 13
// bits dropped (tools/wgmma_tf32_probe.py on the H100), so an operand is
// its own high part and its remainder x - (x & ~0x1FFF) the low part, exact
// in float32. Three products a k8 step (lo.hi, hi.lo, hi.hi). The register
// operand's remainders are taken as it is loaded; the shared one's come
// from global memory, written by a first launch into the workspace (CWg:
// dy's; CXg: the weights', beside their [tap][ci][co] layout), and loaded
// by TMA beside it. The tensor cores' float32 sum of a long chain of
// products drifts (tools/conv_grad_ab.py: a CWg split's whole K summed in
// them read 5.5e-4 of the float64 gradient at the 3-channel image conv,
// 3.4e-5 with a fresh accumulator a 32-pixel k-block, 6.5e-6 with one a k8
// step), so a fresh accumulator takes each k8 step in CWg and each
// k-block (K is Cout k^2 at most) in CXg, and a float32 add folds it into
// the running sum.
//
// CWg: M = (tap, ci) rows, N = Cout (32 to 128 a tile), K = pixels, 32
// a k-block. A block's 128 rows are boxes of one tap x 8, 16, 32 or 64
// input channels (the width that pads Cin least); dy and its remainders
// are B, 128-byte-swizzled boxes of 32 pixels x N channels. K is long
// (591,872 at B = 2, 544^2), so it is cut into splits that depend on the
// shape only (conv_wgrad_splits: the count that fills whole waves of an
// H100's 132 SMs best); a work item is (split, M tile, N tile), and its
// partial tile goes to the split's slice of the workspace, [tap ci][co].
// A last kernel adds the slices in split order in float64 and writes dW,
// transposed through shared memory. No atomics: the order of every sum is
// fixed by the shape, so two runs give the same bits whatever order the
// blocks run in and whatever grid walks the items.
//
// CXg: M = 128 pixels of one image, N = Cin (8-128 a tile), K = (co, tap),
// 32 output channels of one tap a k-block, all of K inside one item, so it
// is deterministic by construction. dy is A, a box of 32 channels x 132
// pixels a k-block. The first launch lays W out as [tap][ci][co] (co padded
// to 32, in the order 0 2 4 6 1 3 5 7 within each 8, so a thread's two A
// columns, channels 2t and 2t + 1, sit on other banks) with its tf32
// remainders beside it; TMA loads both as 128-byte-swizzled B tiles.
//
// What it gives up: one block an SM and each fresh accumulator waited for
// before its fold, so a warpgroup's loads and folds leave the tensor cores
// to the other warpgroup only; 168 registers a thread (ptxas gives a
// 288-thread wgmma block three warpgroups' share), where CWg's N = 128
// spills 16 bytes; 128-row tiles, so CWg reads dy and its remainders once
// per M tile and CXg the weights once per 128 pixels, from L2; the taps read
// x or dy once a tap (9 times its bytes); CWg's workspace of dy's size plus
// splits x Cout x Cin k^2 floats and two more launches; CWg's register
// operand loaded and split at the same cost whatever N, so narrow Cout
// wastes the tensor cores and those convs stay on mma.sync.
//
// The mma.sync kernels (CWg where wgrad_wgmma_shape is false, CXg where
// H W % 4 != 0): implicit GEMMs on mma.sync m16n8k8 in 3xTF32
// (mma_tc.cuh: each operand split in registers at every fragment load, a
// fresh accumulator a k8 step) fed by cp.async rings of 3 stages; CWg
// split-K in 128-pixel chunks, 8 warps a block each adding a partial tile
// in warp order, x staged as [ci][kh][136] shifted rows with the left and
// right edges masked at the fragment loads; CXg 128 pixels x 16-64 input
// channels a block, K in 8-channel (32 for 1x1) chunks. Their tiles of 16
// or 32 output channels suit the narrow convs (the image convs, the 16-
// and 32-channel convs, the 1x1 heads), where they ran 16% to 4x faster
// than the wgmma CWg.

#include <algorithm>
#include <climits>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_tc.cuh"
#include "wgmma_tma.cuh"

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

// ---------------------------------------------------------------- CWg on mma.sync

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

// ---------------------------------------------------------------- CXg on mma.sync

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

// ---------------------------------------------------------------- wgmma: common

constexpr int kWgThreads = 288;       // two consumer warpgroups, one producer warp
constexpr int KB = 32;                // a k-block: 32 floats, one 128-byte row
constexpr int MB = 128;               // A rows a block: 64 a consumer warpgroup
constexpr int XROW = KB + 4;          // CWg's staged x row: 36 pixels (4 mod 32 words)
constexpr int DROW = MB + 4;          // CXg's staged dy row: 132 pixels (4 mod 32 words)
constexpr int XG_A = 17408;           // CXg's dy stage, 32 x 132 floats, to 1024 bytes
constexpr int kMaxStages = 8;
constexpr size_t kSmemBlock = 232448;
constexpr int kSms = 132;             // an H100's SMs: CWg's split rule (shape only)

// The tensor cores' tf32 of a float32 container (tools/wgmma_tf32_probe.py
// on the H100: its low 13 bits are dropped), so x = hi(x) + lo(x) exactly
// with hi(x) the container itself.
__device__ __forceinline__ float tf32_lo(float x) {
    return x - __uint_as_float(__float_as_uint(x) & 0xFFFFE000u);
}

// A tap's staged pixels: TMA takes a box only from an innermost coordinate
// that is a multiple of 16 bytes (the H100 stops with an illegal
// instruction at others, negative or not; tools/wgmma_tf32_probe.py), so
// a pixel range that starts at `first` (a tap's shift moves it by any
// count, -W - 1 .. W + 1) is loaded from box_start(first), 3 floats below
// at most, and read `first - box_start(first)` floats in. Pixels outside
// [0, H W) read as TMA's zero fill.
__device__ __forceinline__ int box_start(int first) { return first & ~3; }

// A fragment of one k8 step: the container (hi) and its remainder (lo)
struct Frag {
    uint32_t hi[4], lo[4];
};

__device__ __forceinline__ void set_frag(Frag& f, int q, float v) {
    f.hi[q] = __float_as_uint(v);
    f.lo[q] = __float_as_uint(tf32_lo(v));
}

// d (+)= A B^T over k8 step `k8` of a k-block in 3xTF32: lo.hi, hi.lo,
// hi.hi, B's hi and lo tiles at descriptors bh, bl (32 bytes a step: 2 in
// the start field); `fresh` overwrites d
template <int N>
__device__ __forceinline__ void mma_k8(float (&d)[N / 2], const Frag& a, uint64_t bh, uint64_t bl,
                                       int k8, bool fresh) {
    wg::wgmma_tf32_rs<N>(d, a.lo, bh + 2 * k8, !fresh);
    wg::wgmma_tf32_rs<N>(d, a.hi, bl + 2 * k8, 1);
    wg::wgmma_tf32_rs<N>(d, a.hi, bh + 2 * k8, 1);
}

struct Ring {
    unsigned char* base;
    uint64_t *full, *empty;
};

// the stages from a 1024-byte boundary (the 128-byte swizzle's period),
// the mbarriers after them; full: one arrival (the producer), empty: one a
// consumer warpgroup
__device__ __forceinline__ Ring make_ring(unsigned char* smem, int stages, int stage_bytes) {
    const uint32_t base = wg::smem_u32(smem);
    Ring r;
    r.base = smem + (((base + 1023u) & ~1023u) - base);
    r.full = reinterpret_cast<uint64_t*>(r.base + (size_t)stages * stage_bytes);
    r.empty = r.full + kMaxStages;
    if (threadIdx.x == 0) {
        for (int s = 0; s < stages; ++s) {
            wg::mbar_init(&r.full[s], 1);
            wg::mbar_init(&r.empty[s], 2);
        }
        wg::fence_barrier_init();
    }
    __syncthreads();
    return r;
}

// ---------------------------------------------------------------- CWg on wgmma

// the flat offset of tap's input pixel from its output pixel: (kh - 1) W +
// kw - 1 for 3x3, 0 for 1x1
__device__ __forceinline__ int tap_shift(int tap, int kk, int w) {
    return kk == 9 ? (tap / 3 - 1) * w + tap % 3 - 1 : 0;
}

// A: the taps of x, MB rows (tap, ci) of a block's M tile as boxes of CI
// channels of one tap, XROW pixels each; B: dy, N output channels; K: 32
// pixels a k-block.
struct WgGeo {
    int HW, W, Cin, Cout, KK;
    int CI, bpm, nbox;          // channels a box, boxes an M tile, boxes in all
    int m_tiles, n_tiles, splits, items;
    int cpi, chunks;            // 32-pixel chunks an image, in all
    int stages, stage_bytes, b_bytes;
};

template <int N>
__global__ void __launch_bounds__(kWgThreads, 1)
wgrad_wgmma_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap dymap,
                   const __grid_constant__ CUtensorMap dylmap, float* __restrict__ work, WgGeo g) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const Ring ring = make_ring(smem_raw, g.stages, g.stage_bytes);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int tiles = g.m_tiles * g.n_tiles;

    if (warp == 8) {  // the producer
        if (lane != 0) return;
        int it = 0;
        for (int item = blockIdx.x; item < g.items; item += gridDim.x) {
            const int split = item / tiles, m = item % tiles / g.n_tiles, n = item % g.n_tiles;
            const int c_begin = (int)((int64_t)g.chunks * split / g.splits);
            const int c_end = (int)((int64_t)g.chunks * (split + 1) / g.splits);
            const int nb = min(g.bpm, g.nbox - m * g.bpm);
            for (int c = c_begin; c < c_end; ++c, ++it) {
                const int s = it % g.stages, img = c / g.cpi, q0 = (c % g.cpi) * KB;
                unsigned char* st = ring.base + (size_t)s * g.stage_bytes;
                wg::mbar_wait(&ring.empty[s], ((it / g.stages) & 1) ^ 1);
                wg::mbar_arrive_expect_tx(&ring.full[s], nb * g.CI * XROW * 4 + 2 * N * 128);
                wg::tma_load_3d(st + MB * XROW * 4, &dymap, &ring.full[s], q0, n * N, img);
                wg::tma_load_3d(st + MB * XROW * 4 + N * 128, &dylmap, &ring.full[s], q0, n * N,
                                img);
                for (int i = 0; i < nb; ++i) {
                    const int box = m * g.bpm + i, tap = box % g.KK;
                    wg::tma_load_3d(st + i * g.CI * XROW * 4, &xmap, &ring.full[s],
                                    box_start(q0 + tap_shift(tap, g.KK, g.W)), box / g.KK * g.CI,
                                    img);
                }
            }
        }
        return;
    }

    const int grp = warp >> 2, gl = lane >> 2, t = lane & 3;
    int it = 0;
    for (int item = blockIdx.x; item < g.items; item += gridDim.x) {
        const int split = item / tiles, m = item % tiles / g.n_tiles, n = item % g.n_tiles;
        const int c_begin = (int)((int64_t)g.chunks * split / g.splits);
        const int c_end = (int)((int64_t)g.chunks * (split + 1) / g.splits);
        // the thread's two A rows (g and g + 8 of its warp's 16): their
        // tap's shift, and which image edge its column leaves the row at
        // (1: x = 0 reads column -1, 2: x = W - 1 reads W), or 3 for a row
        // past the boxes
        int row[2], edge[2], shift[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            row[h] = 64 * grp + 16 * (warp & 3) + gl + 8 * h;
            const int box = m * g.bpm + row[h] / g.CI, tap = box % g.KK;
            const int kw = g.KK == 9 ? tap % 3 : 1;
            edge[h] = box >= g.nbox ? 3 : kw == 0 ? 1 : kw == 2 ? 2 : 0;
            shift[h] = tap_shift(tap, g.KK, g.W);
        }
        float acc[N / 2], d[N / 2];
#pragma unroll
        for (int j = 0; j < N / 2; ++j) acc[j] = 0.f;
        for (int c = c_begin; c < c_end; ++c, ++it) {
            const int s = it % g.stages, q0 = (c % g.cpi) * KB;
            unsigned char* st = ring.base + (size_t)s * g.stage_bytes;
            const float* A = reinterpret_cast<const float*>(st);
            const uint64_t bh = wg::smem_desc(st + MB * XROW * 4, 128);
            const uint64_t bl = wg::smem_desc(st + MB * XROW * 4 + g.b_bytes, 128);
            wg::mbar_wait(&ring.full[s], (it / g.stages) & 1);
            // the k columns of the thread: pixels q0 + t + 4 i (i = 2 k8 + h
            // for columns t + 8 k8 + 4 h); bit i: whether it sits on the left
            // (x = 0) or right (x = W - 1) edge
            unsigned on_left = 0, on_right = 0;
            int x = (q0 + t) % g.W;
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                on_left |= (unsigned)(x == 0) << i;
                on_right |= (unsigned)(x == g.W - 1) << i;
                for (x += 4; x >= g.W;) x -= g.W;
            }
            // each row's staged pixels: the first at q0 + shift, read from
            // box_start(q0 + shift)
            int base[2];
#pragma unroll
            for (int h = 0; h < 2; ++h) base[h] = row[h] * XROW + q0 - box_start(q0 + shift[h]);
            Frag a[4];
#pragma unroll
            for (int k8 = 0; k8 < 4; ++k8)
#pragma unroll
                for (int q = 0; q < 4; ++q) {  // a0 (g, t) a1 (g + 8, t) a2 (g, t + 4) a3 (g + 8, t + 4)
                    const int h = q & 1, kh = q >> 1, bit = 1u << (2 * k8 + kh);
                    const int e = edge[h], k = 8 * k8 + t + 4 * kh;
                    const bool off = e == 3 || (e == 1 && (on_left & bit)) ||
                                     (e == 2 && (on_right & bit));
                    set_frag(a[k8], q, off ? 0.f : A[base[h] + k + shift[h]]);
                }
            // a fresh accumulator a k8 step, folded into acc: K runs to
            // 591,872 in a split's one output tile, and the tensor cores'
            // float32 sum of a longer chain drifts (PERF.md)
#pragma unroll
            for (int k8 = 0; k8 < 4; ++k8) {
                wg::fence_acc(d);
                wg::wgmma_fence();
                mma_k8<N>(d, a[k8], bh, bl, k8, true);
                wg::wgmma_commit();
                wg::wgmma_wait<0>();
                wg::fence_acc(d);
#pragma unroll
                for (int j = 0; j < N / 2; ++j) acc[j] += d[j];
            }
            if ((threadIdx.x & 127) == 0) wg::mbar_arrive(&ring.empty[s]);
        }
        // the split's partial tile: work[split][(ci k^2 + tap) Cout + co]
        float* out = work + (int64_t)split * g.Cin * g.KK * g.Cout;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const int h = q >> 1, box = m * g.bpm + row[h] / g.CI;
            const int ci = box / g.KK * g.CI + row[h] % g.CI;
            if (box >= g.nbox || ci >= g.Cin) continue;
            float* orow = out + ((int64_t)ci * g.KK + box % g.KK) * g.Cout;
#pragma unroll
            for (int j = 0; j < N / 8; ++j) {
                const int co = n * N + 8 * j + 2 * t + (q & 1);
                if (co < g.Cout) orow[co] = acc[4 * j + q];
            }
        }
    }
}

// dw[co][ci k^2 + tap] = sum over the splits, in split order, of
// work[split][(ci k^2 + tap) Cout + co], in float64, rounded once: a
// 32 x 32 tile a block through shared memory, both sides coalesced
__global__ void __launch_bounds__(256)
wgrad_sum_t_kernel(const float* __restrict__ work, float* __restrict__ dw, int rows, int cout,
                   int splits) {
    __shared__ float tile[32][33];
    const int r0 = blockIdx.y * 32, c0 = blockIdx.x * 32, tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
    const int64_t n = (int64_t)rows * cout;
    for (int rr = ty; rr < 32; rr += 8) {
        const int r = r0 + rr, c = c0 + tx;
        if (r >= rows || c >= cout) continue;
        const int64_t e = (int64_t)r * cout + c;
        double sum = work[e];
        for (int p = 1; p < splits; ++p) sum += work[(int64_t)p * n + e];
        tile[rr][tx] = (float)sum;
    }
    __syncthreads();
    for (int cc = ty; cc < 32; cc += 8) {
        const int c = c0 + cc, r = r0 + tx;
        if (r < rows && c < cout) dw[(int64_t)c * rows + r] = tile[tx][cc];
    }
}

// lo[i] = the tf32 remainder of dy[i], n4 float4s: CWg's B low part
__global__ void __launch_bounds__(256)
tf32_lo_kernel(const float4* __restrict__ dy, float4* __restrict__ lo, int64_t n4) {
    for (int64_t i = (int64_t)blockIdx.x * 256 + threadIdx.x; i < n4; i += (int64_t)gridDim.x * 256) {
        const float4 v = dy[i];
        lo[i] = make_float4(tf32_lo(v.x), tf32_lo(v.y), tf32_lo(v.z), tf32_lo(v.w));
    }
}

// ---------------------------------------------------------------- CXg on wgmma

// A: dy at a tap's shift, MB pixels of one image (a box of 32 output
// channels x DROW pixels); B: the weights as [tap][ci][co], N input channels;
// K: 32 output channels of one tap a k-block. Within each 8 of a k-block
// the output channels run 0 2 4 6 1 3 5 7: a thread's A columns t and
// t + 4 are channels 2 t and 2 t + 1, which keeps its loads off each
// other's banks.
struct XgGeo {
    int HW, W, Cin, Cout, KK;
    int cpi, n_tiles, items;           // 128-pixel tiles an image; work items
    int kblocks;                       // 32-channel chunks x taps
    int stages, stage_bytes, b_bytes;
};

__device__ __forceinline__ int kperm(int c) { return c < 4 ? 2 * c : 2 * (c - 4) + 1; }

template <int N>
__global__ void __launch_bounds__(kWgThreads, 1)
dgrad_wgmma_kernel(const __grid_constant__ CUtensorMap dymap, const __grid_constant__ CUtensorMap whmap,
                   const __grid_constant__ CUtensorMap wlmap, float* __restrict__ dx, XgGeo g) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const Ring ring = make_ring(smem_raw, g.stages, g.stage_bytes);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

    if (warp == 8) {  // the producer
        if (lane != 0) return;
        int it = 0;
        for (int item = blockIdx.x; item < g.items; item += gridDim.x) {
            const int m = item / g.n_tiles, n = item % g.n_tiles;
            const int img = m / g.cpi, q0 = (m % g.cpi) * MB;
            for (int kb = 0; kb < g.kblocks; ++kb, ++it) {
                const int s = it % g.stages, cc = kb / g.KK, tap = kb % g.KK;
                unsigned char* st = ring.base + (size_t)s * g.stage_bytes;
                wg::mbar_wait(&ring.empty[s], ((it / g.stages) & 1) ^ 1);
                wg::mbar_arrive_expect_tx(&ring.full[s], KB * DROW * 4 + 2 * g.b_bytes);
                wg::tma_load_3d(st, &dymap, &ring.full[s],
                                box_start(q0 - tap_shift(tap, g.KK, g.W)), cc * KB, img);
                wg::tma_load_3d(st + XG_A, &whmap, &ring.full[s], cc * KB, n * N, tap);
                wg::tma_load_3d(st + XG_A + g.b_bytes, &wlmap, &ring.full[s], cc * KB, n * N, tap);
            }
        }
        return;
    }

    const int grp = warp >> 2, gl = lane >> 2, t = lane & 3;
    int it = 0;
    for (int item = blockIdx.x; item < g.items; item += gridDim.x) {
        const int m = item / g.n_tiles, n = item % g.n_tiles;
        const int img = m / g.cpi, q0 = (m % g.cpi) * MB;
        // the thread's two pixels (rows g and g + 8 of its warp's 16) and
        // whether each sits on the left (x = 0) or right (x = W - 1) edge
        int px[2];
        bool at_left[2], at_right[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            px[h] = 64 * grp + 16 * (warp & 3) + gl + 8 * h;
            const int x = (q0 + px[h]) % g.W;
            at_left[h] = x == 0;
            at_right[h] = x == g.W - 1;
        }
        float acc[N / 2], d[N / 2];
#pragma unroll
        for (int j = 0; j < N / 2; ++j) acc[j] = 0.f;
        for (int kb = 0; kb < g.kblocks; ++kb, ++it) {
            const int s = it % g.stages, tap = kb % g.KK, kw = g.KK == 9 ? tap % 3 : 1;
            const int shift = tap_shift(tap, g.KK, g.W);
            const unsigned char* st = ring.base + (size_t)s * g.stage_bytes;
            wg::mbar_wait(&ring.full[s], (it / g.stages) & 1);
            // dy's pixel q0 + px - shift, staged from box_start(q0 - shift);
            // its column x - kw + 1 leaves the row at x = W - 1 (kw = 0) and
            // at x = 0 (kw = 2)
            const float* A = reinterpret_cast<const float*>(st);
            const int col0 = q0 - shift - box_start(q0 - shift);
            bool off[2];
#pragma unroll
            for (int h = 0; h < 2; ++h) off[h] = (kw == 0 && at_right[h]) || (kw == 2 && at_left[h]);
            Frag a[4];
#pragma unroll
            for (int k8 = 0; k8 < 4; ++k8)
#pragma unroll
                for (int q = 0; q < 4; ++q) {  // a0 (g, t) a1 (g + 8, t) a2 (g, t + 4) a3 (g + 8, t + 4)
                    const int h = q & 1, co = 8 * k8 + 2 * t + (q >> 1);
                    set_frag(a[k8], q, off[h] ? 0.f : A[co * DROW + col0 + px[h]]);
                }
            const uint64_t bh = wg::smem_desc(st + XG_A, 128);
            const uint64_t bl = wg::smem_desc(st + XG_A + g.b_bytes, 128);
            wg::fence_acc(d);
            wg::wgmma_fence();
#pragma unroll
            for (int k8 = 0; k8 < 4; ++k8) mma_k8<N>(d, a[k8], bh, bl, k8, k8 == 0);
            wg::wgmma_commit();
            wg::wgmma_wait<0>();
            wg::fence_acc(d);
            if ((threadIdx.x & 127) == 0) wg::mbar_arrive(&ring.empty[s]);
#pragma unroll
            for (int j = 0; j < N / 2; ++j) acc[j] += d[j];
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const int p = q0 + px[q >> 1];
            if (p >= g.HW) continue;
            float* o = dx + (int64_t)img * g.Cin * g.HW + p;
#pragma unroll
            for (int j = 0; j < N / 8; ++j) {
                const int ci = n * N + 8 * j + 2 * t + (q & 1);
                if (ci < g.Cin) o[(int64_t)ci * g.HW] = acc[4 * j + q];
            }
        }
    }
}

// wt[0][tap][ci][co'] = w[co][ci][tap] and wt[1] its remainder under tf32,
// co' the position of co in its 8 (kperm), zero past Cout (co' < coutp)
__global__ void __launch_bounds__(256)
dgrad_weights_kernel(const float* __restrict__ w, float* __restrict__ wt, int cin, int cout,
                     int coutp, int kk) {
    const int64_t n = (int64_t)kk * cin * coutp;
    const int64_t e = (int64_t)blockIdx.x * 256 + threadIdx.x;
    if (e >= n) return;
    const int cp = (int)(e % coutp), ci = (int)(e / coutp % cin), tap = (int)(e / coutp / cin);
    const int co = cp / 8 * 8 + kperm(cp % 8);
    const float v = co < cout ? w[((int64_t)co * cin + ci) * kk + tap] : 0.f;
    wt[e] = v;
    wt[n + e] = tf32_lo(v);
}

// ---------------------------------------------------------------- launch: mma.sync

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

// ---------------------------------------------------------------- launch: wgmma

// TMA's maps need every global stride a multiple of 16 bytes: H W % 4 == 0
// for the (H W, C, B) view. Other shapes take the mma.sync kernels.
bool wgmma_shape(int H, int W) { return (int64_t)H * W % 4 == 0; }

// CWg on wgmma also needs work enough to fill its 128 x N tile beside
// the loads and the splits of its register operand, which cost the same
// for any N. With m = Cin k^2 (the rows of M), it takes wgmma where Cout
// >= 128 and m >= 128; Cout >= 64, m >= 256 and m H W >= 2^24; or Cout >=
// 32, m >= 512 and m H W >= 2^27 (never Cout < 32: the wgmma CWg's N
// tiles are 32 to 128). That picks the faster kernel at every conv of the
// four presets' steps (tools/conv_grad_ab.py against a build with this
// rule cut to wgmma_shape, PERF.md): mma.sync ran 1.3-3.7x faster at the
// image convs, the 16-channel convs and the 1x1 heads, 16-19% at 32 -> 32
// and at 96 -> 32 below 544^2, 20-29% at the 64-channel convs at
// 128^2-136^2 and 59% at 64 -> 256 1x1; wgmma 5-6% faster at 96 -> 32 at
// 544^2, 8-10% at 128 -> 512 1x1 at 68^2, 24-50% at the 64-channel convs
// from 272^2 (or m = 1728 at 128^2), and at every wider conv.
bool wgrad_wgmma_shape(int Cin, int Cout, int H, int W, int ks) {
    const int64_t m = (int64_t)Cin * ks * ks, work = m * H * W;
    return wgmma_shape(H, W) &&
           ((Cout >= 128 && m >= 128) || (Cout >= 64 && m >= 256 && work >= (int64_t(1) << 24)) ||
            (Cout >= 32 && m >= 512 && work >= (int64_t(1) << 27)));
}

// the N tile for c channels: the least that covers c up to 128, then 128
// or 96 where either divides c
int tile_n(int c) {
    if (c <= 128)
        for (const int n : {8, 16, 32, 64, 96, 128})
            if (n >= c) return n;
    return c % 128 == 0 ? 128 : c % 96 == 0 ? 96 : 128;
}

int device_sms() {
    int dev = 0, sms = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
        return 0;
    return sms;
}

void ring_size(int stage_bytes, int& stages, size_t& smem) {
    const size_t fixed = 1024 + 2 * kMaxStages * 8;
    stages = (int)std::min<size_t>(kMaxStages, (kSmemBlock - fixed) / stage_bytes);
    smem = fixed + (size_t)stages * stage_bytes;
}

struct WgPlan {
    WgGeo g;
    int N;
    size_t smem;
};

// CWg's tiling of a shape (splits 0: the shape's own count); false for a
// shape it does not take
bool wg_plan(int B, int Cin, int Cout, int H, int W, int ks, int splits, WgPlan& p) {
    WgGeo& g = p.g;
    g = WgGeo{};
    g.HW = H * W, g.W = W, g.Cin = Cin, g.Cout = Cout, g.KK = ks * ks;
    int padded = -1;  // channels a box: the least padding of Cin, then the widest
    for (const int ci : {64, 32, 16, 8}) {
        const int pad = (Cin + ci - 1) / ci * ci;
        if (padded < 0 || pad < padded) padded = pad, g.CI = ci;
    }
    g.bpm = MB / g.CI;
    g.nbox = padded / g.CI * g.KK;
    g.m_tiles = (g.nbox + g.bpm - 1) / g.bpm;
    p.N = tile_n(Cout);
    g.n_tiles = (Cout + p.N - 1) / p.N;
    g.cpi = (g.HW + KB - 1) / KB;
    const int64_t chunks = (int64_t)B * g.cpi, tiles = (int64_t)g.m_tiles * g.n_tiles;
    if (chunks > INT32_MAX) return false;
    g.chunks = (int)chunks;
    if (splits == 0) {
        // splits that fill whole waves of one block an SM best (the fewest
        // of equals), at least 4 chunks a split, at most 8 waves
        const int64_t most = std::max<int64_t>(1, std::min<int64_t>(
            chunks / 4, (8 * kSms + tiles - 1) / tiles));
        int64_t best_items = 0, best_slots = 1;
        for (int64_t s = 1; s <= most; ++s) {
            const int64_t items = tiles * s, slots = (items + kSms - 1) / kSms * kSms;
            if (items * best_slots > best_items * slots) best_items = items, best_slots = slots, splits = (int)s;
        }
    }
    if (splits < 1 || splits > chunks || tiles * splits > INT32_MAX) return false;
    g.splits = splits;
    g.items = (int)(tiles * splits);
    g.b_bytes = p.N * 128;
    g.stage_bytes = MB * XROW * 4 + 2 * g.b_bytes;
    ring_size(g.stage_bytes, g.stages, p.smem);
    return true;
}

struct XgPlan {
    XgGeo g;
    int N, coutp;
    size_t smem;
};

bool xg_plan(int B, int Cin, int Cout, int H, int W, int ks, XgPlan& p) {
    XgGeo& g = p.g;
    g = XgGeo{};
    g.HW = H * W, g.W = W, g.Cin = Cin, g.Cout = Cout, g.KK = ks * ks;
    p.N = tile_n(Cin);
    g.n_tiles = (Cin + p.N - 1) / p.N;
    g.cpi = (g.HW + MB - 1) / MB;
    const int64_t items = (int64_t)B * g.cpi * g.n_tiles;
    if (items > INT32_MAX) return false;
    g.items = (int)items;
    p.coutp = (Cout + KB - 1) / KB * KB;
    g.kblocks = p.coutp / KB * g.KK;
    g.b_bytes = p.N * 128;
    g.stage_bytes = XG_A + 2 * g.b_bytes;
    ring_size(g.stage_bytes, g.stages, p.smem);
    return true;
}

// a (HW, C, B) float32 map of an NCHW tensor, boxes of `px` pixels x
// `rows` channels; swizzle S bytes (0: none)
bool nchw_map(CUtensorMap* m, const float* t, int B, int C, int64_t HW, int px, int rows, int S) {
    const uint64_t dims[3] = {(uint64_t)HW, (uint64_t)C, (uint64_t)B};
    const uint64_t strides[2] = {(uint64_t)HW * 4, (uint64_t)HW * C * 4};
    const uint32_t box[3] = {(uint32_t)px, (uint32_t)rows, 1};
    return wg::encode_f32(m, t, 3, dims, strides, box, S);
}

template <int N>
cudaError_t launch_wg_n(const WgPlan& p, const CUtensorMap& xm, const CUtensorMap& dym,
                        const CUtensorMap& dylm, float* work, int sms, cudaStream_t stream) {
    const cudaError_t err = cudaFuncSetAttribute(
        wgrad_wgmma_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
    if (err != cudaSuccess) return err;
    wgrad_wgmma_kernel<N><<<std::min(p.g.items, sms), kWgThreads, p.smem, stream>>>(xm, dym, dylm,
                                                                                    work, p.g);
    return cudaGetLastError();
}

template <int N>
cudaError_t launch_xg_n(const XgPlan& p, const CUtensorMap& dym, const CUtensorMap& whm,
                        const CUtensorMap& wlm, float* dx, int sms, cudaStream_t stream) {
    const cudaError_t err = cudaFuncSetAttribute(
        dgrad_wgmma_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
    if (err != cudaSuccess) return err;
    dgrad_wgmma_kernel<N><<<std::min(p.g.items, sms), kWgThreads, p.smem, stream>>>(dym, whm, wlm,
                                                                                    dx, p.g);
    return cudaGetLastError();
}

bool aligned16(const void* a, const void* b, const void* c) {
    return reinterpret_cast<uintptr_t>(a) % 16 == 0 && reinterpret_cast<uintptr_t>(b) % 16 == 0 &&
           reinterpret_cast<uintptr_t>(c) % 16 == 0;
}

// work: dy's tf32 remainders (B Cout H W floats), then the splits' partial
// tiles
int wgrad_wgmma(const float* x, const float* dy, float* dw, float* work, int B, int Cin, int Cout,
                int H, int W, int ks, int splits, cudaStream_t st) {
    WgPlan p;
    const int sms = device_sms();
    if (!wg_plan(B, Cin, Cout, H, W, ks, splits, p) || !aligned16(x, dy, work) || sms < 1)
        return (int)cudaErrorInvalidValue;
    const int64_t n = (int64_t)B * Cout * p.g.HW;
    float* partial = work + n;
    CUtensorMap xm, dym, dylm;
    if (!nchw_map(&xm, x, B, Cin, p.g.HW, XROW, p.g.CI, 0) ||
        !nchw_map(&dym, dy, B, Cout, p.g.HW, KB, p.N, 128) ||
        !nchw_map(&dylm, work, B, Cout, p.g.HW, KB, p.N, 128))
        return (int)cudaErrorInvalidValue;
    tf32_lo_kernel<<<(unsigned)std::min<int64_t>((n / 4 + 255) / 256, 8 * sms), 256, 0, st>>>(
        reinterpret_cast<const float4*>(dy), reinterpret_cast<float4*>(work), n / 4);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    switch (p.N) {  // Cout >= 32 (wgrad_wgmma_shape)
        case 32: err = launch_wg_n<32>(p, xm, dym, dylm, partial, sms, st); break;
        case 64: err = launch_wg_n<64>(p, xm, dym, dylm, partial, sms, st); break;
        case 96: err = launch_wg_n<96>(p, xm, dym, dylm, partial, sms, st); break;
        case 128: err = launch_wg_n<128>(p, xm, dym, dylm, partial, sms, st); break;
        default: return (int)cudaErrorInvalidValue;
    }
    if (err != cudaSuccess) return (int)err;
    const int rows = Cin * p.g.KK;
    wgrad_sum_t_kernel<<<dim3((Cout + 31) / 32, (rows + 31) / 32), 256, 0, st>>>(
        partial, dw, rows, Cout, p.g.splits);
    return (int)cudaGetLastError();
}

int dgrad_wgmma(const float* dy, const float* w, float* dx, float* work, int B, int Cin, int Cout,
                int H, int W, int ks, cudaStream_t st) {
    XgPlan p;
    const int sms = device_sms();
    if (!xg_plan(B, Cin, Cout, H, W, ks, p) || !aligned16(dy, work, dx) || sms < 1)
        return (int)cudaErrorInvalidValue;
    const int kk = ks * ks;
    const int64_t n = (int64_t)kk * Cin * p.coutp;
    dgrad_weights_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(w, work, Cin, Cout, p.coutp, kk);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    CUtensorMap dym, whm, wlm;
    const uint64_t dims[3] = {(uint64_t)p.coutp, (uint64_t)Cin, (uint64_t)kk};
    const uint64_t strides[2] = {(uint64_t)p.coutp * 4, (uint64_t)p.coutp * Cin * 4};
    const uint32_t box[3] = {KB, (uint32_t)p.N, 1};
    if (!nchw_map(&dym, dy, B, Cout, p.g.HW, DROW, KB, 0) ||
        !wg::encode_f32(&whm, work, 3, dims, strides, box, 128) ||
        !wg::encode_f32(&wlm, work + n, 3, dims, strides, box, 128))
        return (int)cudaErrorInvalidValue;
    switch (p.N) {
        case 8: err = launch_xg_n<8>(p, dym, whm, wlm, dx, sms, st); break;
        case 16: err = launch_xg_n<16>(p, dym, whm, wlm, dx, sms, st); break;
        case 32: err = launch_xg_n<32>(p, dym, whm, wlm, dx, sms, st); break;
        case 64: err = launch_xg_n<64>(p, dym, whm, wlm, dx, sms, st); break;
        case 96: err = launch_xg_n<96>(p, dym, whm, wlm, dx, sms, st); break;
        default: err = launch_xg_n<128>(p, dym, whm, wlm, dx, sms, st); break;
    }
    return (int)err;
}

}  // namespace

extern "C" {

// 1 where CWg takes its wgmma kernel at a shape, 0 where the mma.sync one
// (CXg takes wgmma wherever H W % 4 == 0)
int conv_wgrad_wgmma(int Cin, int Cout, int H, int W, int ks) {
    return wgrad_wgmma_shape(Cin, Cout, H, W, ks) ? 1 : 0;
}

// CWg's number of K splits for a shape. It depends on the shape only, so a
// shape's sums are always taken in one order. The wgmma path: the count
// that fills whole waves of one block an SM of an H100 best; the mma.sync
// path: enough blocks for 4 an SM, at most one chunk of 128 pixels a
// split.
int conv_wgrad_splits(int B, int Cin, int Cout, int H, int W, int ks) {
    if (B < 1 || Cin < 1 || Cout < 1 || H < 1 || W < 1 || (ks != 1 && ks != 3)) return 1;
    if (wgrad_wgmma_shape(Cin, Cout, H, W, ks)) {
        WgPlan p;
        return wg_plan(B, Cin, Cout, H, W, ks, 0, p) ? p.g.splits : 1;
    }
    int co_blocks, ci_blocks;
    wg_tiles(Cin, Cout, ks, co_blocks, ci_blocks);
    const int64_t chunks = (int64_t)B * (((int64_t)H * W + PX - 1) / PX);
    const int64_t tiles = (int64_t)co_blocks * ci_blocks;
    int64_t splits = (kTargetBlocks + tiles - 1) / tiles;
    if (splits > chunks) splits = chunks;
    return (int)(splits < 1 ? 1 : splits);
}

// The floats of CWg's workspace for a shape and split count: the splits'
// partial tiles, splits x Cout x Cin x ks^2, and on the wgmma path dy's
// tf32 remainders, B x Cout x H x W, besides.
int64_t conv_wgrad_workspace(int B, int Cin, int Cout, int H, int W, int ks, int splits) {
    const int64_t partials = (int64_t)splits * Cout * Cin * ks * ks;
    return wgrad_wgmma_shape(Cin, Cout, H, W, ks) ? partials + (int64_t)B * Cout * H * W : partials;
}

// dw (Cout, Cin, ks, ks) from x (B, Cin, H, W) and dy (B, Cout, H, W), all
// float32 contiguous and 16-byte aligned; work holds conv_wgrad_workspace
// floats. Two or three launches on `stream`; returns the cudaError_t of
// the launches (0 on success).
int conv_wgrad(const float* x, const float* dy, float* dw, float* work, int B, int Cin, int Cout,
               int H, int W, int ks, int splits, void* stream) {
    Shape s;
    if (!make_shape(s, B, Cin, Cout, H, W, ks, x, dy, work) || splits < 1 || splits > 65535)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (wgrad_wgmma_shape(Cin, Cout, H, W, ks))
        return wgrad_wgmma(x, dy, dw, work, B, Cin, Cout, H, W, ks, splits, st);
    if (splits > (int64_t)B * s.cpi) return (int)cudaErrorInvalidValue;
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

// The floats of CXg's workspace for a shape: the weights as [tap][ci][co]
// and their tf32 remainders (the wgmma path), or 0 (the mma.sync path).
int64_t conv_dgrad_workspace(int B, int Cin, int Cout, int H, int W, int ks) {
    if (B < 1 || Cin < 1 || Cout < 1 || H < 1 || W < 1 || (ks != 1 && ks != 3) ||
        !wgmma_shape(H, W))
        return 0;
    return 2 * (int64_t)ks * ks * Cin * ((Cout + KB - 1) / KB * KB);
}

// dx (B, Cin, H, W) from dy (B, Cout, H, W) and w (Cout, Cin, ks, ks), all
// float32 contiguous and 16-byte aligned; work holds
// conv_dgrad_workspace floats. One or two launches on `stream`; returns
// their cudaError_t.
int conv_dgrad(const float* dy, const float* w, float* dx, float* work, int B, int Cin, int Cout,
               int H, int W, int ks, void* stream) {
    Shape s;
    if (!make_shape(s, B, Cin, Cout, H, W, ks, dy, w, dx) || (Cin + 15) / 16 > 65535)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (wgmma_shape(H, W)) return dgrad_wgmma(dy, w, dx, work, B, Cin, Cout, H, W, ks, st);
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
