// int8 serving on Hopper (sm_90a): two kernels, neither with a TPU site.
// The JAX package computes both outside Pallas (pixel_embedded_affinity_tpu/
// ops/quant.py: conv_i8 is an XLA conv with preferred_element_type=int32,
// quantize_act a jnp expression), and no PyTorch call computes an int8
// convolution on the card (F.conv2d refuses int8 there; torch._int_mm
// needs an im2col of kh x kw times the activation's bytes).
//
// Python wrapper: ops/conv_i8_cuda.py.
//
// I8c, conv_i8_fwd. x: (B, H, W, Cin) NHWC int8, Cin a multiple of 16 (the
// wrapper pads other widths with zero channels); w: the packed (Cout,
// kh * kw * Cin) int8 weights, K order (dy, dx, ci) contiguous; scale:
// (Cout,) float32; shift: (Cout,) float32 or null. With the padding (pt,
// pb, pl, pr) the output is (B, Ho, Wo, Cout) float32, Ho = H + pt + pb -
// kh + 1, Wo = W + pl + pr - kw + 1:
//     acc[b, r, c, o] = sum_{dy, dx, i} w[o, dy, dx, i] x[b, r + dy - pt, c + dx - pl, i]
// in int32 (x read as 0 outside the image; exact: |acc| <= 127^2 kh kw Cin),
// then out = __fadd_rn(__fmul_rn(float(acc), scale[o]), shift[o]) with no
// contracted multiply-add, so the card's result equals the plain version's
// (acc converted to float32, times scale, plus shift) to the bit. With
// scale null, out receives acc itself.
//
// What bounds it: 2 kh kw Cin Cout operations a pixel at 1,979 TOPS (dense
// int8) against the bytes (x once, w once, out once as float32) at 3.35
// TB/s. The float32 output, 4 bytes a channel against the input's 1, makes
// 16 of the 23 calls of the served forward bound by bytes, the deep 3x3
// convs at 68² and 136² by operations.
//
// Design: an implicit GEMM, M = output pixels, N = output channels, K =
// taps x Cin, on wgmma.mma_async m64nNk32 .s32.s8.s8 (wgmma_tma.cuh), with
// both operands K-major in shared memory. A block is two consumer
// warpgroups and one producer warp (288 threads), one block an SM. An M
// tile is a TH x TW box of 128 MW output pixels (8 x 16 or 16 x 8 at MW =
// 1, 16 x 16 or 32 x 8 at MW = 2), each consumer warpgroup MW m64 rows of
// it; N is BN = 128 or 64 channels. make_plan picks MW, BN and the box
// that give the fewest rounds of tiles over the SMs times the bytes a
// tile's k-blocks move (MW = 2 only with BN = 64). K runs in k-blocks of
// one tap x S channels, S = 128, 64 or 32 bytes (the widest that divides
// Cin and leaves a ring of 4 stages), read in S / 32 wgmma k steps. The
// producer warp's one thread loads each k-block into the ring by TMA: the
// input through a 4-D map over (C, W, H, B), the same TH x TW box at the
// tap's offset (dy - pt, dx - pl), so TMA's zero fill outside the tensor is
// the padding, the ragged edge and the K tail past Cin; the weights through
// a 2-D map over (K, Cout) at (tap Cin + c S, o0). Both maps swizzle by S
// bytes, the layout the wgmma descriptors read. Full and empty mbarriers
// pace the ring; a consumer releases a stage once the wgmma group after it
// has been committed and the one before it waited for (wait_group 1). The
// grid is persistent (as many blocks as the tiles, at most one an SM),
// walking the tiles weight-slab-major, so the blocks in flight share one
// slab of weights from L2 while the producer runs ahead into the next tile
// during an epilogue. The epilogue stages each warp's 16 rows, 64 channels
// at a time, in shared memory (rows 72 words apart: the 8-byte fragment
// stores meet no bank conflict) and writes each pixel's channels with
// 16-byte stores, a warp two rows at a time.
//
// What it gives up: the input is read once a tap from L2 (kh kw times its
// bytes), not staged once with its halo; the weights once an M tile, with
// no cluster multicast; no split K, so a 68² site with Cout 256 fills 90
// of the 132 SMs; one block an SM, so a tile's epilogue leaves the tensor
// cores idle (two blocks an SM, at 64-byte k-blocks, ran slower); the
// float32 output is written as it is, since the JAX op returns float32 (a
// fused requantize, residual add or ReLU is not offered).
//
// I8q, quantize_i8. x float32 or bfloat16, n elements -> int8:
// clip(rint(float(x) * inv), -127, 127), rounding half to even as
// jnp.round and torch.round do (rintf, not roundf). An elementwise pass,
// bound by its bytes (4 or 2 in, 1 out): each thread reads 16 elements
// with 16-byte loads (four for float32, two for bfloat16) and writes their
// codes as one 16-byte store; a scalar path takes the head before the
// output's first 16-byte boundary and the tail. The grid is a whole number
// of waves over the SMs, walked grid-stride.

#include <algorithm>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "wgmma_tma.cuh"

namespace {

constexpr int kThreads = 288;  // two consumer warpgroups, one producer warp
constexpr int kMaxStages = 8;
constexpr size_t kSmemBlock = 232448;  // a block's shared memory
constexpr int EC = 64;       // channels the epilogue stages at a time
constexpr int RW = EC + 8;   // a staged row, words: the 8-byte fragment stores meet no bank conflict
constexpr size_t kStaging = 8 * 16 * RW * 4;  // 16 rows a consumer warp

struct Geometry {
    int Ho, Wo, Cin, Cout, kw, pt, pl;
    int S;                // k-block bytes: channels a k-block, the swizzle width
    int TW, TH;           // the M tile's box of output pixels
    int nch, nkb;         // k-blocks a tap, a tile
    int mx, my, m_tiles;  // M tiles along x, along y, in all
    int tiles;            // M tiles x N tiles
    int stages, stage_bytes, a_bytes;
    int vec;              // 16-byte output stores
};

__device__ __forceinline__ void tile_origin(const Geometry& g, int bn, int t, int& b, int& y0,
                                            int& x0, int& o0) {
    const int n = t / g.m_tiles, m = t % g.m_tiles;  // weight-slab-major
    b = m / (g.mx * g.my);
    const int r = m % (g.mx * g.my);
    y0 = (r / g.mx) * g.TH;
    x0 = (r % g.mx) * g.TW;
    o0 = n * bn;
}

// BN output channels by 128 MW pixels a tile: each consumer warpgroup
// takes MW m64 rows of 64 pixels.
template <int BN, int MW>
__global__ void __launch_bounds__(kThreads, 1)
conv_i8_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
               const float* __restrict__ scale, const float* __restrict__ shift,
               void* __restrict__ out, Geometry g) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    // the stages start on a 1024-byte boundary of the shared window, the
    // period of the 128-byte swizzle
    const uint32_t base = wg::smem_u32(smem_raw);
    unsigned char* ring = smem_raw + (((base + 1023u) & ~1023u) - base);
    int* staging = reinterpret_cast<int*>(ring + g.stages * g.stage_bytes);
    uint64_t* full = reinterpret_cast<uint64_t*>(staging + kStaging / 4);
    uint64_t* empty = full + kMaxStages;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (threadIdx.x == 0) {
        for (int s = 0; s < g.stages; ++s) {
            wg::mbar_init(&full[s], 1);
            wg::mbar_init(&empty[s], 2);  // one arrival a consumer warpgroup
        }
        wg::fence_barrier_init();
    }
    __syncthreads();

    if (warp == 8) {  // the producer
        if (lane != 0) return;
        int it = 0;
        for (int t = blockIdx.x; t < g.tiles; t += gridDim.x) {
            int b, y0, x0, o0;
            tile_origin(g, BN, t, b, y0, x0, o0);
            for (int kb = 0; kb < g.nkb; ++kb, ++it) {
                const int s = it % g.stages, tap = kb / g.nch, c = kb % g.nch;
                unsigned char* a = ring + s * g.stage_bytes;
                wg::mbar_wait(&empty[s], ((it / g.stages) & 1) ^ 1);
                wg::mbar_arrive_expect_tx(&full[s], g.stage_bytes);  // whole boxes, fill included
                wg::tma_load_4d(a, &xmap, &full[s], c * g.S, x0 + tap % g.kw - g.pl,
                                y0 + tap / g.kw - g.pt, b);
                wg::tma_load_2d(a + g.a_bytes, &wmap, &full[s], tap * g.Cin + c * g.S, o0);
            }
        }
        return;
    }

    const int grp = warp >> 2;  // the consumer warpgroup: tile rows 64 MW grp ..
    int* st = staging + warp * 16 * RW;
    constexpr int LPR = EC / 4, RPP = 32 / LPR;  // lanes a staged row, rows a pass
    int acc[MW][BN / 2];
#pragma unroll
    for (int i = 0; i < MW; ++i)
#pragma unroll
        for (int j = 0; j < BN / 2; ++j) acc[i][j] = 0;
    int it = 0;
    for (int t = blockIdx.x; t < g.tiles; t += gridDim.x) {
        int b, y0, x0, o0;
        tile_origin(g, BN, t, b, y0, x0, o0);
        int prev = 0;
        for (int kb = 0; kb < g.nkb; ++kb, ++it) {
            const int s = it % g.stages;
            wg::mbar_wait(&full[s], (it / g.stages) & 1);
            const unsigned char* a = ring + s * g.stage_bytes;
            const uint64_t da = wg::smem_desc(a + grp * MW * 64 * g.S, g.S);
            const uint64_t db = wg::smem_desc(a + g.a_bytes, g.S);
#pragma unroll
            for (int i = 0; i < MW; ++i) wg::fence_acc(acc[i]);
            wg::wgmma_fence();
            for (int ks = 0; ks < g.S / 32; ++ks)  // 32 bytes on: 2 in the start field
#pragma unroll
                for (int i = 0; i < MW; ++i)  // 64 rows on: 4 S in the start field
                    wg::wgmma_s8<BN>(acc[i], da + 4 * i * g.S + 2 * ks, db + 2 * ks, kb | ks);
            wg::wgmma_commit();
#pragma unroll
            for (int i = 0; i < MW; ++i) wg::fence_acc(acc[i]);
            if (kb > 0) {  // the previous k-block's products are done: free its stage
                wg::wgmma_wait<1>();
#pragma unroll
                for (int i = 0; i < MW; ++i) wg::fence_acc(acc[i]);
                if ((threadIdx.x & 127) == 0) wg::mbar_arrive(&empty[prev]);
            }
            prev = s;
        }
        wg::wgmma_wait<0>();
#pragma unroll
        for (int i = 0; i < MW; ++i) wg::fence_acc(acc[i]);
        if ((threadIdx.x & 127) == 0) wg::mbar_arrive(&empty[prev]);

        // epilogue: the warp's 16 rows of each m64 through shared memory, EC
        // channels at a time, then 16-byte stores of each pixel's channels
        const int gq = lane >> 2, t4 = lane & 3, c4 = lane % LPR;
#pragma unroll
        for (int i = 0; i < MW; ++i)
#pragma unroll
            for (int ch = 0; ch < BN / EC; ++ch) {
#pragma unroll
                for (int j = 0; j < EC / 8; ++j)
#pragma unroll
                    for (int h = 0; h < 2; ++h) {
                        const int e = 4 * (ch * EC / 8 + j) + 2 * h;
                        *reinterpret_cast<int2*>(st + (gq + 8 * h) * RW + 8 * j + 2 * t4) =
                            make_int2(acc[i][e], acc[i][e + 1]);
                    }
                __syncwarp();
                const int oc = o0 + ch * EC + 4 * c4;
                float sc[4] = {0.f, 0.f, 0.f, 0.f}, sh[4] = {0.f, 0.f, 0.f, 0.f};
                if (scale)
#pragma unroll
                    for (int e = 0; e < 4; ++e)
                        if (oc + e < g.Cout) {
                            sc[e] = scale[oc + e];
                            if (shift) sh[e] = shift[oc + e];
                        }
#pragma unroll 1
                for (int r0 = 0; r0 < 16; r0 += RPP) {
                    const int r = r0 + lane / LPR;
                    const int m = (grp * MW + i) * 64 + (warp & 3) * 16 + r;
                    const int y = y0 + m / g.TW, x = x0 + m % g.TW;
                    if (y >= g.Ho || x >= g.Wo || oc >= g.Cout) continue;
                    const int4 v = *reinterpret_cast<const int4*>(st + r * RW + 4 * c4);
                    const int vi[4] = {v.x, v.y, v.z, v.w};
                    const size_t off = (((size_t)b * g.Ho + y) * g.Wo + x) * g.Cout + oc;
                    if (!scale) {
                        int* op = static_cast<int*>(out) + off;
                        if (g.vec && oc + 3 < g.Cout)
                            *reinterpret_cast<int4*>(op) = v;
                        else
                            for (int e = 0; e < 4 && oc + e < g.Cout; ++e) op[e] = vi[e];
                        continue;
                    }
                    float f[4];
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        f[e] = __fmul_rn(__int2float_rn(vi[e]), sc[e]);
                        if (shift) f[e] = __fadd_rn(f[e], sh[e]);
                    }
                    float* op = static_cast<float*>(out) + off;
                    if (g.vec && oc + 3 < g.Cout)
                        *reinterpret_cast<float4*>(op) = make_float4(f[0], f[1], f[2], f[3]);
                    else
                        for (int e = 0; e < 4 && oc + e < g.Cout; ++e) op[e] = f[e];
                }
                __syncwarp();
            }
    }
}

__device__ __forceinline__ int8_t code(float v, float inv) {
    const float s = __fmul_rn(v, inv);
    return (int8_t)__float2int_rn(fminf(fmaxf(s, -127.f), 127.f));
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// 16 elements from 16-byte-aligned x
__device__ __forceinline__ void load16(const float* x, float (&f)[16]) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        const float4 v = reinterpret_cast<const float4*>(x)[q];
        f[4 * q] = v.x;
        f[4 * q + 1] = v.y;
        f[4 * q + 2] = v.z;
        f[4 * q + 3] = v.w;
    }
}

__device__ __forceinline__ void load16(const __nv_bfloat16* x, float (&f)[16]) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
        const uint4 v = reinterpret_cast<const uint4*>(x)[q];
        const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {  // a bfloat16 is the high half of its float32
            f[8 * q + 2 * k] = __uint_as_float(w[k] << 16);
            f[8 * q + 2 * k + 1] = __uint_as_float(w[k] & 0xFFFF0000u);
        }
    }
}

// The vector body covers elements [head, head + 16 nvec); the scalar path
// the head [0, head) and the tail [head + 16 nvec, n).
template <typename T>
__global__ void __launch_bounds__(256)
quantize_kernel(const T* __restrict__ x, int8_t* __restrict__ out, float inv, int64_t head,
                int64_t nvec, int64_t n) {
    const int64_t first = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    for (int64_t v = first; v < nvec; v += stride) {
        const int64_t i = head + 16 * v;
        float f[16];
        load16(x + i, f);
        uint32_t w[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
            w[q] = (uint32_t)(uint8_t)code(f[4 * q], inv) |
                   ((uint32_t)(uint8_t)code(f[4 * q + 1], inv) << 8) |
                   ((uint32_t)(uint8_t)code(f[4 * q + 2], inv) << 16) |
                   ((uint32_t)(uint8_t)code(f[4 * q + 3], inv) << 24);
        *reinterpret_cast<uint4*>(out + i) = make_uint4(w[0], w[1], w[2], w[3]);
    }
    const int64_t tail = head + 16 * nvec;
    for (int64_t k = first; k < head + (n - tail); k += stride) {
        const int64_t i = k < head ? k : tail + (k - head);
        out[i] = code(to_float(x[i]), inv);
    }
}

int device_sms() {
    int dev = 0, sms = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
        return 0;
    return sms;
}

struct Plan {
    Geometry g;
    int bn, mw, grid;  // the N tile, m64 rows a consumer warpgroup, blocks
    size_t smem;
};

// The tiling of one call, or cudaErrorInvalidValue for a shape the kernel
// does not take.
int make_plan(int B, int H, int W, int Cin, int Cout, int kh, int kw, int pt, int pb, int pl,
              int pr, Plan& p) {
    const int Ho = H + pt + pb - kh + 1, Wo = W + pl + pr - kw + 1;
    if (B < 1 || H < 1 || W < 1 || Cin < 1 || Cout < 1 || kh < 1 || kw < 1 || pt < 0 ||
        pb < 0 || pl < 0 || pr < 0 || Ho < 1 || Wo < 1 || Cin % 16)
        return (int)cudaErrorInvalidValue;
    const int sms = device_sms();
    if (sms < 1) return (int)cudaErrorInvalidValue;
    Geometry& g = p.g;
    g = Geometry{};
    g.Ho = Ho, g.Wo = Wo, g.Cin = Cin, g.Cout = Cout, g.kw = kw, g.pt = pt, g.pl = pl;
    // Tiles of 128 MW pixels by BN channels: the SMs take ceil(tiles / SMs)
    // rounds of them, and a tile's k-blocks move (128 MW + BN) S bytes each
    // from L2. The plan with the fewest rounds x bytes; of equals, the
    // fewest tiles (the box that wastes least of the ragged edge), then the
    // first. 256-pixel tiles only with BN = 64: at BN = 128 their 128
    // accumulators a thread spill, and their 64-byte k-blocks ran 10-20%
    // slower on the H100 (tools/conv_i8_ab.py).
    int64_t best = -1, fewest = 0;
    for (const int mw : {1, 2})
        for (const int bn : {128, 64}) {
            if ((bn == 128 && Cout <= 64) || (mw == 2 && bn == 128)) continue;
            for (const int tw : {16, 8}) {
                const int th = 128 * mw / tw;
                const int64_t mx = (Wo + tw - 1) / tw, my = (Ho + th - 1) / th;
                const int64_t tiles = B * mx * my * ((Cout + bn - 1) / bn);
                const int64_t cost = (tiles + sms - 1) / sms * (128 * mw + bn);
                if (best >= 0 && (cost > best || (cost == best && tiles >= fewest))) continue;
                best = cost, fewest = tiles;
                p.bn = bn, p.mw = mw, g.TW = tw, g.TH = th;
                g.mx = (int)mx, g.my = (int)my;
            }
        }
    const int64_t m_tiles = (int64_t)B * g.mx * g.my;
    const int64_t tiles = m_tiles * ((Cout + p.bn - 1) / p.bn);
    if (tiles > INT32_MAX) return (int)cudaErrorInvalidValue;
    g.m_tiles = (int)m_tiles;
    g.tiles = (int)tiles;
    // k-blocks of the widest S that divides Cin and still leaves a ring of
    // 4 stages (32 where none does, or where Cin is not a multiple of 32)
    const int bm = 128 * p.mw;
    const size_t fixed = 1024 + kStaging + 2 * kMaxStages * 8;
    for (const int S : {128, 64, 32}) {
        g.S = S;
        if (Cin % S == 0 && (kSmemBlock - fixed) / ((size_t)(bm + p.bn) * S) >= 4) break;
    }
    g.nch = (Cin + g.S - 1) / g.S;
    g.nkb = kh * kw * g.nch;
    g.a_bytes = bm * g.S;
    g.stage_bytes = (bm + p.bn) * g.S;
    g.stages = (int)std::min<size_t>(kMaxStages, (kSmemBlock - fixed) / g.stage_bytes);
    if (g.stages < 2) return (int)cudaErrorInvalidValue;
    p.smem = fixed + (size_t)g.stages * g.stage_bytes;
    p.grid = (int)std::min<int64_t>(tiles, sms);
    return 0;
}

template <int BN, int MW>
int launch(const Plan& p, const CUtensorMap& xm, const CUtensorMap& wm, const float* scale,
           const float* shift, void* out, cudaStream_t stream) {
    const cudaError_t err = cudaFuncSetAttribute(
        conv_i8_kernel<BN, MW>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
    if (err != cudaSuccess) return (int)err;
    conv_i8_kernel<BN, MW><<<p.grid, kThreads, p.smem, stream>>>(xm, wm, scale, shift, out, p.g);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The tiling conv_i8_fwd would launch: plan[0..8] = S, BN, BM, TW, TH,
// tiles, grid, stages, dynamic shared memory bytes. Returns 0, or
// cudaErrorInvalidValue for a shape the kernel does not take.
int conv_i8_plan(int B, int H, int W, int Cin, int Cout, int kh, int kw, int pt, int pb, int pl,
                 int pr, int* plan) {
    Plan p;
    const int err = make_plan(B, H, W, Cin, Cout, kh, kw, pt, pb, pl, pr, p);
    if (err) return err;
    const int v[9] = {p.g.S,     p.bn,   128 * p.mw, p.g.TW,     p.g.TH,
                      p.g.tiles, p.grid, p.g.stages, (int)p.smem};
    for (int i = 0; i < 9; ++i) plan[i] = v[i];
    return 0;
}

// The padding is (top, bottom, left, right). With scale null, out receives
// the int32 accumulators (the same layout, 4 bytes each). Returns the
// cudaError_t of the launch (0 on success); cudaErrorInvalidValue for a
// shape it does not take (an empty output, Cin not a multiple of 16, x or
// w not 16-byte aligned, a tensor map the driver refuses).
int conv_i8_fwd(const void* x, const void* w, const float* scale, const float* shift,
                float* out, int B, int H, int W, int Cin, int Cout, int kh, int kw, int pt,
                int pb, int pl, int pr, void* stream) {
    Plan p;
    const int err = make_plan(B, H, W, Cin, Cout, kh, kw, pt, pb, pl, pr, p);
    if (err) return err;
    if (reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(w) % 16)
        return (int)cudaErrorInvalidValue;
    Geometry& g = p.g;
    g.vec = Cout % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
    CUtensorMap xm, wm;
    const uint64_t xdims[4] = {(uint64_t)Cin, (uint64_t)W, (uint64_t)H, (uint64_t)B};
    const uint64_t xstrides[3] = {(uint64_t)Cin, (uint64_t)W * Cin, (uint64_t)H * W * Cin};
    const uint32_t xbox[4] = {(uint32_t)g.S, (uint32_t)g.TW, (uint32_t)g.TH, 1};
    const uint64_t K = (uint64_t)kh * kw * Cin;
    const uint64_t wdims[2] = {K, (uint64_t)Cout};
    const uint64_t wstrides[1] = {K};
    const uint32_t wbox[2] = {(uint32_t)g.S, (uint32_t)p.bn};
    if (!wg::encode_i8(&xm, x, 4, xdims, xstrides, xbox, g.S) ||
        !wg::encode_i8(&wm, w, 2, wdims, wstrides, wbox, g.S))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (p.mw == 2) return launch<64, 2>(p, xm, wm, scale, shift, out, s);
    return p.bn == 64 ? launch<64, 1>(p, xm, wm, scale, shift, out, s)
                      : launch<128, 1>(p, xm, wm, scale, shift, out, s);
}

// dtype: 0 = float32, 1 = bfloat16 input; inv = 1 / scale in float32.
int quantize_i8(const void* x, void* out, int dtype, float inv, int64_t n, void* stream) {
    if (n < 1 || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
    const int es = dtype == 0 ? 4 : 2;
    // the head up to the output's first 16-byte boundary; a vector body only
    // where the input is 16-byte aligned there too
    int64_t head = (16 - (int64_t)(reinterpret_cast<uintptr_t>(out) % 16)) % 16;
    if (head > n) head = n;
    int64_t nvec = (n - head) / 16;
    if ((reinterpret_cast<uintptr_t>(x) + head * es) % 16) head = 0, nvec = 0;
    const int sms = device_sms();
    int per_sm = 0;
    const cudaError_t oe =
        dtype == 0
            ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, quantize_kernel<float>, 256, 0)
            : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                  &per_sm, quantize_kernel<__nv_bfloat16>, 256, 0);
    if (sms < 1 || oe != cudaSuccess) return (int)cudaErrorInvalidValue;
    // blocks an SM: as many as the work needs, at most as many as fit
    const int64_t work = std::max<int64_t>(nvec, n - 16 * nvec);
    const int64_t each = std::min<int64_t>(std::max(per_sm, 1),
                                           (work + 256 * (int64_t)sms - 1) / (256 * (int64_t)sms));
    const dim3 grid((unsigned)(sms * each));
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    int8_t* o = static_cast<int8_t*>(out);
    if (dtype == 0)
        quantize_kernel<float><<<grid, 256, 0, s>>>(static_cast<const float*>(x), o, inv, head,
                                                    nvec, n);
    else
        quantize_kernel<__nv_bfloat16><<<grid, 256, 0, s>>>(
            static_cast<const __nv_bfloat16*>(x), o, inv, head, nvec, n);
    return (int)cudaGetLastError();
}

}  // extern "C"
