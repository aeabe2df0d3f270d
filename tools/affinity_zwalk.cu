// K5f (affinity3d_fwd) and the self-affinity backward (affinity_bwd) in the
// staged z-walk design, for Hopper (sm_90a). The same functions and C
// interface as pixel_embedded_affinity_torch/csrc/affinity3d.cu and
// csrc/affinity_grad.cu (their notes define both); tools/affinity_zwalk.py
// builds this file beside them and holds and times the two designs against
// each other on the card.
//
// The design, for both kernels:
//  1. Each voxel is normalised once a block, by the thread that stages it:
//     n = v * (one reciprocal of max(sqrt(|v|^2 + 1e-36), 1e-12)). A
//     neighbour read from outside the staged region takes its norm from the
//     values it loads (one reciprocal, no divisions).
//  2. A block owns a 32 x 8 (x, y) tile and stages the unit vectors of the
//     current slice with a halo of 9 along y and x in shared memory
//     (plane-wise, [c][row][col]): the forward's halo lies behind (its
//     shifts look back), the backward's on both sides. Neighbours at
//     |dy|, |dx| <= 9 in the slice are read from there.
//  3. The block walks z over a chunk of slices and keeps a ring of the
//     tile's last four slices in shared memory. The forward is one thread a
//     voxel, each thread's ring private to it. The backward needs z-4 ..
//     z+4 and the cotangent at both ends of every pair: it splits a voxel's
//     C channels over C/4 lanes (4 channels a lane, 1024 threads a block at
//     C = 16), keeps the past four slices in registers, stages the next
//     four ahead (one a step) and the step's cotangents in shared memory.
//  4. The first far neighbours (the 27s; any shift or offset outside the
//     halo and the ring) are read through the cache into registers before
//     the step's barrier, so that their latency overlaps it; further ones
//     in the step's loop.
// Which source each shift or offset reads is decided on the host, once a
// launch. The z chunks are sized so the card's resident blocks take the
// fewest waves of chunk length plus warm-up (chunks() below); a chunk
// re-reads the ring of its first slice.

#include <climits>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "affinity_load.cuh"

namespace {

using namespace affinity_load;

constexpr int kTX = 32, kTY = 8, kPix = kTX * kTY;
constexpr int kNear = 9;  // staged halo along y and x
constexpr int kRing = 4;  // z offsets read from the ring
constexpr int kMaxK = 64;
constexpr int kFarPre = 4;  // far terms read ahead of the barrier (forward: 2)

// what a shift or offset reads: a ring slot (past z-1-j, ahead z+1+j), the
// staged slice, a far vector read ahead (kPre), or the cache in the loop
enum : int { kPast = 0, kAhead = 4, kTile = 8, kFar = 9, kPre = 10 };

__device__ __forceinline__ float inv_norm(float ss) {
    return 1.f / fmaxf(sqrtf(ss + 1e-36f), 1e-12f);
}

template <int C>
__device__ __forceinline__ float dot_strided(const float* u, const float* v, int stride) {
    float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int c = 0; c < C; ++c) s[c % 4] += u[c] * v[c * stride];
    return (s[0] + s[1]) + (s[2] + s[3]);
}

// n = the unit vector at p (raw: the values as they are), or 0 when !ok;
// returns sqrt(|v|^2 + 1e-36)
template <typename T, int C, bool kContig>
__device__ __forceinline__ float load_unit(const T* p, int64_t sC, bool ok, bool raw, float* n) {
    if (!ok) {
#pragma unroll
        for (int c = 0; c < C; ++c) n[c] = 0.f;
        return 0.f;
    }
    load_values<T, C, kContig>(p, sC, n);
    const float norm = sqrtf(dot_strided<C>(n, n, 1) + 1e-36f);
    if (!raw) {
        const float r = 1.f / fmaxf(norm, 1e-12f);
#pragma unroll
        for (int c = 0; c < C; ++c) n[c] *= r;
    }
    return norm;
}

// smallest stride >= n whose 4 channel planes of a lane group fall on
// distinct banks: 4 * stride = 32 / groups (mod 32)
__host__ __device__ constexpr int plane_stride(int n, int groups) {
    int s = n;
    while ((4 * s) % 32 != (32 / groups) % 32) ++s;
    return s;
}

// z chunks for `tiles` (y, x) tiles of D slices on `resident` blocks at a
// time: the fewest waves of chunk length plus its warm-up
int chunks(int tiles, int D, int resident, int warm) {
    int best = 1;
    long best_cost = LONG_MAX;
    for (int n = 1; n <= D; ++n) {
        const int len = (D + n - 1) / n;
        if ((n - 1) * len >= D) continue;
        const long waves = ((long)tiles * n + resident - 1) / resident;
        const long cost = waves * (len + warm);
        if (cost < best_cost) {
            best_cost = cost;
            best = n;
        }
    }
    return best;
}

// blocks of `kernel` the card holds at once
template <class F>
int resident(F kernel, int threads, size_t smem) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
    return (sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
}

struct Tile {
    int b, y0, x0, z0, z1;
};

__device__ __forceinline__ Tile tile_of(int H, int D, int tilesX, int tiles, int zLen) {
    const int tile = blockIdx.x % tiles, zc = blockIdx.x / tiles;
    const int tilesY = (H + kTY - 1) / kTY;
    const int b = tile / (tilesX * tilesY), r = tile - b * tilesX * tilesY;
    const int z0 = zc * zLen;
    return {b, r / tilesX * kTY, r % tilesX * kTX, z0, z0 + zLen < D ? z0 + zLen : D};
}

// ---- K5f

constexpr int kRowsF = kTY + kNear, kColsF = kTX + kNear, kTileF = kRowsF * kColsF;
constexpr int kFarPreF = 2;

struct FwdTable {
    int src[kMaxK];       // kPast + s - 1 (z shift s in 1..4), kTile, kPre, kFar
    int off[kMaxK];       // kTile: offset in the staged slice; kPre, kFar: the shift
    int nfar;             // far channels read ahead, <= kFarPreF
    int far_k[kFarPreF];  // their channels
};

template <typename T, int C, bool kContig>
__global__ void __launch_bounds__(kPix, 2)
fwd_kernel(const T* __restrict__ e, T* __restrict__ out, int D, int H, int W, int K,
           int64_t sB, int64_t sD, int64_t sH, int64_t sW, int64_t sC, FwdTable tab,
           int tilesX, int tiles, int zLen) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    float* tileS = reinterpret_cast<float*>(smem_raw);  // n[C][kTileF] of slice z
    float* ring = tileS + C * kTileF;                     // [4][C][kPix]: slice zz at zz & 3
    const int tx = threadIdx.x, ty = threadIdx.y, t = ty * kTX + tx;
    const Tile tl = tile_of(H, D, tilesX, tiles, zLen);
    const int y = tl.y0 + ty, x = tl.x0 + tx;
    const bool mine = y < H && x < W;
    const T* eb = e + tl.b * sB;
    const int64_t vol = (int64_t)D * H * W;
    T* ob = out + (int64_t)tl.b * K * vol + (int64_t)y * W + x;

    // the ring: n(z0-4 .. z0-1) of the thread's voxel, 0 outside
#pragma unroll 1
    for (int zz = tl.z0 - kRing; zz < tl.z0; ++zz) {
        float v[C];
        load_unit<T, C, kContig>(eb + zz * sD + y * sH + x * sW, sC, mine && zz >= 0, false, v);
#pragma unroll
        for (int c = 0; c < C; ++c) ring[((zz & 3) * C + c) * kPix + t] = v[c];
    }

    const int ic = (ty + kNear) * kColsF + tx + kNear;
    for (int z = tl.z0; z < tl.z1; ++z) {
#pragma unroll
        for (int u = 0; u < (kTileF + kPix - 1) / kPix; ++u) {
            const int i = t + u * kPix;
            if (i < kTileF) {
                const int row = i / kColsF, cl = i - row * kColsF;
                const int yy = tl.y0 - kNear + row, xx = tl.x0 - kNear + cl;
                float v[C];
                load_unit<T, C, kContig>(eb + z * sD + yy * sH + xx * sW, sC,
                                         yy >= 0 && yy < H && xx >= 0 && xx < W, false, v);
#pragma unroll
                for (int c = 0; c < C; ++c) tileS[c * kTileF + i] = v[c];
            }
        }
        // the far neighbours read ahead, raw, 0 outside
        float fv[kFarPreF][C];
#pragma unroll
        for (int f = 0; f < kFarPreF; ++f) {
            const int k = tab.far_k[f], s = tab.off[k], axis = k % 3;
            const int zz = z - (axis == 0 ? s : 0), yy = y - (axis == 1 ? s : 0),
                      xx = x - (axis == 2 ? s : 0);
            const bool in = f < tab.nfar && mine && zz >= 0 && zz < D && yy >= 0 && yy < H &&
                            xx >= 0 && xx < W;
            if (in) {
                load_values<T, C, kContig>(eb + zz * sD + yy * sH + xx * sW, sC, fv[f]);
            } else {
#pragma unroll
                for (int c = 0; c < C; ++c) fv[f][c] = 0.f;
            }
        }
        __syncthreads();
        if (mine) {
            float n0[C];
#pragma unroll
            for (int c = 0; c < C; ++c) n0[c] = tileS[c * kTileF + ic];
            T* o = ob + (int64_t)z * H * W;
#pragma unroll
            for (int f = 0; f < kFarPreF; ++f)
                if (f < tab.nfar)
                    o[tab.far_k[f] * vol] = from_float<T>(
                        dot_strided<C>(n0, fv[f], 1) * inv_norm(dot_strided<C>(fv[f], fv[f], 1)));
            for (int k = 0; k < K; ++k) {
                const int src = tab.src[k];
                if (src == kPre) continue;
                float a = 0.f;
                if (src == kTile) {
                    a = dot_strided<C>(n0, tileS + ic + tab.off[k], kTileF);
                } else if (src < kTile) {
                    a = dot_strided<C>(n0, ring + ((z - 1 - (src - kPast)) & 3) * C * kPix + t,
                                       kPix);
                } else {
                    const int s = tab.off[k], axis = k % 3;
                    const int zz = z - (axis == 0 ? s : 0), yy = y - (axis == 1 ? s : 0),
                              xx = x - (axis == 2 ? s : 0);
                    if (zz >= 0 && zz < D && yy >= 0 && yy < H && xx >= 0 && xx < W) {
                        float v[C];
                        load_values<T, C, kContig>(eb + zz * sD + yy * sH + xx * sW, sC, v);
                        a = dot_strided<C>(n0, v, 1) * inv_norm(dot_strided<C>(v, v, 1));
                    }
                }
                o[k * vol] = from_float<T>(a);
            }
            // n(z) into the ring, over n(z-4), which this step has read
#pragma unroll
            for (int c = 0; c < C; ++c) ring[((z & 3) * C + c) * kPix + t] = n0[c];
        }
        __syncthreads();
    }
}

template <typename T>
struct FwdArgs {
    const T* e;
    T* out;
    int D, H, W, K;
    const int64_t* s;
    FwdTable tab;
    int tilesX, tiles;
};

template <typename T, int C, bool kContig>
cudaError_t run_fwd(const FwdArgs<T>& a, cudaStream_t stream) {
    auto kernel = fwd_kernel<T, C, kContig>;
    const size_t smem = (size_t)(C * kTileF + kRing * C * kPix) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
    const int n = chunks(a.tiles, a.D, resident(kernel, kPix, smem), 1);
    const int zLen = (a.D + n - 1) / n, nz = (a.D + zLen - 1) / zLen;
    fwd_kernel<T, C, kContig><<<dim3(a.tiles * nz), dim3(kTX, kTY), smem, stream>>>(
        a.e, a.out, a.D, a.H, a.W, a.K, a.s[0], a.s[1], a.s[2], a.s[3], a.s[4], a.tab, a.tilesX,
        a.tiles, zLen);
    return cudaGetLastError();
}

FwdTable fwd_table(const int32_t* shifts, int K) {
    FwdTable tab;
    tab.nfar = 0;
    for (int f = 0; f < kFarPreF; ++f) tab.far_k[f] = 0;
    for (int k = 0; k < K; ++k) {
        const int sh = shifts[k], axis = k % 3;
        tab.off[k] = sh;
        if (axis == 0 && sh >= 1 && sh <= kRing) {
            tab.src[k] = kPast + sh - 1;
        } else if (axis == 0 && sh == 0) {
            tab.src[k] = kTile;
            tab.off[k] = 0;
        } else if (axis != 0 && sh >= 0 && sh <= kNear) {
            tab.src[k] = kTile;
            tab.off[k] = -(axis == 1 ? sh * kColsF : sh);
        } else if (tab.nfar < kFarPreF) {
            tab.src[k] = kPre;
            tab.far_k[tab.nfar++] = k;
        } else {
            tab.src[k] = kFar;
        }
    }
    return tab;
}

template <typename T>
cudaError_t launch_fwd(const void* e, void* out, int B, int D, int H, int W, int C,
                       const int64_t* s, const int32_t* shifts, int K, cudaStream_t stream) {
    const int tilesX = (W + kTX - 1) / kTX;
    const FwdArgs<T> a{static_cast<const T*>(e), static_cast<T*>(out), D, H, W, K, s,
                       fwd_table(shifts, K), tilesX, B * tilesX * ((H + kTY - 1) / kTY)};
    const bool contig = contiguous_vectors<T>(e, s);
    if (C == 8) return contig ? run_fwd<T, 8, true>(a, stream) : run_fwd<T, 8, false>(a, stream);
    if (C == 16) return contig ? run_fwd<T, 16, true>(a, stream) : run_fwd<T, 16, false>(a, stream);
    return cudaErrorInvalidValue;
}

// ---- the self-affinity backward

constexpr int kRowsB = kTY + 2 * kNear, kColsB = kTX + 2 * kNear, kTileB = kRowsB * kColsB;
constexpr int kSlots = kRing + 1;  // ahead ring: slices z .. z+4

struct BwdTable {
    int z[kMaxK], y[kMaxK], x[kMaxK];  // the offsets o_k
    int src[kMaxK][2];  // per term (+o_k, -o_k): kPast + j, kAhead + j, kTile, kPre, kFar
    int off[kMaxK][2];  // kTile: offset in the staged slice
    int ks;             // channels whose cotangents are staged
    int nfar;           // far terms read ahead, <= kFarPre
    int far_k[kFarPre], far_side[kFarPre];
};

// element strides of a (B, D, H, W, C) view
template <typename T>
struct View {
    const T* p;
    int64_t sB, sD, sH, sW, sC;
    __device__ __forceinline__ const T* at(int b, int z, int y, int x) const {
        return p + b * sB + z * sD + y * sH + x * sW;
    }
};

// the lane's 4 values of channels c0..c0+3 at p in float32
template <typename T, bool kContig>
__device__ __forceinline__ void load4(const T* p, int64_t sC, int c0, float* v) {
    if constexpr (kContig && sizeof(T) == 4) {
        const float4 f = *reinterpret_cast<const float4*>(p + c0);
        v[0] = f.x;
        v[1] = f.y;
        v[2] = f.z;
        v[3] = f.w;
    } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j] = to_float(p[(c0 + j) * sC]);
    }
}

// the sum over the voxel's kG lanes (adjacent lanes of the warp)
template <int kG>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
    for (int m = 1; m < kG; m *= 2) v += __shfl_xor_sync(0xffffffffu, v, m);
    return v;
}

__device__ __forceinline__ float sum_sq4(const float* v) {
    return (v[0] * v[0] + v[1] * v[1]) + (v[2] * v[2] + v[3] * v[3]);
}

template <int C>
constexpr size_t bwd_smem_floats(int ks) {
    return (size_t)C * plane_stride(kTileB, C / 4) +
           (size_t)kSlots * C * plane_stride(kPix, C / 4) + (size_t)kSlots * kPix +
           (size_t)ks * 2 * kPix;
}

template <typename T, int C, bool kContig>
__global__ void __launch_bounds__(kPix * C / 4, 1)
bwd_kernel(View<T> e, const T* __restrict__ g, T* __restrict__ de, int D, int H, int W, int K,
           BwdTable tab, bool raw, int tilesX, int tiles, int zLen) {
    constexpr int kG = C / 4, kVW = 32 / kG, kThreads = kPix * kG;  // lanes a voxel, voxels a warp
    constexpr int kS = plane_stride(kTileB, kG), kSA = plane_stride(kPix, kG);
    extern __shared__ __align__(16) unsigned char smem_raw[];
    float* tileS = reinterpret_cast<float*>(smem_raw);  // n[C][kS] of slice z with its halo
    float* ahead = tileS + C * kS;            // kSlots x n[C][kSA]: slices z .. z+4 at zz % 5
    float* norms = ahead + kSlots * C * kSA;  // kSlots x [kPix]: their sqrt(|e|^2 + 1e-36)
    float* gS = norms + kSlots * kPix;        // [ks][2][kPix]: g_k(p), g_k(p - o_k)

    const int t = threadIdx.x, lane = t & 31, w = t >> 5;
    const int grp = lane % kG, c0 = 4 * grp;
    const int pix = w * kVW + lane / kG;  // the lane's voxel in the tile, row-major
    const int ty = pix / kTX, tx = pix % kTX;
    const Tile tl = tile_of(H, D, tilesX, tiles, zLen);
    const int y = tl.y0 + ty, x = tl.x0 + tx;
    const bool mine = y < H && x < W;
    const int64_t vol = (int64_t)D * H * W, plane = (int64_t)H * W;
    const T* gb = g + (int64_t)tl.b * K * vol;
    auto inside = [&](int zz, int yy, int xx) {
        return zz >= 0 && zz < D && yy >= 0 && yy < H && xx >= 0 && xx < W;
    };

    // stage the unit vectors of slice zz's (y, x) tile into ahead slot zz % 5
    auto stage_ahead = [&](int zz, int i) {
        const int yy = tl.y0 + i / kTX, xx = tl.x0 + i % kTX;
        float v[C];
        const float nm = load_unit<T, C, kContig>(e.at(tl.b, zz, yy, xx), e.sC,
                                                  zz >= 0 && zz < D && yy < H && xx < W, raw, v);
        float* a = ahead + (zz + kSlots) % kSlots * C * kSA;
#pragma unroll
        for (int c = 0; c < C; ++c) a[c * kSA + i] = v[c];
        norms[(zz + kSlots) % kSlots * kPix + i] = nm;
    };
    auto pull = [&](int zz, float* v) {
        const float* a = ahead + (zz + kSlots) % kSlots * C * kSA + pix;
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j] = a[(c0 + j) * kSA];
    };
    // g_k at the pair's first voxel: p (side 0) or p - o_k (side 1)
    auto cotangent = [&](int k, int side, int z) {
        if (k < tab.ks) return gS[(2 * k + side) * kPix + pix];
        const int sg = side ? -1 : 0;
        return to_float(gb[k * vol + (z + sg * tab.z[k]) * plane +
                           (int64_t)(y + sg * tab.y[k]) * W + x + sg * tab.x[k]]);
    };

    // warm-up: n(z0-4 .. z0-1) into the registers, n(z0 .. z0+3) into the ring
    float p1[4], p2[4], p3[4], p4[4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        if (t < kPix) stage_ahead(tl.z0 - 4 + j, t);
        __syncthreads();
        if (j < 4) pull(tl.z0 - 4 + j, j == 0 ? p4 : j == 1 ? p3 : j == 2 ? p2 : p1);
        __syncthreads();
    }

    const int ic = (ty + kNear) * kColsB + tx + kNear;
    for (int z = tl.z0; z < tl.z1; ++z) {
        // the lane's own vector and norm, from the ring, before slot z is reused
        float n0[4];
        pull(z, n0);
        const float norm = norms[z % kSlots * kPix + pix];
        __syncthreads();
        // stage: slice z + 4 into the ring, slice z's halo (its centre is n0)
        for (int i = t; i < kPix + kTileB; i += kThreads) {
            if (i < kPix) {
                stage_ahead(z + kRing, i);
                continue;
            }
            const int j = i - kPix, row = j / kColsB, cl = j - row * kColsB;
            if (row >= kNear && row < kNear + kTY && cl >= kNear && cl < kNear + kTX) continue;
            const int yy = tl.y0 - kNear + row, xx = tl.x0 - kNear + cl;
            float v[C];
            load_unit<T, C, kContig>(e.at(tl.b, z, yy, xx), e.sC,
                                     yy >= 0 && yy < H && xx >= 0 && xx < W, raw, v);
#pragma unroll
            for (int c = 0; c < C; ++c) tileS[c * kS + j] = v[c];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) tileS[(c0 + j) * kS + ic] = n0[j];
        // the cotangents of the step's pairs, 0 outside
        for (int i = t; i < tab.ks * 2 * kPix; i += kThreads) {
            const int k = i / (2 * kPix), side = i / kPix & 1, q = i % kPix;
            const int sg = side ? -1 : 0;
            const int zz = z + sg * tab.z[k], yy = tl.y0 + q / kTX + sg * tab.y[k],
                      xx = tl.x0 + q % kTX + sg * tab.x[k];
            gS[i] = inside(zz, yy, xx)
                        ? to_float(gb[k * vol + zz * plane + (int64_t)yy * W + xx]) : 0.f;
        }
        // the far neighbours read ahead: the lane's 4 values, 0 outside
        float u[kFarPre][4];
#pragma unroll
        for (int f = 0; f < kFarPre; ++f) {
            const int k = tab.far_k[f], sg = tab.far_side[f] ? -1 : 1;
            const int zz = z + sg * tab.z[k], yy = y + sg * tab.y[k], xx = x + sg * tab.x[k];
            if (f < tab.nfar && mine && inside(zz, yy, xx)) {
                load4<T, kContig>(e.at(tl.b, zz, yy, xx), e.sC, c0, u[f]);
            } else {
#pragma unroll
                for (int j = 0; j < 4; ++j) u[f][j] = 0.f;
            }
        }
        __syncthreads();

        float dn[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int f = 0; f < kFarPre; ++f) {
            if (f >= tab.nfar) break;
            const int k = tab.far_k[f], side = tab.far_side[f], sg = side ? -1 : 1;
            const bool in = mine && inside(z + sg * tab.z[k], y + sg * tab.y[k], x + sg * tab.x[k]);
            const float rr = raw ? 1.f : inv_norm(group_sum<kG>(sum_sq4(u[f])));
            const float gv = in ? rr * cotangent(k, side, z) : 0.f;
#pragma unroll
            for (int j = 0; j < 4; ++j) dn[j] += gv * u[f][j];
        }
        for (int k = 0; k < K; ++k) {
#pragma unroll
            for (int side = 0; side < 2; ++side) {
                const int src = tab.src[k][side];
                if (src == kPre) continue;
                const int sg = side ? -1 : 1;
                const int zz = z + sg * tab.z[k], yy = y + sg * tab.y[k], xx = x + sg * tab.x[k];
                const bool in = mine && inside(zz, yy, xx);
                float v[4];
                if (src == kTile) {
                    const float* s = tileS + ic + tab.off[k][side];
#pragma unroll
                    for (int j = 0; j < 4; ++j) v[j] = s[(c0 + j) * kS];
                } else if (src < kAhead) {
#pragma unroll
                    for (int j = 0; j < 4; ++j)
                        v[j] = src == kPast ? p1[j] : src == kPast + 1 ? p2[j]
                             : src == kPast + 2 ? p3[j] : p4[j];
                } else if (src < kTile) {
                    pull(z + src - kAhead + 1, v);
                } else {  // the cache, normalised by the norm of its C values
                    float w4[4] = {0.f, 0.f, 0.f, 0.f};
                    if (in) load4<T, kContig>(e.at(tl.b, zz, yy, xx), e.sC, c0, w4);
                    const float rr = raw ? 1.f : inv_norm(group_sum<kG>(sum_sq4(w4)));
#pragma unroll
                    for (int j = 0; j < 4; ++j) v[j] = w4[j] * rr;
                }
                const float gv = in ? cotangent(k, side, z) : 0.f;
#pragma unroll
                for (int j = 0; j < 4; ++j) dn[j] += gv * v[j];
            }
        }
        // the normalisation's VJP, (dn - n <n, dn> [|e| >= eps]) / max(|e|, eps)
        const float dot = group_sum<kG>((n0[0] * dn[0] + n0[1] * dn[1]) +
                                        (n0[2] * dn[2] + n0[3] * dn[3]));
        const float proj = (!raw && norm >= 1e-12f) ? dot : 0.f;
        const float inv = raw ? 1.f : 1.f / fmaxf(norm, 1e-12f);
        if (mine) {
            T* o = de + ((int64_t)tl.b * C + c0) * vol + z * plane + (int64_t)y * W + x;
#pragma unroll
            for (int j = 0; j < 4; ++j) o[j * vol] = from_float<T>((dn[j] - n0[j] * proj) * inv);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            p4[j] = p3[j];
            p3[j] = p2[j];
            p2[j] = p1[j];
            p1[j] = n0[j];
        }
    }
}

BwdTable bwd_table(const int32_t* offsets, int K, int ks) {
    BwdTable tab;
    tab.ks = ks;
    tab.nfar = 0;
    for (int f = 0; f < kFarPre; ++f) tab.far_k[f] = tab.far_side[f] = 0;
    for (int k = 0; k < K; ++k) {
        tab.z[k] = offsets[3 * k];
        tab.y[k] = offsets[3 * k + 1];
        tab.x[k] = offsets[3 * k + 2];
        for (int side = 0; side < 2; ++side) {
            const int sg = side ? -1 : 1;
            const int dz = sg * tab.z[k], dy = sg * tab.y[k], dx = sg * tab.x[k];
            tab.off[k][side] = 0;
            if (dy == 0 && dx == 0 && dz >= -kRing && dz <= -1) {
                tab.src[k][side] = kPast - dz - 1;
            } else if (dy == 0 && dx == 0 && dz >= 1 && dz <= kRing) {
                tab.src[k][side] = kAhead + dz - 1;
            } else if (dz == 0 && dy >= -kNear && dy <= kNear && dx >= -kNear && dx <= kNear) {
                tab.src[k][side] = kTile;
                tab.off[k][side] = dy * kColsB + dx;
            } else if (tab.nfar < kFarPre) {
                tab.src[k][side] = kPre;
                tab.far_k[tab.nfar] = k;
                tab.far_side[tab.nfar++] = side;
            } else {
                tab.src[k][side] = kFar;
            }
        }
    }
    return tab;
}

template <typename T, int C>
cudaError_t launch_bwd(const void* e, const int64_t* se, const void* g, void* de, int B, int D,
                       int H, int W, const int32_t* offsets, int K, bool raw, cudaStream_t stream) {
    constexpr int kThreads = kPix * C / 4;
    constexpr size_t kMaxSmem = 232448;  // a Hopper block's shared memory
    // stage as many channels' cotangents as shared memory holds
    int ks = K;
    while (ks > 0 && bwd_smem_floats<C>(ks) * sizeof(float) > kMaxSmem) --ks;
    const size_t smem = bwd_smem_floats<C>(ks) * sizeof(float);
    const BwdTable tab = bwd_table(offsets, K, ks);
    const int tilesX = (W + kTX - 1) / kTX, tiles = B * tilesX * ((H + kTY - 1) / kTY);
    const View<T> v{static_cast<const T*>(e), se[0], se[1], se[2], se[3], se[4]};
    const bool contig = contiguous_vectors<T>(e, se);
    auto kernel = contig ? bwd_kernel<T, C, true> : bwd_kernel<T, C, false>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
    const int n = chunks(tiles, D, resident(kernel, kThreads, smem), 2);
    const int zLen = (D + n - 1) / n, nz = (D + zLen - 1) / zLen;
    const dim3 grid(tiles * nz), block(kThreads);
    if (contig)
        bwd_kernel<T, C, true><<<grid, block, smem, stream>>>(
            v, static_cast<const T*>(g), static_cast<T*>(de), D, H, W, K, tab, raw, tilesX,
            tiles, zLen);
    else
        bwd_kernel<T, C, false><<<grid, block, smem, stream>>>(
            v, static_cast<const T*>(g), static_cast<T*>(de), D, H, W, K, tab, raw, tilesX,
            tiles, zLen);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// As csrc/affinity3d.cu's affinity3d_fwd.
int affinity3d_fwd(const void* e, void* out, int dtype, int B, int D, int H, int W, int C,
                   int64_t sB, int64_t sD, int64_t sH, int64_t sW, int64_t sC,
                   const int32_t* shifts, int K, void* stream) {
    if (K < 1 || K > kMaxK || B < 1 || D < 1 || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
    const int64_t s[5] = {sB, sD, sH, sW, sC};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 0) return (int)launch_fwd<float>(e, out, B, D, H, W, C, s, shifts, K, st);
    if (dtype == 1) return (int)launch_fwd<__nv_bfloat16>(e, out, B, D, H, W, C, s, shifts, K, st);
    return (int)cudaErrorInvalidValue;
}

// As csrc/affinity_grad.cu's affinity_bwd.
int affinity_bwd(const void* e, const int64_t* se, const void* g, void* de, int dtype, int B,
                 int D, int H, int W, int C, const int32_t* offsets, int K, int raw,
                 void* stream) {
    if (K < 1 || K > kMaxK || B < 1 || D < 1 || H < 1 || W < 1 || (C != 8 && C != 16) ||
        (dtype != 0 && dtype != 1))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 0 && C == 8)
        return (int)launch_bwd<float, 8>(e, se, g, de, B, D, H, W, offsets, K, raw, st);
    if (dtype == 0)
        return (int)launch_bwd<float, 16>(e, se, g, de, B, D, H, W, offsets, K, raw, st);
    if (C == 8)
        return (int)launch_bwd<__nv_bfloat16, 8>(e, se, g, de, B, D, H, W, offsets, K, raw, st);
    return (int)launch_bwd<__nv_bfloat16, 16>(e, se, g, de, B, D, H, W, offsets, K, raw, st);
}

}  // extern "C"
