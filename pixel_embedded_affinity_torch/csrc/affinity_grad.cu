// The affinity kernels of the training path beside K5f: the self-affinity
// backward, and the cross-view affinity forward and backward, for Hopper
// (sm_90a).
//
// Replaces the TPU kernels of pixel_embedded_affinity_tpu/ops/emb2aff_pallas.py:
//   K1b _affinity_bwd_kernel (pl.pallas_call in _fused_affinity_2d_bwd_impl),
//       and with it the rest of the 3D backward _fused_affinity_3d_bwd (the
//       z-slab adds and the normalisation's VJP)                      -> affinity_bwd
//   K6f _cross_affinity_3d_kernel (_fused_cross_affinity_3d_impl)     -> cross_affinity_fwd
//   K4f _cross_affinity_kernel (_fused_cross_affinity_2d_impl), the 2D
//       cross forward                                      -> cross_affinity_fwd at D = 1
//   K4b _cross_bwd_kernel (_fused_cross_bwd_impl), and with it the rest
//       of the 3D backward _fused_cross_3d_bwd (the z terms and both
//       normalisation VJPs)                                           -> cross_affinity_bwd
// Python wrappers: ops/emb2aff3d_cuda.py; ops/emb2aff_cuda.py runs K1's 2D
// backward through affinity_bwd, and K4's 2D forward and backward through
// cross_affinity_fwd and cross_affinity_bwd, at D = 1 with offsets
// (0, dy, dx), neighbor 8's diagonals (dx > 0) included.
//
// What they compute. Embeddings a, b: (B, D, H, W, C) with arbitrary
// element strides, float32 or bfloat16, C in {8, 16}. Channel k has an
// offset o_k = (oz, oy, ox), and with
//     n = e / max(sqrt(|e|^2 + 1e-36), 1e-12)
// the affinity is a_k(p) = <n_a(p), n_b(p + o_k)>, 0 where p + o_k lies
// outside the volume. The 3D shift table is o_k = -s_k e_{k%3}; K1's 2D
// offsets are the D = 1 case with oz = 0.
//   cross_affinity_fwd: out (B, K, D, H, W) = a_k, contiguous.
//   affinity_bwd (a == b = e), given g (B, K, D, H, W) contiguous:
//       dn(p) = sum_k g_k(p) n(p + o_k) [p + o_k inside] + g_k(p - o_k) n(p - o_k) [p - o_k inside]
//   cross_affinity_bwd:
//       dn_a(p) = sum_k g_k(p) n_b(p + o_k),   dn_b(p) = sum_k g_k(p - o_k) n_a(p - o_k)
//   then each gradient is the normalisation's VJP,
//       de = (dn - n <n, dn> [|e| >= eps]) / max(|e|, eps),
// or, with `raw`, the inputs are taken as unit vectors as they are and dn
// is written (the TPU kernels' normalized=True form). The forward wrote 0
// where p + o_k lies outside, so g there contributes nothing: both terms
// skip it. Gradients go to contiguous (B, C, D, H, W) buffers, the layout
// of the model's NCDHW output. Everything is computed in float32.
//
// Bound (train shape B=2, 18x160x160, C=16, K=12, float32, HBM at 3.35
// TB/s; each input read once, each output written once). affinity_bwd
// reads e (59.0 MB) and g (44.2 MB) and writes de (59.0 MB): 162.2 MB,
// 48.4 us. cross_affinity_fwd reads a and b and writes out: 162.2 MB, 48.4
// us. cross_affinity_bwd reads a, b, g and writes da, db: 280.2 MB, 83.6
// us (221.2 MB, 66.0 us without db). K4f at the BBBC train shape (B=2,
// 256x256, C=16, K=10) reads 16.8 MB and writes 5.2 MB: 6.6 us. The
// arithmetic, ~3C to normalise each
// vector once, 2C a dot and 2C a multiply-add per channel and term, and 5C
// per VJP, is < 10 us at the 67 TFLOP/s float32 rate: bytes bound all three.
//
// Design, as K5f (affinity3d.cu): one thread per voxel; 32x8 blocks over (x,
// y), one grid row per (b, z), so a warp's loads from the NCDHW view (channel
// stride D*H*W, x stride 1) and its stores coalesce; bounds checks in place
// of the TPU's zero pad, row-tile halo and front slab. Each thread gathers
// its own gradient (no atomics, the same result every run) in one launch per
// backward, where the TPU splits it into a 2D pass over B*D slices, XLA slab
// adds and a separate VJP. Each neighbour vector is loaded again for every
// channel and term that reaches it (from L1/L2): a staged tile would need a
// halo of 27 on y and x, 132 KB in float32 for a 32x8 block. Every input is
// read in the mode its own strides allow (load_values): 16-byte pieces where
// its vectors are contiguous and aligned (a channels-last embedding), else
// plane-wise (the model's NCDHW output permuted, which the 3D train step
// hands them for the student and, un-flipped in its own strides, the
// teacher); the cross kernels choose a and b apart, as kContigA and kContigB.
// No kernel divides per value: a gathered neighbour's normalisation is one
// reciprocal square root of the sum of squares of the values it loads, which
// scales its dot (cross forward) or its cotangent g (backwards), so a term
// costs C multiply-adds; the voxel's own vector is normalised, and its VJP
// scaled, by one reciprocal each.
//
// On an NVIDIA H100 80GB HBM3 at 700 W (B=2 18x160x160, C=16, float32, L2
// flushed, CUDA graph replay, three runs of tools/cross_affinity_ab.py beside
// the kernels they replaced, which divided C values a neighbour and read
// every input plane-wise): the cross forward takes 0.106-0.127 ms on the
// NCDHW view (0.156-0.165 before) and 0.111-0.124 on a channels-last student
// and teacher (0.368-0.376), the cross backward without db 0.125-0.130
// (0.210-0.221) and 0.118-0.131 (0.375-0.385); the 2D forward K4f at B=2
// 256x256 0.024-0.028 ms (0.032-0.035) with the teacher in the student's
// layout. A teacher whose vectors are plane-wise with an x stride of a row
// (the NCDHW view with H and W swapped, which the un-flip returned before it
// kept its input's strides) costs both forms alike, as every warp load of a
// channel touches 32 sectors: 0.68 ms (0.69-0.70 before) for the 3D forward
// and backward, 0.095-0.102 for K4f. The staged z-walk form of affinity_bwd
// (tools/affinity_zwalk.cu: a voxel's channels over four lanes, the past four
// slices in registers, the next four, the halo and the step's cotangents in
// shared memory) took 0.6135-0.6147 ms against this kernel's 0.1915-0.1959
// (B=2 18x160x160, float32, the NCDHW view, CUDA graph replay, NVIDIA H100
// 80GB HBM3 at 700 W, one run, tools/affinity_zwalk.py): the four lanes
// repeat each term's index and bounds work, and the block waits at three
// barriers a slice.

#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "affinity_load.cuh"

namespace {

using namespace affinity_load;

constexpr int kMaxChannels = 64;
constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

struct Offsets {
    int z[kMaxChannels];
    int y[kMaxChannels];
    int x[kMaxChannels];
};

// element strides of a (B, D, H, W, C) view
template <typename T>
struct Emb {
    const T* p;
    int64_t sB, sD, sH, sW, sC;
    __device__ __forceinline__ const T* at(int b, int z, int y, int x) const {
        return p + b * sB + z * sD + y * sH + x * sW;
    }
};

__device__ __forceinline__ bool inside(int z, int y, int x, int D, int H, int W) {
    return z >= 0 && z < D && y >= 0 && y < H && x >= 0 && x < W;
}

template <typename T, int C, bool kContig>
__global__ void __launch_bounds__(kBlockX * kBlockY)
affinity_bwd_kernel(Emb<T> e, const T* __restrict__ g, T* __restrict__ de,
                    int D, int H, int W, int K, Offsets off, bool raw) {
    const int x = blockIdx.x * kBlockX + threadIdx.x;
    const int y = blockIdx.y * kBlockY + threadIdx.y;
    const int b = blockIdx.z / D;
    const int z = blockIdx.z - b * D;
    if (x >= W || y >= H) return;

    // the voxel's own unit vector, and its norm for the VJP
    float n0[C], dn[C];
    const float norm = load_unit<T, C, kContig>(e.at(b, z, y, x), e.sC, raw, n0);
#pragma unroll
    for (int c = 0; c < C; ++c) dn[c] = 0.f;

    const int64_t vol = (int64_t)D * H * W;
    const T* gb = g + (int64_t)b * K * vol;
    for (int k = 0; k < K; ++k) {
        const T* gk = gb + k * vol;
        // the pair (p, p + o_k): a_k(p) = <n(p), n(p + o_k)>
        int zz = z + off.z[k], yy = y + off.y[k], xx = x + off.x[k];
        if (inside(zz, yy, xx, D, H, W)) {
            float v[C];
            const float r = load_scaled<T, C, kContig>(e.at(b, zz, yy, xx), e.sC, raw, v);
            axpy<C>(to_float(gk[((int64_t)z * H + y) * W + x]) * r, v, dn);
        }
        // the pair (p - o_k, p): a_k(p - o_k) = <n(p - o_k), n(p)>
        zz = z - off.z[k], yy = y - off.y[k], xx = x - off.x[k];
        if (inside(zz, yy, xx, D, H, W)) {
            float v[C];
            const float r = load_scaled<T, C, kContig>(e.at(b, zz, yy, xx), e.sC, raw, v);
            axpy<C>(to_float(gk[((int64_t)zz * H + yy) * W + xx]) * r, v, dn);
        }
    }
    store_grad<T, C>(n0, norm, dn, raw, de + (int64_t)b * C * vol + ((int64_t)z * H + y) * W + x,
                     vol);
}

// kContigA, kContigB: a's, b's vectors contiguous and 16-byte aligned
// (load_values)
template <typename T, int C, bool kContigA, bool kContigB>
__global__ void __launch_bounds__(kBlockX * kBlockY)
cross_affinity_fwd_kernel(Emb<T> a, Emb<T> b, T* __restrict__ out, int D, int H, int W, int K,
                          Offsets off) {
    const int x = blockIdx.x * kBlockX + threadIdx.x;
    const int y = blockIdx.y * kBlockY + threadIdx.y;
    const int bi = blockIdx.z / D;
    const int z = blockIdx.z - bi * D;
    if (x >= W || y >= H) return;

    float na[C];
    load_unit<T, C, kContigA>(a.at(bi, z, y, x), a.sC, false, na);
    const int64_t vol = (int64_t)D * H * W;
    T* o = out + (int64_t)bi * K * vol + ((int64_t)z * H + y) * W + x;
    for (int k = 0; k < K; ++k) {
        const int zz = z + off.z[k], yy = y + off.y[k], xx = x + off.x[k];
        float a_k = 0.f;
        if (inside(zz, yy, xx, D, H, W)) {
            // <n_a(p), v / |v|>: the raw values' dot times one reciprocal
            float v[C];
            const float r = load_scaled<T, C, kContigB>(b.at(bi, zz, yy, xx), b.sC, false, v);
            a_k = dot<C>(na, v) * r;
        }
        o[k * vol] = from_float<T>(a_k);
    }
}

// kDb: also the teacher's gradient db. Each gathered neighbour's
// normalisation folds into its cotangent, g * (1 / |v|), and multiplies
// its raw values v.
template <typename T, int C, bool kDb, bool kContigA, bool kContigB>
__global__ void __launch_bounds__(kBlockX * kBlockY)
cross_affinity_bwd_kernel(Emb<T> a, Emb<T> b, const T* __restrict__ g, T* __restrict__ da,
                          T* __restrict__ db, int D, int H, int W, int K, Offsets off, bool raw) {
    const int x = blockIdx.x * kBlockX + threadIdx.x;
    const int y = blockIdx.y * kBlockY + threadIdx.y;
    const int bi = blockIdx.z / D;
    const int z = blockIdx.z - bi * D;
    if (x >= W || y >= H) return;

    float na[C], dna[C], nb[C], dnb[C];
    const float norm_a = load_unit<T, C, kContigA>(a.at(bi, z, y, x), a.sC, raw, na);
    float norm_b = 0.f;
    if (kDb) norm_b = load_unit<T, C, kContigB>(b.at(bi, z, y, x), b.sC, raw, nb);
#pragma unroll
    for (int c = 0; c < C; ++c) {
        dna[c] = 0.f;
        dnb[c] = 0.f;
    }

    const int64_t vol = (int64_t)D * H * W;
    const T* gb = g + (int64_t)bi * K * vol;
    const int64_t p = ((int64_t)z * H + y) * W + x;
    for (int k = 0; k < K; ++k) {
        const T* gk = gb + k * vol;
        // a_k(p) = <n_a(p), n_b(p + o_k)>
        int zz = z + off.z[k], yy = y + off.y[k], xx = x + off.x[k];
        if (inside(zz, yy, xx, D, H, W)) {
            float v[C];
            const float r = load_scaled<T, C, kContigB>(b.at(bi, zz, yy, xx), b.sC, raw, v);
            axpy<C>(to_float(gk[p]) * r, v, dna);
        }
        if (kDb) {
            // a_k(p - o_k) = <n_a(p - o_k), n_b(p)>
            zz = z - off.z[k], yy = y - off.y[k], xx = x - off.x[k];
            if (inside(zz, yy, xx, D, H, W)) {
                float v[C];
                const float r = load_scaled<T, C, kContigA>(a.at(bi, zz, yy, xx), a.sC, raw, v);
                axpy<C>(to_float(gk[((int64_t)zz * H + yy) * W + xx]) * r, v, dnb);
            }
        }
    }
    store_grad<T, C>(na, norm_a, dna, raw, da + (int64_t)bi * C * vol + p, vol);
    if (kDb) store_grad<T, C>(nb, norm_b, dnb, raw, db + (int64_t)bi * C * vol + p, vol);
}

bool bad_shape(int B, int D, int H, int W, int C, int K) {
    return K < 1 || K > kMaxChannels || B < 1 || D < 1 || H < 1 || W < 1 ||
           (int64_t)B * D > 65535 || (H + kBlockY - 1) / kBlockY > 65535 || (C != 8 && C != 16);
}

dim3 grid_of(int B, int D, int H, int W) {
    return dim3((W + kBlockX - 1) / kBlockX, (H + kBlockY - 1) / kBlockY, B * D);
}

Offsets to_offsets(const int32_t* offsets, int K) {
    Offsets off;
    for (int k = 0; k < K; ++k) {
        off.z[k] = offsets[3 * k];
        off.y[k] = offsets[3 * k + 1];
        off.x[k] = offsets[3 * k + 2];
    }
    return off;
}

template <typename T>
Emb<T> emb(const void* p, const int64_t* s) {
    return Emb<T>{static_cast<const T*>(p), s[0], s[1], s[2], s[3], s[4]};
}

template <typename T, int C>
void launch_bwd(const void* e, const int64_t* se, const void* g, void* de, int B, int D, int H,
                int W, int K, const Offsets& off, bool raw, cudaStream_t s) {
    const dim3 grid = grid_of(B, D, H, W), block(kBlockX, kBlockY);
    if (contiguous_vectors<T>(e, se))
        affinity_bwd_kernel<T, C, true><<<grid, block, 0, s>>>(
            emb<T>(e, se), static_cast<const T*>(g), static_cast<T*>(de), D, H, W, K, off, raw);
    else
        affinity_bwd_kernel<T, C, false><<<grid, block, 0, s>>>(
            emb<T>(e, se), static_cast<const T*>(g), static_cast<T*>(de), D, H, W, K, off, raw);
}

// f(std::true_type{}) or f(std::false_type{}), as v
template <typename F>
void with_flag(bool v, F&& f) {
    if (v) f(std::true_type{});
    else f(std::false_type{});
}

// each input's load mode from its own strides and address
template <typename T, int C>
void launch_cross_fwd(const void* a, const int64_t* sa, const void* b, const int64_t* sb,
                      void* out, int B, int D, int H, int W, int K, const Offsets& off,
                      cudaStream_t s) {
    const dim3 grid = grid_of(B, D, H, W), block(kBlockX, kBlockY);
    with_flag(contiguous_vectors<T>(a, sa), [&](auto ca) {
        with_flag(contiguous_vectors<T>(b, sb), [&](auto cb) {
            constexpr bool kA = decltype(ca)::value, kB = decltype(cb)::value;
            cross_affinity_fwd_kernel<T, C, kA, kB><<<grid, block, 0, s>>>(
                emb<T>(a, sa), emb<T>(b, sb), static_cast<T*>(out), D, H, W, K, off);
        });
    });
}

template <typename T, int C>
void launch_cross_bwd(const void* a, const int64_t* sa, const void* b, const int64_t* sb,
                      const void* g, void* da, void* db, int B, int D, int H, int W, int K,
                      const Offsets& off, bool raw, cudaStream_t s) {
    const dim3 grid = grid_of(B, D, H, W), block(kBlockX, kBlockY);
    with_flag(db != nullptr, [&](auto with_db) {
        with_flag(contiguous_vectors<T>(a, sa), [&](auto ca) {
            with_flag(contiguous_vectors<T>(b, sb), [&](auto cb) {
                constexpr bool kDb = decltype(with_db)::value, kA = decltype(ca)::value,
                               kB = decltype(cb)::value;
                cross_affinity_bwd_kernel<T, C, kDb, kA, kB><<<grid, block, 0, s>>>(
                    emb<T>(a, sa), emb<T>(b, sb), static_cast<const T*>(g), static_cast<T*>(da),
                    static_cast<T*>(db), D, H, W, K, off, raw);
            });
        });
    });
}

// Calls L<T, C>(args...) for dtype (0 float32, 1 bfloat16) and C (8, 16).
#define DISPATCH(L, dtype, C, ...)                                              \
    do {                                                                        \
        if ((dtype) == 0 && (C) == 8) L<float, 8>(__VA_ARGS__);                 \
        else if ((dtype) == 0) L<float, 16>(__VA_ARGS__);                       \
        else if ((C) == 8) L<__nv_bfloat16, 8>(__VA_ARGS__);                    \
        else L<__nv_bfloat16, 16>(__VA_ARGS__);                                 \
    } while (0)

}  // namespace

extern "C" {

// Each entry returns the cudaError_t of its launch (0 on success).
// dtype: 0 = float32, 1 = bfloat16, the type of every tensor argument.
// se/sa/sb: host arrays of the 5 element strides of a (B, D, H, W, C) view.
// g: contiguous (B, K, D, H, W); out: contiguous (B, K, D, H, W);
// de/da/db: contiguous (B, C, D, H, W). offsets: host array of K
// (oz, oy, ox) triples. raw: take the inputs as unit vectors, write dn.

int affinity_bwd(const void* e, const int64_t* se, const void* g, void* de, int dtype,
                 int B, int D, int H, int W, int C, const int32_t* offsets, int K, int raw,
                 void* stream) {
    if (bad_shape(B, D, H, W, C, K) || (dtype != 0 && dtype != 1))
        return (int)cudaErrorInvalidValue;
    const Offsets off = to_offsets(offsets, K);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    DISPATCH(launch_bwd, dtype, C, e, se, g, de, B, D, H, W, K, off, raw != 0, s);
    return (int)cudaGetLastError();
}

int cross_affinity_fwd(const void* a, const int64_t* sa, const void* b, const int64_t* sb,
                       void* out, int dtype, int B, int D, int H, int W, int C,
                       const int32_t* offsets, int K, void* stream) {
    if (bad_shape(B, D, H, W, C, K) || (dtype != 0 && dtype != 1))
        return (int)cudaErrorInvalidValue;
    const Offsets off = to_offsets(offsets, K);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    DISPATCH(launch_cross_fwd, dtype, C, a, sa, b, sb, out, B, D, H, W, K, off, s);
    return (int)cudaGetLastError();
}

// db may be null: the teacher's gradient is then skipped.
int cross_affinity_bwd(const void* a, const int64_t* sa, const void* b, const int64_t* sb,
                       const void* g, void* da, void* db, int dtype, int B, int D, int H, int W,
                       int C, const int32_t* offsets, int K, int raw, void* stream) {
    if (bad_shape(B, D, H, W, C, K) || (dtype != 0 && dtype != 1))
        return (int)cudaErrorInvalidValue;
    const Offsets off = to_offsets(offsets, K);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    DISPATCH(launch_cross_bwd, dtype, C, a, sa, b, sb, g, da, db, B, D, H, W, K, off, raw != 0,
             s);
    return (int)cudaGetLastError();
}

}  // extern "C"
