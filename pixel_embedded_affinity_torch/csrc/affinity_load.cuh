// What the affinity kernels of affinity2d.cu, affinity3d.cu,
// affinity_grad.cu and affinity_wmse2d.cu share: float32 views of float32
// and bfloat16 values, the load of one voxel's C embedding values from a
// view with any strides, and the arithmetic of a gathered neighbour (its
// raw values and one reciprocal square root of its norm) and of the
// normalisation's VJP. Through these helpers no affinity kernel of the
// package divides an embedding value: a vector is scaled by one
// reciprocal of its norm, a gathered neighbour's dot by inv_norm.

#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace affinity_load {

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
    return __float2bfloat16(v);
}

// v[c] = the C values at p in float32, channel stride sC. With kContig
// they are contiguous and 16-byte aligned (the channels-last layout, which
// the 3D train step's model output has), read in C * sizeof(T) / 16 loads
// of 16 bytes; a bfloat16 is the high half of its float32. Plane-wise, as
// the NCDHW view needs, a warp's load of one channel is coalesced along x,
// and the channels-last layout would spread it over 16 sectors.
template <typename T, int C, bool kContig>
__device__ __forceinline__ void load_values(const T* __restrict__ p, int64_t sC, float* v) {
    if constexpr (!kContig) {
#pragma unroll
        for (int c = 0; c < C; ++c) v[c] = to_float(p[c * sC]);
    } else if constexpr (sizeof(T) == 4) {
#pragma unroll
        for (int j = 0; j < C / 4; ++j) {
            const float4 f = reinterpret_cast<const float4*>(p)[j];
            v[4 * j] = f.x;
            v[4 * j + 1] = f.y;
            v[4 * j + 2] = f.z;
            v[4 * j + 3] = f.w;
        }
    } else {
#pragma unroll
        for (int j = 0; j < C / 8; ++j) {
            const uint4 u = reinterpret_cast<const uint4*>(p)[j];
            const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                v[8 * j + 2 * i] = __uint_as_float(w[i] << 16);
                v[8 * j + 2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
            }
        }
    }
}

// the dot of u and v in four independent sums
template <int C>
__device__ __forceinline__ float dot(const float* u, const float* v) {
    float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int c = 0; c < C; ++c) s[c % 4] += u[c] * v[c];
    return (s[0] + s[1]) + (s[2] + s[3]);
}

template <int C>
__device__ __forceinline__ void axpy(float a, const float* x, float* y) {
#pragma unroll
    for (int c = 0; c < C; ++c) y[c] += a * x[c];
}

// 1 / max(|v|, eps) of the C values v by one reciprocal square root
// (within 2^-22.9 of the quotient; min(rsqrt, 1e12) is 1 / max(sqrt, eps)
// for every sum of squares), or 1 when raw
template <int C>
__device__ __forceinline__ float inv_norm(const float* v, bool raw) {
    return raw ? 1.f : fminf(rsqrtf(dot<C>(v, v) + 1e-36f), 1e12f);
}

// v = the C values at p; returns inv_norm(v)
template <typename T, int C, bool kContig>
__device__ __forceinline__ float load_scaled(const T* __restrict__ p, int64_t sC, bool raw,
                                             float* v) {
    load_values<T, C, kContig>(p, sC, v);
    return inv_norm<C>(v, raw);
}

// n = the C values at p times 1 / max(|v|, eps), one division (as they are
// when raw); returns |v| = sqrt(sum v^2 + 1e-36) for the VJP
template <typename T, int C, bool kContig>
__device__ __forceinline__ float load_unit(const T* __restrict__ p, int64_t sC, bool raw,
                                           float* n) {
    load_values<T, C, kContig>(p, sC, n);
    const float norm = sqrtf(dot<C>(n, n) + 1e-36f);
    if (!raw) {
        const float inv = 1.f / fmaxf(norm, 1e-12f);
#pragma unroll
        for (int c = 0; c < C; ++c) n[c] *= inv;
    }
    return norm;
}

// out[c * vol] = (dn[c] - n[c] <n, dn> [norm >= eps]) / max(norm, eps) by
// one division, or dn[c] when raw
template <typename T, int C>
__device__ __forceinline__ void store_grad(const float* n, float norm, const float* dn, bool raw,
                                           T* __restrict__ out, int64_t vol) {
    const float inv = raw ? 1.f : 1.f / fmaxf(norm, 1e-12f);
    const float proj = (!raw && norm >= 1e-12f) ? dot<C>(n, dn) : 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) out[c * vol] = from_float<T>((dn[c] - n[c] * proj) * inv);
}

// whether every voxel's C values of the view at p with element strides s
// (B, D, H, W, C) are contiguous and 16-byte aligned
template <typename T>
inline bool contiguous_vectors(const void* p, const int64_t* s) {
    constexpr int64_t kPer = 16 / sizeof(T);
    return s[4] == 1 && s[0] % kPer == 0 && s[1] % kPer == 0 && s[2] % kPer == 0 &&
           s[3] % kPer == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace affinity_load
