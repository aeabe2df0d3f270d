// What the affinity kernels of affinity3d.cu and affinity_grad.cu share:
// float32 views of float32 and bfloat16 values, and the load of one
// voxel's C embedding values from a (B, D, H, W, C) view with any strides.

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

// whether every voxel's C values of the view at p with element strides s
// (B, D, H, W, C) are contiguous and 16-byte aligned
template <typename T>
inline bool contiguous_vectors(const void* p, const int64_t* s) {
    constexpr int64_t kPer = 16 / sizeof(T);
    return s[4] == 1 && s[0] % kPer == 0 && s[1] % kPer == 0 && s[2] % kPer == 0 &&
           s[3] % kPer == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace affinity_load
