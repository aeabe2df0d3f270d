// Tensor-core and asynchronous-copy helpers shared by conv3x3.cu and
// s2d_block.cu (sm_90a): cp.async with zero fill, mma.sync m16n8k8 TF32
// with the 3xTF32 split for float32, mma.sync m16n8k16 bfloat16 with
// ldmatrix fragment loads, and one k-step of a warp's implicit-GEMM tile.
//
// Fragment layouts (PTX ISA, "Matrix fragments for mma.m16n8k8 / k16"),
// with g = lane / 4 and t = lane % 4:
//   TF32 m16n8k8  A (16 x 8, row)  a0 (g, t)  a1 (g + 8, t)  a2 (g, t + 4)  a3 (g + 8, t + 4)
//                 B (8 x 8, col)   b0 (k = t, n = g)  b1 (k = t + 4, n = g)
//   BF16 m16n8k16 A (16 x 16, row) a0 (g, 2t..2t+1)  a1 (g + 8, 2t..)  a2 (g, 2t + 8..)  a3 (g + 8, 2t + 8..)
//                 B (16 x 8, col)  b0 (k = 2t..2t+1, n = g)  b1 (k = 2t + 8.., n = g)
//   C/D (16 x 8, float)            c0 (g, 2t)  c1 (g, 2t + 1)  c2 (g + 8, 2t)  c3 (g + 8, 2t + 1)
//
// Shared-memory operands. A is [row][k] (a row is an output pixel's input
// pixel for one tap, k its channels), B is [k][n] (a tap's weights, n the
// output channels), both with k or n contiguous. Their row strides are
// padded so that a warp's fragment loads meet no bank conflict:
//   float32 A: stride = 4 (mod 32) floats, so rows g = 0..7 at t = 0..3
//     cover 32 distinct banks;
//   float32 B: stride = 8 or 24 (mod 32) floats (k = 0..3 rows at n = 0..7);
//   bfloat16 A and B (ldmatrix, 8 rows of 16 bytes a phase): a row stride
//     of an odd multiple of 16 bytes puts the 8 rows in 8 distinct 16-byte
//     slots of the 128-byte bank window.

#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace tc {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zeros where !valid (the source
// is then not read, but must be a mapped address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
    const int n = valid ? 16 : 0;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" :: "n"(N)); }

__device__ __forceinline__ uint32_t to_tf32(float x) {
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
    return r;
}

// x = hi + lo to ~2^-22 relative, each part a TF32 value.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
    hi = to_tf32(x);
    lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
    return __float2bfloat16(v);
}

// The k depth of one mma step: 8 (TF32) or 16 (bf16) channels, the chunk
// that a pipeline stage holds.
template <typename T> struct Mma;
template <> struct Mma<float> { static constexpr int K = 8; };
template <> struct Mma<__nv_bfloat16> { static constexpr int K = 16; };

// One k-step of a warp's MT x NT tile of 16 x 8 products:
//   acc[i][j] += A[rows of m-tile i][0 : K] . B[0 : K][n0 + 8 j : n0 + 8 j + 8]
// A: shared [row][k] with row stride as; the lane's rows of m-tile i are
// given as row indices, arow[i][0] for rows g (float32) or the lane's
// ldmatrix row (lane & 15, bf16), arow[i][1] for rows g + 8 (float32), to
// which `shift` is added (the tap's offset in the tile). B: shared [k][n]
// with row stride bs.
template <int MT, int NT>
__device__ __forceinline__ void mma_step(float (&acc)[MT][NT][4], const float* A, int as,
                                         const int (&arow)[MT][2], int shift, const float* B,
                                         int bs, int n0) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
        split_tf32(B[t * bs + n0 + 8 * j + g], bh[j][0], bl[j][0]);
        split_tf32(B[(t + 4) * bs + n0 + 8 * j + g], bh[j][1], bl[j][1]);
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
        const float* r0 = A + (arow[i][0] + shift) * as;
        const float* r1 = A + (arow[i][1] + shift) * as;
        uint32_t ah[4], al[4];
        split_tf32(r0[t], ah[0], al[0]);
        split_tf32(r1[t], ah[1], al[1]);
        split_tf32(r0[t + 4], ah[2], al[2]);
        split_tf32(r1[t + 4], ah[3], al[3]);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
            // the three passes (small products first) into a fresh sum,
            // added to acc by a rounding float32 add: the tensor cores
            // truncate the sum they carry, and a K-long chain of them
            // drifts (1.6e-5 of the largest output at K = 9 x 256 on an
            // H100, against the 1e-5 the kernels are held to)
            float d[4] = {0.f, 0.f, 0.f, 0.f};
            mma_tf32(d, al, bh[j][0], bh[j][1]);
            mma_tf32(d, ah, bl[j][0], bl[j][1]);
            mma_tf32(d, ah, bh[j][0], bh[j][1]);
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j][e] += d[e];
        }
    }
}

template <int MT, int NT>
__device__ __forceinline__ void mma_step(float (&acc)[MT][NT][4], const __nv_bfloat16* A, int as,
                                         const int (&arow)[MT][2], int shift,
                                         const __nv_bfloat16* B, int bs, int n0) {
    static_assert(NT % 2 == 0, "bf16 B fragments load two n-tiles at a time");
    const int lane = threadIdx.x & 31;
    const int k8 = (lane >> 4) * 8;  // the lane's ldmatrix row: (lane & 15), half k8
    uint32_t b[NT][2];
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, B + (lane & 15) * bs + n0 + 8 * j + k8);
        b[j][0] = r[0];
        b[j][1] = r[1];
        b[j + 1][0] = r[2];
        b[j + 1][1] = r[3];
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
        uint32_t a[4];
        ldmatrix_x4(a, A + (arow[i][0] + shift) * as + k8);
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_bf16(acc[i][j], a, b[j][0], b[j][1]);
    }
}

// The lane's A rows of an m-tile whose 16 rows are the row indices
// row_of(0..15): (g, g + 8) for float32, the ldmatrix row for bf16.
template <typename T, typename F>
__device__ __forceinline__ void lane_rows(int (&r)[2], F row_of) {
    const int lane = threadIdx.x & 31;
    if constexpr (sizeof(T) == 4) {
        r[0] = row_of(lane >> 2);
        r[1] = row_of((lane >> 2) + 8);
    } else {
        r[0] = row_of(lane & 15);
        r[1] = r[0];
    }
}

// A ring of S shared-memory stages over n chunks: load(c, s) issues chunk
// c's copies into stage s (cp.async, or plain stores), compute(c, s) uses
// them. Chunk c + S - 1 is in flight while chunk c is computed. Every
// thread of the block calls it; it returns with all copies landed and the
// block synchronised, so the stages may be reused.
template <int S, typename Load, typename Compute>
__device__ __forceinline__ void pipeline(int n, Load load, Compute compute) {
    static_assert(S >= 2, "at least two stages");
#pragma unroll
    for (int s = 0; s < S - 1; ++s) {
        if (s < n) load(s, s);
        cp_async_commit();
    }
    for (int c = 0; c < n; ++c) {
        cp_async_wait<S - 2>();
        __syncthreads();
        const int next = c + S - 1;
        if (next < n) load(next, next % S);
        cp_async_commit();
        compute(c, c % S);
    }
    cp_async_wait<0>();
    __syncthreads();
}

}  // namespace tc
