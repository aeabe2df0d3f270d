// Loss-fused embedding -> affinity WMSE, forward and backward, self and
// cross view, for Hopper (sm_90a).
//
// Replaces the TPU kernels of pixel_embedded_affinity_tpu/ops/emb2aff_pallas.py
// (public entries fused_affinity_wmse_2d, fused_cross_affinity_wmse_2d):
//   K2f _affinity_wmse_kernel     (pl.pallas_call in _fused_wmse_2d_fwd_impl)       -> wmse2d_fwd
//   K2b _affinity_wmse_bwd_kernel (_fused_wmse_2d_bwd_impl)                         -> wmse2d_bwd
//   K3f _cross_wmse_kernel        (_fused_cross_wmse_2d_fwd_impl)                   -> cross_wmse2d_fwd
//   K3b _cross_wmse_bwd_kernel    (_fused_cross_wmse_2d_bwd_impl)                   -> cross_wmse2d_bwd
// Python wrapper: ops/emb2aff_wmse_cuda.py.
//
// What it computes. Embeddings a, b: (B, H, W, C) float32 or bfloat16 (T,
// one for both) with arbitrary element strides (the self loss passes
// a == b); C = 16, the emd of the cvppp preset, the only width training
// runs. Every value is computed in float32. With
//     n = e / max(sqrt(|e|^2 + 1e-36), 1e-12)
// and offsets o_k that look up and left, the affinity is
//     a_k(p) = <n_a(p), n_b(p + o_k)>,  0 where p + o_k lies outside the image.
// t, w, m: (B, K, H, W) float32, contiguous (target, weight, mask).
// Forward: affs (B, K, H, W) = a_k in T, and the per-offset sums
//     S_k = sum_{b,y,x} w_k (a_k m_k - t_k m_k)^2
// in float32 from the unrounded a_k (as the TPU kernels take them),
// one (K,) partial per block into partial (n_blocks, K); the wrapper sums
// the partials with torch.sum, so S is the same from run to run (no atomics).
// Backward, given gS (K,) on the device: the WMSE cotangent
//     g_k(q) = gS_k * 2 w_k(q) m_k(q) (a_k(q) m_k(q) - t_k(q) m_k(q))
// is formed in registers from a recomputed a_k (no (B, K, H, W) gradient is
// stored), then
//     dn_a(p) = sum_k g_k(p) n_b(p + o_k),   dn_b(p) = sum_k g_k(p - o_k) n_a(p - o_k)
// and the normalisation's VJP, de = (dn - n <n, dn> [|e| >= eps]) / max(|e|, eps).
// The self loss (a == b) writes de = VJP(dn_a + dn_b); the cross loss
// writes da, and db only when the caller asks for it (db non-null): the
// training step's teacher is detached, so its call skips db.
// Gradients go to contiguous (B, C, H, W) buffers of T, the layout of the
// model's NCHW output.
//
// Bound (B=2, 544x544, C=16, K=10, f32, HBM at 3.35 TB/s; each input read
// once, each output written once). Forward: read e (37.9 MB, twice that
// for cross) and t/w/m (71.0 MB), write affs (23.7 MB): ~133 MB, ~40 us
// self, ~51 us cross. Backward: self reads e and t/w/m and writes de:
// 146.8 MB, 43.8 us; cross without db reads a, b and t/w/m and writes da:
// 184.6 MB, 55.1 us; with db it also writes db: 222.5 MB, 66.4 us. The
// arithmetic (~2-4 x (3C + 2CK) flops per pixel) needs < 10 us at the 67
// TFLOP/s float32 rate, so bytes bound all four.
// In bfloat16 the embeddings and the outputs take half the bytes and t/w/m
// the same (K = 10: 172 B a pixel forward, against 224 in float32), so the
// forward's bound falls to ~0.77x its float32 one: K2f ~31 us, K3f ~36 us.
//
// Design. One thread per pixel, 32x8 blocks along x so a warp's loads and
// stores of one channel are contiguous in NCHW, bounds checks in place of
// the TPU's zero pad and row-tile halo. Every kernel gathers each
// neighbour through L1/L2 as the 3D kernels of affinity_grad.cu do, with
// their helpers (affinity_load.cuh): it loads the neighbour's raw values v
// plane-wise through the view's strides and takes r = inv_norm(v), one
// reciprocal square root, so its affinity is <n_own, v> r and no value is
// divided; the pixel's own vector is normalised by one reciprocal. The
// forward (K2f/K3f) writes the affinity and reduces S inside the block
// (warp shuffles per offset, then one shared-memory row per warp). The
// backward (K2b/K3b) forms the cotangent g and adds (g r) v to dn, and
// scales the VJP by one reciprocal. The self form gathers 2K neighbours,
// the cross form K without db (only b at p + o_k) and 2K with it. A
// shared-memory tile was not built: its halo would be 27 pixels, and the
// staged forms of the 3D kernels lost to this gather by 1.45-3.2x
// (tools/affinity_zwalk.cu).
//
// On an NVIDIA H100 80GB HBM3 at 700 W (B=2 544x544, C=16, K=10, float32,
// the model's NCHW output permuted, L2 flushed, CUDA graph replay, median
// of 20; tools/wmse_ab.py beside the first versions, which divided every
// value they normalised and always wrote db): K2f 0.0985-0.1020 ms
// (0.1297-0.1328 before; bound 0.0396), K3f 0.1102-0.1120 (0.1351-0.1391;
// bound 0.0509), both at 48 registers (64 before), no spills; capped at 40
// (6 blocks an SM) they spilled nothing and tied, so no cap ships. K2b
// 0.1286-0.1341 (0.2195-0.2252 before; bound 0.0438), K3b without db
// 0.1005-0.1053 (bound 0.0551; 0.1154 uncapped at 77 registers), K3b with
// db 0.2064-0.2132 (0.3398-0.3423 before; bound 0.0664). In the training
// steps (torch.profiler, chip_smoke.py): K3b 0.0969-0.0971 ms at 544x544
// (0.3370 before) and 0.0239-0.0253 at 256x256 (0.0760). A teacher with H
// stride 1 costs K3b 0.3986 without db: each warp load of a channel then
// touches 32 sectors.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "affinity_load.cuh"

namespace {

using namespace affinity_load;

constexpr int C = 16;  // embedding channels
constexpr int kMaxOffsets = 16;
constexpr int kBlockX = 32;
constexpr int kBlockY = 8;
constexpr int kWarps = kBlockX * kBlockY / 32;

struct Offsets {
    int dy[kMaxOffsets];
    int dx[kMaxOffsets];
};

// element strides of a (B, H, W, C) view of T values
template <typename T>
struct View {
    const T* p;
    int64_t sB, sH, sW, sC;
    __device__ __forceinline__ const T* at(int b, int y, int x) const {
        return p + b * sB + y * sH + x * sW;
    }
};

__device__ __forceinline__ bool inside(int y, int x, int H, int W) {
    return y >= 0 && y < H && x >= 0 && x < W;
}

__device__ __forceinline__ float wmse_grad(float gs, float a, float t, float w, float m) {
    const float d = a * m - t * m;
    return gs * 2.0f * w * m * d;
}

template <typename T>
__global__ void __launch_bounds__(kBlockX * kBlockY)
wmse_fwd_kernel(View<T> a, View<T> b, const float* __restrict__ t, const float* __restrict__ w,
                const float* __restrict__ m, T* __restrict__ affs, float* __restrict__ partial,
                int H, int W, int K, Offsets off) {
    __shared__ float red[kWarps][kMaxOffsets];
    const int x = blockIdx.x * kBlockX + threadIdx.x;
    const int y = blockIdx.y * kBlockY + threadIdx.y;
    const int bi = blockIdx.z;
    const int tid = threadIdx.y * kBlockX + threadIdx.x;
    const bool in_img = x < W && y < H;

    float na[C];
#pragma unroll
    for (int c = 0; c < C; ++c) na[c] = 0.f;
    if (in_img) load_unit<T, C, false>(a.at(bi, y, x), a.sC, false, na);

    const int64_t plane = (int64_t)H * W;
    const int64_t pix = (int64_t)bi * K * plane + (int64_t)y * W + x;
    // every thread of the block runs this loop (no early return): the
    // shuffles below need the whole warp
    for (int k = 0; k < K; ++k) {
        float s = 0.f;
        if (in_img) {
            const int yy = y + off.dy[k];
            const int xx = x + off.dx[k];
            float v = 0.f;
            if (inside(yy, xx, H, W)) {
                float vb[C];
                const float r = load_scaled<T, C, false>(b.at(bi, yy, xx), b.sC, false, vb);
                v = dot<C>(na, vb) * r;
            }
            const int64_t i = pix + k * plane;
            affs[i] = from_float<T>(v);
            const float mk = m[i];
            const float d = v * mk - t[i] * mk;
            s = w[i] * d * d;
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
        if ((tid & 31) == 0) red[tid >> 5][k] = s;
    }
    __syncthreads();
    if (tid < K) {
        float s = 0.f;
#pragma unroll
        for (int wp = 0; wp < kWarps; ++wp) s += red[wp][tid];
        const int64_t blk = ((int64_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
        partial[blk * K + tid] = s;
    }
}

// The blocks an SM the backward asks ptxas to fit: 4 (64 registers a
// thread, 32 warps an SM) for the cross form without db, which then spills
// nothing and takes 13% less time than with the 77 registers it takes
// unbounded (tools/wmse_ab.py); the self and db forms would spill under
// that cap (16 and 232 bytes) and keep the default.
template <bool kSelf, bool kDb>
constexpr int kBwdMinBlocks = kSelf || kDb ? 1 : 4;

// kSelf: a == b, one output de = VJP(dn_a + dn_b); else da, and with kDb
// also db. Each gathered neighbour's raw values v are scaled by one
// reciprocal r = 1 / |v|: its affinity is <n, v> r, and g r multiplies v.
template <typename T, bool kSelf, bool kDb>
__global__ void __launch_bounds__(kBlockX * kBlockY, (kBwdMinBlocks<kSelf, kDb>))
wmse_bwd_kernel(View<T> a, View<T> b, const float* __restrict__ t, const float* __restrict__ w,
                const float* __restrict__ m, const float* __restrict__ gs,
                T* __restrict__ da, T* __restrict__ db,
                int H, int W, int K, Offsets off) {
    static_assert(!(kSelf && kDb), "the self loss has one gradient");
    const int x = blockIdx.x * kBlockX + threadIdx.x;
    const int y = blockIdx.y * kBlockY + threadIdx.y;
    const int bi = blockIdx.z;
    if (x >= W || y >= H) return;

    float na[C], dna[C], nb[C], dnb[C];
    const float norm_a = load_unit<T, C, false>(a.at(bi, y, x), a.sC, false, na);
    float norm_b = 0.f;
    if (kDb) norm_b = load_unit<T, C, false>(b.at(bi, y, x), b.sC, false, nb);
#pragma unroll
    for (int c = 0; c < C; ++c) {
        dna[c] = 0.f;
        dnb[c] = 0.f;
    }

    const int64_t plane = (int64_t)H * W;
    const int64_t p = (int64_t)y * W + x;
    for (int k = 0; k < K; ++k) {
        const float gsk = gs[k];
        const int64_t ik = ((int64_t)bi * K + k) * plane;
        // the pair (p, p + o_k): a_k(p) = <n_a(p), n_b(p + o_k)>
        int yy = y + off.dy[k];
        int xx = x + off.dx[k];
        if (inside(yy, xx, H, W)) {
            float v[C];
            const float r = load_scaled<T, C, false>(b.at(bi, yy, xx), b.sC, false, v);
            const int64_t i = ik + p;
            axpy<C>(wmse_grad(gsk, dot<C>(na, v) * r, t[i], w[i], m[i]) * r, v, dna);
        }
        if (kSelf || kDb) {
            // the pair (p - o_k, p): a_k(p - o_k) = <n_a(p - o_k), n_b(p)>
            yy = y - off.dy[k];
            xx = x - off.dx[k];
            if (inside(yy, xx, H, W)) {
                float v[C];
                const float r = load_scaled<T, C, false>(a.at(bi, yy, xx), a.sC, false, v);
                const int64_t i = ik + (int64_t)yy * W + xx;
                const float g = wmse_grad(gsk, dot<C>(v, kSelf ? na : nb) * r, t[i], w[i], m[i]);
                axpy<C>(g * r, v, kSelf ? dna : dnb);
            }
        }
    }
    const int64_t out = (int64_t)bi * C * plane + p;
    store_grad<T, C>(na, norm_a, dna, false, da + out, plane);
    if (kDb) store_grad<T, C>(nb, norm_b, dnb, false, db + out, plane);
}

dim3 grid_of(int B, int H, int W) {
    return dim3((W + kBlockX - 1) / kBlockX, (H + kBlockY - 1) / kBlockY, B);
}

bool bad_shape(int B, int H, int W, int c, int K) {
    return K < 1 || K > kMaxOffsets || B < 1 || H < 1 || W < 1 || B > 65535 || c != C;
}

Offsets to_offsets(const int32_t* offsets, int K) {
    Offsets off;
    for (int k = 0; k < K; ++k) {
        off.dy[k] = offsets[2 * k];
        off.dx[k] = offsets[2 * k + 1];
    }
    return off;
}

template <typename T>
int fwd(const void* a, const int64_t* sa, const void* b, const int64_t* sb, const float* t,
        const float* w, const float* m, void* affs, float* partial, int B, int H, int W, int c,
        const int32_t* offsets, int K, void* stream) {
    if (bad_shape(B, H, W, c, K)) return (int)cudaErrorInvalidValue;
    const Offsets off = to_offsets(offsets, K);
    const View<T> va{static_cast<const T*>(a), sa[0], sa[1], sa[2], sa[3]};
    const View<T> vb{static_cast<const T*>(b), sb[0], sb[1], sb[2], sb[3]};
    const dim3 block(kBlockX, kBlockY);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    wmse_fwd_kernel<T><<<grid_of(B, H, W), block, 0, s>>>(va, vb, t, w, m, static_cast<T*>(affs),
                                                          partial, H, W, K, off);
    return (int)cudaGetLastError();
}

template <typename T, bool kSelf, bool kDb>
int bwd(const void* a, const int64_t* sa, const void* b, const int64_t* sb, const float* t,
        const float* w, const float* m, const float* gs, void* da, void* db, int B, int H, int W,
        int c, const int32_t* offsets, int K, void* stream) {
    if (bad_shape(B, H, W, c, K)) return (int)cudaErrorInvalidValue;
    const Offsets off = to_offsets(offsets, K);
    const View<T> va{static_cast<const T*>(a), sa[0], sa[1], sa[2], sa[3]};
    const View<T> vb{static_cast<const T*>(b), sb[0], sb[1], sb[2], sb[3]};
    const dim3 block(kBlockX, kBlockY);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    wmse_bwd_kernel<T, kSelf, kDb><<<grid_of(B, H, W), block, 0, s>>>(
        va, vb, t, w, m, gs, static_cast<T*>(da), static_cast<T*>(db), H, W, K, off);
    return (int)cudaGetLastError();
}

// the forward of the storage type that dtype names (0 float32, 1 bfloat16)
int fwd_of(int dtype, const void* a, const int64_t* sa, const void* b, const int64_t* sb,
           const float* t, const float* w, const float* m, void* affs, float* partial, int B,
           int H, int W, int c, const int32_t* offsets, int K, void* stream) {
    if (dtype == 0)
        return fwd<float>(a, sa, b, sb, t, w, m, affs, partial, B, H, W, c, offsets, K, stream);
    if (dtype == 1)
        return fwd<__nv_bfloat16>(a, sa, b, sb, t, w, m, affs, partial, B, H, W, c, offsets, K,
                                  stream);
    return (int)cudaErrorInvalidValue;
}

// the backward of that storage type
template <bool kSelf, bool kDb>
int bwd_of(int dtype, const void* a, const int64_t* sa, const void* b, const int64_t* sb,
           const float* t, const float* w, const float* m, const float* gs, void* da, void* db,
           int B, int H, int W, int c, const int32_t* offsets, int K, void* stream) {
    if (dtype == 0)
        return bwd<float, kSelf, kDb>(a, sa, b, sb, t, w, m, gs, da, db, B, H, W, c, offsets, K,
                                      stream);
    if (dtype == 1)
        return bwd<__nv_bfloat16, kSelf, kDb>(a, sa, b, sb, t, w, m, gs, da, db, B, H, W, c,
                                              offsets, K, stream);
    return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Rows of the forward's partial-sum scratch: one per block.
int64_t wmse2d_partial_rows(int B, int H, int W) {
    const dim3 g = grid_of(B, H, W);
    return (int64_t)g.x * g.y * g.z;
}

// Each entry returns the cudaError_t of its launch (0 on success).
// dtype: the storage of the embeddings, the affinities and the gradients,
// 0 float32, 1 bfloat16; t, w, m, partial and gs are float32.
// offsets: host array of K (dy, dx) pairs; gs: device pointer to K floats.
int wmse2d_fwd(const void* e, int64_t sB, int64_t sH, int64_t sW, int64_t sC,
               const float* t, const float* w, const float* m, void* affs, float* partial,
               int dtype, int B, int H, int W, int c, const int32_t* offsets, int K,
               void* stream) {
    const int64_t s[4] = {sB, sH, sW, sC};
    return fwd_of(dtype, e, s, e, s, t, w, m, affs, partial, B, H, W, c, offsets, K, stream);
}

int cross_wmse2d_fwd(const void* a, int64_t saB, int64_t saH, int64_t saW, int64_t saC,
                     const void* b, int64_t sbB, int64_t sbH, int64_t sbW, int64_t sbC,
                     const float* t, const float* w, const float* m, void* affs, float* partial,
                     int dtype, int B, int H, int W, int c, const int32_t* offsets, int K,
                     void* stream) {
    const int64_t sa[4] = {saB, saH, saW, saC}, sb[4] = {sbB, sbH, sbW, sbC};
    return fwd_of(dtype, a, sa, b, sb, t, w, m, affs, partial, B, H, W, c, offsets, K, stream);
}

int wmse2d_bwd(const void* e, int64_t sB, int64_t sH, int64_t sW, int64_t sC,
               const float* t, const float* w, const float* m, const float* gs, void* de,
               int dtype, int B, int H, int W, int c, const int32_t* offsets, int K,
               void* stream) {
    const int64_t s[4] = {sB, sH, sW, sC};
    return bwd_of<true, false>(dtype, e, s, e, s, t, w, m, gs, de, nullptr, B, H, W, c, offsets,
                               K, stream);
}

// db may be null: the teacher's gradient is then skipped.
int cross_wmse2d_bwd(const void* a, int64_t saB, int64_t saH, int64_t saW, int64_t saC,
                     const void* b, int64_t sbB, int64_t sbH, int64_t sbW, int64_t sbC,
                     const float* t, const float* w, const float* m, const float* gs,
                     void* da, void* db, int dtype,
                     int B, int H, int W, int c, const int32_t* offsets, int K, void* stream) {
    const int64_t sa[4] = {saB, saH, saW, saC}, sb[4] = {sbB, sbH, sbW, sbC};
    if (db == nullptr)
        return bwd_of<false, false>(dtype, a, sa, b, sb, t, w, m, gs, da, nullptr, B, H, W, c,
                                    offsets, K, stream);
    return bwd_of<false, true>(dtype, a, sa, b, sb, t, w, m, gs, da, db, B, H, W, c, offsets, K,
                               stream);
}

}  // extern "C"
