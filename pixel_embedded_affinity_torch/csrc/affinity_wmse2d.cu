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
// What it computes. Embeddings a, b: (B, H, W, C) float32 with arbitrary
// element strides (the self loss passes a == b); C = 16, the emd of the
// cvppp preset, the only width training runs. With
//     n = e / max(sqrt(|e|^2 + 1e-36), 1e-12)
// and offsets o_k that look up and left, the affinity is
//     a_k(p) = <n_a(p), n_b(p + o_k)>,  0 where p + o_k lies outside the image.
// t, w, m: (B, K, H, W) float32, contiguous (target, weight, mask).
// Forward: affs (B, K, H, W) = a_k, and the per-offset sums
//     S_k = sum_{b,y,x} w_k (a_k m_k - t_k m_k)^2,
// one (K,) partial per block into partial (n_blocks, K); the wrapper sums
// the partials with torch.sum, so S is the same from run to run (no atomics).
// Backward, given gS (K,) on the device: the WMSE cotangent
//     g_k(q) = gS_k * 2 w_k(q) m_k(q) (a_k(q) m_k(q) - t_k(q) m_k(q))
// is formed in registers from a recomputed a_k (no (B, K, H, W) gradient is
// stored), then
//     dn_a(p) = sum_k g_k(p) n_b(p + o_k),   dn_b(p) = sum_k g_k(p - o_k) n_a(p - o_k)
// and the normalisation's VJP, de = (dn - n <n, dn> [|e| >= eps]) / max(|e|, eps).
// The self loss (a == b) writes de = VJP(dn_a + dn_b); the cross loss
// writes da and db. Gradients go to contiguous (B, C, H, W) buffers, the
// layout of the model's NCHW output.
//
// Bound (B=2, 544x544, C=16, K=10, f32, HBM at 3.35 TB/s). Forward: read e
// (37.9 MB, twice that for cross) and t/w/m (71.0 MB), write affs (23.7 MB):
// ~133 MB, ~40 us self, ~51 us cross. Backward: read e and t/w/m, write de:
// ~147 MB, ~44 us; cross reads two embeddings and writes two: ~223 MB,
// ~66 us. The arithmetic (~2-4 x (3C + 2CK) flops per pixel) needs < 10 us
// at the 67 TFLOP/s float32 rate, so bytes bound all four.
//
// Design, the simple first version, as K1 (affinity2d.cu): one thread per
// pixel, 32x8 blocks along x so loads and stores of a warp are contiguous in
// NCHW, bounds checks in place of the TPU's zero pad and row-tile halo. The
// forward reduces S inside the block (warp shuffles, then one shared-memory
// row per warp). The backward recomputes each neighbour's normalised vector
// for every offset (2K neighbour loads per pixel, mostly from L1/L2); a
// shared-memory tile with the 27-pixel halo is left to a later version.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int C = 16;  // embedding channels
constexpr int kMaxOffsets = 16;
constexpr int kBlockX = 32;
constexpr int kBlockY = 8;
constexpr int kWarps = kBlockX * kBlockY / 32;

struct Offsets {
    int dy[kMaxOffsets];
    int dx[kMaxOffsets];
};

// element strides of a (B, H, W, C) view
struct View {
    const float* p;
    int64_t sB, sH, sW, sC;
    __device__ __forceinline__ const float* at(int b, int y, int x) const {
        return p + b * sB + y * sH + x * sW;
    }
};

__device__ __forceinline__ bool inside(int y, int x, int H, int W) {
    return y >= 0 && y < H && x >= 0 && x < W;
}

// n[c] = v[c] / max(sqrt(sum v^2 + 1e-36), 1e-12); returns the sqrt
__device__ __forceinline__ float load_normalized(const float* __restrict__ v, int64_t sC, float* n) {
    float ss = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
        n[c] = v[c * sC];
        ss += n[c] * n[c];
    }
    const float norm = sqrtf(ss + 1e-36f);
    const float d = fmaxf(norm, 1e-12f);
#pragma unroll
    for (int c = 0; c < C; ++c) n[c] = n[c] / d;
    return norm;
}

__device__ __forceinline__ float dot(const float* u, const float* v) {
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) s += u[c] * v[c];
    return s;
}

__device__ __forceinline__ float wmse_grad(float gs, float a, float t, float w, float m) {
    const float d = a * m - t * m;
    return gs * 2.0f * w * m * d;
}

// de[c] = (dn[c] - n[c] <n, dn> [norm >= eps]) / max(norm, eps), written
// to a contiguous (B, C, H, W) buffer at out + c * plane
__device__ __forceinline__ void store_normalize_vjp(const float* n, float norm, const float* dn,
                                                    float* __restrict__ out, int64_t plane) {
    const float mm = fmaxf(norm, 1e-12f);
    const float proj = norm >= 1e-12f ? dot(n, dn) : 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) out[c * plane] = (dn[c] - n[c] * proj) / mm;
}

__global__ void __launch_bounds__(kBlockX * kBlockY)
wmse_fwd_kernel(View a, View b, const float* __restrict__ t, const float* __restrict__ w,
                const float* __restrict__ m, float* __restrict__ affs, float* __restrict__ partial,
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
    if (in_img) load_normalized(a.at(bi, y, x), a.sC, na);

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
                float nb[C];
                load_normalized(b.at(bi, yy, xx), b.sC, nb);
                v = dot(na, nb);
            }
            const int64_t i = pix + k * plane;
            affs[i] = v;
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

// kSelf: a == b, one output de = VJP(dn_a + dn_b); else da and db
template <bool kSelf>
__global__ void __launch_bounds__(kBlockX * kBlockY)
wmse_bwd_kernel(View a, View b, const float* __restrict__ t, const float* __restrict__ w,
                const float* __restrict__ m, const float* __restrict__ gs,
                float* __restrict__ da, float* __restrict__ db,
                int H, int W, int K, Offsets off) {
    const int x = blockIdx.x * kBlockX + threadIdx.x;
    const int y = blockIdx.y * kBlockY + threadIdx.y;
    const int bi = blockIdx.z;
    if (x >= W || y >= H) return;

    float na[C], nb[C], dna[C], dnb[C];
    const float norm_a = load_normalized(a.at(bi, y, x), a.sC, na);
    float norm_b = norm_a;
#pragma unroll
    for (int c = 0; c < C; ++c) {
        nb[c] = na[c];
        dna[c] = 0.f;
        dnb[c] = 0.f;
    }
    if (!kSelf) norm_b = load_normalized(b.at(bi, y, x), b.sC, nb);

    const int64_t plane = (int64_t)H * W;
    for (int k = 0; k < K; ++k) {
        const float gsk = gs[k];
        const int64_t ik = ((int64_t)bi * K + k) * plane;
        // the pair (p, p + o_k): a_k(p) = <n_a(p), n_b(p + o_k)>
        int yy = y + off.dy[k];
        int xx = x + off.dx[k];
        if (inside(yy, xx, H, W)) {
            float nq[C];
            load_normalized(b.at(bi, yy, xx), b.sC, nq);
            const int64_t i = ik + (int64_t)y * W + x;
            const float g = wmse_grad(gsk, dot(na, nq), t[i], w[i], m[i]);
#pragma unroll
            for (int c = 0; c < C; ++c) dna[c] += g * nq[c];
        }
        // the pair (p - o_k, p): a_k(p - o_k) = <n_a(p - o_k), n_b(p)>
        yy = y - off.dy[k];
        xx = x - off.dx[k];
        if (inside(yy, xx, H, W)) {
            float nr[C];
            load_normalized(a.at(bi, yy, xx), a.sC, nr);
            const int64_t i = ik + (int64_t)yy * W + xx;
            const float g = wmse_grad(gsk, dot(nr, nb), t[i], w[i], m[i]);
#pragma unroll
            for (int c = 0; c < C; ++c) {
                if (kSelf)
                    dna[c] += g * nr[c];
                else
                    dnb[c] += g * nr[c];
            }
        }
    }
    const int64_t out = (int64_t)bi * C * plane + (int64_t)y * W + x;
    store_normalize_vjp(na, norm_a, dna, da + out, plane);
    if (!kSelf) store_normalize_vjp(nb, norm_b, dnb, db + out, plane);
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

int fwd(View a, View b, const float* t, const float* w, const float* m, float* affs,
        float* partial, int B, int H, int W, int c, const int32_t* offsets, int K, void* stream) {
    if (bad_shape(B, H, W, c, K)) return (int)cudaErrorInvalidValue;
    const Offsets off = to_offsets(offsets, K);
    const dim3 block(kBlockX, kBlockY);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    wmse_fwd_kernel<<<grid_of(B, H, W), block, 0, s>>>(a, b, t, w, m, affs, partial, H, W, K, off);
    return (int)cudaGetLastError();
}

template <bool kSelf>
int bwd(View a, View b, const float* t, const float* w, const float* m, const float* gs,
        float* da, float* db, int B, int H, int W, int c, const int32_t* offsets, int K,
        void* stream) {
    if (bad_shape(B, H, W, c, K)) return (int)cudaErrorInvalidValue;
    const Offsets off = to_offsets(offsets, K);
    const dim3 block(kBlockX, kBlockY);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    wmse_bwd_kernel<kSelf><<<grid_of(B, H, W), block, 0, s>>>(a, b, t, w, m, gs, da, db, H, W, K,
                                                              off);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Rows of the forward's partial-sum scratch: one per block.
int64_t wmse2d_partial_rows(int B, int H, int W) {
    const dim3 g = grid_of(B, H, W);
    return (int64_t)g.x * g.y * g.z;
}

// Each entry returns the cudaError_t of its launch (0 on success).
// offsets: host array of K (dy, dx) pairs; gs: device pointer to K floats.
int wmse2d_fwd(const float* e, int64_t sB, int64_t sH, int64_t sW, int64_t sC,
               const float* t, const float* w, const float* m, float* affs, float* partial,
               int B, int H, int W, int c, const int32_t* offsets, int K, void* stream) {
    const View v{e, sB, sH, sW, sC};
    return fwd(v, v, t, w, m, affs, partial, B, H, W, c, offsets, K, stream);
}

int cross_wmse2d_fwd(const float* a, int64_t saB, int64_t saH, int64_t saW, int64_t saC,
                     const float* b, int64_t sbB, int64_t sbH, int64_t sbW, int64_t sbC,
                     const float* t, const float* w, const float* m, float* affs, float* partial,
                     int B, int H, int W, int c, const int32_t* offsets, int K, void* stream) {
    return fwd(View{a, saB, saH, saW, saC}, View{b, sbB, sbH, sbW, sbC}, t, w, m, affs, partial,
               B, H, W, c, offsets, K, stream);
}

int wmse2d_bwd(const float* e, int64_t sB, int64_t sH, int64_t sW, int64_t sC,
               const float* t, const float* w, const float* m, const float* gs, float* de,
               int B, int H, int W, int c, const int32_t* offsets, int K, void* stream) {
    const View v{e, sB, sH, sW, sC};
    return bwd<true>(v, v, t, w, m, gs, de, nullptr, B, H, W, c, offsets, K, stream);
}

int cross_wmse2d_bwd(const float* a, int64_t saB, int64_t saH, int64_t saW, int64_t saC,
                     const float* b, int64_t sbB, int64_t sbH, int64_t sbW, int64_t sbC,
                     const float* t, const float* w, const float* m, const float* gs,
                     float* da, float* db,
                     int B, int H, int W, int c, const int32_t* offsets, int K, void* stream) {
    return bwd<false>(View{a, saB, saH, saW, saC}, View{b, sbB, sbH, sbW, sbC}, t, w, m, gs,
                      da, db, B, H, W, c, offsets, K, stream);
}

}  // extern "C"
