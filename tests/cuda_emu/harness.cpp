// One case of the port's conv3x3, s2d_block, affinity2d, affinity3d,
// affinity_grad or affinity_wmse2d kernel on the CPU stand-in, against a
// float64 reference on the same (float32 or bf16-rounded) inputs:
//   harness conv B H W Cin Cout off relu dtype
//   harness k8 B H W c dtype K0 [K1]
//   harness k1f B H W C dtype layout dy dx [dy dx ...]
//   harness k5f B D H W C dtype layout [shift...]
//   harness bwd B D H W C dtype layout raw [oz oy ox ...]
//   harness xfwd B D H W C dtype layout_a layout_b [oz oy ox ...]
//   harness xbwd B D H W C dtype layout_a layout_b raw db [oz oy ox ...]
//   harness wfwd B H W dtype cross layout_a layout_b soft dy dx [dy dx ...]
//   harness wbwd B H W dtype cross layout_a layout_b db soft dy dx [dy dx ...]
// (dtype 0 float32, 1 bfloat16; off 0 is the canvas mode, kept rectangle
// [1, H - 2) x [2, W - 1); layout 0 a contiguous (B, D, H, W, C)
// embedding, 1 the (B, C, D, H, W) one seen through permuted strides, 2
// and 3 those two stored with H and W swapped, (B, D, W, H, C) and
// (B, C, D, W, H), as a transposed teacher; no shifts or offsets: the 3D
// shift table; k1f: the 2D affinity forward at D = 1; xbwd's db 0 skips
// the second input's gradient; wfwd and wbwd: the loss-fused WMSE kernels
// of affinity_wmse2d.cu, C = 16, D = 1, the self form (cross 0,
// one embedding) or the cross one, a mask of 0s and 1s or, with soft,
// uniform in [0, 1); wfwd also prints the largest relative error of the
// per-offset sums S). Prints the largest error relative to the largest
// reference output (k1f, k5f, xfwd: the largest absolute error), and
// whether every element that must be exactly 0 is: outside the canvas
// mode's rectangle, or an affinity whose neighbour lies outside or that
// touches the zero vector the affinity cases put at (0, 1, 3, 5) (at
// (0, 0, 3, 5) where D = 1).
#include <algorithm>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <random>
#include <string>
#include <vector>

#include "emu.h"

extern "C" int conv3x3_fwd(const void* x, const void* w, const float* scale, const float* shift,
                           void* out, int dtype, int B, int H, int W, int Cin, int Cout, int off,
                           int r0, int r1, int c0, int c1, int relu, void* stream);
// weak: the z-walk forms (tools/affinity_zwalk.cu) have no 2D kernel
extern "C" __attribute__((weak)) int affinity2d_fwd(
    const void* e, void* out, int dtype, int B, int H, int W, int C, int64_t sB, int64_t sH,
    int64_t sW, int64_t sC, const int32_t* offsets, int K, void* stream);
extern "C" int affinity3d_fwd(const void* e, void* out, int dtype, int B, int D, int H, int W,
                              int C, int64_t sB, int64_t sD, int64_t sH, int64_t sW, int64_t sC,
                              const int32_t* shifts, int K, void* stream);
extern "C" int affinity_bwd(const void* e, const int64_t* se, const void* g, void* de, int dtype,
                            int B, int D, int H, int W, int C, const int32_t* offsets, int K,
                            int raw, void* stream);
// weak: the z-walk forms (tools/affinity_zwalk.cu) have no cross kernels
extern "C" __attribute__((weak)) int cross_affinity_fwd(
    const void* a, const int64_t* sa, const void* b, const int64_t* sb, void* out, int dtype,
    int B, int D, int H, int W, int C, const int32_t* offsets, int K, void* stream);
extern "C" __attribute__((weak)) int cross_affinity_bwd(
    const void* a, const int64_t* sa, const void* b, const int64_t* sb, const void* g, void* da,
    void* db, int dtype, int B, int D, int H, int W, int C, const int32_t* offsets, int K,
    int raw, void* stream);
// weak: only the package's build has the WMSE kernels
extern "C" __attribute__((weak)) int64_t wmse2d_partial_rows(int B, int H, int W);
extern "C" __attribute__((weak)) int wmse2d_fwd(
    const void* e, int64_t sB, int64_t sH, int64_t sW, int64_t sC, const float* t, const float* w,
    const float* m, void* affs, float* partial, int dtype, int B, int H, int W, int c,
    const int32_t* offsets, int K, void* stream);
extern "C" __attribute__((weak)) int cross_wmse2d_fwd(
    const void* a, int64_t saB, int64_t saH, int64_t saW, int64_t saC, const void* b,
    int64_t sbB, int64_t sbH, int64_t sbW, int64_t sbC, const float* t, const float* w,
    const float* m, void* affs, float* partial, int dtype, int B, int H, int W, int c,
    const int32_t* offsets, int K, void* stream);
extern "C" __attribute__((weak)) int wmse2d_bwd(
    const void* e, int64_t sB, int64_t sH, int64_t sW, int64_t sC, const float* t, const float* w,
    const float* m, const float* gs, void* de, int dtype, int B, int H, int W, int c,
    const int32_t* offsets, int K, void* stream);
extern "C" __attribute__((weak)) int cross_wmse2d_bwd(
    const void* a, int64_t saB, int64_t saH, int64_t saW, int64_t saC, const void* b,
    int64_t sbB, int64_t sbH, int64_t sbW, int64_t sbC, const float* t, const float* w,
    const float* m, const float* gs, void* da, void* db, int dtype, int B, int H, int W, int c,
    const int32_t* offsets, int K, void* stream);
extern "C" int s2d_block_fwd(const void* x0, const void* w1p0, int K0, const void* x1,
                             const void* w1p1, int K1, int n_parts, const void* w2,
                             const float* h1, const float* hp, const float* h2, void* out,
                             int dtype, int B, int H, int W, int c, void* stream);

static std::mt19937 rng(7);

static std::vector<float> randn(size_t n, double s) {
    std::normal_distribution<double> d(0, s);
    std::vector<float> v(n);
    for (auto& x : v) x = (float)d(rng);
    return v;
}

// values in the kernel's dtype; f holds them as float
struct Tensor {
    std::vector<float> f;
    std::vector<__nv_bfloat16> b;
    int dt;
    Tensor(std::vector<float> v, int dt) : f(std::move(v)), dt(dt) {
        if (!dt) return;
        b.resize(f.size());
        for (size_t i = 0; i < f.size(); ++i) {
            b[i] = __float2bfloat16(f[i]);
            f[i] = __bfloat162float(b[i]);
        }
    }
    Tensor(size_t n, int dt) : f(n), b(dt ? n : 0), dt(dt) {}
    void* ptr() { return dt ? (void*)b.data() : (void*)f.data(); }
    float at(size_t i) const { return dt ? __bfloat162float(b[i]) : f[i]; }
};

static int conv(int B, int H, int W, int Cin, int Cout, int off, int relu, int dt) {
    Tensor x(randn((size_t)B * H * W * Cin, 1), dt), w(randn(9 * Cin * Cout, 1 / std::sqrt(9.0 * Cin)), dt);
    std::vector<float> sc = randn(Cout, 0.1), sh = randn(Cout, 0.1);
    for (auto& s : sc) s += 1;
    const int r0 = off ? 0 : 1, r1 = off ? H : H - 2, c0 = off ? 0 : 2, c1 = off ? W : W - 1;
    Tensor out((size_t)B * H * W * Cout, dt);
    const int err = conv3x3_fwd(x.ptr(), w.ptr(), sc.data(), sh.data(), out.ptr(), dt, B, H, W,
                                Cin, Cout, off, r0, r1, c0, c1, relu, nullptr);
    if (err) { std::printf("launch error %d\n", err); return 1; }
    double e = 0, top = 0;
    bool zeros = true;
    for (int b = 0; b < B; ++b)
        for (int r = 0; r < H; ++r)
            for (int c = 0; c < W; ++c)
                for (int o = 0; o < Cout; ++o) {
                    double a = 0;
                    for (int dy = 0; dy < 3; ++dy)
                        for (int dx = 0; dx < 3; ++dx) {
                            const int yy = r + dy - off, xx = c + dx - off;
                            if (yy < 0 || yy >= H || xx < 0 || xx >= W) continue;
                            for (int i = 0; i < Cin; ++i)
                                a += (double)w.f[((dy * 3 + dx) * Cin + i) * Cout + o]
                                     * x.f[(((size_t)b * H + yy) * W + xx) * Cin + i];
                        }
                    a = a * sc[o] + sh[o];
                    if (relu) a = std::max(a, 0.0);
                    const bool inside = r >= r0 && r < r1 && c >= c0 && c < c1;
                    const float got = out.at((((size_t)b * H + r) * W + c) * Cout + o);
                    if (!inside) { zeros &= got == 0.f; continue; }
                    e = std::max(e, std::fabs(got - a));
                    top = std::max(top, std::fabs(a));
                }
    std::printf("rel_err %.6e zeros_outside %d\n", e / top, (int)zeros);
    return 0;
}

static int k8(int B, int H, int W, int c, int dt, std::vector<int> Ks) {
    const int H2 = 2 * H, W2 = 2 * W;
    int Kt = 0;
    for (int k : Ks) Kt += k;
    std::vector<Tensor> xs, ws;
    for (int k : Ks) {
        xs.emplace_back(randn((size_t)B * H * W * 4 * k, 1), dt);
        ws.emplace_back(randn(9 * k * 2 * c, 1 / std::sqrt(9.0 * Kt)), dt);
    }
    Tensor w2(randn(9 * c * c, 1 / std::sqrt(9.0 * c)), dt);
    std::vector<float> h1 = randn(c, 0.1), hp = randn(c, 0.1), h2 = randn(c, 0.1);
    Tensor out((size_t)B * H * W * 4 * c, dt);
    const bool two = Ks.size() == 2;
    const int err = s2d_block_fwd(xs[0].ptr(), ws[0].ptr(), Ks[0], two ? xs[1].ptr() : nullptr,
                                  two ? ws[1].ptr() : nullptr, two ? Ks[1] : 0, (int)Ks.size(),
                                  w2.ptr(), h1.data(), hp.data(), h2.data(), out.ptr(), dt, B, H,
                                  W, c, nullptr);
    if (err) { std::printf("launch error %d\n", err); return 1; }
    // the direct image of part p through the s2d address map
    auto X = [&](size_t p, int b, int y, int x, int ch) -> double {
        const int K = Ks[p];
        return xs[p].f[(((size_t)b * H + y / 2) * W + x / 2) * 4 * K + (2 * (y & 1) + (x & 1)) * K + ch];
    };
    std::vector<double> y1((size_t)B * H2 * W2 * c), proj(y1.size());
    for (int b = 0; b < B; ++b)
        for (int y = 0; y < H2; ++y)
            for (int x = 0; x < W2; ++x)
                for (int n = 0; n < 2 * c; ++n) {
                    double a = 0;
                    for (size_t p = 0; p < Ks.size(); ++p)
                        for (int dy = 0; dy < 3; ++dy)
                            for (int dx = 0; dx < 3; ++dx) {
                                const int yy = y + dy - 1, xx = x + dx - 1;
                                if (yy < 0 || yy >= H2 || xx < 0 || xx >= W2) continue;
                                for (int i = 0; i < Ks[p]; ++i)
                                    a += (double)ws[p].f[((dy * 3 + dx) * Ks[p] + i) * 2 * c + n] * X(p, b, yy, xx, i);
                            }
                    const size_t at = (((size_t)b * H2 + y) * W2 + x) * c;
                    if (n < c) {  // y1 rounded to the kernel's dtype, as it keeps it
                        const float v = (float)std::max(a + h1[n], 0.0);
                        y1[at + n] = dt ? __bfloat162float(__float2bfloat16(v)) : v;
                    } else {
                        proj[at + n - c] = a + hp[n - c];
                    }
                }
    double e = 0, top = 0;
    for (int b = 0; b < B; ++b)
        for (int y = 0; y < H2; ++y)
            for (int x = 0; x < W2; ++x)
                for (int n = 0; n < c; ++n) {
                    double a = 0;
                    for (int dy = 0; dy < 3; ++dy)
                        for (int dx = 0; dx < 3; ++dx) {
                            const int yy = y + dy - 1, xx = x + dx - 1;
                            if (yy < 0 || yy >= H2 || xx < 0 || xx >= W2) continue;
                            for (int i = 0; i < c; ++i)
                                a += (double)w2.f[((dy * 3 + dx) * c + i) * c + n]
                                     * y1[(((size_t)b * H2 + yy) * W2 + xx) * c + i];
                        }
                    const double v = std::max(a + h2[n] + proj[(((size_t)b * H2 + y) * W2 + x) * c + n], 0.0);
                    const size_t o = (((size_t)b * H + y / 2) * W + x / 2) * 4 * c + (2 * (y & 1) + (x & 1)) * c + n;
                    e = std::max(e, std::fabs(out.at(o) - v));
                    top = std::max(top, std::fabs(v));
                }
    std::printf("rel_err %.6e zeros_outside 1\n", e / top);
    return 0;
}

// An embedding for the affinity kernels: values in logical (B, D, H, W, C)
// order, stored contiguous (layout 0), as (B, C, D, H, W) (layout 1), or
// as either with H and W swapped (layouts 2 and 3), a zero vector at
// (0, 1, 3, 5) clamped into the volume
struct Embedding {
    int B, D, H, W, C;
    Tensor t;
    int64_t s[5];
    int zero[4];
    Embedding(int B, int D, int H, int W, int C, int dt, int layout)
        : B(B), D(D), H(H), W(W), C(C), t(randn((size_t)B * D * H * W * C, 1), dt) {
        zero[0] = 0; zero[1] = std::min(1, D - 1); zero[2] = std::min(3, H - 1); zero[3] = std::min(5, W - 1);
        const int64_t vol = (int64_t)D * H * W;
        // a plane's y and x strides: x the faster axis, or y when swapped
        const int64_t sy = layout >= 2 ? 1 : W, sx = layout >= 2 ? H : 1;
        if (layout % 2) { s[0] = C * vol; s[1] = (int64_t)H * W; s[2] = sy; s[3] = sx; s[4] = vol; }
        else { s[4] = 1; s[3] = sx * C; s[2] = sy * C; s[1] = (int64_t)H * W * C; s[0] = vol * C; }
        for (int c = 0; c < C; ++c) set(zero[0], zero[1], zero[2], zero[3], c, 0.f);
    }
    size_t at(int b, int z, int y, int x, int c) const {
        return (size_t)(b * s[0] + z * s[1] + y * s[2] + x * s[3] + c * s[4]);
    }
    void set(int b, int z, int y, int x, int c, float v) {
        const size_t i = at(b, z, y, x, c);
        if (t.dt) { t.b[i] = __float2bfloat16(v); t.f[i] = __bfloat162float(t.b[i]); } else t.f[i] = v;
    }
    bool inside(int z, int y, int x) const { return z >= 0 && z < D && y >= 0 && y < H && x >= 0 && x < W; }
    // the vector at a voxel, normalised unless raw, and its norm
    double vec(int b, int z, int y, int x, bool raw, std::vector<double>& n) const {
        double ss = 0;
        n.assign(C, 0);
        for (int c = 0; c < C; ++c) { n[c] = t.f[at(b, z, y, x, c)]; ss += n[c] * n[c]; }
        const double norm = std::sqrt(ss + 1e-36);
        if (!raw) for (auto& v : n) v /= std::max(norm, 1e-12);
        return norm;
    }
    bool is_zero(int b, int z, int y, int x) const {
        return b == zero[0] && z == zero[1] && y == zero[2] && x == zero[3];
    }
};

// a_k(p) = <n(p), n(p + o_k)>, 0 outside, against affinity2d_fwd (D = 1,
// offsets (dy, dx))
static int k1f(int B, int H, int W, int C, int dt, int layout, std::vector<int> o) {
    if (!affinity2d_fwd) { std::printf("no 2D kernel\n"); return 1; }
    const int K = (int)o.size() / 2;
    Embedding e(B, 1, H, W, C, dt, layout);
    Tensor out((size_t)B * K * H * W, dt);
    const int err = affinity2d_fwd(e.t.ptr(), out.ptr(), dt, B, H, W, C, e.s[0], e.s[2], e.s[3],
                                   e.s[4], o.data(), K, nullptr);
    if (err) { std::printf("launch error %d\n", err); return 1; }
    double worst = 0;
    bool zeros = true;
    std::vector<double> n0, n1;
    for (int b = 0; b < B; ++b)
        for (int y = 0; y < H; ++y)
            for (int x = 0; x < W; ++x) {
                e.vec(b, 0, y, x, false, n0);
                for (int k = 0; k < K; ++k) {
                    const int yy = y + o[2 * k], xx = x + o[2 * k + 1];
                    const bool in = e.inside(0, yy, xx);
                    double a = 0;
                    if (in) {
                        e.vec(b, 0, yy, xx, false, n1);
                        for (int c = 0; c < C; ++c) a += n0[c] * n1[c];
                    }
                    const float got = out.at((((size_t)b * K + k) * H + y) * W + x);
                    if (!in || e.is_zero(b, 0, y, x) || e.is_zero(b, 0, yy, xx))
                        zeros &= got == 0.f;
                    worst = std::max(worst, std::fabs(got - a));
                }
            }
    std::printf("abs_err %.6e zeros_outside %d\n", worst, (int)zeros);
    return 0;
}

static const int kShifts3D[12] = {1, 1, 1, 2, 3, 3, 3, 9, 9, 4, 27, 27};

static int k5f(int B, int D, int H, int W, int C, int dt, int layout, std::vector<int> shifts) {
    if (shifts.empty()) shifts.assign(kShifts3D, kShifts3D + 12);
    const int K = (int)shifts.size();
    Embedding e(B, D, H, W, C, dt, layout);
    Tensor out((size_t)B * K * D * H * W, dt);
    const int err = affinity3d_fwd(e.t.ptr(), out.ptr(), dt, B, D, H, W, C, e.s[0], e.s[1], e.s[2],
                                   e.s[3], e.s[4], shifts.data(), K, nullptr);
    if (err) { std::printf("launch error %d\n", err); return 1; }
    double worst = 0;
    bool zeros = true;
    std::vector<double> n0, n1;
    for (int b = 0; b < B; ++b)
        for (int z = 0; z < D; ++z)
            for (int y = 0; y < H; ++y)
                for (int x = 0; x < W; ++x) {
                    e.vec(b, z, y, x, false, n0);
                    for (int k = 0; k < K; ++k) {
                        int q[3] = {z, y, x};
                        q[k % 3] -= shifts[k];
                        double a = 0;
                        const bool in = e.inside(q[0], q[1], q[2]);
                        if (in) {
                            e.vec(b, q[0], q[1], q[2], false, n1);
                            for (int c = 0; c < C; ++c) a += n0[c] * n1[c];
                        }
                        const float got = out.at(((((size_t)b * K + k) * D + z) * H + y) * W + x);
                        if (!in || e.is_zero(b, z, y, x) || e.is_zero(b, q[0], q[1], q[2]))
                            zeros &= got == 0.f;
                        worst = std::max(worst, std::fabs(got - a));
                    }
                }
    std::printf("abs_err %.6e zeros_outside %d\n", worst, (int)zeros);
    return 0;
}

// The largest error of a (B, C, D, H, W) gradient against its float64
// reference: relative to the largest reference value, the zero vector's
// voxel relative to its own largest
struct GradErr {
    double rest = 0, top = 0, zd = 0, ztop = 0;
    void add(double got, double ref, bool at_zero) {
        const double d = std::fabs(got - ref);
        if (at_zero) { zd = std::max(zd, d); ztop = std::max(ztop, std::fabs(ref)); }
        else { rest = std::max(rest, d); top = std::max(top, std::fabs(ref)); }
    }
    double rel() const { return rest / top; }
    double at_zero() const { return ztop > 0 ? zd / ztop : zd; }
};

// the 3D shift table as (oz, oy, ox) offsets when o is empty
static std::vector<int> offsets_or_3d(std::vector<int> o) {
    if (o.empty())
        for (int k = 0; k < 12; ++k) {
            int v[3] = {0, 0, 0};
            v[k % 3] = -kShifts3D[k];
            o.insert(o.end(), v, v + 3);
        }
    return o;
}

static int bwd(int B, int D, int H, int W, int C, int dt, int layout, int raw, std::vector<int> o) {
    o = offsets_or_3d(o);
    const int K = (int)o.size() / 3;
    Embedding e(B, D, H, W, C, dt, layout);
    const size_t vol = (size_t)D * H * W;
    Tensor g(randn((size_t)B * K * vol, 1), dt), de((size_t)B * C * vol, dt);
    const int err = affinity_bwd(e.t.ptr(), e.s, g.ptr(), de.ptr(), dt, B, D, H, W, C, o.data(), K,
                                 raw, nullptr);
    if (err) { std::printf("launch error %d\n", err); return 1; }
    auto G = [&](int b, int k, int z, int y, int x) { return (double)g.f[(((size_t)b * K + k) * D + z) * H * W + (size_t)y * W + x]; };
    GradErr err_de;
    std::vector<double> n0, nq, dn(C);
    for (int b = 0; b < B; ++b)
        for (int z = 0; z < D; ++z)
            for (int y = 0; y < H; ++y)
                for (int x = 0; x < W; ++x) {
                    const double norm = e.vec(b, z, y, x, raw, n0);
                    std::fill(dn.begin(), dn.end(), 0.0);
                    for (int k = 0; k < K; ++k) {
                        const int oz = o[3 * k], oy = o[3 * k + 1], ox = o[3 * k + 2];
                        if (e.inside(z + oz, y + oy, x + ox)) {
                            e.vec(b, z + oz, y + oy, x + ox, raw, nq);
                            for (int c = 0; c < C; ++c) dn[c] += G(b, k, z, y, x) * nq[c];
                        }
                        if (e.inside(z - oz, y - oy, x - ox)) {
                            e.vec(b, z - oz, y - oy, x - ox, raw, nq);
                            for (int c = 0; c < C; ++c) dn[c] += G(b, k, z - oz, y - oy, x - ox) * nq[c];
                        }
                    }
                    double proj = 0;
                    if (!raw && norm >= 1e-12)
                        for (int c = 0; c < C; ++c) proj += n0[c] * dn[c];
                    const double mm = raw ? 1.0 : std::max(norm, 1e-12);
                    for (int c = 0; c < C; ++c)
                        err_de.add(de.at((((size_t)b * C + c) * D + z) * H * W + (size_t)y * W + x),
                                   (dn[c] - n0[c] * proj) / mm, e.is_zero(b, z, y, x));
                }
    std::printf("rel_err %.6e zeros_outside 1 (rest %.3e, zero vector %.3e)\n",
                std::max(err_de.rel(), err_de.at_zero()), err_de.rel(), err_de.at_zero());
    return 0;
}

// a_k(p) = <n_a(p), n_b(p + o_k)>, 0 outside, against cross_affinity_fwd
static int xfwd(int B, int D, int H, int W, int C, int dt, int la, int lb, std::vector<int> o) {
    if (!cross_affinity_fwd) { std::printf("no cross kernels\n"); return 1; }
    o = offsets_or_3d(o);
    const int K = (int)o.size() / 3;
    Embedding a(B, D, H, W, C, dt, la), b(B, D, H, W, C, dt, lb);
    Tensor out((size_t)B * K * D * H * W, dt);
    const int err = cross_affinity_fwd(a.t.ptr(), a.s, b.t.ptr(), b.s, out.ptr(), dt, B, D, H, W,
                                       C, o.data(), K, nullptr);
    if (err) { std::printf("launch error %d\n", err); return 1; }
    double worst = 0;
    bool zeros = true;
    std::vector<double> na, nb;
    for (int bi = 0; bi < B; ++bi)
        for (int z = 0; z < D; ++z)
            for (int y = 0; y < H; ++y)
                for (int x = 0; x < W; ++x) {
                    a.vec(bi, z, y, x, false, na);
                    for (int k = 0; k < K; ++k) {
                        const int zz = z + o[3 * k], yy = y + o[3 * k + 1], xx = x + o[3 * k + 2];
                        const bool in = b.inside(zz, yy, xx);
                        double ref = 0;
                        if (in) {
                            b.vec(bi, zz, yy, xx, false, nb);
                            for (int c = 0; c < C; ++c) ref += na[c] * nb[c];
                        }
                        const float got = out.at(((((size_t)bi * K + k) * D + z) * H + y) * W + x);
                        if (!in || a.is_zero(bi, z, y, x) || b.is_zero(bi, zz, yy, xx))
                            zeros &= got == 0.f;
                        worst = std::max(worst, std::fabs(got - ref));
                    }
                }
    std::printf("abs_err %.6e zeros_outside %d\n", worst, (int)zeros);
    return 0;
}

// (da, db) of sum(g * a) for the cross affinities, against cross_affinity_bwd
static int xbwd(int B, int D, int H, int W, int C, int dt, int la, int lb, int raw, int with_db,
                std::vector<int> o) {
    if (!cross_affinity_bwd) { std::printf("no cross kernels\n"); return 1; }
    o = offsets_or_3d(o);
    const int K = (int)o.size() / 3;
    Embedding a(B, D, H, W, C, dt, la), b(B, D, H, W, C, dt, lb);
    const size_t vol = (size_t)D * H * W;
    Tensor g(randn((size_t)B * K * vol, 1), dt), da((size_t)B * C * vol, dt), db((size_t)B * C * vol, dt);
    const int err = cross_affinity_bwd(a.t.ptr(), a.s, b.t.ptr(), b.s, g.ptr(), da.ptr(),
                                       with_db ? db.ptr() : nullptr, dt, B, D, H, W, C, o.data(),
                                       K, raw, nullptr);
    if (err) { std::printf("launch error %d\n", err); return 1; }
    auto G = [&](int bi, int k, int z, int y, int x) { return (double)g.f[(((size_t)bi * K + k) * D + z) * H * W + (size_t)y * W + x]; };
    GradErr ea, eb;
    std::vector<double> n0, nq, dn(C);
    // the gradient of one input e at one voxel: its dn from the other input o's neighbours at
    // p + sign * o_k, each with the cotangent at the pair's first voxel, then the VJP
    auto grad = [&](const Embedding& e, const Embedding& other, int sign, const Tensor& out,
                    GradErr& ge, int bi, int z, int y, int x) {
        const double norm = e.vec(bi, z, y, x, raw, n0);
        std::fill(dn.begin(), dn.end(), 0.0);
        for (int k = 0; k < K; ++k) {
            const int zz = z + sign * o[3 * k], yy = y + sign * o[3 * k + 1], xx = x + sign * o[3 * k + 2];
            if (!other.inside(zz, yy, xx)) continue;
            other.vec(bi, zz, yy, xx, raw, nq);
            const double gk = sign > 0 ? G(bi, k, z, y, x) : G(bi, k, zz, yy, xx);
            for (int c = 0; c < C; ++c) dn[c] += gk * nq[c];
        }
        double proj = 0;
        if (!raw && norm >= 1e-12)
            for (int c = 0; c < C; ++c) proj += n0[c] * dn[c];
        const double mm = raw ? 1.0 : std::max(norm, 1e-12);
        for (int c = 0; c < C; ++c)
            ge.add(out.at((((size_t)bi * C + c) * D + z) * H * W + (size_t)y * W + x),
                   (dn[c] - n0[c] * proj) / mm, e.is_zero(bi, z, y, x));
    };
    for (int bi = 0; bi < B; ++bi)
        for (int z = 0; z < D; ++z)
            for (int y = 0; y < H; ++y)
                for (int x = 0; x < W; ++x) {
                    grad(a, b, 1, da, ea, bi, z, y, x);
                    if (with_db) grad(b, a, -1, db, eb, bi, z, y, x);
                }
    double rel = std::max(ea.rel(), ea.at_zero());
    if (with_db) rel = std::max(rel, std::max(eb.rel(), eb.at_zero()));
    std::printf("rel_err %.6e zeros_outside 1 (da %.3e, %.3e at the zero vector; db %.3e, %.3e)\n",
                rel, ea.rel(), ea.at_zero(), with_db ? eb.rel() : 0.0, with_db ? eb.at_zero() : 0.0);
    return 0;
}

// The loss-fused WMSE case's inputs: embeddings a and b (b is a for the
// self form), each a D = 1 Embedding of C = 16 in its layout and dtype,
// the (dy, dx) table, and t, w, m (B, K, H, W) and gS (K,), float32
struct WmseCase {
    int B, H, W, K, dt;
    bool cross;
    Embedding a, b;
    std::vector<int> o;
    std::vector<float> t, w, m, gs;
    WmseCase(int B, int H, int W, int dt, int cross, int la, int lb, int soft,
             std::vector<int> offs)
        : B(B), H(H), W(W), K((int)offs.size() / 2), dt(dt), cross(cross != 0),
          a(B, 1, H, W, 16, dt, la), b(B, 1, H, W, 16, dt, lb), o(std::move(offs)) {
        const size_t n = (size_t)B * K * H * W;
        std::uniform_real_distribution<float> u(0.f, 1.f);
        t.resize(n), w.resize(n), m.resize(n), gs.resize(K);
        for (size_t i = 0; i < n; ++i) {
            t[i] = u(rng) > 0.5f ? 1.f : 0.f;
            w[i] = u(rng) * 2.f + 0.05f;
            m[i] = soft ? u(rng) : (u(rng) > 0.2f ? 1.f : 0.f);
        }
        for (auto& g : gs) g = u(rng) / (2.f * W) + 1e-4f;
    }
    const Embedding& second() const { return cross ? b : a; }
    size_t at(int bi, int k, int y, int x) const { return (((size_t)bi * K + k) * H + y) * W + x; }
    bool inside(int y, int x) const { return y >= 0 && y < H && x >= 0 && x < W; }
    // a_k(p) = <n_a(p), n_b(p + o_k)> in float64, 0 outside
    double aff(int bi, int k, int y, int x) const {
        const int yy = y + o[2 * k], xx = x + o[2 * k + 1];
        if (!inside(yy, xx)) return 0;
        std::vector<double> na, nb;
        a.vec(bi, 0, y, x, false, na);
        second().vec(bi, 0, yy, xx, false, nb);
        double s = 0;
        for (int c = 0; c < 16; ++c) s += na[c] * nb[c];
        return s;
    }
    // the WMSE cotangent g_k(q) in float64
    double cot(int bi, int k, int y, int x) const {
        const size_t i = at(bi, k, y, x);
        return gs[k] * 2.0 * w[i] * m[i] * (aff(bi, k, y, x) * m[i] - (double)t[i] * m[i]);
    }
};

// affs and S of wmse2d_fwd / cross_wmse2d_fwd against float64
static int wfwd(int B, int H, int W, int dt, int cross, int la, int lb, int soft,
                std::vector<int> o) {
    if (!wmse2d_fwd) { std::printf("no WMSE kernels\n"); return 1; }
    WmseCase cs(B, H, W, dt, cross, la, lb, soft, o);
    const int K = cs.K;
    Tensor affs(std::vector<float>((size_t)B * K * H * W, -1.f), dt);
    std::vector<float> partial((size_t)wmse2d_partial_rows(B, H, W) * K);
    const int64_t* sa = cs.a.s;
    const int64_t* sb = cs.second().s;
    const int err = cross
        ? cross_wmse2d_fwd(cs.a.t.ptr(), sa[0], sa[2], sa[3], sa[4], cs.b.t.ptr(), sb[0], sb[2],
                           sb[3], sb[4], cs.t.data(), cs.w.data(), cs.m.data(), affs.ptr(),
                           partial.data(), dt, B, H, W, 16, cs.o.data(), K, nullptr)
        : wmse2d_fwd(cs.a.t.ptr(), sa[0], sa[2], sa[3], sa[4], cs.t.data(), cs.w.data(),
                     cs.m.data(), affs.ptr(), partial.data(), dt, B, H, W, 16, cs.o.data(), K,
                     nullptr);
    if (err) { std::printf("launch error %d\n", err); return 1; }
    double worst = 0, s_rel = 0, p_rel = 0;
    bool zeros = true;
    std::vector<double> S(K, 0.0);
    for (int bi = 0; bi < B; ++bi)
        for (int k = 0; k < K; ++k)
            for (int y = 0; y < H; ++y)
                for (int x = 0; x < W; ++x) {
                    const size_t i = cs.at(bi, k, y, x);
                    const double ref = cs.aff(bi, k, y, x);
                    const int yy = y + o[2 * k], xx = x + o[2 * k + 1];
                    const float got = affs.at(i);
                    if (!cs.inside(yy, xx) || cs.a.is_zero(bi, 0, y, x) ||
                        cs.second().is_zero(bi, 0, yy, xx))
                        zeros &= got == 0.f;
                    worst = std::max(worst, std::fabs(got - ref));
                    const double d = ref * cs.m[i] - (double)cs.t[i] * cs.m[i];
                    S[k] += cs.w[i] * d * d;
                }
    // S_k as the wrapper sums it, the partials in float32; and their sum in
    // float64, the kernel's block sums alone
    const size_t rows = partial.size() / K;
    for (int k = 0; k < K; ++k) {
        float f = 0.f;
        double dsum = 0;
        for (size_t r = 0; r < rows; ++r) {
            f += partial[r * K + k];
            dsum += partial[r * K + k];
        }
        s_rel = std::max(s_rel, std::fabs(f - S[k]) / S[k]);
        p_rel = std::max(p_rel, std::fabs(dsum - S[k]) / S[k]);
    }
    std::printf("abs_err %.6e zeros_outside %d s_rel %.6e partial_rel %.6e\n", worst, (int)zeros,
                s_rel, p_rel);
    return 0;
}

// de (self) or da and, with db, db (cross) of sum_k gS_k S_k against
// wmse2d_bwd / cross_wmse2d_bwd
static int wbwd(int B, int H, int W, int dt, int cross, int la, int lb, int with_db, int soft,
                std::vector<int> o) {
    if (!wmse2d_bwd) { std::printf("no WMSE kernels\n"); return 1; }
    WmseCase cs(B, H, W, dt, cross, la, lb, soft, o);
    const int K = cs.K;
    const size_t n = (size_t)B * 16 * H * W;
    Tensor da(std::vector<float>(n, NAN), dt), db(std::vector<float>(n, NAN), dt);
    const int64_t* sa = cs.a.s;
    const int64_t* sb = cs.second().s;
    const int err = cross
        ? cross_wmse2d_bwd(cs.a.t.ptr(), sa[0], sa[2], sa[3], sa[4], cs.b.t.ptr(), sb[0], sb[2],
                           sb[3], sb[4], cs.t.data(), cs.w.data(), cs.m.data(), cs.gs.data(),
                           da.ptr(), with_db ? db.ptr() : nullptr, dt, B, H, W, 16, cs.o.data(),
                           K, nullptr)
        : wmse2d_bwd(cs.a.t.ptr(), sa[0], sa[2], sa[3], sa[4], cs.t.data(), cs.w.data(),
                     cs.m.data(), cs.gs.data(), da.ptr(), dt, B, H, W, 16, cs.o.data(), K,
                     nullptr);
    if (err) { std::printf("launch error %d\n", err); return 1; }
    // float64 cotangents, once
    std::vector<double> g((size_t)B * K * H * W);
    for (int bi = 0; bi < B; ++bi)
        for (int k = 0; k < K; ++k)
            for (int y = 0; y < H; ++y)
                for (int x = 0; x < W; ++x) g[cs.at(bi, k, y, x)] = cs.cot(bi, k, y, x);
    GradErr ea, eb;
    std::vector<double> n0, nq, dna(16), dnb(16);
    // the normalisation's VJP of dn at one pixel of e, against out
    auto vjp = [&](const Embedding& e, const std::vector<double>& dn, const Tensor& out,
                   GradErr& ge, int bi, int y, int x) {
        const double norm = e.vec(bi, 0, y, x, false, n0);
        double proj = 0;
        if (norm >= 1e-12)
            for (int c = 0; c < 16; ++c) proj += n0[c] * dn[c];
        for (int c = 0; c < 16; ++c)
            ge.add(out.at((((size_t)bi * 16 + c) * H + y) * W + x),
                   (dn[c] - n0[c] * proj) / std::max(norm, 1e-12), e.is_zero(bi, 0, y, x));
    };
    for (int bi = 0; bi < B; ++bi)
        for (int y = 0; y < H; ++y)
            for (int x = 0; x < W; ++x) {
                std::fill(dna.begin(), dna.end(), 0.0);
                std::fill(dnb.begin(), dnb.end(), 0.0);
                for (int k = 0; k < K; ++k) {
                    const int dy = o[2 * k], dx = o[2 * k + 1];
                    if (cs.inside(y + dy, x + dx)) {  // dn_a(p) += g_k(p) n_b(p + o_k)
                        cs.second().vec(bi, 0, y + dy, x + dx, false, nq);
                        for (int c = 0; c < 16; ++c) dna[c] += g[cs.at(bi, k, y, x)] * nq[c];
                    }
                    if (cs.inside(y - dy, x - dx)) {  // dn_b(p) += g_k(p - o_k) n_a(p - o_k)
                        cs.a.vec(bi, 0, y - dy, x - dx, false, nq);
                        for (int c = 0; c < 16; ++c)
                            dnb[c] += g[cs.at(bi, k, y - dy, x - dx)] * nq[c];
                    }
                }
                if (!cross)
                    for (int c = 0; c < 16; ++c) dna[c] += dnb[c];
                vjp(cs.a, dna, da, ea, bi, y, x);
                if (cross && with_db) vjp(cs.b, dnb, db, eb, bi, y, x);
            }
    const bool two = cross && with_db;
    double rel = std::max(ea.rel(), ea.at_zero());
    if (two) rel = std::max(rel, std::max(eb.rel(), eb.at_zero()));
    std::printf("rel_err %.6e zeros_outside 1 (da %.3e, %.3e at the zero vector; db %.3e, %.3e)\n",
                rel, ea.rel(), ea.at_zero(), two ? eb.rel() : 0.0, two ? eb.at_zero() : 0.0);
    return 0;
}

int main(int argc, char** argv) {
    std::vector<int> a;
    for (int i = 2; i < argc; ++i) a.push_back(std::atoi(argv[i]));
    if (argc >= 10 && std::string(argv[1]) == "conv") return conv(a[0], a[1], a[2], a[3], a[4], a[5], a[6], a[7]);
    if (argc >= 8 && std::string(argv[1]) == "k8")
        return k8(a[0], a[1], a[2], a[3], a[4], std::vector<int>(a.begin() + 5, a.end()));
    if (argc >= 10 && std::string(argv[1]) == "k1f")
        return k1f(a[0], a[1], a[2], a[3], a[4], a[5], std::vector<int>(a.begin() + 6, a.end()));
    if (argc >= 9 && std::string(argv[1]) == "k5f")
        return k5f(a[0], a[1], a[2], a[3], a[4], a[5], a[6], std::vector<int>(a.begin() + 7, a.end()));
    if (argc >= 10 && std::string(argv[1]) == "bwd")
        return bwd(a[0], a[1], a[2], a[3], a[4], a[5], a[6], a[7], std::vector<int>(a.begin() + 8, a.end()));
    if (argc >= 10 && std::string(argv[1]) == "xfwd")
        return xfwd(a[0], a[1], a[2], a[3], a[4], a[5], a[6], a[7], std::vector<int>(a.begin() + 8, a.end()));
    if (argc >= 12 && std::string(argv[1]) == "xbwd")
        return xbwd(a[0], a[1], a[2], a[3], a[4], a[5], a[6], a[7], a[8], a[9],
                    std::vector<int>(a.begin() + 10, a.end()));
    if (argc >= 12 && std::string(argv[1]) == "wfwd")
        return wfwd(a[0], a[1], a[2], a[3], a[4], a[5], a[6], a[7],
                    std::vector<int>(a.begin() + 8, a.end()));
    if (argc >= 13 && std::string(argv[1]) == "wbwd")
        return wbwd(a[0], a[1], a[2], a[3], a[4], a[5], a[6], a[7], a[8],
                    std::vector<int>(a.begin() + 9, a.end()));
    std::fprintf(stderr, "usage: harness conv B H W Cin Cout off relu dtype | k8 B H W c dtype K0 [K1]"
                         " | k1f B H W C dtype layout dy dx [dy dx...]"
                         " | k5f B D H W C dtype layout [shift...] | bwd B D H W C dtype layout raw [oz oy ox...]"
                         " | xfwd B D H W C dtype la lb [oz oy ox...] | xbwd B D H W C dtype la lb raw db [oz oy ox...]"
                         " | wfwd B H W dtype cross la lb soft dy dx [dy dx...]"
                         " | wbwd B H W dtype cross la lb db soft dy dx [dy dx...]\n");
    return 2;
}
