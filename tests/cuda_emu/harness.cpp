// One case of the port's conv3x3 or s2d_block kernel on the CPU stand-in,
// against a float64 reference on the same (float32 or bf16-rounded) inputs:
//   harness conv B H W Cin Cout off relu dtype
//   harness k8 B H W c dtype K0 [K1]
// (dtype 0 float32, 1 bfloat16; off 0 is the canvas mode, kept rectangle
// [1, H - 2) x [2, W - 1)). Prints the largest error relative to the
// largest reference output, and for the canvas mode whether every element
// outside the rectangle is exactly 0.
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

int main(int argc, char** argv) {
    std::vector<int> a;
    for (int i = 2; i < argc; ++i) a.push_back(std::atoi(argv[i]));
    if (argc >= 10 && std::string(argv[1]) == "conv") return conv(a[0], a[1], a[2], a[3], a[4], a[5], a[6], a[7]);
    if (argc >= 8 && std::string(argv[1]) == "k8")
        return k8(a[0], a[1], a[2], a[3], a[4], std::vector<int>(a.begin() + 5, a.end()));
    std::fprintf(stderr, "usage: harness conv B H W Cin Cout off relu dtype | k8 B H W c dtype K0 [K1]\n");
    return 2;
}
