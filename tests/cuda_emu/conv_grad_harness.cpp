// One case of csrc/conv_grad.cu's kernels on the CPU stand-in, against a
// float64 reference on the same float32 inputs:
//   conv_grad_harness wgrad B Cin Cout H W ks splits   (splits 0: the kernel's own count)
//   conv_grad_harness dgrad B Cin Cout H W ks
// Runs the case twice, the second time with the grid's blocks in reverse
// order, and prints the first run's largest error relative to the largest
// reference value and whether the two runs gave the same bits:
//   rel_err E bit_equal 0|1 splits S
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <random>
#include <string>
#include <vector>

#include "emu.h"

extern "C" int conv_wgrad_splits(int B, int Cin, int Cout, int H, int W, int ks);
extern "C" int conv_wgrad(const float* x, const float* dy, float* dw, float* work, int B, int Cin,
                          int Cout, int H, int W, int ks, int splits, void* stream);
extern "C" int conv_dgrad(const float* dy, const float* w, float* dx, int B, int Cin, int Cout,
                          int H, int W, int ks, void* stream);

static std::vector<float> randn(size_t n, std::mt19937& rng) {
    std::normal_distribution<double> d(0, 1);
    std::vector<float> v(n);
    for (auto& x : v) x = (float)d(rng);
    return v;
}

int main(int argc, char** argv) {
    if (argc < 8) return 2;
    const std::string mode = argv[1];
    const int B = std::atoi(argv[2]), Cin = std::atoi(argv[3]), Cout = std::atoi(argv[4]),
              H = std::atoi(argv[5]), W = std::atoi(argv[6]), ks = std::atoi(argv[7]);
    const int p = ks / 2, kk = ks * ks;
    std::mt19937 rng(11);
    const std::vector<float> x = randn((size_t)B * Cin * H * W, rng),
                             dy = randn((size_t)B * Cout * H * W, rng),
                             w = randn((size_t)Cout * Cin * kk, rng);
    auto X = [&](int n, int c, int y, int xx) -> double {
        if (y < 0 || y >= H || xx < 0 || xx >= W) return 0.0;
        return x[(((size_t)n * Cin + c) * H + y) * W + xx];
    };
    auto DY = [&](int n, int c, int y, int xx) -> double {
        if (y < 0 || y >= H || xx < 0 || xx >= W) return 0.0;
        return dy[(((size_t)n * Cout + c) * H + y) * W + xx];
    };
    std::vector<double> ref;
    std::vector<float> got[2];
    int splits = 0;
    if (mode == "wgrad") {
        splits = argc > 8 ? std::atoi(argv[8]) : 0;
        if (splits == 0) splits = conv_wgrad_splits(B, Cin, Cout, H, W, ks);
        ref.assign((size_t)Cout * Cin * kk, 0.0);
        for (int co = 0; co < Cout; ++co)
            for (int ci = 0; ci < Cin; ++ci)
                for (int kh = 0; kh < ks; ++kh)
                    for (int kw = 0; kw < ks; ++kw) {
                        double a = 0;
                        for (int n = 0; n < B; ++n)
                            for (int y = 0; y < H; ++y)
                                for (int xx = 0; xx < W; ++xx)
                                    a += DY(n, co, y, xx) * X(n, ci, y + kh - p, xx + kw - p);
                        ref[((size_t)co * Cin + ci) * kk + kh * ks + kw] = a;
                    }
        for (int run = 0; run < 2; ++run) {
            emu_reverse_blocks = run == 1;
            std::vector<float> work((size_t)splits * Cout * Cin * kk, std::nanf(""));
            got[run].assign(ref.size(), std::nanf(""));
            const int err = conv_wgrad(x.data(), dy.data(), got[run].data(), work.data(), B, Cin,
                                       Cout, H, W, ks, splits, nullptr);
            if (err) { std::printf("launch error %d\n", err); return 1; }
        }
    } else if (mode == "dgrad") {
        ref.assign((size_t)B * Cin * H * W, 0.0);
        for (int n = 0; n < B; ++n)
            for (int ci = 0; ci < Cin; ++ci)
                for (int y = 0; y < H; ++y)
                    for (int xx = 0; xx < W; ++xx) {
                        double a = 0;
                        for (int co = 0; co < Cout; ++co)
                            for (int kh = 0; kh < ks; ++kh)
                                for (int kw = 0; kw < ks; ++kw)
                                    a += DY(n, co, y - kh + p, xx - kw + p)
                                         * (double)w[((size_t)co * Cin + ci) * kk + kh * ks + kw];
                        ref[(((size_t)n * Cin + ci) * H + y) * W + xx] = a;
                    }
        for (int run = 0; run < 2; ++run) {
            emu_reverse_blocks = run == 1;
            got[run].assign(ref.size(), std::nanf(""));
            const int err = conv_dgrad(dy.data(), w.data(), got[run].data(), B, Cin, Cout, H, W,
                                       ks, nullptr);
            if (err) { std::printf("launch error %d\n", err); return 1; }
        }
    } else {
        return 2;
    }
    double e = 0, top = 0;
    for (size_t i = 0; i < ref.size(); ++i) {
        top = std::max(top, std::fabs(ref[i]));
        const double d = std::fabs((double)got[0][i] - ref[i]);
        e = std::isnan(d) ? INFINITY : std::max(e, d);
    }
    const bool same = std::memcmp(got[0].data(), got[1].data(), got[0].size() * sizeof(float)) == 0;
    std::printf("rel_err %.3e bit_equal %d splits %d\n", e / top, (int)same, splits);
    return 0;
}
