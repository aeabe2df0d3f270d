// A CPU stand-in for the CUDA runtime that lets the port's kernels
// (pixel_embedded_affinity_torch/csrc/*.cu) run as plain C++ for a test:
// every CUDA thread of a block is a ucontext coroutine on one OS thread,
// __syncthreads() and the warp collectives of mma_emu.h yield to a
// scheduler that releases a barrier once every live thread of the block
// (or warp) waits at it, and blocks run one after another. Shared memory is
// one buffer, filled with garbage before each block. Deterministic, and
// quick enough for small shapes.
#pragma once

#include <ucontext.h>

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__
#define __shared__ static  // a static __shared__ array: one for the blocks, which run in turn
#define __align__(n) __attribute__((aligned(n)))

struct dim3 {
    unsigned x, y, z;
    dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline dim3 threadIdx, blockIdx, blockDim, gridDim;

typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
constexpr size_t kSmemMax = 232448;  // a Hopper block's dynamic shared memory
template <class F> cudaError_t cudaFuncSetAttribute(F, int, int bytes) {
    return bytes > (int)kSmemMax ? cudaErrorInvalidValue : cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
inline int emu_sms = 3;  // the emulated card's SMs
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return cudaSuccess; }
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) { *v = emu_sms; return cudaSuccess; }
template <class F> cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int, size_t) {
    *n = 1;
    return cudaSuccess;
}

struct float4 { float x, y, z, w; };
struct uint4 { uint32_t x, y, z, w; };
inline float4 make_float4(float x, float y, float z, float w) { return {x, y, z, w}; }

inline float __uint_as_float(uint32_t u) { float f; std::memcpy(&f, &u, 4); return f; }
inline uint32_t emu_bits(float f) { uint32_t u; std::memcpy(&u, &f, 4); return u; }
inline float fmaxf(float a, float b) { return a > b ? a : b; }
inline float rsqrtf(float x) { return 1.f / std::sqrt(x); }
inline float fminf(float a, float b) { return a < b ? a : b; }
// the rounding intrinsics of conv_i8.cu: one IEEE operation each, round to
// nearest even (g++ contracts nothing across these calls)
inline float __int2float_rn(int i) { return (float)i; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline int __float2int_rn(float x) { return (int)std::nearbyint(x); }
template <class T> T min(T a, T b) { return a < b ? a : b; }

struct __nv_bfloat16 { uint16_t v; };
inline float __bfloat162float(__nv_bfloat16 b) { return __uint_as_float((uint32_t)b.v << 16); }
inline __nv_bfloat16 __float2bfloat16(float f) {  // round to nearest even
    uint32_t u = emu_bits(f);
    u += 0x7FFFu + ((u >> 16) & 1u);
    return {(uint16_t)(u >> 16)};
}

alignas(16) inline unsigned char smem_raw[kSmemMax];
inline size_t emu_smem_bytes = kSmemMax;

// ---- the block scheduler
enum EmuWait { kRunning, kBlockBarrier, kWarpBarrier, kDone };
struct EmuThread {
    ucontext_t ctx;
    std::vector<char> stack;
    EmuWait state = kRunning;
};
inline std::vector<EmuThread> emu_threads;
inline ucontext_t emu_sched;
inline int emu_cur = 0;
inline std::function<void()>* emu_fn = nullptr;

inline void emu_yield(EmuWait why) {
    emu_threads[emu_cur].state = why;
    swapcontext(&emu_threads[emu_cur].ctx, &emu_sched);
}
inline void __syncthreads() { emu_yield(kBlockBarrier); }
inline void emu_warp_sync() { emu_yield(kWarpBarrier); }

// the warp's exchange through a scratch row between two warp barriers
inline float emu_shfl[32][32];
inline float __shfl_xor_sync(unsigned, float v, int mask) {
    float* row = emu_shfl[emu_cur >> 5];
    const int lane = emu_cur & 31;
    row[lane] = v;
    emu_warp_sync();
    const float got = row[lane ^ mask];
    emu_warp_sync();
    return got;
}

inline float __shfl_down_sync(unsigned, float v, int delta) {
    float* row = emu_shfl[emu_cur >> 5];
    const int lane = emu_cur & 31;
    row[lane] = v;
    emu_warp_sync();
    const float got = lane + delta < 32 ? row[lane + delta] : v;
    emu_warp_sync();
    return got;
}

inline void emu_entry() {
    (*emu_fn)();
    emu_threads[emu_cur].state = kDone;
    swapcontext(&emu_threads[emu_cur].ctx, &emu_sched);
}

inline void emu_run_block(dim3 block) {
    const int threads = (int)(block.x * block.y * block.z);
    emu_threads.assign(threads, EmuThread{});
    for (int t = 0; t < threads; ++t) {
        EmuThread& th = emu_threads[t];
        th.stack.resize(256 << 10);
        getcontext(&th.ctx);
        th.ctx.uc_stack.ss_sp = th.stack.data();
        th.ctx.uc_stack.ss_size = th.stack.size();
        th.ctx.uc_link = nullptr;
        makecontext(&th.ctx, emu_entry, 0);
    }
    for (;;) {
        bool ran = false;
        for (int t = 0; t < threads; ++t) {
            if (emu_threads[t].state != kRunning) continue;
            emu_cur = t;
            threadIdx = dim3(t % block.x, t / block.x % block.y, t / (block.x * block.y));
            swapcontext(&emu_sched, &emu_threads[t].ctx);
            ran = true;
        }
        if (ran) continue;
        // nobody can run: release a barrier every live thread waits at
        bool all_done = true, released = false;
        for (const auto& th : emu_threads) all_done &= th.state == kDone;
        if (all_done) return;
        for (int w = 0; w < threads / 32; ++w) {
            bool full = true, any = false;
            for (int l = 0; l < 32; ++l) {
                const EmuWait s = emu_threads[32 * w + l].state;
                full &= s == kWarpBarrier;
                any |= s == kWarpBarrier;
            }
            if (any && !full) { std::fprintf(stderr, "warp %d diverged at a collective\n", w); std::abort(); }
            if (full) {
                for (int l = 0; l < 32; ++l) emu_threads[32 * w + l].state = kRunning;
                released = true;
            }
        }
        if (released) continue;
        bool at_barrier = true;
        for (const auto& th : emu_threads) at_barrier &= th.state == kBlockBarrier || th.state == kDone;
        for (const auto& th : emu_threads)
            if (th.state == kDone && at_barrier) {
                std::fprintf(stderr, "a thread left the block before a __syncthreads()\n");
                std::abort();
            }
        if (!at_barrier) { std::fprintf(stderr, "deadlock\n"); std::abort(); }
        for (auto& th : emu_threads) th.state = kRunning;
    }
}

inline void emu_launch(dim3 grid, dim3 block, size_t smem, cudaStream_t,
                       std::function<void()> fn) {
    if (smem > kSmemMax || (block.x * block.y * block.z) % 32) std::abort();
    emu_smem_bytes = smem;
    emu_fn = &fn;
    blockDim = block;
    gridDim = grid;
    for (unsigned z = 0; z < grid.z; ++z)
        for (unsigned y = 0; y < grid.y; ++y)
            for (unsigned x = 0; x < grid.x; ++x) {
                std::memset(smem_raw, 0xCD, sizeof(smem_raw));
                blockIdx = dim3(x, y, z);
                emu_run_block(block);
            }
}
