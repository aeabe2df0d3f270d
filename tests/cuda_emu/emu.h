// A CPU stand-in for the CUDA runtime that lets the port's kernels
// (pixel_embedded_affinity_torch/csrc/*.cu) run as plain C++ for a test:
// every CUDA thread of a block is a ucontext coroutine on one OS thread,
// __syncthreads() and the warp collectives of mma_emu.h yield to a
// scheduler that releases a barrier once every live thread of the block
// (or warp) waits at it, and blocks run one after another. Shared memory is
// one buffer, filled with garbage before each block. Deterministic, and
// quick enough for small shapes. For hopper_emu.h it also keeps mbarriers
// (a thread waiting on one sleeps until its phase completes), 128-thread
// warpgroup barriers, each thread's wgmma groups in flight, and the
// driver's tensor maps (cuTensorMapEncodeTiled through
// cudaGetDriverEntryPointByVersion, checking what the driver checks).
#pragma once

#include <ucontext.h>

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <algorithm>
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
#define __grid_constant__
#define CUDART_VERSION 12080

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

struct alignas(16) float4 { float x, y, z, w; };
struct alignas(16) uint4 { uint32_t x, y, z, w; };
struct alignas(16) int4 { int x, y, z, w; };
struct alignas(8) int2 { int x, y; };
inline float4 make_float4(float x, float y, float z, float w) { return {x, y, z, w}; }
inline uint4 make_uint4(uint32_t x, uint32_t y, uint32_t z, uint32_t w) { return {x, y, z, w}; }
inline int2 make_int2(int x, int y) { return {x, y}; }

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

// aligned to 1024 bytes, the period of the 128-byte swizzle, as the shared
// window's offsets are on the card
// ---- the driver's tensor maps (cuda.h), as the stand-in TMA of
// hopper_emu.h reads them: int8 elements, element strides of 1, zero fill
typedef uint32_t cuuint32_t;
typedef uint64_t cuuint64_t;
typedef int CUresult;
enum { CUDA_SUCCESS = 0, CUDA_ERROR_INVALID_VALUE = 1 };
enum CUtensorMapDataType { CU_TENSOR_MAP_DATA_TYPE_UINT8 = 0 };
enum CUtensorMapInterleave { CU_TENSOR_MAP_INTERLEAVE_NONE = 0 };
enum CUtensorMapSwizzle { CU_TENSOR_MAP_SWIZZLE_NONE = 0, CU_TENSOR_MAP_SWIZZLE_32B,
                          CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_SWIZZLE_128B };
enum CUtensorMapL2promotion { CU_TENSOR_MAP_L2_PROMOTION_NONE = 0, CU_TENSOR_MAP_L2_PROMOTION_L2_64B,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B };
enum CUtensorMapFloatOOBfill { CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE = 0 };
struct alignas(64) CUtensorMap {
    const unsigned char* base;
    int rank, swizzle;  // swizzle in bytes, 0 for none
    uint64_t dims[5], strides[5];  // strides[i]: bytes of dimension i + 1
    uint32_t box[5];
};

// The checks of cuTensorMapEncodeTiled (CUDA driver API) for this case.
inline CUresult emu_encode_tiled(CUtensorMap* m, CUtensorMapDataType type, cuuint32_t rank,
                                 void* base, const cuuint64_t* dims, const cuuint64_t* strides,
                                 const cuuint32_t* box, const cuuint32_t* estrides,
                                 CUtensorMapInterleave il, CUtensorMapSwizzle sw,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill fill) {
    if (type != CU_TENSOR_MAP_DATA_TYPE_UINT8 || il != CU_TENSOR_MAP_INTERLEAVE_NONE ||
        fill != CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE || rank < 1 || rank > 5 ||
        reinterpret_cast<uintptr_t>(base) % 16)
        return CUDA_ERROR_INVALID_VALUE;
    const int span[4] = {0, 32, 64, 128};
    *m = CUtensorMap{static_cast<const unsigned char*>(base), (int)rank, span[sw], {}, {}, {}};
    for (cuuint32_t i = 0; i < rank; ++i) {
        if (dims[i] < 1 || dims[i] > (1ull << 32) || box[i] < 1 || box[i] > 256 ||
            estrides[i] != 1)
            return CUDA_ERROR_INVALID_VALUE;
        if (i > 0 && (strides[i - 1] % 16 || strides[i - 1] >= (1ull << 40)))
            return CUDA_ERROR_INVALID_VALUE;
        m->dims[i] = dims[i];
        m->box[i] = box[i];
        if (i > 0) m->strides[i - 1] = strides[i - 1];
    }
    if (box[0] % 16 || (m->swizzle && (int)box[0] > m->swizzle)) return CUDA_ERROR_INVALID_VALUE;
    return CUDA_SUCCESS;
}

enum cudaDriverEntryPointQueryResult { cudaDriverEntryPointSuccess = 0,
                                       cudaDriverEntryPointSymbolNotFound = 1 };
enum { cudaEnableDefault = 0 };
inline cudaError_t cudaGetDriverEntryPointByVersion(const char* symbol, void** fn, unsigned,
                                                    unsigned long long,
                                                    cudaDriverEntryPointQueryResult* q) {
    const bool known = std::strcmp(symbol, "cuTensorMapEncodeTiled") == 0;
    *fn = known ? reinterpret_cast<void*>(&emu_encode_tiled) : nullptr;
    *q = known ? cudaDriverEntryPointSuccess : cudaDriverEntryPointSymbolNotFound;
    return cudaSuccess;
}

alignas(1024) inline unsigned char smem_raw[kSmemMax];
inline size_t emu_smem_bytes = kSmemMax;

// ---- the block scheduler
enum EmuWait { kRunning, kBlockBarrier, kWarpBarrier, kGroupBarrier, kMbarWait, kDone };
// one wgmma.mma_async a thread has issued: its accumulator registers, the
// descriptors, scale-d
struct EmuWgmma { int* d; int n; uint64_t a, b; int scale_d; };
struct EmuThread {
    ucontext_t ctx;
    std::vector<char> stack;
    EmuWait state = kRunning;
    const void* bar = nullptr;  // kMbarWait: the mbarrier and the parity awaited
    uint32_t parity = 0;
    std::vector<EmuWgmma> open;                 // issued, not yet committed
    std::vector<std::vector<EmuWgmma>> groups;  // committed, in flight
    uint64_t issued = 0;                        // a hash of every product issued
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
inline void __syncwarp() { emu_warp_sync(); }
// the .sync.aligned instructions of a warpgroup (four warps from a warp
// index that is a multiple of 4): every one of its 128 threads at once
inline void emu_group_sync() { emu_yield(kGroupBarrier); }

// An mbarrier's 8 bytes as the stand-in keeps them: the pending arrivals
// (bits 0-14), the expected arrival count (15-29), the current phase's
// parity (30); the transaction count in the upper word, signed.
inline uint32_t& emu_mbar_word(const void* bar) { return *(uint32_t*)bar; }
inline int32_t& emu_mbar_tx(const void* bar) { return *((int32_t*)bar + 1); }
inline bool emu_mbar_passed(const void* bar, uint32_t parity) {
    return ((emu_mbar_word(bar) >> 30) & 1) != (parity & 1);
}
// the phase completes once every arrival is in and no byte is pending
inline void emu_mbar_settle(const void* bar) {
    uint32_t& w = emu_mbar_word(bar);
    if ((w & 0x7FFF) == 0 && emu_mbar_tx(bar) == 0) {
        const uint32_t count = (w >> 15) & 0x7FFF;
        w = (((w >> 30) & 1) ^ 1) << 30 | count << 15 | count;
    }
}
inline void emu_mbar_wait(const void* bar, uint32_t parity) {
    if (emu_mbar_passed(bar, parity)) return;
    emu_threads[emu_cur].bar = bar;
    emu_threads[emu_cur].parity = parity;
    emu_yield(kMbarWait);
}

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
            EmuThread& th = emu_threads[t];
            if (th.state == kMbarWait && emu_mbar_passed(th.bar, th.parity)) th.state = kRunning;
            if (th.state != kRunning) continue;
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
        for (int g = 0; g < (threads + 127) / 128; ++g) {
            bool full = 128 * (g + 1) <= threads, any = false;
            for (int t = 128 * g; t < std::min(128 * (g + 1), threads); ++t) {
                const EmuWait s = emu_threads[t].state;
                full &= s == kGroupBarrier;
                any |= s == kGroupBarrier;
            }
            if (any && !full) {
                std::fprintf(stderr, "warpgroup %d diverged at a .sync.aligned instruction\n", g);
                std::abort();
            }
            if (full) {
                for (int t = 128 * g; t < 128 * (g + 1); ++t) emu_threads[t].state = kRunning;
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
        if (!at_barrier) {
            int waiting = 0;
            for (const auto& th : emu_threads) waiting += th.state == kMbarWait;
            std::fprintf(stderr, "deadlock (%d threads wait on an mbarrier)\n", waiting);
            std::abort();
        }
        for (auto& th : emu_threads) th.state = kRunning;
    }
}

// run a grid's blocks from the last to the first (a test of results that
// must not depend on the order in which blocks run)
inline bool emu_reverse_blocks = false;

inline void emu_launch(dim3 grid, dim3 block, size_t smem, cudaStream_t,
                       std::function<void()> fn) {
    if (smem > kSmemMax || (block.x * block.y * block.z) % 32) std::abort();
    emu_smem_bytes = smem;
    emu_fn = &fn;
    blockDim = block;
    gridDim = grid;
    const unsigned n = grid.x * grid.y * grid.z;
    for (unsigned i = 0; i < n; ++i) {
        const unsigned b = emu_reverse_blocks ? n - 1 - i : i;
        std::memset(smem_raw, 0xCD, sizeof(smem_raw));
        blockIdx = dim3(b % grid.x, b / grid.x % grid.y, b / (grid.x * grid.y));
        emu_run_block(block);
    }
}
