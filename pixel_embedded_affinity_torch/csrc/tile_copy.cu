// Tile copy (P), for Hopper (sm_90a).
//
// Replaces the TPU kernel docs/profile_b1_arrange.py::_id_kernel
// (pl.pallas_call in pallas_copy, the identity-copy probe of the script that
// asks which tensor arrangement avoids the B=1 slow-conv demotion). Python
// wrapper: ops/tile_copy_cuda.py; the probe's port:
// utils/profile_arrange.py.
//
// What it computes. out = t for a contiguous tensor t of any dtype and rank.
// The TPU kernel copies t in shape[tile_axis] / tile blocks of `tile` rows
// along tile_axis; the wrapper raises where shape[tile_axis] is not a
// multiple of tile (the TPU kernel leaves the remainder unwritten), so the
// covered region is the whole tensor and the copy is one of nbytes bytes.
//
// Bound. HBM bytes: nbytes read and nbytes written, no arithmetic. The
// probe's (1, 544, 544, 16) bfloat16 embedding is 9.47 MB: 2 x 9.47 MB /
// 3.35 TB/s = 5.65 us.
//
// Design. The TPU grid's 17 blocks would leave most of the 132 SMs idle, so
// it is not carried over: one grid-stride loop over the bytes, 8 blocks of
// 256 threads per SM. Each thread moves the widest vector (16, 8, 4, 2 or
// 1 bytes) to which both pointers are aligned: 16-byte loads and stores for
// a tensor at the start of its allocation, narrower ones for a view with a
// misaligned storage offset. The bytes past the last whole vector (a size
// that is not a multiple of the vector) are copied one by one in the same
// launch.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

template <typename V>
__global__ void __launch_bounds__(256)
tile_copy_kernel(const unsigned char* __restrict__ src, unsigned char* __restrict__ dst,
                 int64_t nbytes) {
    const int64_t nthreads = (int64_t)gridDim.x * blockDim.x;
    const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    const int64_t nvec = nbytes / (int64_t)sizeof(V);
    const V* __restrict__ s = reinterpret_cast<const V*>(src);
    V* __restrict__ d = reinterpret_cast<V*>(dst);
    for (int64_t i = tid; i < nvec; i += nthreads) d[i] = s[i];
    for (int64_t i = nvec * (int64_t)sizeof(V) + tid; i < nbytes; i += nthreads) dst[i] = src[i];
}

template <typename V>
cudaError_t launch(const unsigned char* src, unsigned char* dst, int64_t nbytes,
                   cudaStream_t stream) {
    int dev = 0, sms = 132;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    constexpr int kThreads = 256;
    const int64_t nvec = nbytes / (int64_t)sizeof(V);
    const int64_t want = (nvec > 0 ? nvec : nbytes) + kThreads - 1;
    int64_t blocks = want / kThreads;
    const int64_t cap = (int64_t)sms * 8;
    if (blocks > cap) blocks = cap;
    if (blocks < 1) blocks = 1;
    tile_copy_kernel<V><<<(unsigned)blocks, kThreads, 0, stream>>>(src, dst, nbytes);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// Copies nbytes from src to dst (device pointers) on stream. Returns the
// cudaError_t of the launch (0 on success).
int tile_copy(const void* src, void* dst, int64_t nbytes, void* stream) {
    if (nbytes < 0) return (int)cudaErrorInvalidValue;
    if (nbytes == 0) return 0;
    const unsigned char* s = static_cast<const unsigned char*>(src);
    unsigned char* d = static_cast<unsigned char*>(dst);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const uintptr_t align = reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst);
    if (align % 16 == 0) return (int)launch<uint4>(s, d, nbytes, st);
    if (align % 8 == 0) return (int)launch<uint2>(s, d, nbytes, st);
    if (align % 4 == 0) return (int)launch<unsigned int>(s, d, nbytes, st);
    if (align % 2 == 0) return (int)launch<unsigned short>(s, d, nbytes, st);
    return (int)launch<unsigned char>(s, d, nbytes, st);
}

}  // extern "C"
