// The instruction wrappers of csrc/mma_tc.cuh for the CPU stand-in of
// emu.h, by the PTX ISA's definitions: cp.async copies at once (the
// stages' ring order is then trivially kept) and checks its alignment and
// bounds; cvt.rna.tf32 rounds to 10 mantissa bits, ties away from zero;
// mma.sync (TF32, bf16) and ldmatrix exchange the warp's registers through a scratch
// area between two warp barriers, with the fragment layouts of the PTX ISA
// (see mma_tc.cuh). Products are summed in float32, in order.
// Included by the test in place of that header's asm section, inside
// namespace tc.

struct EmuWarpScratch { uint32_t r[32][6]; uintptr_t p[32]; };
inline EmuWarpScratch emu_scratch[32];

inline int emu_lane() { return threadIdx.x & 31; }
inline EmuWarpScratch& emu_warp() { return emu_scratch[threadIdx.x >> 5]; }

inline void emu_check_smem(const void* p, size_t n) {
    const unsigned char* c = static_cast<const unsigned char*>(p);
    if (reinterpret_cast<uintptr_t>(p) % 16 || c < smem_raw || c + n > smem_raw + emu_smem_bytes) {
        std::fprintf(stderr, "shared-memory access out of bounds or misaligned\n");
        std::abort();
    }
}

inline uint32_t smem_addr(const void*) { return 0; }

inline void cp_async16(void* dst, const void* src, bool valid) {
    emu_check_smem(dst, 16);
    if (!valid) { std::memset(dst, 0, 16); return; }
    if (reinterpret_cast<uintptr_t>(src) % 16) {
        std::fprintf(stderr, "cp.async source misaligned\n");
        std::abort();
    }
    std::memcpy(dst, src, 16);
}
inline void cp_async_commit() {}
template <int N> inline void cp_async_wait() {}

inline uint32_t to_tf32(float x) { return (emu_bits(x) + 0x1000u) & 0xFFFFE000u; }
inline float emu_tf32(uint32_t u) { return __uint_as_float(u & 0xFFFFE000u); }
inline float emu_bf16(uint32_t u, int half) { return __uint_as_float(((u >> (16 * half)) & 0xFFFFu) << 16); }

// D = A B + C for the warp: a(row, k) and b(k, col) read the lanes' registers
template <int K, typename FA, typename FB>
inline void emu_mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1, FA av, FB bv) {
    EmuWarpScratch& s = emu_warp();
    const int l = emu_lane();
    for (int i = 0; i < 4; ++i) s.r[l][i] = a[i];
    s.r[l][4] = b0;
    s.r[l][5] = b1;
    emu_warp_sync();
    const int g = l >> 2, t = l & 3;
    float d[4];
    for (int e = 0; e < 4; ++e) {
        const int row = g + 8 * (e >= 2), col = 2 * t + (e & 1);
        float sum = c[e];
        for (int k = 0; k < K; ++k) sum += av(s, row, k) * bv(s, k, col);
        d[e] = sum;
    }
    emu_warp_sync();
    for (int e = 0; e < 4; ++e) c[e] = d[e];
}

inline void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
    emu_mma<8>(c, a, b0, b1,
               [](EmuWarpScratch& s, int row, int k) {
                   return emu_tf32(s.r[(row % 8) * 4 + k % 4][(row >= 8) + 2 * (k >= 4)]);
               },
               [](EmuWarpScratch& s, int k, int col) {
                   return emu_tf32(s.r[col * 4 + k % 4][4 + (k >= 4)]);
               });
}

inline void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
    emu_mma<16>(c, a, b0, b1,
                [](EmuWarpScratch& s, int row, int k) {
                    return emu_bf16(s.r[(row % 8) * 4 + (k % 8) / 2][(row >= 8) + 2 * (k >= 8)], k % 2);
                },
                [](EmuWarpScratch& s, int k, int col) {
                    return emu_bf16(s.r[col * 4 + (k % 8) / 2][4 + (k >= 8)], k % 2);
                });
}

// matrix j's row r comes from the address of lane 8 j + r
inline void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
    emu_check_smem(p, 16);
    EmuWarpScratch& s = emu_warp();
    const int l = emu_lane();
    s.p[l] = reinterpret_cast<uintptr_t>(p);
    emu_warp_sync();
    for (int j = 0; j < 4; ++j) {
        const uint16_t* q = reinterpret_cast<const uint16_t*>(s.p[8 * j + l / 4]);
        r[j] = q[2 * (l % 4)] | ((uint32_t)q[2 * (l % 4) + 1] << 16);
    }
    emu_warp_sync();
}

inline void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
    emu_check_smem(p, 16);
    EmuWarpScratch& s = emu_warp();
    const int l = emu_lane();
    s.p[l] = reinterpret_cast<uintptr_t>(p);
    emu_warp_sync();
    for (int j = 0; j < 4; ++j) {
        const uint16_t* q0 = reinterpret_cast<const uint16_t*>(s.p[8 * j + 2 * (l % 4)]);
        const uint16_t* q1 = reinterpret_cast<const uint16_t*>(s.p[8 * j + 2 * (l % 4) + 1]);
        r[j] = q0[l / 4] | ((uint32_t)q1[l / 4] << 16);
    }
    emu_warp_sync();
}
