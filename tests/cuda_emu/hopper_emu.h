// The instruction wrappers of csrc/wgmma_tma.cuh for the CPU stand-in of
// emu.h, each by its definition in the PTX ISA. Included by the test in
// place of that header's asm section, inside namespace wg.
//
// - Shared addresses are offsets into emu.h's shared buffer (aligned to
//   1024 bytes, as the kernel aligns its ring in the shared window).
// - mbarrier: init, arrive, arrive.expect_tx (the bytes expected first,
//   then the arrival), try_wait.parity (the thread sleeps until the phase
//   of that parity has completed); a phase completes when its arrivals are
//   in and its transaction count is back to 0.
// - cp.async.bulk.tensor (tile mode, int8 or float32): the innermost
//   coordinate a multiple of 16 bytes, negative or not (the H100 stops with
//   an illegal instruction at -5 and 6 floats, tools/wgmma_tf32_probe.py);
//   the box at the coordinates
//   copied at once, elements outside the tensor read as 0, written densely
//   (innermost dimension first) with the map's swizzle applied to the
//   shared address (bits [4, 4 + b) ^= bits [7, 7 + b), b = log2(swizzle /
//   16)); then complete_tx of the box's bytes on the mbarrier. The
//   destination must be 128-byte aligned.
// - wgmma.fence / commit_group / wait_group: .sync.aligned, so each is a
//   barrier of the thread's 128-thread warpgroup. mma_async records the
//   product in the thread's open group; commit_group closes it;
//   wait_group N computes the groups beyond the newest N, every thread of
//   the warpgroup its own accumulator fragment, between two warpgroup
//   barriers. So the operands are read when the kernel waits for them, as
//   late as the card may read them: a stage released before its products
//   were waited for is overwritten first, and the result is wrong.
// - The descriptors (start, LBO, SBO, base offset, layout) decode to
//   addresses as the PTX ISA's shared-memory matrix layouts define: K-major
//   rows of the swizzle width (or 8 x 16-byte core matrices without
//   swizzle), with the swizzle applied to the address as TMA applies it.
//   Every thread's issued products are hashed, and the warpgroup's hashes
//   must agree when it waits.
// - wgmma .tf32 (m64nNk8, A from registers in the layout of mma.sync
//   m16n8k8 .tf32, B from shared memory): each operand's float32 container
//   enters as its tf32 with the low 13 bits dropped, as the H100 does
//   (tools/wgmma_tf32_probe.py); a row's 8 products summed in float32 in
//   k order and added to the accumulator. Register operands are taken at
//   the issue (the card forbids changing them before the wait).

inline uint32_t smem_u32(const void* p) {
    return (uint32_t)(static_cast<const unsigned char*>(p) - smem_raw);
}

inline unsigned char* emu_shared(uint32_t addr, size_t n, size_t align, const char* what) {
    if (addr % align || addr + n > emu_smem_bytes) {
        std::fprintf(stderr, "%s: shared address %u (+%zu) out of bounds or not %zu-aligned\n",
                     what, addr, n, align);
        std::abort();
    }
    return smem_raw + addr;
}

inline void mbar_init(uint64_t* bar, int count) {
    emu_shared(smem_u32(bar), 8, 8, "mbarrier.init");
    if (count < 1 || count > 0x7FFF) std::abort();
    emu_mbar_word(bar) = (uint32_t)count << 15 | (uint32_t)count;
    emu_mbar_tx(bar) = 0;
}

inline void fence_barrier_init() {}

inline void mbar_arrive(uint64_t* bar) {
    emu_shared(smem_u32(bar), 8, 8, "mbarrier.arrive");
    if ((emu_mbar_word(bar) & 0x7FFF) == 0) {
        std::fprintf(stderr, "mbarrier.arrive past the phase's arrival count\n");
        std::abort();
    }
    emu_mbar_word(bar) -= 1;
    emu_mbar_settle(bar);
}

inline void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
    emu_shared(smem_u32(bar), 8, 8, "mbarrier.arrive.expect_tx");
    emu_mbar_tx(bar) += (int32_t)bytes;
    mbar_arrive(bar);
}

inline void mbar_wait(uint64_t* bar, uint32_t parity) {
    emu_shared(smem_u32(bar), 8, 8, "mbarrier.try_wait");
    emu_mbar_wait(bar, parity);
}

// The shared address of element offset `off` of a region at `addr` written
// or read with a swizzle of `span` bytes (0: none).
inline uint32_t emu_swizzle(uint32_t addr, int span) {
    if (span == 0) return addr;
    const uint32_t mask = (uint32_t)span / 16 - 1;
    return addr ^ (((addr >> 7) & mask) << 4);
}

inline void emu_tma(void* dst, const CUtensorMap* m, uint64_t* bar, const int* c) {
    if (((int64_t)c[0] * m->esize) % 16) {  // the card faults (illegal instruction)
        std::fprintf(stderr, "cp.async.bulk.tensor: innermost coordinate %d not on 16 bytes\n",
                     c[0]);
        std::abort();
    }
    size_t elems = 1;
    for (int d = 0; d < m->rank; ++d) elems *= m->box[d];
    const size_t bytes = elems * m->esize;
    const uint32_t base = smem_u32(dst);
    emu_shared(base, bytes, 128, "cp.async.bulk.tensor");
    uint32_t idx[5] = {0, 0, 0, 0, 0};
    for (size_t e = 0; e < elems; ++e) {
        bool in = true;
        uint64_t src = 0;
        for (int d = 0; d < m->rank; ++d) {
            const int64_t g = (int64_t)c[d] + idx[d];
            in &= g >= 0 && g < (int64_t)m->dims[d];
            src += (uint64_t)g * (d == 0 ? m->esize : m->strides[d - 1]);
        }
        for (int b = 0; b < m->esize; ++b) {
            const uint32_t off = (uint32_t)(e * m->esize + b);
            smem_raw[emu_swizzle(base + off, m->swizzle)] = in ? m->base[src + b] : 0;
        }
        for (int d = 0; d < m->rank && ++idx[d] == m->box[d]; ++d) idx[d] = 0;
    }
    emu_shared(smem_u32(bar), 8, 8, "complete_tx");
    emu_mbar_tx(bar) -= (int32_t)bytes;
    emu_mbar_settle(bar);
}

inline void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1, int c2,
                        int c3) {
    if (map->rank != 4) std::abort();
    const int c[4] = {c0, c1, c2, c3};
    emu_tma(dst, map, bar, c);
}

inline void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1,
                        int c2) {
    if (map->rank != 3) std::abort();
    const int c[3] = {c0, c1, c2};
    emu_tma(dst, map, bar, c);
}

inline void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1) {
    if (map->rank != 2) std::abort();
    const int c[2] = {c0, c1};
    emu_tma(dst, map, bar, c);
}

// the shared address of (row r, byte k) of the K-major operand at desc
inline uint32_t emu_desc_addr(uint64_t desc, int r, int k) {
    const uint32_t start = (uint32_t)(desc & 0x3FFF) << 4;
    const uint32_t lbo = (uint32_t)((desc >> 16) & 0x3FFF) << 4;
    const uint32_t sbo = (uint32_t)((desc >> 32) & 0x3FFF) << 4;
    const int layout = (int)(desc >> 62), span = layout == 1 ? 128 : layout == 2 ? 64 : 32;
    if ((desc >> 49) & 7) {
        std::fprintf(stderr, "wgmma descriptor: a base offset is not emulated\n");
        std::abort();
    }
    if (layout == 0)  // 8 x 16-byte core matrices: LBO along k, SBO along rows
        return start + (r / 8) * sbo + (k / 16) * lbo + (r % 8) * 16 + k % 16;
    if (start % span + 32 > (uint32_t)span) {
        std::fprintf(stderr, "wgmma descriptor: a k step of 32 bytes crosses a %d-byte row\n", span);
        std::abort();
    }
    return emu_swizzle(start + (r / 8) * sbo + (r % 8) * span + k, span);
}

inline void wgmma_fence() { emu_group_sync(); }

template <int R>
inline void fence_acc(int (&)[R]) {}
template <int R>
inline void fence_acc(float (&)[R]) {}

template <int N>
inline void wgmma_s8(int (&d)[N / 2], uint64_t a, uint64_t b, int scale_d) {
    static_assert(N == 8 || N == 16 || N == 24 || (N % 16 == 0 && N >= 32 && N <= 256),
                  "no m64nNk32 .s8 shape of this N");
    EmuThread& th = emu_threads[emu_cur];
    th.open.push_back({d, N, a, b, scale_d != 0});
    th.issued = (th.issued * 1000003u) ^ a ^ (b << 1) ^ ((uint64_t)N << 56) ^ (scale_d != 0);
}

template <int N>
inline void wgmma_tf32_rs(float (&d)[N / 2], const uint32_t (&ar)[4], uint64_t b, int scale_d) {
    static_assert(N % 8 == 0 && N >= 8 && N <= 256, "no m64nNk8 .tf32 shape of this N");
    EmuThread& th = emu_threads[emu_cur];
    EmuWgmma op{d, N, 0, b, scale_d != 0};
    op.tf32 = true;
    for (int i = 0; i < 4; ++i) op.ar[i] = ar[i];
    th.open.push_back(op);
    th.issued = (th.issued * 1000003u) ^ (b << 1) ^ ((uint64_t)N << 56) ^ (scale_d != 0) ^ 4;
}

inline void wgmma_commit() {
    EmuThread& th = emu_threads[emu_cur];
    th.groups.push_back(std::move(th.open));
    th.open.clear();
}

// the two 16-byte pieces of row r's 32 bytes of k (a swizzle moves whole pieces)
inline void emu_desc_row(uint64_t desc, int r, const int8_t* (&piece)[2]) {
    for (int p = 0; p < 2; ++p)
        piece[p] = (const int8_t*)emu_shared(emu_desc_addr(desc, r, 16 * p), 16, 16, "wgmma operand");
}

// the tensor cores' tf32 of a float32 container: its low 13 bits dropped
inline float emu_wg_tf32(uint32_t u) { return __uint_as_float(u & 0xFFFFE000u); }

// a .tf32 operand's row r, k 0..7 (32 bytes) from shared memory at desc
inline void emu_desc_row_f32(uint64_t desc, int r, float (&v)[8]) {
    for (int p = 0; p < 2; ++p) {
        const unsigned char* q = emu_shared(emu_desc_addr(desc, r, 16 * p), 16, 16, "wgmma operand");
        for (int i = 0; i < 4; ++i) {
            uint32_t u;
            std::memcpy(&u, q + 4 * i, 4);
            v[4 * p + i] = emu_wg_tf32(u);
        }
    }
}

// D (64 x N) = A (64 x 8) B (N x 8)^T (+ D) in tf32: the thread's fragment.
// A from registers: the warp's lanes' registers at their issue, a0 (g, t)
// a1 (g + 8, t) a2 (g, t + 4) a3 (g + 8, t + 4).
// The op is the thread's op `oi` of its group `gi`; the warp's other
// lanes hold theirs at the same indices.
inline void emu_wgmma_run_tf32(const EmuWgmma& op, size_t gi, size_t oi) {
    const int lane = threadIdx.x & 31;
    float a[2][8];
    for (int h = 0; h < 2; ++h) {
        const int r = lane / 4 + 8 * h;  // the row within the warp's 16
        for (int k = 0; k < 8; ++k) {  // (r, k) is register h + 2 (k >= 4) of lane 4 (r % 8) + k % 4
            const EmuThread& owner = emu_threads[(emu_cur & ~31) + 4 * (r % 8) + k % 4];
            a[h][k] = emu_wg_tf32(owner.groups[gi][oi].ar[h + 2 * (k >= 4)]);
        }
    }
    float* d = static_cast<float*>(op.d);
    for (int j = 0; j < op.n / 8; ++j)
        for (int c = 0; c < 2; ++c) {
            float b[8];
            emu_desc_row_f32(op.b, 8 * j + 2 * (lane % 4) + c, b);
            for (int h = 0; h < 2; ++h) {
                float sum = 0.f;
                for (int k = 0; k < 8; ++k) sum += a[h][k] * b[k];
                float& acc = d[4 * j + 2 * h + c];
                acc = op.scale_d ? acc + sum : sum;
            }
        }
}

// D (64 x N) = A (64 x 32) B (N x 32)^T (+ D): the thread's fragment
inline void emu_wgmma_run(const EmuWgmma& op) {
    const int l = threadIdx.x & 127, w = l >> 5, lane = l & 31;
    const int8_t* a[2][2];
    for (int h = 0; h < 2; ++h) emu_desc_row(op.a, 16 * w + lane / 4 + 8 * h, a[h]);
    for (int j = 0; j < op.n / 8; ++j)
        for (int c = 0; c < 2; ++c) {
            const int8_t* b[2];
            emu_desc_row(op.b, 8 * j + 2 * (lane % 4) + c, b);
            for (int h = 0; h < 2; ++h) {
                int sum = 0;
                for (int k = 0; k < 32; ++k) sum += (int)a[h][k / 16][k % 16] * (int)b[k / 16][k % 16];
                int& d = static_cast<int*>(op.d)[4 * j + 2 * h + c];
                d = op.scale_d ? d + sum : sum;
            }
        }
}

template <int N>
inline void wgmma_wait() {
    emu_group_sync();
    EmuThread& th = emu_threads[emu_cur];
    if (th.issued != emu_threads[emu_cur & ~127].issued) {
        std::fprintf(stderr, "wgmma: the warpgroup's threads issued different products\n");
        std::abort();
    }
    if (!th.open.empty()) {
        std::fprintf(stderr, "wgmma.wait_group with products not committed\n");
        std::abort();
    }
    // every thread computes its fragments, reading the other lanes'
    // register operands, before any thread drops its finished groups
    const size_t done = th.groups.size() > (size_t)N ? th.groups.size() - N : 0;
    for (size_t gi = 0; gi < done; ++gi)
        for (size_t oi = 0; oi < th.groups[gi].size(); ++oi) {
            const EmuWgmma& op = th.groups[gi][oi];
            if (op.tf32)
                emu_wgmma_run_tf32(op, gi, oi);
            else
                emu_wgmma_run(op);
        }
    emu_group_sync();
    th.groups.erase(th.groups.begin(), th.groups.begin() + done);
    emu_group_sync();
}
