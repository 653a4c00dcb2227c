// One Life-like generation of uint8 cells on a band of rows staged in shared
// memory, 16-byte columns of 4-cell words: the pieces ca_step.cu's
// ca_step_words_kernel and halo_words.cu's halo_words_kernel share.
//
// A block stages its band with one ghost row above and below by the Tensor
// Memory Accelerator's 1-D bulk copies, completing on an mbarrier; XORs the
// action's toggles into the staged rows that the window covers (each staged
// row's global row decides, ghost rows included); then a thread walks a
// strip of rows down one 16-byte column, carrying three rows' words in
// registers, and stores 16 bytes a row (step_band).
#pragma once

#include "common.cuh"

// -- The Tensor Memory Accelerator's 1-D bulk copy, behind helpers the
// emulated build (tests/cuda_emulation) stands in for.
#ifndef CUDA_EMULATION
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// An mbarrier in shared memory that one arrival (the issuing thread's)
// completes, once the bytes it expects have landed.
__device__ __forceinline__ void bulk_barrier_init(uint64_t* bar) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar)));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void bulk_barrier_expect(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// bytes (a multiple of 16, both addresses 16-byte aligned) from device memory
// into shared memory, completing on bar.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
        ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void bulk_barrier_wait(uint64_t* bar, uint32_t phase) {
    uint32_t done = 0;
    while (!done) {
        asm volatile(
            "{\n .reg .pred p;\n"
            " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            " selp.u32 %0, 1, 0, p;\n}"
            : "=r"(done) : "r"(smem_addr(bar)), "r"(phase) : "memory");
    }
}
#endif

constexpr int BAR_BYTES = 16;  // the mbarrier's slot ahead of the staged band

__device__ __forceinline__ int wrap_row(int r, int H) {
    return r < 0 ? r + H : (r >= H ? r - H : r);
}

// The toggles of the 4 cells of a word whose first cell is column s of the
// action row `arow` (columns outside [0, AW) do not toggle): a byte 0x01
// where the action byte is nonzero, by a SWAR test on the word.
__device__ __forceinline__ uint32_t nonzero_bytes(uint32_t v) {
    return ((((v & 0x7f7f7f7fu) + 0x7f7f7f7fu) | v) >> 7) & 0x01010101u;
}

__device__ __forceinline__ uint32_t action_word(const uint8_t* arow, int s, int AW) {
    uint32_t v = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k)
        if (s + k >= 0 && s + k < AW) v |= static_cast<uint32_t>(arow[s + k]) << (8 * k);
    return v;
}

// The raw action bytes over the 16 cells 16 v .. 16 v + 15 of grid row r
// (zero off the window).  `aligned`: the window starts and ends on 16-byte
// columns and the action is 16-byte aligned, so it is one 16-byte load.
__device__ __forceinline__ uint4 action_chunk(const uint8_t* a, int r, int v, int AH, int AW,
                                              int r0, int c0, bool aligned) {
    const int ar = r - r0;
    if (ar < 0 || ar >= AH || 16 * v + 15 < c0 || 16 * v >= c0 + AW)
        return make_uint4(0, 0, 0, 0);
    const uint8_t* arow = a + static_cast<size_t>(ar) * AW;
    const int s = 16 * v - c0;
    if (aligned) return *reinterpret_cast<const uint4*>(arow + s);
    return make_uint4(action_word(arow, s, AW), action_word(arow, s + 4, AW),
                      action_word(arow, s + 8, AW), action_word(arow, s + 12, AW));
}

// XOR the toggles of raw action bytes t into the 4 words c.
__device__ __forceinline__ void toggle(uint4& c, const uint4& t) {
    c.x ^= nonzero_bytes(t.x);
    c.y ^= nonzero_bytes(t.y);
    c.z ^= nonzero_bytes(t.z);
    c.w ^= nonzero_bytes(t.w);
}

// The action a ([AH, AW] bytes of one universe, the window's first row and
// column r0, c0 of a universe of H rows) into the E staged rows of tile4
// (V 16-byte columns a row; staged row lr is global row wrap_row(g0 + lr, H)),
// its bytes loaded while the band's bulk copies, completing on bar, are in
// flight; every thread waits for them.
__device__ __forceinline__ void toggle_band(uint4* tile4, const uint8_t* a, int g0, int E, int V,
                                            int H, int AH, int AW, int r0, int c0, bool aligned,
                                            uint64_t* bar) {
    const int tid = threadIdx.x, nt = blockDim.x;
    const int v0 = c0 / 16, nv = (c0 + AW - 1) / 16 - v0 + 1;
    for (int base = tid; base < E * nv; base += 2 * nt) {
        uint4 t[2];
#pragma unroll
        for (int k = 0; k < 2; ++k) {
            const int i = base + k * nt, lr = i / nv;
            if (i < E * nv)
                t[k] = action_chunk(a, wrap_row(g0 + lr, H), v0 + i - lr * nv, AH, AW, r0, c0,
                                    aligned);
        }
        bulk_barrier_wait(bar, 0);
#pragma unroll
        for (int k = 0; k < 2; ++k) {
            const int i = base + k * nt, lr = i / nv;
            if (i < E * nv) toggle(tile4[lr * V + v0 + i - lr * nv], t[k]);
        }
    }
    bulk_barrier_wait(bar, 0);
}

// The 4 words of a 16-byte column of one staged row and its west and east
// neighbour words (the row wraps).
struct Row6 {
    uint32_t w, c0, c1, c2, c3, e;
};

__device__ __forceinline__ Row6 row6(const uint32_t* row, int v, int QW) {
    const uint4 c = reinterpret_cast<const uint4*>(row)[v];
    return Row6{row[v == 0 ? QW - 1 : 4 * v - 1], c.x, c.y, c.z, c.w,
                row[4 * v + 4 == QW ? 0 : 4 * v + 4]};
}

// One generation of the `rows` rows staged at tw (words; staged rows 0 and
// rows + 1 the ghost rows) into o4 (V 16-byte columns a row): a thread a
// strip of `strip` rows of a 16-byte column at a time, the rule rb.
__device__ __forceinline__ void step_band(const uint32_t* tw, uint4* o4, int rows, int V,
                                          int strip, int rb) {
    const int QW = 4 * V;
    const int strips = (rows + strip - 1) / strip;
    for (int i = threadIdx.x; i < V * strips; i += blockDim.x) {
        const int v = i % V, s0 = (i / V) * strip;
        const int s1 = min(s0 + strip, rows);
        // staged row lr + 1 is output row lr: its north is staged row lr
        Row6 up = row6(tw + s0 * QW, v, QW), mid = row6(tw + (s0 + 1) * QW, v, QW);
        for (int lr = s0; lr < s1; ++lr) {
            const Row6 dn = row6(tw + (lr + 2) * QW, v, QW);
            uint32_t cw, cc0, cc1, cc2, cc3, ce;  // column sums: column_sums_rows' arithmetic
            cw = up.w + mid.w + dn.w;
            cc0 = up.c0 + mid.c0 + dn.c0;
            cc1 = up.c1 + mid.c1 + dn.c1;
            cc2 = up.c2 + mid.c2 + dn.c2;
            cc3 = up.c3 + mid.c3 + dn.c3;
            ce = up.e + mid.e + dn.e;
            o4[static_cast<size_t>(lr) * V + v] =
                make_uint4(step_cells4(cw, cc0, cc1, mid.c0, rb),
                           step_cells4(cc0, cc1, cc2, mid.c1, rb),
                           step_cells4(cc1, cc2, cc3, mid.c2, rb),
                           step_cells4(cc2, cc3, ce, mid.c3, rb));
            up = mid;
            mid = dn;
        }
    }
}
