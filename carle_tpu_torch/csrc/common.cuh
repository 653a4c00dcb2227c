// Shared by every kernel source of carle_tpu_torch.
//
// Each source compiles into its own shared library with a plain C interface
// (ops/cuda_build.py): every launcher selects the tensors' device, launches
// on the caller's stream and returns cudaGetLastError() as an int, which the
// Python wrapper turns into an exception through cuda_error_string().
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

extern "C" const char* cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Opt a kernel in to more than the default 48 KB of dynamic shared memory.
template <typename Kernel>
static cudaError_t allow_smem(Kernel kernel, size_t bytes) {
    if (bytes <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(bytes));
}

// What the card gives a kernel launched with `threads` threads and `smem`
// bytes of dynamic shared memory: out[0] registers a thread, out[1] static
// shared memory, out[2] local (spilled) bytes a thread, out[3] resident blocks
// a multiprocessor (cudaOccupancyMaxActiveBlocksPerMultiprocessor).  Host
// code only: chip_smoke.py reads it through each source's *_occupancy.
template <typename Kernel>
static int kernel_occupancy(Kernel kernel, int threads, size_t smem, int* out) {
    cudaFuncAttributes attr;
    cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
    if (e == cudaSuccess) e = allow_smem(kernel, smem);
    int blocks = 0;
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    out[0] = attr.numRegs;
    out[1] = static_cast<int>(attr.sharedSizeBytes);
    out[2] = static_cast<int>(attr.localSizeBytes);
    out[3] = blocks;
    return 0;
}

// Cells as the kernels read them: a plane of uint8_t cells (one a byte), of
// float values, or of uint32_t words that pack 32 cells along a row (bit j of
// word k is cell 32k + j: ops/bitpack.py's layout, rows a multiple of 32
// cells).  Indices and offsets count cells, whatever the type; a packed word
// is expanded in registers, so no cell plane passes through device memory.
__device__ __forceinline__ float cell_value(const uint8_t* p, size_t i) {
    return static_cast<float>(p[i]);
}
__device__ __forceinline__ float cell_value(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float cell_value(const uint32_t* p, size_t i) {
    return static_cast<float>((p[i >> 5] >> (i & 31)) & 1u);
}
template <typename T>
__device__ __forceinline__ const T* cells_at(const T* p, size_t i) {
    return p + i;
}
__device__ __forceinline__ const uint32_t* cells_at(const uint32_t* p, size_t i) {
    return p + (i >> 5);
}

// Rows [r0, r0 + rows) and columns [c0, c0 + cols) of a [H, W] plane of
// cells into xs[rows][cols] as bytes, zero outside the plane.  The whole
// width with a zero column each side is c0 = -1, cols = W + 2.
__device__ __forceinline__ void stage_cells(uint8_t* xs, const uint8_t* __restrict__ plane,
                                            int r0, int rows, int c0, int cols, int H, int W) {
    const int tid = threadIdx.x, nt = blockDim.x;
    for (int i = tid; i < rows * cols; i += nt) {
        const int lr = i / cols, lc = i - lr * cols;
        const int r = r0 + lr, c = c0 + lc;
        xs[i] = (r >= 0 && r < H && c >= 0 && c < W)
                    ? plane[static_cast<size_t>(r) * W + c]
                    : 0;
    }
}

// The same from packed words.  The whole width: a thread expands one word
// into 32 bytes.  A column window (a tile of the row, its edges anywhere in
// a word): a thread expands the window's part of one word, the words on
// either side of the plane reading as zero.
__device__ __forceinline__ void stage_cells(uint8_t* xs, const uint32_t* __restrict__ plane,
                                            int r0, int rows, int c0, int cols, int H, int W) {
    const int tid = threadIdx.x, nt = blockDim.x;
    const int NW = W >> 5;
    if (c0 != -1 || cols != W + 2) {
        const int k0 = c0 >> 5, kw = ((c0 + cols - 1) >> 5) - k0 + 1;  // words touched
        for (int i = tid; i < rows * kw; i += nt) {
            const int lr = i / kw, k = k0 + (i - lr * kw);
            const int r = r0 + lr;
            const uint32_t word = (r >= 0 && r < H && k >= 0 && k < NW)
                                      ? plane[static_cast<size_t>(r) * NW + k] : 0u;
            const int j0 = max(c0 - 32 * k, 0), j1 = min(c0 + cols - 32 * k, 32);
            for (int j = j0; j < j1; ++j)
                xs[lr * cols + 32 * k + j - c0] = static_cast<uint8_t>((word >> j) & 1u);
        }
        return;
    }
    const int IW = W + 2;
    for (int i = tid; i < rows * NW; i += nt) {
        const int lr = i / NW, k = i - lr * NW;
        const int r = r0 + lr;
        const uint32_t word = (r >= 0 && r < H) ? plane[static_cast<size_t>(r) * NW + k] : 0u;
        uint8_t* dst = xs + lr * IW + 1 + 32 * k;
#pragma unroll
        for (int j = 0; j < 32; ++j) dst[j] = static_cast<uint8_t>((word >> j) & 1u);
    }
    for (int lr = tid; lr < rows; lr += nt) {
        xs[lr * IW] = 0;
        xs[lr * IW + W + 1] = 0;
    }
}

// The whole width: xs[rows][W + 2], a zero column each side.
template <typename T>
__device__ __forceinline__ void stage_cells(uint8_t* xs, const T* __restrict__ plane, int r0,
                                            int rows, int H, int W) {
    stage_cells(xs, plane, r0, rows, -1, W + 2, H, W);
}

// What a cell pointer argument holds: float values, uint8 cells or packed
// uint32 words (the launchers' `*_kind` arguments).
constexpr int KIND_F32 = 0, KIND_U8 = 1, KIND_U32 = 2;

// Both cell arguments uint8 or packed, and packed rows whole words.
__host__ __device__ inline bool cell_kinds_ok(int a, int b, int W) {
    const bool packed = a == KIND_U32 || b == KIND_U32;
    return (a == KIND_U8 || a == KIND_U32) && (b == KIND_U8 || b == KIND_U32) &&
           !(packed && W % 32);
}

// The most blocks a grid's y dimension takes: a launcher with more
// instances than this launches the same grid again for the rest, each block
// adding the first instance of its launch (N0) to blockIdx.y.
constexpr int MAX_GRID_Y = 65535;
static inline int grid_rows(int N, int n0) { return N - n0 < MAX_GRID_Y ? N - n0 : MAX_GRID_Y; }

// The clamped window [max(c0 - h, 0), min(c0 + t + h, n)) as (start, width).
__host__ __device__ inline void clamped_window(int c0, int t, int h, int n, int& start,
                                               int& width) {
    start = c0 - h > 0 ? c0 - h : 0;
    width = (c0 + t + h < n ? c0 + t + h : n) - start;
}

// The widest clamped window over the tiles c0 = 0, t, 2t, ... of [0, n).
__host__ __device__ inline int widest_window(int n, int t, int h) {
    int best = 0;
    for (int c0 = 0; c0 < n; c0 += t) {
        int start, width;
        clamped_window(c0, t < n - c0 ? t : n - c0, h, n, start, width);
        best = width > best ? width : best;
    }
    return best;
}

// -- The Life-like update on words ------------------------------------------
//
// Shared by the single-device engines (bit_multi_step.cu, ca_multi_step.cu)
// and the row-sharded halo kernels (halo_step.cu): each function computes a
// row's next words from the rows above and below it (north, centre, south),
// wherever those rows live, so the engines and the halo kernels run one update.
// Columns wrap inside each row (the torus over the width).

// Packed words (bit j of word k is the cell in column 32k + j): the rule's 18
// bits as leaf words of a multiplexer tree over the bit-sliced Moore count.
struct Leaves {
    uint32_t dead[9];   // all-ones where a dead cell with v neighbours is born
    uint32_t alive[9];  // all-ones where a live cell with v neighbours survives
};

__device__ __forceinline__ Leaves make_leaves(int rb) {
    Leaves l;
#pragma unroll
    for (int v = 0; v < 9; ++v) {
        l.dead[v] = 0u - static_cast<uint32_t>((rb >> v) & 1);
        l.alive[v] = 0u - static_cast<uint32_t>((rb >> (9 + v)) & 1);
    }
    return l;
}

// The rule of universe n: the compile-time mask (RULE >= 0), whose leaves the
// compiler folds, or the data.
template <int RULE>
__device__ __forceinline__ int rule_of(const int32_t* __restrict__ rule, int stride, int n) {
    return RULE >= 0 ? RULE : rule[static_cast<size_t>(n) * stride];
}

__device__ __forceinline__ void csa(uint32_t a, uint32_t b, uint32_t c,
                                    uint32_t& sum, uint32_t& carry) {
    const uint32_t ab = a ^ b;
    sum = ab ^ c;
    carry = (a & b) | (ab & c);
}

__device__ __forceinline__ uint32_t mux(uint32_t a, uint32_t b, uint32_t sel) {
    return (a & ~sel) | (b & sel);
}

// The mux tree of carle_tpu/ops/bitpack.py::_rule_mux: select 9 -> 5 -> 3 ->
// 2 -> 1 leaves by n0, n1, n2, n3 (odd tails only reachable with sel = 0).
__device__ __forceinline__ uint32_t fold(const uint32_t* l, uint32_t n0,
                                         uint32_t n1, uint32_t n2, uint32_t n3) {
    const uint32_t p0 = mux(l[0], l[1], n0), p1 = mux(l[2], l[3], n0);
    const uint32_t p2 = mux(l[4], l[5], n0), p3 = mux(l[6], l[7], n0);
    const uint32_t p4 = l[8] & ~n0;
    const uint32_t q0 = mux(p0, p1, n1), q1 = mux(p2, p3, n1), q2 = p4 & ~n1;
    const uint32_t r0 = mux(q0, q1, n2), r1 = q2 & ~n2;
    return mux(r0, r1, n3);
}

// Horizontal pair planes of one row: weight-1 (left ^ right) and weight-2
// (left & right) of each cell's west and east neighbours.
__device__ __forceinline__ void pair_planes(uint32_t west, uint32_t g,
                                            uint32_t east, uint32_t& a,
                                            uint32_t& b) {
    const uint32_t left = __funnelshift_l(west, g, 1);   // (g << 1) | (west >> 31)
    const uint32_t right = __funnelshift_r(g, east, 1);  // (g >> 1) | (east << 31)
    a = left ^ right;
    b = left & right;
}

// Next state of a word g from the pair planes of its row (a, b) and of the
// rows above (a_t, b_t) and below (a_b, b_b), and the words above (m_t) and
// below (m_b): the carry-save count (n0..n3 of the 8 neighbours) and the
// rule's mux tree.
__device__ __forceinline__ uint32_t step_planes(uint32_t a_t, uint32_t b_t, uint32_t m_t,
                                                uint32_t a, uint32_t b, uint32_t g,
                                                uint32_t a_b, uint32_t b_b, uint32_t m_b,
                                                const Leaves& leaves) {
    uint32_t s1, c1, s2, c2, s3, c3, s4, c4;
    csa(a_t, a, a_b, s1, c1);   // weight-1 triples
    csa(m_t, m_b, s1, s2, c2);  // + the two vertical cells
    csa(b_t, b, b_b, s3, c3);   // weight-2 triples
    csa(s3, c1, c2, s4, c4);
    const uint32_t n0 = s2, n1 = s4, n2 = c3 ^ c4, n3 = c3 & c4;
    return (fold(leaves.dead, n0, n1, n2, n3) & ~g) |
           (fold(leaves.alive, n0, n1, n2, n3) & g);
}

// Next state of word k of the packed row `mid` ([NW] words) between the rows
// `up` and `dn`.
__device__ __forceinline__ uint32_t step_word_rows(const uint32_t* up, const uint32_t* mid,
                                                   const uint32_t* dn, int NW, int k,
                                                   const Leaves& leaves) {
    const int kw = k == 0 ? NW - 1 : k - 1;
    const int ke = k == NW - 1 ? 0 : k + 1;
    const uint32_t g = mid[k], m_t = up[k], m_b = dn[k];
    uint32_t a_t, b_t, a, b, a_b, b_b;
    pair_planes(up[kw], m_t, up[ke], a_t, b_t);
    pair_planes(mid[kw], g, mid[ke], a, b);
    pair_planes(dn[kw], m_b, dn[ke], a_b, b_b);
    return step_planes(a_t, b_t, m_t, a, b, g, a_b, b_b, m_b, leaves);
}

// uint8 cells read as 32-bit words of 4 cells (a byte a cell, 0 or 1): the
// three rows' bytes add without carries into column sums (0-3).  Column sums
// of word q of the row `mid` between `up` and `dn`; `centre` gets mid[q].
__device__ __forceinline__ uint32_t column_sums_rows(const uint32_t* up, const uint32_t* mid,
                                                     const uint32_t* dn, int q,
                                                     uint32_t& centre) {
    centre = mid[q];
    return up[q] + centre + dn[q];
}

// Next 4 cells from the column sums of the word's west, own and east words:
// the count including the centre (0-9) plus 8 * alive indexes the rule mask,
// one variable shift a byte.
__device__ __forceinline__ uint32_t step_cells4(uint32_t sw, uint32_t s, uint32_t se,
                                                uint32_t mid, int rb) {
    const uint32_t left = __funnelshift_l(sw, s, 8);   // (s << 8) | (sw >> 24): column c-1
    const uint32_t right = __funnelshift_r(s, se, 8);  // (s >> 8) | (se << 24): column c+1
    const uint32_t idx = left + s + right + (mid << 3);  // count9 + 8 alive, a byte each
    uint32_t out = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j)
        out |= ((static_cast<uint32_t>(rb) >> ((idx >> (8 * j)) & 0xffu)) & 1u) << (8 * j);
    return out;
}

// A kernel launch.  A macro so that a host build can replace it: compiled as
// plain C++ with a stand-in <cuda_runtime.h> that runs each block with one
// thread, the kernels' index arithmetic can be checked where there is no
// card (tests/cuda_emulation/).
#ifndef KERNEL_LAUNCH
#define KERNEL_LAUNCH(kernel, grid, block, smem, stream, ...) \
    kernel<<<(grid), (block), (smem), (stream)>>>(__VA_ARGS__)
#endif
// A launch whose threads exchange registers (barriers between generations,
// lane shuffles): the host build runs each block's threads as threads.
#ifndef KERNEL_LAUNCH_THREADED
#define KERNEL_LAUNCH_THREADED KERNEL_LAUNCH
#endif
