// Stage 1 of an encoder as a table over bit-staged cells, shared by the
// kernels specialised at the package's widths: the whole autoencoder's
// (ae2d.cuh, C1 = 4 at pool 2) and the encoder's (enc3.cuh, C1 = 4 or 2 at
// pool 4 or 2).
//
// The input is cells, 0 or 1, so conv3x3(cells) + b1 takes one of 512 values
// a channel, one a 9-bit neighbourhood.  A block builds the 512-entry table
// of its C1 channels with the generic kernel's sum (bias, then taps 0..8 in
// (dy, dx) order; a tap of 0 adds an exact zero and a tap of 1 an exact
// weight), so every stage-1 pre-activation equals the generic kernel's bit
// for bit, and a pixel costs one shared load of C1 floats indexed by bits of
// the staged rows.  The rows are staged as bits (uint8 cells packed while
// staging, packed words as they come).  The backward adds the taps of a pool
// window's tied maxima as counts packed in one integer (the spread table).
#pragma once

#include "net_stages.cuh"

// Where the keep bits of a dropout stage come from.
constexpr int KEEP_NONE = 0, KEEP_DRAW = 1, KEEP_READ = 2;

// f(r, c) for every (r, c) of a rows x cols grid (cols > 0), thread tid
// taking the flat indices tid, tid + nt, ...: a flat loop's order, without a
// division an element.  Each step starts with a compiler barrier on memory:
// without it the compiler hoists the weights' shared loads out of the walk
// and holds them in registers (the AE2D forward's stage 2: 74), which spills
// at three blocks a multiprocessor and cost that forward 19% on an H100.
template <typename F>
__device__ __forceinline__ void grid_walk(int rows, int cols, F f) {
    const int tid = threadIdx.x, nt = blockDim.x;
    int r = tid / cols, c = tid - r * cols;
    const int dr = nt / cols, dc = nt - dr * cols;
    while (r < rows) {
        asm volatile("" ::: "memory");
        f(r, c);
        r += dr;
        c += dc;
        if (c >= cols) {
            c -= cols;
            ++r;
        }
    }
}

// -- cells as bits -------------------------------------------------------------

// Word k of row r of a plane of cells: bit j is cell 32k + j (zero past W).
// uint8 cells (0 or 1, W a multiple of 4, the plane 4-byte aligned) read four
// at a time and packed by one multiply: (v & 0x01010101) * 0x01020408
// carries byte q's low bit to bit 24 + q and nothing else there.
__device__ __forceinline__ uint32_t cell_word(const uint32_t* __restrict__ plane, int r, int k,
                                              int W, int NW) {
    return plane[static_cast<size_t>(r) * NW + k];
}
__device__ __forceinline__ uint32_t cell_word(const uint8_t* __restrict__ plane, int r, int k,
                                              int W, int NW) {
    const uint32_t* q4 =
        reinterpret_cast<const uint32_t*>(plane + static_cast<size_t>(r) * W + 32 * k);
    const int quads = min(8, (W - 32 * k) / 4);
    uint32_t word = 0;
#pragma unroll
    for (int q = 0; q < 8; ++q)
        if (q < quads) word |= (((q4[q] & 0x01010101u) * 0x01020408u) >> 24) << (4 * q);
    return word;
}

// Rows [r0, r0 + rows) of a [H, W] plane of cells into bits[rows][NS]:
// staged word k holds the plane's word K0 + k (cells 32 (K0 + k) .. + 31),
// zero for words and rows outside the plane.  So cell `col` of a row is bit
// col - 32 K0 of its staged words (row_bits).
template <typename SRC>
__device__ __forceinline__ void stage_bits(uint32_t* bits, const SRC* __restrict__ plane,
                                           int r0, int rows, int K0, int NS, int H, int W) {
    const int NW = (W + 31) / 32;
    grid_walk(rows, NS, [&](int lr, int k) {
        const int r = r0 + lr, g = K0 + k;
        bits[lr * NS + k] = (r >= 0 && r < H && g >= 0 && g < NW) ? cell_word(plane, r, g, W, NW)
                                                                   : 0u;
    });
}

// Bits p .. p + 31 of a staged bit row (p >= 0).
__device__ __forceinline__ uint32_t row_bits(const uint32_t* row, int p) {
    return __funnelshift_r(row[p >> 5], row[(p >> 5) + 1], p & 31);
}

// The 9-bit neighbourhood indices of the P x P pixels p = P py + px of
// stage-1 pool window (r, c): bit 3 dy + dx is cell (P r + py + dy - 1,
// P c + px + dx - 1), the generic kernel's tap k.  bits holds rows from I0,
// words from K0, NS words a row.
template <int P>
__device__ __forceinline__ void window_indices(const uint32_t* bits, int NS, int I0, int K0,
                                               int r, int c, unsigned idx[P * P]) {
    const uint32_t* row = bits + (P * r - 1 - I0) * NS;
    const int p0 = P * c - 1 - 32 * K0;
    unsigned seg[P + 2];
#pragma unroll
    for (int q = 0; q < P + 2; ++q) seg[q] = row_bits(row + q * NS, p0);
#pragma unroll
    for (int py = 0; py < P; ++py)
#pragma unroll
        for (int px = 0; px < P; ++px)
            idx[py * P + px] = ((seg[py] >> px) & 7u) | (((seg[py + 1] >> px) & 7u) << 3) |
                               (((seg[py + 2] >> px) & 7u) << 6);
}

// -- the table -------------------------------------------------------------------

// C float32 channels in one shared load.
template <int C> struct ChanVec;
template <> struct ChanVec<4> { using type = float4; };
template <> struct ChanVec<2> { using type = float2; };

__device__ __forceinline__ void channels(const float4& t, float z[4]) {
    z[0] = t.x; z[1] = t.y; z[2] = t.z; z[3] = t.w;
}
__device__ __forceinline__ void channels(const float2& t, float z[2]) {
    z[0] = t.x; z[1] = t.y;
}
__device__ __forceinline__ void pack_channels(float4& t, const float z[4]) {
    t = make_float4(z[0], z[1], z[2], z[3]);
}
__device__ __forceinline__ void pack_channels(float2& t, const float z[2]) {
    t = make_float2(z[0], z[1]);
}

// tab[i] = the C channels' conv3x3 + b1 of neighbourhood i (w1 [C, 1, 3, 3],
// b1 [C] in shared memory), summed as the generic kernel sums
// (net_stages.cuh::encoder_stage1_band): bias, then taps 0..8.
template <int C>
__device__ __forceinline__ void build_table(typename ChanVec<C>::type* tab, const float* w1,
                                            const float* b1) {
    for (int i = threadIdx.x; i < 512; i += blockDim.x) {
        float z[C];
#pragma unroll
        for (int c = 0; c < C; ++c) {
            z[c] = b1[c];
#pragma unroll
            for (int k = 0; k < 9; ++k) z[c] += w1[c * 9 + k] * static_cast<float>((i >> k) & 1);
        }
        pack_channels(tab[i], z);
    }
}

// The taps of a pool window's tied pixels as counts: spread[i] holds the bits
// of neighbourhood i BITS apart (bit k at BITS k), so the taps of several
// pixels add as counts in one integer.  A window of P x P pixels needs fields
// that hold P^2: 3 bits at pool 2, 5 at pool 4 (a blank window ties all 16).
template <int P> struct Spread;
template <> struct Spread<2> {
    using type = uint32_t;
    static constexpr int BITS = 3;
};
template <> struct Spread<4> {
    using type = unsigned long long;
    static constexpr int BITS = 5;
};

template <int P>
__device__ __forceinline__ void build_spread(typename Spread<P>::type* spread) {
    using T = typename Spread<P>::type;
    for (int i = threadIdx.x; i < 512; i += blockDim.x) {
        T v = 0;
#pragma unroll
        for (int k = 0; k < 9; ++k) v |= static_cast<T>((i >> k) & 1) << (Spread<P>::BITS * k);
        spread[i] = v;
    }
}

// Tap j's count in a sum of spread entries, as a float: its bits over 2^23's,
// less 2^23 (exact, as the generic kernel's float sum of 0s and 1s).
template <int P>
__device__ __forceinline__ float tap_count(typename Spread<P>::type taps, int j) {
    constexpr int B = Spread<P>::BITS;
    const unsigned v = static_cast<unsigned>(taps >> (B * j)) & ((1u << B) - 1u);
    return __int_as_float(static_cast<int>(v | 0x4b000000u)) - 8388608.f;
}

// -- stage 2 ---------------------------------------------------------------------

// The stage-2 pre-activations conv3x3(x1) + b2 of a 2 x 2 pool window:
// acc[p][o] for pixel p = 2 py + px and channel o, summed as the generic
// kernel (net_stages.cuh::encoder_stage2_preact): bias, then channel, dy, dx.
// x1s holds C1 planes of XR rows of XW floats; (lr0, lc0) is the local place
// of tap (0, 0) of the window's first pixel.  w2 [C2, C1, 3, 3], b2 [C2].
template <int C1, int C2>
__device__ __forceinline__ void stage2_window(const float* x1s, int XR, int XW, int lr0,
                                              int lc0, const float* w2, const float* b2,
                                              float acc[4][C2]) {
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int o = 0; o < C2; ++o) acc[p][o] = b2[o];
#pragma unroll
    for (int c = 0; c < C1; ++c) {
        const float* base = x1s + (c * XR + lr0) * XW + lc0;
        float win[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) win[i][j] = base[i * XW + j];
#pragma unroll
        for (int o = 0; o < C2; ++o)
#pragma unroll
            for (int dy = 0; dy < 3; ++dy)
#pragma unroll
                for (int dx = 0; dx < 3; ++dx) {
                    const float w = w2[(o * C1 + c) * 9 + dy * 3 + dx];
#pragma unroll
                    for (int p = 0; p < 4; ++p)
                        acc[p][o] += w * win[(p >> 1) + dy][(p & 1) + dx];
                }
    }
}
