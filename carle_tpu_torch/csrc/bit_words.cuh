// bit_words.cuh: the packed Life-like word update as the H100 kernels of
// PERF.md rows 2 and 15 walk it (bit_multi_step.cu's bit_words_launch,
// halo_step.cu's bit_halo_words_launch).
//
// A thread owns V adjacent words of a row (V = 1 or 4: one word or one
// 16-byte access) over a strip of rows, and walks down the strip
// carrying the row above and the centre row as their words and horizontal
// pair planes: each row of the strip is read once (plus the strip's two
// ghost rows) and its pair planes are built once, not three times.  The
// west and east words come from the thread's own words where V covers the
// row, else from one more word load each (served by L1, or shared memory).
// The arithmetic is common.cuh's step_planes, the one step_word_rows runs,
// so the outputs are the other packed kernels' bit for bit.
//
// A universe is a slot of a ring (SlotRows): its own rows, and the rows of
// the slots above and below for the ghost rows past its edges.  A whole
// universe on one device is its own neighbour both ways (the torus); a
// row-sharded universe (parallel/mesh.py) names its ring neighbours' buffers.
#pragma once
#include "common.cuh"

// A row's V words and their weight-1 (a) and weight-2 (b) pair planes.
template <int V>
struct RowPlanes {
    uint32_t g[V], a[V], b[V];
};

template <int V>
__device__ __forceinline__ void row_planes(const uint32_t (&w)[V], uint32_t west, uint32_t east,
                                           RowPlanes<V>& p) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
        p.g[j] = w[j];
        pair_planes(j == 0 ? west : w[j - 1], w[j], j == V - 1 ? east : w[j + 1], p.a[j],
                    p.b[j]);
    }
}

// The centre row's next words.
template <int V>
__device__ __forceinline__ void step_row(const RowPlanes<V>& up, const RowPlanes<V>& mid,
                                         const RowPlanes<V>& dn, const Leaves& leaves,
                                         uint32_t (&out)[V]) {
#pragma unroll
    for (int j = 0; j < V; ++j)
        out[j] = step_planes(up.a[j], up.b[j], up.g[j], mid.a[j], mid.b[j], mid.g[j], dn.a[j],
                             dn.b[j], dn.g[j], leaves);
}

// V words at p, 16 bytes an access where V is a multiple of 4 (p then
// 16-byte aligned).
template <int V>
__device__ __forceinline__ void load_words(const uint32_t* p, uint32_t (&w)[V]) {
    if constexpr (V % 4 == 0) {
#pragma unroll
        for (int q = 0; q < V / 4; ++q) {
            const uint4 u = reinterpret_cast<const uint4*>(p)[q];
            w[4 * q] = u.x;
            w[4 * q + 1] = u.y;
            w[4 * q + 2] = u.z;
            w[4 * q + 3] = u.w;
        }
    } else {
#pragma unroll
        for (int j = 0; j < V; ++j) w[j] = p[j];
    }
}

template <int V>
__device__ __forceinline__ void store_words(uint32_t* p, const uint32_t (&w)[V]) {
    if constexpr (V % 4 == 0) {
#pragma unroll
        for (int q = 0; q < V / 4; ++q)
            reinterpret_cast<uint4*>(p)[q] =
                make_uint4(w[4 * q], w[4 * q + 1], w[4 * q + 2], w[4 * q + 3]);
    } else {
#pragma unroll
        for (int j = 0; j < V; ++j) p[j] = w[j];
    }
}

// Words [k0, k0 + V) of a row of NW words and the words west and east of
// them (the row wraps: the torus over the width).
template <int V>
struct RowWords {
    uint32_t w[V], west, east;
};

template <int V>
__device__ __forceinline__ void load_row_words(const uint32_t* row, int k0, int NW,
                                               RowWords<V>& r) {
    load_words<V>(row + k0, r.w);
    const bool whole = NW == V;
    r.west = whole ? r.w[V - 1] : row[k0 == 0 ? NW - 1 : k0 - 1];
    r.east = whole ? r.w[0] : row[k0 + V == NW ? 0 : k0 + V];
}

// The same with their pair planes.
template <int V>
__device__ __forceinline__ void load_row(const uint32_t* row, int k0, int NW, RowPlanes<V>& p) {
    RowWords<V> r;
    load_row_words<V>(row, k0, NW, r);
    row_planes<V>(r.w, r.west, r.east, p);
}

// One slot of a ring: [N, HL, NW] words a buffer.
struct SlotRows {
    const uint32_t* src;    // the slot's words this launch reads
    uint32_t* dst;          // and writes
    const uint32_t* above;  // the slot above (its last rows are the ghost rows above row 0)
    const uint32_t* below;  // the slot below (its first rows are the ghost rows past HL - 1)
};

// Passed by value as a __grid_constant__ kernel argument, so a thread reads
// its slot's pointers in place instead of copying the table.
template <int SLOTS>
struct SlotTable {
    SlotRows s[SLOTS];
};

// Row r (-HL <= r < 2 HL) of universe n of a slot.
__device__ __forceinline__ const uint32_t* slot_row(const SlotRows& t, size_t plane, int n, int r,
                                                    int HL, int NW) {
    const uint32_t* base = r < 0 ? t.above : (r >= HL ? t.below : t.src);
    const int rr = r < 0 ? r + HL : (r >= HL ? r - HL : r);
    return base + n * plane + static_cast<size_t>(rr) * NW;
}

// One generation streamed through device memory, no shared memory: item
// blockIdx.x * B + i (i < B) of the launch is (universe n0 + u, strip of S
// rows, group of V words), the groups of a strip adjacent; grid (blocks,
// slots).  B is blockDim.x on the card, so each thread takes one item.
template <int RULE, int V, int SLOTS>
__global__ void __launch_bounds__(256)
    bit_stream_kernel(const __grid_constant__ SlotTable<SLOTS> t, const int32_t* __restrict__ rule,
                      int rule_stride, int n0, int N, int HL, int NW, int S, int strips, int B) {
    const SlotRows& sl = t.s[blockIdx.y];
    const int G = NW / V;
    const unsigned per_universe = static_cast<unsigned>(strips) * G;
    const size_t plane = static_cast<size_t>(HL) * NW;
    for (int i = threadIdx.x; i < B; i += blockDim.x) {
        const unsigned item = blockIdx.x * static_cast<unsigned>(B) + i;
        const unsigned u = item / per_universe;
        if (u >= static_cast<unsigned>(N)) break;
        const int rest = static_cast<int>(item - u * per_universe);
        const int strip = rest / G, k0 = (rest - strip * G) * V;
        const int n = n0 + static_cast<int>(u);
        const int r0 = strip * S, r1 = min(r0 + S, HL);
        const Leaves leaves = make_leaves(rule_of<RULE>(rule, rule_stride, n));
        // the row below is loaded a row ahead: its load is in flight while
        // the row above it is computed and stored
        RowPlanes<V> up, mid, dn;
        RowWords<V> next;
        load_row<V>(slot_row(sl, plane, n, r0 - 1, HL, NW), k0, NW, up);
        load_row<V>(slot_row(sl, plane, n, r0, HL, NW), k0, NW, mid);
        load_row_words<V>(slot_row(sl, plane, n, r0 + 1, HL, NW), k0, NW, next);
        uint32_t* dst = sl.dst + n * plane + k0;
        for (int r = r0; r < r1; ++r) {
            row_planes<V>(next.w, next.west, next.east, dn);
            if (r + 1 < r1) load_row_words<V>(slot_row(sl, plane, n, r + 2, HL, NW), k0, NW, next);
            uint32_t w[V];
            step_row<V>(up, mid, dn, leaves, w);
            store_words<V>(dst + static_cast<size_t>(r) * NW, w);
            up = mid;
            mid = dn;
        }
    }
}

// Universes a streaming launch covers: its item index is 32-bit.
static inline int stream_chunk(int N, int HL, int NW, int V, int S) {
    const long long per = static_cast<long long>((HL + S - 1) / S) * (NW / V);
    const long long most = (1LL << 31) / per;
    return static_cast<int>(most < N ? (most < 1 ? 1 : most) : N);
}

// One generation of every slot of `t` (grid y) by the streaming kernel,
// universes in chunks of stream_chunk (one launch each).
template <int RULE, int SLOTS>
static int stream_launch(const SlotTable<SLOTS>& t, int slots, const int32_t* rule,
                         int rule_stride, int N, int HL, int NW, int V, int S, int threads,
                         cudaStream_t st) {
    if (S < 1 || threads < 1 || threads > 256 || (V != 1 && V != 4) || NW % V)
        return static_cast<int>(cudaErrorInvalidValue);
    const int strips = (HL + S - 1) / S;
    const int chunk = stream_chunk(N, HL, NW, V, S);
    for (int n0 = 0; n0 < N; n0 += chunk) {
        const int n = chunk < N - n0 ? chunk : N - n0;
        const long long items = static_cast<long long>(strips) * (NW / V) * n;
        const dim3 grid(static_cast<unsigned>((items + threads - 1) / threads), slots);
        const auto kernel =
            V == 4 ? bit_stream_kernel<RULE, 4, SLOTS> : bit_stream_kernel<RULE, 1, SLOTS>;
        KERNEL_LAUNCH(kernel, grid, threads, 0, st, t, rule, rule_stride, n0, n, HL, NW, S,
                      strips, threads);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    return static_cast<int>(cudaSuccess);
}
