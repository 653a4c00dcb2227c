// bit_regs.cuh: K Life-like generations of row-major packed universes held in
// REGISTERS, as the register-resident kernels walk them: bit_multi_step.cu's
// bit_regs_kernel (words in and out, PERF.md rows 2 and 10) and
// ca_multi_step.cu's ca_bits_kernel (uint8 cells in and out, row 12).
//
// A thread owns R rows of V adjacent words; L = NW / V lanes (adjacent
// threads) cover a row and pass their edge words by lane shuffles.  Once an
// exchange each thread stores its top row into the slots of the threads
// above it and its bottom row into the slots of those below (shared memory),
// builds its own rows' pair planes, waits at one barrier and reads its ghost
// rows from its own slots: one barrier an exchange (the slots alternate),
// every other operand a register.  An exchange runs G generations: G = 1
// trades one ghost row a side; G = 2 (one row a thread) trades two, and the
// thread computes the rows above and below its own once more itself (three
// rows, then its own), so one barrier serves two generations.  CL = 1: a
// block holds whole universes (threads / (H / R * L) of them).  CL > 1: a
// universe is split over a thread-block cluster of CL blocks, a band of
// H / CL rows each, so its generations run on CL multiprocessors (the
// server's /rollout: one universe, many generations); the bands' edge rows
// are stored into the neighbouring blocks' slots through distributed shared
// memory before a split cluster barrier (arrive, own planes, wait).
#pragma once
#include "bit_words.cuh"

#ifndef CUDA_EMULATION
#include <cooperative_groups.h>

template <int CL>
__device__ __forceinline__ void band_arrive() {
    if constexpr (CL > 1) asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

template <int CL>
__device__ __forceinline__ void band_wait() {
    if constexpr (CL > 1)
        asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
    else
        __syncthreads();
}

template <int CL>
__device__ __forceinline__ int band_rank() {
    if constexpr (CL > 1)
        return static_cast<int>(cooperative_groups::this_cluster().block_rank());
    else
        return 0;
}

// p (this block's shared memory) in the block of cluster rank `rank`.
template <int CL>
__device__ __forceinline__ uint32_t* band_ptr(uint32_t* p, int rank) {
    if constexpr (CL > 1)
        return cooperative_groups::this_cluster().map_shared_rank(p, rank);
    else
        return p;
}
#else
// The host build runs clusters of one block: the block barrier at the wait,
// its own shared memory; lane shuffles are the shim's.
template <int CL>
__device__ __forceinline__ void band_arrive() {}
template <int CL>
__device__ __forceinline__ void band_wait() { __syncthreads(); }
template <int CL>
__device__ __forceinline__ int band_rank() { return 0; }
template <int CL>
__device__ __forceinline__ uint32_t* band_ptr(uint32_t* p, int) { return p; }
#endif

// Lane (lane + delta) mod L of the caller's L adjacent lanes.
template <int L>
__device__ __forceinline__ uint32_t lane_word(uint32_t v, int delta) {
    if constexpr (L > 1)
        return __shfl_sync(0xffffffffu, v, (static_cast<int>(threadIdx.x) + delta) & (L - 1), L);
    else
        return v;
}

// A row's words with their pair planes, the row's west and east edge words
// from the neighbouring lanes (wrapping: the torus over the width).
template <int V, int L>
__device__ __forceinline__ void lane_row(const uint32_t (&w)[V], RowPlanes<V>& p) {
    const uint32_t west = lane_word<L>(w[V - 1], -1);
    const uint32_t east = lane_word<L>(w[0], 1);
    row_planes<V>(w, west, east, p);
}

// Where a thread of a register-resident block sits: its universe n (nn, the
// universe it computes: the last one for a spare band of the last block,
// which stores nothing), its band's cluster rank, its row group rg of R rows
// and its lane among the L a row.
struct RegsPlace {
    int u, per, rg, lane, rank, groups, n, nn;
    bool live;
};

template <int L, int R, int CL>
__device__ __forceinline__ RegsPlace regs_place(int tid, int nt, int N, int H) {
    RegsPlace p;
    p.groups = H / CL / R;  // row groups a band
    p.per = p.groups * L;   // threads a band
    p.u = tid / p.per;
    const int t = tid - p.u * p.per;
    p.rg = t / L;
    p.lane = t - p.rg * L;
    p.rank = band_rank<CL>();
    p.n = CL > 1 ? static_cast<int>(blockIdx.x) / CL
                 : static_cast<int>(blockIdx.x) * (nt / p.per) + p.u;
    p.live = p.n < N;
    p.nn = p.live ? p.n : N - 1;
    return p;
}

// `steps` generations of the rows st a thread holds at `at`, exchanging
// ghost rows through `ex` (2 x blockDim x 2 G x V words of shared memory).
template <int V, int L, int R, int CL, int G>
__device__ __forceinline__ void regs_generations(uint32_t (&st)[R][V], const Leaves& leaves,
                                                 const RegsPlace& at, uint32_t* ex,
                                                 int steps) {
    static_assert(G == 1 || (G == 2 && R == 1), "two generations an exchange: a row a thread");
    constexpr int SLOTS = 2 * G;  // slots: the G rows above, then the G below
    const int tid = threadIdx.x, nt = blockDim.x;
    // The thread j row groups away (j < 0: above; across a band's edge, the
    // neighbouring band's, in the same universe) and its cluster rank.
    int away_t[SLOTS], away_rank[SLOTS];
#pragma unroll
    for (int k = 0; k < SLOTS; ++k) {
        const int j = k < G ? k - G : k - G + 1;  // -G .. -1, 1 .. G
        int g = at.rg + j, r = at.rank;
        if (g < 0) {
            g += at.groups;
            r = (at.rank + CL - 1) % CL;
        } else if (g >= at.groups) {
            g -= at.groups;
            r = (at.rank + 1) % CL;
        }
        away_t[k] = at.u * at.per + g * L + at.lane;
        away_rank[k] = r;
    }
    if constexpr (CL > 1) {  // every block of the cluster has started before the first
        band_arrive<CL>();   // store into its shared memory
        band_wait<CL>();
    }
    for (int s = 0; s < steps; s += G) {
        uint32_t* buf = ex + static_cast<size_t>((s / G) & 1) * nt * SLOTS * V;
        // my top row is row j below for the thread j above (its slot G - 1 + j),
        // my bottom row row j above for the thread j below (its slot G - j)
#pragma unroll
        for (int k = 0; k < SLOTS; ++k) {
            const int j = k < G ? G - k : k - G + 1;
            uint32_t* slot = buf + (away_t[k] * SLOTS + (k < G ? G - 1 + j : G - j)) * V;
            store_words<V>(away_rank[k] == at.rank ? slot : band_ptr<CL>(slot, away_rank[k]),
                           k < G ? st[0] : st[R - 1]);
        }
        band_arrive<CL>();
        RowPlanes<V> up, mid, dn;
        lane_row<V, L>(st[0], mid);
        band_wait<CL>();
        const uint32_t* mine = buf + tid * SLOTS * V;
        uint32_t w[V];
        if constexpr (G == 2) {
            if (s + 1 < steps) {  // two generations: the rows above and below, then its own
                RowPlanes<V> a2, b2;
                load_words<V>(mine, w);
                lane_row<V, L>(w, a2);
                load_words<V>(mine + V, w);
                lane_row<V, L>(w, up);
                load_words<V>(mine + 2 * V, w);
                lane_row<V, L>(w, dn);
                load_words<V>(mine + 3 * V, w);
                lane_row<V, L>(w, b2);
                uint32_t na[V], nb[V];
                step_row<V>(a2, up, mid, leaves, na);
                step_row<V>(mid, dn, b2, leaves, nb);
                step_row<V>(up, mid, dn, leaves, st[0]);
                lane_row<V, L>(na, up);
                lane_row<V, L>(st[0], mid);
                lane_row<V, L>(nb, dn);
                step_row<V>(up, mid, dn, leaves, st[0]);
                continue;
            }
        }
        load_words<V>(mine + (G - 1) * V, w);  // the row above
        lane_row<V, L>(w, up);
#pragma unroll
        for (int i = 0; i < R; ++i) {
            if (i + 1 < R) {
                lane_row<V, L>(st[i + 1], dn);
            } else {
                load_words<V>(mine + G * V, w);  // the row below
                lane_row<V, L>(w, dn);
            }
            step_row<V>(up, mid, dn, leaves, st[i]);
            up = mid;
            mid = dn;
        }
    }
    // (a neighbour's last stores into this block landed before its last wait)
}

// The (V, L, R, CL, G) instantiations a plan may name: NW = V L words a row.
// ops/cuda_bitpack.py reads this list (REGS_PLANS): keep it one macro.
#define BIT_REGS_PLANS(X)                                                                  \
    X(8, 1, 4, 1, 1) X(8, 1, 1, 1, 1) X(4, 1, 4, 1, 1) X(4, 1, 1, 1, 1) X(2, 1, 4, 1, 1) \
    X(2, 1, 1, 1, 1) X(1, 1, 4, 1, 1) X(1, 1, 1, 1, 1) X(2, 4, 1, 1, 2) X(2, 4, 1, 16, 2) \
    X(8, 1, 8, 1, 1)

// Shared memory of a register-resident block: two sets of 2 G slots a thread.
static inline size_t regs_smem(int threads, int V, int G) {
    return 2 * static_cast<size_t>(threads) * 2 * G * V * sizeof(uint32_t);
}
