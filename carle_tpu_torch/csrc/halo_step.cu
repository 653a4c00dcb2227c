// halo_step: Life-like generations of universes whose rows are split over
// the slots of a mesh (parallel/mesh.py), each slot's rows an allocation of
// its own.
//
// Replaces carle_tpu/parallel/pallas_halo.py::
//   spatial_ca_step_pallas         (one uint8 generation; kernel _halo_kernel)
//   spatial_multi_step_pallas      (K uint8 generations; _halo_multi_kernel)
//   bit_spatial_multi_step_pallas  (K packed generations; _bit_halo_multi_kernel)
// and the fixed-rule packed path of carle_tpu/parallel/spatial.py::
// bit_spatial_multi_step(static_rules=...) (-DSTATIC_RULE=<mask>).
//
// A slot holds rows [s HL, (s + 1) HL) of every universe: [N, HL, W] uint8
// cells or [N, HL, W/32] packed words.  A generation needs one ghost row from
// each ring neighbour (slot 0's north is slot n-1: the torus), and the TPU
// kernels send those rows by remote DMA while they compute the interior.
// Here a neighbour's row is read in place, through its device pointer: a
// plain load on one card, a peer load over NVLink between cards (the mesh
// checks peer access).  The update is common.cuh's, the one the single-device
// engines run: step_word_rows on packed words (carry-save count, the rule's
// mux tree), column_sums_rows + step_cells4 on uint8 cells read 4 to a word.
// Columns stay inside a slot, so they wrap as in bit_multi_step.cu.
//
// Double buffers: a launch (a generation, or the packed kernels' chunk of T
// generations) reads one buffer of every slot (its own rows and the ghost
// rows of each neighbour) and writes the other, so no slot overwrites a row a
// neighbour still reads.  The launch boundary on a device's stream is the
// barrier between launches; between devices the caller records an event on
// each device's stream and waits on its neighbours' (parallel/cuda_halo.py).
// One launch covers every slot on a device, with the slots' own and their
// neighbours' pointers in a table passed by value: one launch per device per
// generation (or chunk), not per slot.
//
// Bound on an H100: the packed update is ~37 integer operations a word a
// generation (a row's pair planes built once; chip_smoke.py counts them)
// against 8 bytes moved a word a launch: one generation a launch is bound by
// the bytes (~5.0 us at 8192^2, the operations ~4.6), several by the integer
// ALUs.  The uint8 update moves 2
// bytes a cell (~19 operations a 4-cell word): bytes, ~40 us at 8192^2.
// The uint8 kernels: one thread a word through device memory, its nine loads
// served by L1 and L2, one launch a generation.  The packed kernels
// (bit_halo_words_launch, counted as bit_spatial_words; the present
// bit_halo_kernel with cuda_halo.BIT_HALO_BLOCKS off): one generation by
// bit_words.cuh's streaming kernel; K generations by temporal blocking, T
// generations a launch on bands staged in shared memory with T ghost rows a
// side, so a burst of K takes ceil(K / T) launches and the slots' rows pass
// through device memory once a launch, not once a generation.
#include "bit_words.cuh"
#include "common.cuh"

#ifdef STATIC_RULE
static_assert(STATIC_RULE >= 0 && STATIC_RULE < (1 << 18), "an 18-bit rule mask");
#endif

constexpr int MAX_SLOTS = 64;  // slots a launch covers (the table is a kernel argument)

struct HaloTable {
    const uint32_t* src[MAX_SLOTS];    // the slot's words this generation
    uint32_t* dst[MAX_SLOTS];          // and the next
    const uint32_t* north[MAX_SLOTS];  // row HL-1 of universe 0 of the slot above
    const uint32_t* south[MAX_SLOTS];  // row 0 of universe 0 of the slot below
};

// Packed words [N, HL, NW] a slot; grid (word blocks, slots, universes).
template <int RULE>
__global__ void bit_halo_kernel(HaloTable t, const int32_t* __restrict__ rule,
                                int rule_stride, int HL, int NW) {
    const int s = blockIdx.y, n = blockIdx.z;
    const size_t plane = static_cast<size_t>(HL) * NW;
    const uint32_t* src = t.src[s] + n * plane;
    const uint32_t* north = t.north[s] + n * plane;
    const uint32_t* south = t.south[s] + n * plane;
    uint32_t* dst = t.dst[s] + n * plane;
    const Leaves leaves = make_leaves(rule_of<RULE>(rule, rule_stride, n));
    for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < plane;
         i += static_cast<size_t>(gridDim.x) * blockDim.x) {
        const int r = static_cast<int>(i / NW);
        const int k = static_cast<int>(i - static_cast<size_t>(r) * NW);
        const uint32_t* mid = src + static_cast<size_t>(r) * NW;
        const uint32_t* up = r == 0 ? north : mid - NW;
        const uint32_t* dn = r == HL - 1 ? south : mid + NW;
        dst[i] = step_word_rows(up, mid, dn, NW, k, leaves);
    }
}

// uint8 cells [N, HL, W] a slot, read as QW = W/4 words of 4 cells.
__global__ void halo_u8_kernel(HaloTable t, const int32_t* __restrict__ rule,
                               int rule_stride, int HL, int QW) {
    const int s = blockIdx.y, n = blockIdx.z;
    const size_t plane = static_cast<size_t>(HL) * QW;
    const uint32_t* src = t.src[s] + n * plane;
    const uint32_t* north = t.north[s] + n * plane;
    const uint32_t* south = t.south[s] + n * plane;
    uint32_t* dst = t.dst[s] + n * plane;
    const int rb = rule[static_cast<size_t>(n) * rule_stride];
    for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < plane;
         i += static_cast<size_t>(gridDim.x) * blockDim.x) {
        const int r = static_cast<int>(i / QW);
        const int q = static_cast<int>(i - static_cast<size_t>(r) * QW);
        const uint32_t* mid = src + static_cast<size_t>(r) * QW;
        const uint32_t* up = r == 0 ? north : mid - QW;
        const uint32_t* dn = r == HL - 1 ? south : mid + QW;
        const int qw = q == 0 ? QW - 1 : q - 1, qe = q == QW - 1 ? 0 : q + 1;
        uint32_t centre, unused;
        const uint32_t sw = column_sums_rows(up, mid, dn, qw, unused);
        const uint32_t sc = column_sums_rows(up, mid, dn, q, centre);
        const uint32_t se = column_sums_rows(up, mid, dn, qe, unused);
        dst[i] = step_cells4(sw, sc, se, centre, rb);
    }
}

// Generations [t0, t1) of `steps` on the S slots `slots` (of the n in the
// ring) that live on `device`.  in, scratch and out hold every slot's pointer
// (host arrays of n): generation t reads `in` (t = 0) or the buffer the last
// generation wrote, and writes scratch or out so that the last lands in out.
// kind: KIND_U8 (W cells a row, W % 4 == 0) or KIND_U32 (W words a row).  The
// rule is one int32 (rule_stride 0) or one a universe (1), on `device`; a
// library built with -DSTATIC_RULE fixes the packed rule and ignores it.
extern "C" int halo_step_launch(int kind, const void* const* in, void* const* scratch,
                                void* const* out, const int* slots, int S, int n,
                                const void* rule, int rule_stride, int N, int HL, int W,
                                int steps, int t0, int t1, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (S < 1 || S > MAX_SLOTS || n < S || N < 1 || N > 65535 || HL < 1 || t0 < 0 ||
        t1 > steps || (kind != KIND_U8 && kind != KIND_U32) || (kind == KIND_U8 && W % 4))
        return static_cast<int>(cudaErrorInvalidValue);
    const int NW = kind == KIND_U8 ? W / 4 : W;  // 32-bit words a row
    const size_t plane = static_cast<size_t>(HL) * NW;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int32_t* rb = static_cast<const int32_t*>(rule);
    auto buffer = [&](int t, int j) -> uint32_t* {  // what generation t writes in slot j
        return static_cast<uint32_t*>(((steps - t) % 2) ? out[j] : scratch[j]);
    };
    auto source = [&](int t, int j) -> const uint32_t* {  // what it reads
        return t == 0 ? static_cast<const uint32_t*>(in[j]) : buffer(t - 1, j);
    };
    const unsigned blocks = static_cast<unsigned>((plane + 255) / 256);
    for (int t = t0; t < t1; ++t) {
        HaloTable table;
        for (int i = 0; i < S; ++i) {
            const int j = slots[i];
            if (j < 0 || j >= n) return static_cast<int>(cudaErrorInvalidValue);
            table.src[i] = source(t, j);
            table.dst[i] = buffer(t, j);
            table.north[i] = source(t, (j + n - 1) % n) + (plane - NW);
            table.south[i] = source(t, (j + 1) % n);
        }
        const dim3 grid(blocks, S, N);
        if (kind == KIND_U8) {
            KERNEL_LAUNCH(halo_u8_kernel, grid, 256, 0, st, table, rb, rule_stride, HL, NW);
        } else {
#ifdef STATIC_RULE
            KERNEL_LAUNCH(bit_halo_kernel<STATIC_RULE>, grid, 256, 0, st, table, rb, rule_stride,
                          HL, NW);
#else
            KERNEL_LAUNCH(bit_halo_kernel<-1>, grid, 256, 0, st, table, rb, rule_stride, HL, NW);
#endif
        }
        err = cudaGetLastError();
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    return static_cast<int>(cudaSuccess);
}

// -- The redesigned halo kernels (bit_halo_words_launch, u8_halo_bits_launch).
//
// K = 1 on packed words: bit_words.cuh's streaming kernel over every slot of
// the device (grid y), a strip's ghost row at a slot's first and last row
// read from the neighbour's buffer.  K > 1: temporal blocking.  A block
// stages a band of R rows of one universe of one slot, with `gens` ghost rows
// each side (from the neighbours' buffers past the slot's edges), in shared
// memory as packed words, runs `gens` generations on it, each on a region one
// row shorter each side than the last (the trapezoid: the rows whose
// neighbourhoods are still exact), and writes its R rows.  The launcher steps
// the K generations in chunks of T: one launch a chunk, not a generation, and
// a slot's rows pass through device memory once a chunk.  T <= HL: the ghost
// rows of a slot come from its ring neighbours alone.
//
// The staging policy says what the slots hold.  WordRows: packed words, copied
// as they are.  ByteRows: uint8 cells, packed on the load and unpacked on the
// store, so a uint8 burst runs its generations on bits (37 operations a
// 32-cell word, not 19 a 4-cell byte word) and its cells cross device memory
// once a chunk, not once a generation.  The generations loop is the same.

// Packed words: a row is NW words in device memory.
template <int V>
struct WordRows {
    static constexpr int UNITS = 1;  // 32-bit units of device memory a packed word

    // Staged rows [0, E) are rows first .. first + E - 1 of universe n of the slot.
    __device__ __forceinline__ static void stage(uint32_t* cur, const SlotRows& sl, size_t plane,
                                                 int n, int first, int E, int HL, int NW) {
        const int tid = threadIdx.x, nt = blockDim.x;
        const int lanes = nt < 32 ? nt : 32, lane = tid % lanes, warp = tid / lanes,
                  warps = nt / lanes;
        constexpr int C = V % 4 == 0 ? 4 : 1;  // words a staging access
        for (int i = warp; i < E; i += warps) {
            const uint32_t* row = slot_row(sl, plane, n, first + i, HL, NW);
            for (int c = lane * C; c < NW; c += lanes * C) {
                uint32_t w[C];
                load_words<C>(row + c, w);
                store_words<C>(cur + static_cast<size_t>(i) * NW + c, w);
            }
        }
    }

    // The staged rows src [rows][NW] to dst, rows of NW words.
    __device__ __forceinline__ static void store(uint32_t* dst, const uint32_t* src, int rows,
                                                 int NW) {
        const int tid = threadIdx.x, nt = blockDim.x;
        const int lanes = nt < 32 ? nt : 32, lane = tid % lanes, warp = tid / lanes,
                  warps = nt / lanes;
        constexpr int C = V % 4 == 0 ? 4 : 1;
        for (int i = warp; i < rows; i += warps)
            for (int c = lane * C; c < NW; c += lanes * C) {
                uint32_t w[C];
                load_words<C>(src + static_cast<size_t>(i) * NW + c, w);
                store_words<C>(dst + static_cast<size_t>(i) * NW + c, w);
            }
    }
};

// uint8 cells (0 or 1; packed as != 0, as ops/bitpack.py::pack_grid does): a
// row is 32 NW bytes, 8 NW units.  A thread takes 16-byte pieces of the band:
// piece p of a row is cells 16 p .. 16 p + 15, half of packed word p / 2
// (a lane a byte and a warp ballot a word issue 16 times the loads and
// measured 3.2x slower at 8192² over 4 slots on an H100).  The load gathers
// a piece's 16 nonzero flags into 16 bits (each 4-byte quad's flags to the
// top bit of its bytes, then one multiply carries them to 4 adjacent
// bits), and lanes 2k and 2k + 1 join their halves into the
// word by one shuffle (a block is whole warps, so a pair is two lanes of one
// warp).  The store spreads half a word over 16 bytes (a multiply a 4-bit
// nibble).  Every thread runs the same number of steps (the shuffle takes the
// whole warp), U pieces a step, their loads all issued before the first is
// used, so a step waits for memory once.
struct ByteRows {
    static constexpr int UNITS = 8;
    static constexpr int U = 8;  // pieces a thread has in flight

    // The 4 bits of a 4-byte quad q, bit j set where byte j is not zero.
    __device__ __forceinline__ static uint32_t quad_bits(uint32_t q) {
        const uint32_t top = (((q & 0x7f7f7f7fu) + 0x7f7f7f7fu) | q) & 0x80808080u;
        return ((top >> 7) * 0x01020408u) >> 24;
    }

    // The 4 bytes (0 or 1) of the 4 bits of nibble b.
    __device__ __forceinline__ static uint32_t nibble_bytes(uint32_t b) {
        return (b * 0x00204081u) & 0x01010101u;
    }

    __device__ __forceinline__ static void stage(uint32_t* cur, const SlotRows& sl, size_t plane,
                                                 int n, int first, int E, int HL, int NW) {
        const int tid = threadIdx.x, nt = blockDim.x, Q = 2 * NW, total = E * Q;
        const bool low = (tid & 1) == 0;  // the lane holding the word's cells 0-15
        for (int base = 0; base < total; base += U * nt) {
            uint4 v[U];
#pragma unroll
            for (int u = 0; u < U; ++u) {
                const int idx = base + u * nt + tid, i = idx / Q, p = idx - i * Q;
                v[u] = idx < total ? reinterpret_cast<const uint4*>(
                                         slot_row(sl, plane, n, first + i, HL, 8 * NW))[p]
                                   : make_uint4(0u, 0u, 0u, 0u);
            }
#pragma unroll
            for (int u = 0; u < U; ++u) {
                const int idx = base + u * nt + tid, i = idx / Q, p = idx - i * Q;
                const uint32_t half = quad_bits(v[u].x) | quad_bits(v[u].y) << 4 |
                                      quad_bits(v[u].z) << 8 | quad_bits(v[u].w) << 12;
                const uint32_t other = __shfl_sync(0xffffffffu, half, (tid & 31) ^ 1);
                if (idx < total && low)
                    cur[static_cast<size_t>(i) * NW + (p >> 1)] = half | other << 16;
            }
        }
    }

    __device__ __forceinline__ static void store(uint32_t* dst, const uint32_t* src, int rows,
                                                 int NW) {
        const int tid = threadIdx.x, nt = blockDim.x, Q = 2 * NW;
        for (int idx = tid; idx < rows * Q; idx += nt) {
            const int i = idx / Q, p = idx - i * Q;
            const uint32_t half = src[static_cast<size_t>(i) * NW + (p >> 1)] >> (16 * (p & 1));
            reinterpret_cast<uint4*>(dst + static_cast<size_t>(i) * 8 * NW)[p] =
                make_uint4(nibble_bytes(half & 15u), nibble_bytes((half >> 4) & 15u),
                           nibble_bytes((half >> 8) & 15u), nibble_bytes((half >> 12) & 15u));
        }
    }
};

template <int RULE, int V, int SLOTS, typename Rows>
__global__ void __launch_bounds__(512)
    bit_blocks_kernel(const __grid_constant__ SlotTable<SLOTS> t, const int32_t* __restrict__ rule,
                      int rule_stride, int HL, int NW, int R, int bands, int gens, int S) {
    extern __shared__ float smem[];  // two buffers of (R + 2 gens) rows of NW words
    const SlotRows& sl = t.s[blockIdx.y];
    const int n = blockIdx.x / bands, band = blockIdx.x - n * bands;
    const int r0 = band * R, rows = min(R, HL - r0), E = rows + 2 * gens;
    const int RU = Rows::UNITS * NW;  // 32-bit units a row in device memory
    const size_t plane = static_cast<size_t>(HL) * RU;
    uint32_t* cur = reinterpret_cast<uint32_t*>(smem);
    uint32_t* nxt = cur + static_cast<size_t>(R + 2 * gens) * NW;
    const int tid = threadIdx.x, nt = blockDim.x;
    // staged row i is row r0 - gens + i of the slot
    Rows::stage(cur, sl, plane, n, r0 - gens, E, HL, NW);
    const Leaves leaves = make_leaves(rule_of<RULE>(rule, rule_stride, n));
    const int G = NW / V;
    __syncthreads();
    for (int g = 1; g <= gens; ++g) {  // staged rows [g, E - g) this generation
        const int strips = (E - 2 * g + S - 1) / S;
        for (int i = tid; i < strips * G; i += nt) {
            const int strip = i / G, k0 = (i - strip * G) * V;
            const int s0 = g + strip * S, s1 = min(s0 + S, E - g);
            RowPlanes<V> up, mid, dn;
            load_row<V>(cur + static_cast<size_t>(s0 - 1) * NW, k0, NW, up);
            load_row<V>(cur + static_cast<size_t>(s0) * NW, k0, NW, mid);
            for (int r = s0; r < s1; ++r) {
                load_row<V>(cur + static_cast<size_t>(r + 1) * NW, k0, NW, dn);
                uint32_t w[V];
                step_row<V>(up, mid, dn, leaves, w);
                store_words<V>(nxt + static_cast<size_t>(r) * NW + k0, w);
                up = mid;
                mid = dn;
            }
        }
        __syncthreads();
        uint32_t* tmp = cur;
        cur = nxt;
        nxt = tmp;
    }
    Rows::store(sl.dst + n * plane + static_cast<size_t>(r0) * RU,
                cur + static_cast<size_t>(gens) * NW, rows, NW);
}

#ifdef STATIC_RULE
constexpr int HALO_RULE = STATIC_RULE;
#else
constexpr int HALO_RULE = -1;
#endif

// Shared memory of a band of R rows with T ghost rows each side, two copies.
static inline size_t blocks_smem(int R, int T, int NW) {
    return 2 * static_cast<size_t>(R + 2 * T) * NW * sizeof(uint32_t);
}

// Chunks [c0, c1) of the ceil(steps / T) chunks of T generations (the last
// may be shorter) on the S slots `slots` (of the n in the ring) of a device:
// in, scratch and out hold every slot's pointer (host arrays of n); chunk c
// reads `in` (c = 0) or the buffer chunk c - 1 wrote, and writes scratch or
// out so that the last lands in out.  launch(table, gens) launches one chunk
// and returns an error code.
template <typename Launch>
static int run_chunks(const void* const* in, void* const* scratch, void* const* out,
                      const int* slots, int S, int n, int steps, int T, int c0, int c1,
                      Launch launch) {
    const int chunks = (steps + T - 1) / T;
    auto buffer = [&](int c, int j) -> uint32_t* {  // what chunk c writes in slot j
        return static_cast<uint32_t*>(((chunks - c) % 2) ? out[j] : scratch[j]);
    };
    auto source = [&](int c, int j) -> const uint32_t* {  // what it reads
        return c == 0 ? static_cast<const uint32_t*>(in[j]) : buffer(c - 1, j);
    };
    for (int c = c0; c < c1; ++c) {
        SlotTable<MAX_SLOTS> table;
        for (int i = 0; i < S; ++i) {
            const int j = slots[i];
            if (j < 0 || j >= n) return static_cast<int>(cudaErrorInvalidValue);
            table.s[i] = SlotRows{source(c, j), buffer(c, j), source(c, (j + n - 1) % n),
                                  source(c, (j + 1) % n)};
        }
        const int rc = launch(table, T < steps - c * T ? T : steps - c * T);
        if (rc != 0) return rc;
    }
    return static_cast<int>(cudaSuccess);
}

// The arguments both launchers check: chunks [c0, c1) of T generations on
// bands of `rows` rows, `threads` a block.
static bool chunks_ok(int S, int n, int N, int HL, int NW, int steps, int T, int c0, int c1,
                      int V, int rows, int strip, int threads) {
    const int chunks = T >= 1 ? (steps + T - 1) / T : 0;
    return S >= 1 && S <= MAX_SLOTS && n >= S && N >= 1 && HL >= 1 && NW >= 1 && steps >= 1 &&
           T >= 1 && T <= HL && c0 >= 0 && c1 <= chunks && rows >= 1 && strip >= 1 &&
           threads >= 1 && (V == 1 || V == 4) && NW % V == 0 &&
           (threads <= 32 || threads % 32 == 0);
}

// Packed words [N, HL, NW] a slot, chunks [c0, c1) as run_chunks.  T = 1:
// each chunk a generation by the streaming kernel (V words, strips of `strip`
// rows, `threads` a block); T > 1: bit_blocks_kernel on bands of `rows` rows,
// compute strips of `strip` rows, `threads` a block.  The rule as
// halo_step_launch's; a library built with -DSTATIC_RULE fixes it.
extern "C" int bit_halo_words_launch(const void* const* in, void* const* scratch,
                                     void* const* out, const int* slots, int S, int n,
                                     const void* rule, int rule_stride, int N, int HL, int NW,
                                     int steps, int T, int c0, int c1, int V, int rows,
                                     int strip, int threads, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (!chunks_ok(S, n, N, HL, NW, steps, T, c0, c1, V, rows, strip, threads))
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int32_t* rb = static_cast<const int32_t*>(rule);
    const int bands = (HL + rows - 1) / rows;
    const size_t smem = blocks_smem(rows, T, NW);
    if (T > 1 && (threads > 512 || static_cast<long long>(N) * bands >= (1LL << 31)))
        return static_cast<int>(cudaErrorInvalidValue);
    const auto kernel = V == 4 ? bit_blocks_kernel<HALO_RULE, 4, MAX_SLOTS, WordRows<4>>
                               : bit_blocks_kernel<HALO_RULE, 1, MAX_SLOTS, WordRows<1>>;
    if (T > 1) {
        err = allow_smem(kernel, smem);
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    return run_chunks(in, scratch, out, slots, S, n, steps, T, c0, c1,
                      [&](const SlotTable<MAX_SLOTS>& table, int gens) -> int {
        if (T == 1)
            return stream_launch<HALO_RULE, MAX_SLOTS>(table, S, rb, rule_stride, N, HL, NW, V,
                                                       strip, threads, st);
        const dim3 grid(static_cast<unsigned>(N) * bands, S);
        KERNEL_LAUNCH(kernel, grid, threads, smem, st, table, rb, rule_stride, HL, NW, rows,
                      bands, gens, strip);
        return static_cast<int>(cudaGetLastError());
    });
}

// uint8 cells [N, HL, W] a slot (W % 32 == 0, every buffer 16-byte aligned),
// chunks [c0, c1) as run_chunks, each a launch of bit_blocks_kernel on the
// cells packed as they are staged (ByteRows): bands of `rows` rows with T >= 1
// ghost rows a side, compute strips of `strip` rows, `threads` a block (whole
// warps).  The rule as halo_step_launch's.
extern "C" int u8_halo_bits_launch(const void* const* in, void* const* scratch, void* const* out,
                                   const int* slots, int S, int n, const void* rule,
                                   int rule_stride, int N, int HL, int W, int steps, int T,
                                   int c0, int c1, int V, int rows, int strip, int threads,
                                   int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int NW = W / 32;
    const int bands = rows >= 1 ? (HL + rows - 1) / rows : 0;
    if (W % 32 || !chunks_ok(S, n, N, HL, NW, steps, T, c0, c1, V, rows, strip, threads) ||
        threads % 32 || threads > 512 || static_cast<long long>(N) * bands >= (1LL << 31))
        return static_cast<int>(cudaErrorInvalidValue);
    for (int i = 0; i < n; ++i)
        if ((reinterpret_cast<uintptr_t>(in[i]) | reinterpret_cast<uintptr_t>(scratch[i]) |
             reinterpret_cast<uintptr_t>(out[i])) % 16)
            return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int32_t* rb = static_cast<const int32_t*>(rule);
    const size_t smem = blocks_smem(rows, T, NW);
    const auto kernel = V == 4 ? bit_blocks_kernel<-1, 4, MAX_SLOTS, ByteRows>
                               : bit_blocks_kernel<-1, 1, MAX_SLOTS, ByteRows>;
    err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    return run_chunks(in, scratch, out, slots, S, n, steps, T, c0, c1,
                      [&](const SlotTable<MAX_SLOTS>& table, int gens) -> int {
        const dim3 grid(static_cast<unsigned>(N) * bands, S);
        KERNEL_LAUNCH_THREADED(kernel, grid, threads, smem, st, table, rb, rule_stride, HL, NW,
                               rows, bands, gens, strip);
        return static_cast<int>(cudaGetLastError());
    });
}

// Registers, static shared memory, spills and resident blocks a
// multiprocessor of the temporal-blocking kernel (V words, bands of `rows`
// rows, T generations, NW words a row) or, rows == 0, of the streaming one.
extern "C" int bit_halo_words_occupancy(int V, int rows, int T, int NW, int threads, int device,
                                        int* out) {
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (rows == 0) {
        const auto kernel = V == 4 ? bit_stream_kernel<HALO_RULE, 4, MAX_SLOTS>
                                   : bit_stream_kernel<HALO_RULE, 1, MAX_SLOTS>;
        return kernel_occupancy(kernel, threads, 0, out);
    }
    const auto kernel = V == 4 ? bit_blocks_kernel<HALO_RULE, 4, MAX_SLOTS, WordRows<4>>
                               : bit_blocks_kernel<HALO_RULE, 1, MAX_SLOTS, WordRows<1>>;
    return kernel_occupancy(kernel, threads, blocks_smem(rows, T, NW), out);
}

// The same of the uint8 kernel (u8_halo_bits_launch) at W = 32 NW cells a row.
extern "C" int u8_halo_bits_occupancy(int V, int rows, int T, int NW, int threads, int device,
                                      int* out) {
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return static_cast<int>(e);
    const auto kernel = V == 4 ? bit_blocks_kernel<-1, 4, MAX_SLOTS, ByteRows>
                               : bit_blocks_kernel<-1, 1, MAX_SLOTS, ByteRows>;
    return kernel_occupancy(kernel, threads, blocks_smem(rows, T, NW), out);
}

// Let `device` read `peer`'s memory (a mesh whose slots span several cards).
extern "C" int halo_enable_peer(int device, int peer) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaDeviceEnablePeerAccess(peer, 0);
    if (err == cudaErrorPeerAccessAlreadyEnabled) {
        cudaGetLastError();  // clear the error it leaves behind
        return static_cast<int>(cudaSuccess);
    }
    return static_cast<int>(err);
}
