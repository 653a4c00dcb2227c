// enc3_fwd: the wrapper-net encoder's forward at the package's three encoder
// widths, specialised at compile time (enc3.cuh has the widths and the
// design).
//
// Replaces carle_tpu/ops/pallas_head.py::make_fused_encoder's forward kernel
// _enc_fwd_kernel (with its per-instance stage-1 row mask) at those widths;
// encoder_fwd.cu stays the generic instantiation.  Its outputs are the
// generic kernel's bit for bit: every pre-activation is summed in the generic
// order.
//
// Bound on an H100: operations.  With stage 1 a table lookup, what is left
// is stage 2's 9 C1 C2 float32 multiply-adds a stage-1 pixel (9 C1 C2 / P1^2
// a cell) against 1/8 or 1 byte read a cell; with dropout one Philox draw a
// cell (stage 1) and one a stage-1 pixel (stage 2), whose integer multiplies
// and logic outweigh the rest (chip_smoke.py counts a draw by pipe).
//
// A block owns R2 output rows and TW output columns of one instance: it
// stages its input rows as bits, builds the table, computes the pooled
// stage-1 band (its rows and one to either side) into shared memory, then
// the output.  SAVE (a training forward, ops/cuda_head.py::EncoderFn) also
// writes the keep bits of its own stage-1 positions and outputs (Enc3Saved),
// so the backward draws none.  Instances beyond the grid's 65,535 rows go in
// further launches of the same grid.
#include "enc3.cuh"

// Capped at 128 registers (two blocks a multiprocessor): with dropout,
// uncapped, the compiler interleaved the draws into 149-176 registers (one
// block), and the saving forward ran 17% slower on an H100 (a probe).
template <int C1, int C2, int P1, int KEEP, bool SAVE, typename SRC>
__global__ void __launch_bounds__(ENC3_THREADS, 2)
enc3_fwd_kernel(const SRC* __restrict__ x, Enc3Weights wp, const float* __restrict__ mask,
                float* __restrict__ out, Enc3Saved sv, Enc3Shape sh, int N0, DropCfg cfg) {
    using Vec = typename ChanVec<C1>::type;
    using Keep1 = typename UWord<P1 * P1 * C1>::type;
    __shared__ float w1s[C1 * 9], b1s[C1], w2s[C2 * C1 * 9], b2s[C2];
    const Enc3Block b(sh, P1, N0);
    // the stage-1 band: rows 2 o0 - 1 .. 2 (o0 + R), columns 2 oc0 - 1 .. 2 (oc0 + TC)
    const int X0 = 2 * b.o0 - 1, XR = 2 * b.R + 2, XC0 = 2 * b.oc0 - 1, XW = 2 * b.TC + 2;
    const int I0 = P1 * X0 - 1, IR = P1 * XR + 2;
    const int K0 = (P1 * XC0 - 1) >> 5, NS = enc3_words(P1, XW);

    extern __shared__ float smem[];
    Vec* tab = reinterpret_cast<Vec*>(smem);                      // 512
    float* x1s = smem + 512 * C1;                                 // C1 x XR x XW
    uint32_t* bits = reinterpret_cast<uint32_t*>(x1s + C1 * XR * XW);   // IR x NS

    enc3_load_weights<C1, C2>(wp, w1s, b1s, w2s, b2s);
    __syncthreads();
    build_table<C1>(tab, w1s, b1s);
    stage_bits(bits, cells_at(x, static_cast<size_t>(b.n) * sh.H * sh.W), I0, IR, K0, NS, sh.H,
               sh.W);
    __syncthreads();
    Keep1* keep1n = SAVE ? static_cast<Keep1*>(sv.keep1) + static_cast<size_t>(b.n) * b.H1 * b.W1
                         : nullptr;
    enc3_stage1<C1, P1, KEEP, SAVE>(tab, bits, NS, I0, K0, x1s, X0, XR, XC0, XW, b,
                                    mask != nullptr ? mask + static_cast<size_t>(b.n) * b.H1
                                                    : nullptr,
                                    cfg, keep1n);
    __syncthreads();

    // stage 2: output (e, f) pools stage-1 pixels 2e + py, 2f + px, whose
    // taps start at local row 2 (e - o0), column 2 (f - oc0)
    float* on = out + static_cast<size_t>(b.n) * C2 * b.Ho * b.Wo;
    grid_walk(b.R, b.TC, [&](int lr, int lf) {
        const int e = b.o0 + lr, f = b.oc0 + lf;
        float acc[4][C2];
        stage2_window<C1, C2>(x1s, XR, XW, 2 * lr, 2 * lf, w2s, b2s, acc);
        float m[C2];
#pragma unroll
        for (int o = 0; o < C2; ++o) m[o] = NEG_INF;
        unsigned keep8 = 0;
#pragma unroll
        for (int p = 0; p < 4; ++p) {
            if (KEEP != KEEP_NONE) {
                const unsigned keep = drop_keep_group(cfg, STAGE_ENC2, b.n, 0, 2 * e + (p >> 1),
                                                      2 * f + (p & 1)) & ((1u << C2) - 1u);
                keep8 |= keep << (C2 * p);
#pragma unroll
                for (int o = 0; o < C2; ++o) acc[p][o] = drop_apply(acc[p][o], keep, o, cfg.scale);
            }
#pragma unroll
            for (int o = 0; o < C2; ++o) m[o] = fmaxf(m[o], acc[p][o]);
        }
#pragma unroll
        for (int o = 0; o < C2; ++o)
            on[(static_cast<size_t>(o) * b.Ho + e) * b.Wo + f] = fmaxf(m[o], 0.f);
        if (SAVE)
            sv.keep2[(static_cast<size_t>(b.n) * b.Ho + e) * b.Wo + f] =
                static_cast<uint8_t>(keep8);
    });
}

template <int C1, int C2, int P1, int KEEP, bool SAVE, typename SRC>
static cudaError_t launch_as(const void* x, const Enc3Weights& wp, const void* mask, void* out,
                             const Enc3Saved& sv, int N, const Enc3Shape& sh, size_t smem,
                             const DropCfg& cfg, cudaStream_t s) {
    const auto kernel = enc3_fwd_kernel<C1, C2, P1, KEEP, SAVE, SRC>;
    cudaError_t e = allow_smem(kernel, smem);
    if (e != cudaSuccess) return e;
    const int Ho = sh.H / (2 * P1), Wo = sh.W / (2 * P1);
    const int blocks = ((Ho + sh.R2 - 1) / sh.R2) * ((Wo + sh.TW - 1) / sh.TW);
    for (int n0 = 0; n0 < N; n0 += MAX_GRID_Y) {
        KERNEL_LAUNCH(kernel, dim3(blocks, grid_rows(N, n0)), ENC3_THREADS, smem, s,
                      static_cast<const SRC*>(x), wp, static_cast<const float*>(mask),
                      static_cast<float*>(out), sv, sh, n0, cfg);
        e = cudaGetLastError();
        if (e != cudaSuccess) return e;
    }
    return cudaSuccess;
}

// mode: 0 no dropout, 1 dropout, 2 dropout saving the keep bits
template <int C1, int C2, int P1, typename SRC>
static cudaError_t launch_mode(int mode, const void* x, const Enc3Weights& wp, const void* mask,
                               void* out, const Enc3Saved& sv, int N, const Enc3Shape& sh,
                               size_t smem, const DropCfg& cfg, cudaStream_t s) {
    if (mode == 2)
        return launch_as<C1, C2, P1, KEEP_DRAW, true, SRC>(x, wp, mask, out, sv, N, sh, smem, cfg, s);
    if (mode == 1)
        return launch_as<C1, C2, P1, KEEP_DRAW, false, SRC>(x, wp, mask, out, sv, N, sh, smem, cfg, s);
    return launch_as<C1, C2, P1, KEEP_NONE, false, SRC>(x, wp, mask, out, sv, N, sh, smem, cfg, s);
}

template <int C1, int C2, int P1>
static cudaError_t launch_kind(int kind, int mode, const void* x, const Enc3Weights& wp,
                               const void* mask, void* out, const Enc3Saved& sv, int N,
                               const Enc3Shape& sh, size_t smem, const DropCfg& cfg,
                               cudaStream_t s) {
    if (kind == KIND_U32)
        return launch_mode<C1, C2, P1, uint32_t>(mode, x, wp, mask, out, sv, N, sh, smem, cfg, s);
    return launch_mode<C1, C2, P1, uint8_t>(mode, x, wp, mask, out, sv, N, sh, smem, cfg, s);
}

// x: KIND_U8 cells [N, 1, H, W] (4-byte aligned) or KIND_U32 packed words
// [N, 1, H, W/32]; w1 .. b2 float32, contiguous; mask float32 [N, H/p1] or
// null; out [N, C2, H/2p1, W/2p1].  keep1 and keep2 (Enc3Saved's layout; both
// or neither, dropout only) receive the keep bits.  smem must equal
// enc3_fwd_smem (ops/cuda_head.py computes the same).
extern "C" int enc3_fwd_launch(const void* x, const void* w1, const void* b1, const void* w2,
                               const void* b2, const void* mask, void* out, void* keep1,
                               void* keep2, int N, int H, int W, int C1, int C2, int p1, int p2,
                               int R2, int TW, long long smem, int x_kind, double drop_p,
                               unsigned long long seed, int device, void* stream) {
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return static_cast<int>(e);
    const bool drop = drop_p > 0.0, save = keep1 != nullptr;
    if (!enc3_widths(C1, C2, p1, p2) || H % (2 * p1) || W % (2 * p1) || R2 < 1 || TW < 1 ||
        drop_p < 0.0 || drop_p >= 1.0 || (x_kind != KIND_U8 && x_kind != KIND_U32) ||
        (x_kind == KIND_U32 && W % 32) || save != (keep2 != nullptr) || (save && !drop) ||
        static_cast<size_t>(smem) != enc3_fwd_smem(C1, p1, R2, TW))
        return static_cast<int>(cudaErrorInvalidValue);
    const Enc3Weights wp{static_cast<const float*>(w1), static_cast<const float*>(b1),
                         static_cast<const float*>(w2), static_cast<const float*>(b2)};
    const Enc3Saved sv{keep1, static_cast<uint8_t*>(keep2)};
    const Enc3Shape sh{H, W, R2, TW};
    const int mode = save ? 2 : drop ? 1 : 0;
    const DropCfg cfg = make_drop_cfg(drop_p, seed);
    const size_t bytes = static_cast<size_t>(smem);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (C1 == 4 && p1 == 4)
        e = launch_kind<4, 1, 4>(x_kind, mode, x, wp, mask, out, sv, N, sh, bytes, cfg, s);
    else if (C1 == 2)
        e = launch_kind<2, 1, 4>(x_kind, mode, x, wp, mask, out, sv, N, sh, bytes, cfg, s);
    else
        e = launch_kind<4, 2, 2>(x_kind, mode, x, wp, mask, out, sv, N, sh, bytes, cfg, s);
    return static_cast<int>(e);
}

template <int C1, int C2, int P1>
static int occupancy_mode(int mode, size_t bytes, int* out) {
    if (mode == 2)
        return kernel_occupancy(enc3_fwd_kernel<C1, C2, P1, KEEP_DRAW, true, uint8_t>,
                                ENC3_THREADS, bytes, out);
    if (mode == 1)
        return kernel_occupancy(enc3_fwd_kernel<C1, C2, P1, KEEP_DRAW, false, uint8_t>,
                                ENC3_THREADS, bytes, out);
    return kernel_occupancy(enc3_fwd_kernel<C1, C2, P1, KEEP_NONE, false, uint8_t>,
                            ENC3_THREADS, bytes, out);
}

// Registers, static shared memory, spilled bytes and resident blocks a
// multiprocessor (common.cuh::kernel_occupancy) of the forward at widths
// (C1, C2, p1, 2) on uint8 cells; mode as enc3_fwd_launch's.
extern "C" int enc3_fwd_occupancy(int C1, int C2, int p1, int mode, long long smem, int device,
                                  int* out) {
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (!enc3_widths(C1, C2, p1, 2)) return static_cast<int>(cudaErrorInvalidValue);
    const size_t bytes = static_cast<size_t>(smem);
    if (C1 == 4 && p1 == 4) return occupancy_mode<4, 1, 4>(mode, bytes, out);
    if (C1 == 2) return occupancy_mode<2, 1, 4>(mode, bytes, out);
    return occupancy_mode<4, 2, 2>(mode, bytes, out);
}
