// The autoencoder's forward up to the decoder's middle activation, for one
// band of output rows, in shared memory: shared by ae_loss_fwd.cu and the
// decoder backward of ae_loss_bwd.cu, which recomputes it.  The decoder-only
// kernels (decoder_loss_fwd.cu, decoder_loss_bwd.cu) use the same layout with
// C1 = 0 (no encoder buffers) and read the embedding from device memory.
//
// A band of RY output rows [Y0, Y0 + RY) needs the decoder's middle rows
// [Y0/2 - 1, Y0/2 + RY/2 + 1), the embedding rows [Y0/4 - 1, Y0/4 + RY/4 + 1),
// the stage-1 rows [Y0/2 - 3, Y0/2 + RY/2 + 3) and the input rows
// [Y0 - 7, Y0 + RY + 7).  The middle rows also cover output rows Y0 - 1 and
// Y0 + RY, which the backward needs for the middle cotangent.
//
// The decoder-only kernels may also cut the width into tiles of TX output
// columns (decoder_band_layout): a tile [X0, X0 + TX) needs the middle
// columns [X0/2 - 1, X0/2 + TX/2 + 1) and the embedding columns
// [X0/4 - 1, X0/4 + TX/4 + 1), each clamped to its layer's extent, so a
// column outside a buffer is outside the extent (deconv_preact).  One tile
// of the whole width is the untiled layout.
#pragma once

#include "net_stages.cuh"

struct AEShape {
    int H, W, C1, C2, CMID, COUT, RY;
};

struct AEBand {
    float *w1s, *b1s, *w2s, *b2s, *wt1s, *bt1s, *wt2s, *bt2s;
    float* x1s;  // C1 x XR x (W/2 + 2), rows from X0
    float* es;   // C2 x ER x EW, rows from E0, columns from EC0
    float* ms;   // CMID x MR x MW, rows from M0, columns from MC0
    float* end;  // first float after the band buffers
    int I0, IR, X0, XR, E0, ER, M0, MR;
    int EC0, EW, MC0, MW;
};

// Floats of the band buffers (weights and the three activation bands).
__host__ __device__ inline size_t ae_band_floats(const AEShape& sh) {
    const int XR = sh.RY / 2 + 6, ER = sh.RY / 4 + 2, MR = sh.RY / 2 + 2;
    return static_cast<size_t>(sh.C1) * 9 + sh.C1 + sh.C2 * sh.C1 * 9 + sh.C2 +
           sh.C2 * sh.CMID * 16 + sh.CMID + sh.CMID * sh.COUT * 16 + sh.COUT +
           static_cast<size_t>(sh.C1) * XR * (sh.W / 2 + 2) +
           static_cast<size_t>(sh.C2) * ER * (sh.W / 4) +
           static_cast<size_t>(sh.CMID) * MR * (sh.W / 2);
}

__device__ __forceinline__ AEBand ae_band_layout(float* smem, const AEShape& sh, int Y0) {
    AEBand b;
    const int W1 = sh.W / 2, We = sh.W / 4;
    b.IR = sh.RY + 14; b.I0 = Y0 - 7;          // input rows
    b.XR = sh.RY / 2 + 6; b.X0 = Y0 / 2 - 3;   // stage-1 rows
    b.ER = sh.RY / 4 + 2; b.E0 = Y0 / 4 - 1;   // embedding rows
    b.MR = sh.RY / 2 + 2; b.M0 = Y0 / 2 - 1;   // decoder middle rows
    b.w1s = smem;
    b.b1s = b.w1s + sh.C1 * 9;
    b.w2s = b.b1s + sh.C1;
    b.b2s = b.w2s + sh.C2 * sh.C1 * 9;
    b.wt1s = b.b2s + sh.C2;
    b.bt1s = b.wt1s + sh.C2 * sh.CMID * 16;
    b.wt2s = b.bt1s + sh.CMID;
    b.bt2s = b.wt2s + sh.CMID * sh.COUT * 16;
    b.x1s = b.bt2s + sh.COUT;
    b.EC0 = 0; b.EW = We;                      // every column
    b.MC0 = 0; b.MW = W1;
    b.es = b.x1s + sh.C1 * b.XR * (W1 + 2);
    b.ms = b.es + sh.C2 * b.ER * We;
    b.end = b.ms + sh.CMID * b.MR * W1;
    return b;
}

// Floats of a decoder-only band buffer (C1 = 0) with tiles of TX output
// columns: the widest tile's.  TX >= W is ae_band_floats.
__host__ __device__ inline size_t decoder_band_floats(const AEShape& sh, int TX) {
    if (TX >= sh.W) return ae_band_floats(sh);
    const int ER = sh.RY / 4 + 2, MR = sh.RY / 2 + 2;
    return static_cast<size_t>(sh.C2) * sh.CMID * 16 + sh.CMID + sh.CMID * sh.COUT * 16 +
           sh.COUT + static_cast<size_t>(sh.C2) * ER * widest_window(sh.W / 4, TX / 4, 1) +
           static_cast<size_t>(sh.CMID) * MR * widest_window(sh.W / 2, TX / 2, 1);
}

// The decoder-only layout (C1 = 0) of the block that owns output rows
// [Y0, Y0 + RY) and output columns [X0, X0 + TX) (TX the block's own width,
// short in a ragged last tile).  Without GENERAL the block owns the whole
// width (X0 = 0, TX = W) and the windows are constants.
template <bool GENERAL>
__device__ __forceinline__ AEBand decoder_band_layout(float* smem, const AEShape& sh, int Y0,
                                                      int X0, int TX) {
    AEBand b;
    b.IR = 0; b.I0 = 0; b.XR = 0; b.X0 = 0;
    b.ER = sh.RY / 4 + 2; b.E0 = Y0 / 4 - 1;
    b.MR = sh.RY / 2 + 2; b.M0 = Y0 / 2 - 1;
    if (GENERAL) {
        clamped_window(X0 / 4, TX / 4, 1, sh.W / 4, b.EC0, b.EW);
        clamped_window(X0 / 2, TX / 2, 1, sh.W / 2, b.MC0, b.MW);
    } else {
        b.EC0 = 0; b.EW = sh.W / 4;
        b.MC0 = 0; b.MW = sh.W / 2;
    }
    b.w1s = b.b1s = b.w2s = b.b2s = smem;
    b.wt1s = smem;
    b.bt1s = b.wt1s + sh.C2 * sh.CMID * 16;
    b.wt2s = b.bt1s + sh.CMID;
    b.bt2s = b.wt2s + sh.CMID * sh.COUT * 16;
    b.x1s = b.bt2s + sh.COUT;
    b.es = b.x1s;
    b.ms = b.es + sh.C2 * b.ER * b.EW;
    b.end = b.ms + sh.CMID * b.MR * b.MW;
    return b;
}

// Loads the weights, stages the input rows into xs and fills x1s, es and ms.
// src: cells or packed words (common.cuh).  Ends with a __syncthreads().
template <bool DROP, typename SRC>
__device__ __forceinline__ void ae_band_forward(
    const AEBand& b, uint8_t* xs, const SRC* __restrict__ src,
    const float* __restrict__ w1, const float* __restrict__ b1,
    const float* __restrict__ w2, const float* __restrict__ b2,
    const float* __restrict__ wt1, const float* __restrict__ bt1,
    const float* __restrict__ wt2, const float* __restrict__ bt2, const AEShape& sh,
    int n, const DropCfg& cfg) {
    const int H = sh.H, W = sh.W, C1 = sh.C1, C2 = sh.C2, CMID = sh.CMID, COUT = sh.COUT;
    const int H1 = H / 2, W1 = W / 2, He = H / 4, We = W / 4;
    copy_floats(b.w1s, w1, C1 * 9);
    copy_floats(b.b1s, b1, C1);
    copy_floats(b.w2s, w2, C2 * C1 * 9);
    copy_floats(b.b2s, b2, C2);
    copy_floats(b.wt1s, wt1, C2 * CMID * 16);
    copy_floats(b.bt1s, bt1, CMID);
    copy_floats(b.wt2s, wt2, CMID * COUT * 16);
    copy_floats(b.bt2s, bt2, COUT);
    stage_cells(xs, cells_at(src, static_cast<size_t>(n) * H * W), b.I0, b.IR, H, W);
    __syncthreads();
    // encoder stage 1 -> x1s (zero outside the universe: stage 2's padding)
    encoder_stage1_band<2, DROP>(xs, b.I0, -1, W + 2, W, b.w1s, b.b1s, C1, b.x1s, b.X0, b.XR,
                                 -1, W1 + 2, H1, nullptr, n, cfg);
    __syncthreads();
    // encoder stage 2 -> es (zero outside the universe: no decoder input)
    encoder_stage2_band<2, DROP, true>(b.x1s, b.X0, b.XR, -1, W1 + 2, b.w2s, b.b2s, C1, C2,
                                       b.es, static_cast<size_t>(b.ER) * We, We, b.E0, b.ER,
                                       He, 0, We, n, cfg);
    __syncthreads();
    // decoder stage 1 (transpose conv + relu) -> ms (zero outside the universe)
    decoder_stage1_band<DROP>(b.es, b.E0, b.ER, 0, We, b.wt1s, b.bt1s, C2, CMID, b.ms, b.M0,
                              b.MR, 0, W1, H1, n, cfg);
    __syncthreads();
}

// The decoder-only band: loads the decoder's weights, stages the band's
// embedding window from device memory (emb: instance n's [C2, H/4, W/4]) and
// fills ms.  Ends with a __syncthreads().
template <bool DROP>
__device__ __forceinline__ void decoder_band_forward(
    const AEBand& b, const float* __restrict__ emb, const float* __restrict__ wt1,
    const float* __restrict__ bt1, const float* __restrict__ wt2,
    const float* __restrict__ bt2, const AEShape& sh, int n, const DropCfg& cfg) {
    const int C2 = sh.C2, CMID = sh.CMID, COUT = sh.COUT;
    copy_floats(b.wt1s, wt1, C2 * CMID * 16);
    copy_floats(b.bt1s, bt1, CMID);
    copy_floats(b.wt2s, wt2, CMID * COUT * 16);
    copy_floats(b.bt2s, bt2, COUT);
    stage_float_window(b.es, emb, C2, b.E0, b.ER, b.EC0, b.EW, sh.H / 4, sh.W / 4);
    __syncthreads();
    decoder_stage1_band<DROP>(b.es, b.E0, b.ER, b.EC0, b.EW, b.wt1s, b.bt1s, C2, CMID, b.ms,
                              b.M0, b.MR, b.MC0, b.MW, sh.H / 2, n, cfg);
    __syncthreads();
}

// Decoder stage 2 (transpose conv + sigmoid) on the block's output rows
// [Y0, Y0 + RY) and columns [X0, X0 + TX) and the squared error against obs
// [N, COUT, H, W] (cells, packed words or floats), each output row's error
// times its weight em[row] (em: the instance's [H] row weights; nullptr: all
// ones, and then no multiply).  The block's sum, in a fixed order (warp
// trees, then the warps in turn), goes to partials[slot].  red needs 32
// floats.  (The addresses are formed where they are used: a pointer held
// across the loop costs the inference kernel its fourth block a
// multiprocessor.)
template <bool DROP, typename OBS>
__device__ __forceinline__ void decoder_stage2_error_tile(
    const AEBand& b, float* red, const OBS* __restrict__ obs, const AEShape& sh, int Y0,
    int X0, int TX, const float* __restrict__ em, int n, size_t slot, const DropCfg& cfg,
    float* __restrict__ partials) {
    const int H = sh.H, W = sh.W, COUT = sh.COUT, RY = sh.RY;
    const int tid = threadIdx.x, nt = blockDim.x;
    const OBS* on = cells_at(obs, static_cast<size_t>(n) * COUT * H * W);
    float part = 0.f;
    for (int i = tid; i < RY * TX; i += nt) {
        const int lr = i / TX, xo = X0 + (i - lr * TX);
        const int gy = Y0 + lr;
        if (gy >= H) continue;
        float acc[MAXC];
        deconv_preact(b.ms, b.M0, b.MR, b.MC0, b.MW, b.wt2s, b.bt2s, sh.CMID, COUT, gy, xo, acc);
        unsigned keep = 0;
        if (DROP) keep = drop_keep_bits(cfg, STAGE_DEC2, n, COUT, gy, xo);
#pragma unroll
        for (int o = 0; o < MAXC; ++o) {
            if (o < COUT) {
                const float r = DROP ? drop_apply(acc[o], keep, o, cfg.scale) : acc[o];
                const float y = 1.f / (1.f + expf(-r));
                const float d = cell_value(on, (static_cast<size_t>(o) * H + gy) * W + xo) - y;
                // d * em * d: a weight of one gives d * d's bits
                const float de = em != nullptr ? d * em[gy] : d;
                part += de * d;
            }
        }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) part += __shfl_down_sync(0xffffffffu, part, off);
    if ((tid & 31) == 0) red[tid >> 5] = part;
    __syncthreads();
    if (tid == 0) {
        float s = 0.f;
        for (int w = 0; w < (nt + 31) / 32; ++w) s += red[w];
        partials[slot] = s;
    }
}

// The whole width, no row weights, partials[n][band] (the whole autoencoder).
template <bool DROP, typename OBS>
__device__ __forceinline__ void decoder_stage2_error(const AEBand& b, float* red,
                                                     const OBS* __restrict__ obs,
                                                     const AEShape& sh, int Y0, int n,
                                                     const DropCfg& cfg,
                                                     float* __restrict__ partials) {
    decoder_stage2_error_tile<DROP>(b, red, obs, sh, Y0, 0, sh.W, nullptr, n,
                                    static_cast<size_t>(n) * gridDim.x + blockIdx.x, cfg,
                                    partials);
}
