// The autoencoder's forward up to the decoder's middle activation, for one
// band of output rows, in shared memory: shared by ae_loss_fwd.cu and the
// decoder backward of ae_loss_bwd.cu, which recomputes it.
//
// A band of RY output rows [Y0, Y0 + RY) needs the decoder's middle rows
// [Y0/2 - 1, Y0/2 + RY/2 + 1), the embedding rows [Y0/4 - 1, Y0/4 + RY/4 + 1),
// the stage-1 rows [Y0/2 - 3, Y0/2 + RY/2 + 3) and the input rows
// [Y0 - 7, Y0 + RY + 7).  The middle rows also cover output rows Y0 - 1 and
// Y0 + RY, which the backward needs for the middle cotangent.
#pragma once

#include "net_stages.cuh"

struct AEShape {
    int H, W, C1, C2, CMID, COUT, RY;
};

struct AEBand {
    float *w1s, *b1s, *w2s, *b2s, *wt1s, *bt1s, *wt2s, *bt2s;
    float* x1s;  // C1 x XR x (W/2 + 2), rows from X0
    float* es;   // C2 x ER x W/4, rows from E0
    float* ms;   // CMID x MR x W/2, rows from M0
    float* end;  // first float after the band buffers
    int I0, IR, X0, XR, E0, ER, M0, MR;
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
    b.es = b.x1s + sh.C1 * b.XR * (W1 + 2);
    b.ms = b.es + sh.C2 * b.ER * We;
    b.end = b.ms + sh.CMID * b.MR * W1;
    return b;
}

// Loads the weights, stages the input rows into xs and fills x1s, es and ms.
// Ends with a __syncthreads().
template <bool DROP>
__device__ __forceinline__ void ae_band_forward(
    const AEBand& b, uint8_t* xs, const uint8_t* __restrict__ src,
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
    stage_cells(xs, src + static_cast<size_t>(n) * H * W, b.I0, b.IR, H, W);
    __syncthreads();
    // encoder stage 1 -> x1s (zero outside the universe: stage 2's padding)
    encoder_stage1_band<2, DROP>(xs, b.I0, W, b.w1s, b.b1s, C1, b.x1s, b.X0, b.XR, H1, n, cfg);
    __syncthreads();
    // encoder stage 2 -> es (zero outside the universe: no decoder input)
    encoder_stage2_band<2, DROP, true>(b.x1s, b.X0, b.XR, W1 + 2, b.w2s, b.b2s, C1, C2, b.es,
                                       static_cast<size_t>(b.ER) * We, We, b.E0, b.ER, He,
                                       We, n, cfg);
    __syncthreads();
    // decoder stage 1 (transpose conv + relu) -> ms (zero outside the universe)
    decoder_stage1_band<DROP>(b.es, b.E0, b.ER, We, b.wt1s, b.bt1s, C2, CMID, b.ms, b.M0,
                              b.MR, H1, W1, n, cfg);
    __syncthreads();
}
