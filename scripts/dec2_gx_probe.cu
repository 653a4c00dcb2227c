// The decoder-loss backward of csrc/dec2_bwd.cu as two launches, for
// scripts/port_ab.py decoder-gx only (the package does not build it): the
// band kernel computes the output cotangent on its rows and one to either
// side, writes its own middle cotangent to device memory (gmid) and sums its
// weight gradients; net_stages.cuh's deconv_input_grad_kernel then forms gx
// from gmid, and column_sums_kernel adds the partial gradients.  dec2_bwd.cu
// instead recomputes the output cotangent on three rows to either side and
// keeps gmid in shared memory; timing both on the card chose between them.
#include "dec2.cuh"

template <bool DROP, typename OBS>
__global__ void __launch_bounds__(DEC2_THREADS, DEC2_BWD_BLOCKS)
opt2_kernel(const float* __restrict__ x, const OBS* __restrict__ obs, Dec2Weights wp,
            const float* __restrict__ gbar, const float* __restrict__ em,
            const uint8_t* __restrict__ keepd, float* __restrict__ gmid,
            float* __restrict__ partials, Dec2Shape sh, int N0, DropCfg cfg) {
    constexpr int KEEP = DROP ? KEEP_READ : KEEP_NONE;
    const Dec2Block b(sh, N0);
    const int H = sh.H, W = sh.W, H1 = H / 2, W1 = W / 2, He = H / 4, We = W / 4;
    const int Y0 = b.Y0, X0 = b.X0, RY = b.RY, TX = b.TX, n = b.n;
    extern __shared__ float smem[];
    const Win es{smem, Y0 / 4 - 1, X0 / 4 - 1, RY / 4 + 2, TX / 4 + 2};
    const Win ms{es.p + 2 * es.rows * es.cols, Y0 / 2 - 1, X0 / 2 - 1, RY / 2 + 2, TX / 2 + 2};
    const Win gys{ms.p + ms.rows * ms.cols, Y0 - 1, X0 - 1, RY + 2, TX + 2};
    const Win gms{gys.p + gys.rows * gys.cols, Y0 / 2, X0 / 2, RY / 2, TX / 2};
    float* red = gms.p + gms.rows * gms.cols;
    dec2_load_weights(wp.wt1, wp.bt1, wp.wt2, wp.bt2);
    dec2_stage_emb(es, x + static_cast<size_t>(n) * 2 * He * We, He, We);
    const float* em_n = em != nullptr ? em + static_cast<size_t>(n) * H : nullptr;
    int w_lo = -DEC2_ALL, w_hi = DEC2_ALL, m_lo = -DEC2_ALL, m_hi = DEC2_ALL;
    if (em_n != nullptr) {
        int lo, hi;
        weighted_rows(em_n, max(Y0 - 1, 0), min(Y0 + RY + 1, H), lo, hi);
        w_lo = lo < hi ? lo : DEC2_ALL;
        w_hi = lo < hi ? hi : -DEC2_ALL;
        m_lo = lo < hi ? (lo - 1) >> 1 : DEC2_ALL;
        m_hi = lo < hi ? ((hi - 2) >> 1) + 2 : -DEC2_ALL;
    }
    const uint8_t* keepd_n = DROP ? keepd + static_cast<size_t>(n) * H1 * W1 : nullptr;
    __syncthreads();
    dec2_middle<KEEP, false, true>(es, ms, Y0 / 4, RY / 4 + 1, X0 / 4, TX / 4 + 1, H1, W1,
                                   m_lo, m_hi, n, cfg, keepd_n, nullptr, 0, 0, 0, 0);
    __syncthreads();
    dec2_out_cotangent<DROP, true>(ms, gys, Y0 / 2, RY / 2 + 1, X0 / 2, TX / 2 + 1, w_lo, w_hi, H,
                                   W, cells_at(obs, static_cast<size_t>(n) * H * W),
                                   2.f * gbar[n], em_n, keepd_n, cfg);
    __syncthreads();
    float* row = partials + (static_cast<size_t>(n) * gridDim.x + blockIdx.x) * DEC2_PARTS;
    dec2_wt2_grad_quads(ms, gys, Y0 / 2, RY / 2 + 1, X0 / 2, TX / 2 + 1, Y0, Y0 + RY, X0, X0 + TX,
                        red, row + 33, row + 49);
    // the own middle cotangent, also into device memory
    float* gm_n = gmid + static_cast<size_t>(n) * H1 * W1;
    grid_walk(gms.rows, gms.cols, [&](int lr, int lc) {
        const int gm = gms.r0 + lr, mx = gms.c0 + lc;
        float g = 0.f;
        if (*ms.at(gm, mx) > 0.f) {
            float s = 0.f;
#pragma unroll
            for (int ky = 0; ky < 4; ++ky) {
                const float* gp = gys.at(2 * gm - 1 + ky, 2 * mx - 1);
#pragma unroll
                for (int kx = 0; kx < 4; ++kx) s += parity_tap(dec2_wt2p, ky, kx) * gp[kx];
            }
            g = DROP ? s * cfg.scale : s;
        }
        gms.p[lr * gms.cols + lc] = g;
        gm_n[static_cast<size_t>(gm) * W1 + mx] = g;
    });
    __syncthreads();
    dec2_wt1_grad_pairs(es, gms, Y0 / 4, RY / 4 + 1, X0 / 4, TX / 4 + 1, Y0 / 2, Y0 / 2 + RY / 2,
                        X0 / 2, X0 / 2 + TX / 2, red, row, row + 32);
}

extern "C" int opt2_launch(const void* x, const void* obs, const void* wt1, const void* bt1,
                           const void* wt2, const void* bt2, const void* gbar, const void* em,
                           const void* keepd, void* partials, void* grads, void* gx, void* gmid,
                           int N, int H, int W, int RY, int TX, int obs_kind, double drop_p,
                           void* stream) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const Dec2Weights wp{static_cast<const float*>(wt1), static_cast<const float*>(bt1),
                         static_cast<const float*>(wt2), static_cast<const float*>(bt2)};
    const Dec2Shape sh{H, W, RY, TX};
    const DropCfg cfg = make_drop_cfg(drop_p, 0);
    const int T = TX < W ? TX : W;
    const size_t bytes = 4 * (2 * (RY / 4 + 2) * (T / 4 + 2) + (RY / 2 + 2) * (T / 2 + 2) +
                              (RY + 2) * (T + 2) + (RY / 2) * (T / 2) + 32 * 16);
    const int blocks = ((H + RY - 1) / RY) * ((W + T - 1) / T);
    cudaError_t e;
#define GO(D, O) { auto k = opt2_kernel<D, O>; e = allow_smem(k, bytes); if (e) return e; \
    k<<<dim3(blocks, N), DEC2_THREADS, bytes, s>>>(static_cast<const float*>(x), \
        static_cast<const O*>(obs), wp, static_cast<const float*>(gbar), \
        static_cast<const float*>(em), static_cast<const uint8_t*>(keepd), \
        static_cast<float*>(gmid), static_cast<float*>(partials), sh, 0, cfg); }
    if (drop_p > 0) { if (obs_kind == KIND_U32) GO(true, uint32_t) else GO(true, uint8_t) }
    else { if (obs_kind == KIND_U32) GO(false, uint32_t) else GO(false, uint8_t) }
    e = cudaGetLastError();
    if (e) return e;
    const size_t total = static_cast<size_t>(N) * 2 * (H / 4) * (W / 4);
    deconv_input_grad_kernel<<<static_cast<int>((total + 255) / 256), 256, 0, s>>>(
        static_cast<const float*>(gmid), static_cast<const float*>(wt1), static_cast<float*>(gx),
        N, H / 2, W / 2, 2, 1);
    column_sums_kernel<<<DEC2_PARTS, 128, 0, s>>>(static_cast<const float*>(partials),
                                                    blocks * N, DEC2_PARTS,
                                                    static_cast<float*>(grads));
    return static_cast<int>(cudaGetLastError());
}
