// In-kernel dropout for the wrapper-net kernels: Philox4x32-10, a
// counter-based generator (Salmon et al., "Parallel random numbers: as easy
// as 1, 2, 3", SC 2011), indexed by the element and not by who computes it.
//
// The TPU kernels (carle_tpu/ops/pallas_head.py::_keep_mask) draw one
// hardware-PRNG stream per tile in draw order and replay it in the backward.
// Here a halo cell is computed by two blocks, and by the forward and the
// backward launches, so the bit of an element is a pure function of
//
//   key     = (seed low word, seed high word)
//   counter = (x, y, instance, 4 * stage + channel / 4)
//
// and the four output words serve channels 4g .. 4g + 3 of that position.
// Stages: 0 and 1 the encoder's convolutions, 2 and 3 the decoder's transpose
// convolutions; y and x are the element's own row and column at its stage's
// resolution.  An element is kept iff its word < keep_below =
// floor((1 - p) 2^32), and kept values are scaled by 1 / (1 - p); dropout
// comes before the activation, as _apply_drop_relu.  The plain PyTorch twin
// (ops/cuda_head.py::philox_keep_mask) uses the same layout, so kernel and
// twin draw the same mask.
#pragma once

#include <stdint.h>

struct DropCfg {
    uint32_t key0, key1;   // the seed's low and high words
    uint32_t keep_below;   // keep iff word < keep_below
    float scale;           // 1 / (1 - p)
};

__device__ __forceinline__ void philox4x32_10(uint32_t c0, uint32_t c1, uint32_t c2,
                                              uint32_t c3, uint32_t k0, uint32_t k1,
                                              uint32_t out[4]) {
    const uint32_t M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;
    const uint32_t W0 = 0x9E3779B9u, W1 = 0xBB67AE85u;
#pragma unroll
    for (int round = 0; round < 10; ++round) {
        const uint32_t hi0 = __umulhi(M0, c0), lo0 = M0 * c0;
        const uint32_t hi1 = __umulhi(M1, c2), lo1 = M1 * c2;
        c0 = hi1 ^ c1 ^ k0;
        c1 = lo1;
        c2 = hi0 ^ c3 ^ k1;
        c3 = lo0;
        k0 += W0;
        k1 += W1;
    }
    out[0] = c0; out[1] = c1; out[2] = c2; out[3] = c3;
}

// Bit k of the result: channel 4 * group + k of position (y, x) of instance n
// at `stage` is kept.
__device__ __forceinline__ unsigned drop_keep_group(const DropCfg& cfg, int stage, int n,
                                                    int group, int y, int x) {
    uint32_t w[4];
    philox4x32_10(static_cast<uint32_t>(x), static_cast<uint32_t>(y),
                  static_cast<uint32_t>(n), static_cast<uint32_t>(4 * stage + group),
                  cfg.key0, cfg.key1, w);
    unsigned bits = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k)
        if (w[k] < cfg.keep_below) bits |= 1u << k;
    return bits;
}

// Bit c of the result: channel c (of at most 8) of that position is kept.
__device__ __forceinline__ unsigned drop_keep_bits(const DropCfg& cfg, int stage, int n,
                                                   int channels, int y, int x) {
    unsigned bits = drop_keep_group(cfg, stage, n, 0, y, x);
    if (channels > 4) bits |= drop_keep_group(cfg, stage, n, 1, y, x) << 4;
    return bits;
}

// Dropout of one pre-activation: z / (1 - p) if kept, else 0.
__device__ __forceinline__ float drop_apply(float z, unsigned keep_bits, int c,
                                            float scale) {
    return ((keep_bits >> c) & 1u) ? z * scale : 0.f;
}
