// encoder_bwd: the gradients of a wrapper-net encoder's two conv stages.
//
// Replaces carle_tpu/ops/pallas_head.py::make_fused_encoder's backward kernel
// _enc_bwd_kernel (all-ones row mask): from the cells x, the four parameters,
// the dropout seed and the cotangent g of the pooled output it gives dW1
// [C1, 1, 3, 3], db1, dW2 [C2, C1, 3, 3] and db2, recomputing both stages
// with the forward's dropout mask.  The kernels and their design are in
// encoder_bwd.cuh.
#include "encoder_bwd.cuh"

// gc2 is scratch of N x C2 x H/p1 x W/p1 floats; part2 of N x bands2 x
// (C2 C1 9 + C2) and part1 of N x bands1 x (C1 9 + C1) floats, with bands2 =
// ceil(H/(p1 p2) / R2) and bands1 = ceil(H/p1 / RB); grads receives dW1, db1,
// dW2, db2 one after the other.  smem2 and smem1 must equal enc_bwd2_smem and
// enc_bwd1_smem (ops/cuda_head.py computes the same).  x_kind: KIND_U8 cells or
// KIND_U32 packed words.
extern "C" int encoder_bwd_launch(const void* x, const void* w1, const void* b1,
                                  const void* w2, const void* b2, const void* g,
                                  void* gc2, void* part2, void* part1, void* grads,
                                  int N, int H, int W, int C1, int C2, int p1, int p2,
                                  int R2, int RB, long long smem2, long long smem1,
                                  int x_kind, double drop_p, unsigned long long seed,
                                  int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (drop_p < 0.0 || drop_p >= 1.0) return static_cast<int>(cudaErrorInvalidValue);
    const EncBwdArgs a{x, w1, b1, w2, b2, g, gc2, part2, part1, grads, N, H, W, C1, C2,
                       R2, RB, static_cast<size_t>(smem2), static_cast<size_t>(smem1),
                       x_kind};
    return encoder_bwd_run(a, p1, p2, drop_p, make_drop_cfg(drop_p, seed),
                           static_cast<cudaStream_t>(stream));
}
