// Measurement variants of the exact MSAC scorer, on K3's kernel template.
//
// T1 replaces the TPU kernel `_kernel_A` of tools/msac_opt.py
// (`variant_A`): the production scorer's function, per pose k
// sum_n min(|R_k p_n + t_k - q_n|^2, tau^2) and sum_n [e < tau^2], with the
// number of poses a block scores as an argument. On the TPU the variant
// sweeps KT, the poses of one grid step; here a block's poses (1, 2, 4, 8,
// 16) set how often each correspondence load is reused against how many
// blocks there are to fill the card.
//
// T5 replaces `_kernel_D` of the same file (`variant_D`): T1 without the
// inlier count, so that the two together measure what the count costs.
//
// Bound on this card: operations, 23*K*N f32 (T5: 20*K*N); the bytes are
// negligible. Design and NaN handling: see score3d.cuh.

#include "score3d.cuh"

// poses (K, 12) f32 [9 rotation row-major, 3 translation], p and q (N, 3)
// f32, msac and count (K,) f32; all contiguous. poses_per_block is one of
// 1, 2, 4, 8, 16 (anything else: cudaErrorInvalidValue, nothing launched).
extern "C" int rgbd_msac_variant_a(const float* poses, const float* p,
                                   const float* q, float* msac, float* count,
                                   int K, int N, float tau2,
                                   int poses_per_block, cudaStream_t stream) {
  return score3d::launch<true>(poses_per_block, poses, p, q, msac, count, K,
                               N, tau2, stream);
}

// As rgbd_msac_variant_a, without the count.
extern "C" int rgbd_msac_variant_d(const float* poses, const float* p,
                                   const float* q, float* msac, int K, int N,
                                   float tau2, int poses_per_block,
                                   cudaStream_t stream) {
  return score3d::launch<false>(poses_per_block, poses, p, q, msac, nullptr,
                                K, N, tau2, stream);
}
