// Fast MSAC ranking of K poses: sum_n clip(feat_k . pn_n, 0, tau^2).
//
// Replaces the TPU kernel `_quad_fused_kernel` of
// rgbd_pose_estimation_tpu/ops/ransac_score.py
// (`score_poses_3d3d_quad_fused`): the squared residual |R p + t - q|^2 of
// an orthonormal pose factors into a 17-term bilinear form, so all K x N
// residuals are one (K, 17) x (17, N) product whose clip-and-row-sum
// epilogue is fused: the (K, N) matrix never reaches device memory.
//
// Contract kept from the TPU kernel: both operands are rounded to bf16
// (round to nearest even) and the products are accumulated in f32. The
// product of two bf16 values is exact in f32, so an f32 multiply-add of the
// rounded operands computes what a bf16 tensor-core product would, up to the
// order of the 17-term sum. clip, not min: the far-away pad correspondences
// make pn entries of order 1e8 whose rounding drives residuals negative.
// The clamp is written with comparisons so that a NaN residual (a NaN pose)
// stays NaN and the caller can rank it last.
//
// The same kernel, with its three template flags turned the other way,
// replaces `_kernel_C` of tools/msac_opt.py (`variant_C`, T2): f32 operands
// not rounded, min(e, tau^2) instead of the clip, and the inlier count
// sum_n [e < tau^2] beside the sum. One design serves both; K2's
// instantiation is the code it was before the flags.
//
// Bound on this card: operations, 2*17*K*N for the product plus about
// 3*K*N for the epilogue, against the bf16 tensor-core peak (T2: the f32
// peak, its operands' type); the bytes, 4*(17*K + 17*N + K), are
// negligible. This kernel runs on the CUDA cores, so its own ceiling is the
// f32 multiply-add rate; the tensor-core form of the f32 function is T3
// (quad_mma.cu).
//
// Design: a block of 8 warps ranks a tile of 128 poses. Each thread keeps
// 4 poses' feature rows in registers (68 values, already rounded) and the
// block walks over N in chunks of 256 correspondences staged, rounded, in
// shared memory; warp w takes 32 columns of each chunk, every lane reading
// the same column (a shared-memory broadcast, 5 vector loads for 68
// multiply-adds). The 8 warps' partial sums meet in shared memory at the
// end, summed in a fixed order. Ragged K and N are masked here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kFeat = 17;       // terms of the bilinear form
constexpr int kFeatPad = 20;    // column stride in shared memory (float4 loads)
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kPosesPerThread = 4;
constexpr int kPoseTile = 32 * kPosesPerThread;  // 128 poses a block
constexpr int kColsPerWarp = 32;
constexpr int kChunk = kWarps * kColsPerWarp;    // 256 correspondences

// Rounds to bf16 when kRound, else passes the f32 value.
template <bool kRound>
__device__ __forceinline__ float operand(float x) {
  return kRound ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

// kRound: operands rounded to bf16; kClipLow: clip(e, 0, tau2), else
// min(e, tau2); kCount: also write sum_n [e < tau2] to count.
template <bool kRound, bool kClipLow, bool kCount>
__global__ void __launch_bounds__(kThreads)
quad_score_kernel(const float* __restrict__ feat,  // (K, 17)
                  const float* __restrict__ pn,    // (17, N)
                  float* __restrict__ out,         // (K,)
                  float* __restrict__ count,       // (K,), kCount only
                  int K, int N, float tau2) {
  __shared__ __align__(16) float s_pn[kChunk * kFeatPad];
  __shared__ float s_feat[kPoseTile * kFeat];  // reused for the final sums

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int k0 = blockIdx.x * kPoseTile;

  // Stage the tile's feature rows (coalesced), rounded; rows past K are 0.
  for (int i = threadIdx.x; i < kPoseTile * kFeat; i += kThreads) {
    const size_t g = static_cast<size_t>(k0) * kFeat + i;
    s_feat[i] = g < static_cast<size_t>(K) * kFeat ? operand<kRound>(feat[g]) : 0.f;
  }
  __syncthreads();
  // Thread (lane, j) owns pose k0 + j*32 + lane: stride 17 words between
  // lanes, so the reads below hit 32 different banks.
  float f[kPosesPerThread][kFeat];
#pragma unroll
  for (int j = 0; j < kPosesPerThread; ++j) {
#pragma unroll
    for (int c = 0; c < kFeat; ++c) f[j][c] = s_feat[(j * 32 + lane) * kFeat + c];
  }

  float acc[kPosesPerThread], cnt[kPosesPerThread];
#pragma unroll
  for (int j = 0; j < kPosesPerThread; ++j) {
    acc[j] = 0.f;
    cnt[j] = 0.f;
  }

  for (int n0 = 0; n0 < N; n0 += kChunk) {
    __syncthreads();  // the previous chunk has been consumed
    // Stage pn[:, n0 : n0 + kChunk] column-major with stride kFeatPad.
    for (int i = threadIdx.x; i < kChunk * kFeat; i += kThreads) {
      const int c = i / kChunk, col = i % kChunk;
      const int n = n0 + col;
      s_pn[col * kFeatPad + c] =
          n < N ? operand<kRound>(pn[static_cast<size_t>(c) * N + n]) : 0.f;
    }
    __syncthreads();

    const int col0 = warp * kColsPerWarp;
    const int cols = min(kColsPerWarp, N - n0 - col0);  // <= 0: nothing left
    for (int col = 0; col < cols; ++col) {
      const float4* v4 = reinterpret_cast<const float4*>(s_pn + (col0 + col) * kFeatPad);
      float v[kFeat];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 x = v4[i];
        v[4 * i] = x.x;
        v[4 * i + 1] = x.y;
        v[4 * i + 2] = x.z;
        v[4 * i + 3] = x.w;
      }
      v[16] = s_pn[(col0 + col) * kFeatPad + 16];
#pragma unroll
      for (int j = 0; j < kPosesPerThread; ++j) {
        float e = 0.f;
#pragma unroll
        for (int c = 0; c < kFeat; ++c) e = fmaf(f[j][c], v[c], e);
        // clip(e, 0, tau2), or min(e, tau2), that keeps NaN
        const float hi = e > tau2 ? tau2 : e;
        acc[j] += kClipLow ? (e < 0.f ? 0.f : hi) : hi;
        if (kCount) cnt[j] += e < tau2 ? 1.f : 0.f;
      }
    }
  }

  // Sum the 8 warps' partial sums in warp order.
  __syncthreads();
  // (kWarps, kPoseTile) sums, then as many counts: 2*8*128 <= 128*17 floats.
  float* s_part = s_feat;
  float* s_cnt = s_feat + kWarps * kPoseTile;
#pragma unroll
  for (int j = 0; j < kPosesPerThread; ++j) {
    s_part[warp * kPoseTile + j * 32 + lane] = acc[j];
    if (kCount) s_cnt[warp * kPoseTile + j * 32 + lane] = cnt[j];
  }
  __syncthreads();
  if (threadIdx.x < kPoseTile && k0 + threadIdx.x < K) {
    float s = 0.f, c = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      s += s_part[w * kPoseTile + threadIdx.x];
      if (kCount) c += s_cnt[w * kPoseTile + threadIdx.x];
    }
    out[k0 + threadIdx.x] = s;
    if (kCount) count[k0 + threadIdx.x] = c;
  }
}

}  // namespace

// feat (K, 17) f32, pn (17, N) f32, out (K,) f32; all contiguous.
extern "C" int rgbd_score_poses_3d3d_quad_fused(const float* feat,
                                                const float* pn, float* out,
                                                int K, int N, float tau2,
                                                cudaStream_t stream) {
  const int blocks = (K + kPoseTile - 1) / kPoseTile;
  quad_score_kernel<true, true, false><<<blocks, kThreads, 0, stream>>>(
      feat, pn, out, nullptr, K, N, tau2);
  return static_cast<int>(cudaGetLastError());
}

// T2: feat (K, 17) f32, pn (17, N) f32, msac and count (K,) f32; all
// contiguous. sum_n min(feat_k . pn_n, tau^2) and sum_n [e < tau^2] in f32.
extern "C" int rgbd_msac_variant_c(const float* feat, const float* pn,
                                   float* msac, float* count, int K, int N,
                                   float tau2, cudaStream_t stream) {
  const int blocks = (K + kPoseTile - 1) / kPoseTile;
  quad_score_kernel<false, false, true><<<blocks, kThreads, 0, stream>>>(
      feat, pn, msac, count, K, N, tau2);
  return static_cast<int>(cudaGetLastError());
}
