// Fast MSAC ranking of K poses on the tensor cores (K2):
// sum_n clip(feat_k . pn_n, 0, tau^2) with bf16 operands and f32 sums.
//
// Replaces the TPU kernel `_quad_fused_kernel` of
// rgbd_pose_estimation_tpu/ops/ransac_score.py
// (`score_poses_3d3d_quad_fused`), itself a bf16 matrix-unit product with
// f32 accumulation: the squared residual |R p + t - q|^2 of an orthonormal
// pose factors into a 17-term bilinear form, so all K x N residuals are one
// (K, 17) x (17, N) product whose clip-and-row-sum epilogue is fused: the
// (K, N) matrix never reaches device memory.
//
// Contract (unchanged from the CUDA-core design of quad_score.cu, which stays
// in the library as the harness entry `quad_fused_cuda_cores`): both operands
// are rounded to bf16, round to nearest even, and the products are summed in
// f32. The product of two bf16 values is exact in f32, so one bf16 pass of
// the tensor cores computes the same function; only the order of the 17-term
// sum differs. clip, not min: the far-away pad correspondences make pn
// entries of order 1e8 whose rounding drives residuals negative. The clamp
// is min.NaN / max.NaN, so that a NaN residual (a NaN pose) stays NaN and the
// caller can rank it last.
//
// Bound on this card: operations, 2*17*K*N at the bf16 tensor-core peak plus
// about 3*K*N for the epilogue at the f32 peak, ~5.3 us at K = 32768 x
// N = 2048; the bytes, 4*(17*K + 17*N + K), are negligible. The epilogue's
// three f32 operations an entry (~3 us) weigh more than the product (~2 us
// at the peak, twice that for the zero-padded contraction), so the CUDA cores
// set the floor: warp-level mma.sync is enough, and wgmma with TMA, which
// would speed up only the product, waits for a later change.
//
// Design: mma.sync.aligned.m16n8k16 with bf16 operands and f32 accumulators;
// the contraction is zero-padded from 17 to 32, two k-steps. A block of 8
// warps ranks 256 poses; each warp owns 32 of them (two m16 tiles) and keeps
// their A fragments in registers for the whole run. The block walks over N
// in chunks of 256 columns, staged in shared memory as bf16 already in the
// B-fragment order (each lane's four words of a column are one 16-byte load,
// a warp's loads cover 512 contiguous bytes: no bank conflicts), double
// buffered: each thread loads its column of the next chunk into registers
// while the warps multiply the current one. Every accumulator is clipped and
// added to its row's running sum in registers; padded columns are zero and
// add exactly 0 after the clip, so no column needs a mask. At the end the
// four lanes of a row add their sums by two shuffles in a fixed order. Warps
// own distinct rows: no atomics, no shared-memory sum, a rerun gives the same
// bits.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kFeat = 17;                   // terms of the bilinear form
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMTiles = 2;                  // m16 tiles a warp
constexpr int kPoseTile = kWarps * 16 * kMTiles;  // 256 poses a block
constexpr int kChunk = kThreads;            // columns staged a round, one a thread
constexpr int kWords = 16;                  // 32 bf16 (the padded contraction) a column

// Two f32 -> one word of two bf16, round to nearest even; lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// clip(e, 0, tau2) that keeps NaN.
__device__ __forceinline__ float clip(float e, float tau2) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(e), "f"(tau2));
  asm("max.NaN.f32 %0, %0, %1;" : "+f"(r) : "f"(0.f));
  return r;
}

// d += a * b for one m16n8k16 tile: a row-major 16x16, b column-major 16x8.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Column n of pn into registers (zeros past N).
__device__ __forceinline__ void load_column(float (&col)[kFeat], const float* __restrict__ pn,
                                            int n, int N) {
#pragma unroll
  for (int f = 0; f < kFeat; ++f) col[f] = n < N ? __ldg(pn + static_cast<size_t>(f) * N + n) : 0.f;
}

// A column as 16 words, word w = features (2w, 2w + 1), stored so that lane
// t of a row group reads words t, t + 4, t + 8, t + 12 (the B fragments of
// both k-steps) as one 16-byte load at word 4t.
__device__ __forceinline__ void store_column(uint32_t* __restrict__ dst, const float (&col)[kFeat]) {
  uint32_t word[kWords];
#pragma unroll
  for (int w = 0; w < 8; ++w) word[w] = pack_bf16(col[2 * w], col[2 * w + 1]);
  word[8] = pack_bf16(col[16], 0.f);
#pragma unroll
  for (int w = 9; w < kWords; ++w) word[w] = 0u;
  uint4* d4 = reinterpret_cast<uint4*>(dst);
#pragma unroll
  for (int t = 0; t < 4; ++t) d4[t] = make_uint4(word[t], word[t + 4], word[t + 8], word[t + 12]);
}

__global__ void __launch_bounds__(kThreads, 1)
quad_bf16_mma_kernel(const float* __restrict__ feat,  // (K, 17)
                     const float* __restrict__ pn,    // (17, N)
                     float* __restrict__ out,         // (K,)
                     int K, int N, float tau2) {
  __shared__ __align__(16) uint32_t s_b[2][kChunk * kWords];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;  // the fragments' row group, lane in it
  const int row0 = blockIdx.x * kPoseTile + warp * 16 * kMTiles;

  auto f = [&](int row, int c) -> float {
    return row < K && c < kFeat ? __ldg(feat + static_cast<size_t>(row) * kFeat + c) : 0.f;
  };
  // A fragments, [m tile][k step][register]: register r holds row
  // gid + 8*(r & 1) and columns 2*tig + 8*(r >> 1) + {0, 1} of the k-step.
  // Past column 16 (k-step 1 beyond its first column) everything is zero.
  uint32_t a[kMTiles][2][4];
#pragma unroll
  for (int mt = 0; mt < kMTiles; ++mt) {
    const int lo = row0 + mt * 16 + gid, hi = lo + 8;
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const int c = 16 * ks + 2 * tig;
      a[mt][ks][0] = pack_bf16(f(lo, c), f(lo, c + 1));
      a[mt][ks][1] = pack_bf16(f(hi, c), f(hi, c + 1));
      a[mt][ks][2] = pack_bf16(f(lo, c + 8), f(lo, c + 9));
      a[mt][ks][3] = pack_bf16(f(hi, c + 8), f(hi, c + 9));
    }
  }

  // Running sums of this lane's share of its rows: [mt][0] row gid, [mt][1] gid + 8.
  float sum[kMTiles][2];
#pragma unroll
  for (int mt = 0; mt < kMTiles; ++mt) sum[mt][0] = sum[mt][1] = 0.f;

  float col[kFeat];
  load_column(col, pn, threadIdx.x, N);
  store_column(s_b[0] + threadIdx.x * kWords, col);
  __syncthreads();

  const int chunks = (N + kChunk - 1) / kChunk;
  for (int c = 0; c < chunks; ++c) {
    const bool more = c + 1 < chunks;
    if (more) load_column(col, pn, (c + 1) * kChunk + threadIdx.x, N);

    const uint32_t* sb = s_b[c & 1];
    const int tiles = (min(kChunk, N - c * kChunk) + 7) / 8;  // n8 tiles holding a column
#pragma unroll 2
    for (int nt = 0; nt < tiles; ++nt) {
      const uint4 b = *reinterpret_cast<const uint4*>(sb + (nt * 8 + gid) * kWords + 4 * tig);
#pragma unroll
      for (int mt = 0; mt < kMTiles; ++mt) {
        // Accumulator i holds row gid + 8*(i >> 1), column 2*tig + (i & 1).
        float d[4] = {0.f, 0.f, 0.f, 0.f};
        mma_bf16(d, a[mt][0], b.x, b.y);
        mma_bf16(d, a[mt][1], b.z, b.w);
        sum[mt][0] += clip(d[0], tau2);
        sum[mt][0] += clip(d[1], tau2);
        sum[mt][1] += clip(d[2], tau2);
        sum[mt][1] += clip(d[3], tau2);
      }
    }
    if (more) store_column(s_b[(c + 1) & 1] + threadIdx.x * kWords, col);
    __syncthreads();  // the next chunk is staged; this one may be overwritten
  }

  // The four lanes of a row group hold four column shares of the same rows.
#pragma unroll
  for (int mt = 0; mt < kMTiles; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v = sum[mt][h];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      const int row = row0 + mt * 16 + 8 * h + gid;
      if (tig == 0 && row < K) out[row] = v;
    }
  }
}

}  // namespace

// feat (K, 17) f32, pn (17, N) f32, out (K,) f32; all contiguous.
extern "C" int rgbd_score_poses_3d3d_quad_fused(const float* feat,
                                                const float* pn, float* out,
                                                int K, int N, float tau2,
                                                cudaStream_t stream) {
  const int blocks = (K + kPoseTile - 1) / kPoseTile;
  quad_bf16_mma_kernel<<<blocks, kThreads, 0, stream>>>(feat, pn, out, K, N, tau2);
  return static_cast<int>(cudaGetLastError());
}
