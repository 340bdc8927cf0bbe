// The f32 quad-form MSAC scorer on the tensor cores (T3).
//
// Replaces the TPU kernel `_kernel_M` of tools/msac_opt.py (`variant_M`):
// e = feat @ pn as one (K, 17) x (17, N) f32 product on the matrix unit,
// then per pose k sum_n min(e_kn, tau^2) and sum_n [e_kn < tau^2]. The
// (K, N) matrix never reaches device memory.
//
// The product runs on Hopper's tensor cores through
// mma.sync.aligned.m16n8k8 with TF32 operands and f32 accumulation; the
// contraction is zero-padded from 17 to 24 (three k-steps of 8). One TF32
// pass keeps about three decimal digits, and the 17 terms, of order 10-50,
// cancel down to residuals near tau^2 = 2.5e-3: one pass would put counts on
// the wrong side of tau^2. So each operand is split, x = hi + lo with hi and
// lo both TF32, and the product is the sum of the three passes
// lo*hi + hi*lo + hi*hi (3xTF32; the dropped lo*lo is ~2^-22 of a term):
// the f32 product that `_kernel_M` computes, up to the order of the sum.
// TF32 has f32's exponent range, so the ~1e8 pn entries of the far-away
// pad correspondences keep their size in both parts.
//
// Bound on this card: operations, 3 passes of 2*17*K*N at the TF32
// tensor-core peak, and about 3*K*N for the epilogue at the f32 peak; the
// bytes, 4*(17*K + 17*N + 2*K), are negligible.
//
// Design (simple first; wgmma and TMA are later work): a block of 4 warps
// scores 32 poses (two m16 tiles). Every warp holds the split A fragments
// of those 32 rows in registers for the whole run and walks over its share
// of the N columns, 8 at a time (warp w takes n8-tiles w, w + 4, ...),
// loading and splitting the B fragment straight from pn (17 x N floats,
// resident in L2). The epilogue is fused: each accumulator is clamped with
// a comparison, so that NaN stays NaN, counted, and added to its row's
// running sum; columns past N are masked. At the end the four lanes that
// share a row add their sums with shuffles, and the 4 warps' sums meet in
// shared memory and are added in warp order. No atomics: a rerun gives the
// same bits.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kFeat = 17;     // terms of the bilinear form
constexpr int kKSteps = 3;    // contraction padded to 24 = 3 x k8
constexpr int kMTiles = 2;    // m16 tiles a block
constexpr int kRows = 16 * kMTiles;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;

// f32 -> TF32, round to nearest (ties away from zero), low 13 bits zero.
// Inf stays inf and NaN becomes the quiet NaN.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  const uint32_t b = __float_as_uint(x);
  if ((b & 0x7f800000u) == 0x7f800000u) return (b & 0x007fffffu) ? 0x7fc00000u : b;
  return (b + 0x1000u) & 0xffffe000u;
}

// x = hi + lo, both TF32; x - hi is exact in f32.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// d += a * b for one m16n8k8 tile: a row-major 16x8, b column-major 8x8.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(kThreads)
quad_mma_kernel(const float* __restrict__ feat,  // (K, 17)
                const float* __restrict__ pn,    // (17, N)
                float* __restrict__ msac,        // (K,)
                float* __restrict__ count,       // (K,)
                int K, int N, float tau2) {
  __shared__ float s_msac[kWarps][kRows];
  __shared__ float s_count[kWarps][kRows];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;  // the fragments' row group, lane in it
  const int k0 = blockIdx.x * kRows;

  // A fragments of the block's rows. Register r of an m16n8k8 A fragment
  // holds row gid + 8*(r & 1), column tig + 4*(r >> 1) of the tile. Rows
  // past K and the padded columns 17..23 are zero.
  uint32_t a_hi[kMTiles][kKSteps][4], a_lo[kMTiles][kKSteps][4];
#pragma unroll
  for (int mt = 0; mt < kMTiles; ++mt) {
#pragma unroll
    for (int ks = 0; ks < kKSteps; ++ks) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = k0 + mt * 16 + gid + 8 * (r & 1);
        const int col = ks * 8 + tig + 4 * (r >> 1);
        const float x = row < K && col < kFeat
                            ? __ldg(feat + static_cast<size_t>(row) * kFeat + col)
                            : 0.f;
        split(x, a_hi[mt][ks][r], a_lo[mt][ks][r]);
      }
    }
  }

  // Running sums of this thread's rows: [mt][0] is row gid, [mt][1] row gid + 8.
  float m[kMTiles][2], c[kMTiles][2];
#pragma unroll
  for (int mt = 0; mt < kMTiles; ++mt) {
    m[mt][0] = m[mt][1] = 0.f;
    c[mt][0] = c[mt][1] = 0.f;
  }

  const int ntiles = (N + 7) / 8;
  for (int nt = warp; nt < ntiles; nt += kWarps) {
    const int n0 = nt * 8;
    // B fragment: register r holds row (contraction index) tig + 4*r,
    // column gid of the k-step's 8x8 tile.
    uint32_t b_hi[kKSteps][2], b_lo[kKSteps][2];
#pragma unroll
    for (int ks = 0; ks < kKSteps; ++ks) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int f = ks * 8 + tig + 4 * r;
        const int n = n0 + gid;
        const float x = f < kFeat && n < N ? __ldg(pn + static_cast<size_t>(f) * N + n) : 0.f;
        split(x, b_hi[ks][r], b_lo[ks][r]);
      }
    }
    // Accumulator register i holds row gid + 8*(i >> 1), column
    // n0 + 2*tig + (i & 1).
    const bool ok0 = n0 + 2 * tig < N, ok1 = n0 + 2 * tig + 1 < N;
#pragma unroll
    for (int mt = 0; mt < kMTiles; ++mt) {
      float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int ks = 0; ks < kKSteps; ++ks) {  // small passes first
        mma_tf32(d, a_lo[mt][ks], b_hi[ks][0], b_hi[ks][1]);
        mma_tf32(d, a_hi[mt][ks], b_lo[ks][0], b_lo[ks][1]);
        mma_tf32(d, a_hi[mt][ks], b_hi[ks][0], b_hi[ks][1]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if ((i & 1) ? ok1 : ok0) {
          const float e = d[i];
          m[mt][i >> 1] += e > tau2 ? tau2 : e;  // NaN stays NaN
          c[mt][i >> 1] += e < tau2 ? 1.f : 0.f;
        }
      }
    }
  }

  // The four lanes of a row group hold four column shares of the same rows.
#pragma unroll
  for (int mt = 0; mt < kMTiles; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        m[mt][h] += __shfl_xor_sync(0xffffffffu, m[mt][h], off);
        c[mt][h] += __shfl_xor_sync(0xffffffffu, c[mt][h], off);
      }
      if (tig == 0) {
        s_msac[warp][mt * 16 + 8 * h + gid] = m[mt][h];
        s_count[warp][mt * 16 + 8 * h + gid] = c[mt][h];
      }
    }
  }
  __syncthreads();
  if (threadIdx.x < kRows && k0 + threadIdx.x < K) {
    float mj = 0.f, cj = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      mj += s_msac[w][threadIdx.x];
      cj += s_count[w][threadIdx.x];
    }
    msac[k0 + threadIdx.x] = mj;
    count[k0 + threadIdx.x] = cj;
  }
}

}  // namespace

// feat (K, 17) f32, pn (17, N) f32, msac and count (K,) f32; all contiguous.
extern "C" int rgbd_msac_variant_m(const float* feat, const float* pn,
                                   float* msac, float* count, int K, int N,
                                   float tau2, cudaStream_t stream) {
  const int blocks = (K + kRows - 1) / kRows;
  quad_mma_kernel<<<blocks, kThreads, 0, stream>>>(feat, pn, msac, count, K, N, tau2);
  return static_cast<int>(cudaGetLastError());
}
