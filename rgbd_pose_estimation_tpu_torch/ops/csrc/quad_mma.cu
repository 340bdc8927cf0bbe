// The f32 quad-form MSAC scorer on the tensor cores (T3).
//
// Replaces the TPU kernel `_kernel_M` of tools/msac_opt.py (`variant_M`):
// e = feat @ pn as one (K, 17) x (17, N) f32 product on the matrix unit,
// then per pose k sum_n min(e_kn, tau^2) and sum_n [e_kn < tau^2]. The
// (K, N) matrix never reaches device memory.
//
// The product runs on Hopper's tensor cores through the warpgroup MMA,
// wgmma.mma_async m64n128k8 with TF32 operands and f32 accumulation; the
// contraction is zero-padded from 17 to 24 (three k-steps of 8). One TF32
// pass keeps about three decimal digits, and the 17 terms, of order 10-50,
// cancel down to residuals near tau^2 = 2.5e-3: one pass would put counts on
// the wrong side of tau^2. So each operand is split, x = hi + lo with hi and
// lo both TF32 (cvt.rna: round to nearest, ties away from zero), and the
// product is the sum of the three passes lo*hi + hi*lo + hi*hi (3xTF32; the
// dropped lo*lo is ~2^-22 of a term): the f32 product that `_kernel_M`
// computes, up to the order of the sum. TF32 has f32's exponent range, so the
// ~1e8 pn entries of the far-away pad correspondences keep their size in
// both parts.
//
// Bound on this card: operations, 3 passes of 2*17*K*N at the TF32
// tensor-core peak, and a few operations an entry for the epilogue at the
// f32 peak; the bytes, 4*(17*K + 17*N + 2*K), are negligible.
//
// Design. A warpgroup (4 warps) scores 64 poses, one wgmma row tile; a
// block holds two of them (128 poses) where that still gives every SM a
// block (K >= 132 * 128), else one. At K = 32768: 256 blocks of two
// warpgroups, two resident on each of the 132 SMs, one wave. The poses'
// features are split into hi and lo once, into the registers of the wgmma A
// fragment, and stay there. pn is walked in tiles of 128 columns: the block
// brings each tile into a ring of three raw stages with cp.async (16-byte
// copies along N where N is a multiple of 4, 4-byte copies otherwise;
// columns past N are zero-filled), then all its threads split the tile once
// into hi and lo planes, written transposed (K-major, as the TF32 wgmma takes
// B) in 8 x 16-byte core matrices without swizzle, double-buffered, for both
// warpgroups (74 KB of shared memory a block). Each warpgroup issues the
// nine products of a tile (3 k-steps x 3 passes, small passes first)
// asynchronously; while they run, the block splits the next tile; then the
// warpgroup clamps, counts and sums the tile's accumulators, while the other
// block on the SM keeps the tensor cores busy. One accumulator set a
// warpgroup, 128 registers a thread: a second set, to overlap a warpgroup's
// own epilogue with its next products, made ptxas serialise the products
// for want of registers. The clamp is min.NaN, so that NaN stays NaN;
// columns past N are masked, rows past K are zero and not stored. A row's
// scores go to four partial sums, so that no f32 sum runs over more than
// N / 16 entries; at the end the four lanes that share a row add their sums
// with shuffles in a fixed order. No atomics: a rerun gives the same bits.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kFeat = 17;             // terms of the bilinear form
constexpr int kKSteps = 3;            // contraction padded to 24 = 3 x k8
constexpr int kChunks = 2 * kKSteps;  // 4-float (16-byte) core-matrix columns along k
constexpr int kTileN = 128;           // columns a tile: wgmma n128
constexpr int kStages = 3;            // raw pn tiles in flight
constexpr int kPlane = kChunks * kTileN * 4;  // floats of one split plane of a tile
constexpr int kRaw = kFeat * kTileN;          // floats of one raw tile
// Descriptor strides of a plane: the k-direction core matrices lie
// kTileN * 16 bytes apart (LBO), the 8-column groups 128 bytes (SBO).
constexpr uint32_t kLbo = kTileN * 16, kSbo = 128;

__device__ __forceinline__ uint32_t cvt_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, both TF32; x - hi is exact in f32.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = cvt_tf32(x);
  lo = cvt_tf32(x - __uint_as_float(hi));
}

// f32 -> TF32 by bits (round to nearest, ties away, low 13 bits zero; inf
// stays inf, NaN becomes the quiet NaN): the reference that
// tf32_split_check_kernel holds cvt.rna against.
__device__ __forceinline__ uint32_t to_tf32_bits(float x) {
  const uint32_t b = __float_as_uint(x);
  if ((b & 0x7f800000u) == 0x7f800000u) return (b & 0x007fffffu) ? 0x7fc00000u : b;
  return (b + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Matrix descriptor of a K-major plane without swizzle, at p.
__device__ __forceinline__ uint64_t plane_desc(const float* p) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3ffffu) >> 4) |
         static_cast<uint64_t>(kLbo >> 4) << 16 | static_cast<uint64_t>(kSbo >> 4) << 32;
}

// Keeps the compiler from moving accesses of the accumulators across the
// asynchronous products that write them.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= a * b: a the 64 x 8 A fragment in registers, b the 8 x 128
// K-major tile in shared memory kOff bytes past the one descriptor `b`
// names (the offset is added inside the asm, so that the compiler keeps one
// descriptor in registers, not one per buffer and pass). kScaleD = 0
// overwrites d.
template <int kOff, int kScaleD>
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 desc;\nsetp.ne.b32 p, %69, 0;\n"
      "add.s64 desc, %68, %70;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, desc, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(kScaleD), "n"(kOff >> 4));
}

struct Smem {
  float planes[2][2][kPlane];  // [buffer][hi, lo], K-major core matrices
  float raw[kStages][kRaw];    // [stage][row f][column], as pn lies
};

// Starts the copies of pn's tile t (columns t*128 ..) into raw stage t % kStages.
template <int kThreads, bool kVec>
__device__ __forceinline__ void load_tile(Smem& s, const float* __restrict__ pn, int N, int t) {
  float* dst = s.raw[t % kStages];
  const int n0 = t * kTileN;
  if (kVec) {  // 16-byte pieces: N % 4 == 0, so a piece is all in or all out
    for (int i = threadIdx.x; i < kRaw / 4; i += kThreads) {
      const int f = i / (kTileN / 4), n = n0 + 4 * (i % (kTileN / 4));
      const bool in = n < N;
      const float* src = pn + (in ? static_cast<size_t>(f) * N + n : 0);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst + 4 * i)),
                   "l"(src), "r"(in ? 16 : 0));
    }
  } else {
    for (int i = threadIdx.x; i < kRaw; i += kThreads) {
      const int f = i / kTileN, n = n0 + i % kTileN;
      const bool in = n < N;
      const float* src = pn + (in ? static_cast<size_t>(f) * N + n : 0);
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst + i)),
                   "l"(src), "r"(in ? 4 : 0));
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Splits raw stage t % kStages into the hi and lo planes of buffer t & 1:
// element (f, n) goes to float 4 * kTileN * (f / 4) + 4 * n + f % 4 of a
// plane. Thread i takes column n = i % 128 and the 4-row chunks i / 128,
// i / 128 + kThreads / 128, ... below 4; the first 128 threads also row 16.
// Rows 17-23 stay zero. The fence makes the planes visible to wgmma.
template <int kThreads>
__device__ __forceinline__ void split_tile(Smem& s, int t) {
  const float* raw = s.raw[t % kStages];
  float* hi = s.planes[t & 1][0];
  float* lo = s.planes[t & 1][1];
  const int n = threadIdx.x % kTileN;
#pragma unroll
  for (int j = 0; j < 4 * kTileN / kThreads; ++j) {
    const int c = threadIdx.x / kTileN + j * (kThreads / kTileN);
    uint4 h, l;
    split(raw[(4 * c + 0) * kTileN + n], h.x, l.x);
    split(raw[(4 * c + 1) * kTileN + n], h.y, l.y);
    split(raw[(4 * c + 2) * kTileN + n], h.z, l.z);
    split(raw[(4 * c + 3) * kTileN + n], h.w, l.w);
    *reinterpret_cast<uint4*>(hi + c * 4 * kTileN + 4 * n) = h;
    *reinterpret_cast<uint4*>(lo + c * 4 * kTileN + 4 * n) = l;
  }
  if (threadIdx.x < kTileN) {
    uint32_t h, l;
    split(raw[16 * kTileN + n], h, l);
    hi[4 * 4 * kTileN + 4 * n] = __uint_as_float(h);
    lo[4 * 4 * kTileN + 4 * n] = __uint_as_float(l);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The products of buffer kBuf's tile into d, per k-step (two 16-byte
// chunks) lo*hi, hi*lo, hi*hi. `desc` names buffer 0's hi plane.
template <int kBuf, int kStep>
__device__ __forceinline__ void k_step(float (&d)[64], const uint32_t (&a_hi)[4],
                                       const uint32_t (&a_lo)[4], uint64_t desc) {
  constexpr int kHi = 4 * (kBuf * 2 * kPlane + 2 * kStep * 4 * kTileN);  // bytes
  constexpr int kLo = kHi + 4 * kPlane;
  wgmma_tf32<kHi, kStep == 0 ? 0 : 1>(d, a_lo, desc);
  wgmma_tf32<kLo, 1>(d, a_hi, desc);
  wgmma_tf32<kHi, 1>(d, a_hi, desc);
}

template <int kBuf>
__device__ __forceinline__ void issue_products(float (&d)[64], const uint32_t (&a_hi)[kKSteps][4],
                                               const uint32_t (&a_lo)[kKSteps][4], uint64_t desc) {
  static_assert(kKSteps == 3, "three k-steps of 8");
  fence_acc(d);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
  k_step<kBuf, 0>(d, a_hi[0], a_lo[0], desc);
  k_step<kBuf, 1>(d, a_hi[1], a_lo[1], desc);
  k_step<kBuf, 2>(d, a_hi[2], a_lo[2], desc);
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Clamp, count and sum a tile's accumulators into this thread's two rows.
// Register i holds row gid + 8 * ((i >> 1) & 1), column
// 8 * (i >> 2) + 2 * tig + (i & 1) of the tile; the row's four partial
// sums take the column groups i >> 2 modulo 4. min.NaN keeps NaN (a plain min
// would drop it); set.lt gives 1.0 or 0.0, and 0.0 for NaN.
template <bool kMask>
__device__ __forceinline__ void epilogue(const float (&d)[64], int col0, int N, float tau2,
                                         float (&m)[2][4], float (&c)[2]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    if (kMask && col0 + 8 * (i >> 2) + (i & 1) >= N) continue;
    const float e = d[i];
    float clamped, below;
    asm("min.NaN.f32 %0, %1, %2;\n" : "=f"(clamped) : "f"(e), "f"(tau2));
    asm("set.lt.f32.f32 %0, %1, %2;\n" : "=f"(below) : "f"(e), "f"(tau2));
    m[(i >> 1) & 1][(i >> 2) & 3] += clamped;
    c[(i >> 1) & 1] += below;
  }
}

// One tile: start its products (buffer kBuf) into d; while they run, split
// tile t + 1 into the other buffer and start the copies of tile t + 3; then
// wait for the products and finish the tile. The barrier at the end makes
// the next buffer whole and frees this one.
template <int kThreads, bool kVec, int kBuf>
__device__ __forceinline__ void tile_turn(Smem& s, const float* __restrict__ pn, int N, float tau2,
                                          int t, int tiles, int tig, uint64_t desc,
                                          float (&d)[64], const uint32_t (&a_hi)[kKSteps][4],
                                          const uint32_t (&a_lo)[kKSteps][4], float (&m)[2][4],
                                          float (&c)[2]) {
  issue_products<kBuf>(d, a_hi, a_lo, desc);
  if (t + 1 < tiles) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2) : "memory");
    __syncthreads();  // tile t + 1 is in; raw stage t % kStages is free
    if (t + kStages < tiles) {
      load_tile<kThreads, kVec>(s, pn, N, t + kStages);
    } else {
      asm volatile("cp.async.commit_group;\n" ::: "memory");  // one group a tile
    }
    split_tile<kThreads>(s, t + 1);
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_acc(d);
  const int n0 = t * kTileN;
  if (n0 + kTileN <= N) {
    epilogue<false>(d, 0, N, tau2, m, c);
  } else {
    epilogue<true>(d, n0 + 2 * tig, N, tau2, m, c);
  }
  __syncthreads();
}

// kWG warpgroups a block, 64 poses each.
template <int kWG, bool kVec>
__global__ void __launch_bounds__(128 * kWG, kWG == 1 ? 3 : 2)
quad_mma_kernel(const float* __restrict__ feat,  // (K, 17)
                const float* __restrict__ pn,    // (17, N)
                float* __restrict__ msac,        // (K,)
                float* __restrict__ count,       // (K,)
                int K, int N, float tau2) {
  constexpr int kThreads = 128 * kWG;
  extern __shared__ __align__(128) unsigned char smem_buf[];
  Smem& s = *reinterpret_cast<Smem*>(smem_buf);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;  // warp 4 * wg + w
  const int gid = lane >> 2, tig = lane & 3;  // the fragments' row group, lane in it
  const int k0 = blockIdx.x * 64 * kWG + 16 * warp;  // this warp's first row
  const int tiles = (N + kTileN - 1) / kTileN;

  for (int i = threadIdx.x; i < 2 * 2 * kPlane; i += kThreads) (&s.planes[0][0][0])[i] = 0.f;
#pragma unroll
  for (int t = 0; t < kStages; ++t) {
    if (t < tiles) {
      load_tile<kThreads, kVec>(s, pn, N, t);
    } else {
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
  }

  // A fragments of the warp's 16 rows, split once. Register r holds row
  // gid + 8 * (r & 1), column tig + 4 * (r >> 1) of the k-step. Rows past K
  // and the padded columns 17..23 are zero.
  uint32_t a_hi[kKSteps][4], a_lo[kKSteps][4];
#pragma unroll
  for (int ks = 0; ks < kKSteps; ++ks) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = k0 + gid + 8 * (r & 1);
      const int col = ks * 8 + tig + 4 * (r >> 1);
      const float x = row < K && col < kFeat
                          ? __ldg(feat + static_cast<size_t>(row) * kFeat + col)
                          : 0.f;
      split(x, a_hi[ks][r], a_lo[ks][r]);
    }
  }

  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1) : "memory");
  __syncthreads();  // tile 0 is in, the planes are zero
  split_tile<kThreads>(s, 0);
  __syncthreads();

  float d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.f;
  float m[2][4] = {}, c[2] = {0.f, 0.f};  // rows gid and gid + 8
  const uint64_t desc = plane_desc(s.planes[0][0]);
  int t = 0;
  for (; t + 1 < tiles; t += 2) {  // tile t in buffer t & 1
    tile_turn<kThreads, kVec, 0>(s, pn, N, tau2, t, tiles, tig, desc, d, a_hi, a_lo, m, c);
    tile_turn<kThreads, kVec, 1>(s, pn, N, tau2, t + 1, tiles, tig, desc, d, a_hi, a_lo, m, c);
  }
  if (t < tiles) {
    tile_turn<kThreads, kVec, 0>(s, pn, N, tau2, t, tiles, tig, desc, d, a_hi, a_lo, m, c);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");

  // The four lanes of a row group hold four column shares of the same rows.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mh = (m[h][0] + m[h][1]) + (m[h][2] + m[h][3]);
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mh += __shfl_xor_sync(0xffffffffu, mh, off);
      c[h] += __shfl_xor_sync(0xffffffffu, c[h], off);
    }
    const int row = k0 + gid + 8 * h;
    if (tig == 0 && row < K) {
      msac[row] = mh;
      count[row] = c[h];
    }
  }
}

// For each x[i]: out[4i ..] = the hi and lo bits of cvt.rna's split, then
// of the bit-level split.
__global__ void tf32_split_check_kernel(const float* __restrict__ x, uint32_t* __restrict__ out,
                                        int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t h, l;
  split(x[i], h, l);
  const uint32_t hb = to_tf32_bits(x[i]);
  out[4 * i + 0] = h;
  out[4 * i + 1] = l;
  out[4 * i + 2] = hb;
  out[4 * i + 3] = to_tf32_bits(x[i] - __uint_as_float(hb));
}

template <int kWG, bool kVec>
int launch(const float* feat, const float* pn, float* msac, float* count, int K, int N,
           float tau2, cudaStream_t stream) {
  const auto kernel = quad_mma_kernel<kWG, kVec>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(sizeof(Smem)));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<(K + 64 * kWG - 1) / (64 * kWG), 128 * kWG, sizeof(Smem), stream>>>(
      feat, pn, msac, count, K, N, tau2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// feat (K, 17) f32, pn (17, N) f32, msac and count (K,) f32; all contiguous.
extern "C" int rgbd_msac_variant_m(const float* feat, const float* pn,
                                   float* msac, float* count, int K, int N,
                                   float tau2, cudaStream_t stream) {
  const bool vec = N % 4 == 0 && reinterpret_cast<uintptr_t>(pn) % 16 == 0;
  if ((K + 127) / 128 >= 132) {  // two warpgroups a block still give every SM one
    return vec ? launch<2, true>(feat, pn, msac, count, K, N, tau2, stream)
               : launch<2, false>(feat, pn, msac, count, K, N, tau2, stream);
  }
  return vec ? launch<1, true>(feat, pn, msac, count, K, N, tau2, stream)
             : launch<1, false>(feat, pn, msac, count, K, N, tau2, stream);
}

// x (n,) f32, out (n, 4) uint32: T3's split by cvt.rna against the bit-level one.
extern "C" int rgbd_tf32_split_check(const float* x, uint32_t* out, int n, cudaStream_t stream) {
  tf32_split_check_kernel<<<(n + 255) / 256, 256, 0, stream>>>(x, out, n);
  return static_cast<int>(cudaGetLastError());
}
