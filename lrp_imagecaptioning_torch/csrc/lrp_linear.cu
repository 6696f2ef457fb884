// epsilon-LRP linear rule as one tiled f32 GEMM, split along K where the
// output has too few tiles to fill the card:
//     out = x * ((r / stab(z)) @ W^T),   stab(z) = z + (z >= 0 ? eps : -eps), eps = 1e-7
//
// Replaces lrp_imagecaptioning_tpu/ops/pallas_kernels.py:_lrp_linear_kernel.
// r, z: (M, K) row-major; x, out: (M, N); W: (N, K) row-major, i.e. the
// (Din, Dout) weight with K = Dout, N = Din.
//
// Bound on the H100: operations for the wide products (W_img, M = B*T*196:
// 2*M*512*512 FLOP against 4*M*(2*512 + 2*512) bytes) and for the output
// layer (K = 7003); bytes for the thin ones. Full f32 on the CUDA cores: no
// TF32, the callers' tolerances rest on f32 sums.
//
// Design: a 128x128 output tile per block, 256 threads with an 8x8 register
// tile each (rows tm*4 + {0..3} and 64 + tm*4 + {0..3}, columns likewise, so
// the float4 reads of shared memory are free of bank conflicts), BK = 8.
// The stabilised divide is fused into the A-operand staging and the x
// re-weight into the epilogue, so s never reaches device memory. Shared
// memory is double-buffered: the next k-slice is loaded into registers as
// the current one's FMAs start, and divided (div_rn_fast_group, div_rn.cuh:
// exactly `r / stab(z)` without a branch per divide) and stored into the
// other buffer halfway through them, one __syncthreads a slice (divided
// after the FMAs, with `/`, it ran slower). Loads are float4 where
// K % 4 == 0, N % 4 == 0 and every pointer is 16-byte aligned, and scalar
// otherwise (the output layer's K = 7003 is odd, so its rows are not 16-byte
// aligned). grid.x walks the N tiles fastest, so the blocks that share an M
// tile of r and z run together and read it from L2.
//
// ptxas (sm_90a): 125-127 registers (capped at 128 by __launch_bounds__ for
// 2 blocks an SM), 16 896 bytes of static shared memory, no spills. BK = 16
// measured slower: under the cap its prefetch registers spill, without it
// one block an SM fits.
//
// Split-K: grid.y = splits, each over a contiguous range of ceil(slices /
// splits) k-slices (none empty; the wrapper's lrp_linear_splits chooses the
// count so that the blocks fit one wave of two an SM). With more than one
// split each block writes its f32 partial sums to scratch (splits, M, N),
// and a second kernel sums the splits in a fixed order and applies x:
// deterministic, no atomics.

#include <cuda_runtime.h>
#include <stdint.h>

#include "div_rn.cuh"

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 8;
constexpr int NT = 256;
constexpr int PAD = 4;        // row pitch BM + 4: the transposed stores hit 32 banks
constexpr float EPS = 1e-7f;  // K.epsilon(), the reference rule's stabiliser

template <bool VEC>
__global__ void __launch_bounds__(NT, 2)
lrp_linear_kernel(const float* __restrict__ r, const float* __restrict__ z,
                  const float* __restrict__ x, const float* __restrict__ w,
                  float* __restrict__ dst, int64_t M, int K, int N, int n_tiles, int kchunk) {
  __shared__ __align__(16) float As[2][BK][BM + PAD];  // As[b][k][m] = s[m0 + m][k0 + k]
  __shared__ __align__(16) float Bs[2][BK][BN + PAD];  // Bs[b][k][n] = w[n0 + n][k0 + k]
  const int tid = threadIdx.x;
  const int64_t m0 = (int64_t)(blockIdx.x / n_tiles) * BM;
  const int n0 = (blockIdx.x % n_tiles) * BN;
  const int kbeg = blockIdx.y * kchunk;
  const int kend = min(K, kbeg + kchunk);

  // loader: one (row, 4 k) group of A and of B a thread per slice
  const int lrow = tid >> 1;
  const int lk = (tid & 1) * 4;
  const int64_t gm = m0 + lrow;
  const int gn = n0 + lrow;
  float ra[4], za[4], wb[4];
  auto load = [&](int k0) {
    const int gk = k0 + lk;
    if (VEC) {   // K % 4 == 0: the 4 values are all in range or all out
      float4 rv = make_float4(0.f, 0.f, 0.f, 0.f), zv = rv, wv = rv;
      if (gm < M && gk < K) {
        rv = __ldg(reinterpret_cast<const float4*>(r + gm * K + gk));
        zv = __ldg(reinterpret_cast<const float4*>(z + gm * K + gk));
      }
      if (gn < N && gk < K) wv = __ldg(reinterpret_cast<const float4*>(w + (int64_t)gn * K + gk));
      ra[0] = rv.x; ra[1] = rv.y; ra[2] = rv.z; ra[3] = rv.w;
      za[0] = zv.x; za[1] = zv.y; za[2] = zv.z; za[3] = zv.w;
      wb[0] = wv.x; wb[1] = wv.y; wb[2] = wv.z; wb[3] = wv.w;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool in_k = gk + i < K;
        ra[i] = (gm < M && in_k) ? __ldg(r + gm * K + gk + i) : 0.f;
        za[i] = (gm < M && in_k) ? __ldg(z + gm * K + gk + i) : 0.f;
        wb[i] = (gn < N && in_k) ? __ldg(w + (int64_t)gn * K + gk + i) : 0.f;
      }
    }
  };
  auto store = [&](int b) {   // s = r / stab(z); r = z = 0 (masked) gives 0
    float s[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) za[i] += za[i] >= 0.f ? EPS : -EPS;
    if (!div_rn_fast_group(ra, za, s)) {
#pragma unroll
      for (int i = 0; i < 4; ++i) s[i] = ra[i] / za[i];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      As[b][lk + i][lrow] = s[i];
      Bs[b][lk + i][lrow] = wb[i];
    }
  };

  const int tm = tid >> 4;  // rows tm*4 .. +3 and 64 + tm*4 .. +3
  const int tn = tid & 15;  // cols tn*4 .. +3 and 64 + tn*4 .. +3
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  load(kbeg);
  store(0);
  __syncthreads();
  int b = 0;
  for (int k0 = kbeg; k0 < kend; k0 += BK) {
    const bool more = k0 + BK < kend;
    if (more) load(k0 + BK);
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[b][k][tm * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[b][k][64 + tm * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[b][k][tn * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[b][k][64 + tn * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      // the next slice's s halfway through this one's FMAs, which hide the divides
      if (k == BK / 2 - 1 && more) store(b ^ 1);
    }
    __syncthreads();
    b ^= 1;
  }

  // x == nullptr: write this split's partial sums to dst + split * M * N
  float* const d = x ? dst : dst + (int64_t)blockIdx.y * M * N;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t row = m0 + (i >> 2) * 64 + tm * 4 + (i & 3);
    if (row >= M) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = n0 + h * 64 + tn * 4;
      const int64_t off = row * N + col;
      if (VEC && col < N) {   // N % 4 == 0: all 4 columns are in range
        float4 v = make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                               acc[i][4 * h + 3]);
        if (x) {
          const float4 xv = __ldg(reinterpret_cast<const float4*>(x + off));
          v.x *= xv.x; v.y *= xv.y; v.z *= xv.z; v.w *= xv.w;
        }
        *reinterpret_cast<float4*>(d + off) = v;
      } else if (!VEC) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (col + j < N) d[off + j] = x ? x[off + j] * acc[i][4 * h + j] : acc[i][4 * h + j];
      }
    }
  }
}

// out = x * (sum over splits of the partials), the splits in order
__global__ void lrp_linear_reduce_kernel(const float* __restrict__ part,
                                         const float* __restrict__ x, float* __restrict__ out,
                                         int64_t MN, int splits) {
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < MN;
       i += (int64_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < splits; ++k) s += part[k * MN + i];
    out[i] = x[i] * s;
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// part: scratch of splits * M * N floats, or null when splits == 1
extern "C" int lrp_linear_f32(const float* r, const float* z, const float* x, const float* w,
                              float* out, float* part, int64_t M, int K, int N, int splits,
                              void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || splits < 1 || splits > 65535 || (splits > 1 && !part))
    return (int)cudaErrorInvalidValue;
  const int slices = (K + BK - 1) / BK;
  const int per = (slices + splits - 1) / splits;
  if ((int64_t)(splits - 1) * per >= slices) return (int)cudaErrorInvalidValue;  // an empty split
  const int64_t m_tiles = (M + BM - 1) / BM;
  const int n_tiles = (N + BN - 1) / BN;
  if (m_tiles * n_tiles > 2147483647LL) return (int)cudaErrorInvalidValue;
  const bool vec = K % 4 == 0 && N % 4 == 0 && aligned16(r) && aligned16(z) && aligned16(w) &&
                   aligned16(x) && aligned16(out) && (!part || aligned16(part));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)(m_tiles * n_tiles), (unsigned)splits);
  float* const dst = splits == 1 ? out : part;
  const float* const xs = splits == 1 ? x : nullptr;
  if (vec)
    lrp_linear_kernel<true><<<grid, NT, 0, s>>>(r, z, xs, w, dst, M, K, N, n_tiles, per * BK);
  else
    lrp_linear_kernel<false><<<grid, NT, 0, s>>>(r, z, xs, w, dst, M, K, N, n_tiles, per * BK);
  if (splits > 1) {
    const int64_t mn = M * N;
    const int64_t blocks = (mn + 255) / 256;
    lrp_linear_reduce_kernel<<<(unsigned)(blocks < 65535 ? blocks : 65535), 256, 0, s>>>(
        part, x, out, mn, splits);
  }
  return (int)cudaGetLastError();
}
