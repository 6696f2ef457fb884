// epsilon-LRP linear rule as one tiled f32 GEMM:
//     out = x * ((r / stab(z)) @ W^T),   stab(z) = z + (z >= 0 ? eps : -eps), eps = 1e-7
//
// Replaces lrp_imagecaptioning_tpu/ops/pallas_kernels.py:_lrp_linear_kernel.
// r, z: (M, K) row-major; x, out: (M, N); W: (N, K) row-major, i.e. the
// (Din, Dout) weight with K = Dout, N = Din.
//
// Bound on the H100: operations for the wide products (W_img, M = B*T*196:
// 2*M*512*512 FLOP against 4*M*(2*512 + 2*512) bytes), bytes for the thin
// ones. The stabilised divide is fused into the A-operand staging and the
// x re-weight into the epilogue, so neither s nor s @ W^T goes to device
// memory. f32 on the CUDA cores; 64x64 output tile, 256 threads with a 4x4
// register tile each, BK = 16 deep. K (= Dout, 7003 at the output layer) and
// the M/N edges are masked; row offsets are 64-bit (M reaches 219 520).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int NT = 256;
constexpr float EPS = 1e-7f;  // K.epsilon(), the reference rule's stabiliser

__global__ void __launch_bounds__(NT)
lrp_linear_kernel(const float* __restrict__ r, const float* __restrict__ z,
                  const float* __restrict__ x, const float* __restrict__ w,
                  float* __restrict__ out, int64_t M, int K, int N) {
  __shared__ float As[BK][BM + 4];  // As[k][m] = s[m0 + m][k0 + k]
  __shared__ float Bs[BK][BN + 4];  // Bs[k][n] = w[n0 + n][k0 + k]
  const int tid = threadIdx.x;
  const int64_t m0 = (int64_t)blockIdx.x * BM;  // grid.x: up to 2^31-1 tiles
  const int n0 = blockIdx.y * BN;
  const int tm = tid / 16;  // rows tm*4 .. tm*4+3
  const int tn = tid % 16;  // cols tn*4 .. tn*4+3
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int i = 0; i < (BM * BK) / NT; ++i) {
      const int e = tid + i * NT;
      const int am = e / BK, ak = e % BK;
      const int64_t gm = m0 + am;
      const int gk = k0 + ak;
      float v = 0.f;
      if (gm < M && gk < K) {
        const float zz = z[gm * K + gk];
        v = r[gm * K + gk] / (zz + (zz >= 0.f ? EPS : -EPS));
      }
      As[ak][am] = v;
    }
#pragma unroll
    for (int i = 0; i < (BN * BK) / NT; ++i) {
      const int e = tid + i * NT;
      const int bn = e / BK, bk = e % BK;
      const int gn = n0 + bn;
      const int gk = k0 + bk;
      Bs[bk][bn] = (gn < N && gk < K) ? w[(int64_t)gn * K + gk] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[k][tm * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[k][tn * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t gm = m0 + tm * 4 + i;
    if (gm >= M) break;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tn * 4 + j;
      if (gn < N) out[gm * N + gn] = x[gm * N + gn] * acc[i][j];
    }
  }
}

}  // namespace

extern "C" int lrp_linear_f32(const float* r, const float* z, const float* x, const float* w,
                              float* out, int64_t M, int K, int N, void* stream) {
  const int64_t m_tiles = (M + BM - 1) / BM;
  if (m_tiles > 2147483647LL) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)m_tiles, (N + BN - 1) / BN);
  lrp_linear_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(r, z, x, w, out, M, K, N);
  return (int)cudaGetLastError();
}
