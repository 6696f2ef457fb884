// LSTM step tail, from the two gate products, the bias and c_prev:
//     z_pre = (zx + zh) + b                    (B, 4H), gate order [i, f, g, o]
//     c     = sig(f) * c_prev + sig(i) * tanh(g)
//     h     = sig(o) * tanh(c)
// with zx = x @ W_i and zh = h_prev @ W_h computed by the caller.
//
// Replaces lrp_imagecaptioning_tpu/ops/pallas_kernels.py:_lstm_gates_kernel
// and the two adds before it. z_pre is summed in the JAX package's order
// (lrp_imagecaptioning_tpu/models/cells.py:51, x @ wi + h @ wh + b), each add
// rounded once, so it is bit for bit the z_pre of the unfused step; the
// decoder LRP reads it back from the step cache.
//
// Bound on the H100: neither. At B = 24..168 rows of H = 512 the kernel moves
// 0.5-3.5 MB, a microsecond or less at 3.35 TB/s, so a call costs its launch.
// The design cuts launches: the two adds and the tail are one launch (three
// before), and the caller replays the whole decoder loop from a CUDA graph.
// A thread takes 4 adjacent j of one row: 16-byte loads of zx, zh and b for
// each gate and of c_prev, 16-byte stores of z_pre, h and c (H % 4 == 0 and
// 16-byte bases; the wrapper checks both).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// (a + b) + c, each add rounded to nearest (no contraction)
__device__ __forceinline__ float4 add3(float4 a, float4 b, float4 c) {
  return make_float4(__fadd_rn(__fadd_rn(a.x, b.x), c.x), __fadd_rn(__fadd_rn(a.y, b.y), c.y),
                     __fadd_rn(__fadd_rn(a.z, b.z), c.z), __fadd_rn(__fadd_rn(a.w, b.w), c.w));
}

__device__ __forceinline__ float cell(float i, float f, float g, float cp) {
  return sigmoid(f) * cp + sigmoid(i) * tanhf(g);
}

__global__ void lstm_gates_kernel(const float* __restrict__ zx, const float* __restrict__ zh,
                                  const float* __restrict__ bias,
                                  const float* __restrict__ c_prev, float* __restrict__ z_pre,
                                  float* __restrict__ h, float* __restrict__ c, int64_t quads,
                                  int H) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;   // one per 4 j
  if (idx >= quads) return;
  const int hq = H / 4;
  const int64_t b = idx / hq;
  const int j = (int)(idx % hq) * 4;
  const int64_t row = b * 4 * H;
  float4 z[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {   // gates i, f, g, o
    const int64_t off = row + q * H + j;
    z[q] = add3(ld4(zx + off), ld4(zh + off), ld4(bias + q * H + j));
    *reinterpret_cast<float4*>(z_pre + off) = z[q];
  }
  const float4 cp = ld4(c_prev + b * H + j);
  const float4 cn = make_float4(cell(z[0].x, z[1].x, z[2].x, cp.x),
                                cell(z[0].y, z[1].y, z[2].y, cp.y),
                                cell(z[0].z, z[1].z, z[2].z, cp.z),
                                cell(z[0].w, z[1].w, z[2].w, cp.w));
  *reinterpret_cast<float4*>(c + b * H + j) = cn;
  *reinterpret_cast<float4*>(h + b * H + j) =
      make_float4(sigmoid(z[3].x) * tanhf(cn.x), sigmoid(z[3].y) * tanhf(cn.y),
                  sigmoid(z[3].z) * tanhf(cn.z), sigmoid(z[3].w) * tanhf(cn.w));
}

}  // namespace

extern "C" int lstm_gates_f32(const float* zx, const float* zh, const float* bias,
                              const float* c_prev, float* z_pre, float* h, float* c, int64_t B,
                              int H, void* stream) {
  if (B <= 0 || H <= 0 || H % 4) return (int)cudaErrorInvalidValue;
  const int64_t quads = B * (H / 4);
  const int threads = 128;
  const int64_t blocks = (quads + threads - 1) / threads;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  lstm_gates_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      zx, zh, bias, c_prev, z_pre, h, c, quads, H);
  return (int)cudaGetLastError();
}
