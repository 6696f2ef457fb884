// LSTM gate tail: from z_pre (B, 4H) in gate order [i, f, g, o] and c_prev
// (B, H):  c = sig(f) * c_prev + sig(i) * tanh(g),  h = sig(o) * tanh(c).
//
// Replaces lrp_imagecaptioning_tpu/ops/pallas_kernels.py:_lstm_gates_kernel.
// Bound on the H100: bytes (6 floats moved per 5 transcendentals); one
// thread per (b, j) element reads its four gate columns and c_prev and
// writes h and c, so the gate activations never reach device memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

__global__ void lstm_gates_kernel(const float* __restrict__ z, const float* __restrict__ c_prev,
                                  float* __restrict__ h, float* __restrict__ c,
                                  int64_t total, int H) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int64_t b = idx / H;
  const int j = (int)(idx % H);
  const float* zr = z + b * 4 * H;
  const float ig = sigmoid(zr[j]);
  const float fg = sigmoid(zr[H + j]);
  const float gg = tanhf(zr[2 * H + j]);
  const float og = sigmoid(zr[3 * H + j]);
  const float cn = fg * c_prev[idx] + ig * gg;
  c[idx] = cn;
  h[idx] = og * tanhf(cn);
}

}  // namespace

extern "C" int lstm_gates_f32(const float* z, const float* c_prev, float* h, float* c,
                              int64_t B, int H, void* stream) {
  const int64_t total = B * H;
  const int threads = 256;
  const int64_t blocks = (total + threads - 1) / threads;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  lstm_gates_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(z, c_prev, h, c, total, H);
  return (int)cudaGetLastError();
}
