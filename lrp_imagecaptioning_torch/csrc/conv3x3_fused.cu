// Direct 3x3 SAME stride-1 conv in NHWC with a fused elementwise epilogue:
//     divide:    out = ew / safe(conv(x, W) + b),  safe(z) = z + (z == 0) * 1e-7
//     multiply:  out = ew * conv(x, W)
//
// Replaces lrp_imagecaptioning_tpu/ops/pallas_conv_lrp.py:_conv3x3_kernel.
// x: (Nc, H, W, Cin); ew: (Ne, H, W, Cout); taps: (3, 3, Cin, Cout) HWIO;
// out: (N, H, W, Cout) with N = max(Nc, Ne) and Nc, Ne each 1 or N. A
// batch-1 operand is shared by all N words: when the conv input has batch 1
// (the divide pass, x shared by every word seed) the block computes its
// conv tile ONCE and applies the epilogue for all N words, so z is never
// recomputed per word and never stored.
//
// Bound on the H100: operations (2*H*W*9*Cin*Cout FLOP per conv image on the
// f32 CUDA cores against 4*(Cin + 2*Cout) bytes per pixel). Design: a block
// owns an 8x16 pixel tile x 64 output channels; it stages a halo'd
// (10 x 18 x 8-channel) input slab and the matching 9 x 8 x 64 taps in shared
// memory, and each of its 256 threads accumulates 8 pixels x 4 channels in
// f32 registers (10 input + 3 float4 tap loads per 96 FMAs). Cin = 64 is
// taken as it is; the TPU's pad to 128 channels was a Mosaic constraint.
// The epilogue reads ew and bias and writes out as float4 (Cout % 4 == 0,
// 16-byte-aligned bases; the wrapper checks both).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TH = 8;         // tile rows
constexpr int TW = 16;        // tile cols
constexpr int TC = 64;        // output channels per block
constexpr int CK = 8;         // input channels per shared-memory stage
constexpr int CKP = CK + 1;   // padded pixel pitch: the two half-warps hit different banks
constexpr int NT = 256;
constexpr int PX = 8;         // pixels per thread (one row segment)
constexpr float EPS = 1e-7f;  // SafeDivide's factor, K.epsilon()

__global__ void __launch_bounds__(NT)
conv3x3_fused_kernel(const float* __restrict__ x, const float* __restrict__ ew,
                     const float* __restrict__ taps, const float* __restrict__ bias,
                     float* __restrict__ out, int N, int Nc, int Ne, int H, int W,
                     int Cin, int Cout, int divide) {
  __shared__ float xs[(TH + 2) * (TW + 2) * CKP];
  __shared__ __align__(16) float ws[9 * CK * TC];

  const int tiles_w = (W + TW - 1) / TW;
  const int th0 = (blockIdx.x / tiles_w) * TH;
  const int tw0 = (blockIdx.x % tiles_w) * TW;
  const int co0 = blockIdx.y * TC;
  const int nc = blockIdx.z;
  const int tid = threadIdx.x;
  const int cg = tid & 15;            // channels co0 + cg*4 .. +3
  const int pg = tid >> 4;            // 0..15
  const int prow = pg >> 1;           // tile row 0..7
  const int pcol0 = (pg & 1) * PX;    // tile cols pcol0 .. pcol0+7

  float acc[PX][4];
#pragma unroll
  for (int i = 0; i < PX; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const float* xn = x + (int64_t)nc * H * W * Cin;
  for (int c0 = 0; c0 < Cin; c0 += CK) {
    for (int e = tid; e < (TH + 2) * (TW + 2) * CK; e += NT) {
      const int ci = e % CK;
      const int p = e / CK;
      const int gh = th0 - 1 + p / (TW + 2);
      const int gw = tw0 - 1 + p % (TW + 2);
      const int gc = c0 + ci;
      float v = 0.f;
      if (gh >= 0 && gh < H && gw >= 0 && gw < W && gc < Cin)
        v = xn[((int64_t)gh * W + gw) * Cin + gc];
      xs[p * CKP + ci] = v;
    }
    for (int e = tid; e < 9 * CK * TC; e += NT) {
      const int co = e % TC;
      const int t2 = e / TC;
      const int ci = t2 % CK;
      const int tap = t2 / CK;
      const int gc = c0 + ci;
      const int gco = co0 + co;
      ws[e] = (gc < Cin && gco < Cout) ? taps[((int64_t)tap * Cin + gc) * Cout + gco] : 0.f;
    }
    __syncthreads();
#pragma unroll 2
    for (int ci = 0; ci < CK; ++ci) {
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        float xv[PX + 2];
#pragma unroll
        for (int i = 0; i < PX + 2; ++i)
          xv[i] = xs[((prow + dy) * (TW + 2) + pcol0 + i) * CKP + ci];
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float4 wv =
              *reinterpret_cast<const float4*>(&ws[((dy * 3 + dx) * CK + ci) * TC + cg * 4]);
#pragma unroll
          for (int i = 0; i < PX; ++i) {
            acc[i][0] = fmaf(xv[i + dx], wv.x, acc[i][0]);
            acc[i][1] = fmaf(xv[i + dx], wv.y, acc[i][1]);
            acc[i][2] = fmaf(xv[i + dx], wv.z, acc[i][2]);
            acc[i][3] = fmaf(xv[i + dx], wv.w, acc[i][3]);
          }
        }
      }
    }
    __syncthreads();
  }

  const int gh = th0 + prow;
  const int gco = co0 + cg * 4;
  if (gh >= H || gco >= Cout) return;
  float4 bv = make_float4(0.f, 0.f, 0.f, 0.f);
  if (divide && bias != nullptr) bv = *reinterpret_cast<const float4*>(bias + gco);
  const int n_begin = (Nc == N) ? nc : 0;
  const int n_end = (Nc == N) ? nc + 1 : N;
  const int64_t plane = (int64_t)H * W * Cout;
  for (int n = n_begin; n < n_end; ++n) {
    const float* ewn = ew + (Ne == 1 ? 0 : (int64_t)n * plane);
    float* on = out + (int64_t)n * plane;
#pragma unroll
    for (int i = 0; i < PX; ++i) {
      const int gw = tw0 + pcol0 + i;
      if (gw >= W) break;
      const int64_t off = ((int64_t)gh * W + gw) * Cout + gco;
      const float4 e = *reinterpret_cast<const float4*>(ewn + off);
      float4 o;
      if (divide) {
        float z0 = acc[i][0] + bv.x, z1 = acc[i][1] + bv.y;
        float z2 = acc[i][2] + bv.z, z3 = acc[i][3] + bv.w;
        z0 += (z0 == 0.f) ? EPS : 0.f;
        z1 += (z1 == 0.f) ? EPS : 0.f;
        z2 += (z2 == 0.f) ? EPS : 0.f;
        z3 += (z3 == 0.f) ? EPS : 0.f;
        o = make_float4(e.x / z0, e.y / z1, e.z / z2, e.w / z3);
      } else {
        o = make_float4(e.x * acc[i][0], e.y * acc[i][1], e.z * acc[i][2], e.w * acc[i][3]);
      }
      *reinterpret_cast<float4*>(on + off) = o;
    }
  }
}

}  // namespace

extern "C" int conv3x3_fused_f32(const float* x, const float* ew, const float* taps,
                                 const float* bias, float* out, int N, int Nc, int Ne, int H,
                                 int W, int Cin, int Cout, int divide, void* stream) {
  const int64_t tiles = (int64_t)((H + TH - 1) / TH) * ((W + TW - 1) / TW);
  if (tiles > 2147483647LL || Nc > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)tiles, (Cout + TC - 1) / TC, Nc);
  conv3x3_fused_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(x, ew, taps, bias, out, N, Nc, Ne,
                                                              H, W, Cin, Cout, divide);
  return (int)cudaGetLastError();
}
