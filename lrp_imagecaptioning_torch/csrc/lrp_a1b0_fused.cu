// The alpha1beta0 conv-LRP rule for a post-ReLU 3x3 SAME stride-1 conv in
// one launch, bf16 storage and f32 accumulation:
//     s   = bf16(r / safe(z)),  safe(z) = z + (z == 0) * 1e-7   (f32 divide)
//     out = bf16(x * sum over taps and Cout of s * flipT(W+))
//
// Replaces experiments/pallas_block1_v2.py:_kernel (K4, r row-padded in
// device memory) and :_kernel_v3 (K5, r unpadded, halo handled at the
// edges). Both compute this function; here the halo is masked at the image
// edge, so nothing is padded. K4/K5 take eps = 0.01; this kernel takes
// SafeDivide's 1e-7, the rule of the JAX package's main path
// (lrp_imagecaptioning_tpu/ops/lrp_conv.py:140).
//
// r: (N, H, W, Cout), one relevance per word; z: (1, H, W, Cout),
// z = conv(x, W+) + b computed once per image by the caller; x: (1, H, W, Cin),
// shared by the N words; taps: (3, 3, Cout, Cin) = flipT(W+), so that the
// transposed conv is a SAME conv; out: (N, H, W, Cin). All bf16, NHWC.
// Cout % 8 == 0 and Cin % 4 == 0 (vector loads; the wrapper checks them and
// the alignment).
//
// Bound on the H100: against the bf16 tensor-core peak the rule is bound by
// its 2*N*H*W*9*Cin*Cout FLOP at every VGG layer (at 224^2 the bytes,
// 2*N*H*W*(Cin + Cout), take about as long). This first version runs on the
// f32 CUDA cores; the tensor cores (mma.sync / wgmma in bf16) are the
// redesign after it. Design: a block owns an 8x16 pixel tile x 64 output
// channels (of Cin) for one word. For each 8-channel chunk of Cout it loads
// the halo'd 10x18 r and z tile with one 16-byte load of each per pixel,
// forms s in f32, rounds it to bf16 as the plain version does and keeps the
// rounded value in shared memory as f32 (the FMA loop then converts
// nothing); outside the image s is 0, the SAME conv's zero padding. The
// matching 9x8x64 taps are staged beside it, and each of the 256 threads
// accumulates 8 pixels x 4 channels in f32 registers, as
// csrc/conv3x3_fused.cu does. The epilogue multiplies by x and stores 4 bf16
// at once. s never reaches device memory. Words are innermost in the launch
// order (grid.x = word x channel tile, grid.y = pixel tile), so the z, x and
// tap tiles that every word shares come from L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TH = 8;         // tile rows
constexpr int TW = 16;        // tile cols
constexpr int TC = 64;        // output channels (of Cin) per block
constexpr int CK = 8;         // Cout channels per shared-memory stage: one 16-byte load
constexpr int CKP = CK + 1;   // padded pixel pitch: the two half-warps hit different banks
constexpr int NT = 256;
constexpr int PX = 8;         // pixels per thread (one row segment)
constexpr float EPS = 1e-7f;  // SafeDivide's factor, K.epsilon()

__device__ __forceinline__ float lo_bf16(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float hi_bf16(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

__device__ __forceinline__ float s_of(float r, float z) {
  z += (z == 0.f) ? EPS : 0.f;
  return __bfloat162float(__float2bfloat16_rn(r / z));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float a, float b) {
  __nv_bfloat162 v = __floats2bfloat162_rn(a, b);  // .x = a at the lower address
  return *reinterpret_cast<uint32_t*>(&v);
}

__global__ void __launch_bounds__(NT)
lrp_a1b0_fused_kernel(const __nv_bfloat16* __restrict__ r, const __nv_bfloat16* __restrict__ z,
                      const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ taps,
                      __nv_bfloat16* __restrict__ out, int H, int W, int Cin, int Cout,
                      int ci_tiles) {
  __shared__ float ss[(TH + 2) * (TW + 2) * CKP];
  __shared__ __align__(16) float ws[9 * CK * TC];

  const int n = blockIdx.x / ci_tiles;
  const int ci0 = (blockIdx.x % ci_tiles) * TC;
  const int tiles_w = (W + TW - 1) / TW;
  const int th0 = (blockIdx.y / tiles_w) * TH;
  const int tw0 = (blockIdx.y % tiles_w) * TW;
  const int tid = threadIdx.x;
  const int cg = tid & 15;            // channels ci0 + cg*4 .. +3
  const int pg = tid >> 4;            // 0..15
  const int prow = pg >> 1;           // tile row 0..7
  const int pcol0 = (pg & 1) * PX;    // tile cols pcol0 .. pcol0+7

  float acc[PX][4];
#pragma unroll
  for (int i = 0; i < PX; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const __nv_bfloat16* rn = r + (int64_t)n * H * W * Cout;
  for (int c0 = 0; c0 < Cout; c0 += CK) {
    // s = r / safe(z) on the halo'd tile, 0 outside the image
    for (int p = tid; p < (TH + 2) * (TW + 2); p += NT) {
      const int gh = th0 - 1 + p / (TW + 2);
      const int gw = tw0 - 1 + p % (TW + 2);
      float sv[CK];
      if (gh >= 0 && gh < H && gw >= 0 && gw < W) {
        const int64_t off = ((int64_t)gh * W + gw) * Cout + c0;
        const uint4 rv = *reinterpret_cast<const uint4*>(rn + off);
        const uint4 zv = *reinterpret_cast<const uint4*>(z + off);
        const uint32_t rw[4] = {rv.x, rv.y, rv.z, rv.w};
        const uint32_t zw[4] = {zv.x, zv.y, zv.z, zv.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sv[2 * j] = s_of(lo_bf16(rw[j]), lo_bf16(zw[j]));
          sv[2 * j + 1] = s_of(hi_bf16(rw[j]), hi_bf16(zw[j]));
        }
      } else {
#pragma unroll
        for (int k = 0; k < CK; ++k) sv[k] = 0.f;
      }
#pragma unroll
      for (int k = 0; k < CK; ++k) ss[p * CKP + k] = sv[k];
    }
    for (int e = tid; e < 9 * CK * TC; e += NT) {
      const int c = e % TC;
      const int t2 = e / TC;
      const int k = t2 % CK;
      const int tap = t2 / CK;
      const int gci = ci0 + c;
      ws[e] = gci < Cin ? __bfloat162float(taps[((int64_t)tap * Cout + c0 + k) * Cin + gci])
                        : 0.f;
    }
    __syncthreads();
#pragma unroll 2
    for (int k = 0; k < CK; ++k) {
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        float sv[PX + 2];
#pragma unroll
        for (int i = 0; i < PX + 2; ++i)
          sv[i] = ss[((prow + dy) * (TW + 2) + pcol0 + i) * CKP + k];
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float4 wv =
              *reinterpret_cast<const float4*>(&ws[((dy * 3 + dx) * CK + k) * TC + cg * 4]);
#pragma unroll
          for (int i = 0; i < PX; ++i) {
            acc[i][0] = fmaf(sv[i + dx], wv.x, acc[i][0]);
            acc[i][1] = fmaf(sv[i + dx], wv.y, acc[i][1]);
            acc[i][2] = fmaf(sv[i + dx], wv.z, acc[i][2]);
            acc[i][3] = fmaf(sv[i + dx], wv.w, acc[i][3]);
          }
        }
      }
    }
    __syncthreads();
  }

  const int gh = th0 + prow;
  const int gci = ci0 + cg * 4;
  if (gh >= H || gci >= Cin) return;
  __nv_bfloat16* on = out + (int64_t)n * H * W * Cin;
#pragma unroll
  for (int i = 0; i < PX; ++i) {
    const int gw = tw0 + pcol0 + i;
    if (gw >= W) break;
    const int64_t off = ((int64_t)gh * W + gw) * Cin + gci;
    const uint2 xv = *reinterpret_cast<const uint2*>(x + off);
    uint2 o;
    o.x = pack_bf16x2(lo_bf16(xv.x) * acc[i][0], hi_bf16(xv.x) * acc[i][1]);
    o.y = pack_bf16x2(lo_bf16(xv.y) * acc[i][2], hi_bf16(xv.y) * acc[i][3]);
    *reinterpret_cast<uint2*>(on + off) = o;
  }
}

}  // namespace

extern "C" int lrp_a1b0_fused_bf16(const void* r, const void* z, const void* x, const void* taps,
                                   void* out, int N, int H, int W, int Cin, int Cout,
                                   void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || Cout % CK || Cin % 4) return (int)cudaErrorInvalidValue;
  const int ci_tiles = (Cin + TC - 1) / TC;
  const int64_t words_x_tiles = (int64_t)N * ci_tiles;
  const int64_t tiles = (int64_t)((H + TH - 1) / TH) * ((W + TW - 1) / TW);
  if (words_x_tiles > 2147483647LL || tiles > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)words_x_tiles, (unsigned)tiles);
  lrp_a1b0_fused_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(r), static_cast<const __nv_bfloat16*>(z),
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(taps),
      static_cast<__nv_bfloat16*>(out), H, W, Cin, Cout, ci_tiles);
  return (int)cudaGetLastError();
}
