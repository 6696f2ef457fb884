// 3x3 SAME stride-1 conv in NHWC with a fused elementwise epilogue, f32 in
// and out:
//     divide:    out = ew / safe(conv(x, W) + b),  safe(z) = z + (z == 0) * 1e-7
//     multiply:  out = ew * conv(x, W)
//
// Replaces lrp_imagecaptioning_tpu/ops/pallas_conv_lrp.py:_conv3x3_kernel.
// x: (Nc, H, W, Cin); ew: (Ne, H, W, Cout); taps: (3, 3, Cin, Cout) HWIO;
// out: (N, H, W, Cout) with N = max(Nc, Ne) and Nc, Ne each 1 or N. A
// batch-1 conv input (the divide pass: x shared by every word seed) is
// convolved ONCE per tile and the epilogue writes all N quotients, so z is
// never recomputed per word and never stored.
//
// Bound on the H100: operations, 2*H*W*9*Cin*Cout FLOP per conv image
// against 4*(Cin + 2*Cout) bytes per pixel. The function is f32; on the
// CUDA cores its least time is FLOP / 67 TFLOP/s.
//
// Design: an implicit GEMM on the tensor cores in 3xTF32, which keeps f32
// accuracy at 495 / 3 = 165 TFLOP/s of f32 products.
// - 3xTF32: each operand v splits into hi = tf32(v) and lo = tf32(v - hi)
//   (cvt.rna), and each product is lo*hi + hi*lo + hi*hi, small terms first,
//   by mma.sync.m16n8k8 tf32 with f32 accumulators; lo*lo (2^-22 of the
//   product) is dropped. The tensor cores' own f32 additions round toward
//   zero: summed into one register set per 16-channel chunk, those
//   truncations left the kernel up to 1.9x as far from an f64 conv as
//   cuDNN's f32 one where z cancels (signed taps). So each tap's 16 channels
//   (6 MMAs, the first with a zero accumulator) sum into fresh registers,
//   added to the running sum by round-to-nearest adds: a truncation costs
//   at most an ulp of one tap's partial sum, and the kernel came within
//   0.5x cuDNN's distance from f64 (H100, the card test's signed taps).
// - GEMM rows are (conv image, pixel) over a TH x 16 pixel tile; a m16
//   fragment is one 16-pixel tile row. Columns are Cout, depth 9 taps x Cin.
//   Warp wm owns tile rows 2wm, 2wm + 1 (two m16 fragments) x the block's BN
//   = 8 * NF columns (NF n8 fragments): 2 * NF * 4 accumulators a thread.
// - The A operand is a shifted read of the halo'd (TH + 2) x 18 input tile
//   in shared memory: a tap is an address change, with no im2col. Inside a
//   k8 step the GEMM's k order is permuted (logical k = t, t + 4 is channel
//   2t, 2t + 1 of the step, for both operands), so a lane's two A values of
//   a row are one 8-byte load. Pixel pitch CK + 8 = 24 floats: the 8-byte
//   loads of a half-warp fall in distinct banks.
// - B is W as it lies (HWIO, Cout contiguous): the "col" operand. Tap row
//   pitch BN + 4 floats: the lanes' scalar loads (rows 2t, 2t + 1, column g)
//   fall in distinct banks.
// - Both come by 16-byte cp.async, zero-filled outside the image and past
//   Cin and Cout, into a two-stage ring: chunk c + 1's copy (CK = 16 Cin
//   channels: the halo tile and 9 x 16 x BN taps) is in flight while chunk
//   c's MMAs run. One __syncthreads ends a chunk.
// - Two tiles, chosen by the launcher: TH = 8, BN = 64 (4 warps, 112 896
//   bytes of dynamic shared memory: two blocks an SM), and where that grid
//   is less than one wave (the divide pass at 28^2 and 14^2: 64 and 16
//   blocks) TH = 4, BN = 32 (2 warps, 62 208 bytes), four times the blocks.
//   Both take more than 48 KB: the launcher raises the limit once.
// - ptxas (sm_90a): 165 registers (big tile) and 112 (small), no spills.
//   The copy loops and the tap loop stay rolled: unrolled, their hoisted
//   addresses took the kernel to 255 registers and spills.
// - Epilogue: a lane holds 2 adjacent channels at 2 pixels of each
//   fragment: 8-byte loads of ew and b and stores of out. The divides take
//   div_rn_fast_group (div_rn.cuh), exactly `ew / z` without a branch per
//   divide. Pixels past H and W and channels past Cout are masked.
// Cin % 4 == 0 and Cout % 4 == 0, with 16-byte-aligned bases (cp.async and
// the 8-byte epilogue); the wrapper checks them.

#include <cuda_runtime.h>
#include <stdint.h>

#include "div_rn.cuh"

namespace {

constexpr int TW = 16;          // tile cols: one m16 fragment
constexpr int HW2 = TW + 2;     // halo'd tile width
constexpr int CK = 16;          // Cin channels a stage: two k8 steps
constexpr int PA = CK + 8;      // floats per halo pixel
constexpr float EPS = 1e-7f;    // SafeDivide's factor, K.epsilon()

template <int WM, int NF>  // warps along rows, n8 fragments a warp
struct Cfg {
  static constexpr int TH = 2 * WM;
  static constexpr int BN = 8 * NF;
  static constexpr int NT = 32 * WM;
  static constexpr int PB = BN + 4;
  static constexpr int HALO = (TH + 2) * HW2;
  static constexpr int A_ELEMS = HALO * PA;
  static constexpr int STAGE = A_ELEMS + 9 * CK * PB;        // floats
  static constexpr int SMEM = 2 * STAGE * 4;                 // bytes, two stages
  static constexpr int A_GROUPS = HALO * (CK / 4);           // 16-byte groups
  static constexpr int A_ITEMS = (A_GROUPS + NT - 1) / NT;
  static constexpr int B_GROUPS = 9 * CK * (BN / 4);
  static constexpr int B_ITEMS = B_GROUPS / NT;
  static_assert(B_ITEMS * NT == B_GROUPS, "tap groups");
  static_assert(PA * 4 % 16 == 0 && PB * 4 % 16 == 0, "cp.async rows must be 16-byte aligned");
};
using Big = Cfg<4, 8>;
using Small = Cfg<2, 4>;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, or 16 zero bytes when !valid
__device__ __forceinline__ void cp_async16(uint32_t saddr, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(saddr), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

// v = hi + lo to 2^-22 of v, both exact tf32 values
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32(v);
  lo = tf32(v - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a * b with a zero accumulator in
__device__ __forceinline__ void mma_tf32_zero(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                              uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
}

template <int WM, int NF>
__global__ void __launch_bounds__(Cfg<WM, NF>::NT)
conv3x3_fused_kernel(const float* __restrict__ x, const float* __restrict__ ew,
                     const float* __restrict__ taps, const float* __restrict__ bias,
                     float* __restrict__ out, int N, int Nc, int Ne, int H, int W, int Cin,
                     int Cout, int divide) {
  using C = Cfg<WM, NF>;
  extern __shared__ __align__(16) float smem[];
  // stage s: the halo tile at smem + s * STAGE (HALO x PA), taps after it
  // (9 * CK rows of PB: row tap * CK + k holds Cout co0 .. co0 + BN - 1)

  const int tiles_w = (W + TW - 1) / TW;
  const int th0 = (blockIdx.x / tiles_w) * C::TH;
  const int tw0 = (blockIdx.x % tiles_w) * TW;
  const int co0 = blockIdx.y * C::BN;
  const int nc = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wm = tid >> 5;
  const int g = lane >> 2;   // fragment row (pixel col) / B column
  const int t = lane & 3;    // k pair 2t, 2t + 1 / accumulator columns 2t, 2t + 1
  const float* const xn = x + (int64_t)nc * H * W * Cin;

  auto load_chunk = [&](float* stage, int c0) {
#pragma unroll 1
    for (int i = 0; i < C::A_ITEMS; ++i) {
      const int e = tid + i * C::NT;   // (halo pixel, 4-channel group)
      if (e < C::A_GROUPS) {
        const int p = e / (CK / 4);
        const int q = (e % (CK / 4)) * 4;
        const int gh = th0 - 1 + p / HW2;
        const int gw = tw0 - 1 + p % HW2;
        const bool valid = gh >= 0 && gh < H && gw >= 0 && gw < W && c0 + q < Cin;
        const float* src = valid ? xn + ((int64_t)gh * W + gw) * Cin + c0 + q : x;
        cp_async16(smem_u32(stage + p * PA + q), src, valid);
      }
    }
    float* const bs = stage + C::A_ELEMS;
#pragma unroll 1
    for (int i = 0; i < C::B_ITEMS; ++i) {
      const int e = tid + i * C::NT;   // (tap row, 4-channel group of Cout)
      const int row = e / (C::BN / 4);
      const int q = (e % (C::BN / 4)) * 4;
      const int ci = c0 + row % CK;
      const bool valid = ci < Cin && co0 + q < Cout;
      const float* src = valid ? taps + ((int64_t)(row / CK) * Cin + ci) * Cout + co0 + q : taps;
      cp_async16(smem_u32(bs + row * C::PB + q), src, valid);
    }
  };

  float acc[2][NF][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][j][r] = 0.f;

  // per-lane offsets from a stage's base: A at tile row 2wm, pixel col g,
  // tap (0, 0), channel 2t; B at tap row 2t, column g
  const int a_lane = ((2 * wm) * HW2 + g) * PA + 2 * t;
  const int b_lane = C::A_ELEMS + (2 * t) * C::PB + g;

  const int nchunks = (Cin + CK - 1) / CK;
  load_chunk(smem, 0);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  for (int c = 0; c < nchunks; ++c) {
    const float* const cur = smem + (c & 1) * C::STAGE;
    if (c + 1 < nchunks) {
      load_chunk(smem + ((c + 1) & 1) * C::STAGE, (c + 1) * CK);
      cp_async_commit();
    }
    const float* const as = cur + a_lane;
    const float* const bs = cur + b_lane;
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      float part[2][NF][4];   // this tap's sum (see the header)
#pragma unroll
      for (int ks = 0; ks < CK / 8; ++ks) {
        uint32_t ahi[2][4], alo[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const float* ap = as + ((mi + dy) * HW2 + dx) * PA + ks * 8;
          const float2 v0 = *reinterpret_cast<const float2*>(ap);            // row g
          const float2 v1 = *reinterpret_cast<const float2*>(ap + 8 * PA);   // row g + 8
          split(v0.x, ahi[mi][0], alo[mi][0]);
          split(v1.x, ahi[mi][1], alo[mi][1]);
          split(v0.y, ahi[mi][2], alo[mi][2]);
          split(v1.y, ahi[mi][3], alo[mi][3]);
        }
#pragma unroll
        for (int j = 0; j < NF; ++j) {
          const float* bp = bs + (tap * CK + ks * 8) * C::PB + j * 8;
          uint32_t b0h, b0l, b1h, b1l;
          split(bp[0], b0h, b0l);        // k row 2t
          split(bp[C::PB], b1h, b1l);    // k row 2t + 1
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            if (ks == 0)
              mma_tf32_zero(part[mi][j], alo[mi], b0h, b1h);
            else
              mma_tf32(part[mi][j], alo[mi], b0h, b1h);
            mma_tf32(part[mi][j], ahi[mi], b0l, b1l);
            mma_tf32(part[mi][j], ahi[mi], b0h, b1h);
          }
        }
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int j = 0; j < NF; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[mi][j][r] += part[mi][j][r];
    }
    cp_async_wait_all();
    __syncthreads();
  }

  // accumulator (mi, j): r = 0, 1 at pixel col g, r = 2, 3 at col g + 8 of
  // tile row 2wm + mi; channels co0 + 8j + 2t + (r & 1)
  if (divide) {
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      const int co = co0 + j * 8 + 2 * t;
      float2 bv = make_float2(0.f, 0.f);
      if (bias != nullptr && co < Cout) bv = *reinterpret_cast<const float2*>(bias + co);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          float z = acc[mi][j][r] + ((r & 1) ? bv.y : bv.x);
          acc[mi][j][r] = z + ((z == 0.f) ? EPS : 0.f);
        }
    }
  }
  const int n_begin = (Nc == N) ? nc : 0;
  const int n_end = (Nc == N) ? nc + 1 : N;
  const int64_t plane = (int64_t)H * W * Cout;
  const bool ok0 = tw0 + g < W, ok1 = tw0 + g + 8 < W;
  for (int n = n_begin; n < n_end; ++n) {
    const float* const ewn = ew + (Ne == 1 ? 0 : (int64_t)n * plane);
    float* const on = out + (int64_t)n * plane;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int gh = th0 + 2 * wm + mi;
      if (gh >= H) continue;
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        const int co = co0 + j * 8 + 2 * t;
        if (co >= Cout) continue;
        const int64_t p0 = ((int64_t)gh * W + tw0 + g) * Cout + co;
        const int64_t p1 = p0 + 8 * (int64_t)Cout;
        const float2 e0 = ok0 ? *reinterpret_cast<const float2*>(ewn + p0) : make_float2(0.f, 0.f);
        const float2 e1 = ok1 ? *reinterpret_cast<const float2*>(ewn + p1) : make_float2(0.f, 0.f);
        const float a[4] = {e0.x, e0.y, e1.x, e1.y};
        float q[4];
        if (divide) {
          if (!div_rn_fast_group(a, acc[mi][j], q)) {
#pragma unroll
            for (int r = 0; r < 4; ++r) q[r] = a[r] / acc[mi][j][r];
          }
        } else {
#pragma unroll
          for (int r = 0; r < 4; ++r) q[r] = a[r] * acc[mi][j][r];
        }
        if (ok0) *reinterpret_cast<float2*>(on + p0) = make_float2(q[0], q[1]);
        if (ok1) *reinterpret_cast<float2*>(on + p1) = make_float2(q[2], q[3]);
      }
    }
  }
}

template <int WM, int NF>
int64_t grid_blocks(int Nc, int H, int W, int Cout) {
  using C = Cfg<WM, NF>;
  return (int64_t)((H + C::TH - 1) / C::TH) * ((W + TW - 1) / TW) * ((Cout + C::BN - 1) / C::BN) *
         Nc;
}

template <int WM, int NF>
int launch(const float* x, const float* ew, const float* taps, const float* bias, float* out,
           int N, int Nc, int Ne, int H, int W, int Cin, int Cout, int divide, cudaStream_t s) {
  using C = Cfg<WM, NF>;
  // above 48 KB of dynamic shared memory a launch is refused unless allowed
  static const cudaError_t attr = cudaFuncSetAttribute(
      conv3x3_fused_kernel<WM, NF>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  const int64_t tiles = (int64_t)((H + C::TH - 1) / C::TH) * ((W + TW - 1) / TW);
  const int co_tiles = (Cout + C::BN - 1) / C::BN;
  if (tiles > 2147483647LL || co_tiles > 65535 || Nc > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)tiles, co_tiles, Nc);
  conv3x3_fused_kernel<WM, NF><<<grid, C::NT, C::SMEM, s>>>(x, ew, taps, bias, out, N, Nc, Ne, H,
                                                            W, Cin, Cout, divide);
  return (int)cudaGetLastError();
}

int sm_count() {
  static int sms = [] {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n > 0 ? n : 132;
  }();
  return sms;
}

}  // namespace

extern "C" int conv3x3_fused_f32(const float* x, const float* ew, const float* taps,
                                 const float* bias, float* out, int N, int Nc, int Ne, int H,
                                 int W, int Cin, int Cout, int divide, void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0 || Cin % 4 || Cout % 4)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the small tile where the big one leaves SMs idle (less than one wave)
  if (grid_blocks<4, 8>(Nc, H, W, Cout) < sm_count())
    return launch<2, 4>(x, ew, taps, bias, out, N, Nc, Ne, H, W, Cin, Cout, divide, s);
  return launch<4, 8>(x, ew, taps, bias, out, N, Nc, Ne, H, W, Cin, Cout, divide, s);
}

// dynamic shared memory (bytes) of the big (small = 0) or the small tile
extern "C" int conv3x3_fused_smem_bytes(int small) { return small ? Small::SMEM : Big::SMEM; }
