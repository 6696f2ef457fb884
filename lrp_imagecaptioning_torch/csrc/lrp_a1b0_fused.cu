// The alpha1beta0 conv-LRP rule for a post-ReLU 3x3 SAME stride-1 conv in
// one launch, bf16 storage, bf16 tensor-core products and f32 accumulation:
//     s   = bf16(r / safe(z)),  safe(z) = z + (z == 0) * 1e-7   (f32 divide)
//     out = bf16(x * sum over taps and Cout of s * flip(W+))
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
// shared by the N words; kp: W+, (3, 3, Cin, Cout) HWIO as the conv takes it;
// out: (N, H, W, Cin). All bf16, NHWC. The transposed conv is a SAME conv
// over s with W+ flipped in both spatial axes: tap t = 3 dy + dx multiplies
// s at pixel (h + dy - 1, w + dx - 1) by the (Cin, Cout) matrix kp[8 - t],
// Cout contiguous, so the kernel reads W+ as it lies, with no flipped copy.
// Cout % 8 == 0 and Cin % 4 == 0 (16-byte r/z/tap loads, bf16-pair x loads;
// the wrapper checks them and the alignment).
//
// Bound on the H100: the 2*N*H*W*9*Cin*Cout FLOP against the bf16
// tensor-core peak bound it at every VGG layer; at 224^2 (Cout = 64, K = 576)
// the bytes, 2*N*H*W*(Cin + Cout), take about as long.
//
// Design: an implicit GEMM on mma.sync.m16n8k16 (bf16 in, f32 accumulate).
// GEMM rows are (word, pixel), columns Cin, depth 9 * Cout.
// - Block tile: one word x an 8x16 pixel tile (128 rows) x BN = 64 (Cin <= 64,
//   4 warps) or 128 (8 warps) channels of Cin. Warp (wm, wn) owns tile rows
//   2wm, 2wm + 1 (two m16 fragments: a fragment is one 16-pixel tile row) x
//   64 channels (eight n8 fragments): 64 f32 accumulators a thread. Words are
//   innermost in the launch order (grid.x = word x Cin tile, grid.y = pixel
//   tile), so the z, x and taps that all words share come from L2.
// - K loop: Cout in chunks of CK = 16 (BN = 64) or 32 (BN = 128) channels,
//   one or two k16 steps, and inside each chunk the 9 taps. Per chunk the
//   block forms s for the halo'd 10x18 tile from 16-byte loads of r and z
//   (divide in f32, round once to bf16, 0 outside the image and past Cout)
//   and stores it in shared memory as bf16 with a pixel pitch of CK + 8 bf16
//   (48 or 80 bytes), so that the 8 rows of an ldmatrix fall in distinct
//   banks. The chunk's 9 x BN x CK taps (Cout contiguous: the "col" operand
//   of mma.row.col as W+ lies in memory) go in by 16-byte cp.async,
//   zero-filled past Cin and Cout, at the same pitch.
// - A fragments: ldmatrix.x4 with one row address per lane, the halo pixel
//   (prow + dy, pcol + dx) of the current tap: the shifted read of the
//   implicit GEMM is an address change per tap, with no im2col copy.
//   B fragments: ldmatrix.x4 of two n8 fragments from the tap rows.
// - Pipeline: two stages. While chunk c's mma run, chunk c+1's taps are in
//   flight by cp.async, and its s is formed between the taps: each thread's
//   3 groups of 8 channels (360 or 720 groups over 128 or 256 threads) are
//   loaded and, two taps later, divided and stored into the other stage, so
//   the divides overlap the tensor cores and one group's registers are live
//   at a time. The 8 divides of a group take div_rn_fast_group
//   (div_rn.cuh): exactly `r / z`, without a branch per divide. One
//   __syncthreads ends the chunk.
// - Shared memory: a stage is 180 x (CK + 8) (s) + 9 x BN x (CK + 8) (taps)
//   bf16, so two stages take 72 576 bytes at BN = 64 and 213 120 at BN = 128
//   (dynamic, above the 48 KB default; the launcher raises the limit once).
//   CK = 32 at BN = 128 halves the syncs against CK = 16 (127 872 bytes):
//   one block of 8 warps is resident per SM either way, for its registers.
// - ptxas (sm_90a): 214 registers at BN = 64 (2 blocks of 4 warps an SM by
//   registers), 251 at BN = 128 (1 block of 8 warps), no spills; the k16-step
//   loop stays rolled, as unrolled the 8-warp tile spills.
// - Epilogue: the f32 accumulators times x (bf16 pairs: a fragment holds 2
//   adjacent channels), rounded once to bf16; pixels past H and W (14^2 and
//   28^2 fill 16-wide tiles partly) and channels past Cin are masked.
// Why mma.sync and not wgmma: A is a gather of shifted halo rows, which
// ldmatrix addresses per lane as it is; wgmma wants A in a canonical
// swizzled shared-memory layout or in its own register layout. wgmma with
// TMA for the taps is the next step for this kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "div_rn.cuh"

namespace {

constexpr int TH = 8;                        // tile rows
constexpr int TW = 16;                       // tile cols: one m16 fragment
constexpr int HW2 = TW + 2;                  // halo'd tile width
constexpr int HALO = (TH + 2) * HW2;         // 180 halo pixels
constexpr float EPS = 1e-7f;                 // SafeDivide's factor, K.epsilon()

template <int WN>  // warps along Cin: BN = 64 * WN
struct Cfg {
  static constexpr int BN = 64 * WN;
  static constexpr int NT = 128 * WN;                        // 4 warps along rows
  static constexpr int CK = 16 * WN;                         // Cout channels a stage
  static constexpr int PITCH = CK + 8;                       // bf16 per pixel / tap row
  static constexpr int G = CK / 8;                           // 16-byte groups per row
  static constexpr int S_ELEMS = HALO * PITCH;
  static constexpr int STAGE = S_ELEMS + 9 * BN * PITCH;     // bf16 per stage
  static constexpr int SMEM = 2 * STAGE * 2;                 // bytes, two stages
  static constexpr int RZ_ITEMS = (G * HALO + NT - 1) / NT;  // r/z groups a thread
  static constexpr int TAP_ITEMS = 9 * BN * G / NT;          // tap groups a thread
  static_assert(TAP_ITEMS * NT == 9 * BN * G, "tap groups");
  static_assert(PITCH * 2 % 16 == 0, "ldmatrix rows must be 16-byte aligned");
};

__device__ __forceinline__ float lo_bf16(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float hi_bf16(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

__device__ __forceinline__ uint32_t pack_bf16x2(float a, float b) {
  __nv_bfloat162 v = __floats2bfloat162_rn(a, b);  // .x = a at the lower address
  return *reinterpret_cast<uint32_t*>(&v);
}

// s for 8 channels of r and z (16 bytes each): r / safe(z) divided in f32
// and rounded once to bf16
__device__ __forceinline__ uint4 s_of8(uint4 r, uint4 z) {
  const uint32_t rw[4] = {r.x, r.y, r.z, r.w};
  const uint32_t zw[4] = {z.x, z.y, z.z, z.w};
  float a[8], b[8], q[8];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    a[2 * j] = lo_bf16(rw[j]);
    a[2 * j + 1] = hi_bf16(rw[j]);
    b[2 * j] = lo_bf16(zw[j]);
    b[2 * j + 1] = hi_bf16(zw[j]);
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) b[k] += (b[k] == 0.f) ? EPS : 0.f;
  if (!div_rn_fast_group(a, b, q)) {
#pragma unroll
    for (int k = 0; k < 8; ++k) q[k] = a[k] / b[k];
  }
  return make_uint4(pack_bf16x2(q[0], q[1]), pack_bf16x2(q[2], q[3]), pack_bf16x2(q[4], q[5]),
                    pack_bf16x2(q[6], q[7]));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&d)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

template <int WN>
__global__ void __launch_bounds__(Cfg<WN>::NT, 1)
lrp_a1b0_fused_kernel(const __nv_bfloat16* __restrict__ r, const __nv_bfloat16* __restrict__ z,
                      const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ kp,
                      __nv_bfloat16* __restrict__ out, int H, int W, int Cin, int Cout,
                      int ci_tiles) {
  using C = Cfg<WN>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* const smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  // stage b: s at smem + b * STAGE (HALO x PITCH), taps after it (9 * BN x PITCH)

  const int n = blockIdx.x / ci_tiles;
  const int ci0 = (blockIdx.x % ci_tiles) * C::BN;
  const int tiles_w = (W + TW - 1) / TW;
  const int th0 = (blockIdx.y / tiles_w) * TH;
  const int tw0 = (blockIdx.y % tiles_w) * TW;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wm = (tid >> 5) & 3;   // tile rows 2wm, 2wm + 1
  const int wn = tid >> 7;         // Cin columns wn*64 .. +63 of the block's BN
  const __nv_bfloat16* const rn = r + (int64_t)n * H * W * Cout;

  // r and z of this thread's item i of a chunk (16 bytes each), loaded and
  // turned into s a few taps apart during the chunk before
  uint4 rv, zv;
  auto load_rz = [&](int c0, int i) {
    const int e = tid + i * C::NT;   // (halo pixel, 8-channel group)
    const int p = e / C::G;
    const int gh = th0 - 1 + p / HW2;
    const int gw = tw0 - 1 + p % HW2;
    const int co = c0 + (e % C::G) * 8;
    rv = zv = make_uint4(0u, 0u, 0u, 0u);   // r = z = 0 gives s = 0
    if (e < C::G * HALO && gh >= 0 && gh < H && gw >= 0 && gw < W && co < Cout) {
      const int64_t off = ((int64_t)gh * W + gw) * Cout + co;
      rv = __ldg(reinterpret_cast<const uint4*>(rn + off));
      zv = __ldg(reinterpret_cast<const uint4*>(z + off));
    }
  };
  auto store_s = [&](__nv_bfloat16* s_buf, int i) {   // this thread's item i
    const int e = tid + i * C::NT;
    if (e < C::G * HALO)
      *reinterpret_cast<uint4*>(s_buf + (e / C::G) * C::PITCH + (e % C::G) * 8) =
          s_of8(rv, zv);
  };
  auto load_taps = [&](__nv_bfloat16* t_buf, int c0) {
#pragma unroll
    for (int i = 0; i < C::TAP_ITEMS; ++i) {
      const int e = tid + i * C::NT;   // (tap row = tap * BN + ci, 8-channel group)
      const int row = e / C::G;
      const int tap = row / C::BN;
      const int gci = ci0 + row % C::BN;
      const int co = c0 + (e % C::G) * 8;
      const bool valid = gci < Cin && co < Cout;
      // tap t of the transposed conv is W+'s tap 8 - t: the spatial flip
      const __nv_bfloat16* src =
          valid ? kp + ((int64_t)(8 - tap) * Cin + gci) * Cout + co : kp;
      cp_async16(smem_u32(t_buf + row * C::PITCH + (e % C::G) * 8), src, valid);
    }
  };

  float acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][j][q] = 0.f;

  // per-lane ldmatrix rows, in bf16 elements from the stage's base:
  // A: tile row 2wm, pixel col lane & 15, k half lane >> 4 (tap (0, 0))
  const int a_lane = ((2 * wm) * HW2 + (lane & 15)) * C::PITCH + (lane >> 4) * 8;
  // B: Cin row wn*64 + (lane & 7) + 8 * (lane >> 4), k half (lane >> 3) & 1
  const int b_lane =
      (wn * 64 + (lane & 7) + ((lane >> 4) << 3)) * C::PITCH + ((lane >> 3) & 1) * 8;

  const int nchunks = (Cout + C::CK - 1) / C::CK;
  load_taps(smem + C::S_ELEMS, 0);
  cp_async_commit();
#pragma unroll
  for (int i = 0; i < C::RZ_ITEMS; ++i) {
    load_rz(0, i);
    store_s(smem, i);
  }
  cp_async_wait_all();
  __syncthreads();

  for (int c = 0; c < nchunks; ++c) {
    __nv_bfloat16* const cur = smem + (c & 1) * C::STAGE;
    __nv_bfloat16* const nxt = smem + ((c + 1) & 1) * C::STAGE;
    const bool more = c + 1 < nchunks;
    if (more) {
      load_taps(nxt + C::S_ELEMS, (c + 1) * C::CK);
      cp_async_commit();
    }
    const uint32_t s_base = smem_u32(cur) + 2 * a_lane;
    const uint32_t t_base = smem_u32(cur + C::S_ELEMS) + 2 * b_lane;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        // the chunk's k16 steps (rolled: see the header)
#pragma unroll 1
        for (int ks = 0; ks < C::CK / 16; ++ks) {
          uint32_t a[2][4];
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
            ldmatrix_x4(s_base + 2 * (((mi + dy) * HW2 + dx) * C::PITCH + ks * 16), a[mi]);
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            uint32_t b[4];   // n8 fragments 2jj (b[0], b[1]) and 2jj + 1 (b[2], b[3])
            ldmatrix_x4(t_base + 2 * (((dy * 3 + dx) * C::BN + jj * 16) * C::PITCH + ks * 16),
                        b);
#pragma unroll
            for (int mi = 0; mi < 2; ++mi) {
              mma_bf16(acc[mi][2 * jj], a[mi], b[0], b[1]);
              mma_bf16(acc[mi][2 * jj + 1], a[mi], b[2], b[3]);
            }
          }
        }
        // the next chunk's s: item i is loaded after tap 9i / RZ_ITEMS and
        // formed after tap 9(i + 1) / RZ_ITEMS - 1, so the loads have taps to
        // arrive in, the divides overlap the tensor cores' work, and one
        // item's registers are live at a time
#pragma unroll
        for (int i = 0; i < C::RZ_ITEMS; ++i) {
          const int t = dy * 3 + dx;
          if (more && t == 9 * i / C::RZ_ITEMS) load_rz((c + 1) * C::CK, i);
          if (more && t == 9 * (i + 1) / C::RZ_ITEMS - 1) store_s(nxt, i);
        }
      }
    }
    cp_async_wait_all();
    __syncthreads();
  }

  // accumulator (mi, j): rows g and g + 8 of the fragment are tile cols g,
  // g + 8 of tile row 2wm + mi; columns 2 * (lane & 3) + {0, 1} of n8 block j
  const int g = lane >> 2;
  __nv_bfloat16* const on = out + (int64_t)n * H * W * Cin;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    const int gh = th0 + 2 * wm + mi;
    if (gh >= H) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int gw = tw0 + g + half * 8;
      if (gw >= W) continue;
      const int64_t pix = ((int64_t)gh * W + gw) * Cin;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int ci = ci0 + wn * 64 + j * 8 + 2 * (lane & 3);
        if (ci >= Cin) continue;
        const uint32_t xv = *reinterpret_cast<const uint32_t*>(x + pix + ci);
        *reinterpret_cast<uint32_t*>(on + pix + ci) = pack_bf16x2(
            lo_bf16(xv) * acc[mi][j][2 * half], hi_bf16(xv) * acc[mi][j][2 * half + 1]);
      }
    }
  }
}

template <int WN>
int launch(const void* r, const void* z, const void* x, const void* kp, void* out, int N, int H,
           int W, int Cin, int Cout, cudaStream_t stream) {
  using C = Cfg<WN>;
  // above 48 KB of dynamic shared memory a launch is refused unless allowed
  static const cudaError_t attr = cudaFuncSetAttribute(
      lrp_a1b0_fused_kernel<WN>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  const int ci_tiles = (Cin + C::BN - 1) / C::BN;
  const int64_t words_x_tiles = (int64_t)N * ci_tiles;
  const int64_t tiles = (int64_t)((H + TH - 1) / TH) * ((W + TW - 1) / TW);
  if (words_x_tiles > 2147483647LL || tiles > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)words_x_tiles, (unsigned)tiles);
  lrp_a1b0_fused_kernel<WN><<<grid, C::NT, C::SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(r), static_cast<const __nv_bfloat16*>(z),
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(kp),
      static_cast<__nv_bfloat16*>(out), H, W, Cin, Cout, ci_tiles);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int lrp_a1b0_fused_bf16(const void* r, const void* z, const void* x, const void* kp,
                                   void* out, int N, int H, int W, int Cin, int Cout,
                                   void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0 || Cout % 8 || Cin % 4)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return Cin <= 64 ? launch<1>(r, z, x, kp, out, N, H, W, Cin, Cout, s)
                   : launch<2>(r, z, x, kp, out, N, H, W, Cin, Cout, s);
}

// dynamic shared memory of the launch that a layer with Cin channels takes
extern "C" int lrp_a1b0_fused_smem_bytes(int Cin) {
  return Cin <= 64 ? Cfg<1>::SMEM : Cfg<2>::SMEM;
}
