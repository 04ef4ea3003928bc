// The depth decoder's 3x3 convolutions (stride 1, zero padding 1, NCHW
// float32) for Hopper (sm_90a) as an implicit GEMM on the FP32 cores.
// Built with nvcc into a shared library with a plain C interface and
// loaded through ctypes by google_nerf_tpu_torch/ops/cuda/conv3x3.py,
// which plans the launches (tiles, the split over K, the workspaces) and
// holds the plain PyTorch version (ops/conv3x3.py) they are tested
// against.  depth/decoder.Conv3x3 calls them for CUDA tensors when no
// gradient is recorded.
//
// What they replace.  No TPU kernel: the JAX package leaves its
// convolutions to XLA.  On the card cuDNN ran the decoder's dense 3x3s in
// f32 (TF32 off) with its FFT-tiled algorithm, a complex f32 GEMM on 8
// streams with an ~18 GiB workspace, at 12% of the f32 peak.
//
// The product.  out[b, n, y, x] = bias[n] + sum over c, ky, kx of
// w[n, c, ky, kx] * in[b, c, y + ky - 1, x + kx - 1], the input zero
// outside the map.  As a GEMM: M = B * H * W output pixels, N = Cout,
// K = 9 * Cin, with K ordered tap-major (tap = 3 ky + kx, then c), so
// that the BK = 16 channels of one step share one tap, and so one pixel
// offset and one bounds test a thread.  Every multiply-add is one
// __fmaf_rn (nvcc builds with --fmad=false, which would split a*b+c):
// each output is a direct f32 sum of its 9 Cin products, in the order
// of K, with no TF32, FFT or Winograd.
//
// What bounds it on the H100.  The operations: 2 M N K flops against
// 67 TFLOP/s in f32 (the decoder's 1.587 TFLOP a frame, 23.7 ms).  Its
// bytes (the input, the weights and the output once) are 4-30 MB a
// call, well under the operations' time at 3.35 TB/s.
//
// What the design does about it.
//   * conv3x3_gemm: a block of 256 threads computes a 128 x 128 tile of
//     (pixels, channels), each thread an 8 x 8 register tile (two 4-wide
//     strips in each direction, so its shared-memory reads are float4s
//     without bank conflicts), stepping over K 16 at a time from a
//     3-stage ring of cp.async copies (48 KB): the A tile (16 channels x
//     128 pixels at one tap) by 4-byte copies whose zero fill makes the
//     halo, pixels contiguous along W so a warp's copies coalesce; the B
//     tile (16 x 128 of the packed weights) by 16-byte copies.  A step
//     of 16 ran the decoder's 3x3s 4.8% faster than one of 8 (4 stages
//     or 3) on an H100; 2 stages of 16 as fast as 3.  The
//     channel tile varies fastest over the grid, so the blocks that
//     share a pixel tile run together and read it from L2.
//   * conv3x3_pack: the weights, (Cout, Cin, 3, 3), repacked each call
//     into (9, Cp, Np), K-major with channels contiguous and zero past
//     Cin and Cout (Cp a multiple of 32, Np of 128), by a shared-memory
//     transpose: in the GEMM's B loads every 16 bytes are used.  Packed
//     on the stream each call, so a replayed CUDA graph reads the
//     weights as they are then.
//   * A split over K for maps too small to fill the 132 SMs (14^2 and
//     28^2 at a minibatch of 5): split s writes its partial sums to its
//     own slice of a workspace, and conv3x3_reduce adds the slices in
//     order and the bias.  No atomics, so every launch sums alike.
//   * conv3x3_cout1: Cout = 1 (the AO head's last convolution), a
//     thread an output pixel, summing its Cin x 9 products (c outer, the
//     taps inner) with the weights read as warp-uniform loads, instead
//     of a 128-wide channel tile that would be all but empty.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128, BN = 128, BK = 16, STAGES = 3, NT = 256;
constexpr int PACK_C = 32, PACK_N = 32;      // conv3x3_pack's tile

struct Gemm {
  const float* x;      // (B, C, H, W)
  const float* wt;     // (9, Cp, Np) packed
  const float* bias;   // (N) or null (the split's partial sums)
  float* out;          // (splits, B, N, H, W)
  int B, C, H, W, N, Cp, Np;
  int M;               // B H W
  int cblocks;         // ceil(C / BK): K steps a tap
  int per_split;       // K steps a split
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__global__ void __launch_bounds__(NT, 2) conv3x3_gemm(Gemm g) {
  __shared__ __align__(16) float As[STAGES][BK][BM];
  __shared__ __align__(16) float Bs[STAGES][BK][BN];

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int split = blockIdx.z;
  const int total = 9 * g.cblocks;
  const int s0 = split * g.per_split;
  const int steps = min(g.per_split, total - s0);
  const int64_t HW = (int64_t)g.H * g.W;

  // this thread's A copies: pixel m0 + (tid & 127), channels kk, kk + 2,
  // ... of each step
  const int am = m0 + (tid & (BM - 1));
  const int kk = tid >> 7;
  const bool m_ok = am < g.M;
  int ab = 0, ay = 0, ax = 0;
  if (m_ok) {
    ab = am / (int)HW;
    const int yx = am - ab * (int)HW;
    ay = yx / g.W;
    ax = yx - ay * g.W;
  }
  const float* xb = g.x + (int64_t)ab * g.C * HW + (int64_t)ay * g.W + ax;
  // this thread's B copies: rows br, br + 8, ... of the step, columns
  // 4 (tid & 31) on
  const int br = tid >> 5, bc = (tid & 31) * 4;
  const float* wb = g.wt + (int64_t)br * g.Np + n0 + bc;

  // the next step to load, as (tap, channel block)
  int ld_tap = s0 / g.cblocks, ld_cb = s0 - ld_tap * g.cblocks;
  int64_t ld_off = 0;
  bool ld_ok = false;
  auto set_tap = [&](int tap) {
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    ld_ok = m_ok && (unsigned)(ay + dy) < (unsigned)g.H &&
            (unsigned)(ax + dx) < (unsigned)g.W;
    ld_off = (int64_t)dy * g.W + dx;
  };
  set_tap(ld_tap);

  auto load = [&](int slot) {
    const int c0 = ld_cb * BK;
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) {
      const int c = c0 + kk + 2 * j;
      const bool ok = ld_ok && c < g.C;
      const float* src = ok ? xb + (int64_t)c * HW + ld_off : g.x;
      cp_async4(&As[slot][kk + 2 * j][tid & (BM - 1)], src, ok);
    }
#pragma unroll
    for (int r = 0; r < BK; r += NT / 32)
      cp_async16(&Bs[slot][br + r][bc],
                 wb + ((int64_t)ld_tap * g.Cp + c0 + r) * g.Np);
    if (++ld_cb == g.cblocks) {
      ld_cb = 0;
      if (++ld_tap < 9) set_tap(ld_tap);
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) load(s);
    cp_commit();
  }

  // thread tile: warps 2 (pixels) x 4 (channels), lanes 8 x 4
  const int warp = tid >> 5, lane = tid & 31;
  const int tm = (warp & 1) * 8 + (lane & 7);
  const int tn = (warp >> 1) * 4 + (lane >> 3);

  for (int s = 0; s < steps; ++s) {
    cp_wait<STAGES - 2>();
    __syncthreads();
    if (s + STAGES - 1 < steps) load((s + STAGES - 1) % STAGES);
    cp_commit();
    const int slot = s % STAGES;
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[slot][k][tm * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[slot][k][64 + tm * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[slot][k][tn * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Bs[slot][k][64 + tn * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = __fmaf_rn(a[i], b[j], acc[i][j]);
    }
  }
  cp_wait<0>();

  // epilogue: + bias (none for a split's partial sums), NCHW stores
  float* out = g.out + (int64_t)split * g.M * g.N;
  float bias[8];
  int ns[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    ns[j] = n0 + (j < 4 ? tn * 4 + j : 64 + tn * 4 + j - 4);
    bias[j] = (g.bias && ns[j] < g.N) ? g.bias[ns[j]] : 0.f;
  }
  const bool quads = (g.W & 3) == 0;     // 4 pixels of a quad share a row
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int mq = m0 + h * 64 + tm * 4;
    if (quads) {
      if (mq >= g.M) continue;
      const int b = mq / (int)HW;
      const int64_t base = (int64_t)b * g.N * HW + (mq - b * (int)HW);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (ns[j] >= g.N) continue;
        float4 v;
        v.x = acc[h * 4 + 0][j] + bias[j];
        v.y = acc[h * 4 + 1][j] + bias[j];
        v.z = acc[h * 4 + 2][j] + bias[j];
        v.w = acc[h * 4 + 3][j] + bias[j];
        *reinterpret_cast<float4*>(out + base + (int64_t)ns[j] * HW) = v;
      }
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = mq + i;
        if (m >= g.M) continue;
        const int b = m / (int)HW;
        const int64_t base = (int64_t)b * g.N * HW + (m - b * (int)HW);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (ns[j] < g.N) out[base + (int64_t)ns[j] * HW] =
                acc[h * 4 + i][j] + bias[j];
      }
    }
  }
}

// (N, C, 3, 3) -> (9, Cp, Np): a block moves PACK_N output channels x
// PACK_C input channels, all 9 taps, through shared memory; zeros past C
// and N.
__global__ void __launch_bounds__(NT) conv3x3_pack(const float* w, int C,
                                                   int N, int Cp, int Np,
                                                   float* wt) {
  __shared__ float t[PACK_N][PACK_C * 9 + 1];
  const int n0 = blockIdx.x * PACK_N, c0 = blockIdx.y * PACK_C;
  const int64_t K = 9LL * C;
  for (int e = threadIdx.x; e < PACK_N * PACK_C * 9; e += NT) {
    const int r = e / (PACK_C * 9), col = e - r * (PACK_C * 9);
    const int n = n0 + r, c = c0 + col / 9;
    t[r][col] = (n < N && c < C) ? w[n * K + (int64_t)c0 * 9 + col] : 0.f;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < PACK_N * PACK_C * 9; e += NT) {
    const int nl = e & (PACK_N - 1), rest = e / PACK_N;
    const int cl = rest % PACK_C, tap = rest / PACK_C;
    wt[((int64_t)tap * Cp + c0 + cl) * Np + n0 + nl] = t[nl][cl * 9 + tap];
  }
}

// out[e] = sum over s of part[s][e] in order, + bias[n of e]
__global__ void conv3x3_reduce(const float* part, int splits, int64_t size,
                               int64_t HW, int N, const float* bias,
                               float* out) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= size) return;
  float v = part[e];
  for (int s = 1; s < splits; ++s) v += part[(int64_t)s * size + e];
  if (bias) v += bias[(e / HW) % N];
  out[e] = v;
}

// Cout = 1: a thread an output pixel
__global__ void __launch_bounds__(NT) conv3x3_cout1(const float* x,
                                                    const float* w,
                                                    const float* bias, int M,
                                                    int C, int H, int W,
                                                    float* out) {
  const int m = blockIdx.x * NT + threadIdx.x;
  if (m >= M) return;
  const int64_t HW = (int64_t)H * W;
  const int b = m / (int)HW;
  const int yx = m - b * (int)HW, y = yx / W, xx = yx - y * W;
  const float* xb = x + (int64_t)b * C * HW + yx;
  bool ok[9];
  int off[9];
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    const int dy = t / 3 - 1, dx = t % 3 - 1;
    ok[t] = (unsigned)(y + dy) < (unsigned)H && (unsigned)(xx + dx) < (unsigned)W;
    off[t] = dy * W + dx;
  }
  float acc = 0.f;
  for (int c = 0; c < C; ++c) {
    const float* p = xb + (int64_t)c * HW;
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      const float v = ok[t] ? __ldg(p + off[t]) : 0.f;
      acc = __fmaf_rn(v, __ldg(w + c * 9 + t), acc);
    }
  }
  out[m] = bias ? acc + bias[0] : acc;
}

}  // namespace

extern "C" {

const char* conv3x3_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The tile sizes conv3x3.py plans with: BM, BN, BK, PACK_C.
int conv3x3_tiles(int i) {
  const int t[4] = {BM, BN, BK, PACK_C};
  return (i >= 0 && i < 4) ? t[i] : -1;
}

// Repack w (N, C, 3, 3) into wt (9, Cp, Np).
int conv3x3_pack_weights(const float* w, int32_t C, int32_t N, int32_t Cp,
                         int32_t Np, float* wt, void* stream) {
  dim3 grid(Np / PACK_N, Cp / PACK_C);
  conv3x3_pack<<<grid, NT, 0, (cudaStream_t)stream>>>(w, C, N, Cp, Np, wt);
  return (int)cudaGetLastError();
}

// The GEMM over grid (Np / BN, ceil(M / BM), splits), each split
// per_split K steps, writing out (splits == 1: + bias) or the split's
// slice of the workspace (bias null).
int conv3x3_gemm_launch(const float* x, const float* wt, const float* bias,
                        int32_t B, int32_t C, int32_t H, int32_t W,
                        int32_t N, int32_t Cp, int32_t Np, int32_t splits,
                        int32_t per_split, float* out, void* stream) {
  Gemm g;
  g.x = x;
  g.wt = wt;
  g.bias = bias;
  g.out = out;
  g.B = B;
  g.C = C;
  g.H = H;
  g.W = W;
  g.N = N;
  g.Cp = Cp;
  g.Np = Np;
  g.M = B * H * W;
  g.cblocks = (C + BK - 1) / BK;
  g.per_split = per_split;
  dim3 grid(Np / BN, (g.M + BM - 1) / BM, splits);
  conv3x3_gemm<<<grid, NT, 0, (cudaStream_t)stream>>>(g);
  return (int)cudaGetLastError();
}

int conv3x3_reduce_launch(const float* part, int32_t splits, int64_t size,
                          int64_t HW, int32_t N, const float* bias,
                          float* out, void* stream) {
  const int threads = 256;
  const int64_t blocks = (size + threads - 1) / threads;
  conv3x3_reduce<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      part, splits, size, HW, N, bias, out);
  return (int)cudaGetLastError();
}

int conv3x3_cout1_launch(const float* x, const float* w, const float* bias,
                         int32_t B, int32_t C, int32_t H, int32_t W,
                         float* out, void* stream) {
  const int M = B * H * W;
  conv3x3_cout1<<<(M + NT - 1) / NT, NT, 0, (cudaStream_t)stream>>>(
      x, w, bias, M, C, H, W, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
