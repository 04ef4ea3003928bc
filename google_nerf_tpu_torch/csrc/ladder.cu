// The construct ladder P5 for Hopper (sm_90a): 17 minimal kernels, each
// one construct that the tile kernels of csrc/brick_field_dense.cu use or
// would use, each writing one (8, 64) f32 block.  Built with nvcc into a
// shared library with a plain C interface and loaded through ctypes by
// google_nerf_tpu_torch/ops/cuda/ladder.py, which also holds each rung's
// plain PyTorch version; google_nerf_tpu_torch/tools/kernel_ladder.py runs
// them.
//
// What it replaces: tools/mosaic_bisect.py (`run` :19-31, rungs k1-k17
// :40-186), a ladder of minimal Pallas kernels that found which construct
// of the transposed tile kernel (google_nerf_tpu/ops/pallas/brick_field.py
// `_kernel_t`) tripped a Mosaic compiler assert.  Each rung here computes
// its JAX rung's (8, 64) result from the same operands, with the construct
// Hopper's tile kernels use in place of the TPU's:
//   k1, k9       block loads into shared memory and a row broadcast;
//   k2, k14      the sample loop over S = 9 with a block reduction in
//                place of a lane concatenation;
//   k3-k5, k13, k16  thread-index arithmetic over N = 576;
//   k6, k7, k17  compare-select over (512, 576) with int32 and int16
//                operands;
//   k8, k10      bf16 products on the tensor cores, mma.sync.m16n8k16
//                with f32 accumulation: (128,512)@(512,576) and
//                (64,32)@(32,576) with ReLU;
//   k11          a (3, 128, 576) operand sliced on its leading axis;
//   k12          the carried output row under a block-uniform predicate
//                (__syncthreads_or);
//   k15          scalar splats from a (1, 1, 8) meta row.
// k12 reads its output before writing it.  On the TPU that buffer is
// undefined (interpret mode fills it with NaN); here the wrapper hands
// the kernel a zeroed output, so k12 gives 1.0 everywhere.
//
// What bounds them on the H100: hardly anything.  The largest operand is
// 590 KB (k7, k11, k17), the largest product 75.5 MFLOP (k8): well under
// a microsecond of bytes or bf16 tensor-core time.  A rung of one block
// of 256 threads takes about the launch's ~2 us of device time, and the
// short rungs are that.  The four long ones (k6, k7, k17: 295k
// compare-selects; k8: 18,432 mma.sync) ran at one SM's rate, tens of us,
// as one block; they now spread over the card: each block of a grid
// reduces its share (k6, k7, k17: a contiguous run of 2,048 elements, 144
// blocks; k8: one 16-deep step of K for all eight 16-row slices, a warp
// a slice, against all 72 column tiles, 32 blocks) into one partial, and
// the last block to finish, found by a ticket (__threadfence, then
// atomicAdd on an int), sums the partials in a fixed order, fills the
// output and resets the ticket for the next launch.  Each rung stays one launch.
// The partials and tickets are the library's own device memory, so
// launches of one rung must not overlap (the ladder runs on one stream).
// The ladder checks constructs, not speed.
// Sums are block reductions in a fixed order, and floats are never summed
// with atomics; the rungs whose sums are integers below 2^24 are exact,
// the others agree with their plain versions to f32 rounding.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int S = 9, TPX = 64, N = 576, VOX = 512, ROWW = 128;
constexpr int NT = 256;            // threads of every rung's one block
constexpr int OUT = 8 * TPX;       // (8, 64) output

// Sum of v over the block, the same value in every thread.
__device__ float block_sum(float v) {
  __shared__ float part[NT / 32];
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();                 // part may hold an earlier call's sums
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.0f;
  for (int w = 0; w < NT / 32; ++w) s += part[w];
  return s;
}

__device__ void fill(float* o, float v) {
  for (int i = threadIdx.x; i < OUT; i += NT) o[i] = v;
}

// The grid-wide rungs: each block's partial, and a ticket per rung.
constexpr int SPAN = 2048;               // k6, k7, k17: elements a block
constexpr int GRID = VOX * N / SPAN;     // 144 blocks
constexpr int GRID8 = VOX / 16;          // k8: 32 blocks, a K step each
constexpr int ACC = 4;                   // k8: accumulators a warp
enum Wide { W6, W7, W8, W17, N_WIDE };
__device__ float g_part[N_WIDE][GRID];
__device__ unsigned int g_ticket[N_WIDE];

// Block b's partial v (the same in every thread) into g_part; the last
// block of the grid to arrive sums every partial in a fixed order (thread
// t takes partials t, t + NT, ... in order, then block_sum), fills o and
// resets the ticket.
__device__ void grid_finish(float v, int rung, float* o) {
  __shared__ bool last;
  if (threadIdx.x == 0) {
    g_part[rung][blockIdx.x] = v;
    __threadfence();                  // the partial before the ticket
    last = atomicAdd(&g_ticket[rung], 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  float s = 0.0f;
  for (int b = threadIdx.x; b < gridDim.x; b += NT)
    s += __ldcg(&g_part[rung][b]);    // from L2: other SMs wrote them
  s = block_sum(s);
  fill(o, s);
  if (threadIdx.x == 0) g_ticket[rung] = 0;
}

// k1: o = x + x[0:1], x staged in shared memory.
__global__ void k1_kernel(const float* x, float* o) {
  __shared__ float xs[OUT];
  for (int i = threadIdx.x; i < OUT; i += NT) xs[i] = x[i];
  __syncthreads();
  for (int i = threadIdx.x; i < OUT; i += NT) o[i] = xs[i] + xs[i % TPX];
}

// k2: sum of row 6 tiled over S samples.
__global__ void k2_kernel(const float* x, float* o) {
  float v = 0.0f;
  for (int n = threadIdx.x; n < N; n += NT) v += x[6 * TPX + n % TPX];
  fill(o, block_sum(v));
}

// k3: sum over n < N of (n / 64) * 2 + 1.
__global__ void k3_kernel(const float*, float* o) {
  float v = 0.0f;
  for (int n = threadIdx.x; n < N; n += NT) v += (float)(n / TPX) * 2.0f + 1.0f;
  fill(o, block_sum(v));
}

// k4: lane l sums n = s * 64 + l over the S samples.
__global__ void k4_kernel(const float*, float* o) {
  for (int i = threadIdx.x; i < OUT; i += NT) {
    float acc = 0.0f;
    for (int s = 0; s < S; ++s) acc += (float)(s * TPX + i % TPX);
    o[i] = acc;
  }
}

// k5: count of 5 < n < 500.
__global__ void k5_kernel(const float*, float* o) {
  float v = 0.0f;
  for (int n = threadIdx.x; n < N; n += NT)
    v += (n > 5 && n < 500) ? 1.0f : 0.0f;
  fill(o, block_sum(v));
}

// k6: one-hot (VOX, N), row == n % VOX, selected as bf16; grid-wide.
__global__ void k6_kernel(const float*, float* o) {
  const __nv_bfloat16 one = __float2bfloat16(1.0f);
  const __nv_bfloat16 zero = __float2bfloat16(0.0f);
  float v = 0.0f;
  const int e0 = blockIdx.x * SPAN;
  for (int e = e0 + threadIdx.x; e < e0 + SPAN; e += NT) {
    const int r = e / N, n = e % N;
    v += __bfloat162float(r == n % VOX ? one : zero);
  }
  grid_finish(block_sum(v), W6, o);
}

// k7: as k6 with a precomputed int16 row operand rv (VOX, N); grid-wide.
__global__ void k7_kernel(const float*, const int16_t* rv, float* o) {
  const __nv_bfloat16 one = __float2bfloat16(1.0f);
  const __nv_bfloat16 zero = __float2bfloat16(0.0f);
  float v = 0.0f;
  const int e0 = blockIdx.x * SPAN;
  for (int e = e0 + threadIdx.x; e < e0 + SPAN; e += NT) {
    const int16_t lid = (int16_t)((e % N) % VOX);
    v += __bfloat162float(rv[e] == lid ? one : zero);
  }
  grid_finish(block_sum(v), W7, o);
}

// One m16n8k16 bf16 product with f32 accumulation: d += a * b.
__device__ void mma_bf16(float d[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo)
         | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// A fragment of the 16x16 tile at (m0, k0) of a row-major bf16 matrix with
// `ld` (even) columns: rows m0 + g and m0 + g + 8, column pairs k0 + 2t
// and k0 + 2t + 8, g = lane / 4, t = lane % 4; each pair is one 32-bit
// load.
__device__ void load_a(uint32_t a[4], const __nv_bfloat16* m, int ld, int m0,
                       int k0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const uint32_t* r0 = reinterpret_cast<const uint32_t*>(
      m + (size_t)(m0 + g) * ld + k0 + 2 * t);
  const uint32_t* r8 = r0 + 4 * ld;          // 8 rows of ld / 2 words
  a[0] = r0[0];
  a[1] = r8[0];
  a[2] = r0[4];
  a[3] = r8[4];
}

// k8: sum of slabT (ROWW, VOX) @ onehot (VOX, N) with onehot[k, n] =
// (k == 3), on the tensor cores, grid-wide.  Block b takes the 16-deep
// step k0 = 16b of K = VOX; its warp w loads the A fragment of rows
// 16w..16w+15 once and runs it against every 8-column tile of N, whose B
// fragment (rows k0 + 2t (+1, +8, +9) of column n0 + g) is the one-hot
// built in registers, so slabT is read once over the grid.  Only the sum
// of the product is kept: the tiles accumulate round robin into ACC
// fragments (shorter dependent chains), summed in a fixed order.
__global__ void k8_kernel(const __nv_bfloat16* slabT, float* o) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = 16 * blockIdx.x, k = k0 + 2 * t;
  uint32_t a[4];
  load_a(a, slabT, VOX, 16 * warp, k0);
  float d[ACC][4] = {};
#pragma unroll
  for (int nt = 0; nt < N / 8; ++nt) {
    const int n = 8 * nt + g;
    auto oh = [n](int kk) {
      return __float2bfloat16(kk == 3 && n < N ? 1.0f : 0.0f);
    };
    const uint32_t b[2] = {pack_bf16(oh(k), oh(k + 1)),
                           pack_bf16(oh(k + 8), oh(k + 9))};
    mma_bf16(d[nt % ACC], a, b);
  }
  float v = 0.0f;
#pragma unroll
  for (int i = 0; i < ACC; ++i) v += (d[i][0] + d[i][1]) + (d[i][2] + d[i][3]);
  grid_finish(block_sum(v), W8, o);
}

// k9: sh (16, 64) staged in shared memory, tiled over S samples, summed.
__global__ void k9_kernel(const float* sh, float* o) {
  __shared__ float ss[16 * TPX];
  for (int i = threadIdx.x; i < 16 * TPX; i += NT) ss[i] = sh[i];
  __syncthreads();
  float v = 0.0f;
  for (int e = threadIdx.x; e < 16 * N; e += NT)
    v += ss[(e / N) * TPX + (e % N) % TPX];
  fill(o, block_sum(v));
}

// k10: sum of relu(w1 (64, 32) @ ones (32, N)) on the tensor cores.
// Warps 0-3 own rows 16w..16w+15; the other four take the odd column
// tiles, so all eight share the 72 tiles of N.
__global__ void k10_kernel(const __nv_bfloat16* w1, float* o) {
  const int warp = threadIdx.x >> 5;
  const uint32_t one2 = pack_bf16(__float2bfloat16(1.0f),
                                  __float2bfloat16(1.0f));
  const uint32_t b[2] = {one2, one2};
  float v = 0.0f;
  for (int n0 = 8 * (warp >> 2); n0 < N; n0 += 16) {
    float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int k0 = 0; k0 < 32; k0 += 16) {
      uint32_t a[4];
      load_a(a, w1, 32, 16 * (warp & 3), k0);
      mma_bf16(d, a, b);
    }
    v += (fmaxf(d[0], 0.0f) + fmaxf(d[1], 0.0f))
         + (fmaxf(d[2], 0.0f) + fmaxf(d[3], 0.0f));
  }
  fill(o, block_sum(v));
}

// k11: sum of b[0] * 2 + b[1] over (ROWW, N) of a (3, ROWW, N) operand.
__global__ void k11_kernel(const float* b, float* o) {
  float v = 0.0f;
  for (int e = threadIdx.x; e < ROWW * N; e += NT)
    v += b[e] * 2.0f + b[ROWW * N + e];
  fill(o, block_sum(v));
}

// k12: tau = o[0, lane]; live = tau < 4.6; if any lane is live, o += live.
// Every thread reads its row-0 values before the barrier that decides
// the predicate, and writes after it.
__global__ void k12_kernel(const float*, float* o) {
  float live[OUT / NT];
  int any = 0;
  for (int j = 0, i = threadIdx.x; i < OUT; ++j, i += NT) {
    live[j] = o[i % TPX] < 4.6f ? 1.0f : 0.0f;
    any |= live[j] != 0.0f;
  }
  if (__syncthreads_or(any))
    for (int j = 0, i = threadIdx.x; i < OUT; ++j, i += NT) o[i] += live[j];
}

// k13: sum of ones (ROWW, N) * ((1 - f) + 0.5 * (2f - 1)), f = 0.01 n.
__global__ void k13_kernel(const float*, float* o) {
  float v = 0.0f;
  for (int n = threadIdx.x; n < N; n += NT) {
    const float f = (float)n * 0.01f;
    const float w = (1.0f - f) + 0.5f * (2.0f * f - 1.0f);
    for (int r = 0; r < ROWW; ++r) v += 1.0f * w;
  }
  fill(o, block_sum(v));
}

// k14: count of n with x[0, n % 64] > 0.5 and the scalar x[1, 0] > 0.
__global__ void k14_kernel(const float* x, float* o) {
  const bool s = x[TPX] > 0.0f;
  float v = 0.0f;
  for (int n = threadIdx.x; n < N; n += NT)
    v += (x[n % TPX] > 0.5f && s) ? 1.0f : 0.0f;
  fill(o, block_sum(v));
}

// k15: sum over k < 3 of (meta[k] - 0.3) * 2, splat over the block.
__global__ void k15_kernel(const float* meta, float* o) {
  float acc = 0.0f;
  for (int k = 0; k < 3; ++k) acc += (meta[k] - 0.3f) * 2.0f;
  fill(o, acc);
}

// k16: sum of exp(-v)(1 - exp(-v)) and of sigmoid(v) over 3 rows,
// v = 1e-3 n.
__global__ void k16_kernel(const float*, float* o) {
  float sd = 0.0f, sg = 0.0f;
  for (int n = threadIdx.x; n < N; n += NT) {
    const float v = (float)n * 1e-3f;
    sd += expf(-v) * (1.0f - expf(-v));
    for (int r = 0; r < 3; ++r) sg += 1.0f / (1.0f + expf(-(1.0f * v)));
  }
  const float a = block_sum(sd);
  fill(o, a + block_sum(sg));
}

// k17: count of rv == 3 over an int16 (VOX, N) operand read as int32;
// grid-wide.
__global__ void k17_kernel(const int16_t* rv, float* o) {
  float v = 0.0f;
  const int e0 = blockIdx.x * SPAN;
  for (int e = e0 + threadIdx.x; e < e0 + SPAN; e += NT)
    v += (int)rv[e] == 3 ? 1.0f : 0.0f;
  grid_finish(block_sum(v), W17, o);
}

}  // namespace

extern "C" {

const char* ladder_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Launch rung k (1-17) on its operands a (and b for k7) into o (8, 64)
// f32; o must be zeroed for k12.  k6, k7, k8 and k17 launch a grid (one
// launch a rung all the same).
int ladder_rung(int k, const void* a, const void* b, float* o,
                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float* x = (const float*)a;
  switch (k) {
    case 1: k1_kernel<<<1, NT, 0, s>>>(x, o); break;
    case 2: k2_kernel<<<1, NT, 0, s>>>(x, o); break;
    case 3: k3_kernel<<<1, NT, 0, s>>>(x, o); break;
    case 4: k4_kernel<<<1, NT, 0, s>>>(x, o); break;
    case 5: k5_kernel<<<1, NT, 0, s>>>(x, o); break;
    case 6: k6_kernel<<<GRID, NT, 0, s>>>(x, o); break;
    case 7: k7_kernel<<<GRID, NT, 0, s>>>(x, (const int16_t*)b, o); break;
    case 8: k8_kernel<<<GRID8, NT, 0, s>>>((const __nv_bfloat16*)a, o); break;
    case 9: k9_kernel<<<1, NT, 0, s>>>(x, o); break;
    case 10: k10_kernel<<<1, NT, 0, s>>>((const __nv_bfloat16*)a, o); break;
    case 11: k11_kernel<<<1, NT, 0, s>>>(x, o); break;
    case 12: k12_kernel<<<1, NT, 0, s>>>(x, o); break;
    case 13: k13_kernel<<<1, NT, 0, s>>>(x, o); break;
    case 14: k14_kernel<<<1, NT, 0, s>>>(x, o); break;
    case 15: k15_kernel<<<1, NT, 0, s>>>(x, o); break;
    case 16: k16_kernel<<<1, NT, 0, s>>>(x, o); break;
    case 17: k17_kernel<<<GRID, NT, 0, s>>>((const int16_t*)a, o); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
