// The multiresolution hash-grid encoder (Instant-NGP) for Hopper (sm_90a):
// one kernel computes the features of a point on a level in registers,
// one adds the table gradient (and, when asked, the gradient of the
// points) with atomics.  Built with nvcc into a shared library with a
// plain C interface and loaded through ctypes by
// google_nerf_tpu_torch/ops/cuda/hash_grid.py, which also holds the plain
// PyTorch versions these kernels are tested against.  The encoder that
// calls them is google_nerf_tpu_torch/models/encoders.hash_encode.
//
// What they replace.  No TPU kernel: google_nerf_tpu/models/encoders.py
// computes the hash grid in XLA, and the port wrote it as a chain of ~35
// tensor ops (the int64 corner arithmetic, ops/table_gather's row gather,
// the trilinear sum; autograd's payloads and P3 backward) whose (L, 8, N,
// .) intermediates all went through device memory.  These kernels write
// none of them: per point and level, 3 floats in, 8 rows gathered, F
// floats out.  tiny-cuda-nn's grid encoding, the encoder behind the
// reference's ngp_pl/models/networks.py:38-47, is written the same way.
//
// The arithmetic is the plain path's, bit for bit up to the order of the
// 8-corner sum (and of the atomics):
//   pos = x * res (f32); c0 = min(max(floor(pos), 0), res - 1);
//   frac = pos - c0; corner c takes offset bit k = (c >> k) & 1 on axis k;
//   index: dense (x-fastest) on levels with (res + 1)^3 <= T, else the
//   xor-prime hash in uint32 (the same bits as the plain path's int64
//   products masked to 32 bits), & (T - 1); then clamped to [0, T);
//   w_c = (t0 * t1) * t2 with t_k = frac_k or 1 - frac_k;
//   the row read in the gather dtype (bf16 or f32) and widened to f32.
// nvcc builds with --fmad=false, so no product is fused into a sum.
//
// What bounds them on the H100 (3.35 TB/s, 50 MB L2).
//   Forward: per point and level 8 row reads of 2 x 2 or 4 bytes, random
//   within the level's slice of the table (2 MB a level in bf16 at
//   2^19 x 2), which sits in L2: the whole bf16 table is 33.5 MB.  The
//   bytes that must cross HBM are x (12 B a point) and the features
//   (8 L bytes a point); the L2 sectors of the row reads (32 B each,
//   8 L a point) are what limits the kernel.
//   Backward: 8 L atomic row adds a point into an f32 table gradient
//   (67 MB at 2^19 x 2 x 16 levels, over the L2), zeroed first.  With the
//   level in blockIdx.y, the blocks of one level run together, so the
//   level's 4 MB slice of the gradient stays in L2 while it is hit.
//
// What the designs do about it
//   * Forward: thread g of the grid takes point g / L on level g % L, so
//     a warp's feature stores are one contiguous run of 64 floats, and
//     the output (N, 2 L) is written in whole lines (the level in
//     blockIdx.y, as tiny-cuda-nn lays it, stores 2 floats at a stride of
//     2 L and took 2.7-4.1x as long at 2^18-2^21 points); the 8 corners
//     are unrolled, so their row loads go out together.  A row is one
//     32-bit load in bf16, one 64-bit load in f32.
//   * Backward: the level in blockIdx.y, a point a thread.  Rows take
//     many payloads: thousands each on the dense (coarse) levels, and
//     consecutive samples of a ray share corners on the finer ones too.
//     So the lanes of a warp that add onto one row first sum among
//     themselves (__match_any_sync, then a tree of shuffles), and one
//     lane adds the sum; on every level, since pre-summing the hashed
//     levels too was measured faster on samples along rays (0.262 against
//     0.341 ms at 2^18 points, and no slower on uniform points).  The row
//     add is one float2 atomic (sm_90).  The gradient of x sums its 3
//     floats a level into a zeroed (N, 3) with atomics.
//   * The forward adds its corners in the plain path's order, so its
//     features equal the plain path's bit for bit; in the backward the
//     order of the atomics, and the last bits of a row's sum, vary from
//     run to run.
//   * Every hash field of the port has rows of F = 2 features, so that
//     is the one width instantiated, for a gather dtype of bf16 or f32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 256;
constexpr int MAX_LEVELS = 64;
constexpr int F = 2;                         // features a row
constexpr uint32_t PRIME1 = 2654435761u, PRIME2 = 805459861u;

struct Levels {
  int32_t res[MAX_LEVELS];
};

// The row of 2 elements at p, widened to f32: one 32-bit load of two
// bf16 (element 0 in the low half), or one 64-bit load of two f32.
__device__ __forceinline__ void load_row(const uint16_t* __restrict__ p,
                                         float (&out)[F]) {
  const uint32_t w = __ldg(reinterpret_cast<const unsigned int*>(p));
  out[0] = __uint_as_float(w << 16);                   // bf16 -> f32, exact
  out[1] = __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ void load_row(const float* __restrict__ p,
                                         float (&out)[F]) {
  const float2 v = __ldg(reinterpret_cast<const float2*>(p));
  out[0] = v.x;
  out[1] = v.y;
}

__device__ __forceinline__ bool dense_level(int32_t res, uint32_t T) {
  const uint64_t r1 = (uint64_t)res + 1;
  return r1 * r1 * r1 <= T;
}

// The cell of point x on a level of resolution res: its low corner and
// the offset inside it, as the plain path computes them.
struct Cell {
  uint32_t c0[3];
  float frac[3];
};

__device__ __forceinline__ Cell cell_of(const float (&x)[3], int32_t res) {
  const float r = (float)res;
  Cell cell;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float pos = __fmul_rn(x[k], r);
    const float c = fminf(fmaxf(floorf(pos), 0.0f), __fsub_rn(r, 1.0f));
    cell.c0[k] = (uint32_t)c;
    cell.frac[k] = __fsub_rn(pos, c);
  }
  return cell;
}

// Table index of corner c of the cell (0 <= index < T).
__device__ __forceinline__ uint32_t corner_index(const Cell& cell, int c,
                                                 int32_t res, bool dense,
                                                 uint32_t T) {
  const uint32_t cx = cell.c0[0] + (c & 1), cy = cell.c0[1] + ((c >> 1) & 1),
                 cz = cell.c0[2] + ((c >> 2) & 1);
  uint32_t idx;
  if (dense) {
    const uint32_t r1 = (uint32_t)res + 1;
    idx = cx + cy * r1 + cz * r1 * r1;
  } else {
    idx = (cx ^ (cy * PRIME1) ^ (cz * PRIME2)) & (T - 1);
  }
  return min(idx, T - 1);
}

// t[b][k]: the factor of axis k for offset bit b (1 - frac, or frac).
__device__ __forceinline__ void factors(const Cell& cell, float (&t)[2][3]) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    t[0][k] = __fsub_rn(1.0f, cell.frac[k]);
    t[1][k] = cell.frac[k];
  }
}

__device__ __forceinline__ float corner_weight(const float (&t)[2][3],
                                               int c) {
  return __fmul_rn(__fmul_rn(t[c & 1][0], t[(c >> 1) & 1][1]),
                   t[(c >> 2) & 1][2]);
}

__device__ __forceinline__ void load_point(const float* __restrict__ x,
                                           uint64_t i, float (&p)[3]) {
#pragma unroll
  for (int k = 0; k < 3; ++k) p[k] = __ldg(x + 3 * i + k);
}

// The features of point i on level l (resolution res) into o[0, F).
template <typename TT>
__device__ __forceinline__ void encode_one(const float* __restrict__ x,
                                           const TT* __restrict__ tab,
                                           float* __restrict__ o, uint64_t i,
                                           uint32_t l, uint32_t T,
                                           int32_t res) {
  const bool dense = dense_level(res, T);
  float p[3];
  load_point(x, i, p);
  const Cell cell = cell_of(p, res);
  float t[2][3];
  factors(cell, t);
  const TT* tl = tab + (uint64_t)l * T * F;
  float acc[F];
#pragma unroll
  for (int f = 0; f < F; ++f) acc[f] = 0.0f;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const uint32_t idx = corner_index(cell, c, res, dense, T);
    const float w = corner_weight(t, c);
    float row[F];
    load_row(tl + (uint64_t)idx * F, row);
#pragma unroll
    for (int f = 0; f < F; ++f)
      acc[f] = __fadd_rn(acc[f], __fmul_rn(w, row[f]));
  }
  *reinterpret_cast<float2*>(o) = make_float2(acc[0], acc[1]);
}

// Forward: thread g computes level g % L of point g / L: out[g * F, +F).
template <typename TT>
__global__ void __launch_bounds__(NTHREADS)
hash_grid_fwd_kernel(const float* __restrict__ x, const TT* __restrict__ tab,
                     float* __restrict__ out, uint64_t n_items, uint32_t L,
                     uint32_t T, Levels lv) {
  const uint64_t g = (uint64_t)blockIdx.x * NTHREADS + threadIdx.x;
  if (g >= n_items) return;
  uint64_t i;
  uint32_t l;
  if (n_items < (1ull << 32)) {          // 32-bit division where it fits
    i = (uint32_t)g / L;
    l = (uint32_t)g - (uint32_t)i * L;
  } else {
    i = g / L;
    l = (uint32_t)(g - i * L);
  }
  encode_one<TT>(x, tab, out + g * F, i, l, T, lv.res[l]);
}

// Sums v over the lanes of `peers` (the lanes that share a key, this lane
// among them) into the lowest of them, in a tree of shuffles; every lane
// of the warp calls it.
__device__ __forceinline__ void peer_sum(uint32_t peers, float (&v)[F]) {
  const uint32_t lane = threadIdx.x & 31;
  uint32_t rank = __popc(peers & ((1u << lane) - 1u));  // peers below
  peers &= 0xfffffffeu << lane;                         // peers above
  while (__any_sync(0xffffffffu, peers)) {
    const int next = __ffs(peers);                      // 0: none left
#pragma unroll
    for (int f = 0; f < F; ++f) {
      const float o = __shfl_sync(0xffffffffu, v[f], (next - 1) & 31);
      if (next) v[f] = __fadd_rn(v[f], o);
    }
    peers &= __ballot_sync(0xffffffffu, !(rank & 1));
    rank >>= 1;
  }
}

// The gradients from point i (valid) on level l (resolution res), every
// lane of the warp calling: the payloads w_c * g into dtable's level (if
// not null), pre-summed over the lanes that share a row; sum_c (g .
// row_c) dw_c/dfrac * res into dx[i] (if not null).
template <typename TT>
__device__ __forceinline__ void grads_one(
    const float* __restrict__ x, const float* __restrict__ g,
    const TT* __restrict__ tab, float* __restrict__ dtable,
    float* __restrict__ dx, uint32_t i, bool valid, uint32_t l, uint32_t L,
    uint32_t T, int32_t res) {
  const bool dense = dense_level(res, T);
  float p[3] = {0.0f, 0.0f, 0.0f}, gi[F];
#pragma unroll
  for (int f = 0; f < F; ++f) gi[f] = 0.0f;
  if (valid) {
    load_point(x, i, p);
#pragma unroll
    for (int f = 0; f < F; ++f)
      gi[f] = __ldg(g + (uint64_t)i * L * F + (uint64_t)l * F + f);
  }
  const Cell cell = cell_of(p, res);
  float t[2][3];
  factors(cell, t);
  if (dtable != nullptr) {
    float* dl = dtable + (uint64_t)l * T * F;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const uint32_t idx = corner_index(cell, c, res, dense, T);
      const float w = corner_weight(t, c);
      float v[F];
#pragma unroll
      for (int f = 0; f < F; ++f) v[f] = __fmul_rn(w, gi[f]);
      const uint32_t peers =
          __match_any_sync(0xffffffffu, valid ? idx : 0xffffffffu);
      peer_sum(peers, v);
      if (valid && (threadIdx.x & 31) == (uint32_t)(__ffs(peers) - 1))
        atomicAdd(reinterpret_cast<float2*>(dl + (uint64_t)idx * F),
                  make_float2(v[0], v[1]));
    }
  }
  if (dx != nullptr && valid) {
    const TT* tl = tab + (uint64_t)l * T * F;
    float d[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const uint32_t idx = corner_index(cell, c, res, dense, T);
      float row[F];
      load_row(tl + (uint64_t)idx * F, row);
      float dw = 0.0f;
#pragma unroll
      for (int f = 0; f < F; ++f)
        dw = __fadd_rn(dw, __fmul_rn(gi[f], row[f]));
      const float a = t[c & 1][0], b = t[(c >> 1) & 1][1],
                  e = t[(c >> 2) & 1][2];
      const float dab = __fmul_rn(dw, e);
      const float dt[3] = {__fmul_rn(dab, b), __fmul_rn(dab, a),
                           __fmul_rn(dw, __fmul_rn(a, b))};
#pragma unroll
      for (int k = 0; k < 3; ++k)
        d[k] = ((c >> k) & 1) ? __fadd_rn(d[k], dt[k])
                              : __fsub_rn(d[k], dt[k]);
    }
    const float r = (float)res;
#pragma unroll
    for (int k = 0; k < 3; ++k)
      atomicAdd(dx + 3 * (uint64_t)i + k, __fmul_rn(d[k], r));
  }
}

// Backward: thread (blockIdx.x * NTHREADS + threadIdx.x) takes that point
// on level blockIdx.y.  dtable (L, T, F) and dx (n, 3), each zeroed or
// null.
template <typename TT>
__global__ void __launch_bounds__(NTHREADS)
hash_grid_bwd_kernel(const float* __restrict__ x, const float* __restrict__ g,
                     const TT* __restrict__ tab, float* __restrict__ dtable,
                     float* __restrict__ dx, uint32_t n, uint32_t L,
                     uint32_t T, Levels lv) {
  const uint32_t i = blockIdx.x * NTHREADS + threadIdx.x;
  const uint32_t l = blockIdx.y;
  grads_one<TT>(x, g, tab, dtable, dx, i, i < n, l, L, T, lv.res[l]);
}

// Debug: the index and weight of every (level, corner, point).
__global__ void __launch_bounds__(NTHREADS)
hash_grid_corners_kernel(const float* __restrict__ x,
                         int32_t* __restrict__ idx, float* __restrict__ w,
                         uint32_t n, uint32_t T, Levels lv) {
  const uint32_t i = blockIdx.x * NTHREADS + threadIdx.x;
  const uint32_t l = blockIdx.y;
  if (i >= n) return;
  const int32_t res = lv.res[l];
  const bool dense = dense_level(res, T);
  float p[3];
  load_point(x, i, p);
  const Cell cell = cell_of(p, res);
  float t[2][3];
  factors(cell, t);
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const uint64_t o = ((uint64_t)l * 8 + c) * n + i;
    idx[o] = (int32_t)corner_index(cell, c, res, dense, T);
    w[o] = corner_weight(t, c);
  }
}

// The launches, one struct a direction, instantiated by dispatch().
template <typename TT>
struct Fwd {
  static cudaError_t run(const float* x, const void* tab, float* out,
                         uint64_t n, uint32_t L, uint32_t T, const Levels* lv,
                         cudaStream_t s) {
    const uint64_t items = n * L;
    hash_grid_fwd_kernel<TT>
        <<<(unsigned)((items + NTHREADS - 1) / NTHREADS), NTHREADS, 0, s>>>(
            x, (const TT*)tab, out, items, L, T, *lv);
    return cudaGetLastError();
  }
};

template <typename TT>
struct Bwd {
  static cudaError_t run(const float* x, const float* g, const void* tab,
                         float* dtable, float* dx, uint32_t n, uint32_t L,
                         uint32_t T, const Levels* lv, cudaStream_t s) {
    const dim3 grid((n + NTHREADS - 1) / NTHREADS, L);
    hash_grid_bwd_kernel<TT><<<grid, NTHREADS, 0, s>>>(
        x, g, (const TT*)tab, dtable, dx, n, L, T, *lv);
    return cudaGetLastError();
  }
};

// The instances: rows of F = 2 features of a gather dtype of 2 (bf16) or
// 4 (f32) bytes.  Anything else is refused.
template <template <typename> class Op, typename... A>
cudaError_t dispatch(int esize, int f, A... a) {
  if (f != F) return cudaErrorInvalidValue;
  if (esize == 2) return Op<uint16_t>::run(a...);
  if (esize == 4) return Op<float>::run(a...);
  return cudaErrorInvalidValue;
}

// Levels from the caller's array; false if one is out of range.
bool levels_of(const int32_t* res, int32_t L, Levels* lv) {
  if (L <= 0 || L > MAX_LEVELS) return false;
  for (int l = 0; l < L; ++l) {
    if (res[l] < 1 || res[l] >= (1 << 24)) return false;
    lv->res[l] = res[l];
  }
  return true;
}

bool shape_ok(int64_t n, int32_t L, int32_t T) {
  return n >= 0 && n < (1ll << 31) && T > 0 && L > 0 && L <= MAX_LEVELS;
}

}  // namespace

extern "C" {

const char* hash_grid_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int hash_grid_max_levels(void) { return MAX_LEVELS; }

// Forward.  x (n, 3) f32; tab (L, T, f) of esize-byte elements (2: bf16,
// 4: f32), aligned to its row; res (L,) host int32; out (n, L * f) f32.
// f = 2.
int hash_grid_encode(const float* x, int64_t n, const void* tab,
                     int32_t esize, int32_t L, int32_t T, int32_t f,
                     const int32_t* res, float* out, void* stream) {
  Levels lv;
  if (!shape_ok(n, L, T) || !levels_of(res, L, &lv))
    return cudaErrorInvalidValue;
  if (n == 0) return 0;
  return (int)dispatch<Fwd>(esize, f, x, tab, out, (uint64_t)n,
                            (uint32_t)L, (uint32_t)T, (const Levels*)&lv,
                            (cudaStream_t)stream);
}

// Backward.  As the forward, with g (n, L * f) f32, the gradient of the
// features; dtable (L, T, f) f32 and dx (n, 3) f32, each null or any
// content: the entry zeroes each on the stream, then adds into them.  tab
// is read only for dx.
int hash_grid_grads(const float* x, const float* g, int64_t n,
                    const void* tab, int32_t esize, int32_t L, int32_t T,
                    int32_t f, const int32_t* res, float* dtable, float* dx,
                    void* stream) {
  Levels lv;
  if (!shape_ok(n, L, T) || !levels_of(res, L, &lv) || f != F)
    return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaSuccess;
  if (dtable != nullptr)
    err = cudaMemsetAsync(dtable, 0, (size_t)L * T * f * sizeof(float), s);
  if (!err && dx != nullptr)
    err = cudaMemsetAsync(dx, 0, (size_t)n * 3 * sizeof(float), s);
  if (err || n == 0 || (dtable == nullptr && dx == nullptr)) return (int)err;
  return (int)dispatch<Bwd>(esize, f, x, g, tab, dtable, dx, (uint32_t)n,
                            (uint32_t)L, (uint32_t)T, (const Levels*)&lv, s);
}

// Debug.  idx (L, 8, n) int32 and w (L, 8, n) f32: every corner's table
// index and weight, as both kernels compute them.
int hash_grid_corners(const float* x, int64_t n, int32_t L, int32_t T,
                      const int32_t* res, int32_t* idx, float* w,
                      void* stream) {
  Levels lv;
  if (!shape_ok(n, L, T) || !levels_of(res, L, &lv))
    return cudaErrorInvalidValue;
  if (n == 0) return 0;
  const dim3 grid((unsigned)((n + NTHREADS - 1) / NTHREADS), L);
  hash_grid_corners_kernel<<<grid, NTHREADS, 0, (cudaStream_t)stream>>>(
      x, idx, w, (uint32_t)n, (uint32_t)T, lv);
  return (int)cudaGetLastError();
}

}  // extern "C"
