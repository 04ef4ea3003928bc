// Brick-field kernel K5 of the tile-raster serving renderer, for Hopper
// (sm_90a): the pre-shaded variant, which trilerps baked [log sigma, r, g,
// b] corners and runs no MLP.  Built with nvcc into a shared library with a
// plain C interface and loaded through ctypes by
// google_nerf_tpu_torch/ops/cuda/brick_field.py, which also holds the
// plain PyTorch version it is tested against.  K1-K4 are in
// brick_field_dense.cu.
//
// What it replaces (google_nerf_tpu/ops/pallas/brick_field.py)
//   brick_field_rgba <- brick_field_tiles_rgba / _kernel_rgba (K5: tile
//                       grid with list addressing, pre-shaded
//                       (n_blocks, 32, Bk^3) slabs, init carry)
// It computes brick_field_rgba_reference: for each 8x8 ray tile and each
// brick of its front-to-back list, slab-test the tile's 64 rays against
// the brick AABB, lay the lattice window of at most S samples, trilerp the
// brick-local Bk^3 lattice of [log sigma, r, g, b] (lane = corner * 4 +
// channel), sigma*dt = min(exp(min(h0, 30))*dt, 80), rgb clipped to
// [0, 1], and composite front to back with tau carried across bricks under
// the live gate tau < tau_max.  Output per ray: [tau, r, g, b, depth*w,
// n_pairs, c6, c7], c6 and c7 as init.
//
// Rounding follows the TPU kernel: slab values are bf16; each corner's
// w_c * v_c is rounded to bf16 before the f32 corner sum (the TPU's bf16
// group-reduce matmul).  The corner weights take the TPU kernel's form
// (1-f) + bit*(2f-1).  The library is built without fast math and with
// --fmad=false, so the slab test's ceil/floor window bounds round exactly
// as in PyTorch and n_pairs matches exactly.
//
// What bounds it on the H100
//   Bytes: each distinct voxel a live sample touches read once (its 8
//   corners x 4 channels, 64 B), plus the list rows and the rays, init
//   and output of the call's tiles.  Operations: per live sample 8x4
//   trilerp MACs and the composite, far below the bytes' time.  This
//   design stages a whole 32 KiB slab per live (tile, slot), so it moves
//   far more than those bytes (PERF.md has its time against the bound).
//
// What this simple design does about it
//   * The slab puts a voxel's 32 values Bk^3 elements apart, so the block
//     stages the whole (32, Bk^3) slab in shared memory with coalesced
//     16-byte loads, once per (tile, slot) that has a live hit, and each
//     sample reads its values from there.
//   * Only live samples are evaluated: rays that miss the brick or have
//     saturated contribute exactly zero in the reference, so the block
//     compacts the (ray, sample) pairs of live hit rays before the field.
//     The window is evaluated in passes of at most MAX_CHUNK samples per
//     ray, each composited into per-ray running sums before the next, so
//     shared memory does not grow with S and any window span renders.
//   * The TPU's sequential grid carried tau in a revisited output block.
//     CUDA blocks run in no order, so one block owns one tile and walks
//     its nslots list rows from lbase in list order, carrying
//     tau/rgb/depth/count per ray in shared memory.  A slot whose rays
//     have no live hit adds nothing and is skipped, so n_pairs = sum(hit &
//     live) matches.
//   * The state buffer `out` holds the carry-in on entry (the wrapper
//     copies `init` there) and is updated in place for listed tiles only;
//     every other tile keeps its row.
//   The batched walk of brick_field_dense.cu, reading only the touched
//   voxels, is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TPX = 64;       // rays per tile (8x8)
constexpr int LANES = 32;     // slab lanes: 8 corners x [log sigma, rgb]
constexpr int NTHREADS = 128;
constexpr int MAX_CHUNK = 32;   // window samples per ray in one pass

struct Args {
  const int32_t* pool_blk;     // (n_rows,) pool block per list row
  const float* meta;           // (n_rows, 8) [lo xyz, hi xyz, pad, pad]
  int64_t n_rows;
  const float* rays;           // (T*64, 8) [o xyz, unit d xyz, t1, t2]
  const __nv_bfloat16* pool;   // (n_blocks, 32, Bk^3)
  int64_t n_blocks;
  float* out;                  // (T*64, 8) carry-in, updated in place
  int T;
  int S;                       // window span (samples per ray per brick)
  int SC;                      // samples per ray per pass, min(S, MAX_CHUNK)
  float dt;
  float tau_max;
  int Bk;
};

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

struct Smem {
  __nv_bfloat16* slab;   // staged slab
  float* ray;     // 64*8
  float* st;      // 64*8 carried state
  float* n0;      // 64
  float* sd;      // 64*SC
  float* rgb;     // 64*SC*3
  int* pre;       // 65 prefix sums of per-ray sample counts in a pass
};

// Dynamic shared memory of a block; the slab comes first, and its byte
// size (64 x Bk^3) keeps the floats after it 16-byte aligned.
__host__ __device__ inline size_t smem_bytes(int SC, int Bk) {
  const size_t f = TPX * 8 * 2 + TPX + (size_t)TPX * SC * 4 + (TPX + 1);
  return (size_t)LANES * Bk * Bk * Bk * sizeof(__nv_bfloat16)
         + f * sizeof(float);
}

__device__ Smem carve(float* base, int SC, int Bk) {
  Smem s;
  s.slab = reinterpret_cast<__nv_bfloat16*>(base);
  s.ray = reinterpret_cast<float*>(s.slab + (size_t)LANES * Bk * Bk * Bk);
  s.st = s.ray + TPX * 8;
  s.n0 = s.st + TPX * 8;
  s.sd = s.n0 + TPX;
  s.rgb = s.sd + TPX * SC;
  s.pre = reinterpret_cast<int*>(s.rgb + TPX * SC * 3);
  return s;
}

// Voxel of window sample n of ray `ray` in the brick [lo, hi]: its
// brick-local row lid and in-voxel fractions fr.
__device__ __forceinline__ int locate(const Args& a, const float* ray,
                                      float n, const float* lo,
                                      const float* hi, float* fr) {
  const float ts = ray[6] + (n + 0.5f) * a.dt;
  const float fBk = (float)a.Bk;
  float v0[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float x = ray[k] + ts * ray[3 + k];
    float u = (x - lo[k]) * (fBk / (hi[k] - lo[k]));
    u = fminf(fmaxf(u, 0.f), fBk - 1e-3f);
    v0[k] = floorf(u);
    fr[k] = u - v0[k];
  }
  return (int)((v0[0] * fBk + v0[1]) * fBk + v0[2]);
}

// Trilinear weight of corner c (bit k = offset on axis k, x = LSB), in
// the TPU kernel's form (1-f) + bit*(2f-1).
__device__ __forceinline__ float corner_w(int c, const float* fr) {
  float w[3];
#pragma unroll
  for (int k = 0; k < 3; ++k)
    w[k] = (c >> k) & 1 ? (1.f - fr[k]) + (2.f * fr[k] - 1.f) : 1.f - fr[k];
  return w[0] * w[1] * w[2];
}

// sigma*dt and rgb of one (ray r, window sample n) inside the brick, from
// the staged slab (slab[lane * vox + lid], lane = corner * 4 + channel).
__device__ void eval_sample(const Args& a, const Smem& s, int r, float n,
                            const float* lo, const float* hi, float* sd_out,
                            float* rgb_out) {
  float fr[3];
  const int lid = locate(a, s.ray + r * 8, n, lo, hi, fr);
  const int vox = a.Bk * a.Bk * a.Bk;
  float h4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float wc = corner_w(c, fr);
#pragma unroll
    for (int ch = 0; ch < 4; ++ch)
      h4[ch] += bf16r(wc * __bfloat162float(s.slab[(c * 4 + ch) * vox + lid]));
  }
  *sd_out = fminf(expf(fminf(h4[0], 30.f)) * a.dt, 80.f);
#pragma unroll
  for (int ch = 0; ch < 3; ++ch)
    rgb_out[ch] = fminf(fmaxf(h4[1 + ch], 0.f), 1.f);
}

// One list row of the tile: slab test, staged slab, live-sample field,
// ordered composite into the carried state.  Block-uniform control flow.
__device__ void rgba_slot(const Args& a, const Smem& s, int64_t row) {
  const int tid = threadIdx.x;
  if (row < 0 || row >= a.n_rows) return;
  const int64_t pb = a.pool_blk[row];
  if (pb < 0 || pb >= a.n_blocks) return;
  float lo[3], hi[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    lo[k] = a.meta[row * 8 + k];
    hi[k] = a.meta[row * 8 + 3 + k];
  }
  int cnt = 0;   // live window samples of ray tid in this brick
  if (tid < TPX) {
    const float* ray = s.ray + tid * 8;
    const float t1 = ray[6], t2 = ray[7];
    float ta = t1, tb = t2;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float d = ray[3 + k];
      const float dd = fabsf(d) > 1e-10f ? d : (d >= 0.f ? 1e-10f : -1e-10f);
      const float inv = 1.f / dd;
      const float p = (lo[k] - ray[k]) * inv;
      const float q = (hi[k] - ray[k]) * inv;
      ta = fmaxf(ta, fminf(p, q));
      tb = fminf(tb, fmaxf(p, q));
    }
    const float n0 = fmaxf(ceilf((ta - t1) / a.dt - 0.5f), 0.f);
    const float n1 = floorf((tb - t1) / a.dt - 0.5f);
    const bool hit = (tb > ta) && (n1 >= n0) && (t2 > 0.f);
    if (hit && s.st[tid * 8] < a.tau_max)
      cnt = (int)fminf(n1 - n0 + 1.f, (float)a.S);
    s.n0[tid] = n0;
  }
  if (!__syncthreads_or(cnt > 0)) return;
  // stage the slab with 16-byte loads; the loop's first barrier publishes
  // it
  {
    const int64_t n16 = (int64_t)LANES * a.Bk * a.Bk * a.Bk / 8;
    const uint4* src = reinterpret_cast<const uint4*>(a.pool) + pb * n16;
    uint4* dst = reinterpret_cast<uint4*>(s.slab);
    for (int64_t i = tid; i < n16; i += NTHREADS) dst[i] = __ldg(src + i);
  }
  float run = 0.f, cr = 0.f, cg = 0.f, cb = 0.f, dep = 0.f;
  for (int j0 = 0; __syncthreads_or(cnt > j0); j0 += a.SC) {
    const int nv = min(max(cnt - j0, 0), a.SC);
    if (tid < TPX) s.pre[tid + 1] = nv;
    __syncthreads();
    if (tid == 0) {
      s.pre[0] = 0;
      for (int r = 0; r < TPX; ++r) s.pre[r + 1] += s.pre[r];
    }
    __syncthreads();
    const int M = s.pre[TPX];
    for (int i = tid; i < M; i += NTHREADS) {
      int lo_r = 0, hi_r = TPX - 1;   // last r with pre[r] <= i
      while (lo_r < hi_r) {
        const int mid = (lo_r + hi_r + 1) >> 1;
        if (s.pre[mid] <= i) lo_r = mid; else hi_r = mid - 1;
      }
      const int r = lo_r, j = i - s.pre[r];
      eval_sample(a, s, r, s.n0[r] + (float)(j0 + j), lo, hi,
                  s.sd + r * a.SC + j, s.rgb + (r * a.SC + j) * 3);
    }
    __syncthreads();
    if (tid < TPX) {
      const float* ray = s.ray + tid * 8;
      for (int j = 0; j < nv; ++j) {
        const float sd = s.sd[tid * a.SC + j];
        const float* c = s.rgb + (tid * a.SC + j) * 3;
        const float w = expf(-run) * (1.f - expf(-sd));
        cr += w * c[0];
        cg += w * c[1];
        cb += w * c[2];
        dep += w * (ray[6] + ((s.n0[tid] + (float)(j0 + j)) + 0.5f) * a.dt);
        run += sd;
      }
    }
  }
  if (cnt > 0) {
    float* st = s.st + tid * 8;
    const float Tb = expf(-st[0]);
    st[0] += run;
    st[1] += Tb * cr;
    st[2] += Tb * cg;
    st[3] += Tb * cb;
    st[4] += Tb * dep;
    st[5] += 1.f;
  }
  __syncthreads();
}

// K5: one block per entry of tid, walking min(nslots, Lcall) list rows
// from lbase, from the carry.
__global__ void __launch_bounds__(NTHREADS)
brick_field_rgba_kernel(Args a, const int32_t* tid, const int32_t* lbase,
                        const int32_t* nslots, int Lcall) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x;
  const int tile = tid[b];
  if (tile < 0 || tile >= a.T) return;
  const Smem s = carve(smem, a.SC, a.Bk);
  const int64_t r0 = (int64_t)tile * TPX;
  for (int i = threadIdx.x; i < TPX * 8; i += NTHREADS) {
    s.ray[i] = a.rays[r0 * 8 + i];
    s.st[i] = a.out[r0 * 8 + i];
  }
  __syncthreads();
  const int n = min(nslots[b], Lcall);
  for (int l = 0; l < n; ++l) rgba_slot(a, s, (int64_t)lbase[b] + l);
  for (int i = threadIdx.x; i < TPX * 8; i += NTHREADS)
    a.out[r0 * 8 + i] = s.st[i];
}

}  // namespace

extern "C" {

const char* brick_field_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Dynamic shared memory K5 takes at window span S and brick edge Bk, and
// the current device's opt-in limit for one block.
int64_t brick_field_smem_bytes(int S, int Bk) {
  return (int64_t)smem_bytes(S < MAX_CHUNK ? S : MAX_CHUNK, Bk);
}

int brick_field_smem_optin(void) {
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  return optin;
}

int brick_field_rgba(const int32_t* pool_blk, const float* meta,
                     int64_t n_rows, const float* rays, const void* pool,
                     int64_t n_blocks, float* out, int T, const int32_t* tid,
                     const int32_t* lbase, const int32_t* nslots, int Tb,
                     int Lcall, int S, float dt, float tau_max, int Bk,
                     void* stream) {
  Args a;
  a.pool_blk = pool_blk;
  a.meta = meta;
  a.n_rows = n_rows;
  a.rays = rays;
  a.pool = static_cast<const __nv_bfloat16*>(pool);
  a.n_blocks = n_blocks;
  a.out = out;
  a.T = T;
  a.S = S;
  a.SC = S < MAX_CHUNK ? S : MAX_CHUNK;
  a.dt = dt;
  a.tau_max = tau_max;
  a.Bk = Bk;
  const size_t bytes = smem_bytes(a.SC, Bk);
  const int err = (int)cudaFuncSetAttribute(
      brick_field_rgba_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err) return err;
  if (Tb == 0) return 0;
  brick_field_rgba_kernel<<<Tb, NTHREADS, bytes, (cudaStream_t)stream>>>(
      a, tid, lbase, nslots, Lcall);
  return (int)cudaGetLastError();
}

}  // extern "C"
