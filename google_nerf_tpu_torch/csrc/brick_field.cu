// Brick-field kernels of the tile-raster serving renderer, for Hopper
// (sm_90a).  Built with nvcc into a shared library with a plain C
// interface and loaded through ctypes by
// google_nerf_tpu_torch/ops/cuda/brick_field.py, which also holds the
// plain PyTorch versions these kernels are tested against.
//
// What they replace
//   brick_field_wl  <- google_nerf_tpu/ops/pallas/brick_field.py
//                      brick_field_tiles_wl / _kernel_wl (worklist grid)
//   brick_field_tp  <- brick_field_tiles_tp / _kernel_tp (dense tile grid
//                      with scalar list addressing: the exact drain)
// Both compute brick_field_tiles_reference: for each 8x8 ray tile and each
// brick of its front-to-back list, slab-test the tile's 64 rays against
// the brick AABB, lay the lattice window of at most S samples, trilerp the
// brick-local Bk^3 lattice, sigma*dt = min(exp(min(h0, 30))*dt, 80),
// rgb = sigmoid(MLP 32->64->64->3 of [sh16, h16]), and composite front to
// back with tau carried across bricks under the live gate tau < tau_max.
// Output per ray: [tau, r, g, b, depth*w, n_pairs, c6, c7].
//
// Rounding follows the TPU kernel: slab values are bf16; each corner's
// w_c * v_c is rounded to bf16 before the f32 corner sum (the TPU's bf16
// group-reduce matmul); sh, h and the two hidden activations are rounded
// to bf16 and every product accumulates in f32.  The library is built
// without fast math and with --fmad=false, so the slab test's ceil/floor
// window bounds round exactly as in PyTorch and n_pairs matches exactly;
// the MLP uses explicit fmaf, which that flag does not touch.
//
// What bounds it on the H100
//   Bytes: each distinct slab a call touches (Bk^3 = 512 rows x 256 B =
//   128 KiB per brick) read once, plus the rays, sh and carry of its tiles.
//   A K1 call of the 800^2 bench frame touches ~1.4k distinct bricks
//   (~180 MB: ~0.055 ms at 3.35 TB/s).
//   Operations: per live sample 8x16 trilerp MACs plus 16x64 + 64x64 +
//   64x3 MLP MACs (~5.4k MACs, ~11 kFLOP; the sh half of layer 1 is per
//   ray, not per sample).  Such a call has ~2.5M live samples, ~27 GFLOP:
//   ~0.03 ms at the bf16 tensor-core peak, so bytes bind.  This simple
//   kernel runs the MLP on the fp32 CUDA cores (67 TFLOP/s, ~0.4 ms for
//   those FLOPs), which makes it compute-bound in practice.
//
// What this simple design does about it
//   * No one-hot trilerp: the TPU kernel's (N,512)x(512,128) one-hot
//     matmul exists because Mosaic has no vector gather.  Here a thread per
//     (ray, sample) reads its voxel's 256-byte row (8 corners x 16 bf16
//     features) straight from global memory through L2.  The whole 128 KiB
//     slab is not staged in shared memory: a tile's narrow ray bundle
//     touches only a fraction of the 512 rows, and a 128 KiB stage would
//     cap the SM at one block.
//   * Only live samples are evaluated: rays that miss the brick or have
//     saturated contribute exactly zero in the reference, so the block
//     compacts the (ray, sample) pairs of live hit rays before the field.
//   * MLP weights (rounded to bf16, held as f32, ~25 KB) sit in shared
//     memory; layer 1's sh half is computed once per tile and ray.
//   * The TPU's sequential grid carried tau in a revisited output block.
//     CUDA blocks run in no order, so one block owns one tile and walks
//     that tile's slots in list order, carrying tau/rgb/depth/count per
//     ray in shared memory.  K1's block starts at a worklist step with
//     wf==1 and walks the following steps while wt is unchanged; K2's
//     block loops over its tile's nslots list rows from lbase.
//   * The group gate and per-sub-brick liveness are kept as one test per
//     sub-brick: a sub-brick whose rays have no live hit adds nothing and
//     is skipped, so n_pairs = sum(hit & live) matches.
//   * The state buffer `out` holds the carry-in on entry (the wrapper
//     copies `init` there) and is updated in place for visited tiles only;
//     every other tile keeps its init row.
//   wgmma, TMA slab staging and a persistent grid are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TPX = 64;       // rays per tile (8x8)
constexpr int ROWW = 128;     // pool row: 8 corners x 16 features
constexpr int FEAT = 16;
constexpr int HID = 64;       // rgb MLP width
constexpr int NTHREADS = 128;
constexpr int A1_STRIDE = HID + 1;   // padded: rows of different rays
                                     // land in different banks

struct Args {
  const int32_t* pool_blk;     // (n_rows,) pool block per list row
  const float* meta;           // (n_rows, 8) [lo xyz, hi xyz, pad, pad]
  int64_t n_rows;
  const float* rays;           // (T*64, 8) [o xyz, unit d xyz, t1, t2]
  const float* sh;             // (T*64, 16)
  const __nv_bfloat16* pool;   // (n_blocks, Bk^3, 128)
  int64_t n_blocks;
  const float* w1;             // (32, 64)
  const float* w2;             // (64, 64)
  const float* w3;             // (64, 3)
  float* out;                  // (T*64, 8) carry-in, updated in place
  int T;
  int S;
  float dt;
  float tau_max;
  int Bk;
};

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

struct Smem {
  float* w1;      // 32*64
  float* w2;      // 64*64, transposed: w2[j*64 + i] = W2[i, j]
  float* w3;      // 64*3
  float* a1sh;    // 64*A1_STRIDE: per-ray sh half of layer 1
  float* ray;     // 64*8
  float* st;      // 64*8 carried state
  float* n0;      // 64
  float* sd;      // 64*S
  float* rgb;     // 64*S*3
  int* pre;       // 65 prefix sums of per-ray sample counts
};

__host__ __device__ inline size_t smem_floats(int S) {
  return 32 * HID + HID * HID + HID * 3 + TPX * A1_STRIDE + TPX * 8 +
         TPX * 8 + TPX + (size_t)TPX * S * 4 + (TPX + 1);
}

__device__ Smem carve(float* base, int S) {
  Smem s;
  s.w1 = base;
  s.w2 = s.w1 + 32 * HID;
  s.w3 = s.w2 + HID * HID;
  s.a1sh = s.w3 + HID * 3;
  s.ray = s.a1sh + TPX * A1_STRIDE;
  s.st = s.ray + TPX * 8;
  s.n0 = s.st + TPX * 8;
  s.sd = s.n0 + TPX;
  s.rgb = s.sd + TPX * S;
  s.pre = reinterpret_cast<int*>(s.rgb + TPX * S * 3);
  return s;
}

// Load weights, the tile's rays and carried state; precompute the sh half
// of MLP layer 1 for the tile's 64 rays.
__device__ void tile_begin(const Args& a, const Smem& s, int tile) {
  const int tid = threadIdx.x;
  for (int i = tid; i < 32 * HID; i += NTHREADS) s.w1[i] = bf16r(a.w1[i]);
  for (int i = tid; i < HID * HID; i += NTHREADS)
    s.w2[(i % HID) * HID + i / HID] = bf16r(a.w2[i]);
  for (int i = tid; i < HID * 3; i += NTHREADS) s.w3[i] = bf16r(a.w3[i]);
  const int64_t r0 = (int64_t)tile * TPX;
  for (int i = tid; i < TPX * 8; i += NTHREADS) {
    s.ray[i] = a.rays[r0 * 8 + i];
    s.st[i] = a.out[r0 * 8 + i];
  }
  __syncthreads();
  for (int i = tid; i < TPX * HID; i += NTHREADS) {
    const int r = i / HID, j = i % HID;
    const float* shr = a.sh + (r0 + r) * FEAT;
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < FEAT; ++k)
      acc = fmaf(bf16r(shr[k]), s.w1[k * HID + j], acc);
    s.a1sh[r * A1_STRIDE + j] = acc;
  }
  __syncthreads();
}

__device__ void tile_end(const Args& a, const Smem& s, int tile) {
  const int64_t r0 = (int64_t)tile * TPX;
  for (int i = threadIdx.x; i < TPX * 8; i += NTHREADS)
    a.out[r0 * 8 + i] = s.st[i];
}

// Field + MLP of one (ray r, window sample n) inside the brick.
__device__ void eval_sample(const Args& a, const Smem& s, int r, float n,
                            const float* lo, const float* hi, int64_t pb,
                            float* sd_out, float* rgb_out) {
  const float* ray = s.ray + r * 8;
  const float ts = ray[6] + (n + 0.5f) * a.dt;
  const float fBk = (float)a.Bk;
  float v0[3], fr[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float x = ray[k] + ts * ray[3 + k];
    float u = (x - lo[k]) * (fBk / (hi[k] - lo[k]));
    u = fminf(fmaxf(u, 0.f), fBk - 1e-3f);
    v0[k] = floorf(u);
    fr[k] = u - v0[k];
  }
  const int lid = (int)((v0[0] * fBk + v0[1]) * fBk + v0[2]);
  const uint4* row = reinterpret_cast<const uint4*>(
      a.pool + (pb * a.Bk * a.Bk * a.Bk + lid) * ROWW);

  float h[FEAT];
#pragma unroll
  for (int f = 0; f < FEAT; ++f) h[f] = 0.f;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float wc = ((c & 1) ? fr[0] : 1.f - fr[0]) *
                     ((c & 2) ? fr[1] : 1.f - fr[1]) *
                     ((c & 4) ? fr[2] : 1.f - fr[2]);
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const uint4 raw = __ldg(row + c * 2 + q);
      const __nv_bfloat16* v = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
      for (int f = 0; f < 8; ++f)
        h[q * 8 + f] += bf16r(wc * __bfloat162float(v[f]));
    }
  }
  *sd_out = fminf(expf(fminf(h[0], 30.f)) * a.dt, 80.f);

  // layer 1: [sh, h] @ w1 as the sh half (per ray) + the h half
  float a1[HID];
#pragma unroll
  for (int j = 0; j < HID; ++j) a1[j] = 0.f;
#pragma unroll
  for (int k = 0; k < FEAT; ++k) {
    const float hk = bf16r(h[k]);
    const float4* w = reinterpret_cast<const float4*>(s.w1 + (FEAT + k) * HID);
#pragma unroll
    for (int j = 0; j < HID / 4; ++j) {
      const float4 wv = w[j];
      a1[4 * j + 0] = fmaf(hk, wv.x, a1[4 * j + 0]);
      a1[4 * j + 1] = fmaf(hk, wv.y, a1[4 * j + 1]);
      a1[4 * j + 2] = fmaf(hk, wv.z, a1[4 * j + 2]);
      a1[4 * j + 3] = fmaf(hk, wv.w, a1[4 * j + 3]);
    }
  }
  const float* a1sh = s.a1sh + r * A1_STRIDE;
#pragma unroll
  for (int j = 0; j < HID; ++j) a1[j] = bf16r(fmaxf(a1sh[j] + a1[j], 0.f));
  // layers 2 and 3, one hidden unit at a time
  float z0 = 0.f, z1 = 0.f, z2 = 0.f;
  for (int j = 0; j < HID; ++j) {
    const float4* w = reinterpret_cast<const float4*>(s.w2 + j * HID);
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < HID / 4; ++i) {
      const float4 wv = w[i];
      acc = fmaf(a1[4 * i + 0], wv.x, acc);
      acc = fmaf(a1[4 * i + 1], wv.y, acc);
      acc = fmaf(a1[4 * i + 2], wv.z, acc);
      acc = fmaf(a1[4 * i + 3], wv.w, acc);
    }
    const float a2 = bf16r(fmaxf(acc, 0.f));
    z0 = fmaf(a2, s.w3[j * 3 + 0], z0);
    z1 = fmaf(a2, s.w3[j * 3 + 1], z1);
    z2 = fmaf(a2, s.w3[j * 3 + 2], z2);
  }
  rgb_out[0] = 1.f / (1.f + expf(-z0));
  rgb_out[1] = 1.f / (1.f + expf(-z1));
  rgb_out[2] = 1.f / (1.f + expf(-z2));
}

// One list row (sub-brick) of the tile: slab test, live-sample field,
// ordered composite into the carried state.  Block-uniform control flow.
__device__ void sub_brick(const Args& a, const Smem& s, int64_t row) {
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
  int act = 0;
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
    act = hit && (s.st[tid * 8] < a.tau_max);
    s.n0[tid] = n0;
    s.pre[tid + 1] = act ? (int)fminf(n1 - n0 + 1.f, (float)a.S) : 0;
  }
  if (!__syncthreads_or(act)) return;
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
    eval_sample(a, s, r, s.n0[r] + (float)j, lo, hi, pb,
                s.sd + r * a.S + j, s.rgb + (r * a.S + j) * 3);
  }
  __syncthreads();
  if (tid < TPX) {
    const int nv = s.pre[tid + 1] - s.pre[tid];
    if (nv > 0) {
      const float* ray = s.ray + tid * 8;
      float run = 0.f, cr = 0.f, cg = 0.f, cb = 0.f, dep = 0.f;
      for (int j = 0; j < nv; ++j) {
        const float sd = s.sd[tid * a.S + j];
        const float* c = s.rgb + (tid * a.S + j) * 3;
        const float w = expf(-run) * (1.f - expf(-sd));
        cr += w * c[0];
        cg += w * c[1];
        cb += w * c[2];
        dep += w * (ray[6] + ((s.n0[tid] + (float)j) + 0.5f) * a.dt);
        run += sd;
      }
      float* st = s.st + tid * 8;
      const float Tb = expf(-st[0]);
      st[0] += run;
      st[1] += Tb * cr;
      st[2] += Tb * cg;
      st[3] += Tb * cb;
      st[4] += Tb * dep;
      st[5] += 1.f;
    }
  }
  __syncthreads();
}

// K1: one block per worklist step; blocks at a tile's first step (wf==1)
// render the tile's consecutive steps, the rest exit.  The block scans
// ahead NTHREADS steps at a time in parallel, so the run of pad steps
// (wn == 0) after the last real tile costs one load per thread, not a
// serial walk.
__global__ void __launch_bounds__(NTHREADS)
brick_field_wl_kernel(Args a, const int32_t* wt, const int32_t* wl,
                      const int32_t* wn, const int32_t* wf, int Ns, int P) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int c_wl[NTHREADS], c_wn[NTHREADS], c_end;
  const int j0 = blockIdx.x;
  if (wf[j0] != 1) return;
  const int tile = wt[j0];
  if (tile < 0 || tile >= a.T) return;
  const Smem s = carve(smem, a.S);
  tile_begin(a, s, tile);
  for (int base = j0;; base += NTHREADS) {
    const int j = base + threadIdx.x;
    const bool end = j >= Ns || (j > j0 && (wt[j] != tile || wf[j] == 1));
    if (threadIdx.x == 0) c_end = NTHREADS;
    __syncthreads();
    if (end) atomicMin(&c_end, (int)threadIdx.x);
    else {
      c_wl[threadIdx.x] = wl[j];
      c_wn[threadIdx.x] = min(wn[j], P);
    }
    __syncthreads();
    const int n_steps = c_end;
    for (int t = 0; t < n_steps; ++t)
      for (int k = 0; k < c_wn[t]; ++k)
        sub_brick(a, s, (int64_t)c_wl[t] + k);
    if (n_steps < NTHREADS) break;
    __syncthreads();
  }
  tile_end(a, s, tile);
}

// K2: one block per entry of tid, walking nslots list rows from lbase.
__global__ void __launch_bounds__(NTHREADS)
brick_field_tp_kernel(Args a, const int32_t* tid, const int32_t* lbase,
                      const int32_t* nslots, int Lcall) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x;
  const int tile = tid[b];
  if (tile < 0 || tile >= a.T) return;
  const Smem s = carve(smem, a.S);
  tile_begin(a, s, tile);
  const int n = min(nslots[b], Lcall);
  for (int l = 0; l < n; ++l) sub_brick(a, s, (int64_t)lbase[b] + l);
  tile_end(a, s, tile);
}

Args make_args(const int32_t* pool_blk, const float* meta, int64_t n_rows,
               const float* rays, const float* sh, const void* pool,
               int64_t n_blocks, const float* w1, const float* w2,
               const float* w3, float* out, int T, int S, float dt,
               float tau_max, int Bk) {
  Args a;
  a.pool_blk = pool_blk;
  a.meta = meta;
  a.n_rows = n_rows;
  a.rays = rays;
  a.sh = sh;
  a.pool = static_cast<const __nv_bfloat16*>(pool);
  a.n_blocks = n_blocks;
  a.w1 = w1;
  a.w2 = w2;
  a.w3 = w3;
  a.out = out;
  a.T = T;
  a.S = S;
  a.dt = dt;
  a.tau_max = tau_max;
  a.Bk = Bk;
  return a;
}

template <typename K>
int prepare(K kernel, int S, size_t* bytes) {
  *bytes = smem_floats(S) * sizeof(float);
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*bytes);
}

}  // namespace

extern "C" {

const char* brick_field_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int brick_field_wl(const int32_t* pool_blk, const float* meta, int64_t n_rows,
                   const float* rays, const float* sh, const void* pool,
                   int64_t n_blocks, const float* w1, const float* w2,
                   const float* w3, float* out, int T, const int32_t* wt,
                   const int32_t* wl, const int32_t* wn, const int32_t* wf,
                   int Ns, int P, int S, float dt, float tau_max, int Bk,
                   void* stream) {
  size_t bytes;
  int err = prepare(brick_field_wl_kernel, S, &bytes);
  if (err) return err;
  if (Ns == 0) return 0;
  const Args a = make_args(pool_blk, meta, n_rows, rays, sh, pool, n_blocks,
                           w1, w2, w3, out, T, S, dt, tau_max, Bk);
  brick_field_wl_kernel<<<Ns, NTHREADS, bytes, (cudaStream_t)stream>>>(
      a, wt, wl, wn, wf, Ns, P);
  return (int)cudaGetLastError();
}

int brick_field_tp(const int32_t* pool_blk, const float* meta, int64_t n_rows,
                   const float* rays, const float* sh, const void* pool,
                   int64_t n_blocks, const float* w1, const float* w2,
                   const float* w3, float* out, int T, const int32_t* tid,
                   const int32_t* lbase, const int32_t* nslots, int Tb,
                   int Lcall, int S, float dt, float tau_max, int Bk,
                   void* stream) {
  size_t bytes;
  int err = prepare(brick_field_tp_kernel, S, &bytes);
  if (err) return err;
  if (Tb == 0) return 0;
  const Args a = make_args(pool_blk, meta, n_rows, rays, sh, pool, n_blocks,
                           w1, w2, w3, out, T, S, dt, tau_max, Bk);
  brick_field_tp_kernel<<<Tb, NTHREADS, bytes, (cudaStream_t)stream>>>(
      a, tid, lbase, nslots, Lcall);
  return (int)cudaGetLastError();
}

}  // extern "C"
