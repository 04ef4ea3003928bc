// Brick-field kernels K1, K2 and K5 of the tile-raster serving renderer,
// for Hopper (sm_90a).  Built with nvcc into a shared library with a plain
// C interface and loaded through ctypes by
// google_nerf_tpu_torch/ops/cuda/brick_field.py, which also holds the
// plain PyTorch versions these kernels are tested against.  K3 and K4 are
// in brick_field_dense.cu.
//
// What they replace (google_nerf_tpu/ops/pallas/brick_field.py)
//   brick_field_wl   <- brick_field_tiles_wl / _kernel_wl (K1, worklist grid)
//   brick_field_tp   <- brick_field_tiles_tp / _kernel_tp (K2, dense tile
//                       grid with list addressing and an init carry)
//   brick_field_rgba <- brick_field_tiles_rgba / _kernel_rgba (K5, pre-
//                       shaded (n_blocks, 32, Bk^3) slabs, no MLP, carry)
// K1 and K2 compute brick_field_tiles_reference: for each 8x8 ray tile and
// each brick of its front-to-back list, slab-test the tile's 64 rays against
// the brick AABB, lay the lattice window of at most S samples, trilerp the
// brick-local Bk^3 lattice, sigma*dt = min(exp(min(h0, 30))*dt, 80),
// rgb = sigmoid(MLP 32->64->64->3 of [sh16, h16]), and composite front to
// back with tau carried across bricks under the live gate tau < tau_max.
// K5 computes brick_field_rgba_reference: the same with the trilerped
// [log sigma, r, g, b] of pre-shaded corners, rgb clipped to [0, 1].
// Output per ray: [tau, r, g, b, depth*w, n_pairs, c6, c7].
//
// Rounding follows the TPU kernels: slab values are bf16; each corner's
// w_c * v_c is rounded to bf16 before the f32 corner sum (the TPU's bf16
// group-reduce matmul); sh, h and the two hidden activations are rounded
// to bf16 and every product accumulates in f32.  The corner weights keep
// each TPU kernel's own form: K1 and K2 take where(bit, f, 1-f); K5 takes
// (1-f) + bit*(2f-1), which can differ in the last bit.  The library is
// built without fast math and with --fmad=false, so the slab test's
// ceil/floor window bounds round exactly as in PyTorch and n_pairs matches
// exactly; the MLP uses explicit fmaf, which that flag does not touch.
//
// What bounds them on the H100
//   Bytes: each distinct slab a call touches read once (K1, K2: Bk^3 = 512
//   rows x 256 B = 128 KiB per brick; K5: 32 KiB), plus the rays, sh and
//   carry of its tiles.  A K1 call of the 800^2 bench frame touches ~1.4k
//   distinct bricks (~180 MB: ~0.055 ms at 3.35 TB/s).
//   Operations: per live sample 8x16 trilerp MACs plus 16x64 + 64x64 +
//   64x3 MLP MACs (~5.4k MACs, ~11 kFLOP; the sh half of layer 1 is per
//   ray, not per sample); K5 8x4 MACs.  The MLP kernels' FLOPs are ~0.03 ms
//   of bf16 tensor-core time per K1 call, so bytes bind; this simple code
//   runs the MLP on the fp32 CUDA cores (67 TFLOP/s, ~0.4 ms for those
//   FLOPs), which makes it compute-bound in practice.
//
// What this simple design does about it
//   * No one-hot trilerp: the TPU kernel's (N,512)x(512,128) one-hot
//     matmul exists because Mosaic has no vector gather.  K1 and K2 give each
//     (ray, sample) a thread that reads its voxel's 256-byte row (8
//     corners x 16 bf16 features) straight from global memory through L2;
//     a tile's narrow ray bundle touches only a fraction of the 512 rows.
//   * K5's slab puts a voxel's 32 values Bk^3 elements apart, so K5 stages
//     the whole (32, Bk^3) slab (32 KiB) in shared memory with coalesced
//     16-byte loads, once per (tile, slot) that has a live hit, and each
//     sample reads its values from there; with no MLP it is bound by those
//     bytes.
//   * Only live samples are evaluated: rays that miss the brick or have
//     saturated contribute exactly zero in the reference, so the block
//     compacts the (ray, sample) pairs of live hit rays before the field.
//     The window is evaluated in passes of at most MAX_CHUNK samples per
//     ray, each composited into per-ray running sums before the next, so
//     shared memory does not grow with S and any window span renders.
//   * MLP weights (rounded to bf16, held as f32, ~25 KB) sit in shared
//     memory; layer 1's sh half is computed once per tile and ray.
//   * The TPU's sequential grid carried tau in a revisited output block.
//     CUDA blocks run in no order, so one block owns one tile and walks
//     that tile's slots in list order, carrying tau/rgb/depth/count per
//     ray in shared memory.  K1's block starts at a worklist step with
//     wf==1 and walks the following steps while wt is unchanged; the tile
//     kernels' block loops over its tile's nslots list rows from lbase.
//   * The group gate and per-sub-brick liveness are kept as one test per
//     sub-brick: a sub-brick whose rays have no live hit adds nothing and
//     is skipped, so n_pairs = sum(hit & live) matches.
//   * The state buffer `out` holds the carry-in on entry (the wrapper
//     copies `init` there) and is updated in place for listed tiles only;
//     every other tile keeps its row.
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
constexpr int MAX_CHUNK = 32;   // window samples per ray in one pass

// Field kinds: how a sample's corner values are found and shaded.
enum Kind {
  ROWS = 0,    // (n_blocks, Bk^3, 128) rows from global memory, MLP (K1, K2)
  RGBA = 2     // (n_blocks, 32, Bk^3) slab staged, [log sigma, rgb] (K5)
};

struct Args {
  const int32_t* pool_blk;     // (n_rows,) pool block per list row
  const float* meta;           // (n_rows, 8) [lo xyz, hi xyz, pad, pad]
  int64_t n_rows;
  const float* rays;           // (T*64, 8) [o xyz, unit d xyz, t1, t2]
  const float* sh;             // (T*64, 16); unused by K5
  const __nv_bfloat16* pool;   // per Kind above
  int64_t n_blocks;
  const float* w1;             // (32, 64); unused by K5
  const float* w2;             // (64, 64)
  const float* w3;             // (64, 3)
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
  __nv_bfloat16* slab;   // staged slab (RGBA)
  float* w1;      // 32*64
  float* w2;      // 64*64, transposed: w2[j*64 + i] = W2[i, j]
  float* w3;      // 64*3
  float* a1sh;    // 64*A1_STRIDE: per-ray sh half of layer 1
  float* ray;     // 64*8
  float* st;      // 64*8 carried state
  float* n0;      // 64
  float* sd;      // 64*SC
  float* rgb;     // 64*SC*3
  int* pre;       // 65 prefix sums of per-ray sample counts in a pass
};

__host__ __device__ inline size_t slab_elems(int kind, int Bk) {
  const size_t vox = (size_t)Bk * Bk * Bk;
  return kind == RGBA ? 32 * vox : 0;
}

// Dynamic shared memory of a kernel; the slab comes first, and its byte
// size (256 or 64 x Bk^3) keeps the floats after it 16-byte aligned.
__host__ __device__ inline size_t smem_bytes(int kind, int SC, int Bk) {
  size_t f = TPX * 8 * 2 + TPX + (size_t)TPX * SC * 4 + (TPX + 1);
  if (kind != RGBA) f += 32 * HID + HID * HID + HID * 3 + TPX * A1_STRIDE;
  return slab_elems(kind, Bk) * sizeof(__nv_bfloat16) + f * sizeof(float);
}

__device__ Smem carve(float* base, int kind, int SC, int Bk) {
  Smem s;
  s.slab = reinterpret_cast<__nv_bfloat16*>(base);
  float* f = reinterpret_cast<float*>(s.slab + slab_elems(kind, Bk));
  s.w1 = s.w2 = s.w3 = s.a1sh = nullptr;
  if (kind != RGBA) {
    s.w1 = f;
    s.w2 = s.w1 + 32 * HID;
    s.w3 = s.w2 + HID * HID;
    s.a1sh = s.w3 + HID * 3;
    f = s.a1sh + TPX * A1_STRIDE;
  }
  s.ray = f;
  s.st = s.ray + TPX * 8;
  s.n0 = s.st + TPX * 8;
  s.sd = s.n0 + TPX;
  s.rgb = s.sd + TPX * SC;
  s.pre = reinterpret_cast<int*>(s.rgb + TPX * SC * 3);
  return s;
}

// Load weights, the tile's rays and carried state;
// precompute the sh half of MLP layer 1 for the tile's 64 rays.
template <int KIND, int NT>
__device__ void tile_begin(const Args& a, const Smem& s, int tile) {
  const int tid = threadIdx.x;
  if (KIND != RGBA) {
    for (int i = tid; i < 32 * HID; i += NT) s.w1[i] = bf16r(a.w1[i]);
    for (int i = tid; i < HID * HID; i += NT)
      s.w2[(i % HID) * HID + i / HID] = bf16r(a.w2[i]);
    for (int i = tid; i < HID * 3; i += NT) s.w3[i] = bf16r(a.w3[i]);
  }
  const int64_t r0 = (int64_t)tile * TPX;
  for (int i = tid; i < TPX * 8; i += NT) {
    s.ray[i] = a.rays[r0 * 8 + i];
    s.st[i] = a.out[r0 * 8 + i];
  }
  __syncthreads();
  if (KIND != RGBA) {
    for (int i = tid; i < TPX * HID; i += NT) {
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
}

template <int NT>
__device__ void tile_end(const Args& a, const Smem& s, int tile) {
  const int64_t r0 = (int64_t)tile * TPX;
  for (int i = threadIdx.x; i < TPX * 8; i += NT)
    a.out[r0 * 8 + i] = s.st[i];
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

// Trilinear weight of corner c (bit k = offset on axis k, x = LSB).
// LERP: the TPU t-kernels' (1-f) + bit*(2f-1); else where(bit, f, 1-f).
template <bool LERP>
__device__ __forceinline__ float corner_w(int c, const float* fr) {
  float w[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const bool bit = (c >> k) & 1;
    if (LERP)
      w[k] = bit ? (1.f - fr[k]) + (2.f * fr[k] - 1.f) : 1.f - fr[k];
    else
      w[k] = bit ? fr[k] : 1.f - fr[k];
  }
  return w[0] * w[1] * w[2];
}

// sigma*dt and rgb of one sample from its trilerped features h.
__device__ void shade(const Args& a, const Smem& s, int r, const float* h,
                      float* sd_out, float* rgb_out) {
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

// Field of one (ray r, window sample n) inside the brick.
template <int KIND>
__device__ void eval_sample(const Args& a, const Smem& s, int r, float n,
                            const float* lo, const float* hi, int64_t pb,
                            float* sd_out, float* rgb_out) {
  float fr[3];
  const int lid = locate(a, s.ray + r * 8, n, lo, hi, fr);
  const int vox = a.Bk * a.Bk * a.Bk;
  if constexpr (KIND == RGBA) {
    // lane = corner * 4 + channel; slab[lane * vox + lid]
    float h4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float wc = corner_w<true>(c, fr);
#pragma unroll
      for (int ch = 0; ch < 4; ++ch)
        h4[ch] += bf16r(wc * __bfloat162float(
                                  s.slab[(c * 4 + ch) * vox + lid]));
    }
    *sd_out = fminf(expf(fminf(h4[0], 30.f)) * a.dt, 80.f);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch)
      rgb_out[ch] = fminf(fmaxf(h4[1 + ch], 0.f), 1.f);
  } else {
    float h[FEAT];
#pragma unroll
    for (int f = 0; f < FEAT; ++f) h[f] = 0.f;
    if constexpr (KIND == ROWS) {
      const uint4* row = reinterpret_cast<const uint4*>(
          a.pool + (pb * vox + lid) * ROWW);
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float wc = corner_w<false>(c, fr);
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const uint4 raw = __ldg(row + c * 2 + q);
          const __nv_bfloat16* v =
              reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
          for (int f = 0; f < 8; ++f)
            h[q * 8 + f] += bf16r(wc * __bfloat162float(v[f]));
        }
      }
    }
    shade(a, s, r, h, sd_out, rgb_out);
  }
}

// Copy brick pb's slab into shared memory (RGBA) with 16-byte loads.
template <int KIND, int NT>
__device__ void stage(const Args& a, const Smem& s, int64_t pb) {
  if (KIND == ROWS) return;
  const int64_t n16 = (int64_t)slab_elems(KIND, a.Bk) / 8;
  const uint4* src = reinterpret_cast<const uint4*>(a.pool) + pb * n16;
  uint4* dst = reinterpret_cast<uint4*>(s.slab);
  for (int64_t i = threadIdx.x; i < n16; i += NT) dst[i] = __ldg(src + i);
}

// One list row (sub-brick) of the tile: slab test, live-sample field,
// ordered composite into the carried state.  Block-uniform control flow.
template <int KIND, int NT>
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
  stage<KIND, NT>(a, s, pb);     // the loop's first barrier publishes it
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
    for (int i = tid; i < M; i += NT) {
      int lo_r = 0, hi_r = TPX - 1;   // last r with pre[r] <= i
      while (lo_r < hi_r) {
        const int mid = (lo_r + hi_r + 1) >> 1;
        if (s.pre[mid] <= i) lo_r = mid; else hi_r = mid - 1;
      }
      const int r = lo_r, j = i - s.pre[r];
      eval_sample<KIND>(a, s, r, s.n0[r] + (float)(j0 + j), lo, hi, pb,
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
  const Smem s = carve(smem, ROWS, a.SC, a.Bk);
  tile_begin<ROWS, NTHREADS>(a, s, tile);
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
        sub_brick<ROWS, NTHREADS>(a, s, (int64_t)c_wl[t] + k);
    if (n_steps < NTHREADS) break;
    __syncthreads();
  }
  tile_end<NTHREADS>(a, s, tile);
}

// The tile-list kernels: one block per entry of tid, walking
// min(nslots, Lcall) list rows from lbase.
template <int KIND, int NT>
__device__ void tiles_body(const Args& a, const int32_t* tid,
                           const int32_t* lbase, const int32_t* nslots,
                           int Lcall) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x;
  const int tile = tid[b];
  if (tile < 0 || tile >= a.T) return;
  const Smem s = carve(smem, KIND, a.SC, a.Bk);
  tile_begin<KIND, NT>(a, s, tile);
  const int n = min(nslots[b], Lcall);
  for (int l = 0; l < n; ++l) sub_brick<KIND, NT>(a, s, (int64_t)lbase[b] + l);
  tile_end<NT>(a, s, tile);
}

// K2: row pool, from the carry.
__global__ void __launch_bounds__(NTHREADS)
brick_field_tp_kernel(Args a, const int32_t* tid, const int32_t* lbase,
                      const int32_t* nslots, int Lcall) {
  tiles_body<ROWS, NTHREADS>(a, tid, lbase, nslots, Lcall);
}

// K5: pre-shaded rgba slabs staged per live (tile, slot), from the carry.
__global__ void __launch_bounds__(NTHREADS)
brick_field_rgba_kernel(Args a, const int32_t* tid, const int32_t* lbase,
                        const int32_t* nslots, int Lcall) {
  tiles_body<RGBA, NTHREADS>(a, tid, lbase, nslots, Lcall);
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
  a.SC = S < MAX_CHUNK ? S : MAX_CHUNK;
  a.dt = dt;
  a.tau_max = tau_max;
  a.Bk = Bk;
  return a;
}

template <typename K>
int prepare(K kernel, int kind, const Args& a, size_t* bytes) {
  *bytes = smem_bytes(kind, a.SC, a.Bk);
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*bytes);
}

template <typename K>
int launch_tiles(K kernel, int kind, int nt, const Args& a,
                 const int32_t* tid, const int32_t* lbase,
                 const int32_t* nslots, int Tb, int Lcall, void* stream) {
  size_t bytes;
  int err = prepare(kernel, kind, a, &bytes);
  if (err) return err;
  if (Tb == 0) return 0;
  kernel<<<Tb, nt, bytes, (cudaStream_t)stream>>>(a, tid, lbase, nslots,
                                                  Lcall);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* brick_field_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Dynamic shared memory a kernel of `kind` (0 rows, 2 rgba)
// takes at window span S and brick edge Bk, and the current device's
// opt-in limit for one block.
int64_t brick_field_smem_bytes(int kind, int S, int Bk) {
  return (int64_t)smem_bytes(kind, S < MAX_CHUNK ? S : MAX_CHUNK, Bk);
}

int brick_field_smem_optin(void) {
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  return optin;
}

int brick_field_wl(const int32_t* pool_blk, const float* meta, int64_t n_rows,
                   const float* rays, const float* sh, const void* pool,
                   int64_t n_blocks, const float* w1, const float* w2,
                   const float* w3, float* out, int T, const int32_t* wt,
                   const int32_t* wl, const int32_t* wn, const int32_t* wf,
                   int Ns, int P, int S, float dt, float tau_max, int Bk,
                   void* stream) {
  const Args a = make_args(pool_blk, meta, n_rows, rays, sh, pool, n_blocks,
                           w1, w2, w3, out, T, S, dt, tau_max, Bk);
  size_t bytes;
  int err = prepare(brick_field_wl_kernel, ROWS, a, &bytes);
  if (err) return err;
  if (Ns == 0) return 0;
  brick_field_wl_kernel<<<Ns, NTHREADS, bytes, (cudaStream_t)stream>>>(
      a, wt, wl, wn, wf, Ns, P);
  return (int)cudaGetLastError();
}

#define TILE_ENTRY(NAME, KERNEL, KIND, NT)                                   \
  int NAME(const int32_t* pool_blk, const float* meta, int64_t n_rows,       \
           const float* rays, const float* sh, const void* pool,             \
           int64_t n_blocks, const float* w1, const float* w2,               \
           const float* w3, float* out, int T, const int32_t* tid,           \
           const int32_t* lbase, const int32_t* nslots, int Tb, int Lcall,   \
           int S, float dt, float tau_max, int Bk, void* stream) {           \
    const Args a = make_args(pool_blk, meta, n_rows, rays, sh, pool,         \
                             n_blocks, w1, w2, w3, out, T, S, dt, tau_max,   \
                             Bk);                                            \
    return launch_tiles(KERNEL, KIND, NT, a, tid, lbase, nslots, Tb, Lcall,  \
                        stream);                                             \
  }

TILE_ENTRY(brick_field_tp, brick_field_tp_kernel, ROWS, NTHREADS)

// K5 takes no sh and no MLP weights.
int brick_field_rgba(const int32_t* pool_blk, const float* meta,
                     int64_t n_rows, const float* rays, const void* pool,
                     int64_t n_blocks, float* out, int T, const int32_t* tid,
                     const int32_t* lbase, const int32_t* nslots, int Tb,
                     int Lcall, int S, float dt, float tau_max, int Bk,
                     void* stream) {
  const Args a = make_args(pool_blk, meta, n_rows, rays, nullptr, pool,
                           n_blocks, nullptr, nullptr, nullptr, out, T, S, dt,
                           tau_max, Bk);
  return launch_tiles(brick_field_rgba_kernel, RGBA, NTHREADS, a, tid, lbase,
                      nslots, Tb, Lcall, stream);
}

}  // extern "C"
