// The brick-field tile kernels K1-K5 of the tile-raster serving renderer,
// for Hopper (sm_90a), on one batched body.  Built with nvcc into a shared
// library with a plain C interface and loaded through ctypes by
// google_nerf_tpu_torch/ops/cuda/brick_field.py, which also holds the plain
// PyTorch versions these kernels are tested against.
//
// What they replace (google_nerf_tpu/ops/pallas/brick_field.py)
//   brick_field_wl   <- brick_field_tiles_wl / _kernel_wl (K1: a tile-major
//                       worklist of (tile, P-slot group) steps, init carry)
//   brick_field_tp   <- brick_field_tiles_tp / _kernel_tp (K2: tile grid
//                       with list addressing, init carry)
//   brick_field_n    <- brick_field_tiles / _kernel (K3: tile grid, each
//                       listed tile from zero)
//   brick_field_t    <- brick_field_tiles_t / _kernel_t (K4: K3 on the
//                       transposed pool (n_blocks, 128, Bk^3))
//   brick_field_rgba <- brick_field_tiles_rgba / _kernel_rgba (K5: K2's
//                       list addressing and carry on the pre-shaded pool
//                       (n_blocks, 32, Bk^3), no MLP)
// Three pool layouts: ROWS, the row pool (n_blocks, Bk^3, 128) of K1-K3;
// LANES, K4's transposed pool; RGBA, K5's pre-shaded slabs, lane = corner
// * 4 + channel with channels [log sigma, r, g, b], so a voxel's 32 values
// sit Bk^3 elements apart.  K1-K4 compute brick_field_tiles_reference: for
// each 8x8 ray tile and each brick of its front-to-back list, slab-test
// the tile's 64 rays against the brick AABB, lay the lattice window of at
// most S samples, trilerp the brick-local Bk^3 lattice, sigma*dt =
// min(exp(min(h0, 30))*dt, 80), rgb = sigmoid(MLP 32->64->64->3 of [sh16,
// h16]), and composite front to back with tau carried across bricks under
// the live gate tau < tau_max.  K5 computes brick_field_rgba_reference,
// the same walk with rgb the trilerped channels 1-3 clipped to [0, 1].
// Output per ray: [tau, r, g, b, depth*w, n_pairs, c6, c7], where c6, c7
// are K1/K2/K5's init values and 0 for K3/K4.
//
// Rounding follows the TPU kernels: slab values are bf16; each corner's
// w_c * v_c is rounded to bf16 before the f32 corner sum; sh, h and the two
// hidden activations are rounded to bf16 and every product accumulates in
// f32 (here inside mma.sync, whose order of summation differs from a plain
// f32 dot product, so a hidden activation can round to the neighbouring
// bf16 value).  K5 has no MLP, so it computes its plain version's sums in
// the same order.  Corner weights take each TPU kernel's form, chosen by a
// template flag apart from the pool layout: K3's where(bit, f, 1-f); K1,
// K2, K4 and K5's (1-f) + bit*(2f-1).  The two differ in the last bit when
// f < 1/2 has bits below 2^-24, i.e. in a brick's first voxel along an axis
// (u < 1), which moves a bf16 corner product now and then.  The library is
// built without fast math and with --fmad=false, so the slab test's window
// bounds and sigma round exactly as in PyTorch and n_pairs and tau match
// exactly.
//
// What bounds them on the H100
//   Bytes: each distinct voxel that a live sample touches read once (its
//   8 corners x 16 features, 256 B; K5's 8 corners x 4 channels, 64 B),
//   plus the list rows and the rays, sh, init and output of the call's
//   tiles.  Operations: per live sample 8x16 trilerp MACs and 16x64 +
//   64x64 + 64x3 MLP MACs (~11 kFLOP), a few microseconds of the bf16
//   tensor cores for a call of the 800^2 frame; K5's 8x4 trilerp MACs.
//   Bytes bind (PERF.md has both bounds per call), and the earlier
//   slot-serial design sat far above them, bound instead by latency: one
//   block walked its tile's list one slot at a time with several barriers
//   and a serial prefix sum per slot, a dead slot cost a barrier, each
//   sample's MLP was a chain of ~5.4k dependent fmaf, every block staged
//   the weights first (a dead tile's too), and K4 and K5 re-staged a
//   whole slab (128 KiB, 32 KiB) per live (tile, slot).
//
// What this design does about it
//   * Batched slots: a block of 64*G threads owns one tile and takes its
//     list G slots at a time, one thread per (ray, slot).  Each thread slab-
//     tests its pair; a dead pair costs a predicate, not a barrier.
//   * Gate before shading: each brick's contribution is local to it (run,
//     sum w*rgb and sum w*t start at 0 per brick) and meets the carried
//     state only through the gate tau < tau_max at the brick's start and
//     T_bef = exp(-tau).  So each thread first sums sigma*dt over its pair's
//     window from feature (channel) 0 alone (only for rays still alive at
//     the batch start), then 64 threads resolve the gate slot by slot in
//     list order, and only then are the other features and the MLP
//     evaluated, for the samples of live pairs only.  The sums are the same
//     sums in the same order as the slot-serial walk.
//   * The carry (K1, K2, K5): the state starts from the tile's `out` rows,
//     which hold init (the wrapper copies it there), instead of zero.  It
//     enters each batch only through the gate and T_bef, as any earlier
//     slot's state does, so the batched order stays exact; columns 6-7
//     keep init's values.
//   * Early return (K1, K2, K5): a block reads its tile and slot count,
//     then its 64 carried tau, and returns before it stages anything if it
//     has no slot or no ray with tau < tau_max.  It writes nothing, so its
//     rows keep init; the gate would have added nothing.  Dead-tile elision
//     in a segmented frame (nslots = 0) and the drain's tiles that need no
//     drain launch such blocks.
//   * K1's worklist: one block per step; a block not at a tile's first
//     step (wf != 1) returns at once.  A wf == 1 block scans its run of
//     steps (up to Ns, another tile or the next wf == 1) 512 at a time and
//     walks each step's rows wl[j] + k, k < min(wn[j], P), in batches of
//     at most G that never straddle two steps: the contract makes rows
//     absolute and P-aligned, not contiguous across steps.  The gate is
//     resolved in list order whatever the grouping, so this is exact; with
//     P a multiple of G only a step's short tail is a short batch.  A pad
//     step (wn == 0) costs nothing.
//   * The live samples are listed by a block scan (warp shuffles), not a
//     serial loop, and evaluated in passes of at most CAP samples, so shared
//     memory is sized by the pass, not by 64 x S; a pair's samples are
//     composited in window order across passes.
//   * The MLP runs on the tensor cores: a warp takes 16 live samples, two
//     lanes per sample trilerp 8 features each into a bf16 [16x16] tile,
//     and mma.sync.m16n8k16 (bf16 in, f32 accumulate) computes layer 1's h
//     half (8 products), layer 2 (32) and layer 3 (4, 3 columns padded to
//     8); each layer's f32 fragments are rounded to bf16 and reused in
//     registers as the next layer's A fragments.  Layer 1's sh half is
//     computed once per ray of the tile in f32.  The weights sit once per
//     block in shared memory as bf16 B fragments (11 KiB).
//   * K5 shades without an MLP: one thread a live sample trilerps its
//     voxel's 4 channels (channel 0 again for the sample's sigma*dt, the
//     same bits as the sigma pass) and clips rgb.  It stages no weights
//     and no sh, and its blocks take only the shared memory in front of
//     the MLP's (~40 KiB).
//   * K4 and K5 stage no slab: each sample reads its voxel's values
//     straight from the lane-major pool (through L1/L2), so a call reads
//     only the voxels of its samples: channel 0 of every window sample of
//     a ray alive at the batch start, the rest for live pairs' samples
//     only.  A value costs a 2-byte load there (8 a sample in the sigma
//     pass; K4 128 and K5 32 a live sample); K1-K3 read a sample's
//     256-byte row with 16-byte loads.
//   * G = 8 slots a batch (chosen on the card over 2 and 4: larger batches
//     halve the serial steps of a tile's walk).  K1-K4's shared memory is
//     ~76 KiB a block, so two 512-thread blocks fit an SM; K1-K3's and
//     K5's registers are capped so that two do.  The grid is one block per
//     listed tile (K1: per worklist step).
//   * K3/K4 write each listed tile's `out` rows (the TPU kernels zero their
//     block at l == 0); K1/K2/K5 update them in place; every other tile
//     keeps its rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int TPX = 64;       // rays per tile (8x8)
constexpr int ROWW = 128;     // pool row: 8 corners x 16 features
constexpr int FEAT = 16;
constexpr int RCH = 4;        // K5's channels a corner: [log sigma, rgb]
constexpr int HID = 64;       // rgb MLP width
constexpr int A1_STRIDE = HID + 1;   // padded: rows of different rays
                                     // land in different banks
constexpr int G = 8;          // list slots per batch: 64 * G threads
constexpr int NT = TPX * G;   // threads a block
constexpr int NW = NT / 32;   // warps a block
constexpr int CAP = 128 * G;  // live samples per field pass
constexpr int SIGMA_ILP = 4;  // window samples whose loads a thread
                              // issues together in the sigma pass
constexpr unsigned FULL = 0xffffffffu;

enum Layout { ROWS = 0, LANES = 1, RGBA = 2 };

struct Args {
  const int32_t* pool_blk;     // (n_rows,) pool block per list row
  const float* meta;           // (n_rows, 8) [lo xyz, hi xyz, pad, pad]
  int64_t n_rows;
  const float* rays;           // (T*64, 8) [o xyz, unit d xyz, t1, t2]
  const float* sh;             // (T*64, 16); K5 none
  const __nv_bfloat16* pool;   // ROWS (n_blocks, Bk^3, 128); LANES
                               // (n_blocks, 128, Bk^3); RGBA (n_blocks,
                               // 32, Bk^3)
  int64_t n_blocks;
  const float* w1;             // (32, 64); K5 none (w2, w3 too)
  const float* w2;             // (64, 64)
  const float* w3;             // (64, 3)
  float* out;                  // (T*64, 8): K1/K2/K5 carry-in, updated
                               // in place; K3/K4 listed tiles overwritten
  int T;
  int S;                       // window span (samples per ray per brick)
  float dt;
  float tau_max;
  int Bk;
};

// Shared memory of one block; index i = g * 64 + r is the (slot g of the
// batch, ray r) pair.  The MLP's part comes last: K5 launches without it.
struct Smem {
  float ray[TPX * 8];
  float st[TPX * 8];          // carried state
  float n0[TPX * G];          // first window sample of the pair
  int cnt[TPX * G];           // window samples of a hit pair, else 0
  float run[TPX * G];         // sum of sigma*dt over the pair's window
  float tb[TPX * G];          // T_bef of a live pair, -1 if not live
  float acc[TPX * G * 4];     // a live pair's sum w*rgb, sum w*t
  int wsum[NW];               // block-scan warp totals
  int pb[G];                  // the slots' pool blocks (-1: no slot)
  float box[G * 6];           // the slots' [lo, hi]
  int desc[CAP];              // a pass's samples: (j << 10) | i
  float sd[CAP];              // their sigma*dt
  float rgb[CAP * 3];         // and rgb
  // K1-K4 only
  uint2 w1f[8 * 32];          // B fragments: layer 1's h half, 8 n-tiles
  uint2 w2f[4 * 8 * 32];      // layer 2, (k-tile, n-tile)
  uint2 w3f[4 * 32];          // layer 3, 3 columns padded to 8
  float a1sh[TPX * A1_STRIDE];   // per-ray sh half of layer 1
  alignas(16) __nv_bfloat16 atile[NW][16 * FEAT];   // per-warp A tile
};
constexpr size_t SMEM_RGBA = offsetof(Smem, w1f);   // K5's shared memory

__device__ __forceinline__ Smem& smem() {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  return *reinterpret_cast<Smem*>(smem_raw);
}

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo))
         | ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

__device__ __forceinline__ float ldg_bf16(const __nv_bfloat16* p) {
  return __bfloat162float(__ushort_as_bfloat16(
      __ldg(reinterpret_cast<const unsigned short*>(p))));
}

// d += a * b: one m16n8k16 bf16 product with f32 accumulation.
__device__ __forceinline__ void mma_bf16(float d[4], const uint32_t a[4],
                                         uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// B fragment of the 16x8 tile at (k0, n0) of the row-major f32 matrix w
// (ld columns, ncols of them real, the rest 0), rounded to bf16: lane
// (g = lane / 4, t = lane % 4) holds rows k0 + 2t, +1 and k0 + 2t + 8, +9
// of column n0 + g.
__device__ uint2 b_frag(const float* w, int ld, int ncols, int k0, int n0,
                        int lane) {
  const int n = n0 + (lane >> 2), k = k0 + 2 * (lane & 3);
  auto v = [&](int kk) { return n < ncols ? w[kk * ld + n] : 0.f; };
  return make_uint2(pack_bf16(v(k), v(k + 1)), pack_bf16(v(k + 8), v(k + 9)));
}

// Voxel of window sample n of a ray in the brick [lo, hi]: its
// brick-local voxel lid and in-voxel fractions fr.
__device__ __forceinline__ int locate(const Args& a, const float* ray,
                                      float n, const float* box, float* fr) {
  const float ts = ray[6] + (n + 0.5f) * a.dt;
  const float fBk = (float)a.Bk;
  float v0[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float x = ray[k] + ts * ray[3 + k];
    float u = (x - box[k]) * (fBk / (box[3 + k] - box[k]));
    u = fminf(fmaxf(u, 0.f), fBk - 1e-3f);
    v0[k] = floorf(u);
    fr[k] = u - v0[k];
  }
  return (int)((v0[0] * fBk + v0[1]) * fBk + v0[2]);
}

// Trilinear weight of corner c (bit k = offset on axis k, x = LSB).
// LERP (K1, K2, K4): the TPU kernels' (1-f) + bit*(2f-1); else (K3)
// where(bit, f, 1-f).
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

// Address of feature (K5: channel) f of corner c of voxel lid in pool
// block pb.
template <int L>
__device__ __forceinline__ const __nv_bfloat16* feat(const Args& a,
                                                     int64_t pb, int lid,
                                                     int c, int f) {
  const int64_t vox = (int64_t)a.Bk * a.Bk * a.Bk;
  if (L == ROWS) return a.pool + (pb * vox + lid) * ROWW + c * FEAT + f;
  if (L == RGBA) return a.pool + (pb * 8 * RCH + c * RCH + f) * vox + lid;
  return a.pool + (pb * ROWW + c * FEAT + f) * vox + lid;
}

__device__ __forceinline__ float sigma_dt(const Args& a, float h0) {
  return fminf(expf(fminf(h0, 30.f)) * a.dt, 80.f);
}

// sigma*dt of window sample n from feature 0 alone; the same operations
// in the same order as feature 0 of trilerp_half (K5: of rgba_pass), so
// the same bits.
template <int L, bool LERP>
__device__ float sample_sigma(const Args& a, const float* ray, float n,
                              const float* box, int64_t pb) {
  float fr[3];
  const int lid = locate(a, ray, n, box, fr);
  float h0 = 0.f;
#pragma unroll
  for (int c = 0; c < 8; ++c)
    h0 += bf16r(corner_w<LERP>(c, fr) * ldg_bf16(feat<L>(a, pb, lid, c, 0)));
  return sigma_dt(a, h0);
}

// Features 8q .. 8q+7 of window sample n, trilerped.
template <int L, bool LERP>
__device__ void trilerp_half(const Args& a, const float* ray, float n,
                             const float* box, int64_t pb, int q,
                             float h[8]) {
  float fr[3];
  const int lid = locate(a, ray, n, box, fr);
#pragma unroll
  for (int f = 0; f < 8; ++f) h[f] = 0.f;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float wc = corner_w<LERP>(c, fr);
    if (L == ROWS) {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(
          feat<L>(a, pb, lid, c, 8 * q)));
      const __nv_bfloat16* v = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
      for (int f = 0; f < 8; ++f) h[f] += bf16r(wc * __bfloat162float(v[f]));
    } else {
#pragma unroll
      for (int f = 0; f < 8; ++f)
        h[f] += bf16r(wc * ldg_bf16(feat<L>(a, pb, lid, c, 8 * q + f)));
    }
  }
}

// Exclusive prefix sum of v over the block; *total gets the block's sum.
__device__ int block_scan(int v, Smem& s, int* total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s.wsum[w] = x;
  __syncthreads();
  if (w == 0) {
    int y = lane < NW ? s.wsum[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int z = __shfl_up_sync(FULL, y, o);
      if (lane >= o) y += z;
    }
    if (lane < NW) s.wsum[lane] = y;
  }
  __syncthreads();
  *total = s.wsum[NW - 1];
  return x - v + (w > 0 ? s.wsum[w - 1] : 0);
}

// K5's field of the pass's m listed samples into s.sd, s.rgb: one thread
// a sample trilerps the 4 channels of its voxel, each corner product
// rounded to bf16 and summed in corner order, and clips rgb to [0, 1].
__device__ void rgba_pass(const Args& a, Smem& s, int m) {
  for (int k = threadIdx.x; k < m; k += NT) {
    const int d = s.desc[k], i = d & 1023, j = d >> 10, g = i >> 6;
    float fr[3];
    const int lid = locate(a, s.ray + (i & (TPX - 1)) * 8,
                           s.n0[i] + (float)j, s.box + g * 6, fr);
    float h[RCH] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float wc = corner_w<true>(c, fr);
#pragma unroll
      for (int ch = 0; ch < RCH; ++ch)
        h[ch] += bf16r(wc * ldg_bf16(feat<RGBA>(a, s.pb[g], lid, c, ch)));
    }
    s.sd[k] = sigma_dt(a, h[0]);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch)
      s.rgb[k * 3 + ch] = fminf(fmaxf(h[1 + ch], 0.f), 1.f);
  }
}

// K1-K4's field of the pass's m listed samples: sigma*dt and rgb into
// s.sd, s.rgb.  Each warp takes 16 samples at a time, two lanes a sample.
template <int L, bool LERP>
__device__ void mlp_pass(const Args& a, Smem& s, int m) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q = lane & 1, gq = lane >> 2, t = lane & 3;
  __nv_bfloat16* at = s.atile[warp];
  const uint32_t* aw = reinterpret_cast<const uint32_t*>(at);
  for (int t0 = 16 * warp; t0 < m; t0 += 16 * NW) {
    const int k = t0 + (lane >> 1);
    int r = 0;
    float h[8];
#pragma unroll
    for (int f = 0; f < 8; ++f) h[f] = 0.f;
    if (k < m) {
      const int d = s.desc[k], i = d & 1023, j = d >> 10, g = i >> 6;
      r = i & (TPX - 1);
      trilerp_half<L, LERP>(a, s.ray + r * 8, s.n0[i] + (float)j,
                            s.box + g * 6, s.pb[g], q, h);
      if (q == 0) s.sd[k] = sigma_dt(a, h[0]);
    }
    uint4 hv;
    hv.x = pack_bf16(h[0], h[1]);
    hv.y = pack_bf16(h[2], h[3]);
    hv.z = pack_bf16(h[4], h[5]);
    hv.w = pack_bf16(h[6], h[7]);
    reinterpret_cast<uint4*>(at)[lane] = hv;   // row lane/2, half q
    __syncwarp();
    const uint32_t a1[4] = {aw[gq * 8 + t], aw[(gq + 8) * 8 + t],
                            aw[gq * 8 + 4 + t], aw[(gq + 8) * 8 + 4 + t]};
    __syncwarp();
    const float* sh_lo = s.a1sh + __shfl_sync(FULL, r, 2 * gq) * A1_STRIDE;
    const float* sh_hi = s.a1sh + __shfl_sync(FULL, r, 2 * gq + 16) *
                                      A1_STRIDE;
    // layer 1: the h half on the tensor cores, plus the ray's sh half
    uint32_t x[4][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      float d[4] = {0.f, 0.f, 0.f, 0.f};
      mma_bf16(d, a1, s.w1f[nt * 32 + lane]);
      const int col = nt * 8 + 2 * t;
      x[nt >> 1][(nt & 1) * 2] =
          pack_bf16(fmaxf(sh_lo[col] + d[0], 0.f),
                    fmaxf(sh_lo[col + 1] + d[1], 0.f));
      x[nt >> 1][(nt & 1) * 2 + 1] =
          pack_bf16(fmaxf(sh_hi[col] + d[2], 0.f),
                    fmaxf(sh_hi[col + 1] + d[3], 0.f));
    }
    // layer 2 in two halves of 32 columns, each feeding its two k-tiles
    // of layer 3 (fewer live registers; the same sums in the same order)
    float z[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float d2[4][4];
#pragma unroll
      for (int nn = 0; nn < 4; ++nn)
        d2[nn][0] = d2[nn][1] = d2[nn][2] = d2[nn][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int nn = 0; nn < 4; ++nn)
          mma_bf16(d2[nn], x[kk],
                   s.w2f[(kk * 8 + half * 4 + nn) * 32 + lane]);
      uint32_t y[2][4];
#pragma unroll
      for (int nn = 0; nn < 4; ++nn) {
        y[nn >> 1][(nn & 1) * 2] =
            pack_bf16(fmaxf(d2[nn][0], 0.f), fmaxf(d2[nn][1], 0.f));
        y[nn >> 1][(nn & 1) * 2 + 1] =
            pack_bf16(fmaxf(d2[nn][2], 0.f), fmaxf(d2[nn][3], 0.f));
      }
#pragma unroll
      for (int q = 0; q < 2; ++q)
        mma_bf16(z, y[q], s.w3f[(2 * half + q) * 32 + lane]);
    }
    // the sigmoid; lanes t = 0, 1 hold columns 0-1 and 2
    if (t < 2) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = t0 + gq + (e >> 1) * 8, col = 2 * t + (e & 1);
        if (row < m && col < 3)
          s.rgb[row * 3 + col] = 1.f / (1.f + expf(-z[e]));
      }
    }
  }
}

template <int L, bool LERP>
__device__ void field_pass(const Args& a, Smem& s, int m) {
  if constexpr (L == RGBA)
    rgba_pass(a, s, m);
  else
    mlp_pass<L, LERP>(a, s, m);
}

// The tile's rays and its starting state: its `out` rows (CARRY: they
// hold init) or zero.  Returns, block-uniform, whether any ray is alive
// (tau < tau_max); from zero every ray is.
template <bool CARRY>
__device__ bool tile_start(const Args& a, Smem& s, int64_t r0) {
  bool alive = !CARRY;
  for (int e = threadIdx.x; e < TPX * 8; e += NT) {
    s.ray[e] = a.rays[r0 * 8 + e];
    const float v = CARRY ? a.out[r0 * 8 + e] : 0.f;
    s.st[e] = v;
    if (CARRY && (e & 7) == 0 && v < a.tau_max) alive = true;
  }
  return __syncthreads_or(alive);
}

// The MLP weights as bf16 B fragments and the sh half of layer 1 for the
// tile's 64 rays.
__device__ void stage(const Args& a, Smem& s, int64_t r0) {
  const int x = threadIdx.x;
  for (int e = x; e < 8 * 32; e += NT)
    s.w1f[e] = b_frag(a.w1 + FEAT * HID, HID, HID, 0, (e >> 5) * 8, e & 31);
  for (int e = x; e < 32 * 32; e += NT) {
    const int f = e >> 5;
    s.w2f[e] = b_frag(a.w2, HID, HID, (f >> 3) * 16, (f & 7) * 8, e & 31);
  }
  for (int e = x; e < 4 * 32; e += NT)
    s.w3f[e] = b_frag(a.w3, 3, 3, (e >> 5) * 16, 0, e & 31);
  if (x < 4 * 32) {   // sh half of layer 1: warp w takes rays 16w .. 16w+15
    const int lane = x & 31, gq = lane >> 2, t = lane & 3;
    const int row = 16 * (x >> 5) + gq;
    const float* s0 = a.sh + (r0 + row) * FEAT + 2 * t;
    const float* s8 = s0 + 8 * FEAT;
    const uint32_t af[4] = {pack_bf16(s0[0], s0[1]), pack_bf16(s8[0], s8[1]),
                            pack_bf16(s0[8], s0[9]), pack_bf16(s8[8], s8[9])};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      float d[4] = {0.f, 0.f, 0.f, 0.f};
      mma_bf16(d, af, b_frag(a.w1, HID, HID, 0, nt * 8, lane));
      float* o = s.a1sh + row * A1_STRIDE + nt * 8 + 2 * t;
      o[0] = d[0];
      o[1] = d[1];
      o[8 * A1_STRIDE] = d[2];
      o[8 * A1_STRIDE + 1] = d[3];
    }
  }
  __syncthreads();
}

// List rows row0 .. row0 + nb - 1 (nb <= G) into the tile's state, in
// list order.  Returns, block-uniform, whether any ray is still alive.
template <int L, bool LERP>
__device__ bool batch(const Args& a, Smem& s, int64_t row0, int nb) {
  const int x = threadIdx.x, r = x & (TPX - 1), g = x >> 6;
  const float* ray = s.ray + r * 8;

  // 1. slab test and the sum of sigma*dt of pair (r, g)
  const int64_t row = row0 + g;
  int64_t pb = -1;
  if (g < nb && row >= 0 && row < a.n_rows) pb = a.pool_blk[row];
  if (pb >= a.n_blocks) pb = -1;
  float box[6];
  int cnt = 0;
  float n0 = 0.f, run = 0.f;
  if (pb >= 0) {
#pragma unroll
    for (int k = 0; k < 6; ++k) box[k] = a.meta[row * 8 + k];
    if (r == 0) {
#pragma unroll
      for (int k = 0; k < 6; ++k) s.box[g * 6 + k] = box[k];
    }
    const float t1 = ray[6], t2 = ray[7];
    float ta = t1, tb = t2;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float d = ray[3 + k];
      const float dd = fabsf(d) > 1e-10f ? d : (d >= 0.f ? 1e-10f : -1e-10f);
      const float inv = 1.f / dd;
      const float p = (box[k] - ray[k]) * inv;
      const float pq = (box[3 + k] - ray[k]) * inv;
      ta = fmaxf(ta, fminf(p, pq));
      tb = fminf(tb, fmaxf(p, pq));
    }
    n0 = fmaxf(ceilf((ta - t1) / a.dt - 0.5f), 0.f);
    const float n1 = floorf((tb - t1) / a.dt - 0.5f);
    if ((tb > ta) && (n1 >= n0) && (t2 > 0.f))
      cnt = (int)fminf(n1 - n0 + 1.f, (float)a.S);
    // rays dead at the batch start stay dead: no sigma for them.  The
    // loads of SIGMA_ILP samples go out together; run sums in order.
    if (cnt > 0 && s.st[r * 8] < a.tau_max)
      for (int j0 = 0; j0 < cnt; j0 += SIGMA_ILP) {
        float sd[SIGMA_ILP];
#pragma unroll
        for (int u = 0; u < SIGMA_ILP; ++u)
          sd[u] = j0 + u < cnt
                      ? sample_sigma<L, LERP>(a, ray, n0 + (float)(j0 + u),
                                              box, pb)
                      : 0.f;
#pragma unroll
        for (int u = 0; u < SIGMA_ILP; ++u)
          if (j0 + u < cnt) run += sd[u];
      }
  }
  if (r == 0) s.pb[g] = (int)pb;
  s.n0[x] = n0;
  s.cnt[x] = cnt;
  s.run[x] = run;
  __syncthreads();

  // 2. the live gate, slot by slot in list order, per ray
  bool alive = false;
  if (x < TPX) {
    float* st = s.st + x * 8;
#pragma unroll 1
    for (int k = 0; k < G; ++k) {
      const int i = k * TPX + x;
      float tbef = -1.f;
      if (s.cnt[i] > 0 && st[0] < a.tau_max) {
        tbef = expf(-st[0]);
        st[0] += s.run[i];
        st[5] += 1.f;
      }
      s.tb[i] = tbef;
    }
    alive = st[0] < a.tau_max;
  }
  const bool any_alive = __syncthreads_or(alive);

  // 3. list the live pairs' samples; field and composite in passes
  const bool live = s.tb[x] >= 0.f;
  const int c = live ? cnt : 0;
  int M;
  const int off = block_scan(c, s, &M);
  float run_c = 0.f, cr = 0.f, cg = 0.f, cb = 0.f, dep = 0.f;
  for (int p0 = 0; p0 < M; p0 += CAP) {
    const int m = min(M - p0, CAP);
    const int lo = max(off, p0), hi = min(off + c, p0 + m);
    for (int k = lo; k < hi; ++k) s.desc[k - p0] = ((k - off) << 10) | x;
    __syncthreads();
    field_pass<L, LERP>(a, s, m);
    __syncthreads();
    for (int k = lo; k < hi; ++k) {
      const float sd = s.sd[k - p0];
      const float* cc = s.rgb + (k - p0) * 3;
      const float w = expf(-run_c) * (1.f - expf(-sd));
      cr += w * cc[0];
      cg += w * cc[1];
      cb += w * cc[2];
      dep += w * (ray[6] + ((n0 + (float)(k - off)) + 0.5f) * a.dt);
      run_c += sd;
    }
    __syncthreads();   // the next pass rewrites desc, sd and rgb
  }
  s.acc[x * 4 + 0] = cr;
  s.acc[x * 4 + 1] = cg;
  s.acc[x * 4 + 2] = cb;
  s.acc[x * 4 + 3] = dep;
  __syncthreads();

  // 4. the live pairs' colour and depth into the state, in list order
  if (x < TPX) {
    float* st = s.st + x * 8;
#pragma unroll 1
    for (int k = 0; k < G; ++k) {
      const int i = k * TPX + x;
      const float tbef = s.tb[i];
      if (tbef >= 0.f) {
        st[1] += tbef * s.acc[i * 4 + 0];
        st[2] += tbef * s.acc[i * 4 + 1];
        st[3] += tbef * s.acc[i * 4 + 2];
        st[4] += tbef * s.acc[i * 4 + 3];
      }
    }
  }
  return any_alive;
}

__device__ void tile_end(const Args& a, Smem& s, int64_t r0) {
  __syncthreads();
  for (int e = threadIdx.x; e < TPX * 8; e += NT) a.out[r0 * 8 + e] = s.st[e];
}

// K2-K5: one block per entry of tid; tile tid[b] walks list rows lbase[b]
// + l, l < min(nslots[b], Lcall), G slots at a time, from its carried
// state (CARRY) or from zero.
template <int L, bool CARRY, bool LERP>
__device__ void tiles_body(const Args& a, const int32_t* tid,
                           const int32_t* lbase, const int32_t* nslots,
                           int Lcall) {
  Smem& s = smem();
  const int b = blockIdx.x;
  const int tile = tid[b];
  if (tile < 0 || tile >= a.T) return;
  const int n = min(nslots[b], Lcall);
  if (CARRY && n <= 0) return;           // no slot: the rows keep init
  const int64_t r0 = (int64_t)tile * TPX;
  if (!tile_start<CARRY>(a, s, r0)) return;   // every carried ray dead
  if constexpr (L != RGBA) {               // K5 has no MLP to stage
    if (n > 0) stage(a, s, r0);
  }
  for (int base = 0; base < n; base += G)
    if (!batch<L, LERP>(a, s, (int64_t)lbase[b] + base, min(G, n - base)))
      break;   // every ray saturated: later slots add nothing
  tile_end(a, s, r0);
}

// K3: row pool.  Registers capped for two blocks of 512 threads per SM
// (a few spilled bytes; faster than one block on the card).
__global__ void __launch_bounds__(NT, 2)
brick_field_n_kernel(Args a, const int32_t* tid, const int32_t* lbase,
                     const int32_t* nslots, int Lcall) {
  tiles_body<ROWS, false, false>(a, tid, lbase, nslots, Lcall);
}

// K4: transposed pool.  Its 64 scattered loads a lane need registers:
// capped at K3's count it spills and runs slower, so one 512-thread block
// per SM.
__global__ void __launch_bounds__(NT, 1)
brick_field_t_kernel(Args a, const int32_t* tid, const int32_t* lbase,
                     const int32_t* nslots, int Lcall) {
  tiles_body<LANES, false, true>(a, tid, lbase, nslots, Lcall);
}

// K2: row pool, from the carry.
__global__ void __launch_bounds__(NT, 2)
brick_field_tp_kernel(Args a, const int32_t* tid, const int32_t* lbase,
                      const int32_t* nslots, int Lcall) {
  tiles_body<ROWS, true, true>(a, tid, lbase, nslots, Lcall);
}

// K5: pre-shaded pool, from the carry.  Its ~40 KiB of shared memory
// would let four 512-thread blocks share an SM, but capped for three (40
// registers) or four (32) it spills and runs slower on the card than at
// two (64, no spill; PERF.md has the times).
__global__ void __launch_bounds__(NT, 2)
brick_field_rgba_kernel(Args a, const int32_t* tid, const int32_t* lbase,
                        const int32_t* nslots, int Lcall) {
  tiles_body<RGBA, true, true>(a, tid, lbase, nslots, Lcall);
}

// K1: one block per worklist step.  A block at a tile's first step (wf ==
// 1) renders the tile's run of consecutive steps from its carry; the rest
// return.  The run is scanned NT steps at a time in parallel, so a long
// tail of pad steps costs one load per thread, not a serial walk.
__global__ void __launch_bounds__(NT, 2)
brick_field_wl_kernel(Args a, const int32_t* wt, const int32_t* wl,
                      const int32_t* wn, const int32_t* wf, int Ns, int P) {
  __shared__ int c_wl[NT], c_wn[NT], c_end;
  Smem& s = smem();
  const int j0 = blockIdx.x;
  if (wf[j0] != 1) return;
  const int tile = wt[j0];
  if (tile < 0 || tile >= a.T) return;
  const int64_t r0 = (int64_t)tile * TPX;
  if (!tile_start<true>(a, s, r0)) return;    // every carried ray dead
  bool staged = false, alive = true;
  for (int base = j0; alive; base += NT) {
    const int j = base + threadIdx.x;
    const bool end = j >= Ns || (j > j0 && (wt[j] != tile || wf[j] == 1));
    if (threadIdx.x == 0) c_end = NT;
    __syncthreads();
    if (end) {
      atomicMin(&c_end, (int)threadIdx.x);
    } else {
      c_wl[threadIdx.x] = wl[j];
      c_wn[threadIdx.x] = min(wn[j], P);
    }
    __syncthreads();
    const int n_steps = c_end;
    for (int t = 0; t < n_steps && alive; ++t)
      for (int k = 0; k < c_wn[t] && alive; k += G) {
        if (!staged) {       // the first slot of the run
          stage(a, s, r0);
          staged = true;
        }
        alive = batch<ROWS, true>(a, s, (int64_t)c_wl[t] + k,
                                  min(G, c_wn[t] - k));
      }
    if (n_steps < NT) break;
    __syncthreads();         // the next scan rewrites c_wl, c_wn, c_end
  }
  if (staged) tile_end(a, s, r0);   // else no slot: the rows keep init
}

template <typename K>
int set_smem(K kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

int launch(void (*kernel)(Args, const int32_t*, const int32_t*,
                          const int32_t*, int),
           size_t bytes, const Args& a, const int32_t* tid,
           const int32_t* lbase, const int32_t* nslots, int Tb, int Lcall,
           void* stream) {
  const int err = set_smem(kernel, bytes);
  if (err) return err;
  if (Tb == 0) return 0;
  kernel<<<Tb, NT, bytes, (cudaStream_t)stream>>>(a, tid, lbase, nslots,
                                                  Lcall);
  return (int)cudaGetLastError();
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

}  // namespace

extern "C" {

const char* brick_field_dense_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

#define DENSE_ENTRY(NAME, KERNEL)                                            \
  int NAME(const int32_t* pool_blk, const float* meta, int64_t n_rows,       \
           const float* rays, const float* sh, const void* pool,             \
           int64_t n_blocks, const float* w1, const float* w2,               \
           const float* w3, float* out, int T, const int32_t* tid,           \
           const int32_t* lbase, const int32_t* nslots, int Tb, int Lcall,   \
           int S, float dt, float tau_max, int Bk, void* stream) {           \
    const Args a = make_args(pool_blk, meta, n_rows, rays, sh, pool,         \
                             n_blocks, w1, w2, w3, out, T, S, dt, tau_max,   \
                             Bk);                                            \
    return launch(KERNEL, sizeof(Smem), a, tid, lbase, nslots, Tb, Lcall,    \
                  stream);                                                   \
  }

DENSE_ENTRY(brick_field_tp, brick_field_tp_kernel)
DENSE_ENTRY(brick_field_n, brick_field_n_kernel)
DENSE_ENTRY(brick_field_t, brick_field_t_kernel)

int brick_field_rgba(const int32_t* pool_blk, const float* meta,
                     int64_t n_rows, const float* rays, const void* pool,
                     int64_t n_blocks, float* out, int T, const int32_t* tid,
                     const int32_t* lbase, const int32_t* nslots, int Tb,
                     int Lcall, int S, float dt, float tau_max, int Bk,
                     void* stream) {
  const Args a = make_args(pool_blk, meta, n_rows, rays, nullptr, pool,
                           n_blocks, nullptr, nullptr, nullptr, out, T, S,
                           dt, tau_max, Bk);
  return launch(brick_field_rgba_kernel, SMEM_RGBA, a, tid, lbase, nslots,
                Tb, Lcall, stream);
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
  const int err = set_smem(brick_field_wl_kernel, sizeof(Smem));
  if (err) return err;
  if (Ns == 0) return 0;
  brick_field_wl_kernel<<<Ns, NT, sizeof(Smem), (cudaStream_t)stream>>>(
      a, wt, wl, wn, wf, Ns, P);
  return (int)cudaGetLastError();
}

}  // extern "C"
