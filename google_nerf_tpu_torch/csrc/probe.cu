// Tool probes P1-P4 for Hopper (sm_90a): a row gather from a table held
// in device memory, a row scatter-add, and a row gather made of one bulk
// copy (TMA) per row.  Built with nvcc into a shared library with a plain
// C interface and loaded through ctypes by
// google_nerf_tpu_torch/ops/cuda/probe.py, which also holds the plain
// PyTorch versions these kernels are tested against.  The tool that runs
// them is google_nerf_tpu_torch/tools/kernel_probe.py.
//
// What they replace (tools/pallas_probe.py, probes of the TPU toolchain)
//   gather_rows_kernel      <- `call`/`kern` (P1, :39-53, f32) and
//                              `callb`/`kernb` (P2, :74-88, bf16): out[i] =
//                              tab[idx[i]] with the whole table in VMEM
//   scatter_add_rows_kernel <- `scall`/`skern` (P3, :113-130): out =
//                              zeros(T, F); out[sidx[i]] += vals[i], one
//                              scalar loop in index order
//   gather_rows_bulk_kernel <- `ccall`/`ckern` (P4, :155-172): out[g] =
//                              tab[idx[g]], one row DMA per grid step with
//                              scalar-prefetched indices
//
// What bounds them on the H100 (3.35 TB/s; no arithmetic to speak of)
//   P1/P2: bytes.  idx read once, the output written once and each
//   distinct table row read once: at the tool's sizes (T = 65536 rows of
//   F = 32, N = 1M lookups) ~4.2 + 134.2 + 8.4 MB = 146.8 MB, ~44 us for
//   f32; ~4.2 + 67.1 + 4.2 MB, ~22 us for bf16.
//   P3: bytes.  vals (16.8 MB) and sidx (0.5 MB) read once and the
//   (T, F) f32 output (8.4 MB) written once, ~7.7 us; the fill and the
//   adds both land in the 50 MB L2.
//   P4: bytes.  At NC = 16384 rows of 128 B, ~2.2 MB in all (~0.7 us):
//   latency, not bandwidth, decides its time.
//
// What the designs do about it
//   * P1/P2.  The TPU kernel holds the whole table (8 MiB f32, 4 MiB bf16)
//     as one VMEM block; a Hopper block has 227 KB of shared memory.  The
//     table stays in device memory, where it sits in L2 after its first
//     touch, and each thread copies one 16-byte word of a row (8 threads
//     per 128-byte f32 row, 4 per 64-byte bf16 row), so a warp's loads
//     and stores are whole rows.  A gather is a byte copy, so the f32 and
//     bf16 probes are one kernel; the wrapper raises on rows that are not
//     a multiple of 16 bytes.
//   * P3.  The scalar loop adds in index order on one core, after
//     zeroing its output as `skern` does.  Here the C entry owns that fill
//     too: a cudaMemsetAsync of the output on the call's stream, then one
//     launch of the adds, where a thread adds one 16-byte word of a
//     contribution row with one vector reduction (atomicAdd on a float4,
//     red.global.add.v4.f32 in L2): a quarter of the scalar reductions.
//     A word cut short by F, or whose vals or out address is not 16-byte
//     aligned, adds its floats one by one: a branch of the same kernel,
//     not a path chosen on the host.  The order of each row's sums, and
//     their last bits, change from run to run.  One cooperative launch
//     (fill, a grid barrier, then the adds) was measured against this and
//     lost (PERF.md).  What stops it: the adds read vals (16.8 MB) and
//     land 1.05M reductions in L2, the memset writes 8.4 MB, and the two
//     run one after the other.
//   * P4.  The row DMA becomes a 1-D bulk copy (cp.async.bulk) per row
//     into shared memory.  A warp owns 32 consecutive output rows: each
//     lane loads its own index and issues its own row's copy, so 32 copies
//     go out at once, completing on the warp's own mbarrier.  Lane 0's
//     single arrival carries the expected bytes of all the warp's rows, so
//     the phase cannot complete early even if a copy lands first.  The
//     warp's tile goes out as one bulk store (cp.async.bulk to global),
//     with no register round trip; lane 0 waits for its read before the
//     warp exits.  Two warps a block: 1 and 4 were measured within 2%
//     (PERF.md), and four would need the shared-memory opt-in at 512-byte
//     rows.  What stops it: one chain of latencies a warp (index load, row
//     copies, store) on top of the launch; each step waits for the one
//     before.  A bulk copy needs 16-byte-aligned addresses and a multiple
//     of 16 bytes; the wrapper raises on rows that do not qualify.
//   * Indices come as int32, as JAX's do; an index outside the table
//     trips a device-side assert before any copy or add uses it, as
//     index_select's does.

#include <assert.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 256;
constexpr int BULK_WARPS = 2;       // P4 warps a block, 32 rows each
constexpr int BULK_ROWS = 32 * BULK_WARPS;
constexpr int BULK_MAX_ROW_BYTES = 512;
static_assert(BULK_ROWS * BULK_MAX_ROW_BYTES <= 48 * 1024,
              "P4's tile must fit without the shared-memory opt-in");

// P1/P2: thread g copies 16-byte word g % words of output row g / words.
__global__ void gather_rows_kernel(const uint4* __restrict__ tab,
                                   const int32_t* __restrict__ idx,
                                   uint4* __restrict__ out, uint32_t n_words,
                                   uint32_t words, int32_t t_rows) {
  const uint32_t g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= n_words) return;
  const uint32_t i = g / words;
  const int32_t j = __ldg(idx + i);
  assert(j >= 0 && j < t_rows);
  out[g] = __ldg(tab + (size_t)j * words + (g - i * words));
}

// P3: thread g adds word g, floats [e, e + 4) of contribution row i (g =
// i * words + e / 4), into out row idx[i]: one float4 reduction where the
// word is whole and both its addresses are 16-byte aligned, else one float
// at a time.
__global__ void __launch_bounds__(NTHREADS)
scatter_add_rows_kernel(const int32_t* __restrict__ idx,
                        const float* __restrict__ vals,
                        float* __restrict__ out, uint32_t n_items,
                        uint32_t words, uint32_t f, int32_t t_rows) {
  const uint32_t g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= n_items) return;
  const uint32_t i = g / words, e = 4 * (g - i * words);
  const int32_t j = __ldg(idx + i);
  assert(j >= 0 && j < t_rows);
  const float* src = vals + (size_t)i * f + e;
  float* dst = out + (size_t)j * f + e;
  if (e + 4 <= f && ((uintptr_t)src | (uintptr_t)dst) % 16 == 0) {
    atomicAdd(reinterpret_cast<float4*>(dst),
              __ldg(reinterpret_cast<const float4*>(src)));
  } else {
    for (uint32_t k = 0; k < 4 && e + k < f; ++k)
      atomicAdd(dst + k, __ldg(src + k));
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// P4: warp w of the block owns output rows [r0, r0 + nr), nr <= 32; lane
// l brings row r0 + l into the warp's tile by its own bulk copy, and lane
// 0 stores the whole tile with one bulk copy once the warp's barrier
// reports every byte in.
__global__ void __launch_bounds__(32 * BULK_WARPS)
gather_rows_bulk_kernel(const char* __restrict__ tab,
                        const int32_t* __restrict__ idx,
                        char* __restrict__ out, int32_t n,
                        int32_t row_bytes, int32_t t_rows) {
  extern __shared__ __align__(128) char tile[];   // BULK_ROWS rows
  __shared__ __align__(8) uint64_t bar[BULK_WARPS];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int32_t r0 = blockIdx.x * BULK_ROWS + warp * 32;
  if (r0 >= n) return;                // the whole warp: no block barrier
  const int32_t nr = min(32, n - r0);
  char* wtile = tile + warp * 32 * row_bytes;
  const uint32_t bar_a = smem_addr(&bar[warp]);
  int32_t j = 0;
  if (lane < nr) j = __ldg(idx + r0 + lane);
  if (lane == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar_a)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 ::"r"(bar_a), "r"(nr * row_bytes) : "memory");
  }
  __syncwarp();
  if (lane < nr) {
    assert(j >= 0 && j < t_rows);
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];\n"
        ::"r"(smem_addr(wtile + lane * row_bytes)),
          "l"(tab + (size_t)j * row_bytes), "r"(row_bytes), "r"(bar_a)
        : "memory");
  }
  if (lane != 0) return;
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar_a) : "memory");
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               ::"l"(out + (size_t)r0 * row_bytes), "r"(smem_addr(wtile)),
                 "r"(nr * row_bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

unsigned blocks(uint64_t n, unsigned per) {
  return (unsigned)((n + per - 1) / per);
}

}  // namespace

extern "C" {

const char* probe_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// P1/P2.  tab (t_rows, row_bytes) and out (n, row_bytes) of any element
// type, row_bytes a multiple of 16 and both pointers 16-byte aligned.
// n * row_bytes < 2^36.
int probe_gather_rows(const void* tab, int32_t t_rows, int32_t row_bytes,
                      const int32_t* idx, int64_t n, void* out,
                      void* stream) {
  const uint64_t words = (uint64_t)n * (row_bytes / 16);
  if (n == 0) return 0;
  if (((uintptr_t)tab | (uintptr_t)out | row_bytes) % 16 || row_bytes <= 0
      || words >= (1ull << 32))
    return cudaErrorInvalidValue;
  gather_rows_kernel<<<blocks(words, NTHREADS), NTHREADS, 0,
                       (cudaStream_t)stream>>>(
      (const uint4*)tab, idx, (uint4*)out, (uint32_t)words,
      (uint32_t)(row_bytes / 16), t_rows);
  return (int)cudaGetLastError();
}

// P3.  out (t_rows, f) f32 of any content: the entry zeroes it on the
// stream (cudaMemsetAsync), then launches the kernel if there is anything
// to add; vals (n, f) f32.  n * f < 2^31.
int probe_scatter_add_rows(const int32_t* idx, int64_t n, const float* vals,
                           int32_t f, float* out, int32_t t_rows,
                           void* stream) {
  const uint64_t n_vals = (uint64_t)n * f;
  if (f < 0 || t_rows < 0 || n_vals >= (1ull << 31))
    return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t err = cudaMemsetAsync(
      out, 0, (size_t)t_rows * f * sizeof(float), s);
  if (err || n_vals == 0) return (int)err;
  const uint32_t words = (uint32_t)(f + 3) / 4, n_items = (uint32_t)n * words;
  scatter_add_rows_kernel<<<blocks(n_items, NTHREADS), NTHREADS, 0, s>>>(
      idx, vals, out, n_items, words, (uint32_t)f, t_rows);
  return (int)cudaGetLastError();
}

// P4.  As P1, with row_bytes a multiple of 16 of at most
// BULK_MAX_ROW_BYTES and both pointers 16-byte aligned.
int probe_gather_rows_bulk(const void* tab, int32_t t_rows,
                           int32_t row_bytes, const int32_t* idx, int64_t n,
                           void* out, void* stream) {
  if (n == 0) return 0;
  if (((uintptr_t)tab | (uintptr_t)out | row_bytes) % 16 || row_bytes <= 0
      || row_bytes > BULK_MAX_ROW_BYTES || n >= (1ll << 31))
    return cudaErrorInvalidValue;
  gather_rows_bulk_kernel<<<blocks(n, BULK_ROWS), 32 * BULK_WARPS,
                            BULK_ROWS * row_bytes, (cudaStream_t)stream>>>(
      (const char*)tab, idx, (char*)out, (int32_t)n, row_bytes, t_rows);
  return (int)cudaGetLastError();
}

int probe_bulk_max_row_bytes(void) { return BULK_MAX_ROW_BYTES; }

}  // extern "C"
