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
//   (T, F) f32 output (8.4 MB) written once, ~7.7 us; the wrapper's zero
//   fill writes the output once more.
//   P4: bytes.  At NC = 16384 rows of 128 B, ~2.2 MB in all (~0.7 us):
//   latency, not bandwidth, decides its time.
//
// What this simple design does about it
//   * The TPU kernel holds the whole table (8 MiB f32, 4 MiB bf16) as one
//     VMEM block; a Hopper block has 227 KB of shared memory.  The table
//     stays in device memory, where it sits in the 50 MB L2 after its
//     first touch, and each thread copies one 16-byte word of a row (8
//     threads per 128-byte f32 row, 4 per 64-byte bf16 row), so a warp's
//     loads and stores are whole rows.  A gather is a byte copy, so the
//     f32 and bf16 probes are one kernel; the wrapper raises on rows
//     that are not a multiple of 16 bytes.
//   * P3's scalar loop adds in index order on one core.  Here every
//     (contribution, feature) pair is one thread's atomicAdd into device
//     memory (a RED in L2), so the order of the sums, and their last
//     bits, change from run to run.  The wrapper allocates the zeroed
//     output; the kernel allocates nothing.
//   * P4's row DMA becomes a 1-D bulk copy (cp.async.bulk) per row into
//     shared memory, issued by one thread for the block's 64 rows and
//     completing on an mbarrier, then a coalesced store of the tile.  A
//     bulk copy needs 16-byte-aligned addresses and a multiple of 16
//     bytes; the wrapper raises on rows that do not qualify.
//   * Indices come as int32, as JAX's do; an index outside the table
//     trips a device-side assert, as index_select's does.
//   Wider vector atomics and a persistent grid are later work.

#include <assert.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 256;
constexpr int BULK_ROWS = 64;       // P4 rows per block
constexpr int BULK_THREADS = 128;
constexpr int BULK_MAX_ROW_BYTES = 512;   // a 32 KiB tile: no opt-in needed

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

// P3: thread g adds feature g % f of contribution g / f.
__global__ void scatter_add_rows_kernel(const int32_t* __restrict__ idx,
                                        const float* __restrict__ vals,
                                        float* __restrict__ out,
                                        uint32_t n_vals, uint32_t f,
                                        int32_t t_rows) {
  const uint32_t g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= n_vals) return;
  const uint32_t i = g / f;
  const int32_t j = __ldg(idx + i);
  assert(j >= 0 && j < t_rows);
  atomicAdd(out + (size_t)j * f + (g - i * f), __ldg(vals + g));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// P4: the block's rows arrive by one bulk copy each on one mbarrier.
__global__ void gather_rows_bulk_kernel(const char* __restrict__ tab,
                                        const int32_t* __restrict__ idx,
                                        char* __restrict__ out, int32_t n,
                                        int32_t row_bytes, int32_t t_rows) {
  extern __shared__ __align__(128) char tile[];   // BULK_ROWS rows
  __shared__ __align__(8) uint64_t bar;
  __shared__ int32_t rows[BULK_ROWS];
  const int32_t r0 = blockIdx.x * BULK_ROWS;
  const int32_t nr = min(BULK_ROWS, n - r0);
  const uint32_t bar_a = smem_addr(&bar);
  if ((int)threadIdx.x < nr) {
    const int32_t j = __ldg(idx + r0 + threadIdx.x);
    assert(j >= 0 && j < t_rows);
    rows[threadIdx.x] = j;
  }
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar_a)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 ::"r"(bar_a), "r"(nr * row_bytes) : "memory");
    for (int r = 0; r < nr; ++r) {
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], %2, [%3];\n"
          ::"r"(smem_addr(tile + r * row_bytes)),
            "l"(tab + (size_t)rows[r] * row_bytes), "r"(row_bytes),
            "r"(bar_a)
          : "memory");
    }
  }
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar_a) : "memory");
  }
  const uint4* src = reinterpret_cast<const uint4*>(tile);
  uint4* dst = reinterpret_cast<uint4*>(out + (size_t)r0 * row_bytes);
  const int words = nr * row_bytes / 16;
  for (int w = threadIdx.x; w < words; w += BULK_THREADS) dst[w] = src[w];
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

// P3.  out (t_rows, f) f32, zeroed by the caller; vals (n, f) f32.
// n * f < 2^31.
int probe_scatter_add_rows(const int32_t* idx, int64_t n, const float* vals,
                           int32_t f, float* out, int32_t t_rows,
                           void* stream) {
  const uint64_t n_vals = (uint64_t)n * f;
  if (n_vals == 0) return 0;
  if (n_vals >= (1ull << 31)) return cudaErrorInvalidValue;
  scatter_add_rows_kernel<<<blocks(n_vals, NTHREADS), NTHREADS, 0,
                            (cudaStream_t)stream>>>(
      idx, vals, out, (uint32_t)n_vals, (uint32_t)f, t_rows);
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
  gather_rows_bulk_kernel<<<blocks(n, BULK_ROWS), BULK_THREADS,
                            BULK_ROWS * row_bytes, (cudaStream_t)stream>>>(
      (const char*)tab, idx, (char*)out, (int32_t)n, row_bytes, t_rows);
  return (int)cudaGetLastError();
}

int probe_bulk_max_row_bytes(void) { return BULK_MAX_ROW_BYTES; }

}  // extern "C"
