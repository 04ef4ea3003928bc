// zlib decompression of ScanNet .sens depth frames, one buffer or many
// on a pool of threads (the port's copy of the JAX package's helper).
// Host code with a plain C interface, loaded with ctypes by
// google_nerf_tpu_torch/scannet_tools/native.py; ops/cuda/_build.py builds
// it at first use with g++ -O3 -fPIC -std=c++17 -shared ... -lz -lpthread.

#include <zlib.h>

#include <atomic>
#include <cstdint>
#include <thread>
#include <vector>

extern "C" {

// Decompress one zlib buffer. Returns decompressed size, or -zlib_error.
int64_t sens_zlib_decompress(const uint8_t* src, int64_t src_len,
                             uint8_t* dst, int64_t dst_cap) {
  uLongf dlen = static_cast<uLongf>(dst_cap);
  int r = uncompress(dst, &dlen, src, static_cast<uLong>(src_len));
  if (r != Z_OK) return -static_cast<int64_t>(r == 0 ? 1 : -r);
  return static_cast<int64_t>(dlen);
}

// Decompress n buffers concurrently.
//   srcs/src_lens: per-item compressed data
//   dst: contiguous output, item i at dst + i*dst_stride
//   out_lens[i]: decompressed size or negative zlib error
// Returns 0 on success, number of failed items otherwise.
int64_t sens_zlib_decompress_batch(const uint8_t** srcs,
                                   const int64_t* src_lens, int64_t n,
                                   uint8_t* dst, int64_t dst_stride,
                                   int64_t* out_lens, int64_t n_threads) {
  if (n_threads <= 0) n_threads = 1;
  if (n_threads > n) n_threads = n;
  std::atomic<int64_t> next(0);
  std::atomic<int64_t> failed(0);
  auto worker = [&]() {
    for (;;) {
      int64_t i = next.fetch_add(1);
      if (i >= n) break;
      int64_t r = sens_zlib_decompress(srcs[i], src_lens[i],
                                       dst + i * dst_stride, dst_stride);
      out_lens[i] = r;
      if (r < 0) failed.fetch_add(1);
    }
  };
  std::vector<std::thread> threads;
  threads.reserve(static_cast<size_t>(n_threads));
  for (int64_t t = 0; t < n_threads; ++t) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
  return failed.load();
}

}  // extern "C"
