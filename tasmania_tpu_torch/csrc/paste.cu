// In-place x-edge paste of N same-shape arrays in one launch.
//
// Replaces: tasmania_tpu/ops/paste.py:67 paste_x_edges_multi (pallas_call at
// :102), which aliases each (nx, ny, nz) array to its output and writes only
// the two nb-wide edge blocks.
//
// Bound on the H100: bytes.  Columns [0, w) and [nx-w, nx) of an (nx, ny, nz)
// C-contiguous array are two contiguous runs of w*ny*nz elements, so the paste
// is 2*N memcpy-like streams: read the strip, write the edge (at the flagship
// 6 arrays x 2 strips x 3*161*120 f32 = 2.8 MB each way).  Design: one thread
// per element, k fastest, blockIdx.y picks the array; the pointers (fulls,
// lows, highs) ride in the kernel arguments, so a launch needs no copy to the
// device and never waits on it.

#include "common.cuh"

namespace {

constexpr int kMaxArrays = 16;

template <typename T>
struct PastePtrs {
  T* full[kMaxArrays];
  const T* lo[kMaxArrays];
  const T* hi[kMaxArrays];
};

template <typename T>
__global__ void paste_kernel(PastePtrs<T> ptrs, int64_t strip, int64_t hi_offset) {
  const int a = blockIdx.y;
  T* full = ptrs.full[a];
  const T* lo = ptrs.lo[a];
  const T* hi = ptrs.hi[a];
  for (int64_t e = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; e < 2 * strip;
       e += int64_t(gridDim.x) * blockDim.x) {
    if (e < strip) {
      full[e] = lo[e];
    } else {
      full[hi_offset + e - strip] = hi[e - strip];
    }
  }
}

template <typename T>
int launch(void* const* fulls, const void* const* lows, const void* const* highs, int n, int nx,
           int ny, int nz, int w, cudaStream_t stream) {
  PastePtrs<T> ptrs{};
  for (int a = 0; a < n; ++a) {
    ptrs.full[a] = static_cast<T*>(fulls[a]);
    ptrs.lo[a] = static_cast<const T*>(lows[a]);
    ptrs.hi[a] = static_cast<const T*>(highs[a]);
  }
  const int64_t strip = int64_t(w) * ny * nz;
  const int64_t hi_offset = int64_t(nx - w) * ny * nz;
  const int threads = 256;
  int64_t blocks = (2 * strip + threads - 1) / threads;
  if (blocks > 4096) blocks = 4096;
  dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(n));
  paste_kernel<T><<<grid, threads, 0, stream>>>(ptrs, strip, hi_offset);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" int tt_paste_x_edges_multi(int dtype, void* const* fulls, const void* const* lows,
                                      const void* const* highs, int n, int nx, int ny, int nz,
                                      int w, cudaStream_t stream) {
  if (n < 1 || n > kMaxArrays) return int(cudaErrorInvalidValue);
  if (dtype == tt::kFloat32) return launch<float>(fulls, lows, highs, n, nx, ny, nz, w, stream);
  return launch<double>(fulls, lows, highs, n, nx, ny, nz, w, stream);
}
