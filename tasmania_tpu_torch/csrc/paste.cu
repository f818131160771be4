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
// per element, k fastest, blockIdx.y picks the array; the pointer table
// (fulls, lows, highs) lives on the device so one launch serves any N.

#include "common.cuh"

namespace {

template <typename T>
__global__ void paste_kernel(const int64_t* __restrict__ ptrs, int n, int64_t strip,
                             int64_t hi_offset) {
  const int a = blockIdx.y;
  T* full = reinterpret_cast<T*>(ptrs[a]);
  const T* lo = reinterpret_cast<const T*>(ptrs[n + a]);
  const T* hi = reinterpret_cast<const T*>(ptrs[2 * n + a]);
  for (int64_t e = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; e < 2 * strip;
       e += int64_t(gridDim.x) * blockDim.x) {
    if (e < strip) {
      full[e] = lo[e];
    } else {
      full[hi_offset + e - strip] = hi[e - strip];
    }
  }
}

}  // namespace

extern "C" int tt_paste_x_edges_multi(int dtype, const void* ptrs, int n, int nx, int ny, int nz,
                                      int w, cudaStream_t stream) {
  const int64_t strip = int64_t(w) * ny * nz;
  const int64_t hi_offset = int64_t(nx - w) * ny * nz;
  const int threads = 256;
  int64_t blocks = (2 * strip + threads - 1) / threads;
  if (blocks > 4096) blocks = 4096;
  dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(n));
  const int64_t* p = static_cast<const int64_t*>(ptrs);
  if (dtype == tt::kFloat32) {
    paste_kernel<float><<<grid, threads, 0, stream>>>(p, n, strip, hi_offset);
  } else {
    paste_kernel<double><<<grid, threads, 0, stream>>>(p, n, strip, hi_offset);
  }
  return int(cudaGetLastError());
}
