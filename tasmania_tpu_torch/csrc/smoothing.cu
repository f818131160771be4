// Multi-field order-n Shapiro smoothing in one launch, every cell written.
//
// Replaces: tasmania_tpu/ops/smoothing_step.py:44 fused_smoothing (pallas_call
// at :108).  Per field f and cell: on the interior [nb, nx-nb) x [nb, ny-nb)
// (1 - c*g) phi + g * sum_k w_k (x-shifts + y-shifts), with g = gamma[f, k]
// (tt::shapiro_taps, common.cuh, shared with smooth_smag.cu); the nb-wide frame is
// copied.  No paste follows.
//
// Bound on the H100: bytes.  At the flagship 6 fields x 12.4 MB are read and
// written once (149 MB, 45 us at 3.35 TB/s); about 40 flops a cell are far
// below the float32 rate.  Design: a block owns an 8 x 8 column tile and a
// run of 32 levels of one field (the run the fastest block index, so that
// blocks in flight together read whole columns), 256 threads with the level
// fastest, so that a warp moves one column's 32 contiguous levels.  It copies the tile's cross of halo n (the
// order) into shared memory with cp.async (tt::for_cross; 16-byte copies
// where nz and the pointers allow), then each thread filters the cells of
// one row at one level from there (interior cells filtered, frame cells
// copied): each input element leaves device memory once for its own block
// and is re-read from L2 only as a neighbour's halo.  32-bit indices from
// blockIdx, no division of a flat index.  25 KB of shared memory a block at
// order 3 in float32, 50 KB in float64.

#include "common.cuh"

namespace {

constexpr int kTX = 8, kTY = 8;  // a block's columns in x and in y
constexpr int kKL = 32;          // a block's levels, the fastest thread index
constexpr int kThreads = 256;
constexpr int kMaxFields = 8;

template <typename T>
struct FieldPtrs {
  const T* in[kMaxFields];
  T* out[kMaxFields];
};

template <int N>
constexpr int rect_elems() {
  return (kTX + 2 * N) * (kTY + 2 * N) * kKL;
}

template <typename T, int N, int V>
__global__ void __launch_bounds__(kThreads)
    smoothing_kernel(FieldPtrs<T> ptrs, const T* __restrict__ gamma, int nx, int ny, int nz, int nb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* R = reinterpret_cast<T*>(smem_raw);  // the cross, (kTX + 2N) x (kTY + 2N) x kKL
  constexpr int RY = kTY + 2 * N;
  // the level run is the fastest block index: blocks that run together read
  // whole columns
  const int ty_tiles = (ny + kTY - 1) / kTY;
  const int f = int(blockIdx.z) / ty_tiles;
  const int k0 = blockIdx.x * kKL, x0 = blockIdx.y * kTX, y0 = (int(blockIdx.z) - f * ty_tiles) * kTY;
  // the field's pointers, picked with constant indices: a kernel argument
  // indexed by a runtime value would be copied to local memory by every thread
  const T* phi = ptrs.in[0];
  T* out = ptrs.out[0];
#pragma unroll
  for (int q = 1; q < kMaxFields; ++q) {
    if (f == q) {
      phi = ptrs.in[q];
      out = ptrs.out[q];
    }
  }
  tt::for_cross<kTX, kTY, kKL, N, V, kThreads>(
      x0, y0, k0, nx, ny, nz, [&](int m, int g) { tt::cp_async<V * sizeof(T)>(&R[m], &phi[g]); });
  tt::cp_async_commit();
  // a thread's level and row are fixed; it takes the row's kTX cells
  static_assert(kThreads == kKL * kTY, "one row of the tile a thread");
  const int kk = threadIdx.x % kKL, ty = threadIdx.x / kKL;
  const int j = y0 + ty, k = k0 + kk;
  const T g = k < nz ? gamma[f * nz + k] : T(0);
  const bool row = j >= nb && j < ny - nb;
  tt::cp_async_wait<0>();
  __syncthreads();
  if (k >= nz || j >= ny) return;
  const int sx = ny * nz;
#pragma unroll
  for (int tx = 0; tx < kTX; ++tx) {
    const int i = x0 + tx;
    if (i >= nx) break;
    const int m = ((tx + N) * RY + ty + N) * kKL + kk;
    const bool interior = row && i >= nb && i < nx - nb;
    out[i * sx + j * nz + k] = interior ? tt::shapiro<T, N>(R, m, RY * kKL, kKL, g) : R[m];
  }
}

template <typename T, int N, int V>
int launch_order(const FieldPtrs<T>& p, const T* gamma, int nf, int nx, int ny, int nz, int nb,
                 cudaStream_t stream) {
  auto kernel = smoothing_kernel<T, N, V>;
  const int smem = int(sizeof(T)) * rect_elems<N>();
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return int(err);
  const dim3 grid((nz + kKL - 1) / kKL, (nx + kTX - 1) / kTX, (ny + kTY - 1) / kTY * nf);
  kernel<<<grid, kThreads, smem, stream>>>(p, gamma, nx, ny, nz, nb);
  return int(cudaGetLastError());
}

template <typename T, int N>
int launch_order(const FieldPtrs<T>& p, const T* gamma, int nf, int nx, int ny, int nz, int nb,
                 cudaStream_t stream) {
  // 16-byte copies where every field's columns are whole 16-byte runs
  bool vec = true;
  for (int f = 0; f < nf; ++f) vec = vec && tt::runs_of_16<T>(nz, {p.in[f]});
  if (vec) return launch_order<T, N, 16 / sizeof(T)>(p, gamma, nf, nx, ny, nz, nb, stream);
  return launch_order<T, N, 1>(p, gamma, nf, nx, ny, nz, nb, stream);
}

template <typename T>
int launch(const void* const* in, void* const* out, const void* gamma, int nf, int nx, int ny,
           int nz, int order, int nb, cudaStream_t stream) {
  FieldPtrs<T> p;
  for (int f = 0; f < nf; ++f) {
    p.in[f] = static_cast<const T*>(in[f]);
    p.out[f] = static_cast<T*>(out[f]);
  }
  const T* g = static_cast<const T*>(gamma);
  if (order == 1) return launch_order<T, 1>(p, g, nf, nx, ny, nz, nb, stream);
  if (order == 2) return launch_order<T, 2>(p, g, nf, nx, ny, nz, nb, stream);
  return launch_order<T, 3>(p, g, nf, nx, ny, nz, nb, stream);
}

}  // namespace

// in, out: nf fields (nx, ny, nz), no aliasing; gamma (nf, nz)
extern "C" int tt_smoothing(int dtype, const void* const* in, void* const* out, const void* gamma,
                            int nf, int nx, int ny, int nz, int order, int nb,
                            cudaStream_t stream) {
  if (nf < 1 || nf > kMaxFields || order < 1 || order > 3 || nb < order || nx < 1 || ny < 1 ||
      nz < 1 || int64_t(nx) * ny * nz > INT32_MAX)
    return int(cudaErrorInvalidValue);
  if (dtype == tt::kFloat32) return launch<float>(in, out, gamma, nf, nx, ny, nz, order, nb, stream);
  return launch<double>(in, out, gamma, nf, nx, ny, nz, order, nb, stream);
}
