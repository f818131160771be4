// Multi-field order-n Shapiro smoothing in one launch.
//
// Replaces: tasmania_tpu/ops/smoothing_step.py:44 fused_smoothing (pallas_call
// at :108).  Per field f and cell: interior (1 - c*g) phi + g * sum_k w_k
// (x-shifts + y-shifts), with g = gamma[f, k] (tt::shapiro, common.cuh,
// shared with smooth_smag.cu); the nb-wide y-frame rows are
// copied.  Only x columns [nb, nx-nb) are written: the wrapper pastes the
// x-frame columns from the inputs with the paste kernel, as the TPU path does.
//
// Bound on the H100: bytes.  At the flagship 6 fields x 12.4 MB are read and
// written once (~150 MB), the 2n x-shifted and y-shifted reads of a
// neighbourhood hit L1/L2.  Design: one thread per cell, k (the contiguous
// axis) fastest, so every stencil read of a warp is a coalesced run along k;
// blockIdx.y picks the field; field pointers ride in the kernel arguments.

#include "common.cuh"

namespace {

constexpr int kMaxFields = 8;

template <typename T>
struct FieldPtrs {
  const T* in[kMaxFields];
  T* out[kMaxFields];
};

template <typename T, int N>
__global__ void smoothing_kernel(FieldPtrs<T> ptrs, const T* __restrict__ gamma, int nx, int ny,
                                 int nz, int nb) {
  const int f = blockIdx.y;
  const T* __restrict__ phi = ptrs.in[f];
  T* __restrict__ out = ptrs.out[f];
  const int64_t total = int64_t(nx - 2 * nb) * ny * nz;
  const int64_t sx = int64_t(ny) * nz;
  for (int64_t e = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; e < total;
       e += int64_t(gridDim.x) * blockDim.x) {
    const int k = int(e % nz);
    const int j = int((e / nz) % ny);
    const int i = nb + int(e / sx);
    const int64_t c = int64_t(i) * sx + int64_t(j) * nz + k;
    if (j < nb || j >= ny - nb) {
      out[c] = phi[c];
      continue;
    }
    out[c] = tt::shapiro<T, N>(phi, c, sx, nz, gamma[f * nz + k]);
  }
}

template <typename T>
int launch(const void* const* in, void* const* out, const void* gamma, int nf, int nx, int ny,
           int nz, int order, int nb, cudaStream_t stream) {
  FieldPtrs<T> p;
  for (int f = 0; f < nf; ++f) {
    p.in[f] = static_cast<const T*>(in[f]);
    p.out[f] = static_cast<T*>(out[f]);
  }
  const int64_t total = int64_t(nx - 2 * nb) * ny * nz;
  const int threads = 256;
  int64_t blocks = (total + threads - 1) / threads;
  if (blocks > 65535) blocks = 65535;
  dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(nf));
  const T* g = static_cast<const T*>(gamma);
  if (order == 1) {
    smoothing_kernel<T, 1><<<grid, threads, 0, stream>>>(p, g, nx, ny, nz, nb);
  } else if (order == 2) {
    smoothing_kernel<T, 2><<<grid, threads, 0, stream>>>(p, g, nx, ny, nz, nb);
  } else {
    smoothing_kernel<T, 3><<<grid, threads, 0, stream>>>(p, g, nx, ny, nz, nb);
  }
  return int(cudaGetLastError());
}

}  // namespace

extern "C" int tt_smoothing(int dtype, const void* const* in, void* const* out, const void* gamma,
                            int nf, int nx, int ny, int nz, int order, int nb,
                            cudaStream_t stream) {
  if (nf < 1 || nf > kMaxFields || order < 1 || order > 3) return int(cudaErrorInvalidValue);
  if (dtype == tt::kFloat32) return launch<float>(in, out, gamma, nf, nx, ny, nz, order, nb, stream);
  return launch<double>(in, out, gamma, nf, nx, ny, nz, order, nb, stream);
}
