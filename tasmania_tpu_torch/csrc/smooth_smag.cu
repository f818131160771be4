// Shapiro smoothing of the isentropic fields and both RK2 stages of the
// conservative Smagorinsky update of the smoothed momenta, in one launch.
//
// Replaces: tasmania_tpu/ops/smagorinsky_step.py:303
// fused_smoothing_smagorinsky_rk2 (pallas_call at :488), the SUS process pair
// [IsentropicHorizontalSmoothing -> IsentropicSmagorinsky(rk2)].  Outputs:
// the smoothed s, the RK2-stepped su and sv of the smoothed (s, su, sv), and
// the smoothed moist fields; the smoothed momenta and the stage-1 momenta
// never reach device memory.  The algebra is that of fused_smoothing (the
// interior [nb, nx-nb) x [nb, ny-nb) filtered, the frame passed through)
// followed by fused_smagorinsky_rk2 (each stage's frame keeps the base, the
// smoothed momenta, which there are the raw ones): tt::shapiro (common.cuh)
// as smoothing.cu uses it, tt::smag_strain and tt::smag_tendency
// (common.cuh), in the order of fused_smoothing_plain and
// smagorinsky_stage_plain.  Every output cell is written here, frame
// included: no paste follows.
//
// Bound on the H100: bytes.  At the flagship (161x161x120 float32, six
// fields) it reads six fields and writes six, 149 MB, 45 us at 3.35 TB/s;
// about 60 flops a field and cell of smoothing and 200 of the two
// Smagorinsky stages are far below the float32 rate.  Design: one block per
// 12 x 12 cell tile in (x, y) and 8 levels, 256 threads with the level
// fastest, so a warp's loads are 32-byte runs along the contiguous z axis.
// Through shared memory: the smoothed (s, su, sv) on the tile widened by 4
// (the stage-1 ring of 2 and its tendency's reach of 2), held as s and the
// velocities su/s, sv/s; the smoothed momenta (the stages' base) and the
// stage-1 velocities on the tile widened by 2; then the stage-2 update on
// the tile.  The smoothing reads its 2n+1-point cross from device memory
// (the neighbours hit L1/L2, as in smoothing.cu).  71 KB of shared memory a
// block in float32, 142 KB in float64.

#include "common.cuh"

namespace {

constexpr int kTile = 12;                   // a block's output cells in x and in y
constexpr int kLevels = 8;                  // a block's levels, the fastest thread index
constexpr int kThreads = 256;
constexpr int kCells = kThreads / kLevels;  // cells a block's threads cover at once
constexpr int kW4 = kTile + 8;              // the tile widened by 4: smoothed fields
constexpr int kW2 = kTile + 4;              // the tile widened by 2: stage-1 values
constexpr int kMaxFields = 8;

template <typename T>
struct Fields {
  const T* in[kMaxFields];  // s, su, sv[, q...]
  T* out[kMaxFields];       // s smoothed, su, sv stepped[, q smoothed...]
};

template <typename T>
constexpr size_t smem_bytes() {
  return sizeof(T) * size_t(kLevels) * (3 * kW4 * kW4 + 4 * kW2 * kW2);
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
    smooth_smag_kernel(Fields<T> p, const T* __restrict__ gamma, int nf, int nx, int ny, int nz,
                       int nb, T c1, T c2, T nuc, T dx2, T dy2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int n4 = kW4 * kW4 * kLevels, n2 = kW2 * kW2 * kLevels;
  T* S = reinterpret_cast<T*>(smem_raw);  // smoothed s on the tile + 4
  T* U0 = S + n4;                         // smoothed su, then su/s, on the tile + 4
  T* V0 = U0 + n4;
  T* BU = V0 + n4;                        // smoothed su on the tile + 2: the base
  T* BV = BU + n2;
  T* U1 = BV + n2;                        // stage-1 velocities on the tile + 2
  T* V1 = U1 + n2;

  const int kk = threadIdx.x % kLevels, cl = threadIdx.x / kLevels;
  const int k = blockIdx.z * kLevels + kk;
  const bool live = k < nz;  // a thread past the last level only joins the barriers
  const int x0 = blockIdx.x * kTile, y0 = blockIdx.y * kTile;
  const int64_t sy = nz, sx = int64_t(ny) * nz;
  auto inside = [&](int i, int j) { return i >= 0 && i < nx && j >= 0 && j < ny; };
  auto interior = [&](int i, int j) { return i >= nb && i < nx - nb && j >= nb && j < ny - nb; };
  auto cell = [&](int i, int j) { return int64_t(i) * sx + int64_t(j) * sy + k; };

  // 1. smooth s, su, sv on the tile + 4 (cells outside the grid get s = 1,
  //    velocities 0: finite, and never read by a cell that is written); the
  //    tile's s and the moist fields go out now
  for (int c = cl; c < kW4 * kW4; c += kCells) {
    const int i = x0 - 4 + c / kW4, j = y0 - 4 + c % kW4;
    T vs = T(1), vu = T(0), vv = T(0);
    if (live && inside(i, j)) {
      const int64_t e = cell(i, j);
      if (interior(i, j)) {
        vs = tt::shapiro<T, N>(p.in[0], e, sx, sy, gamma[k]);
        vu = tt::shapiro<T, N>(p.in[1], e, sx, sy, gamma[nz + k]);
        vv = tt::shapiro<T, N>(p.in[2], e, sx, sy, gamma[2 * nz + k]);
      } else {
        vs = p.in[0][e];
        vu = p.in[1][e];
        vv = p.in[2][e];
      }
      if (i >= x0 && i < x0 + kTile && j >= y0 && j < y0 + kTile) p.out[0][e] = vs;
    }
    const int m = c * kLevels + kk;
    S[m] = vs;
    U0[m] = vu;
    V0[m] = vv;
  }
  for (int c = cl; c < kTile * kTile; c += kCells) {
    const int i = x0 + c / kTile, j = y0 + c % kTile;
    if (!live || !inside(i, j)) continue;
    const int64_t e = cell(i, j);
    const bool in = interior(i, j);
    for (int f = 3; f < nf; ++f)
      p.out[f][e] = in ? tt::shapiro<T, N>(p.in[f], e, sx, sy, gamma[f * nz + k]) : p.in[f][e];
  }
  __syncthreads();

  // 2. the base momenta on the tile + 2, then the velocities in place (each
  //    thread reads and rewrites only its own cells here)
  for (int c = cl; c < kW4 * kW4; c += kCells) {
    const int rx = c / kW4, ry = c % kW4;
    const int m = c * kLevels + kk;
    if (rx >= 2 && rx < kW4 - 2 && ry >= 2 && ry < kW4 - 2) {
      const int b = ((rx - 2) * kW2 + (ry - 2)) * kLevels + kk;
      BU[b] = U0[m];
      BV[b] = V0[m];
    }
    U0[m] = U0[m] / S[m];
    V0[m] = V0[m] / S[m];
  }
  __syncthreads();

  // 3. stage 1 on the tile + 2: su1 = base + (c1 s) T(u0, v0) inside the
  //    frame, the base on it; kept as velocities su1/s
  constexpr int64_t s4x = kW4 * kLevels, s2x = kW2 * kLevels;
  for (int c = cl; c < kW2 * kW2; c += kCells) {
    const int rx = c / kW2, ry = c % kW2;
    const int i = x0 - 2 + rx, j = y0 - 2 + ry;
    const int m4 = ((rx + 2) * kW4 + ry + 2) * kLevels + kk;
    const int m2 = c * kLevels + kk;
    T su1 = BU[m2], sv1 = BV[m2];
    if (live && interior(i, j)) {
      T ut, vt;
      tt::smag_tendency(tt::Plain<T>{U0}, tt::Plain<T>{V0}, m4, s4x, int64_t(kLevels), nuc, dx2,
                        dy2, ut, vt);
      const T cs = c1 * S[m4];
      su1 = BU[m2] + cs * ut;
      sv1 = BV[m2] + cs * vt;
    }
    U1[m2] = su1 / S[m4];
    V1[m2] = sv1 / S[m4];
  }
  __syncthreads();

  // 4. stage 2 on the tile: base + (c2 s) T(u1, v1) inside the frame, the
  //    base on it
  for (int c = cl; c < kTile * kTile; c += kCells) {
    const int tx = c / kTile, ty = c % kTile;
    const int i = x0 + tx, j = y0 + ty;
    if (!live || !inside(i, j)) continue;
    const int m4 = ((tx + 4) * kW4 + ty + 4) * kLevels + kk;
    const int m2 = ((tx + 2) * kW2 + ty + 2) * kLevels + kk;
    T su = BU[m2], sv = BV[m2];
    if (interior(i, j)) {
      T ut, vt;
      tt::smag_tendency(tt::Plain<T>{U1}, tt::Plain<T>{V1}, m2, s2x, int64_t(kLevels), nuc, dx2,
                        dy2, ut, vt);
      const T cs = c2 * S[m4];
      su = BU[m2] + cs * ut;
      sv = BV[m2] + cs * vt;
    }
    const int64_t e = cell(i, j);
    p.out[1][e] = su;
    p.out[2][e] = sv;
  }
}

template <typename T, int N>
int launch_order(const Fields<T>& p, const T* gamma, int nf, int nx, int ny, int nz, int nb,
                 const double* sc, cudaStream_t stream) {
  auto kernel = smooth_smag_kernel<T, N>;
  const size_t smem = smem_bytes<T>();
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((nx + kTile - 1) / kTile, (ny + kTile - 1) / kTile, (nz + kLevels - 1) / kLevels);
  kernel<<<grid, kThreads, smem, stream>>>(p, gamma, nf, nx, ny, nz, nb, T(sc[0]), T(sc[1]),
                                           T(sc[2]), T(sc[3]), T(sc[4]));
  return int(cudaGetLastError());
}

template <typename T>
int launch(const void* const* in, void* const* out, const void* gamma, int nf, int nx, int ny,
           int nz, int order, int nb, const double* sc, cudaStream_t stream) {
  Fields<T> p;
  for (int f = 0; f < nf; ++f) {
    p.in[f] = static_cast<const T*>(in[f]);
    p.out[f] = static_cast<T*>(out[f]);
  }
  const T* g = static_cast<const T*>(gamma);
  if (order == 1) return launch_order<T, 1>(p, g, nf, nx, ny, nz, nb, sc, stream);
  if (order == 2) return launch_order<T, 2>(p, g, nf, nx, ny, nz, nb, sc, stream);
  return launch_order<T, 3>(p, g, nf, nx, ny, nz, nb, sc, stream);
}

}  // namespace

// in: s, su, sv[, q...] (nf fields); out: s smoothed, su and sv stepped[, q
// smoothed] (no aliasing); gamma (nf, nz); scalars: c1 = dt/2, c2 = dt,
// cs^2 dx dy, 2 dx, 2 dy
extern "C" int tt_smoothing_smagorinsky_rk2(int dtype, const void* const* in, void* const* out,
                                            const void* gamma, int nf, int nx, int ny, int nz,
                                            int order, int nb, const double* scalars,
                                            cudaStream_t stream) {
  if (nf < 3 || nf > kMaxFields || order < 1 || order > 3 || nb < order || nb < 2 ||
      nx < 2 * nb + 1 || ny < 2 * nb + 1)
    return int(cudaErrorInvalidValue);
  if (dtype == tt::kFloat32)
    return launch<float>(in, out, gamma, nf, nx, ny, nz, order, nb, scalars, stream);
  return launch<double>(in, out, gamma, nf, nx, ny, nz, order, nb, scalars, stream);
}
