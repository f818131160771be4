// Both RK2 stages of the conservative Smagorinsky update of (su, sv) in one
// launch, and one stage alone.
//
// Replaces: tasmania_tpu/ops/smagorinsky_step.py:149 _smag_rk2_fused
// (pallas_call at :241; entry fused_smagorinsky_rk2 at :261), both stages in
// one launch as there, and :33 _smag_stage, one stage (the JAX entry's path
// for narrow grids).
//
// Per stage, with u = su_st/s and v = sv_st/s: the strain (s00, s01, s11)
// and the viscosity nu of every cell, the products nu s00, nu s01, nu s11,
// the tendency 2(dx(nu s00) + dy(nu s01)), 2(dx(nu s01) + dy(nu s11)), and
// out = base + (c s) tendency on [nb, nx-nb) x [nb, ny-nb), base on the
// frame.  RK2: stage 1 with c = dt/2 from (su, sv), stage 2 with c = dt from
// stage 1, both on the base (su, sv).  Operation order as in
// smagorinsky_stage_plain (ops/smagorinsky_step.py), whose divisions by the
// spacings PyTorch takes on the card as products with their reciprocals:
// so does the kernel.  Every output cell is written, frame included: no
// paste follows.  The tile and its phases are tt::SmagBlock (smag.cuh),
// which smooth_smag.cu runs after its smoothing.
//
// Bound on the H100: bytes.  Both stages read s, su, sv and write su, sv:
// 5 x 12.44 MB = 62 MB at the flagship (161x161x120 float32), 19 us at
// 3.35 TB/s; about 200 flops a cell are far below the float32 rate.
// Design: a block owns a tile of 12 x 12 columns by two neighbouring
// 16-byte runs of levels (float32 4 levels a run, float64 2; the runs the
// fastest block index, so that blocks in flight together read whole
// columns), 512 threads, a thread a column's run at a time, moving it with
// one 16-byte load or store of shared memory; the two runs of a column lie
// side by side, so that two threads copy a column's 32 contiguous bytes.  It
// copies (s, su, sv) on the tile widened by 2 a stage (4 for RK2) into
// shared memory with cp.async (16-byte copies where tt::runs_of_16 allows),
// then forms each intermediate once, in shared memory: u and v on the
// widened tile; the products on the tile + 3; the stage-1 momenta, kept as
// velocities, on the tile + 2; the products again on the tile + 1; the
// output on the tile.  No intermediate reaches device memory, each input
// element leaves it once for its own block (its halo copies come from L2),
// and indices are 32-bit from blockIdx.  A halo cell's stage-1 value is
// formed by the expressions of an interior one, so it is the value its own
// block computes.  86 KB of shared memory a block, at most 64 registers a
// thread: two blocks an SM.  The time goes to instruction issue and the
// latency of each block's five dependent phases, not to bytes: on the H100
// tiles of 8 x 8 to 32 x 16 columns, one, three or four runs a block, 8- or
// 32-byte runs, a thread a level, and a block that takes several runs in
// turn with the next one's copies in flight were all slower.

#include "smag.cuh"

namespace {

// a block's tile: 12 x 12 columns by two level runs, two blocks an SM
using Tile = tt::SmagTile<12, 12, 2, 2>;
template <typename T>
using Levels = tt::Levels<T>;

// Stages = 2: the RK2 of (su, sv) = (su_st, sv_st) = (su_base, sv_base), c1 =
// dt/2 and c2 = dt; Stages = 1: one stage, base + c2 s T(su_st/s, sv_st/s).
// Run: the levels of one copy from device memory (KL, or 1 where a column's
// runs are not whole 16-byte runs)
template <typename T, int Stages, int Run>
__global__ void __launch_bounds__(Tile::Threads, Tile::Blocks)
    smagorinsky_kernel(const T* __restrict__ s, const T* __restrict__ su_st,
                       const T* __restrict__ sv_st, const T* __restrict__ su_base,
                       const T* __restrict__ sv_base, T* __restrict__ su_out,
                       T* __restrict__ sv_out, int nx, int ny, int nz, int nb, T c1, T c2, T nuc,
                       T dx2, T dy2) {
  using B = tt::SmagBlock<Tile, T, Stages, Run>;
  using C = Levels<T>;
  using WS = typename B::WS;
  using WB = typename B::WB;
  constexpr int KL = B::KL;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  B blk(reinterpret_cast<C*>(smem_raw), nx, ny, nz, nb, nuc, dx2, dy2);

  // (s, su_st, sv_st) on the tile + H and, for one stage, the base momenta
  // on the tile, in runs of Run levels (which lie wholly inside or outside
  // the grid: Run > 1 only where Run divides nz); cells outside the grid get
  // s = 1 and zero momenta
  B::template each<WS>([&](int c, int x, int y, int r) {
    const bool column = blk.in_grid(x, y);
    const bool base = Stages == 1 && WB::in(x, y);
    const int b = WB::at(x, y, r);
    const int k0 = B::k0(r);
    const int g = blk.cell(x, y, r);
#pragma unroll
    for (int kk = 0; kk < KL; kk += Run) {
      if (column && k0 + kk < nz) {
        tt::cp_async<Run * sizeof(T)>(&blk.S[c].v[kk], &s[g + kk]);
        tt::cp_async<Run * sizeof(T)>(&blk.U[c].v[kk], &su_st[g + kk]);
        tt::cp_async<Run * sizeof(T)>(&blk.V[c].v[kk], &sv_st[g + kk]);
        if (base) {
          tt::cp_async<Run * sizeof(T)>(&blk.BU[b].v[kk], &su_base[g + kk]);
          tt::cp_async<Run * sizeof(T)>(&blk.BV[b].v[kk], &sv_base[g + kk]);
        }
      } else {
#pragma unroll
        for (int l = kk; l < kk + Run; ++l) {
          blk.S[c].v[l] = T(1);
          blk.U[c].v[l] = blk.V[c].v[l] = T(0);
          if (base) blk.BU[b].v[l] = blk.BV[b].v[l] = T(0);
        }
      }
    }
  });
  tt::cp_async_commit();
  tt::cp_async_wait<0>();
  __syncthreads();
  blk.velocities();
  blk.stages(c1, c2, su_out, sv_out);
}

template <typename T, int Stages, int Run>
int launch_runs(const T* const* in, T* const* out, int nx, int ny, int nz, int nb, T c1, T c2,
                T nuc, T dx2, T dy2, cudaStream_t stream) {
  constexpr int KL = Levels<T>::n;
  using B = tt::SmagBlock<Tile, T, Stages, Run>;
  auto kernel = smagorinsky_kernel<T, Stages, Run>;
  const int smem = int(sizeof(Levels<T>)) * (B::kSUV + B::kBaseProducts);
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return int(err);
  const int runs = (nz + KL - 1) / KL;
  const dim3 grid((runs + Tile::Par - 1) / Tile::Par, (nx + Tile::TX - 1) / Tile::TX,
                  (ny + Tile::TY - 1) / Tile::TY);
  kernel<<<grid, Tile::Threads, smem, stream>>>(in[0], in[1], in[2], in[3], in[4], out[0], out[1],
                                                 nx, ny, nz, nb, c1, c2, nuc, dx2, dy2);
  return int(cudaGetLastError());
}

// in: s, su_st, sv_st, su_base, sv_base (the last two null for RK2)
template <typename T, int Stages>
int launch(const void* const* in_raw, void* const* out_raw, int nx, int ny, int nz, int nb,
           double c1, double c2, const double* sc, cudaStream_t stream) {
  const T* in[5];
  for (int f = 0; f < 5; ++f) in[f] = static_cast<const T*>(in_raw[f]);
  T* out[2] = {static_cast<T*>(out_raw[0]), static_cast<T*>(out_raw[1])};
  const T k[5] = {T(c1), T(c2), T(sc[0]), T(sc[1]), T(sc[2])};  // c1, c2, nu factor, 2 dx, 2 dy
  // 16-byte copies and stores where every field's columns are whole 16-byte runs
  if (tt::runs_of_16<T>(nz, {in[0], in[1], in[2], in[3], in[4], out[0], out[1]}))
    return launch_runs<T, Stages, Levels<T>::n>(in, out, nx, ny, nz, nb, k[0], k[1], k[2], k[3],
                                                 k[4], stream);
  return launch_runs<T, Stages, 1>(in, out, nx, ny, nz, nb, k[0], k[1], k[2], k[3], k[4], stream);
}

bool valid(int nx, int ny, int nz, int nb) {
  return nb >= 2 && nx >= 2 * nb + 1 && ny >= 2 * nb + 1 && nz >= 1 &&
         int64_t(nx) * ny * nz <= INT32_MAX;
}

}  // namespace

// in: s, su, sv; out: su, sv stepped (no aliasing); scalars: dt/2, dt,
// cs^2 dx dy, 2 dx, 2 dy
extern "C" int tt_smagorinsky_rk2(int dtype, const void* const* in, void* const* out, int nx,
                                  int ny, int nz, int nb, const double* scalars,
                                  cudaStream_t stream) {
  if (!valid(nx, ny, nz, nb)) return int(cudaErrorInvalidValue);
  const void* in5[5] = {in[0], in[1], in[2], nullptr, nullptr};
  if (dtype == tt::kFloat32)
    return launch<float, 2>(in5, out, nx, ny, nz, nb, scalars[0], scalars[1], scalars + 2, stream);
  return launch<double, 2>(in5, out, nx, ny, nz, nb, scalars[0], scalars[1], scalars + 2, stream);
}

// in: s, su_stage, sv_stage, su_base, sv_base; out: su, sv (no aliasing);
// scalars: c, cs^2 dx dy, 2 dx, 2 dy
extern "C" int tt_smagorinsky_stage(int dtype, const void* const* in, void* const* out, int nx,
                                    int ny, int nz, int nb, const double* scalars,
                                    cudaStream_t stream) {
  if (!valid(nx, ny, nz, nb)) return int(cudaErrorInvalidValue);
  if (dtype == tt::kFloat32)
    return launch<float, 1>(in, out, nx, ny, nz, nb, scalars[0], scalars[0], scalars + 1, stream);
  return launch<double, 1>(in, out, nx, ny, nz, nb, scalars[0], scalars[0], scalars + 1, stream);
}
