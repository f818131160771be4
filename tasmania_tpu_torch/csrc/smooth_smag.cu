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
// smoothed momenta, which there are the raw ones), in the order of
// fused_smoothing_plain and smagorinsky_stage_plain: the filter is
// tt::shapiro_taps (common.cuh), as smoothing.cu's, and the Smagorinsky
// phases are tt::SmagBlock's (smag.cuh), as smagorinsky.cu's, so the kernel
// gives the bits of those two kernels run in turn.  Every output cell is
// written here, frame included: no paste follows.
//
// Bound on the H100: bytes.  At the flagship (161x161x120 float32, six
// fields) it reads six fields and writes six, 149 MB, 45 us at 3.35 TB/s;
// about 60 flops a field and cell of smoothing and 200 of the two
// Smagorinsky stages are far below the float32 rate.  Design:
// smagorinsky.cu's tile (columns by two 16-byte level runs, 512 threads, a
// thread a column's run at a time), 13 x 15 columns, with the smoothing in
// front of its phases.  It copies with cp.async, cached in L2 alone, each
// moist field's cross of halo n around the tile (group 0) and the raw s,
// su, sv on the cross that the filter of the tile + 4 reads (tt::for_cross
// with the widened tile, halo n; group 1).  While the raw copies land it
// smooths the moist fields on the tile and writes them out; then it smooths
// s, su and sv on the tile + 4 into the Smagorinsky window, a field at a
// time, in the moist crosses' place, writes the tile's s, and runs
// tt::SmagBlock's phases (the velocities, the products on the tile + 3, the
// stage-1 velocities on the tile + 2, the products on the tile + 1, the
// output on the tile), the base momenta and the products in the raw
// crosses' place.  111 KB of shared memory a block at order 2 and 64
// registers a thread: two blocks an SM.  Each input element leaves device
// memory once for its own block (its halo copies come from L2), and nothing
// between the two processes reaches it.  The time goes to the tile's ring
// of 4, on which s, su and sv are filtered and the first stage computed
// (2.5 times the tile's columns), to shared-memory traffic and to the
// rounds of each phase; on the H100 12 x 12, 16 x 12, 14 x 14 and 16 x 16
// tiles, one block an SM, one run a block, 32-byte runs, copies cached in
// L1, the base momenta in a place of their own (so that the filter could
// put the velocities), the moist fields in one round and the filter two
// columns a thread were all slower or spilled.

#include "smag.cuh"

namespace {

// a block's tile: 13 x 15 columns by two level runs, its phases' rounds in
// rolled loops; two blocks an SM (64 registers a thread) in float32 at
// orders 1 and 2 with 16-byte copies, one otherwise (order 3, float64, and
// columns that are not whole 16-byte runs would spill at 64 registers)
template <typename T, int N, int Run>
using TileOf = tt::SmagTile<13, 15, 2, N == 3 || sizeof(T) == 8 || Run == 1 ? 1 : 2, true>;
constexpr int kMaxFields = 8;

template <typename T>
struct Fields {
  const T* in[kMaxFields];  // s, su, sv[, q...]
  T* out[kMaxFields];       // s smoothed, su, sv stepped[, q smoothed...]
};

// a cross of halo N around a tile of TX x TY columns, laid out as
// tt::for_cross's rectangle: RX x RY columns of Par Levels
template <int TX, int TY, int N, int Par>
struct Cross {
  static constexpr int RX = TX + 2 * N, RY = TY + 2 * N, levels = RX * RY * Par;
  // the element of column (x, y) of the tile and level run r
  __device__ static int at(int x, int y, int r) { return ((x + N) * RY + y + N) * Par + r; }
};

// shared memory in Levels: first the nq moist fields' crosses, until they
// are smoothed, then tt::SmagBlock's s, u, v in their place; then the raw
// crosses of s, su, sv (the filter's cross around the tile + 4), whose place
// the base momenta and the products take once the filter has read them
template <typename T, int N, int Run>
struct Layout {
  using Tile = TileOf<T, N, Run>;
  using B = tt::SmagBlock<Tile, T, 2, Run>;
  using Raw = Cross<Tile::TX + 8, Tile::TY + 8, N, Tile::Par>;
  using Moist = Cross<Tile::TX, Tile::TY, N, Tile::Par>;
  static constexpr int kShared =
      3 * Raw::levels > B::kBaseProducts ? 3 * Raw::levels : B::kBaseProducts;
  // the first region (the raw crosses' offset), and all of it
  __host__ __device__ static constexpr int first(int nq) {
    return nq * Moist::levels > B::kSUV ? nq * Moist::levels : B::kSUV;
  }
  __host__ __device__ static constexpr int levels(int nq) { return first(nq) + kShared; }
};

// the order-N filter of element c of a staged cross R (strides sx, sy in
// Levels), each level with its coefficient in g
template <int N, class C>
__device__ __forceinline__ C filtered(const C* R, int c, int sx, int sy, const C& g) {
  using Sh = tt::Shapiro<N>;
  C t[Sh::taps];
  t[0] = R[c];
#pragma unroll
  for (int o = 0; o < 2 * N; ++o) {
    t[1 + o] = R[c + Sh::off(o) * sx];
    t[1 + 2 * N + o] = R[c + Sh::off(o) * sy];
  }
  C out;
#pragma unroll
  for (int l = 0; l < C::n; ++l)
    out.v[l] = tt::shapiro_taps<typename C::value_type, N>([&](int i) { return t[i].v[l]; }, g.v[l]);
  return out;
}

// the coefficients of field f at the levels of run r (0 past the last level)
template <class B, typename T>
__device__ __forceinline__ typename B::C coefficients(const T* __restrict__ gamma, int f, int r, int nz) {
  typename B::C g;
#pragma unroll
  for (int l = 0; l < B::KL; ++l) {
    const int k = B::k0(r) + l;
    g.v[l] = k < nz ? gamma[f * nz + k] : T(0);
  }
  return g;
}

template <typename T, int N, int Run>
__global__ void __launch_bounds__(TileOf<T, N, Run>::Threads, TileOf<T, N, Run>::Blocks)
    smooth_smag_kernel(Fields<T> p, const T* __restrict__ gamma, int nq, int nx, int ny, int nz,
                       int nb, T c1, T c2, T nuc, T dx2, T dy2) {
  using L = Layout<T, N, Run>;
  using Tile = typename L::Tile;
  using B = typename L::B;
  using C = typename B::C;
  using Raw = typename L::Raw;
  using Moist = typename L::Moist;
  constexpr int Par = Tile::Par, KL = B::KL;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  B blk(reinterpret_cast<C*>(smem_raw), nx, ny, nz, nb, nuc, dx2, dy2);
  C* const moist = blk.S;                    // the moist crosses, then s, u, v
  C* const raw = blk.S + L::first(nq);       // the raw s, su, sv, then the base and products
  const int k0 = int(blockIdx.x) * Par * KL;  // the block's first level
  const int r = int(threadIdx.x) % Par;       // the thread's level run, in every element it takes
  // the fields' pointers, out of the kernel argument (which a lambda's
  // reference would copy to local memory)
  const T *s_in = p.in[0], *su_in = p.in[1], *sv_in = p.in[2];
  T *s_out = p.out[0], *su_out = p.out[1], *sv_out = p.out[2];

  // 1. the moist fields' crosses (group 0), then the raw (s, su, sv) crosses
  //    (group 1); the moist loops run over constant field indices, so the
  //    pointers are picked without local memory
#pragma unroll
  for (int q = 0; q < kMaxFields - 3; ++q) {
    if (q < nq) {
      const T* src = p.in[3 + q];
      T* dst = reinterpret_cast<T*>(moist + q * Moist::levels);
      tt::for_cross<Tile::TX, Tile::TY, Par * KL, N, Run, Tile::Threads>(
          blk.x0, blk.y0, k0, nx, ny, nz,
          [&](int m, int g) { tt::cp_async<Run * sizeof(T), true>(dst + m, &src[g]); });
    }
  }
  tt::cp_async_commit();
  tt::for_cross<Tile::TX + 8, Tile::TY + 8, Par * KL, N, Run, Tile::Threads>(
      blk.x0 - 4, blk.y0 - 4, k0, nx, ny, nz, [&](int m, int g) {
        T* dst = reinterpret_cast<T*>(raw) + m;
        tt::cp_async<Run * sizeof(T), true>(dst, &s_in[g]);
        tt::cp_async<Run * sizeof(T), true>(dst + Raw::levels * KL, &su_in[g]);
        tt::cp_async<Run * sizeof(T), true>(dst + 2 * Raw::levels * KL, &sv_in[g]);
      });
  tt::cp_async_commit();

  // 2. the moist fields smoothed on the tile while the raw copies land
  tt::cp_async_wait<1>();
  __syncthreads();
#pragma unroll
  for (int q = 0; q < kMaxFields - 3; ++q) {
    if (q < nq) {
      T* dst = p.out[3 + q];
      const C* Q = moist + q * Moist::levels;
      B::template each<tt::Window<Tile, 0>>([&](int, int x, int y, int) {
        if (!blk.in_grid(x, y)) return;
        const int m = Moist::at(x, y, r);
        const C v = blk.interior(x, y)
                        ? filtered<N>(Q, m, Moist::RY * Par, Par, coefficients<B>(gamma, 3 + q, r, nz))
                        : Q[m];
        blk.store(dst, blk.cell(x, y, r), r, v);
      });
    }
  }
  tt::cp_async_wait<0>();
  __syncthreads();

  // 3. s, su, sv smoothed on the tile + 4 into the Smagorinsky window, a
  //    field at a time (cells outside the grid, and levels past the last,
  //    s = 1 and zero momenta; the coefficients from L1), the tile's s
  //    written out
  using WS = typename B::WS;
  tt::strided<WS::cols * Par, Tile::Threads>([&](int c) {  // unrolled, whatever Tile::Rolled
    const int x = c / Par / WS::WY - 4, y = c / Par % WS::WY - 4;
    const bool column = blk.in_grid(x, y), inner = column && blk.interior(x, y);
    const int m = Raw::at(x + 4, y + 4, r);
    C* const window[3] = {blk.S, blk.U, blk.V};
#pragma unroll
    for (int f = 0; f < 3; ++f) {
      const C* R = raw + f * Raw::levels;
      C v = inner ? filtered<N>(R, m, Raw::RY * Par, Par, coefficients<B>(gamma, f, r, nz)) : R[m];
#pragma unroll
      for (int l = 0; l < KL; ++l)
        if (!column || B::k0(r) + l >= nz) v.v[l] = f == 0 ? T(1) : T(0);
      window[f][c] = v;
      if (f == 0 && column && x >= 0 && x < Tile::TX && y >= 0 && y < Tile::TY)
        blk.store(s_out, blk.cell(x, y, r), r, v);
    }
  });
  __syncthreads();

  // 4. the two Smagorinsky stages of the smoothed (s, su, sv)
  blk.velocities();
  blk.stages(c1, c2, su_out, sv_out);
}

template <typename T, int N, int Run>
int launch_runs(const Fields<T>& p, const T* gamma, int nq, int nx, int ny, int nz, int nb,
                const double* sc, cudaStream_t stream) {
  using B = typename Layout<T, N, Run>::B;
  constexpr int KL = B::KL;
  auto kernel = smooth_smag_kernel<T, N, Run>;
  using Tile = typename Layout<T, N, Run>::Tile;
  const int smem = int(sizeof(typename B::C)) * Layout<T, N, Run>::levels(nq);
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return int(err);
  const int runs = (nz + KL - 1) / KL;
  const dim3 grid((runs + Tile::Par - 1) / Tile::Par, (nx + Tile::TX - 1) / Tile::TX,
                  (ny + Tile::TY - 1) / Tile::TY);
  kernel<<<grid, Tile::Threads, smem, stream>>>(p, gamma, nq, nx, ny, nz, nb, T(sc[0]), T(sc[1]),
                                                T(sc[2]), T(sc[3]), T(sc[4]));
  return int(cudaGetLastError());
}

template <typename T, int N>
int launch_order(const Fields<T>& p, const T* gamma, int nf, int nx, int ny, int nz, int nb,
                 const double* sc, cudaStream_t stream) {
  // 16-byte copies and stores where every field's columns are whole 16-byte runs
  bool vec = true;
  for (int f = 0; f < nf; ++f) vec = vec && tt::runs_of_16<T>(nz, {p.in[f], p.out[f]});
  if (vec) return launch_runs<T, N, tt::Levels<T>::n>(p, gamma, nf - 3, nx, ny, nz, nb, sc, stream);
  return launch_runs<T, N, 1>(p, gamma, nf - 3, nx, ny, nz, nb, sc, stream);
}

template <typename T>
int launch(const void* const* in, void* const* out, const void* gamma, int nf, int nx, int ny,
           int nz, int order, int nb, const double* sc, cudaStream_t stream) {
  Fields<T> p{};
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
      nx < 2 * nb + 1 || ny < 2 * nb + 1 || nz < 1 || int64_t(nx) * ny * nz > INT32_MAX)
    return int(cudaErrorInvalidValue);
  if (dtype == tt::kFloat32)
    return launch<float>(in, out, gamma, nf, nx, ny, nz, order, nb, scalars, stream);
  return launch<double>(in, out, gamma, nf, nx, ny, nz, order, nb, scalars, stream);
}
