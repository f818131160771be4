// Isentropic diagnostics by column scans: pressure, Exner function,
// Montgomery potential, height of the isentropes (and density, temperature).
//
// Replaces: tasmania_tpu/ops/diagnostics_step.py:103
// fused_isentropic_diagnostics (pallas_call at :167), its recurrences
// (:16-21, _diag_compute :62-93), per (i, j) column with theta on the nz+1
// interfaces, theta_s = theta[nz]:
//   p[0] = pt;  p[k+1] = pt + sum_{l<=k} g dz s[l]
//   exn = cp (p / pref)^(rd / cp)
//   mtg[nz-1] = theta_s exn[nz] + g hs + dz/2 exn[nz];
//   mtg[k] = mtg[nz-1] + sum_{l=k}^{nz-2} dz exn[l+1]
//   dh[k] = rd (theta[k] exn[k] + theta[k+1] exn[k+1]) (p[k] - p[k+1])
//           / (cp g (p[k] + p[k+1]))
//   h[nz] = hs;  h[k] = hs - sum_{l=k}^{nz-1} dh[l]
//   rho[k] = s[k] (theta[k] - theta[k+1]) / (h[k] - h[k+1])
//   t[k] = (theta[k] exn[k] + theta[k+1] exn[k+1]) / (2 cp)
// Modes: 0 "mtg" (the Montgomery potential alone), 1 "dry" (p, exn, mtg, h),
// 2 "moist" (and rho, t).  Every sum runs level by level in the order of the
// plain version's cumulative sums on the CPU (ops/diagnostics_step.py), each
// product and sum rounded apart (mul_rn/add_rn): a float32 Montgomery
// potential near 3.7e5 has a last digit of about 0.03, and the pressure
// gradient carries differences of that size into the momenta.
//
// Bound on the H100: bytes.  At the flagship (161x161x120 float32) the moist
// mode reads s (12.4 MB) and writes three interface fields and three cell
// fields (87.5 MB in all, 26 us at 3.35 TB/s); one power a level is far below
// the float32 rate.  Design: the TPU kernel's triangular MXU contractions are
// its way of scanning on a matrix unit and are not carried over.  A block
// owns cpb neighbouring columns, all their levels, in shared memory.  A
// column is contiguous in k and neighbouring columns are neighbours in
// memory, so the block's s is one contiguous run of cpb nz values: it comes
// in with cp.async, 16 bytes a copy where the run's alignment allows, and
// each output of the block is one contiguous run too, written by
// consecutive threads on consecutive values.  Only the running sums are
// serial: one thread a column runs the forward sum of g dz s, and one thread
// each the backward sums of the Montgomery potential and of the height,
// reading rows of the tile at an odd stride (the threads of a warp on
// distinct banks).  Every term that does not depend on a running sum is
// formed one value a thread by all of the block's threads between the
// scans: g dz s; p and its Exner power; theta exn, dh and T; rho.  Phases,
// a barrier between each: copy s and theta in; (1) g dz s; (2) the forward
// scan; (3) p and exn (written out); (4) dh and T (written out); (5) the
// backward scans; (6) mtg, h and rho out.  Nothing is read back from device
// memory and no output serves as scratch.  kColumns columns a block (fewer
// on a grid of few columns, and where a tile of kColumns would not fit the
// shared memory of a block: one column of nz = 600 takes 19 KB in float64),
// in blocks of kThreads threads.

#include "common.cuh"

namespace {

// columns and threads a block, timed as variants on the H100 (PERF.md):
// kColumns columns a block, halved down to kMinColumns while the grid would
// have fewer than two blocks an SM (the mountain wave's 1127 columns)
constexpr int kColumns = 16;
constexpr int kMinColumns = 4;
constexpr int kThreads = 128;
// shared memory one block may take on sm_90 (227 KB)
constexpr size_t kMaxSmem = 232448;

template <typename T>
struct DiagArgs {
  const T *s, *hs, *theta;
  T *p, *exn, *mtg, *h, *rho, *t;  // p, exn, h, rho, t: null in the modes without them
  int64_t ncol;
  int nz;
  T pt, gdz, dz, half_dz, g, cp, rdcp, inv_pref, rd, cpg, half_over_cp;
};

template <typename T>
__device__ __forceinline__ T exner(const DiagArgs<T>& a, T p) {
  return tt::mul_rn(a.cp, tt::tpow(tt::mul_rn(p, a.inv_pref), a.rdcp));
}

// values of T in 16 bytes
template <typename T>
__host__ __device__ constexpr int vec() {
  return 16 / int(sizeof(T));
}

__host__ __device__ constexpr int round_up(int n, int m) { return (n + m - 1) / m * m; }

// the row stride of a scan buffer: odd, at least nz + 1
__host__ __device__ constexpr int row_stride(int nz) { return (nz + 1) | 1; }

// the shared memory of a block, in values of T: theta, the s run (each with
// room to sit at the offset of its source within 16 bytes), and the scan
// buffers P, E (and D outside mode 0), cpb rows each
template <typename T>
__host__ __device__ constexpr int smem_values(int nz, int cpb, int mode) {
  return round_up(nz + 1 + vec<T>(), vec<T>()) + round_up(cpb * nz + vec<T>(), vec<T>()) +
         (mode == 0 ? 2 : 3) * cpb * row_stride(nz);
}

// the offset, in values, of p within 16 bytes
template <typename T>
__device__ __forceinline__ int offset16(const T* p) {
  return int(reinterpret_cast<uintptr_t>(p) % 16 / sizeof(T));
}

// the run g[0, n) into s[0, n), s at the same offset within 16 bytes as g:
// 16-byte cp.async copies in the middle, one value a copy at the ends;
// closes the thread's group of copies
template <typename T>
__device__ __forceinline__ void copy_run(T* s, const T* __restrict__ g, int n) {
  constexpr int V = vec<T>();
  const int lead = (V - offset16(g)) % V;
  const int head = lead < n ? lead : n;
  const int nv = (n - head) / V;
  const int tail = head + nv * V;
  for (int e = threadIdx.x; e < head; e += kThreads) tt::cp_async<sizeof(T)>(s + e, g + e);
  for (int q = threadIdx.x; q < nv; q += kThreads) tt::cp_async<16>(s + head + q * V, g + head + q * V);
  for (int e = tail + threadIdx.x; e < n; e += kThreads) tt::cp_async<sizeof(T)>(s + e, g + e);
  tt::cp_async_commit();
}

// fn(e, c, k) for each value e = c n + k of nc rows of n values, one a
// thread, e from threadIdx.x in steps of kThreads; (c, k) stepped without a
// division
template <typename F>
__device__ __forceinline__ void for_rows(int nc, int n, F fn) {
  const int dc = kThreads / n, dk = kThreads % n;
  int c = int(threadIdx.x) / n, k = int(threadIdx.x) % n;
  for (int e = threadIdx.x; e < nc * n; e += kThreads) {
    fn(e, c, k);
    c += dc;
    k += dk;
    if (k >= n) {
      k -= n;
      ++c;
    }
  }
}

template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads) diagnostics_kernel(DiagArgs<T> a, int cpb) {
  using tt::add_rn;
  using tt::mul_rn;
  constexpr int V = vec<T>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nz = a.nz, L = nz + 1, ld = row_stride(nz);
  const int64_t c0 = int64_t(blockIdx.x) * cpb;
  const int nc = int(a.ncol - c0 < cpb ? a.ncol - c0 : cpb);
  const int tid = threadIdx.x;
  const T* s_g = a.s + c0 * nz;
  T* base = reinterpret_cast<T*>(smem_raw);
  T* th = base + offset16(a.theta);                                      // theta[k]
  T* ss = base + round_up(L + V, V) + offset16(s_g);                     // s[c nz + k]
  T* P = base + round_up(L + V, V) + round_up(cpb * nz + V, V);          // P[c ld + k]
  T* E = P + cpb * ld;                                                   // E[c ld + k]
  T* D = E + cpb * ld;                                                   // D[c ld + k]

  copy_run(th, a.theta, L);
  copy_run(ss, s_g, nc * nz);
  tt::cp_async_wait<0>();
  __syncthreads();

  // (1) g dz s[k] into P[k + 1]; P[0] = 0
  for_rows(nc, nz, [&](int e, int c, int k) { P[c * ld + k + 1] = mul_rn(a.gdz, ss[e]); });
  if (tid < nc) P[tid * ld] = T(0);
  __syncthreads();

  // (2) the forward sum, one thread a column: P[k] = sum_{l<k} g dz s[l]
  if (tid < nc) {
    T* row = P + tid * ld;
    T acc = T(0);
#pragma unroll 8
    for (int k = 1; k <= nz; ++k) {
      acc = add_rn(acc, row[k]);
      row[k] = acc;
    }
  }
  __syncthreads();

  // (3) p = pt + the sum (pt itself on the top interface: 0 + pt) and exn
  const int64_t ci = c0 * L, cc = c0 * nz;  // the block's first interface and cell values
  for_rows(nc, L, [&](int e, int c, int k) {
    const T pk = add_rn(P[c * ld + k], a.pt);
    const T ex = exner(a, pk);
    P[c * ld + k] = pk;
    E[c * ld + k] = ex;
    if (MODE != 0) {
      a.p[ci + e] = pk;
      a.exn[ci + e] = ex;
    }
  });
  __syncthreads();

  // (4) dh into D, and T
  if (MODE != 0) {
    for_rows(nc, nz, [&](int e, int c, int k) {
      const T* pr = P + c * ld + k;
      const T* er = E + c * ld + k;
      const T tex = add_rn(mul_rn(th[k], er[0]), mul_rn(th[k + 1], er[1]));
      const T pk = pr[0], pk1 = pr[1];
      D[c * ld + k] = mul_rn(mul_rn(a.rd, tex), pk - pk1) / mul_rn(a.cpg, add_rn(pk, pk1));
      if (MODE == 2) a.t[cc + e] = mul_rn(a.half_over_cp, tex);
    });
    __syncthreads();
  }

  // (5) the backward sums, one thread a column each: mtg[k] into E[k + 1]
  // (E[k + 1] read and then overwritten by the same step), h into D with
  // D[nz] = hs
  for (int task = tid; task < (MODE == 0 ? nc : 2 * nc); task += kThreads) {
    const int c = task < nc ? task : task - nc;
    const T hs = a.hs[c0 + c];
    if (task < nc) {
      T* row = E + c * ld;
      const T exn_s = row[nz];
      const T base_m = add_rn(add_rn(mul_rn(th[nz], exn_s), mul_rn(a.g, hs)), mul_rn(a.half_dz, exn_s));
      row[nz] = base_m;
      T r = T(0);
#pragma unroll 8
      for (int k = nz - 2; k >= 0; --k) {
        r = add_rn(r, mul_rn(a.dz, row[k + 1]));
        row[k + 1] = add_rn(base_m, r);
      }
    } else {
      T* row = D + c * ld;
      T rh = T(0);
#pragma unroll 8
      for (int k = nz - 1; k >= 0; --k) {
        rh = add_rn(rh, row[k]);
        row[k] = hs - rh;
      }
      row[nz] = hs;
    }
  }
  __syncthreads();

  // (6) mtg and rho on the cells, h on the interfaces
  for_rows(nc, nz, [&](int e, int c, int k) {
    a.mtg[cc + e] = E[c * ld + k + 1];
    if (MODE == 2) {
      const T* hr = D + c * ld + k;
      a.rho[cc + e] = mul_rn(ss[e], th[k] - th[k + 1]) / (hr[0] - hr[1]);
    }
  });
  if (MODE != 0) for_rows(nc, L, [&](int e, int c, int k) { a.h[ci + e] = D[c * ld + k]; });
}

template <typename T>
DiagArgs<T> make_args(const void* const* ptrs, void* const* outs, int64_t ncol, int nz, int mode,
                      const double* sc) {
  DiagArgs<T> a;
  a.s = static_cast<const T*>(ptrs[0]);
  a.hs = static_cast<const T*>(ptrs[1]);
  a.theta = static_cast<const T*>(ptrs[2]);
  a.p = a.exn = a.h = a.rho = a.t = nullptr;
  if (mode == 0) {
    a.mtg = static_cast<T*>(outs[0]);
  } else {
    T** out[] = {&a.p, &a.exn, &a.mtg, &a.h, &a.rho, &a.t};
    for (int n = 0; n < (mode == 2 ? 6 : 4); ++n) *out[n] = static_cast<T*>(outs[n]);
  }
  a.ncol = ncol;
  a.nz = nz;
  // scalars: pt, dz, g, cp, rd, pref; the products of constants are formed
  // in double and rounded once, as the plain version's Python floats are
  const double pt = sc[0], dz = sc[1], g = sc[2], cp = sc[3], rd = sc[4], pref = sc[5];
  a.pt = T(pt); a.gdz = T(g * dz); a.dz = T(dz); a.half_dz = T(0.5 * dz); a.g = T(g);
  a.cp = T(cp); a.rdcp = T(rd / cp); a.inv_pref = T(1.0 / pref); a.rd = T(rd);
  a.cpg = T(cp * g); a.half_over_cp = T(0.5 / cp);
  return a;
}

template <typename T, int MODE>
int launch_mode(const DiagArgs<T>& a, int cpb, cudaStream_t stream) {
  const size_t smem = sizeof(T) * size_t(smem_values<T>(a.nz, cpb, MODE));
  auto kernel = diagnostics_kernel<T, MODE>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return int(err);
  }
  const int64_t blocks = (a.ncol + cpb - 1) / cpb;
  kernel<<<unsigned(blocks), kThreads, smem, stream>>>(a, cpb);
  return int(cudaGetLastError());
}

// up to `columns` columns a block, as many as the shared memory of a block
// holds; an error where not even one column fits
template <typename T>
int launch_columns(const DiagArgs<T>& a, int mode, int columns, cudaStream_t stream) {
  int cpb = columns;
  while (cpb > 1 && sizeof(T) * size_t(smem_values<T>(a.nz, cpb, mode)) > kMaxSmem) --cpb;
  if (sizeof(T) * size_t(smem_values<T>(a.nz, cpb, mode)) > kMaxSmem) return int(cudaErrorInvalidValue);
  if (mode == 0) return launch_mode<T, 0>(a, cpb, stream);
  if (mode == 1) return launch_mode<T, 1>(a, cpb, stream);
  return launch_mode<T, 2>(a, cpb, stream);
}

// kColumns, halved while the grid would leave an SM with fewer than two
// blocks, down to kMinColumns; an error where the device is not readable
int columns_for(int64_t ncol, int* columns) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return int(err);
  int c = kColumns;
  while (c > kMinColumns && (ncol + c - 1) / c < 2 * int64_t(sms)) c /= 2;
  *columns = c;
  return 0;
}

}  // namespace

// ptrs: s (ncol x nz), hs (ncol), theta (nz + 1); outs by mode: 0 mtg; 1 p,
// exn, mtg, h; 2 p, exn, mtg, h, rho, t (p, exn, h: ncol x (nz + 1); the
// others ncol x nz); scalars: pt, dz, g, cp, rd, pref.  nz up to the tallest
// column one block's shared memory holds (about 5800 levels in float64 in
// mode 2, 11600 in float32)
extern "C" int tt_isentropic_diagnostics(int dtype, const void* const* ptrs, void* const* outs,
                                         int ncol, int nz, int mode, const double* scalars,
                                         cudaStream_t stream) {
  if (ncol < 1 || nz < 2 || mode < 0 || mode > 2) return int(cudaErrorInvalidValue);
  int columns = 0;
  if (const int err = columns_for(ncol, &columns)) return err;
  if (dtype == tt::kFloat32)
    return launch_columns(make_args<float>(ptrs, outs, ncol, nz, mode, scalars), mode, columns,
                          stream);
  return launch_columns(make_args<double>(ptrs, outs, ncol, nz, mode, scalars), mode, columns,
                        stream);
}
