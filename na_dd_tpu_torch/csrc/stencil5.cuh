// Shared 5-point stencil apply at one grid point, used by the stencil5,
// bicgstab and triple_solve kernels.
//
// Layout is the JAX package's: an (n0, n1) row-major plane, axis 0 = i (x),
// axis 1 = j (y, contiguous).  Zero inflow: a neighbour outside the plane
// reads as 0, exactly the shift semantics of na_dd_tpu/ops/shifts.py.
//
//   out[i,j] = c0*u[i,j] + cxm*u[i-1,j] + cxp*u[i+1,j] + cym*u[i,j-1]
//              + cyp*u[i,j+1]            (summed left to right)
#pragma once

#include <cuda_runtime.h>

// Loads of the operand u.  kCoherent selects __ldcg (L2 only, no L1): the
// solve kernel reads neighbours that other blocks wrote in the same launch,
// which a stale L1 line must never shadow.  The stand-alone apply reads u
// through the read-only path.
template <typename T, bool kCoherent>
__device__ __forceinline__ T load_u(const T* u, int k) {
  if (kCoherent) return __ldcg(u + k);
  return __ldg(u + k);
}

// The 5-point sum at (i, j) of the values u(k') that the callable `u` gives
// at the flat indices k' of the point and its neighbours; a neighbour outside
// the plane reads as 0 and `u` is not called there.  The solve kernels pass
// a callable that recomputes a value from the arrays it is made of, the
// applies one that loads it.
template <typename T, class U>
__device__ __forceinline__ T stencil5_of(U u, const T* __restrict__ c0,
                                         const T* __restrict__ cxm,
                                         const T* __restrict__ cxp,
                                         const T* __restrict__ cym,
                                         const T* __restrict__ cyp, int i,
                                         int j, int n0, int n1) {
  const int k = i * n1 + j;
  const T zero = T(0);
  const T u0 = u(k);
  const T uxm = i > 0 ? u(k - n1) : zero;
  const T uxp = i < n0 - 1 ? u(k + n1) : zero;
  const T uym = j > 0 ? u(k - 1) : zero;
  const T uyp = j < n1 - 1 ? u(k + 1) : zero;
  return __ldg(c0 + k) * u0 + __ldg(cxm + k) * uxm + __ldg(cxp + k) * uxp +
         __ldg(cym + k) * uym + __ldg(cyp + k) * uyp;
}

template <typename T, bool kCoherent>
__device__ __forceinline__ T stencil5_at(const T* u, const T* __restrict__ c0,
                                         const T* __restrict__ cxm,
                                         const T* __restrict__ cxp,
                                         const T* __restrict__ cym,
                                         const T* __restrict__ cyp, int i,
                                         int j, int n0, int n1) {
  return stencil5_of<T>([u](int k) { return load_u<T, kCoherent>(u, k); }, c0,
                        cxm, cxp, cym, cyp, i, j, n0, n1);
}

// The 5-point operator on an (n0, n1) plane, flat index k = i * n1 + j, as
// the solve kernels take it: apply_of(u, k) sums the values the callable u
// gives; apply(u, k) reads an array through L2 (kCoherent), since other
// blocks wrote it in the same launch.
template <typename T>
struct Stencil5Op {
  const T* c0;
  const T* cxm;
  const T* cxp;
  const T* cym;
  const T* cyp;
  int n0;
  int n1;

  __host__ __device__ int size() const { return n0 * n1; }

  // The operator of the plane `off` points further on (a batch's next
  // system).
  __device__ Stencil5Op offset(size_t off) const {
    return Stencil5Op{c0 + off, cxm + off, cxp + off, cym + off, cyp + off,
                      n0, n1};
  }

  template <class U>
  __device__ __forceinline__ T apply_of(U u, int k) const {
    const int i = k / n1;
    const int j = k - i * n1;
    return stencil5_of<T>(u, c0, cxm, cxp, cym, cyp, i, j, n0, n1);
  }

  __device__ __forceinline__ T apply(const T* u, int k) const {
    return apply_of([u](int m) { return load_u<T, true>(u, m); }, k);
  }
};
