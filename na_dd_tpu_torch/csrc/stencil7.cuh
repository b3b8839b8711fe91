// Shared 7-point stencil apply at one grid point, used by the stencil7 and
// bicgstab3 kernels.
//
// Layout is the JAX package's: an (n0, n1, n2) row-major volume, axis 0 = i
// (x), axis 1 = j (y), axis 2 = l (z, contiguous).  Zero inflow: a neighbour
// outside the volume reads as 0, exactly the shift semantics of
// na_dd_tpu/three_d/shifts.py; the faces are zeroed by index.
//
//   out[i,j,l] = c0*u + cxm*u[i-1] + cxp*u[i+1] + cym*u[j-1] + cyp*u[j+1]
//                + czm*u[l-1] + czp*u[l+1]      (summed left to right)
#pragma once

#include <cuda_runtime.h>

#include "stencil5.cuh"  // load_u

// The 7-point sum at flat index k of the values u(k') that the callable `u`
// gives at the point and its neighbours; a neighbour outside the volume reads
// as 0 and `u` is not called there (see stencil5_of).
template <typename T, class U>
__device__ __forceinline__ T stencil7_of(
    U u, const T* __restrict__ c0, const T* __restrict__ cxm,
    const T* __restrict__ cxp, const T* __restrict__ cym,
    const T* __restrict__ cyp, const T* __restrict__ czm,
    const T* __restrict__ czp, int k, int n0, int n1, int n2) {
  const int plane = n1 * n2;
  const int i = k / plane;
  const int rem = k - i * plane;
  const int j = rem / n2;
  const int l = rem - j * n2;
  const T zero = T(0);
  const T u0 = u(k);
  const T uxm = i > 0 ? u(k - plane) : zero;
  const T uxp = i < n0 - 1 ? u(k + plane) : zero;
  const T uym = j > 0 ? u(k - n2) : zero;
  const T uyp = j < n1 - 1 ? u(k + n2) : zero;
  const T uzm = l > 0 ? u(k - 1) : zero;
  const T uzp = l < n2 - 1 ? u(k + 1) : zero;
  return __ldg(c0 + k) * u0 + __ldg(cxm + k) * uxm + __ldg(cxp + k) * uxp +
         __ldg(cym + k) * uym + __ldg(cyp + k) * uyp + __ldg(czm + k) * uzm +
         __ldg(czp + k) * uzp;
}

template <typename T, bool kCoherent>
__device__ __forceinline__ T stencil7_at(
    const T* u, const T* __restrict__ c0, const T* __restrict__ cxm,
    const T* __restrict__ cxp, const T* __restrict__ cym,
    const T* __restrict__ cyp, const T* __restrict__ czm,
    const T* __restrict__ czp, int k, int n0, int n1, int n2) {
  return stencil7_of<T>([u](int m) { return load_u<T, kCoherent>(u, m); }, c0,
                        cxm, cxp, cym, cyp, czm, czp, k, n0, n1, n2);
}
