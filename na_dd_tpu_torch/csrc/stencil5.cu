// K2: the 5-point stencil apply for Hopper (sm_90a).
//
// Replaces: stencil5_apply_pallas, na_dd_tpu/ops/pallas_kernels.py:523
// (body _stencil5_kernel :38, shifts _shifted :50), a single-block kernel
// that holds u and the five planes in VMEM.
//
// Bound on the card: bytes.  Each output point reads 6 values (u and five
// coefficients) and writes one, 1.5 operations per byte at most — far below
// the H100's ratio of peak f64 rate to memory rate.  At the main path's
// 257 x 257 plane in f64 that is 7 x 257^2 x 8 B = 3.70 MB, about 1.1 us at
// 3.35 TB/s, so at this size one launch's latency (a few us) dominates.
//
// Design: one thread per output point, 32 x 8 blocks with threadIdx.x along
// the contiguous axis j, so each warp's loads of u and of the planes
// coalesce; the neighbour reads of u at i +- 1 are served by L1/L2 from the
// rows the neighbouring warps load.  The ragged edge (257 is odd) is masked
// per thread and the four edges read zero inflow.  Nothing is staged in
// shared memory: a plane never fits one SM here, and the reuse of u is only
// 5x, which the caches already capture.
//
// Batch: a stack of nb planes (the leading dimension jax.vmap gives) in one
// launch, blockIdx.z the plane; each plane is offset on its own and has its
// own zero inflow, so no row of one plane reads a row of the next.
#include <cuda_runtime.h>

#include "stencil5.cuh"

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

template <typename T>
__global__ void __launch_bounds__(kBlockX* kBlockY)
    stencil5_apply_kernel(const T* __restrict__ u, const T* __restrict__ c0,
                          const T* __restrict__ cxm, const T* __restrict__ cxp,
                          const T* __restrict__ cym, const T* __restrict__ cyp,
                          T* __restrict__ out, int n0, int n1) {
  const int j = blockIdx.x * kBlockX + threadIdx.x;
  const int i = blockIdx.y * kBlockY + threadIdx.y;
  if (i >= n0 || j >= n1) return;
  const size_t off = static_cast<size_t>(blockIdx.z) * n0 * n1;
  out[off + i * n1 + j] =
      stencil5_at<T, false>(u + off, c0 + off, cxm + off, cxp + off,
                            cym + off, cyp + off, i, j, n0, n1);
}

template <typename T>
int launch(const T* u, const T* c0, const T* cxm, const T* cxp, const T* cym,
           const T* cyp, T* out, int nb, int n0, int n1, void* stream) {
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((n1 + kBlockX - 1) / kBlockX, (n0 + kBlockY - 1) / kBlockY,
                  nb);
  stencil5_apply_kernel<T><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      u, c0, cxm, cxp, cym, cyp, out, n0, n1);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int stencil5_apply_f64(const double* u, const double* c0, const double* cxm,
                       const double* cxp, const double* cym, const double* cyp,
                       double* out, int nb, int n0, int n1, void* stream) {
  return launch<double>(u, c0, cxm, cxp, cym, cyp, out, nb, n0, n1, stream);
}

int stencil5_apply_f32(const float* u, const float* c0, const float* cxm,
                       const float* cxp, const float* cym, const float* cyp,
                       float* out, int nb, int n0, int n1, void* stream) {
  return launch<float>(u, c0, cxm, cxp, cym, cyp, out, nb, n0, n1, stream);
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
