"""na_dd_tpu_torch — the PyTorch/CUDA port of :mod:`na_dd_tpu` for one NVIDIA
H100.

The same five-field reaction–diffusion model (cp, T, cl, cd, cs), the same
mimetic staggered finite differences and the same predictor–corrector
trapezoidal scheme as the JAX package, written as plain PyTorch functions on
tensors.  The two Pallas kernels on the main path become hand-written CUDA
C++ kernels for Hopper (``csrc/``), each beside a plain PyTorch twin that
serves tensors on the CPU.

Layout mirrors the JAX package:

* :mod:`na_dd_tpu_torch.config`       — device and dtype selection
* :mod:`na_dd_tpu_torch.ops`          — grid, shifts, stencils, inner products,
                                        quadrature, Stencil5 algebra, kernels
* :mod:`na_dd_tpu_torch.models`       — constants and Model01/Model02
* :mod:`na_dd_tpu_torch.core`         — state, fields, forcing
* :mod:`na_dd_tpu_torch.mms`          — SymPy → torch manufactured solutions
* :mod:`na_dd_tpu_torch.integrators`  — PC trapezoidal (RegHCs)
* :mod:`na_dd_tpu_torch.harness`      — MMS trial and error norms
* :mod:`na_dd_tpu_torch.convert`      — numpy/dict inputs → port objects

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with
no card and no explicit device they raise.  float64 is the default dtype.
"""

__version__ = "0.1.0"
