"""three_d (port of na_dd_tpu.three_d: the RegHCs MMS study path).

The 3-D extension on (N+1, M+1, P+1) grids: ``grid``, ``shifts``,
``stencils``, ``inner_products``, ``quadrature`` (discretization),
``diffusion`` (Stencil7 planes), ``fields``, ``forcing``, ``mms`` (physics),
``integrator`` (the 2-D PC step with Stencil7 Newton planes) and ``harness``
(``make_setup3``, ``build_runner3``, ``run_trial3``, ``mms_error3``).  The
Newton solves run through the hand-written 7-point kernels of
:mod:`na_dd_tpu_torch.ops.kernels` on CUDA tensors.
"""
