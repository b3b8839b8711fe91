"""k5_roofline_pct: K5 (``csrc/bicgstab3.cu``, the kernel
``bicgstab_kernel<…Stencil7Op…>``) against its bound, 11·B·(N+1)³·8 bytes
over 3.35 TB/s or its operations over 34 TFLOP/s.  Layer: kernels."""

from portbench.metrics._solve_roofline import share


def read(ctx):
    return share(ctx, "K5", "Stencil7Op", "bicgstab_solve3")
