"""k1_roofline_pct: K1 (``csrc/bicgstab.cu``, the kernel
``bicgstab_kernel<…Stencil5Op…>``) against its bound, 9·B·(N+1)²·8 bytes
over 3.35 TB/s or its operations over 34 TFLOP/s.  Layer: kernels."""

from portbench.metrics._solve_roofline import share


def read(ctx):
    return share(ctx, "K1", "Stencil5Op", "bicgstab_solve")
