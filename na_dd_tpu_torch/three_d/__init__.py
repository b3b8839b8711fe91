"""three_d (port of na_dd_tpu.three_d): the 3-D MMS study path.

The 3-D extension on (N+1, M+1, P+1) grids: ``grid``, ``shifts``,
``stencils``, ``inner_products``, ``quadrature`` (discretization),
``diffusion`` (Stencil7 planes), ``fields``, ``forcing``, ``mms`` (physics),
``integrator`` (the 2-D PC step with Stencil7 Newton planes, its Cs, HCs and
RegHCs variants, and forward Euler), ``harness`` (``make_setup3``,
``make_integrator3``, ``build_runner3``, ``run_trial3``, ``mms_error3``, the
batched η sweep ``run_eta_sweep3``) and ``batched_ladder`` (the study ladder
as one batch of levels).
The Newton solves run through the hand-written 7-point kernels of
:mod:`na_dd_tpu_torch.ops.kernels` on CUDA tensors.

The package names below are resolved on first use: the 2-D solver backend
imports ``three_d.diffusion``, and an eager import of the 3-D integrators
here would import the 2-D integrators back while they load.
"""

import importlib

_EXPORTS = {
    "grid": ("Grid3", "make_grid3", "make_uniform_grid3"),
    "shifts": ("BATCHED_OPS3", "BatchedOps3", "HaloOps3", "LOCAL_OPS3", "LocalOps3", "Ops3"),
    "stencils": ("Dx_reg3", "Dx_star3", "Dy_reg3", "Dy_star3", "Dz_reg3", "Dz_star3",
                 "Mx3", "My3", "Mz3", "grad_H3"),
    "inner_products": ("inner_H3", "inner_p3", "norm_H3", "norm_p3"),
    "quadrature": ("avg_int3",),
    "diffusion": ("Stencil7", "advection_planes3", "crank_nicolson_heat_step",
                  "diffusion_apply3", "diffusion_planes3", "heat_mms_error",
                  "midpoint_coupling_planes3", "newton_planes3", "probe_stencil3",
                  "stencil_add_diag3"),
    "fields": ("Field3Base", "FieldCsTriple3", "FieldHCsTriple3", "FieldRegHCsTriple3"),
    "forcing": ("Forcing3Base", "MMSForcingCsTriple3", "MMSForcingHCsTriple3",
                "MMSForcingRegHCsTriple3", "NoForcing3"),
    "integrator": ("ForwardEulerIntegrator3", "PCTrapezoidalCsTriple3",
                   "PCTrapezoidalHCsTriple3", "PCTrapezoidalRegHCsTriple3"),
    "mms": ("MMSCaseCsZeroCrossing3", "MMSCaseExpSin3", "MMSCasePol3", "MMSCaseSymbolic3",
            "pack_symbolic_txyz_with_derivatives", "state_from_mms_when3", "z_sym"),
    "harness": ("build_runner3", "err_sq3", "make_integrator3", "make_setup3", "mms_error3",
                "run_eta_sweep3", "run_trial3"),
    "batched_ladder": ("pad_grid3", "pad_state3", "run_spatial_ladder3_batched"),
}
_MODULE_OF = {name: module for module, names in _EXPORTS.items() for name in names}

__all__ = sorted(_MODULE_OF)


def __getattr__(name):
    if name in _MODULE_OF:
        return getattr(importlib.import_module(f"{__name__}.{_MODULE_OF[name]}"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
