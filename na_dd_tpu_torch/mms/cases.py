"""Manufactured-solution case library (counterpart of
:mod:`na_dd_tpu.mms.cases`).

Each case is a set of five SymPy expressions fed to
:class:`~na_dd_tpu_torch.mms.engine.MMSCaseSymbolic`; the expressions are
the JAX package's, so the two packages verify the same solutions.
"""

from __future__ import annotations

from typing import List

import numpy as np
import sympy

from na_dd_tpu_torch.mms.engine import MMSCaseSymbolic, t_sym, x_sym, y_sym

_W_POLY = x_sym * (1 - x_sym) * y_sym * (1 - y_sym)


class MMSCaseStiffExpDecay(MMSCaseSymbolic):
    """W(x,y) = x(1-x)y(1-y) with per-field exponential decay rates 10× apart
    (fastest: cl) to stress stiffness."""

    def __init__(self, grid, model, *, a_base: float = 1.0):
        a_cl = a_base
        a_T = a_base / 10.0
        a_cd = a_base / 100.0
        a_cs = a_base / 100.0
        a_cp = a_base / 1000.0
        mk = lambda a: _W_POLY * sympy.exp(-a * t_sym)
        super().__init__(
            grid=grid,
            model=model,
            cp_sym_expr=mk(a_cp),
            T_sym_expr=mk(a_T),
            cl_sym_expr=mk(a_cl),
            cd_sym_expr=mk(a_cd),
            cs_sym_expr=mk(a_cs),
        )


def make_MMSCaseStiffExpDecay_cls(ref_speed):
    class the_MMSCaseStiffExpDecay(MMSCaseStiffExpDecay):
        def __init__(self, grid, model):
            super().__init__(grid=grid, model=model, a_base=ref_speed)

    return the_MMSCaseStiffExpDecay


class MMSCasePolWithOscilatingTime(MMSCaseSymbolic):
    """phi(t) = ampl (1 + shrink sin(speed t)) times the polynomial bump; all
    five fields equal."""

    def __init__(self, grid, model, *, ampl: float = 1, speed: float = 1, shrink: float = 1):
        profile = ampl * (1 + shrink * sympy.sin(speed * t_sym)) * _W_POLY
        super().__init__(
            grid=grid,
            model=model,
            cp_sym_expr=profile,
            T_sym_expr=profile,
            cl_sym_expr=profile,
            cd_sym_expr=profile,
            cs_sym_expr=profile,
        )


def make_MMSCasePolWithOscilatingTime_cls(*, ampl, speed):
    class the_MMSCasePolWithOscilatingTime(MMSCasePolWithOscilatingTime):
        def __init__(self, grid, model):
            super().__init__(grid=grid, model=model, ampl=ampl, speed=speed)

    return the_MMSCasePolWithOscilatingTime


class MMSCaseSlowlyChangingPeaks(MMSCaseSymbolic):
    """W = Const (x²+y²)³ sin(πx) sin(πy), phi = exp(-a t): small temporal
    error, large spatial error."""

    def __init__(self, grid, model, *, leading_spatial_const=1e1, evol_speed: float = 1e-1):
        W = (
            (x_sym**2 + y_sym**2) ** 3
            * sympy.sin(sympy.pi * x_sym)
            * sympy.sin(sympy.pi * y_sym)
            * leading_spatial_const
        )
        f = W * sympy.exp(-evol_speed * t_sym)
        super().__init__(
            grid=grid,
            model=model,
            cp_sym_expr=f,
            T_sym_expr=f,
            cl_sym_expr=f,
            cd_sym_expr=f,
            cs_sym_expr=f,
        )


def make_MMSCaseSlowlyChangingPeaks_cls(*, leading_spatial_const, evol_speed):
    class the_MMSCaseSlowlyChangingPeaks(MMSCaseSlowlyChangingPeaks):
        def __init__(self, grid, model):
            super().__init__(
                grid=grid,
                model=model,
                leading_spatial_const=leading_spatial_const,
                evol_speed=evol_speed,
            )

    return the_MMSCaseSlowlyChangingPeaks


# The reference's preset aliases.
MMSCaseSlowlyChangingPeaks_Slow1e1 = make_MMSCaseSlowlyChangingPeaks_cls(leading_spatial_const=1.0, evol_speed=1e-1)
MMSCaseSlowlyChangingPeaks_Slow1e2 = make_MMSCaseSlowlyChangingPeaks_cls(leading_spatial_const=1.0, evol_speed=1e-2)
MMSCaseSlowlyChangingPeaks_Slow1e3 = make_MMSCaseSlowlyChangingPeaks_cls(leading_spatial_const=1.0, evol_speed=1e-3)
MMSCaseSlowlyChangingPeaks_Slow1e4 = make_MMSCaseSlowlyChangingPeaks_cls(leading_spatial_const=1.0, evol_speed=1e-4)
MMSCaseSlowlyChangingPeaks_Slow1e8 = make_MMSCaseSlowlyChangingPeaks_cls(leading_spatial_const=1.0, evol_speed=1e-8)
MMSCaseSlowlyChangingPeaks_Slow1e16 = make_MMSCaseSlowlyChangingPeaks_cls(leading_spatial_const=1.0, evol_speed=1e-16)
MMSCaseSlowlyChangingPeaks_Fast1e1 = make_MMSCaseSlowlyChangingPeaks_cls(leading_spatial_const=1.0, evol_speed=1e1)
MMSCaseSlowlyChangingPeaks_Fast1e2 = make_MMSCaseSlowlyChangingPeaks_cls(leading_spatial_const=1.0, evol_speed=1e2)
MMSCaseSlowlyChangingPeaks_Fast1e3 = make_MMSCaseSlowlyChangingPeaks_cls(leading_spatial_const=1.0, evol_speed=1e3)
MMSCaseSlowlyChangingPeaks_Fast1e4 = make_MMSCaseSlowlyChangingPeaks_cls(leading_spatial_const=1.0, evol_speed=1e4)
MMSCaseSlowlyChangingPeaks_Fast1e8 = make_MMSCaseSlowlyChangingPeaks_cls(leading_spatial_const=1.0, evol_speed=1e8)


class MMSCasePol(MMSCaseSymbolic):
    """f = x(1-x)y(1-y)/(1+t), all five fields equal — the smooth baseline."""

    def __init__(self, grid, *, model):
        f = _W_POLY / (1 + t_sym)
        super().__init__(
            grid=grid,
            model=model,
            cp_sym_expr=f,
            T_sym_expr=f,
            cl_sym_expr=f,
            cd_sym_expr=f,
            cs_sym_expr=f,
        )


class MMSCaseExpSin(MMSCaseSymbolic):
    """Physically consistent smooth case: (T, cl, cd) solve their uncoupled
    reaction ODEs exactly and (cp, cs) integrate their own ODE exponents
    symbolically:

        W  = sin(πx) sin(πy)
        T  = exp(-2π² DT t) W
        cl = -exp(-t) W,   cd = -cl
        cp = W exp(∫₀ᵗ (-K1(1+cl) - K2 T) ds)
        cs = r_sp W exp(∫₀ᵗ -Kd (Sd - cd)(1 + cl) ds)
    """

    def __init__(self, grid, *, model):
        K1, K2, Sd, Kd, DT = model.K1, model.K2, model.Sd, model.Kd, model.DT
        pi = sympy.pi
        W = sympy.sin(pi * x_sym) * sympy.sin(pi * y_sym)
        T = sympy.exp(-2 * pi**2 * DT * t_sym) * W
        cl = -sympy.exp(-t_sym) * W
        cd = -cl

        cp_exp_prim = sympy.integrate(-K1 * (1 + cl) - K2 * T, t_sym)
        cp = W * sympy.exp(cp_exp_prim - cp_exp_prim.subs(t_sym, 0))

        cs_exp_prim = sympy.integrate(-Kd * (Sd - cd) * (1 + cl), t_sym)
        cs = (model.r_sp * W) * sympy.exp(cs_exp_prim - cs_exp_prim.subs(t_sym, 0))

        super().__init__(
            grid=grid,
            model=model,
            cp_sym_expr=cp,
            T_sym_expr=T,
            cl_sym_expr=cl,
            cd_sym_expr=cd,
            cs_sym_expr=cs,
        )


class MMSCaseCsZeroCrossing(MMSCaseSymbolic):
    """cp = T = cl = cd = 0; cs = (A - B t) W crosses zero — exercises the
    Heaviside switching."""

    def __init__(
        self,
        grid,
        model,
        *,
        cs_A: float = 0.5,
        cs_B: float = 1.0,
        spatial_profile_expr: sympy.Expr = _W_POLY,
    ):
        zero = sympy.S(0)
        cs = (sympy.Float(cs_A) - sympy.Float(cs_B) * t_sym) * spatial_profile_expr
        super().__init__(
            grid=grid,
            model=model,
            cp_sym_expr=zero,
            T_sym_expr=zero,
            cl_sym_expr=zero,
            cd_sym_expr=zero,
            cs_sym_expr=cs,
        )


class MMSCaseNonFullySmoothPol(MMSCaseSymbolic):
    """Limited-regularity solutions f = W/(1+t) |(x-θ)(y-θ)|^γ, per-field γ.
    γ ∈ (2,3] → H² not H³; γ ∈ (3,4] → H³ not H⁴.  Their second
    derivatives carry ``DiracDelta``, which the engine's printer stubs."""

    def __init__(self, grid, *, model, gamma: List[float], theta: float = 1 / np.pi):
        if np.isscalar(gamma):
            gamma = [float(gamma)]
        if not isinstance(gamma, list):
            raise TypeError("gamma must be a number or list")
        if len(gamma) == 1:
            gamma = [gamma[0]] * 5
        elif len(gamma) == 2:
            # (cp, cs) share gamma[0]; (T, cl, cd) share gamma[1].
            gamma = [gamma[0], gamma[1], gamma[1], gamma[1], gamma[0]]
        elif len(gamma) != 5:
            raise ValueError("gamma must have length 1, 2, or 5")
        if not all(gamma[j] > 1 for j in (0, 4)):
            raise ValueError("cp/cs gammas must exceed 1")
        if not all(gamma[j] > 2 for j in (1, 2, 3)):
            raise ValueError("T/cl/cd gammas must exceed 2")
        if not 0 < theta < 1:
            raise ValueError("theta must be in (0, 1)")

        base = sympy.Abs((x_sym - theta) * (y_sym - theta))
        common = _W_POLY / (1 + t_sym)
        exprs = [common * base ** gamma[j] for j in range(5)]
        super().__init__(
            grid=grid,
            model=model,
            cp_sym_expr=exprs[0],
            T_sym_expr=exprs[1],
            cl_sym_expr=exprs[2],
            cd_sym_expr=exprs[3],
            cs_sym_expr=exprs[4],
        )


def make_MMSCaseNonFullySmoothPol_cls(gamma):
    class the_MMSCaseNonFullySmoothPol(MMSCaseNonFullySmoothPol):
        def __init__(self, grid, model):
            super().__init__(grid=grid, model=model, gamma=gamma)

    return the_MMSCaseNonFullySmoothPol


MMSCaseNonFullySmoothPol_cpcsH2_TclcdH3 = make_MMSCaseNonFullySmoothPol_cls(gamma=[2.1, 3.1])
MMSCaseNonFullySmoothPol_cpcsH1_TclcdH2 = make_MMSCaseNonFullySmoothPol_cls(gamma=[1.1, 2.1])
MMSCaseNonFullySmoothPol_cpcsH2_TclcdH2 = make_MMSCaseNonFullySmoothPol_cls(gamma=2.1)
MMSCaseNonFullySmoothPol_cpcsH3_TclcdH4 = make_MMSCaseNonFullySmoothPol_cls(gamma=[3.1, 4.1])
