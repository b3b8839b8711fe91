"""Double-float (two-float32) arithmetic (counterpart of
:mod:`na_dd_tpu.ops.doublefloat`).

A double-float value is an unevaluated pair of float32 tensors ``hi + lo``
(|lo| ≤ ulp(hi)/2, ~2^-48 relative).  The arithmetic runs in float32 with
the classic error-free transformations: Knuth's two-sum, Dekker's
quick-two-sum and Dekker's FMA-free two-prod with Veltkamp's split.  On it
rest the DF add/mul/div, the DF 5- and 7-point stencil apply (the true
residual ``b − A·x`` of the float32 refinement at ~2^-47·‖b‖ absolute) and
the DF transcendentals exp, logistic, log, pow, sqrt, sin, cos and tanh,
accurate to a few DF ulps, with the JAX package's constants, Cody–Waite
splits, Horner degrees and clamps.

Every step is one eager torch operation of one IEEE rounding (``a * b``,
``a + b``, ``a - b``): a fused multiply-add inside Veltkamp's
``ca − (ca − a)`` would no longer split ``a``, so no ``alpha=``, ``addcmul``
or ``lerp``, and nothing here may go through ``torch.compile``, whose
generated code contracts multiply-adds.  Plain functions on tensors of
either device.  Float32 subnormals are kept (torch on the CPU and CUDA
without fast-math), where XLA:CPU flushes them: results below ~1e-31 and
the lo word of tiny ``df_exp`` values may differ from the JAX package's,
toward the exact value.

Used by :mod:`na_dd_tpu_torch.ops.df_lift` and the ``precision="df"`` and
``mixed_df`` modes of :mod:`na_dd_tpu_torch.integrators.pc_trapezoidal`.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

_F32 = torch.float32


class DF(NamedTuple):
    """An unevaluated float32 sum hi + lo (both tensors, same shape)."""

    hi: torch.Tensor
    lo: torch.Tensor


def two_sum(a, b):
    """Knuth two-sum: s + e == a + b exactly (6 float32 operations)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def fast_two_sum(a, b):
    """Dekker quick-two-sum; requires |a| ≥ |b| (or a == 0)."""
    s = a + b
    e = b - (s - a)
    return s, e


#: Veltkamp split constant for float32 (24-bit mantissa -> 12|12 halves)
_SPLIT = 4097.0  # 2**12 + 1


def two_prod(a, b):
    """Dekker two-prod: p + e == a·b exactly, FMA-free: each factor split
    into 12-bit halves whose pairwise products are exact in float32."""
    p = a * b
    ca = a * _SPLIT
    ahi = ca - (ca - a)
    alo = a - ahi
    cb = b * _SPLIT
    bhi = cb - (cb - b)
    blo = b - bhi
    e = ((ahi * bhi - p) + ahi * blo + alo * bhi) + alo * blo
    return p, e


def df_split(x) -> DF:
    """Split a float64 tensor into its (hi, lo) float32 pair."""
    hi = x.to(_F32)
    lo = (x - hi.to(x.dtype)).to(_F32)
    return DF(hi, lo)


def df_split_with_hi(x, hi) -> DF:
    """:func:`df_split` when the float32 downcast ``hi`` already exists."""
    lo = (x - hi.to(x.dtype)).to(_F32)
    return DF(hi, lo)


def df_to(x: DF, dtype):
    """The value hi + lo in ``dtype``."""
    return x.hi.to(dtype) + x.lo.to(dtype)


def df_zeros_like(a) -> DF:
    z = torch.zeros(a.shape, dtype=_F32, device=a.device)
    return DF(z, z)


def df_neg(a: DF) -> DF:
    return DF(-a.hi, -a.lo)


def df_add(a: DF, b: DF) -> DF:
    """Accurate DF + DF: stays accurate under the strong cancellation of
    the residual ``b − A·x``."""
    sh, eh = two_sum(a.hi, b.hi)
    sl, el = two_sum(a.lo, b.lo)
    eh = eh + sl
    sh, eh = fast_two_sum(sh, eh)
    eh = eh + el
    sh, eh = fast_two_sum(sh, eh)
    return DF(sh, eh)


def df_sub(a: DF, b: DF) -> DF:
    return df_add(a, df_neg(b))


def df_add_f32(a: DF, b) -> DF:
    """DF + a plain float32 tensor (the refinement's ``z += e``)."""
    sh, eh = two_sum(a.hi, b)
    eh = eh + a.lo
    sh, eh = fast_two_sum(sh, eh)
    return DF(sh, eh)


def df_mul(a: DF, b: DF) -> DF:
    """Elementwise DF × DF (the lo·lo term dropped: O(2^-48) relative)."""
    p, e = two_prod(a.hi, b.hi)
    e = e + (a.hi * b.lo + a.lo * b.hi)
    p, e = fast_two_sum(p, e)
    return DF(p, e)


def df_mask(a: DF, m32) -> DF:
    """Multiply by a 0/1 mask (exact in float32)."""
    return DF(a.hi * m32, a.lo * m32)


def _plane_shifts(stencil_cls, ops):
    """Shift callables in the plane order of the stencil NamedTuple
    (Stencil5, or Stencil7 where ``ops`` has the z shifts)."""
    table = {
        "c0": lambda w: w,
        "cxm": ops.shift_xm,
        "cxp": ops.shift_xp,
        "cym": ops.shift_ym,
        "cyp": ops.shift_yp,
    }
    if hasattr(ops, "shift_zm"):
        table["czm"] = ops.shift_zm
        table["czp"] = ops.shift_zp
    try:
        return [table[f] for f in stencil_cls._fields]
    except KeyError as exc:
        raise ValueError(
            f"df_stencil_apply: unknown plane {exc} on {stencil_cls.__name__}"
        ) from exc


def df_stencil_apply(st_hi, st_lo, ops, z: DF) -> DF:
    """A·z in double-float for an assembled stencil split by
    :func:`df_split_stencil` (Stencil5 or Stencil7; the shifts of ``ops``,
    so local, batched and halo providers all serve: shifting hi and lo
    apart is exact).  Per plane: two-prod of the hi parts plus the two
    float32 cross terms; the terms accumulate through two-sums into one
    error channel (error O(k·2^-48) for k planes)."""
    acc_h = acc_e = None
    for ch, cl, shift in zip(st_hi, st_lo, _plane_shifts(type(st_hi), ops)):
        zh = shift(z.hi)
        zl = shift(z.lo)
        p, e = two_prod(ch, zh)
        e = e + (ch * zl + cl * zh)
        if acc_h is None:
            acc_h, acc_e = p, e
        else:
            acc_h, err = two_sum(acc_h, p)
            acc_e = acc_e + (e + err)
    sh, el = fast_two_sum(acc_h, acc_e)
    return DF(sh, el)


def df_split_stencil(st, st_hi=None):
    """Split every plane of an assembled stencil; reuses the float32
    downcast ``st_hi`` where the caller made one.  Returns (st_hi, st_lo),
    two instances of type(st)."""
    cls = type(st)
    if st_hi is None:
        st_hi = cls(*(p.to(_F32) for p in st))
    st_lo = cls(*((p - h.to(p.dtype)).to(_F32) for p, h in zip(st, st_hi)))
    return st_hi, st_lo


# ---------------------------------------------------------------------------
# DF transcendentals
# ---------------------------------------------------------------------------


def _df_const(v: float) -> tuple:
    """A Python float split exactly into a pair of float32-exact floats."""
    hi = float(np.float32(v))
    lo = float(np.float32(v - hi))
    return hi, lo


def df_scale2(a: DF, p) -> DF:
    """Multiply by an exact power of two (or any float32-exact scalar)."""
    return DF(a.hi * p, a.lo * p)


def _df_add_const(a: DF, c) -> DF:
    """DF + an exactly split constant (float32-exact Python floats, which
    each operation takes as a float32 scalar)."""
    hi, lo = c
    s = df_add_f32(a, hi)
    if lo:
        s = df_add_f32(s, lo)
    return s


def _df_ones(like) -> DF:
    return DF(torch.ones_like(like), torch.zeros_like(like))


_LN2 = _df_const(math.log(2.0))
#: third Cody–Waite term: ln2 − LN2_HI − LN2_LO
_LN2_LO2 = float(np.float32(math.log(2.0) - _LN2[0] - _LN2[1]))
_INV_LN2 = float(np.float32(1.0 / math.log(2.0)))

#: 1/k! Horner coefficients of expm1 on |s| ≤ ln2/2/2^5 (series through s^7)
_EXP_COEFFS = [_df_const(1.0 / math.factorial(k)) for k in range(7, 1, -1)]

#: scaling depth of the exp argument reduction
_EXP_M = 5


def _exact_pow2(ki):
    """2^ki as an exact float32 for int32 ki in [-126, 127], from the
    exponent field."""
    return ((ki + 127) << 23).to(torch.int32).view(_F32)


def _df_ldexp(a: DF, ki) -> DF:
    """a · 2^ki with exact power-of-two factors; the two-stage split keeps
    each factor in the normal range for |ki| ≤ 252."""
    k1 = torch.div(ki, 2, rounding_mode="floor")
    k2 = ki - k1
    return df_scale2(df_scale2(a, _exact_pow2(k1)), _exact_pow2(k2))


#: float32 exp under/overflow bounds on the reduced path's input
_EXP_UNDER = -104.0
_EXP_OVER = 88.72


def _ln2_multiple(k):
    """k·ln2 as two DF pairs (the three Cody–Waite parts).  The split
    constants enter :func:`two_prod` as float32 tensors: a Python float
    there would be split in double precision."""
    p, e = two_prod(k, torch.full_like(k, _LN2[0]))
    p2, e2 = two_prod(k, torch.full_like(k, _LN2[1]))
    e2 = e2 + k * _LN2_LO2
    return DF(p, e), DF(p2, e2)


def df_exp(a: DF) -> DF:
    """exp in double-float: x = k·ln2 + r, Taylor expm1 on r/2^5, five
    squarings, scale by 2^k.  ~2-3 DF ulps relative for results ≥ ~4e-31;
    below that the lo word is a float32 subnormal, and accuracy degrades
    toward plain float32 until the underflow to 0 at −104 (inf above
    88.72)."""
    x = torch.clamp(a.hi, _EXP_UNDER, _EXP_OVER)
    xl = torch.where((a.hi > _EXP_UNDER) & (a.hi < _EXP_OVER), a.lo, 0.0)
    k = torch.round(x * _INV_LN2)  # |k| ≤ 152: exact in float32
    k1, k2 = _ln2_multiple(k)
    r = df_add(DF(x, xl), df_neg(k1))
    r = df_add(r, df_neg(k2))  # |r| ≤ ln2/2 + eps
    s = df_scale2(r, 2.0 ** (-_EXP_M))
    h = DF(torch.full_like(s.hi, _EXP_COEFFS[0][0]), torch.full_like(s.hi, _EXP_COEFFS[0][1]))
    for c in _EXP_COEFFS[1:]:
        h = _df_add_const(df_mul(h, s), c)
    h = _df_add_const(df_mul(h, s), (1.0, 0.0))
    u = df_mul(s, h)  # expm1(s)
    for _ in range(_EXP_M):  # expm1(2x) = 2u + u²
        u = df_add(df_scale2(u, 2.0), df_mul(u, u))
    ex = _df_add_const(u, (1.0, 0.0))  # exp(r)
    out = _df_ldexp(ex, k.to(torch.int32))
    zero = torch.zeros_like(a.hi)
    under = a.hi <= _EXP_UNDER
    out = DF(torch.where(under, zero, out.hi), torch.where(under, zero, out.lo))
    over = a.hi >= _EXP_OVER
    return DF(torch.where(over, math.inf, out.hi), torch.where(over, zero, out.lo))


def df_div(a: DF, b: DF) -> DF:
    """DF / DF: float32 estimate plus one long-division correction."""
    q0 = a.hi / b.hi
    p, e = two_prod(q0, b.hi)
    r = df_add(a, DF(-p, -(e + q0 * b.lo)))
    q1 = (r.hi + r.lo) / b.hi
    s, t = fast_two_sum(q0, q1)
    return DF(s, t)


def df_logistic(a: DF) -> DF:
    """1/(1+exp(−x)) in double-float (the regularized Heaviside H_η), from
    t = exp(−|x|): 1/(1+t) for x ≥ 0, t/(1+t) for x < 0, each branch to the
    full relative precision of its own value."""
    neg = a.hi < 0
    ax = DF(torch.where(neg, -a.hi, a.hi), torch.where(neg, -a.lo, a.lo))
    t = df_exp(df_neg(ax))
    denom = _df_add_const(t, (1.0, 0.0))
    sp = df_div(_df_ones(a.hi), denom)
    sn = df_div(t, denom)
    return DF(torch.where(neg, sn.hi, sp.hi), torch.where(neg, sn.lo, sp.lo))


def df_log(a: DF) -> DF:
    """log in double-float: a = m·2^K with m ∈ [2/3, 4/3) from the exponent
    field, then one Newton step y ← y + (m·exp(−y) − 1) on the float32
    estimate.  log(0) = −inf, log(<0) = nan."""
    safe = a.hi > 0
    ah = torch.where(safe, a.hi, 1.0)
    al = torch.where(safe, a.lo, 0.0)
    # a subnormal hi is first brought into the extraction's range
    tiny = ah < 2.0 ** -100
    ah = torch.where(tiny, ah * 2.0 ** 100, ah)
    al = torch.where(tiny, al * 2.0 ** 100, al)
    bits = ah.view(torch.int32)
    K = ((bits >> 23) & 0xFF) - 127
    # m in [2/3, 4/3): K + 1 where the mantissa is ≥ 1.5
    K = torch.where((bits & 0x7FFFFF) >= 0x400000, K + 1, K)
    m = _df_ldexp(DF(ah, al), -K)
    y0 = torch.log(m.hi)
    em = df_exp(DF(-y0, torch.zeros_like(y0)))
    d = _df_add_const(df_mul(m, em), (-1.0, 0.0))
    logm = df_add(DF(y0, torch.zeros_like(y0)), d)
    Keff = (K - torch.where(tiny, 100, 0)).to(_F32)
    k1, k2 = _ln2_multiple(Keff)
    res = df_add(df_add(logm, k1), k2)
    bad = torch.where(a.hi == 0, -math.inf, math.nan).to(_F32)
    return DF(torch.where(safe, res.hi, bad), torch.where(safe, res.lo, 0.0))


def df_pow(a: DF, b: DF) -> DF:
    """a**b = exp(b·log a) in double-float: a > 0 the normal path; a == 0
    gives 0 (b > 0), 1 (b == 0), inf (b < 0); a < 0 nan (integer exponents
    take :func:`na_dd_tpu_torch.ops.df_lift`'s square-and-multiply)."""
    safe = a.hi > 0
    a_safe = DF(torch.where(safe, a.hi, 1.0), torch.where(safe, a.lo, 0.0))
    res = df_exp(df_mul(b, df_log(a_safe)))
    rb = b.hi + b.lo
    zero_base = (a.hi == 0.0) & (a.lo == 0.0)
    special = torch.where(rb > 0, 0.0, torch.where(rb == 0, 1.0, math.inf))
    hi = torch.where(safe, res.hi, torch.where(zero_base, special, math.nan))
    lo = torch.where(safe, res.lo, 0.0)
    return DF(hi, lo)


def df_sqrt(a: DF) -> DF:
    """sqrt: float32 estimate and one Heron correction in DF; sqrt(0) = 0
    exactly, sqrt(<0) = nan."""
    y0 = torch.sqrt(a.hi)
    p, e = two_prod(y0, y0)
    r = df_add(a, DF(-p, -e))
    denom = y0 * 2.0
    y1 = torch.where(y0 == 0, 0.0, (r.hi + r.lo) / torch.where(denom == 0, 1.0, denom))
    s, t = fast_two_sum(y0, y1)
    return DF(s, t)


def df_rsqrt(a: DF) -> DF:
    """1/sqrt(a) in double-float (the corrected sqrt, then DF division)."""
    return df_div(_df_ones(a.hi), df_sqrt(a))


# three-part Cody–Waite split of π/2: k·π/2 subtracts exactly for |x| ≲ 1e3
_PIO2_1 = float(np.float32(math.pi / 2))
_PIO2_2 = float(np.float32(math.pi / 2 - _PIO2_1))
_PIO2_3 = float(np.float32(math.pi / 2 - _PIO2_1 - _PIO2_2))
_INV_PIO2 = float(np.float32(2.0 / math.pi))

#: sin (odd, through r^15) and cos (even, through r^16) Taylor coefficients
#: on |r| ≤ π/4, Horner in r²
_SIN_COEFFS = [_df_const((-1.0) ** k / math.factorial(2 * k + 1)) for k in range(7, 0, -1)]
_COS_COEFFS = [_df_const((-1.0) ** k / math.factorial(2 * k)) for k in range(8, 0, -1)]


def _df_sincos_reduced(a: DF):
    """(sin, cos, quadrant) after Cody–Waite reduction by π/2."""
    k = torch.round(a.hi * _INV_PIO2)
    r = a
    for part in (_PIO2_1, _PIO2_2, _PIO2_3):
        p, e = two_prod(k, torch.full_like(k, part))
        r = df_add(r, DF(-p, -e))
    r2 = df_mul(r, r)
    hs = DF(torch.full_like(r.hi, _SIN_COEFFS[0][0]), torch.full_like(r.hi, _SIN_COEFFS[0][1]))
    for c in _SIN_COEFFS[1:]:
        hs = _df_add_const(df_mul(hs, r2), c)
    hs = _df_add_const(df_mul(hs, r2), (1.0, 0.0))
    sin_r = df_mul(r, hs)
    hc = DF(torch.full_like(r.hi, _COS_COEFFS[0][0]), torch.full_like(r.hi, _COS_COEFFS[0][1]))
    for c in _COS_COEFFS[1:]:
        hc = _df_add_const(df_mul(hc, r2), c)
    cos_r = _df_add_const(df_mul(hc, r2), (1.0, 0.0))
    q = torch.remainder(k, 4.0)  # 0..3, exact for |k| < 2^24
    return sin_r, cos_r, q


def _quadrant_select(q, v0: DF, v1: DF, v2: DF, v3: DF) -> DF:
    def pick(f):
        return torch.where(q == 0, f(v0), torch.where(q == 1, f(v1),
                           torch.where(q == 2, f(v2), f(v3))))

    return DF(pick(lambda v: v.hi), pick(lambda v: v.lo))


def df_sin(a: DF) -> DF:
    """sin in double-float; absolute error a few DF ulps of |a|."""
    s, c, q = _df_sincos_reduced(a)
    return _quadrant_select(q, s, c, df_neg(s), df_neg(c))


def df_cos(a: DF) -> DF:
    """cos in double-float (see :func:`df_sin`)."""
    s, c, q = _df_sincos_reduced(a)
    return _quadrant_select(q, c, df_neg(s), df_neg(c), s)


def df_tanh(a: DF) -> DF:
    """tanh = 2σ(2x) − 1 in double-float (absolute error ~2^-48)."""
    s = df_logistic(df_scale2(a, 2.0))
    return _df_add_const(df_scale2(s, 2.0), (-1.0, 0.0))
