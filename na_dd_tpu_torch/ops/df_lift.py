"""df_lift: evaluate the port's float64 code in double-float arithmetic
(counterpart of :mod:`na_dd_tpu.ops.df_lift`).

The JAX package interprets the jaxpr of a function with double-float rules.
The port has no trace to interpret: it runs the same float64 code eagerly on
:class:`DFTensor`, a tensor subclass that presents itself as a float64
tensor of the operand's shape and device and carries the pair of float32
tensors (hi, lo) of :class:`~na_dd_tpu_torch.ops.doublefloat.DF`.  Its
``__torch_dispatch__`` maps each aten operation that reaches it to the JAX
package's rule for the same primitive, one operation at a time, with no
trace to build or cache:

* structural operations (slicing, ``cat``, ``stack``, padding, views,
  ``expand``, ``clone``, indexing, ``zeros_like``) apply to hi and lo
  independently — exact; ``ones_like``/``full_like`` fill with the split
  value;
* add/sub/mul/div/reciprocal/neg run the error-free DF algorithms of
  :mod:`~na_dd_tpu_torch.ops.doublefloat`, and so do sqrt, rsqrt, abs, exp,
  log, sigmoid (the H_η logistic), sin, cos and tanh;
* ``pow`` with an integer-valued Python exponent |y| ≤ 64 is DF
  square-and-multiply (a negative base stays defined, where
  ``exp(y·log a)`` is NaN), any other ``pow`` the DF ``exp(b·log a)``;
* comparisons, ``sign``, ``maximum``/``minimum`` and conversions to an
  integer or bool dtype decide on the reconstructed float64 value (NaN
  propagating as in ``torch.maximum``); ``amax``/``amin`` reduce the
  float32 image ``hi + lo``;
* every other operation is a float64 passthrough (reconstruct, call,
  split), counted per operation by :func:`df_lift_report`, as in the JAX
  package.

A plain float tensor or a Python number that meets a DF operand is split
on demand (a plain tensor once per call of :func:`df_call`; a number once
per value and device, as a cached 0-d pair): the grid metrics, the model
constants, the time tables' rows.  Operations on plain tensors alone never
reach the rules and stay float64.  In-place operations on a DF operand
raise.  The solves never see a DF value: the integrators hand the kernel
wrappers the plain float32 ``hi`` tensors.
"""

from __future__ import annotations

import collections
import math
from functools import partial
from typing import Callable

import torch
from torch.utils import _pytree as pytree

from na_dd_tpu_torch.ops.doublefloat import (
    DF,
    df_add,
    df_cos,
    df_div,
    df_exp,
    df_log,
    df_logistic,
    df_mul,
    df_neg,
    df_pow,
    df_rsqrt,
    df_sin,
    df_split,
    df_sqrt,
    df_tanh,
    df_to,
)

_F32 = torch.float32
_F64 = torch.float64


class DFTensor(torch.Tensor):
    """A float64-presenting tensor whose value is the double-float pair
    (``hi``, ``lo``) of float32 tensors it carries."""

    @staticmethod
    def __new__(cls, hi, lo):
        t = torch.Tensor._make_wrapper_subclass(
            cls, hi.shape, strides=hi.stride(), dtype=_F64, device=hi.device
        )
        t.hi = hi
        t.lo = lo
        return t

    __torch_function__ = torch._C._disabled_torch_function_impl

    def __repr__(self):
        return f"DFTensor(hi={self.hi!r}, lo={self.lo!r})"

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        return _dispatch(func, args, kwargs or {})


def _wrap(d: DF) -> DFTensor:
    return DFTensor(d.hi, d.lo)


def _pair(t: DFTensor) -> DF:
    return DF(t.hi, t.lo)


# ---------------------------------------------------------------------------
# splitting plain operands on demand
# ---------------------------------------------------------------------------

#: plain tensors split during the current df_call: id -> (tensor, DF); the
#: tensor is held so that its id stays its own until the call ends
_CALL_SPLITS: list[dict] = []

#: split Python numbers: (value, device) -> DF of 0-d float32 tensors
_CONSTS: dict = {}
_CONSTS_MAX = 4096


def _split_number(v: float, device) -> DF:
    key = (float(v), str(device))
    d = _CONSTS.get(key)
    if d is None:
        if len(_CONSTS) >= _CONSTS_MAX:
            _CONSTS.clear()
        d = _CONSTS[key] = df_split(torch.tensor(float(v), dtype=_F64, device=device))
    return d


def _split_plain(t: torch.Tensor, device) -> DF:
    if t.dim() == 0 and t.device.type == "cpu" and device.type != "cpu":
        # a wrapped Python number: no host-to-device copy
        return _split_number(t.item(), device)
    cache = _CALL_SPLITS[-1] if _CALL_SPLITS else None
    if cache is not None and id(t) in cache:
        return cache[id(t)][1]
    d = df_split(t.to(device=device, dtype=_F64))
    if cache is not None:
        cache[id(t)] = (t, d)
    return d


def _as_df(v, device) -> DF:
    """A DF operand: a DFTensor's pair, a plain tensor or a number split."""
    if isinstance(v, DFTensor):
        return _pair(v)
    if isinstance(v, torch.Tensor):
        return _split_plain(v, device)
    return _split_number(v, device)


def _reconstruct(v):
    if isinstance(v, DFTensor):
        return df_to(_pair(v), _F64)
    if isinstance(v, (list, tuple)):
        return type(v)(_reconstruct(x) for x in v)
    return v


def _is_float_tensor(v) -> bool:
    return isinstance(v, torch.Tensor) and v.dtype.is_floating_point


def _split_out(o):
    """A passthrough's output back to DF where it is a float tensor."""
    if _is_float_tensor(o):
        return _wrap(df_split(o.to(_F64)))
    if isinstance(o, (list, tuple)):
        return type(o)(_split_out(x) for x in o)
    return o


# ---------------------------------------------------------------------------
# rules
# ---------------------------------------------------------------------------


def _df_integer_pow(a: DF, y: int) -> DF:
    if y == 0:
        return DF(torch.ones_like(a.hi), torch.zeros_like(a.hi))
    if y < 0:
        one = DF(torch.ones_like(a.hi), torch.zeros_like(a.hi))
        return df_div(one, _df_integer_pow(a, -y))
    result = None
    base = a
    n = y
    while n:  # square-and-multiply in DF
        if n & 1:
            result = base if result is None else df_mul(result, base)
        n >>= 1
        if n:
            base = df_mul(base, base)
    return result


def _df_abs(a: DF) -> DF:
    neg = a.hi < 0
    return DF(torch.where(neg, -a.hi, a.hi), torch.where(neg, -a.lo, a.lo))


def _df_select(pred, a: DF, b: DF) -> DF:
    return DF(torch.where(pred, a.hi, b.hi), torch.where(pred, a.lo, b.lo))


def _df_minmax(ge: bool):
    """max/min deciding on the reconstructed float64 values and propagating
    NaN like ``torch.maximum``/``minimum``."""

    def rule(a: DF, b: DF) -> DF:
        ra, rb = df_to(a, _F64), df_to(b, _F64)
        res = _df_select(ra >= rb if ge else ra <= rb, a, b)
        isnan = torch.isnan(ra) | torch.isnan(rb)
        nan = torch.full(torch.broadcast_shapes(a.hi.shape, b.hi.shape), math.nan,
                         dtype=_F32, device=a.hi.device)
        return _df_select(isnan, DF(nan, nan), res)

    return rule


def _df_sign(a: DF) -> DF:
    return DF(torch.sign(df_to(a, _F64)).to(_F32), torch.zeros_like(a.hi))


def _df_reciprocal(a: DF) -> DF:
    return df_div(DF(torch.ones_like(a.hi), torch.zeros_like(a.hi)), a)


_UNARY = {
    "neg": df_neg,
    "sqrt": df_sqrt,
    "rsqrt": df_rsqrt,
    "abs": _df_abs,
    "sign": _df_sign,
    "exp": df_exp,
    "log": df_log,
    "sigmoid": df_logistic,
    "sin": df_sin,
    "cos": df_cos,
    "tanh": df_tanh,
    "reciprocal": _df_reciprocal,
}

_BINARY = {
    "mul": df_mul,
    "div": df_div,
    "maximum": _df_minmax(ge=True),
    "minimum": _df_minmax(ge=False),
}

#: reductions decided on the float32 image hi + lo (they seed comparisons
#: and early exits, where float32 granularity only moves an ulp-edge call)
_REDUCTIONS = frozenset({"amax", "amin"})

_COMPARES = frozenset({"eq", "ne", "lt", "le", "gt", "ge"})

#: layout operations, exact on hi and lo apart
_STRUCTURAL = frozenset({
    "slice", "select", "cat", "stack", "constant_pad_nd", "view", "_unsafe_view",
    "expand", "permute", "transpose", "unsqueeze", "squeeze", "clone", "alias",
    "detach", "index", "index_select", "zeros_like", "empty_like",
})

_passthrough_counter: collections.Counter = collections.Counter()


def df_lift_report(reset: bool = False) -> dict:
    """Operation -> count of float64 passthroughs since process start (or
    since the last ``reset=True`` call): where emulated-float64 work remains
    in a lifted evaluation.  Tests that assert on the report pass
    ``reset=True`` first so earlier lifts in the process don't leak in."""
    report = dict(_passthrough_counter)
    if reset:
        _passthrough_counter.clear()
    return report


def _device_of(args):
    for a in pytree.tree_leaves(args):
        if isinstance(a, DFTensor):
            return a.device
    raise AssertionError("df_lift: no DF operand")  # pragma: no cover


def _structural(func, args, kwargs, device):
    """Apply ``func`` to the hi and the lo channel apart; plain float tensors
    among the operands are split first (duplicating them into both channels
    would count their value twice)."""

    def channel(k):
        def pick(v):
            if isinstance(v, DFTensor):
                return v.hi if k == 0 else v.lo
            if _is_float_tensor(v):
                d = _split_plain(v, device)
                return d.hi if k == 0 else d.lo
            return v

        return pytree.tree_map(pick, (args, kwargs))

    (ah, kh), (al, kl) = channel(0), channel(1)
    return DFTensor(func(*ah, **kh), func(*al, **kl))


def _like_fill(name, args, kwargs):
    """ones_like / full_like of a DF operand: the fill value split, in the
    operand's shape."""
    a = args[0]
    v = 1.0 if name == "ones_like" else args[1]
    dtype = kwargs.get("dtype")
    if dtype is not None and not dtype.is_floating_point:
        return torch.full(a.shape, v, dtype=dtype, device=a.device)
    d = _split_number(v, a.device)
    return DFTensor(d.hi.expand(a.shape).clone(), d.lo.expand(a.shape).clone())


def _passthrough(func, name, args, kwargs):
    _passthrough_counter[name] += 1
    kwargs = {k: _reconstruct(v) for k, v in kwargs.items()}
    return _split_out(func(*_reconstruct(list(args)), **kwargs))


def _dispatch(func, args, kwargs):
    name = func.overloadpacket.__name__
    if func._schema.is_mutable:
        raise NotImplementedError(f"df_lift: in-place {func} on a double-float operand")
    if name == "_to_copy":
        a = args[0]
        dtype = kwargs.get("dtype", a.dtype)
        device = kwargs.get("device", a.device) or a.device
        if dtype is not None and not dtype.is_floating_point:
            return _reconstruct(a).to(dtype=dtype, device=device)
        # every float is DF here, as in the JAX interpreter
        return DFTensor(a.hi.to(device), a.lo.to(device))
    if name == "_local_scalar_dense":
        return _reconstruct(args[0]).item()
    device = _device_of((args, kwargs))
    if name in _STRUCTURAL:
        return _structural(func, args, kwargs, device)
    if name in ("ones_like", "full_like"):
        return _like_fill(name, args, kwargs)
    if name in _COMPARES:
        return func(*_reconstruct(list(args)), **kwargs)
    if name == "where":
        pred, a, b = args
        return _wrap(_df_select(pred, _as_df(a, device), _as_df(b, device)))
    if name in _UNARY and len(args) == 1 and not kwargs:
        return _wrap(_UNARY[name](_pair(args[0])))
    if name in ("add", "sub", "rsub") and len(args) == 2:
        a, b = _as_df(args[0], device), _as_df(args[1], device)
        alpha = kwargs.get("alpha", 1)
        if name == "rsub":  # other − alpha·self
            a, b = b, a
        if alpha != 1:
            b = df_mul(b, _split_number(alpha, device))
        return _wrap(df_add(a, b if name == "add" else df_neg(b)))
    if name in _BINARY and len(args) == 2 and not kwargs:
        return _wrap(_BINARY[name](_as_df(args[0], device), _as_df(args[1], device)))
    if name == "pow":
        base, y = args
        if (not isinstance(y, torch.Tensor) and float(y).is_integer()
                and abs(float(y)) <= 64 and isinstance(base, DFTensor)):
            return _wrap(_df_integer_pow(_pair(base), int(float(y))))
        return _wrap(df_pow(_as_df(base, device), _as_df(y, device)))
    if name in _REDUCTIONS and isinstance(args[0], DFTensor):
        a = args[0]
        v = func(a.hi + a.lo, *args[1:], **kwargs)
        return DFTensor(v, torch.zeros_like(v))
    return _passthrough(func, name, args, kwargs)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def _is_df(x) -> bool:
    return isinstance(x, DF)


def _call(fn, args, out, device):
    def lift(leaf):
        if isinstance(leaf, DF):
            return _wrap(leaf)
        if _is_float_tensor(leaf):
            return _wrap(df_split(leaf.to(_F64)))
        if isinstance(leaf, float):
            d = _split_number(leaf, device)
            return DFTensor(d.hi, d.lo)
        return leaf

    lifted = pytree.tree_map(lift, args, is_leaf=_is_df)
    _CALL_SPLITS.append({})
    try:
        with torch.no_grad():
            res = fn(*lifted)
    finally:
        _CALL_SPLITS.pop()

    def lower(leaf):
        if isinstance(leaf, DFTensor):
            return df_to(_pair(leaf), _F64) if out == "f64" else _pair(leaf)
        if out == "df" and _is_float_tensor(leaf):
            return df_split(leaf.to(_F64))
        return leaf

    return pytree.tree_map(lower, res)


def _device_of_args(args):
    for leaf in pytree.tree_leaves(args, is_leaf=_is_df):
        if isinstance(leaf, DF):
            return leaf.hi.device
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    return torch.device("cpu")


def df_call(fn: Callable, *args, out: str = "f64"):
    """Evaluate ``fn(*args)`` in double-float.

    ``args`` is any pytree of float64 tensors and numbers (non-float leaves
    pass through); every float leaf is split into a :class:`DFTensor`, and
    ``fn`` — ordinary float64 torch code — runs on them.  ``out="f64"``
    reconstructs the float outputs to float64, ``out="df"`` returns
    :class:`~na_dd_tpu_torch.ops.doublefloat.DF` pairs."""
    return _call(fn, args, out, _device_of_args(args))


def df_lift(fn: Callable, out: str = "f64") -> Callable:
    """``fn`` computed in double-float (:func:`df_call`)."""
    return partial(df_call, fn, out=out)


def df_call_df(fn: Callable, *args, out: str = "df"):
    """:func:`df_call` where the float leaves of ``args`` may already be
    :class:`~na_dd_tpu_torch.ops.doublefloat.DF` pairs: the composition entry
    point of the double-float step, which carries its state as DF through
    several lifted stages without a float64 round trip."""
    return _call(fn, args, out, _device_of_args(args))
