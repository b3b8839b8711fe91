"""Differentiable simulation: adjoint gradients and calibration (counterpart
of :mod:`na_dd_tpu.harness.gradients`).

Gradients of an observable of a whole simulation with respect to the model
constants, the RegHCs regularization factor and the initial state, by
``torch.autograd``:

* every Newton solve has its implicit-function-theorem adjoint
  (``differentiable=True``; :mod:`na_dd_tpu_torch.ops.adjoint`): the reverse
  pass solves the transposed 5-point systems with the same solver (on a
  card, the BiCGStab kernel on the transposed planes) instead of
  differentiating through Krylov iterations;
* with ``remat`` each step runs under ``torch.utils.checkpoint``, so the
  reverse sweep recomputes a step's intermediates instead of storing every
  step's;
* the model constants are whatever :class:`ModelConsts` holds: a 0-d tensor
  that requires grad flows through the planes, the couplings and the
  correctors.

Typical use::

    sim = build_simulator(grid, dt=1e-3, num_steps=100)
    kd = torch.tensor(1e-2, dtype=torch.float64, device=grid.device, requires_grad=True)
    loss = ((dissolved_drug_fraction(LOCAL_OPS, grid, sim({"Kd": kd}, s0)) - measured)
            / measured) ** 2
    (g_kd,) = torch.autograd.grad(loss, (kd,))

or calibration in one call by :func:`fit_parameters`.  2-D only, as in the
JAX package.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.utils.checkpoint

from na_dd_tpu_torch.core.state import State
from na_dd_tpu_torch.harness.simulate import make_integrator
from na_dd_tpu_torch.models.coefficients import Model02
from na_dd_tpu_torch.models.consts import ModelConsts, default_model_consts
from na_dd_tpu_torch.ops.shifts import LOCAL_OPS, Ops

#: parameter keys of :func:`build_simulator` beyond the ModelConsts fields
_EXTRA_PARAMS = frozenset({"regularization_factor"})


def build_simulator(
    grid,
    *,
    dt: float,
    num_steps: int,
    t0: float = 0.0,
    variant: str = "reghcstriple",
    base_consts: ModelConsts = default_model_consts,
    model_cls=Model02,
    forcing=None,
    ops: Ops = LOCAL_OPS,
    remat: bool = True,
    **integrator_params,
) -> Callable[[Dict[str, object], State], State]:
    """``sim(params, state0) -> final State`` over ``num_steps`` steps.

    ``params`` is a (possibly empty) dict overriding fields of
    ``base_consts`` and, optionally, ``"regularization_factor"`` (the RegHCs
    eta, 50 by default); its values may be floats or 0-d tensors that
    require grad.  The integrator is :func:`make_integrator`'s with
    ``differentiable=True`` unless ``integrator_params`` says otherwise.  With
    ``remat`` each step runs under ``torch.utils.checkpoint`` (non-reentrant):
    the backward pass runs each step's forward again, its solves included.
    """
    integ_defaults = dict(differentiable=True)
    integ_defaults.update(integrator_params)

    def sim(params: Dict[str, object], state0: State) -> State:
        unknown = set(params) - set(ModelConsts._fields) - _EXTRA_PARAMS
        if unknown:
            raise ValueError(
                f"unknown parameter(s) {sorted(unknown)}; valid keys are "
                f"ModelConsts fields plus {sorted(_EXTRA_PARAMS)}"
            )
        mc = base_consts._replace(**{k: v for k, v in params.items() if k in ModelConsts._fields})
        eta_kw = ({"regularization_factor": params["regularization_factor"]}
                  if "regularization_factor" in params else {})
        integ = make_integrator(grid, model_cls(mc), variant=variant, forcing=forcing, **eta_kw,
                                **integ_defaults)

        def step(t, *fields):
            return tuple(integ.step_fn(grid, ops, State(*fields), t, dt)[0])

        ks = torch.arange(num_steps, dtype=state0.T.dtype, device=state0.T.device)
        s = tuple(state0)
        for k in range(num_steps):
            t = t0 + ks[k] * dt
            if remat:
                s = torch.utils.checkpoint.checkpoint(
                    step, t, *s, use_reentrant=False, preserve_rng_state=False
                )
            else:
                s = step(t, *s)
        return State(*s)

    return sim


def fit_parameters(
    sim: Callable[[Dict[str, object], State], State],
    observable: Callable[[State], torch.Tensor],
    target,
    params0: Dict[str, float],
    state0: State,
    *,
    num_iterations: int = 50,
    learning_rate: float = 1e-2,
    optimizer: Optional[Callable] = None,
    loss_fn: Optional[Callable] = None,
):
    """Gradient-based calibration: fit ``params`` so that
    ``observable(sim(params, state0))`` matches ``target``.

    The parameters are optimized in log space (the constants are positive
    and span ~14 orders of magnitude, so a log step is a relative change).
    ``optimizer(list_of_tensors)`` makes the ``torch.optim`` optimizer
    (default ``torch.optim.Adam(lr=learning_rate)``: the update formula of
    the JAX package's ``optax.adam``, ``eps=1e-8``).  ``loss_fn(pred,
    target)`` defaults to the target-normalized mean squared error
    ``mean(((pred − target)/scale)²)``, ``scale = max|target|`` (1 for an
    all-zero target): Adam's eps would freeze a loss of raw magnitude 1e-17.

    Returns ``(params, history)``: the fitted values as floats and the loss
    of each iteration, each taken before that iteration's update.
    """
    if loss_fn is None:
        def loss_fn(pred, tgt):
            scale = torch.amax(torch.abs(tgt))
            scale = torch.where(scale > 0, scale, torch.ones_like(scale))
            return torch.mean(((pred - tgt) / scale) ** 2)

    dtype, device = state0.T.dtype, state0.T.device
    target = torch.as_tensor(target, dtype=dtype, device=device).detach()
    log_params = {
        k: torch.log(torch.as_tensor(v, dtype=dtype, device=device)).detach().requires_grad_(True)
        for k, v in params0.items()
    }
    if optimizer is None:
        opt = torch.optim.Adam(list(log_params.values()), lr=learning_rate)
    else:
        opt = optimizer(list(log_params.values()))

    history = []
    for _ in range(num_iterations):
        opt.zero_grad()
        value = loss_fn(observable(sim({k: torch.exp(v) for k, v in log_params.items()}, state0)),
                        target)
        value.backward()
        opt.step()
        history.append(float(value.detach()))
    params = {k: float(torch.exp(v.detach())) for k, v in log_params.items()}
    return params, history
