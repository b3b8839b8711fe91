"""Plotting helpers for convergence studies (counterpart of
:mod:`na_dd_tpu.harness.plotting`: the same figures).

Functional equivalents of the reference's notebook helpers (rate report plot
and MMS solution panel, src/notebook_studies_helpers.py:62-179) with this
framework's own presentation: a single shared style, log-log error ladders
with an explicit O(h^expected) guide line, observed rates drawn as a step
chart against the guide, and a field panel laid out around one shared
colormap.  Matplotlib is imported lazily so the compute path never depends
on it; tensors are moved to the host with ``.detach().cpu().numpy()``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

_FG = "#22313f"  # slate foreground
_ACCENT = "#0b7285"  # teal: measured data
_GUIDE = "#c2571a"  # burnt orange: expected-order guides


def _host(x) -> np.ndarray:
    """A tensor (on any device) or array-like as a NumPy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _style(ax, title: str, xlabel: str, ylabel: str):
    ax.set_title(title, color=_FG, fontsize=11, loc="left")
    ax.set_xlabel(xlabel, color=_FG)
    ax.set_ylabel(ylabel, color=_FG)
    ax.grid(True, which="both", linewidth=0.4, alpha=0.45)
    for spine in ("top", "right"):
        ax.spines[spine].set_visible(False)


def guide_exponent(xs, es, expected_rate: float) -> float:
    """Signed exponent for the O(x^±rate) guide line.

    Spatial ladders refine with GROWING x (x=N, error ~ N^-rate) while
    temporal ladders refine with SHRINKING x (x=dt, error ~ dt^+rate), so the
    sign is inferred from whether error and x move together or oppositely —
    using the LAST two nonzero levels, not the ladder endpoints: leading
    exactly-zero levels (the peaks temporal ladder's degenerate all-boundary
    grids) and pre-asymptotic wiggles would flip an endpoint-based guess."""
    xs = np.asarray(xs, dtype=float)
    es = np.asarray(es, dtype=float)
    nz = np.nonzero(es)[0]
    if len(nz) >= 2:
        i, j = nz[-2], nz[-1]
    else:
        i, j = 0, len(es) - 1
    sign = -1.0 if (es[j] - es[i]) * (xs[j] - xs[i]) < 0 else 1.0
    return sign * float(expected_rate)


def plot_errors_and_rates(
    errors: List[float],
    rates: List[float],
    x_values: List,
    x_label: str,
    title: str,
    expected_rate: Optional[float] = None,
    log_scale: bool = True,
    save_path: Optional[str] = None,
):
    """Error ladder + observed 3-point rates.

    Left: the error sequence on log-log axes, with a dashed O(x^-expected)
    guide anchored at the final point so the asymptotic regime is readable at
    a glance.  Right: observed rates as a step chart with the expected-order
    band (±0.25) shaded.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, (ax_err, ax_rate) = plt.subplots(1, 2, figsize=(11, 4.2), dpi=110)

    xs = np.asarray(x_values, dtype=float)
    es = np.asarray(errors, dtype=float)
    ax_err.plot(xs, es, marker=".", markersize=9, linewidth=1.3, color=_ACCENT)
    if expected_rate and len(xs) >= 2:
        exp = guide_exponent(xs, es, expected_rate)
        guide = es[-1] * (xs / xs[-1]) ** exp
        ax_err.plot(xs, guide, "--", linewidth=1.0, color=_GUIDE,
                    label=rf"$\mathcal{{O}}({x_label}^{{{exp:+g}}})$ guide")
        ax_err.legend(frameon=False, fontsize=9)
    if log_scale:
        ax_err.set_xscale("log", base=2)
        ax_err.set_yscale("log")
    _style(ax_err, f"{title}: combined error", x_label, "combined MMS error")

    if rates:
        rate_x = np.asarray(x_values[2 : 2 + len(rates)], dtype=float)
        ax_rate.step(rate_x, rates, where="mid", color=_ACCENT, linewidth=1.5)
        ax_rate.plot(rate_x, rates, ".", markersize=9, color=_ACCENT)
        if expected_rate:
            ax_rate.axhspan(expected_rate - 0.25, expected_rate + 0.25,
                            color=_GUIDE, alpha=0.12, lw=0)
            ax_rate.axhline(expected_rate, color=_GUIDE, linewidth=0.9,
                            linestyle=":", label=f"expected {expected_rate:g}")
            ax_rate.legend(frameon=False, fontsize=9)
        if log_scale:
            ax_rate.set_xscale("log", base=2)
        _style(ax_rate, f"{title}: observed order", x_label, "3-point rate")
    else:
        ax_rate.axis("off")
        ax_rate.text(0.5, 0.5, "fewer than 3 levels —\nno observable rate",
                     ha="center", va="center", fontsize=11, color=_FG)

    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, bbox_inches="tight")
        plt.close(fig)
        return save_path
    return fig


def visualize_mms_solution(
    mms_case,
    time_point: float = 0.1,
    save_path: Optional[str] = None,
    etas: Sequence[float] = (10.0, 100.0, 1000.0),
):
    """Snapshot of the five manufactured fields at ``time_point`` plus the
    H_eta regularization profile, as a 2×3 grid sharing one colormap per row
    (concentrations) and a dedicated one for temperature."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from na_dd_tpu_torch.core import heaviside_regularized

    grid = mms_case.grid
    xx, yy = _host(grid.xx), _host(grid.yy)
    fig, axs = plt.subplots(2, 3, figsize=(12.5, 7.5), dpi=110)

    layout = [
        ("T", "temperature T", "magma", axs[0, 0]),
        ("cp", "polymer cp", "cividis", axs[0, 1]),
        ("cl", "solvent cl", "cividis", axs[0, 2]),
        ("cd", "dissolved drug cd", "cividis", axs[1, 0]),
        ("cs", "solid drug cs", "cividis", axs[1, 1]),
    ]
    for var, label, cmap, ax in layout:
        vals = _host(getattr(mms_case, var)(time_point, grid.xx, grid.yy))
        im = ax.pcolormesh(xx, yy, vals, cmap=cmap, shading="gouraud")
        fig.colorbar(im, ax=ax, shrink=0.85, pad=0.02)
        _style(ax, label, "x", "y")
        ax.set_aspect("equal")

    ax_h = axs[1, 2]
    s = np.linspace(-0.6, 0.6, 801)
    for eta in etas:
        ax_h.plot(s, _host(heaviside_regularized(torch.from_numpy(s), eta)),
                  linewidth=1.3, label=rf"$\eta={eta:g}$")
    ax_h.axvline(0.0, color=_FG, linewidth=0.6, alpha=0.5)
    _style(ax_h, r"regularized Heaviside $H_\eta$", "cs", r"$H_\eta(cs)$")
    ax_h.legend(frameon=False, fontsize=9)

    fig.suptitle(f"manufactured solution at t = {time_point:g}", color=_FG,
                 fontsize=13, x=0.02, ha="left")
    fig.tight_layout(rect=(0, 0, 1, 0.96))
    if save_path:
        fig.savefig(save_path, bbox_inches="tight")
        plt.close(fig)
        return save_path
    return fig


def visualize_mms_solution3(
    mms_case,
    time_point: float = 0.1,
    var: str = "T",
    z_fracs: Sequence[float] = (0.25, 0.5, 0.75),
    save_path: Optional[str] = None,
):
    """Axial slices of one field of a 3-D manufactured solution: ``var`` at
    the z-planes nearest ``z_fracs`` of the domain, sharing one colormap —
    the 3-D companion of :func:`visualize_mms_solution`."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    grid = mms_case.grid
    vals = _host(getattr(mms_case, var)(time_point, grid.xx, grid.yy, grid.zz))
    xx = _host(grid.xx)[:, :, 0]
    yy = _host(grid.yy)[:, :, 0]
    z_1d = _host(grid.zz)[0, 0, :]
    ks = [int(np.argmin(np.abs(z_1d - f))) for f in z_fracs]

    fig, axs = plt.subplots(1, len(ks), figsize=(4.2 * len(ks), 3.9), dpi=110)
    axs = np.atleast_1d(axs)
    vmin, vmax = float(vals[:, :, ks].min()), float(vals[:, :, ks].max())
    im = None
    for ax, k in zip(axs, ks):
        im = ax.pcolormesh(
            xx, yy, vals[:, :, k], cmap="magma" if var == "T" else "cividis",
            shading="gouraud", vmin=vmin, vmax=vmax,
        )
        _style(ax, f"{var} at z = {z_1d[k]:.3g}", "x", "y")
        ax.set_aspect("equal")
    fig.colorbar(im, ax=list(axs), shrink=0.85, pad=0.02)
    fig.suptitle(
        f"3-D manufactured {var} at t = {time_point:g} (z slices)",
        color=_FG, fontsize=13, x=0.02, ha="left",
    )
    if save_path:
        fig.savefig(save_path, bbox_inches="tight")
        plt.close(fig)
        return save_path
    return fig
