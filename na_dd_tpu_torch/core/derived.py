"""Derived state quantities — the reference's ``StateVars`` computed set
(counterpart of :mod:`na_dd_tpu.core.derived`).

The reference caches 24 derived arrays on its state container: midpoint
averages, backward differences, and model coefficients evaluated on them.
Here they are computed on request; :func:`derived_quantities` returns the
full dict for parity with the reference's ``StateVars.into_dict``.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from na_dd_tpu_torch.core.state import State
from na_dd_tpu_torch.models.coefficients import Model01
from na_dd_tpu_torch.ops.grid import Grid
from na_dd_tpu_torch.ops.shifts import Ops
from na_dd_tpu_torch.ops.stencils import Dx_reg, Dy_reg, Mx, My


def derived_quantities(
    g: Grid, ops: Ops, model: Model01, s: State, which: Optional[List[str]] = None
) -> Dict[str, object]:
    """All derived arrays of the reference's StateVars (plus the five fields).

    Keys match reference names exactly: MxT, MyT, Mxcp, Mycp, DmxT, DmyT,
    Dmxcl, Dmycl, Dmxcd, Dmycd, Dl_Mxcp, Dl_Mycp, dDl_Mxcp, dDl_Mycp, V1T,
    V2T, dV1T, dV2T, Dd_MxcpT, Dd_MycpT, delcp_Dd_MxcpT, delcp_Dd_MycpT,
    delT_Dd_MxcpT, delT_Dd_MycpT.
    """
    mx = lambda u: Mx(ops, g, u)
    my = lambda u: My(ops, g, u)
    Mxcp, Mycp = mx(s.cp), my(s.cp)
    MxT, MyT = mx(s.T), my(s.T)
    table = {
        "cp": lambda: s.cp,
        "T": lambda: s.T,
        "cl": lambda: s.cl,
        "cd": lambda: s.cd,
        "cs": lambda: s.cs,
        "MxT": lambda: MxT,
        "MyT": lambda: MyT,
        "Mxcp": lambda: Mxcp,
        "Mycp": lambda: Mycp,
        "DmxT": lambda: Dx_reg(ops, g, s.T),
        "DmyT": lambda: Dy_reg(ops, g, s.T),
        "Dmxcl": lambda: Dx_reg(ops, g, s.cl),
        "Dmycl": lambda: Dy_reg(ops, g, s.cl),
        "Dmxcd": lambda: Dx_reg(ops, g, s.cd),
        "Dmycd": lambda: Dy_reg(ops, g, s.cd),
        "Dl_Mxcp": lambda: model.Dl(Mxcp),
        "Dl_Mycp": lambda: model.Dl(Mycp),
        "dDl_Mxcp": lambda: model.Dl(Mxcp, d=1),
        "dDl_Mycp": lambda: model.Dl(Mycp, d=1),
        "V1T": lambda: model.V1(s.T),
        "V2T": lambda: model.V2(s.T),
        "dV1T": lambda: model.V1(s.T, d=1),
        "dV2T": lambda: model.V2(s.T, d=1),
        "Dd_MxcpT": lambda: model.Dd(Mxcp, MxT),
        "Dd_MycpT": lambda: model.Dd(Mycp, MyT),
        "delcp_Dd_MxcpT": lambda: model.Dd(Mxcp, MxT, d=(1, 0)),
        "delcp_Dd_MycpT": lambda: model.Dd(Mycp, MyT, d=(1, 0)),
        "delT_Dd_MxcpT": lambda: model.Dd(Mxcp, MxT, d=(0, 1)),
        "delT_Dd_MycpT": lambda: model.Dd(Mycp, MyT, d=(0, 1)),
    }
    keys = which if which is not None else list(table)
    return {k: table[k]() for k in keys}
