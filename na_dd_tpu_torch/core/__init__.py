"""core (port of na_dd_tpu.core): state, semi-discrete fields, forcing."""

from na_dd_tpu_torch.core.fields import (
    Field01Base,
    FieldCsTriple,
    FieldHCsTriple,
    FieldRegHCsTriple,
)
from na_dd_tpu_torch.core.forcing import (
    ForcingFromCallables,
    ForcingFromTimeGrid,
    MMSForcingCsTriple,
    MMSForcingHCsTriple,
    MMSForcingRegHCsTriple,
    NoForcing,
)
from na_dd_tpu_torch.core.state import State, heaviside_regularized

__all__ = [
    "State",
    "heaviside_regularized",
    "Field01Base",
    "FieldCsTriple",
    "FieldHCsTriple",
    "FieldRegHCsTriple",
    "NoForcing",
    "ForcingFromCallables",
    "ForcingFromTimeGrid",
    "MMSForcingCsTriple",
    "MMSForcingHCsTriple",
    "MMSForcingRegHCsTriple",
]
