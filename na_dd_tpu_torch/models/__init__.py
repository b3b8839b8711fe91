"""models (port of na_dd_tpu.models)."""

from na_dd_tpu_torch.models.coefficients import Model01, Model02
from na_dd_tpu_torch.models.consts import ModelConsts, default_model_consts

__all__ = ["ModelConsts", "default_model_consts", "Model01", "Model02"]
