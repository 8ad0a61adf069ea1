"""Model stack of the port (dense and hybrid families)."""

from repro_torch.models.model_zoo import Model
from repro_torch.models.params import ParamDef, init_params, params_from_numpy

__all__ = ["Model", "ParamDef", "init_params", "params_from_numpy"]
