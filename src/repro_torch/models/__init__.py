"""Model stack of the port (the dense, MoE, vlm, audio, hybrid and ssm
families)."""

from repro_torch.models.model_zoo import Model, get_model
from repro_torch.models.params import (
    ParamDef,
    init_params,
    opt_state_from_numpy,
    params_from_numpy,
)

__all__ = ["Model", "get_model", "ParamDef", "init_params", "opt_state_from_numpy",
           "params_from_numpy"]
