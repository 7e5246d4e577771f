"""LM substrate: layers, attention, MoE, SSM, model assembly (the port of
``repro.models``, forward only: prefill and decode)."""
from . import attention, convert, layers, model, moe, ssm
from .convert import params_from_numpy
from .layers import ParamDef, init_params
from .model import (backbone, cache_defs, decode_step, init_cache, layer_runs,
                    param_defs, prefill)

__all__ = ["ParamDef", "attention", "backbone", "cache_defs", "convert",
           "decode_step", "init_cache", "init_params", "layer_runs", "layers",
           "model", "moe", "param_defs", "params_from_numpy", "prefill",
           "ssm"]
