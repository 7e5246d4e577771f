"""LM substrate: layers, attention, MoE, SSM, model assembly (the port of
``repro.models``: the training loss, prefill and decode)."""
from . import attention, convert, layers, model, moe, ssm
from .convert import params_from_numpy
from .layers import ParamDef, init_params
from .model import (_xent_chunked, backbone, cache_defs, decode_step,
                    init_cache, layer_runs, loss_fn, param_defs, prefill)

__all__ = ["ParamDef", "_xent_chunked", "attention", "backbone", "cache_defs",
           "convert", "decode_step", "init_cache", "init_params", "layer_runs",
           "layers", "loss_fn", "model", "moe", "param_defs",
           "params_from_numpy", "prefill", "ssm"]
