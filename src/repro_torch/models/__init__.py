from .decoder import DecoderLM
from .param import P, abstract_params, init_params, param_axes, param_count
from .registry import build_model

__all__ = [
    "P",
    "abstract_params",
    "init_params",
    "param_axes",
    "param_count",
    "build_model",
    "DecoderLM",
]
