from .decoder import DecoderLM
from .encdec import EncDecLM
from .hybrid import HybridLM
from .param import P, abstract_params, init_params, param_axes, param_count
from .registry import build_model
from .ssm import SSMLM

__all__ = [
    "P",
    "abstract_params",
    "init_params",
    "param_axes",
    "param_count",
    "build_model",
    "DecoderLM",
    "EncDecLM",
    "HybridLM",
    "SSMLM",
]
