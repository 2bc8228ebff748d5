from .pipeline import DataConfig, make_decode_inputs, make_train_batch

__all__ = ["DataConfig", "make_decode_inputs", "make_train_batch"]
