"""Step functions: training (loss→grad→AdamW) and serving (prefill/decode)."""

from .steps import TrainConfig, make_decode_fn, make_prefill_fn, make_train_step

__all__ = ["TrainConfig", "make_decode_fn", "make_prefill_fn",
           "make_train_step"]
