"""Step builders for serving; training is not ported yet."""
from .steps import make_decode_step, make_prefill_step, make_train_step  # noqa: F401
