"""Training substrate: AdamW, step builders, gradient compression."""
from .optim import adamw_init, adamw_update  # noqa: F401
from .steps import make_decode_step, make_prefill_step, make_train_step  # noqa: F401
