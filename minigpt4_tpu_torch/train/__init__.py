"""Training: the stage-1 projection trainer (``projection.py``) and the
draft head with its distillation (``draft.py``)."""

from .projection import caption_loss, make_train_step

__all__ = ["caption_loss", "make_train_step"]
