"""Device time a step of the model's forward pass: the CUDA events of the
program's ``model/forward`` span (``repro_torch.train.step``, around
``loss_and_aux`` on the step's thread), from its own record of the
traced steps (``bench/record.py``)."""
from bench import record

UNIT = "ms"
MOVES = "train_tokens_per_s"


def read(view):
    return record.device_ms(view, "model/forward")
