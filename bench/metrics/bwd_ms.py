"""Device time a step of the model's backward pass: the CUDA events of the
program's ``model/backward`` span (``repro_torch.train.step``, on the
thread that runs the backward pass, from the loss's gradient to the last
leaf's), from its own record of the traced steps (``bench/record.py``)."""
from bench import record

UNIT = "ms"
MOVES = "train_tokens_per_s"


def read(view):
    return record.device_ms(view, "model/backward")
