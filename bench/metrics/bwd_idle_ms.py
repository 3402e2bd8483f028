"""Device idle time a step while the host dispatches the backward pass: the
gaps between device operations of the traced window whose middle lies in
the host span of the program's ``model/backward`` (on autograd's thread),
placed on the trace's clock by the offset of its ``train/loss_grad``
starts (``bench/record.py``)."""
from bench import record

UNIT = "ms"
MOVES = "train_tokens_per_s"


def read(view):
    return record.idle_ms(view, "model/backward")
