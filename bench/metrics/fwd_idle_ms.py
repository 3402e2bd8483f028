"""Device idle time a step while the host dispatches the forward pass: the
gaps between device operations of the traced window whose middle lies in
the host span of the program's ``model/forward``, placed on the trace's
clock by the offset of its ``train/loss_grad`` starts (``bench/record.py``)."""
from bench import record

UNIT = "ms"
MOVES = "train_tokens_per_s"


def read(view):
    return record.idle_ms(view, "model/forward")
