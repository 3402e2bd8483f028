"""Host time a step in the program's device-to-host reads: its
``compress/trim/read`` spans, each a read that waits for the device's
queue to drain, from its own record of the traced steps
(``bench/record.py``)."""
from bench import record

UNIT = "ms"
MOVES = "train_tokens_per_s"


def read(view):
    return record.host_ms(view, "compress/trim/read")
