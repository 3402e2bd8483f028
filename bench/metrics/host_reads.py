"""Device-to-host reads a step of the program's step: its counter
``host_reads`` (one a read of the compressor's witnesses or the adaptive
counts, ``repro_torch.kernels.compress.ops``, ``core.allocate``), from its
own record of the traced steps (``bench/record.py``)."""
from bench import record

UNIT = "reads"
MOVES = "train_tokens_per_s"


def read(view):
    return record.count_per_step(view, "host_reads")
