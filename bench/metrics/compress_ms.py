"""Device time a step of the compressor: busy time inside the
``compress/*`` stages (``repro_torch.kernels.compress.ops``,
``repro_torch.core.sparsify``)."""
UNIT = "ms"
MOVES = "train_tokens_per_s"


def read(view):
    sec = view.stage_busy_s("compress/")
    return None if sec is None else 1e3 * sec / view.steps
