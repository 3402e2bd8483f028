"""Device time a step of the optimizer: busy time inside the
``train/optimizer`` stage (``repro_torch.optim.optimizer``, with ZeRO-1's
all-gather of the master on more than one rank)."""
UNIT = "ms"
MOVES = "train_tokens_per_s"


def read(view):
    sec = view.stage_busy_s("train/optimizer")
    return None if sec is None else 1e3 * sec / view.steps
