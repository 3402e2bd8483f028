"""Device time a step of the model's forward and backward pass: busy time
inside the ``train/loss_grad`` stage (``repro_torch.models``)."""
UNIT = "ms"
MOVES = "train_tokens_per_s"


def read(view):
    sec = view.stage_busy_s("train/loss_grad")
    return None if sec is None else 1e3 * sec / view.steps
