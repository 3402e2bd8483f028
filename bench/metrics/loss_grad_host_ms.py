"""Host time a step in the ``train/loss_grad`` stage
(``repro_torch.train.step``): the eager dispatch of the forward and
backward pass."""
UNIT = "ms"
MOVES = "train_tokens_per_s"


def read(view):
    sec = view.host_s("train/loss_grad")
    return None if sec is None else 1e3 * sec / view.steps
