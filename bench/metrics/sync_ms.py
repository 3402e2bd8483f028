"""Device time a step of the gradient sync: busy time inside the
``sync/*`` stages (``repro_torch.core.aggregate``) and in NCCL's kernels,
ZeRO-1's all-gather of the master among them."""
UNIT = "ms"
MOVES = "train_tokens_per_s"


def read(view):
    sec = view.stage_busy_s("sync/", extra_ops="nccl")
    return None if sec is None else 1e3 * sec / view.steps
