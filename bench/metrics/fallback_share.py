"""The share of the window's steps whose compressor took the exact dense
fallback: ``GradientSync.fallback_reasons`` grew in the step (rank 0's
counter)."""
UNIT = "%"
MOVES = "train_tokens_per_s"


def read(view):
    steps = view.counters.get("window_steps")
    fell = view.counters.get("fallback_steps")
    if not steps or fell is None:
        return None
    return 100.0 * fell / steps
