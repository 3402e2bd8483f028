"""The share of the traced window in which no device operation runs: one
minus the union of their intervals over the window."""
UNIT = "%"
MOVES = "train_tokens_per_s"


def read(view):
    if view.window_s <= 0:
        return None
    return 100.0 * (1.0 - view.busy_s / view.window_s)
