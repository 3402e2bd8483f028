"""The whole step's share of the cards' bf16 dense peak: the yardstick's
model FLOPs of the tokens the window's untraced steps completed, over
those steps' host-clock time and 989 TFLOP/s a card."""
from bench import yardstick

UNIT = "%"
MOVES = "train_tokens_per_s"


def read(view):
    c = view.counters
    if not c.get("untraced_s"):
        return None
    return yardstick.mfu_pct(c["config"], c["seq"],
                             c["untraced_tokens"] / c["untraced_s"],
                             c["cards"])
