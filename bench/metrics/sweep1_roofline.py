"""B1 (``csrc/sweep1.cu``, plain mode, fp32 state) at the cell's J: the
yardstick's byte count over 3.35 TB/s, over the kernel's time in the
trace."""
from bench import yardstick

UNIT = "%"
MOVES = "train_tokens_per_s"


def read(view):
    sec, launches = view.kernel_s("sweep1_kernel")
    if not launches:
        return None
    return yardstick.roofline_pct(
        launches * yardstick.sweep1_bytes(view.counters["j"]), sec)
