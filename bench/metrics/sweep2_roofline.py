"""B2 (``csrc/sweep2.cu``) at the cell's J and k: the yardstick's byte
count over 3.35 TB/s, over the kernel's time in the trace."""
from bench import yardstick

UNIT = "%"
MOVES = "train_tokens_per_s"


def read(view):
    sec, launches = view.kernel_s("sweep2_kernel")
    if not launches:
        return None
    j, k = view.counters["j"], view.counters["k"]
    return yardstick.roofline_pct(launches * yardstick.sweep2_bytes(j, k),
                                  sec)
