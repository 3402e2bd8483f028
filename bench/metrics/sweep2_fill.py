"""How full B2's fullest tile is: 100 x the largest per-tile candidate
count over the tile's slots (the program's counters ``sweep2_max_cnt``
and ``sweep2_slots``, reduced on the card from B2's ``cnt`` and read with
the trim's witnesses), the fullest sweep 2 of each traced step, averaged
over the steps. Above 100 a tile overflowed and the step took the dense
fallback (``bench/record.py``)."""
from bench import record

UNIT = "%"
MOVES = "train_tokens_per_s"


def read(view):
    got = record.traced(view)
    if got is None:
        return None
    fills = []
    for recs in record.by_step(*got):
        most = [r["n"] for r in record.counts(recs, "sweep2_max_cnt")]
        slots = [r["n"] for r in record.counts(recs, "sweep2_slots")]
        if most and len(most) == len(slots):
            fills.append(max(100.0 * m / s for m, s in zip(most, slots)))
    return sum(fills) / len(fills) if fills else None
