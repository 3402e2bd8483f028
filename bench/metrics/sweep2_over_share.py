"""The share of B2's tiles whose candidates overflowed their slots: 100 x
the program's counter ``sweep2_over`` (tiles with cnt > maxpb, reduced
on the card and read with the trim's witnesses) over ``sweep2_tiles``,
each traced step's, averaged over the steps (``bench/record.py``)."""
from bench import record

UNIT = "%"
MOVES = "train_tokens_per_s"


def read(view):
    got = record.traced(view)
    if got is None:
        return None
    shares = []
    for recs in record.by_step(*got):
        over = sum(r["n"] for r in record.counts(recs, "sweep2_over"))
        tiles = sum(r["n"] for r in record.counts(recs, "sweep2_tiles"))
        if tiles:
            shares.append(100.0 * over / tiles)
    return sum(shares) / len(shares) if shares else None
