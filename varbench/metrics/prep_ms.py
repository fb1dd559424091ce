"""prep_ms.<suffix>: the mean of the program's own `prep_seconds` (its
synchronised timer around the sweep operands' build) per book loaded in
the traced window, in ms."""


def read(record):
    prep = record["prep_seconds"]
    return 1e3 * sum(prep) / len(prep) if prep else None
