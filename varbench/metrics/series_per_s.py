"""series_per_s: the VaR series (one portfolio x one level, each over
every day) completed in the window, per second of the window."""


def read(record):
    w = record["window"]
    return w["rows"] / w["elapsed_s"] if w["rows"] else None
