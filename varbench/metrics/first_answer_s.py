"""first_answer_s: the window's seconds per book that reached its first
answer in it (the CSV read, the artifacts' load, the prep and the first
VaR series)."""


def read(record):
    w = record["window"]
    return w["elapsed_s"] / w["requests"] if w["requests"] else None
