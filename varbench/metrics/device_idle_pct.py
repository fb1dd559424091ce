"""device_idle_pct.<suffix>: the share of the traced window in which no
operation ran on the card, in %, from torch.profiler's trace (the union
of the device's activities). The suffix names the cells' end-to-end
metric that it moves; the reading is the same."""


def read(record):
    p = record["profile"]
    if not p or p["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
