"""peak_mem_gb: torch.cuda.max_memory_allocated() over set-up and the
window, read once the window has closed, in GB (1e9 bytes)."""


def read(record):
    peak = record["memory_peak_bytes"]
    return peak / 1e9 if peak else None
