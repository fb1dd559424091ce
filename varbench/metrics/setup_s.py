"""setup_s: seconds from the start of the process to the start of the
window: imports, the CUDA context, the kernels' load (and, on a
checkout's first run, their build), the book's load and prep, and the
warm-up requests."""


def read(record):
    return record["setup_s"]
