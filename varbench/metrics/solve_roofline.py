"""solve_roofline.<suffix>: the least time the traced requests'
solves need on the card (varbench/work/solve.py, counted from the plain
reference's own sweeps on the same requests), as a share, in %, of the
card's busy time over those requests (all kernels and copies together).
No kernel name or launch layout enters it."""


def read(record):
    p, bound = record["profile"], record["work_bound_s"]
    if not p or not bound or p["busy_s"] <= 0:
        return None
    return 100.0 * bound / p["busy_s"]
