"""device_ops.<suffix>: the device activities (kernels, copies, sets)
per request in the traced window, whatever kernels or names produce
them."""


def read(record):
    p, n = record["profile"], record["traced_requests"]
    if not p or not n:
        return None
    return p["device_ops"] / n
