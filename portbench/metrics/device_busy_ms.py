"""Device ms a frame in which any kernel ran: the union of the kernel
intervals of the traced stretch over its frames."""


def read(run):
    t = run.trace
    if not t or not t["frames"] or t["busy_s"] <= 0:
        return None
    return t["busy_s"] * 1000.0 / t["frames"]
