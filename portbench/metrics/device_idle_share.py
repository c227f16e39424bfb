"""The share of the traced stretch's wall time in which no kernel ran on
the device, in percent: how far the host holds the card back."""


def read(run):
    t = run.trace
    if not t or t["wall_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["wall_s"])
