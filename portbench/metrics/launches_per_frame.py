"""Device kernels launched a frame over the traced stretch (torch.profiler):
the program's own and torch's. Layer: engine / renderer and torch glue."""


def read(run):
    t = run.trace
    if not t or not t["frames"] or not t["kernels"]:
        return None
    return sum(n for n, _ in t["kernels"].values()) / t["frames"]
