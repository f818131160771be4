"""kernel_ms: the device time a step of the port's own CUDA kernels in the
graph.  Device trace."""


def read(rec):
    t = rec.trace
    if t is None or not t.steps or not t.count("replay", "port"):
        return None
    return 1e3 * t.seconds("replay", "port") / t.steps
