"""torch_ms: the device time a step of PyTorch's own kernels in the graph
(every replayed operation that is neither one of the port's kernels nor a
copy): the plain code of the coupling, the dycore and the physics.  Device
trace."""


def read(rec):
    t = rec.trace
    if t is None or not t.steps or not t.count("replay", "torch"):
        return None
    return 1e3 * t.seconds("replay", "torch") / t.steps
