"""device_ops: the device operations a step of the graph runs, of every
kind.  Device trace."""


def read(rec):
    t = rec.trace
    if t is None or not t.steps or not t.count("replay"):
        return None
    return t.count("replay") / t.steps
