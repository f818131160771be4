"""kernel_roofline_pct: the least time of a step's kernel launches at the
chip's published bandwidth over their measured device time.  The launches
are the program's count of the captured step (``launch_counts``), each
bounded by its operation's unique bytes (``kernels/<op>.json``); the time is
the port's kernels' device time a step in the trace.  Reads nothing where
the step launches none of the port's kernels."""

from benchmark import yardstick


def read(rec):
    t = rec.trace
    if t is None or not t.steps or not rec.launches or not t.count("replay", "port"):
        return None
    bound_s, _ = yardstick.step_bound_s(rec.launches, rec.grid, rec.itemsize)
    return yardstick.share_pct(bound_s, t.seconds("replay", "port") / t.steps)
