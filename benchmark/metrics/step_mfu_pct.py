"""step_mfu_pct: the whole step's share of the chip's peak: the least time
of a step's least work (each of the six prognostic fields read once and
written once) at the published bandwidth, over the measured time a step
(the traced window over its steps).  No flop is counted, so it can only
read low.  Device trace."""

from benchmark import yardstick


def read(rec):
    t = rec.trace
    if t is None or not t.steps or t.window_s <= 0.0 or not t.count("replay"):
        return None
    least_s = yardstick.least_step_bytes(rec.grid, rec.itemsize) / yardstick.HBM_BYTES_PER_S
    return yardstick.share_pct(least_s, t.window_s / t.steps)
