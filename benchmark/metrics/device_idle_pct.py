"""device_idle_pct: the share of the traced window (whole forecasts, on the
trace's clock) that no device operation covers.  Device trace."""

from benchmark import yardstick


def read(rec):
    t = rec.trace
    if t is None or not t.forecasts or t.window_s <= 0.0 or not t.count("replay"):
        return None
    return yardstick.idle_pct(t.busy_s, t.window_s)
