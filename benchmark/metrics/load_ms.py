"""load_ms: the device time of the operations ``StepBody.load`` launches
(the copies of a forecast's initial fields into the graph's buffers and the
counter's reset), a traced forecast's mean.  Device trace."""


def read(rec):
    t = rec.trace
    if t is None or not t.forecasts or not t.count("load"):
        return None
    return 1e3 * t.seconds("load") / t.forecasts
