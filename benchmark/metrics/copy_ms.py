"""copy_ms: the device time a step of the graph's device-to-device copies
(the copy-back of the carried fields).  Device trace, the replays' operations."""


def read(rec):
    t = rec.trace
    if t is None or not t.steps or not t.count("replay", "copy"):
        return None
    return 1e3 * t.seconds("replay", "copy") / t.steps
