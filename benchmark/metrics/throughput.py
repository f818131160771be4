"""throughput: grid points times the steps of every forecast the window ran,
over the window's wall time (each forecast's initial state, load, replays
and synchronize included).  Host clock."""


def read(rec):
    return rec.points * rec.steps * len(rec.forecast_s) / rec.window_s
