"""setup_s: seconds from the process's start to the window's: imports, the
model's build, the drivers' warm-up step and capture (and, in a checkout's
first run, the build of the kernels).  Host clock."""


def read(rec):
    return rec.setup_s
