"""peak_mem_mb: ``torch.cuda.max_memory_allocated()`` over set-up and
window, read before the reference runs, in MB (10^6 bytes)."""


def read(rec):
    return rec.peak_bytes / 1e6 if rec.peak_bytes else None
