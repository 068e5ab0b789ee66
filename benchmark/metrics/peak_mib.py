"""The device memory the window's requests peaked at, in MiB
(``torch.cuda.max_memory_allocated``, reset after the warm-up)."""


def read(run):
    return run.peak_bytes / 2 ** 20 if run.peak_bytes else None
