"""Peak device memory allocated in the window (reset after the warm-up)."""


def read(run):
    return run.peak_window_bytes / 2**30 if run.peak_window_bytes > 0 else None
