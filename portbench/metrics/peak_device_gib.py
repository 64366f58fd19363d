"""The caching allocator's peak over the measured window
(``max_memory_allocated`` after ``reset_peak_memory_stats``), in GiB."""


def read(run):
    if run.window_peak_bytes is None:
        return None
    return run.window_peak_bytes / 2 ** 30
