"""The share of the profiled sub-window in which no operation ran on the
device: one minus the union of the trace's device intervals over the
sub-window's length."""


def read(run):
    tl = run.timeline
    if not tl or tl["window_s"] <= 0 or tl["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tl["busy_s"] / tl["window_s"])
