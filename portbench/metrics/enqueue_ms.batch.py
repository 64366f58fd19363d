"""Host milliseconds per request spent inside the calls into the evaluator
over the measured window: the host clock around each call's enqueue, which
holds no synchronize of the benchmark's own.  It includes the waits of the
program's own synchronizes inside a call (a batched call of the port
synchronizes its stream once), which a later span in the program can
split from the host's work."""


def read(run):
    calls = run.window.calls if run.window is not None else []
    if not calls:
        return None
    return sum(c.t_enqueued - c.t_enqueue for c in calls) * 1e3 / sum(c.requests for c in calls)
