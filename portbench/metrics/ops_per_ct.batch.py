"""Operations the host issues per request: the aten calls of one call,
counted by a dispatch mode, plus the launches of the hand-written kernels
counted by their wrappers (ctypes launches pass no aten call); exact."""


def read(run):
    if run.ops is None:
        return None
    return (run.ops["aten"] + sum(run.ops["launches"].values())) / run.requests_per_call
