"""Device milliseconds per request of kernel E, the modular functions of
``seal_tpu_torch/ops/u64.py`` on the card (``csrc/modarith.cu``): kernel
E's device time in the profiled sub-window's trace over the requests of
its calls.  None where the sub-window counted no launch of kernel E (a
program without it)."""


def read(run):
    tl = run.timeline
    if not tl or not tl["counted"].get("kernel_e") or not tl["kernel_s"].get("kernel_e"):
        return None
    return tl["kernel_s"]["kernel_e"] * 1e3 / (run.profile_calls * run.requests_per_call)
