"""Kernel A's share of its roofline over the profiled sub-window: the
least time the card could take for the sub-window's transforms
(``roofline.ntt_work`` at the shape of each of one call's calls to the
transform, times the sub-window's calls), over kernel A's device time in
the sub-window's trace."""

from portbench.roofline import bound_ms, ntt_work

CALLS = {"kernel_a": [["seal_tpu_torch.ops.ntt", "ntt_cuda"]]}


def read(run):
    tl, ops = run.timeline, run.ops
    if not tl or not ops or not tl["kernel_s"].get("kernel_a"):
        return None
    calls = ops["calls"]["kernel_a"]
    if not calls or tl["counted"].get("kernel_a") != ops["launches"].get("kernel_a", 0) * run.profile_calls:
        return None
    nbytes = nops = 0
    for call in calls:
        x, t = call.args[0], call.args[1]
        b, o = ntt_work(x.numel() >> t.log_n, int(t.q.shape[0]), t.log_n)
        nbytes, nops = nbytes + b, nops + o
    ms = tl["kernel_s"]["kernel_a"] * 1e3
    return 100.0 * bound_ms(nbytes * run.profile_calls, nops * run.profile_calls)[0] / ms
