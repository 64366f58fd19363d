"""Kernel B's share of its roofline over the profiled sub-window: the
least time the card could take for the sub-window's key switches
(``roofline.switch_key_work``: the decomposition's reduction and transforms
and the key products, at the shape of each of one call's key switches,
times the sub-window's calls), over kernel B's device time in the
sub-window's trace."""

from portbench.roofline import bound_ms, switch_key_work

# the evaluator's call into the key-switch dispatch, which sends n <= 32768 on the card to kernel B
CALLS = {"kernel_b": [["seal_tpu_torch.ckks_bodies", "switch_key_contract"]]}


def read(run):
    tl, ops = run.timeline, run.ops
    if not tl or not ops or not tl["kernel_s"].get("kernel_b"):
        return None
    calls = ops["calls"]["kernel_b"]
    if not calls or tl["counted"].get("kernel_b") != ops["launches"].get("kernel_b", 0) * run.profile_calls:
        return None
    nbytes = nops = 0
    for call in calls:
        t_c, t_n, key, t = call.args[:4]
        D, n = t_c.shape[-2], t_c.shape[-1]
        b, o = switch_key_work(D, key.shape[1], key.shape[2], t.log_n, t_n is not None, t_c.numel() // (D * n))
        nbytes, nops = nbytes + b, nops + o
    ms = tl["kernel_s"]["kernel_b"] * 1e3
    return 100.0 * bound_ms(nbytes * run.profile_calls, nops * run.profile_calls)[0] / ms
