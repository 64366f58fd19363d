"""Device milliseconds per request of BFV's BEHZ base conversions
(``seal_tpu_torch/ops/rns.py``): the device time of the kernels launched
inside the conversions' calls, from the host-and-device profile's trace,
over the requests of its calls."""

RNS = "seal_tpu_torch.ops.rns"
SPANS = {"behz": [[RNS, name] for name in ("fastbconv_m_tilde", "sm_mrq", "fast_convert_array", "fast_floor",
                                            "fast_floor_finish", "fastbconv_sk")]}


def read(run):
    if not run.host or not run.host["span_s"].get("behz"):
        return None
    return run.host["span_s"]["behz"] * 1e3 / (run.host_profile_calls * run.requests_per_call)
