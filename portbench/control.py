"""The control of the comparison that decides ``correct``.

The control is the plain reference put in the program's place with one of
the configuration's guarantees broken: it divides by the special prime and
by the last prime by flooring instead of rounding, a step that saves an add
per coefficient and still decrypts to nearly the same values.  Its outputs,
for as many calls as a run compares, go through the same comparison as the
program's; a sound comparison finds them wrong.  The benchmark's own runs
never run this.

    python3 portbench/control.py --workload <name> --seeds <n> [<n> ...]

prints one JSON line per seed with the checked numbers.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from portbench import checks  # noqa: E402
from portbench.harness import cell_of, config_of  # noqa: E402
from portbench.inputs import Inputs  # noqa: E402
from portbench.reference.program import Ct, Reference  # noqa: E402
from portbench.traffic import load_mix, run_program  # noqa: E402

HERE = Path(__file__).resolve().parent


def control_outputs(config: dict, mix: dict, seed: int, device) -> list:
    """The control's outputs for calls 0 .. check_calls - 1, as a run's
    sampled outputs."""
    control = Reference(config, device, rounding=False)
    inputs = Inputs(config, seed, device)
    ntt_form = config["scheme"] != "bfv"
    scale = float(config.get("scale", 1.0))
    out = []
    for call in range(mix["check_calls"]):
        keys = checks.call_inputs(control, inputs, mix, call, scale)
        requests = {name: inputs.ciphertexts(name, call % mix["clients"], mix["batch"]) for name in mix["requests"]}
        cts = [run_program(control.op, mix["program"],
                           {**{k: Ct(v[b], ntt_form, scale) for k, v in requests.items()}, **keys}, mix["output"])
               for b in range(mix["batch"])]
        out.append({"call": call, "data": torch.stack([c.data for c in cts]),
                    "ntt_form": cts[0].ntt_form, "scale": cts[0].scale})
    return out


def control_checks(spec: dict, root: Path, workload: str, seed: int, device) -> dict:
    cell = cell_of(spec, workload)
    config = config_of(spec, root, cell["config"])
    mix = load_mix(HERE / "mixes" / f"{cell['traffic']}.json")
    return checks.compare(config, mix, seed, control_outputs(config, mix, seed, device), device)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Read the control of a cell's comparison.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    spec = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    for seed in args.seeds:
        result = control_checks(spec, HERE.parent, args.workload, seed, args.device)
        print(json.dumps({"workload": args.workload, "seed": seed, "correct": checks.passed(result),
                          "checks": result}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
