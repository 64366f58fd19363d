"""Twins of the repository's ``examples/1_bfv_basics.py`` ... ``7_serialization.py``
on the port: the same parameters, the same computation, the same asserts.

Each module has ``main(device=None)``, which runs on the card unless a
device is given (``main("cpu")``).  Run one from the repository root with
``python -m seal_tpu_torch.examples.1_bfv_basics``, or import it with
``importlib.import_module("seal_tpu_torch.examples.1_bfv_basics")``.
"""

NAMES = ("1_bfv_basics", "2_encoders", "3_levels", "4_bgv_basics", "5_ckks_basics", "6_rotation",
         "7_serialization")
