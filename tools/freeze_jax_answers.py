"""Write the JAX package's frozen answers for the port's parity tests.

    JAX_PLATFORMS=cpu python tools/freeze_jax_answers.py [test file stem ...]

A test file under ``tests/`` that reads frozen answers defines
``answers(side)``; this runs its JAX side (``side="jax"``) once and writes
the digests to ``tests/data/jax_answers/<stem>.json``.  With no arguments it
refreshes every such file.  Then run the ``slow`` twins, which recompute the
JAX side and hold it to the records and to the port:

    JAX_PLATFORMS=cpu python -m pytest tests/ -m slow -k frozen_answers
"""

import importlib
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

import conftest  # noqa: E402,F401  the CPU platform and 8 virtual devices, as in the tests
import jax_answers as JA  # noqa: E402


def converted():
    return sorted(p.stem for p in (ROOT / "tests").glob("test_*.py") if "\ndef answers(" in p.read_text())


def main(stems):
    for stem in stems or converted():
        start = time.monotonic()
        module = importlib.import_module(stem)
        count = JA.record(module.__file__, module.answers("jax"))
        print(f"{stem}: {count} cases in {time.monotonic() - start:.1f} s", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
