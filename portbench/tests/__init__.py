"""The benchmark's tests: a package, so that a test reaches ``conftest`` by its name."""
