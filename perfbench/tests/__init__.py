"""CPU tests of the benchmark (run: python -m pytest perfbench/tests -q)."""
