"""CPU tests of the benchmark (``pytest portbench/tests``)."""
