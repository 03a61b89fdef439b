"""The benchmark's harness: it finds a cell's files by the names in
``BENCHMARK.json``, drives the program through a family's workload, times
the window, reads the per-layer metrics, judges ``correct`` against the
plain reference and prints the result line (:func:`dirbench.runner.main`)."""
