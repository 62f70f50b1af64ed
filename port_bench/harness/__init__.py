"""The benchmark harness of the PyTorch port: cells from BENCHMARK.json,
the system under test, the timed window, the trace reduction, the
comparison with the reference and the result line."""
