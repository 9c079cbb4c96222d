"""The benchmark of the PyTorch port (``repro_torch``): ``python3
bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` on the card and prints one JSON line.
It imports neither JAX nor the JAX package."""
