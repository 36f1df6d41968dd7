"""Benchmark of the PyTorch/CUDA port (``llama_swift_torch``).

``python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once on the card and prints one JSON
result line.  Everything that belongs to one configuration, traffic mix or
metric is a file of its own, found by name (:mod:`benchmark.registry`).
Nothing here imports JAX or the JAX package.
"""
