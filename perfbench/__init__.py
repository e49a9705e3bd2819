"""The benchmark of ``repro_torch``, the PyTorch and CUDA port.

``python -m perfbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on the card and
prints its result as the last line of its output. Nothing here imports
JAX or the JAX package.
"""
