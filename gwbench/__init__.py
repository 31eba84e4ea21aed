"""gwbench: the benchmark of gwkit_torch, the PyTorch/CUDA port, on NVIDIA GPUs.

One run measures one cell of ``BENCHMARK.json`` (a model configuration under
a traffic mix) and prints one JSON line; ``README.md`` says how to run it and
how to add a configuration, a cell, a traffic mix or a per-layer metric.
Nothing here imports jax or the JAX package, and ``gwbench.reference``
imports nothing of the port either.
"""
