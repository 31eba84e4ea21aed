"""gwkit_torch: the PyTorch/CUDA port of gwkit for NVIDIA Hopper (H100).

The JAX package ``gwkit`` is the reference; this package reproduces its
functions with the same module names, public function names and parameter
layouts, in PyTorch. Every Pallas kernel that ``gwkit`` runs on the search
path is a hand-written CUDA kernel here (``gwkit_torch/csrc``), built with
``nvcc`` at first use and bound through ``ctypes``.

Entry points take ``device=None``, meaning CUDA; they raise when CUDA is
missing rather than fall back to the CPU. Pass ``device="cpu"`` to run the
plain PyTorch versions on the CPU (what the parity tests do).

The package imports neither ``jax`` nor anything of ``gwkit``; ``h5py`` is
imported lazily inside the functions that read or write HDF5.
"""
