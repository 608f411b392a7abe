"""PyTorch / CUDA port of the TIGRE reconstruction package ``repro``.

Mirrors ``src/repro`` file for file and imports nothing of it (nor JAX):
numpy-only modules are kept as own copies, guarded by parity tests.  Entry
points run on the CUDA device unless the caller passes ``device="cpu"``;
the kernels (``repro_torch.kernels``) are hand-written CUDA, built with
``nvcc`` at first use.  Beside the CT package it carries the LM serving
path of the reference's model zoo (``models``, ``configs``,
``launch.steps``), so far for gemma2-9b.
"""

__version__ = "0.1.0"
