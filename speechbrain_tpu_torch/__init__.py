"""speechbrain_tpu_torch: the PyTorch/CUDA port of speechbrain_tpu.

Same directory layout and public names as the JAX package, written in
PyTorch's idiom: ``nn.Module``s with shapes given at construction, an
explicit ``device``/``dtype``, explicit ``torch.Generator``s for
initialisation. Entry points default to ``device="cuda"``; the CPU is
used only when the caller passes ``device="cpu"``. The hand-written
Hopper kernels live under ``csrc/`` and are built at first use
(``ops/_build.py``).
"""

__version__ = "0.1.0"
