"""repro_torch — DF* PageRank on PyTorch and CUDA (Hopper), beside ``repro``.

The JAX package ``repro`` is the reference; this package is its port.  It
mirrors ``repro``'s module paths (``repro_torch.core.kernel_engine`` is the
twin of ``repro.core.kernel_engine``) and imports torch and numpy only.

Ranks are f64 as in the paper (§5.1.2); every function states its dtypes
explicitly instead of relying on a global 64-bit switch.  Entry points
that create tensors take a ``device`` and default to ``cuda``; with no
device given and no CUDA present they raise (``repro_torch.device``).
"""
__version__ = "0.1.0"
