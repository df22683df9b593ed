"""PyTorch/CUDA port of ``jama16_retina_tpu`` for an NVIDIA H100.

The JAX package stays the reference; this package mirrors its module
names (``configs``, ``models``, ``serve``, ``ops``, ...) so each port
module sits beside the one it is held against in ``tests/test_torch_*``.
It imports ``torch`` and numpy only, never JAX or the JAX package.

Entry points run on the card unless the caller passes ``device="cpu"``
(see ``device.resolve``).
"""
