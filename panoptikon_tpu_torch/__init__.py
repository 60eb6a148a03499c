"""panoptikon_tpu_torch — the search core of panoptikon_tpu on PyTorch + CUDA.

The port keeps the JAX package's layout and module names; ``panoptikon_tpu``
stays the reference that each module is tested against on the same inputs.
It imports ``torch`` and never ``jax``: the host layers it reuses from the
JAX package (``ops.codec``'s NumPy half, ``index.vector_index``) are jax-free
at import.

Layer map:

- ``device``  — explicit device selection (no silent CPU fallback).
- ``ops``     — codec, the exact fp32 oracle, the scoring surface, and the
                two hand-written Hopper kernels (``int8_scan``,
                ``vit_attention``) with their plain PyTorch versions.
- ``models``  — the CLIP towers (bf16) and the JAX-parameter converter.
- ``index``   — a host ``VectorIndex`` snapshot uploaded to the device and
                searched through the fused int8 scan.
- ``_build``  — builds ``csrc/*.cu`` with ``nvcc`` and loads it by ctypes.
"""

__version__ = "0.1.0"
