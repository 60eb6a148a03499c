"""panoptikon_tpu_torch — the search core of panoptikon_tpu on PyTorch + CUDA.

The port keeps the JAX package's layout and module names; ``panoptikon_tpu``
stays the reference that each module is tested against on the same inputs.
It imports ``torch`` and never ``jax``, and nothing of ``panoptikon_tpu``:
the host modules it needs (``ops.codec``'s NumPy half,
``index.vector_index``, ``models.base``, ``models.batching``,
``utils.npy``) are its own copies.

Layer map:

- ``device``  — explicit device selection (no silent CPU fallback).
- ``ops``     — codec, the exact fp32 oracle, the scoring surface, and the
                hand-written Hopper kernels (``int8_scan``: B1 and B2,
                ``vit_attention``: B3 and B4, ``ln_quant``: B5) with their
                plain PyTorch versions.
- ``models``  — the CLIP towers (bf16 and static int8), ``ClipImpl`` and
                the JAX-parameter converter.
- ``utils``   — the npy wire codec.
- ``index``   — a host ``VectorIndex`` snapshot uploaded to the device and
                searched through the fused int8 scan.
- ``_build``  — builds ``csrc/*.cu`` with ``nvcc`` and loads it by ctypes.
"""

__version__ = "0.1.0"
