"""Indexes of the port.

``VectorIndex`` is the host index (``index/vector_index.py``, NumPy only),
the port's own copy of the JAX package's. ``DeviceIndex`` uploads one of its
snapshots to the device.
"""

from panoptikon_tpu_torch.index.vector_index import VectorIndex

__all__ = ["VectorIndex"]
