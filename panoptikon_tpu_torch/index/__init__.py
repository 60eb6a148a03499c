"""Indexes of the port.

``VectorIndex`` is the host index of the JAX package, shared as it is: its
module is NumPy only and imports no JAX. ``DeviceIndex`` uploads one of its
snapshots to the device.
"""

from panoptikon_tpu.index.vector_index import VectorIndex

__all__ = ["VectorIndex"]
