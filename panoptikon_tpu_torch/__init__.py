"""panoptikon_tpu_torch — panoptikon_tpu's search path on PyTorch + CUDA.

The port keeps the JAX package's layout and module names; ``panoptikon_tpu``
stays the reference that each module is tested against on the same inputs.
It imports ``torch`` and never ``jax``, and nothing of ``panoptikon_tpu``:
the host modules it needs (``ops.codec``'s NumPy half,
``index.vector_index``, ``models.base``, ``models.batching``,
``utils.npy``, ``utils.splitmix``, ``db``, ``pql.model``,
``pql.preprocess`` and the host composition of ``pql.executor`` and
``pql.fused``) are its own copies.

Layer map:

- ``device``  — explicit device selection (no silent CPU fallback).
- ``pql``     — the PQL model, query preprocessing and the executor: host
                masks and page assembly, device surfaces and rank joins on
                its one named device.
- ``db``      — the SQLite schema, connections, store and writer.
- ``ops``     — codec, the exact fp32 oracle, the scoring surfaces, RRF
                fusion, and the hand-written Hopper kernels (``int8_scan``:
                B1 and B2, ``vit_attention``: B3 and B4, ``ln_quant``: B5)
                with their plain PyTorch versions.
- ``models``  — the CLIP towers (bf16 and static int8), ``ClipImpl`` and
                the JAX-parameter converter.
- ``utils``   — the npy wire codec and the seeded-random row mix.
- ``index``   — a host ``VectorIndex`` snapshot uploaded to the device and
                searched through the fused int8 scan.
- ``_build``  — builds ``csrc/*.cu`` with ``nvcc`` and loads it by ctypes.
- ``tracing`` — spans and counters at the layers' boundaries, recorded
                only while ``torch.profiler`` is on.
- ``api``     — the HTTP server (the reference's handlers on the port's own
                stdlib transport, ``api/web.py``, and its client half
                ``api/web_client.py``), the span cache, the policy layer
                and the reverse proxy for a UI upstream; ``client``,
                ``aclient`` (async) and ``cli`` drive it.
"""

__version__ = "0.1.0"


def __getattr__(name):
    # Lazy convenience exports, as the reference's: the client and the
    # query builder are stdlib-only and load no engine.
    if name in ("PanoptikonClient", "PanoptikonError"):
        from panoptikon_tpu_torch import client

        return getattr(client, name)
    if name == "AsyncPanoptikonClient":
        from panoptikon_tpu_torch.aclient import AsyncPanoptikonClient

        return AsyncPanoptikonClient
    if name == "Q":
        from panoptikon_tpu_torch.pql import build

        return build
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
