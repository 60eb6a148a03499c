"""Resources embedded in the package (default configs, built-in model
registry) — the reference bundles its equivalents in the binary
(resources.rs).

The port's copy of ``panoptikon_tpu/resources``: the built-in model
registry (``config/inference/00_builtin.toml``) is the JAX package's,
held equal to it by ``tests/test_torch_host_copies.py``.
"""

from __future__ import annotations

from pathlib import Path


def config_dir() -> Path:
    """The packaged default-config tree (…/resources/config)."""
    from importlib import resources

    return Path(str(resources.files("panoptikon_tpu_torch.resources"))) / "config"
