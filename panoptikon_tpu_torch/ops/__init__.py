"""The port's device operations: the kernels' wrappers and their plain
versions, the codec, exact search, scoring and fusion."""

import torch


def refuse_grad(what: str, *inputs) -> None:
    """Raise ``ValueError`` naming ``what`` where grad mode is on and a tensor
    among ``inputs`` requires grad: a kernel with no backward (B1, B2, B4,
    B5: int8 inference only) would return an output with no ``grad_fn`` and
    drop every gradient through it without a word."""
    if torch.is_grad_enabled() and any(isinstance(t, torch.Tensor) and t.requires_grad
                                       for t in inputs):
        raise ValueError(f"{what}: the kernel has no backward; call it under torch.no_grad() "
                         f"or on inputs that do not require grad")
