"""Hand-written Hopper kernels of the port, each beside its plain
PyTorch version; ``_build`` compiles ``csrc/*.cu`` at first use."""


def forward_only(name: str, *tensors) -> None:
    """Raise if any of a kernel's CUDA inputs requires grad: the kernels
    have no backward, so an autograd graph through one would lose its
    gradient without a word.  (The plain versions on the CPU are
    differentiable and take no such check.)"""
    if any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward, and an input requires "
            "grad; pass tensors that do not (computed under "
            "torch.no_grad(), or detached)")
