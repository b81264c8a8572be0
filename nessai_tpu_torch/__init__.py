"""nessai-tpu-torch: nested sampling with normalising flows on PyTorch/CUDA.

The PyTorch port of ``nessai_tpu``: the same standard nested sampler and
flow proposal, with the flows as ``torch.nn.Module``s and the fused
affine-coupling transform as a CUDA kernel written for Hopper
(``csrc/affine_coupling.cu``). Entry points run on the GPU unless the
caller passes ``device="cpu"``; on CPU tensors every kernel wrapper uses
its plain PyTorch version.
"""

__version__ = "0.1.0"

_LAZY = {
    "FlowSampler": ("nessai_tpu_torch.flowsampler", "FlowSampler"),
    "Model": ("nessai_tpu_torch.model", "Model"),
    "NestedSampler": ("nessai_tpu_torch.samplers", "NestedSampler"),
    "FlowModel": ("nessai_tpu_torch.flowmodel", "FlowModel"),
    "FlowProposal": ("nessai_tpu_torch.proposal", "FlowProposal"),
    "configure_logger": ("nessai_tpu_torch.utils", "configure_logger"),
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(
        f"module 'nessai_tpu_torch' has no attribute {name!r}"
    )


def __dir__():
    return sorted(list(globals()) + list(_LAZY))
