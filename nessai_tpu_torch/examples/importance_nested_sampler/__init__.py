"""The importance nested sampler's examples, counterparts of
``examples/importance_nested_sampler/``. Each module holds its script's
model and arguments (``SAMPLER_KWARGS``); run one on the GPU with
``python -m nessai_tpu_torch.examples.importance_nested_sampler.<module>``.
"""
