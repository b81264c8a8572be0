"""The gravitational-wave examples, counterparts of ``examples/gw/``.

Each module holds its script's injection (the same numpy code, constants,
seeds and order of draws, so the data are the same bits), its model with
the host float64 ``log_likelihood`` and a float32 ``torch_log_likelihood``
that takes the observed data through ``torch_likelihood_data``, and the
script's sampler arguments (``SAMPLER_KWARGS``). Run one on the GPU with
``python -m nessai_tpu_torch.examples.gw.basic_gw_example``; importing a
module writes nothing.
"""
