"""On-card checks of the port's kernels against their plain versions.

Marked ``cuda``: they skip without a GPU. On a machine with an H100 and
the CUDA toolkit, run them with
``python -m pytest --noconftest tests/test_torch_cuda.py -m cuda``
(``--noconftest``: the shared conftest needs JAX, which that machine
need not have).
"""

import pytest
import torch


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n,d", [(0, 1), (13, 3), (1000, 1), (4096, 8)])
def test_affine_coupling_kernel_matches_plain(cuda, n, d, inverse):
    from nessai_tpu_torch.ops import coupling

    gen = torch.Generator(device=cuda).manual_seed(n + d)
    x, t = (torch.randn(n, d, device=cuda, generator=gen) for _ in range(2))
    raw_s = 2.0 * torch.randn(n, d, device=cuda, generator=gen)
    before = coupling.affine_coupling.launches
    y, ld = coupling.affine_coupling(x, raw_s, t, inverse)
    y_ref, ld_ref = coupling.affine_coupling_plain(x, raw_s, t, inverse)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, y_ref, atol=1e-6, rtol=1e-5)
    torch.testing.assert_close(ld, ld_ref, atol=1e-5, rtol=0)
    assert coupling.affine_coupling.launches == before + (1 if n else 0)


@pytest.mark.cuda
def test_affine_coupling_kernel_rejects_bad_input(cuda):
    from nessai_tpu_torch.ops import coupling

    x = torch.zeros(8, 2, device=cuda)
    with pytest.raises(TypeError):
        coupling.affine_coupling(x.double(), x.double(), x.double())
    with pytest.raises(ValueError):
        coupling.affine_coupling(x, x.cpu(), x)
