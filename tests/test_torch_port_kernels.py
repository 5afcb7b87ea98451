"""The port's hand-written kernels against their plain PyTorch versions,
on the card. Every test here needs a CUDA card and skips without one.

The file imports neither jax nor the JAX package, so on a machine without
jax it runs without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_port_kernels.py -q
"""

import pytest
import torch

from videocad_tpu_torch.ops import fused_attention as fa

pytestmark = pytest.mark.cuda

BF16, F32 = torch.bfloat16, torch.float32


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _qkv(b, t, hd, dtype, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn((b, t, hd), generator=gen, device="cuda").to(dtype)
            for _ in range(3)]


# bf16: the summation order may differ and the weights round to bf16 at
# the same place in both versions, so a few bf16 ulps of the output.
@pytest.mark.parametrize("b,t,h,d,dtype,max_tol", [
    (1, 50, 16, 64, BF16, 2e-2),    # the flagship ViT: CAD encode
    (8, 50, 16, 64, BF16, 2e-2),    # one served tick
    (8, 50, 16, 64, F32, 1e-5),
    (3, 13, 2, 8, F32, 1e-5),       # T < 32: every lane's 2nd key is padding
    (2, 64, 4, 32, F32, 1e-5),      # T at the kernel's limit
    (5, 33, 3, 48, BF16, 2e-2),     # uneven T and D
])
def test_mhsa_short_kernel_matches_plain_version(cuda, b, t, h, d, dtype,
                                                 max_tol):
    q, k, v = _qkv(b, t, h * d, dtype, seed=b * 1000 + t)
    with torch.no_grad():
        before = fa.mhsa_short.launches
        got = fa.mhsa_short(q, k, v, h)
        torch.cuda.synchronize()
        assert fa.mhsa_short.launches == before + 1
        want = fa.mhsa_short_reference(q, k, v, h)
    assert got.dtype == dtype and got.shape == q.shape
    err = (got.float() - want.float()).abs()
    assert err.max().item() <= max_tol
    assert err.mean().item() <= (1e-3 if dtype == BF16 else 1e-6)


def test_mhsa_short_kernel_refuses_what_it_does_not_take(cuda):
    q, k, v = _qkv(2, 50, 1024, F32, seed=0)
    with torch.no_grad():
        with pytest.raises(TypeError):
            fa.mhsa_short(q.half(), k.half(), v.half(), 16)
        with pytest.raises(ValueError, match="contiguous"):
            fa.mhsa_short(q.transpose(0, 1).contiguous().transpose(0, 1),
                          k, v, 16)
        with pytest.raises(ValueError, match="T <= 64"):
            fa.mhsa_short(*_qkv(1, 65, 64, F32, seed=1), 1)
        with pytest.raises(ValueError, match="D <= 64"):
            fa.mhsa_short(*_qkv(1, 8, 128, F32, seed=2), 1)
    with pytest.raises(NotImplementedError, match="K1-bwd"):
        fa.mhsa_short(q.requires_grad_(), k, v, 16)
