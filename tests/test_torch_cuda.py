"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA device and skips without one. The file
imports neither JAX nor the JAX package, so it also runs where JAX is not
installed:

    python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: the attention kernels within 1e-4 + 2**-6 * |plain|
elementwise, two bf16 steps of the value (kernel and plain version each
round an fp32 result to bf16 once, after sums taken in other orders, so
they may differ by one step); sampling is bit-exact.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels run only on the "
                    "card")
    return torch.device("cuda")


def _paged_inputs(seed, B, H, K, hd, page, NP, P, positions):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, 1, H, hd), np.float32)
    kp = rng.standard_normal((P, page, K, hd), np.float32)
    vp = rng.standard_normal((P, page, K, hd), np.float32)
    tables = rng.integers(1, P, (B, NP)).astype(np.int32)
    return q, kp, vp, tables, np.asarray(positions, np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("S,causal", [(7, True), (200, True), (130, False)])
def test_flash_attention_kernel_on_card(cuda, S, causal):
    g = torch.Generator(device=cuda).manual_seed(S)
    q = torch.randn((2, S, 16, 128), generator=g, device=cuda).bfloat16()
    k = torch.randn((2, S, 8, 128), generator=g, device=cuda).bfloat16()
    v = torch.randn((2, S, 8, 128), generator=g, device=cuda).bfloat16()
    got = ops.flash_attention(q, k, v, causal=causal)
    want = ops.flash_attention(q, k, v, causal=causal, backend="ref")
    torch.testing.assert_close(got.float(), want.float(), atol=1e-4,
                               rtol=2 ** -6)


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True])
def test_paged_decode_kernel_on_card(cuda, quant):
    q, kp, vp, tables, pos = _paged_inputs(5, B=8, H=16, K=8, hd=128,
                                           page=16, NP=8, P=40,
                                           positions=(0, -1, 15, 16, 127,
                                                      70, -1, 33))
    q = torch.from_numpy(q).bfloat16().to(cuda)
    t, p = torch.from_numpy(tables).to(cuda), torch.from_numpy(pos).to(cuda)
    if quant:
        kq, ks = tref.kv_quant_ref(torch.from_numpy(kp).to(cuda))
        vq, vs = tref.kv_quant_ref(torch.from_numpy(vp).to(cuda))
        args = (q, kq, vq, ks, vs, t, p)
        fn = ops.paged_decode_quant
    else:
        args = (q, torch.from_numpy(kp).bfloat16().to(cuda),
                torch.from_numpy(vp).bfloat16().to(cuda), t, p)
        fn = ops.paged_decode
    got, want = fn(*args), fn(*args, backend="ref")
    torch.testing.assert_close(got.float(), want.float(), atol=1e-4,
                               rtol=2 ** -6)
    assert torch.all(got[1] == 0) and torch.all(got[6] == 0)
    assert torch.equal(got, fn(*args))     # no atomics: same bits again


@pytest.mark.cuda
def test_fused_sample_kernel_bit_exact_on_card(cuda):
    V, B = 151_936, 8
    g = torch.Generator(device=cuda).manual_seed(0)
    logits = torch.randn((B, V), generator=g, device=cuda) * 3
    temp = torch.tensor([0, .8, .8, 1.5, 0, .8, .3, 1.], device=cuda)
    top_k = torch.tensor([0, 0, 50, 0, 0, 1, 50, 100],
                         dtype=torch.int32, device=cuda)
    keys = torch.randint(0, 2**31 - 1, (B, 3), generator=g, device=cuda,
                         dtype=torch.int32)
    got = ops.fused_sample(logits, temp, top_k, keys, vocab_size=V - 64)
    want = ops.fused_sample(logits, temp, top_k, keys, vocab_size=V - 64,
                            backend="ref")
    assert torch.equal(got, want)
