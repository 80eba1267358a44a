"""BitNet's QAT forward (bitblas_tpu_torch.models.bitnet.ste and
bitlinear_train_forward) against the JAX package's on the CPU.

The forward and the gradients of JAX's loss (tests/test_models.py:
sum(bitlinear_train_forward(x, w) ** 2)) with respect to w and x, through
torch autograd against `jax.grad`. Both sides fake-quantize bit for bit
(tests/test_torch_bitnet.py holds activation_quant and weight_quant) and
sum in float32 in different orders: the output within rtol 1e-5 and the
gradients within rtol 1e-4 (atol 1e-6 of their largest), float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitblas_tpu.models import bitlinear_train_forward as jax_forward

from bitblas_tpu_torch.models import (activation_quant,
                                      bitlinear_train_forward, ste,
                                      weight_quant)


def _operands(seed, n=32, k=64, m=4):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, k)).astype(np.float32),
            rng.standard_normal((m, k)).astype(np.float32))


@pytest.mark.parametrize("seed", [3, 4])
def test_forward_and_gradients_match_jax(seed):
    w, x = _operands(seed)

    def loss(w, x):
        return jnp.sum(jax_forward(x, w) ** 2)

    want = np.asarray(jax_forward(jnp.asarray(x), jnp.asarray(w)))
    gw, gx = (np.asarray(g) for g in jax.grad(loss, argnums=(0, 1))(
        jnp.asarray(w), jnp.asarray(x)))

    wt = torch.from_numpy(w).requires_grad_()
    xt = torch.from_numpy(x).requires_grad_()
    out = bitlinear_train_forward(xt, wt)
    (out ** 2).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max())
    for got, ref in ((wt.grad, gw), (xt.grad, gx)):
        assert torch.isfinite(got).all() and float(got.abs().sum()) > 0
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4,
                                   atol=1e-6 * np.abs(ref).max())


def test_ste_passes_the_gradient_straight_through():
    x = torch.from_numpy(_operands(5)[1]).requires_grad_()
    q = activation_quant(x)
    y = ste(x, q)
    assert torch.equal(y.detach(), q.detach())
    (y * torch.arange(64.0)).sum().backward()
    assert torch.equal(x.grad, torch.arange(64.0).expand(4, 64))


def test_output_takes_the_input_type():
    w, x = _operands(6)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    out = bitlinear_train_forward(xb, torch.from_numpy(w))
    assert out.dtype == torch.bfloat16
    want = (activation_quant(xb).float()
            @ weight_quant(torch.from_numpy(w)).float().T)
    assert torch.equal(out, want.to(torch.bfloat16))
