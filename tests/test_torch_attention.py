"""Port parity: audio_diffusion_torch.ops.attention (plain version, CPU)
against the JAX Pallas attention body in interpret mode and against
``reference_attention`` at the latent UNet's N=1 and N=4, h=64, d=8."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_diffusion_torch.ops import attention as at
from audio_diffusion_tpu.ops.pallas_attention import _flash_mha_fwd, reference_attention


def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("shape", [(2, 8, 64, 8), (1, 64, 256, 8), (2, 4, 128, 32), (1, 2, 64, 128)])
def test_plain_matches_pallas_interpret(shape):
    q, k, v = _qkv(shape, 0)
    want = np.asarray(_flash_mha_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True))
    got = at.multi_head_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("n", [1, 4])
def test_plain_matches_reference_at_latent_shapes(n):
    q, k, v = _qkv((2, 64, n, 8), n)
    want = np.asarray(reference_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    got = at.multi_head_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
