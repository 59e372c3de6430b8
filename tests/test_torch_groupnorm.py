"""Port parity: audio_diffusion_torch.ops.fused_groupnorm (plain version, CPU)
against the JAX package's fused_group_norm_silu. At C % 128 == 0 the JAX side
runs the Pallas bodies in interpret mode; at C=32 it takes ``_reference``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_diffusion_torch.ops import fused_groupnorm as gn
from audio_diffusion_tpu.ops.pallas_groupnorm import fused_group_norm_silu as jax_fused


@pytest.mark.parametrize("eps", [1e-5, 1e-6])
@pytest.mark.parametrize("shape,groups", [((2, 4, 4, 128), 32), ((1, 8, 8, 256), 32), ((2, 8, 8, 32), 4)])
def test_plain_matches_jax(shape, groups, eps):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(shape) * 3 + 1).astype(np.float32)
    scale = rng.standard_normal(shape[-1]).astype(np.float32)
    bias = rng.standard_normal(shape[-1]).astype(np.float32)
    want = np.asarray(jax_fused(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), groups, eps,
                                interpret=True))
    x_nchw = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
    got = gn.fused_group_norm_silu(x_nchw, torch.from_numpy(scale), torch.from_numpy(bias), groups, eps)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=2e-5)


def test_splits_do_not_depend_on_batch():
    """The kernel's chunking is a function of the slab, so a row's sums do
    not depend on the batch around it."""
    assert gn.num_splits(128, 32, 32, 32) == 4
    assert gn.num_splits(1024, 1, 1, 32) == 1
    assert all(1 <= gn.num_splits(c, s, s, 32) <= gn.MAX_SPLITS
               for c in (128, 256, 512, 1024) for s in (1, 2, 4, 8, 16, 32, 256))
