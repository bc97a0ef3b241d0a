"""The warm-up rule of the fused CUDA kernel, held in both packages.

A span of blocks whose carry-in is unknown first synthesizes the W blocks
before it from a zero carry and drops their PCM: W =
ceil((2*cols - 2) / (rows*cols)) (ops.synth_torch.warmup_blocks). Here,
over levels 1-15 and rows 1-3, the carry after W zero-carry blocks equals
the true carry, through the port's plain version and through the JAX
package's synth_pcm_batch (tolerance 0: an integer codec); and for
rows == 1 from level 2 W - 1 blocks do not give it, so the rule is tight.
"""

import numpy as np
import pytest
import torch

from libacm_tpu.ops import synth_jax as sj
from libacm_tpu_torch.ops import synth_torch as st


def _files(level, rows):
    """Three files of W + 1 blocks: the true stream (blocks x_0..x_W from a
    random carry), then x_1..x_W after one all-zero block from a zero
    carry (W warm-up blocks), then x_2..x_W after two zero blocks (W - 1).
    A zero block from a zero carry leaves a zero carry, so each file's
    final carry is that of its warm-up blocks alone."""
    rng = np.random.default_rng(level * 17 + rows)
    cols = 1 << level
    W = st.warmup_blocks(level, rows)
    k = rng.integers(-3000, 3000, (1, W + 1, rows, cols)).astype(np.int16)
    v = rng.integers(1, 1 << 16, (1, W + 1)).astype(np.int32)
    k, v = np.repeat(k, 3, axis=0), np.repeat(v, 3, axis=0)
    k[1, :1] = 0
    v[1, :1] = 0
    k[2, :2] = 0
    v[2, :2] = 0
    w = np.zeros((3, 2 * cols - 2), np.int32)
    w[0] = rng.integers(-(1 << 20), 1 << 20, 2 * cols - 2)
    return W, k, v, w


@pytest.mark.parametrize("rows", [1, 2, 3])
@pytest.mark.parametrize("level", range(1, 16))
def test_warmup_blocks_give_the_true_carry(level, rows):
    W, k, v, w = _files(level, rows)
    assert W == (2 if rows == 1 and level >= 2 else 1)
    _, port = st.synth_pcm_batch(torch.from_numpy(k), torch.from_numpy(v),
                                 torch.from_numpy(w), level=level, rows=rows)
    _, jax_w = sj.synth_pcm_batch(k, v, w, level=level, rows=rows)
    jax_w = np.asarray(jax_w)
    np.testing.assert_array_equal(port.numpy(), jax_w)
    np.testing.assert_array_equal(port[1].numpy(), port[0].numpy())
    np.testing.assert_array_equal(jax_w[1], jax_w[0])
    if rows == 1 and level >= 2:  # tight: one block fewer is wrong
        assert not torch.equal(port[2], port[0])
        assert not np.array_equal(jax_w[2], jax_w[0])


def test_warmup_blocks_values():
    assert st.warmup_blocks(0, 2048) == 0  # level 0 has no carry
    assert st.warmup_blocks(1, 1) == 1
    assert [st.warmup_blocks(lv, 1) for lv in range(2, 16)] == [2] * 14
    assert all(st.warmup_blocks(lv, r) == 1
               for lv in range(1, 16) for r in (2, 3, 16, 40))


@pytest.mark.parametrize("level,rows", [(7, 1), (2, 1), (5, 3)])
def test_carry_of_block_takes_warmup_blocks(level, rows):
    """carry_of_block of the W blocks before block m equals the carry the
    whole stream leaves after block m - 1."""
    W, k, v, w = _files(level, rows)
    _, want = st.synth_pcm_batch(torch.from_numpy(k[:1]),
                                 torch.from_numpy(v[:1]),
                                 torch.from_numpy(w[:1]), level=level,
                                 rows=rows)
    got = st.carry_of_block(torch.from_numpy(k[0, 1:]),
                            torch.from_numpy(v[0, 1:]), level=level,
                            rows=rows)
    assert torch.equal(got, want[0])
