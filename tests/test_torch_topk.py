"""Port parity: `pl_yolo_tpu_torch.ops.topk` against the JAX package's top-k
on the CPU, where the port's kernel branch runs its plain version.

Top-k selects values and computes none, so every comparison is exact
equality: against `pl_yolo_tpu.ops.topk.topk_lastdim`, against `_topk_iter`,
against the Pallas kernel in interpret mode, and against `torch.topk`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pl_yolo_tpu.ops import topk as jtopk
from pl_yolo_tpu.ops.pallas.topk_pallas import topk_pallas
from pl_yolo_tpu_torch.ops import topk as ttopk
from pl_yolo_tpu_torch.ops.cuda.topk import MAX_K, topk_rows


def _rows(kind, rng, shape=(3, 7, 500)):
    if kind == "random":
        return rng.normal(size=shape).astype(np.float32)
    if kind == "mostly_zero":   # a pair-IoU row: exact zeros but a few entries
        x = rng.uniform(0, 1, shape).astype(np.float32)
        x[x < 0.99] = 0.0
        x[0, 0] = 0.0
        x[0, 1, :3] = [0.5, 0.25, 0.5]
        return x
    if kind == "ties_near_minus_1e9":  # a negated cost row of a masked label
        x = (-1e9 - 1e5 - rng.uniform(50, 80, shape)).astype(np.float32)
        x[1, 2, 17:23] = -rng.uniform(1, 30, 6)
        return x
    if kind == "minus_inf":     # fewer than k finite entries, and none
        x = np.full(shape, -np.inf, np.float32)
        x[0, 0, :4] = [3.0, -1.0, 3.0, 7.5]
        x[1, 3, 100:112] = rng.normal(size=12)
        return x
    raise ValueError(kind)


KINDS = ["random", "mostly_zero", "ties_near_minus_1e9", "minus_inf"]


@pytest.mark.parametrize("k", [1, 10, MAX_K])
@pytest.mark.parametrize("kind", KINDS)
def test_topk_matches_jax_and_torch(kind, k):
    x = _rows(kind, np.random.default_rng(11))
    xt = torch.from_numpy(x)
    want = np.asarray(jtopk.topk_lastdim(jnp.asarray(x), k))
    np.testing.assert_array_equal(np.asarray(jtopk._topk_iter(jnp.asarray(x), k)), want)
    for got in (ttopk.topk_lastdim(xt, k), ttopk.topk_plain(xt, k)):
        assert got.shape == (3, 7, k) and got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
        assert torch.equal(got, torch.topk(xt, k, dim=-1).values)


@pytest.mark.parametrize("kind", KINDS)
def test_topk_plain_matches_pallas_interpret(kind):
    x = _rows(kind, np.random.default_rng(12), shape=(2, 5, 300))
    want = np.asarray(topk_pallas(jnp.asarray(x), 10, interpret=True))
    got = ttopk.topk_plain(torch.from_numpy(x), 10)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("a,k,block", [(40, 10, 64), (64, 10, 64), (8, 10, 64),
                                       (500, 20, 64), (130, 32, 32),
                                       (200, 17, 64)])
def test_short_rows_and_large_k_branches(a, k, block):
    """`a <= block` goes to `torch.topk` (k capped at a); `k > 16` goes to
    the blockwise hierarchy, with a ragged last block."""
    x = np.random.default_rng(13).normal(size=(4, a)).astype(np.float32)
    x[0, : a // 2] = 1.5  # ties
    want = np.asarray(jtopk.topk_lastdim(jnp.asarray(x), k, block))
    got = ttopk.topk_lastdim(torch.from_numpy(x), k, block)
    np.testing.assert_array_equal(got.numpy(), want)


def test_k_above_block_raises():
    with pytest.raises(ValueError, match="k <= block"):
        ttopk.topk_lastdim(torch.zeros(2, 300), 65)


def test_bf16_and_noncontiguous_inputs():
    """The cast path (selection in fp32, result in the input's dtype) and a
    strided view give what `torch.topk` gives."""
    rng = np.random.default_rng(14)
    xb = torch.from_numpy(rng.normal(size=(5, 300)).astype(np.float32)
                          ).to(torch.bfloat16)
    got = ttopk.topk_lastdim(xb, 10)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, torch.topk(xb, 10, dim=-1).values)
    want = np.asarray(jtopk.topk_lastdim(jnp.asarray(xb.float().numpy(),
                                                     jnp.bfloat16), 10))
    np.testing.assert_array_equal(got.float().numpy(), want.astype(np.float32))
    xs = torch.from_numpy(rng.normal(size=(300, 6)).astype(np.float32)).t()
    assert not xs.is_contiguous()
    assert torch.equal(ttopk.topk_lastdim(xs, 10),
                       torch.topk(xs, 10, dim=-1).values)


def test_result_has_no_autograd_history():
    x = torch.randn(3, 100, requires_grad=True)
    assert not ttopk.topk_lastdim(x, 5).requires_grad


@pytest.mark.parametrize("x,k,err", [
    (torch.zeros(2, 100), 0, ValueError),
    (torch.zeros(2, 100), MAX_K + 1, ValueError),
    (torch.zeros(2, 16), 4, ValueError),
    (torch.zeros(2, 100, dtype=torch.int32), 4, TypeError),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(x, k, err):
    with pytest.raises(err):
        topk_rows(x, k)
