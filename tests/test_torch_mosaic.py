"""Port parity: the mosaic warp of `pl_yolo_tpu_torch` (`ops.mosaic`, and
`ops.cuda.mosaic_warp.warp_plain`, the kernel's plain version, which the
wrapper runs on a CPU tensor) against the JAX package on the CPU.

Two references, on the same numpy inputs:
* the Pallas kernel in interpret mode (`mosaic_sample_idx`,
  `warp_sample_idx`). It rounds tiles, weights and its x-pass to bf16 for the
  TPU's matrix unit, so the bounds are those of the JAX package's own kernel
  test (`tests/test_mosaic_pallas.py`): |diff| <= 3 grey levels, mean < 0.5;
* the canvas route in fp32 (`_paste_window`'s canvas + `batched_separable`
  for the mosaic, `batched_separable` with fill 0 for the mixup warp). It
  takes the same bilinear weights, but sums the y-pass first and blends the
  fill as 114-valued canvas texels instead of a coverage term: fp32
  rounding of a 0..255 sum in another order, ~3e-5 an operation, so
  CANVAS_TOL = 1e-3 grey levels.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pl_yolo_tpu.data.augment import FILL, batched_separable
from pl_yolo_tpu.ops.pallas import mosaic_pallas as jm
from pl_yolo_tpu_torch.ops import mosaic as tm
from pl_yolo_tpu_torch.ops.cuda.mosaic_warp import mosaic_warp, warp_plain

# one intra-op thread a test process: the suite runs in parallel workers
torch.set_num_threads(1)

B, H, W = 3, 40, 48  # not square, so that a swapped axis shows
CANVAS_TOL = 1e-3


def _mosaic_case(name, rng):
    """(oxw, oyw [B,4] int32, xs [B,W], ys [B,H] fp32) in window coords,
    drawn as `_mosaic_geometry` draws them, then bent to the case."""
    oxw, oyw, xs, ys = [], [], [], []
    for i in range(B):
        cx = int(rng.integers(W // 2, 3 * W // 2 + 1))
        cy = int(rng.integers(H // 2, 3 * H // 2 + 1))
        if name == "centres at the window's edges":   # tiles half outside
            cx = (W // 2, 3 * W // 2, W // 2)[i]
            cy = (H // 2, H // 2, 3 * H // 2)[i]
        oxw.append([cx - W, cx, cx - W, cx])
        oyw.append([cy - H, cy - H, cy, cy])
        s = {"scale 0.1": 0.1, "scale 2.0": 2.0}.get(
            name, float(rng.uniform(0.5, 1.5)))
        tx, ty = rng.uniform(0.4, 0.6) * W, rng.uniform(0.4, 0.6) * H
        x = (np.arange(W) - tx) / s + W
        y = (np.arange(H) - ty) / s + H
        if name == "flipped":
            x = x[::-1]
        if name == "outside the window":
            x = x + (-2.5 * W, 0.6 * W, 0.0)[i]   # left, right, inside
            y = y - (0.0, 0.0, 4.0 * H)[i]        # all rows outside
        xs.append(x)
        ys.append(y)
    return (np.asarray(oxw, np.int32), np.asarray(oyw, np.int32),
            np.asarray(xs, np.float32), np.asarray(ys, np.float32))


def _mixup_case(name, rng):
    """(xs [B,W], ys [B,H]) of the mixup partner warp: scale f, crop
    offset, `flip`; K=1, valid on [0, W-1] x [0, H-1], fill 0."""
    xs, ys = [], []
    for i in range(B):
        f = {"scale 0.5": 0.5, "scale 1.5": 1.5}.get(name, rng.uniform(0.5, 1.5))
        xo = rng.uniform(0, max(W * f - W, 0))
        yo = rng.uniform(0, max(H * f - H, 0))
        x = (np.arange(W) + xo + 0.5) / f - 0.5
        if name == "flipped" and i % 2 == 0:
            x = x[::-1]
        if name == "outside the window":
            x = x + (-0.5 * W, 0.5 * W, 2.0 * W)[i]
        xs.append(x)
        ys.append((np.arange(H) + yo + 0.5) / f - 0.5)
    return np.asarray(xs, np.float32), np.asarray(ys, np.float32)


MOSAIC_CASES = ["scale 0.1", "scale 2.0", "centres at the window's edges",
                "flipped", "outside the window"]
MIXUP_CASES = ["scale 0.5", "scale 1.5", "flipped", "outside the window"]


def _pool(rng):
    return rng.uniform(0, 255, (B, 3, H, W)).astype(np.float32)


def _tidx(rng):
    perm = rng.permutation(B)
    return np.stack([np.arange(B)] + [np.roll(perm, -i) for i in (1, 2, 3)],
                    axis=1).astype(np.int32)


def _canvas_mosaic(pool, tidx, oxw, oyw, xs, ys):
    """The JAX package's canvas route, as `tests/test_mosaic_pallas.py`
    builds it: paste 4 tiles onto a 3Hx3W canvas of 114, sample the central
    2Hx2W window with `batched_separable`."""
    mh, mw = H // 2, W // 2
    tiles = pool.transpose(0, 2, 3, 1)[tidx]            # [B,4,H,W,3]
    canvas = np.full((B, 3 * H, 3 * W, 3), FILL, np.float32)
    for i in range(B):
        for k in range(4):
            y, x = oyw[i, k] + mh, oxw[i, k] + mw
            canvas[i, y:y + H, x:x + W] = tiles[i, k]
    window = canvas[:, mh:mh + 2 * H, mw:mw + 2 * W]
    xs = np.where((xs >= 0) & (xs < 2 * W), xs, -1e9)
    ys = np.where((ys >= 0) & (ys < 2 * H), ys, -1e9)
    out = batched_separable(jnp.asarray(window), jnp.asarray(xs),
                            jnp.asarray(ys))
    return np.asarray(out).transpose(0, 3, 1, 2)


def _port_mosaic(pool, tidx, oxw, oyw, xs, ys, dtype=torch.float32):
    t = torch.from_numpy
    return tm.mosaic_sample_idx(t(pool).to(dtype), t(tidx), t(oxw), t(oyw),
                                t(xs), t(ys)).float().numpy()


@pytest.mark.parametrize("name", MOSAIC_CASES)
def test_mosaic_matches_pallas_interpret_and_canvas_route(name):
    rng = np.random.default_rng(MOSAIC_CASES.index(name))
    pool, tidx = _pool(rng), _tidx(rng)
    geo = _mosaic_case(name, rng)
    got = _port_mosaic(pool, tidx, *geo)
    assert got.shape == (B, 3, H, W)
    pallas = np.asarray(jm.mosaic_sample_idx(
        jnp.asarray(pool), jnp.asarray(tidx), *map(jnp.asarray, geo),
        interpret=True))
    np.testing.assert_allclose(got, pallas, atol=3.0)
    assert np.abs(got - pallas).mean() < 0.5
    np.testing.assert_allclose(got, _canvas_mosaic(pool, tidx, *geo),
                               rtol=0, atol=CANVAS_TOL)
    if name == "outside the window":   # the third image samples no row
        np.testing.assert_array_equal(got[2], FILL)


@pytest.mark.parametrize("name", MIXUP_CASES)
def test_mixup_warp_matches_pallas_interpret_and_canvas_route(name):
    rng = np.random.default_rng(10 + MIXUP_CASES.index(name))
    pool = _pool(rng)
    idx = rng.permutation(B).astype(np.int32)
    xs, ys = _mixup_case(name, rng)
    got = tm.warp_sample_idx(torch.from_numpy(pool), torch.from_numpy(idx),
                             torch.from_numpy(xs), torch.from_numpy(ys),
                             fill=0.0).numpy()
    pallas = np.asarray(jm.warp_sample_idx(
        jnp.asarray(pool), jnp.asarray(idx), jnp.asarray(xs),
        jnp.asarray(ys), fill=0.0, interpret=True))
    np.testing.assert_allclose(got, pallas, atol=3.0)
    assert np.abs(got - pallas).mean() < 0.5
    canvas = np.asarray(batched_separable(
        jnp.asarray(pool.transpose(0, 2, 3, 1)[idx]), jnp.asarray(xs),
        jnp.asarray(ys), fill=0.0)).transpose(0, 3, 1, 2)
    np.testing.assert_allclose(got, canvas, rtol=0, atol=CANVAS_TOL)


def test_bf16_pool_rounds_once():
    """A bf16 pool is read as it is, summed in fp32 and rounded once: the
    result is the fp32 pool's result rounded to bf16 (the pool's values are
    bf16 values), and within the JAX kernel test's bf16 bound (4 grey
    levels) of the Pallas kernel."""
    rng = np.random.default_rng(20)
    pool = torch.from_numpy(_pool(rng)).to(torch.bfloat16)
    tidx = _tidx(rng)
    geo = _mosaic_case("scale 2.0", rng)
    got = _port_mosaic(pool.float().numpy(), tidx, *geo, dtype=torch.bfloat16)
    exact = _port_mosaic(pool.float().numpy(), tidx, *geo)
    np.testing.assert_array_equal(
        got, torch.from_numpy(exact).to(torch.bfloat16).float().numpy())
    pallas = np.asarray(jm.mosaic_sample_idx(
        jnp.asarray(pool.float().numpy(), jnp.bfloat16), jnp.asarray(tidx),
        *map(jnp.asarray, geo), interpret=True)).astype(np.float32)
    np.testing.assert_allclose(got, pallas, atol=4.0)


def test_chw_layout_helpers_match_jax():
    x = np.random.default_rng(21).uniform(0, 255, (2, H, W, 3)).astype(
        np.float32)
    chw = tm.to_chw(torch.from_numpy(x))
    assert chw.is_contiguous()
    np.testing.assert_array_equal(chw.numpy(),
                                  np.asarray(jm.to_chw(jnp.asarray(x))))
    np.testing.assert_array_equal(tm.from_chw(chw).numpy(), x)


def _args(**over):
    rng = np.random.default_rng(22)
    geo = _mosaic_case("scale 2.0", rng)
    args = dict(pool=torch.from_numpy(_pool(rng)),
                tidx=torch.from_numpy(_tidx(rng)),
                ox=torch.from_numpy(geo[0]), oy=torch.from_numpy(geo[1]),
                xs=torch.from_numpy(geo[2]), ys=torch.from_numpy(geo[3]),
                hix=2 * W, hiy=2 * H, fill=FILL)
    args.update(over)
    return args


@pytest.mark.parametrize("bad,err", [
    (dict(pool=torch.zeros(B, 3, H, W, dtype=torch.uint8)), TypeError),
    (dict(pool=torch.zeros(B, 3, H, W, dtype=torch.float16)), TypeError),
    (dict(pool=torch.zeros(B, 4, H, W)), ValueError),
    (dict(pool=torch.zeros(B, 3, W, H).transpose(2, 3)), ValueError),
    (dict(tidx=torch.zeros(B, 4)), TypeError),
    (dict(tidx=torch.zeros(B, 0, dtype=torch.int32)), ValueError),
    (dict(tidx=torch.full((B, 4), B, dtype=torch.int32)), IndexError),
    (dict(tidx=torch.full((B, 4), -1, dtype=torch.int32)), IndexError),
    (dict(ox=torch.zeros(B, 3, dtype=torch.int32)), ValueError),
    (dict(xs=torch.zeros(B, W + 1)), ValueError),
    (dict(ys=torch.zeros(B, H, dtype=torch.int32)), TypeError),
    (dict(hix=0), ValueError),
    (dict(ox=None), ValueError),
    (dict(tidx=torch.full((B, 1), B, dtype=torch.int64), ox=None, oy=None),
     IndexError),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad, err):
    with pytest.raises(err):
        mosaic_warp(**_args(**bad))


def test_cpu_tensor_takes_the_plain_version_and_counts_no_launch():
    before = mosaic_warp.launches
    args = _args()
    got = mosaic_warp(**args)
    assert mosaic_warp.launches == before
    assert torch.equal(got, warp_plain(**args))
    assert got.dtype == torch.float32 and got.shape == (B, 3, H, W)


@pytest.mark.parametrize("index_dtype", [torch.int64, torch.int16])
def test_int64_indices_and_origins_give_the_int32_result(index_dtype):
    """The augmentation hands over int64 tile indices; any integer dtype of
    indices and origins gives the int32 call's result bit for bit."""
    args = _args()
    want = mosaic_warp(**args)
    got = mosaic_warp(**dict(args, **{k: args[k].to(index_dtype)
                                      for k in ("tidx", "ox", "oy")}))
    assert torch.equal(got, want)


def test_k1_without_origins_is_the_warp_with_zero_origins():
    """`warp_sample_idx` hands over no origins (K=1): the result equals the
    call with zero origins, bit for bit, and the plain version's."""
    rng = np.random.default_rng(23)
    pool = torch.from_numpy(_pool(rng))
    idx = torch.from_numpy(rng.permutation(B)).to(torch.int64)[:, None]
    xs, ys = map(torch.from_numpy, _mixup_case("scale 1.5", rng))
    zeros = torch.zeros((B, 1), dtype=torch.int32)
    got = mosaic_warp(pool, idx, None, None, xs, ys, W, H, 0.0)
    assert torch.equal(got, mosaic_warp(pool, idx, zeros, zeros, xs, ys, W,
                                        H, 0.0))
    assert torch.equal(got, warp_plain(pool, idx, zeros, zeros, xs, ys, W,
                                       H, 0.0))
    assert torch.equal(got, tm.warp_sample_idx(pool, idx[:, 0], xs, ys))


@pytest.mark.parametrize("k", [5, 8])
def test_more_than_four_tiles_match_pallas_interpret(k):
    """K > 4 tiles (the kernel stages the taps of 4 at a time): the mosaic's
    four tiles plus tiles shifted by thirds of a tile, summed where they
    overlap, against the Pallas kernel at its test's bounds."""
    rng = np.random.default_rng(30 + k)
    pool = _pool(rng)
    oxw, oyw, xs, ys = _mosaic_case("scale 0.5-1.5", rng)
    more = range(1, (k + 3) // 4)
    tidx = np.concatenate([_tidx(rng)] + [np.roll(_tidx(rng), i, 1)
                                          for i in more], 1)[:, :k]
    oxw = np.concatenate([oxw] + [oxw + i * W // 3 for i in more], 1)[:, :k]
    oyw = np.concatenate([oyw] + [oyw + i * H // 3 for i in more], 1)[:, :k]
    geo = (oxw, oyw, xs, ys)
    got = _port_mosaic(pool, tidx, *geo)
    pallas = np.asarray(jm.mosaic_sample_idx(
        jnp.asarray(pool), jnp.asarray(tidx), *map(jnp.asarray, geo),
        interpret=True))
    np.testing.assert_allclose(got, pallas, atol=3.0)
    assert np.abs(got - pallas).mean() < 0.5
    assert got.max() > 255.0  # the overlapping tiles do add up
