"""Port parity: the transformer backbones of `pl_yolo_tpu_torch` (Swin,
SwinV2, ViT with its MoE FFN, ResTv2, MCTformer, the generic transformer
layers), the `neck: none` detector with its 4-level head, the bridge's new
leaves, weight decay and AdamW, against the JAX package on the CPU, fp32,
on seeded numpy inputs at the narrow widths of tests/test_backbones.py
and 64 px. The JAX side is jitted (its eager ops compile one by one), and
its variables come from the port's seeded init through the bridge, held to
the tree a flax init makes (traced, not run).

Tolerances: each backbone's (and layer's) eval outputs rtol 1e-5 and atol
1e-5 of the map's scale (fp32 on both sides, matmul and LayerNorm sums in
another order); the window partition, the shift mask and the bicubic
weights exact, the resized position embedding 1e-5 (and 1e-6 of a
float64 product); the MoE FFN's values and gradients 1e-5; the
detector's head maps 1e-4 (as tests/test_torch_model.py: its BatchNorm
head on 0-255 inputs), its loss and gradients rtol 1e-5 (as
tests/test_torch_loss.py), its 3-step train state as
tests/test_torch_train.py holds YOLOX's (change-relative 5e-3, losses
1e-3, base LR 5e-4); AdamW updates 1e-6.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pl_yolo_tpu.layers import blocks as jb
from pl_yolo_tpu.layers import drops as jd
from pl_yolo_tpu.layers import transformer as jtr
from pl_yolo_tpu.models.backbones import mctformer as jmct
from pl_yolo_tpu.models.backbones import restv2 as jrest
from pl_yolo_tpu.models.backbones import swin as jswin
from pl_yolo_tpu.models.backbones import swinv2 as jswin2
from pl_yolo_tpu.models.backbones import vit as jvit
from pl_yolo_tpu.models.detector import build_model as jax_build_model
from pl_yolo_tpu.train import state as jstate_mod
from pl_yolo_tpu.train.optim import _kernel_mask
from pl_yolo_tpu.train.optim import build_optimizer as jax_build_optimizer
from jax._src.image.scale import _fill_keys_cubic_kernel as jax_keys_cubic
from jax._src.image.scale import compute_weight_mat as jax_weight_mat
from pl_yolo_tpu_torch import bridge
from pl_yolo_tpu_torch.layers import drops as td
from pl_yolo_tpu_torch.layers import transformer as ttr
from pl_yolo_tpu_torch.models.backbones import mctformer as tmct
from pl_yolo_tpu_torch.models.backbones import restv2 as trest
from pl_yolo_tpu_torch.models.backbones import swin as tswin
from pl_yolo_tpu_torch.models.backbones import swinv2 as tswin2
from pl_yolo_tpu_torch.models.backbones import vit as tvit
from pl_yolo_tpu_torch.models.detector import build_model
from pl_yolo_tpu_torch.train.optim import build_optimizer
from pl_yolo_tpu_torch.train.state import TrainState, make_train_step
from pl_yolo_tpu_torch.utils.config import CONFIG_DIR, load_config

# one intra-op thread a test process: the suite runs in parallel workers
torch.set_num_threads(1)

NUM_CLASSES, SIZE = 3, 64
TOL = dict(rtol=1e-5, atol=1e-5)
MAPS_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def _fp32_compute():
    """The JAX package's compute dtype is global state; these tests run fp32."""
    prev = jb.get_compute_dtype()
    jb.set_compute_dtype(None)
    yield
    jb.set_compute_dtype(prev)


def _images(seed=0, batch=2, size=SIZE):
    return np.random.default_rng(seed).uniform(
        0, 255, (batch, size, size, 3)).astype(np.float32)


def _jitter(variables, rng):
    """Move every leaf off its init (LayerNorm scales and biases, q / v
    biases, temperatures, BN statistics), so that a leaf mapped to the
    wrong place shows."""
    def leaf(path, x):
        x = np.asarray(x, np.float32)
        if path[-1].key == "var":
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        return (x + rng.normal(0.0, 0.05, x.shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, variables)


def _bridged(jmod, tmod, x, rng, method=None, unused=()):
    """The torch module's seeded parameters, jittered, loaded into `tmod`;
    returned as flax variables, less the top-level modules `unused`, whose
    tree is held to the one a flax init of `jmod` (through `method`) makes
    (traced, not run)."""
    init = functools.partial(jmod.init, method=method)
    want = jax.eval_shape(init, jax.random.key(0), jnp.asarray(x))
    got = bridge.state_dict_to_variables(tmod.state_dict(), tmod)
    variables = _jitter({k: v for k, v in got.items() if v}, rng)
    bridge.load_variables(tmod, variables)
    variables = {c: {k: v for k, v in tree.items() if k not in unused}
                 for c, tree in variables.items()}
    assert (jax.tree.map(lambda v: v.shape, dict(want))
            == jax.tree.map(np.shape, variables))
    return variables


def _seeded(tmod):
    """The module's dense / conv layers and free parameters drawn as
    `build_model` draws them."""
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for m in tmod.modules():
            if isinstance(m, (torch.nn.Linear, torch.nn.Conv2d,
                              torch.nn.ConvTranspose2d)):
                torch.nn.init.normal_(m.weight, 0.0, m.weight[0].numel()
                                      ** -0.5, generator=gen)
        for m in tmod.modules():
            if hasattr(m, "init_weights_"):
                m.init_weights_(gen)
    return tmod.eval()


def _nhwc(ts):
    return [t.detach().permute(0, 2, 3, 1).numpy() for t in ts]


def _assert_close(got, want, tol=1e-5, what=""):
    """|got - want| <= tol·|want| + tol·max(1, max |want|): rtol, and an
    atol scaled to the map (maps of ResTv2's unnormalised stages reach
    |x| ~ 5)."""
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale,
                               err_msg=what)


# ------------------------------------------------------------- the backbones

BACKBONES = {
    "swin": (lambda: jswin.SwinTransformer(embed_dim=32, depths=(1, 1, 2, 1),
                                           num_heads=(2, 2, 4, 4),
                                           out_indices=(0, 1, 2, 3)),
             lambda: tswin.SwinTransformer(embed_dim=32, depths=(1, 1, 2, 1),
                                           num_heads=(2, 2, 4, 4),
                                           out_indices=(0, 1, 2, 3),
                                           input_size=(SIZE, SIZE))),
    # 96 px: a 24x24 first stage, shifted windows in stages 0-1
    "swinv2": (lambda: jswin2.SwinTransformerV2(embed_dim=24,
                                                depths=(2, 2, 1),
                                                num_heads=(2, 4, 4)),
               lambda: tswin2.SwinTransformerV2(embed_dim=24,
                                                depths=(2, 2, 1),
                                                num_heads=(2, 4, 4),
                                                input_size=(96, 96))),
    "vit": (lambda: jvit.VisionTransformer(embed_dim=32, depth=2,
                                           num_heads=2),
            lambda: tvit.VisionTransformer(embed_dim=32, depth=2,
                                           num_heads=2)),
    "vit_moe": (lambda: jvit.VisionTransformer(embed_dim=32, depth=2,
                                               num_heads=2, moe_experts=4,
                                               moe_capacity=0.5),
                lambda: tvit.VisionTransformer(embed_dim=32, depth=2,
                                               num_heads=2, moe_experts=4,
                                               moe_capacity=0.5)),
    "restv2": (lambda: jrest.ResTV2(depths=(1, 1, 1, 1),
                                    embed_dims=(16, 32, 64, 128)),
               lambda: trest.ResTV2(depths=(1, 1, 1, 1),
                                    embed_dims=(16, 32, 64, 128))),
    "mctformer": (lambda: jmct.MCTformer(num_classes=5, embed_dim=32,
                                         depth=2, num_heads=2),
                  lambda: tmct.MCTformer(num_classes=5, embed_dim=32,
                                         depth=2, num_heads=2)),
}
BACKBONE_SIZE = {"swinv2": 96}


@pytest.mark.parametrize("name", sorted(BACKBONES))
def test_backbone_eval_outputs_match_jax(name):
    make_j, make_t = BACKBONES[name]
    jmod, tmod = make_j(), _seeded(make_t())
    x = _images(1, size=BACKBONE_SIZE.get(name, SIZE))
    variables = _bridged(jmod, tmod, x, np.random.default_rng(2))
    want = jax.jit(lambda v, x: jmod.apply(v, x, False))(variables,
                                                          jnp.asarray(x))
    with torch.no_grad():
        got = tmod(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(got) == len(want) and list(tmod.out_channels) == [
        w.shape[-1] for w in want]
    for g, w in zip(_nhwc(got), want):
        assert g.shape == w.shape
        _assert_close(g, w)


def test_mctformer_classify_matches_jax():
    """The CAM path: class-token logits, patch logits and the fused CAMs."""
    jmod = jmct.MCTformer(num_classes=5, embed_dim=32, depth=2, num_heads=2)
    tmod = _seeded(tmct.MCTformer(num_classes=5, embed_dim=32, depth=2,
                                  num_heads=2, cam_head=True))
    x = _images(3)
    # a flax tree made through `classify` has the CAM head, not the pyramid
    variables = _bridged(jmod, tmod, x, np.random.default_rng(4),
                         method=jmct.MCTformer.classify,
                         unused=("up8", "down32"))
    for kind in ("fused", "patchcam", "attention"):
        want = jax.jit(lambda v, x, kind=kind: jmod.apply(
            v, x, 2, kind, method=jmct.MCTformer.classify))(
            variables, jnp.asarray(x))
        with torch.no_grad():
            got = tmod.classify(torch.from_numpy(x).permute(0, 3, 1, 2), 2,
                                kind)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    with pytest.raises(ValueError, match="cam_head"):
        _seeded(tmct.MCTformer(num_classes=5, embed_dim=32, depth=2,
                               num_heads=2)).classify(
            torch.zeros(1, 3, 64, 64))


def test_generic_transformer_layers_match_jax():
    x = np.random.default_rng(5).normal(size=(2, 10, 16)).astype(np.float32)
    for jmod, tmod in ((jtr.MultiHeadAttention(16, 2),
                        ttr.MultiHeadAttention(16, 2)),
                       (jtr.TransformerLayer(16, 2),
                        ttr.TransformerLayer(16, 2))):
        tmod = _seeded(tmod)
        variables = _bridged(jmod, tmod, x, np.random.default_rng(6))
        want = jax.jit(jmod.apply)(variables, jnp.asarray(x))
        with torch.no_grad():
            got = tmod(torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert ttr.SwinTransformerLayer is tswin.SwinBlock


def test_swin_refuses_a_size_its_tables_do_not_fit():
    """Built for 64 px (windows 7, 7, 4, 2), a 640 px input needs windows
    of 7 in every stage: the 4x4 table cannot serve it."""
    tmod = tswin.SwinTransformer(embed_dim=8, depths=(1, 1, 1, 1),
                                 num_heads=(1, 1, 1, 1),
                                 input_size=(SIZE, SIZE))
    assert tmod.windows == [7, 7, 4, 2]
    with pytest.raises(ValueError, match="built for input"):
        tmod(torch.zeros(1, 3, 256, 256))


# ---------------------------------------------------- windows, masks, resize

@pytest.mark.parametrize("h,w,ws", [(14, 21, 7), (8, 8, 4), (6, 6, 3)])
def test_windows_and_shift_mask_match_jax_exactly(h, w, ws):
    x = np.random.default_rng(7).normal(size=(2, h, w, 5)).astype(np.float32)
    want = np.asarray(jswin.window_partition(jnp.asarray(x), ws))
    got = tswin.window_partition(torch.from_numpy(x), ws)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tswin.window_reverse(got, ws, h, w).numpy(), x)
    np.testing.assert_array_equal(
        tswin.shift_attn_mask(h, w, ws, ws // 2),
        np.asarray(jswin._shift_attn_mask(h, w, ws, ws // 2)))
    np.testing.assert_array_equal(tswin.relative_position_index(ws),
                                  jswin._relative_position_index(ws))
    np.testing.assert_array_equal(
        tswin2.log_cpb_table(ws),
        np.asarray(jnp.asarray(jswin2._log_cpb_table(ws))))


def test_patch_merging_matches_jax():
    """The reference's concat order ((0,0), (1,0), (0,1), (1,1) parities):
    any other order moves the output by O(1)."""
    x = np.random.default_rng(8).normal(size=(2, 6, 4, 8)).astype(np.float32)
    jmod, tmod = jswin.PatchMerging(8), _seeded(tswin.PatchMerging(8))
    variables = _bridged(jmod, tmod, x, np.random.default_rng(9))
    want = jax.jit(jmod.apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        got = tmod(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("out", [4, 40], ids=["down_14to4", "up_14to40"])
def test_bicubic_position_embedding_matches_jax_image_resize(out):
    """jax.image.resize(..., "bicubic"): Keys a = -0.5, half-pixel centres,
    antialiased when downsampling; and its gradient."""
    pos = np.random.default_rng(10).normal(size=(1, 14, 14, 6)).astype(
        np.float32)
    cot = np.random.default_rng(11).normal(size=(1, out, out, 6)).astype(
        np.float32)

    def jfn(p):
        y = jax.image.resize(p, (1, out, out, 6), "bicubic")
        return jnp.sum(y * cot), y
    (_, want), wgrad = jax.jit(jax.value_and_grad(jfn, has_aux=True))(
        jnp.asarray(pos))
    p = torch.from_numpy(pos).requires_grad_()
    got = tvit.resize_bicubic(p, out, out)
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **TOL)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(wgrad), **TOL)
    # the weights equal jax's eager `compute_weight_mat` (the jitted resize
    # computes them with ~5e-7 of rounding, and lands ~4e-6 from float64
    # upsampling); the port's product is within 1e-6 of the float64 one
    w = tvit.bicubic_weights(14, out)
    np.testing.assert_array_equal(w, np.asarray(jax_weight_mat(
        14, out, jnp.float32(out / 14), jnp.float32(0.0),
        jax_keys_cubic, True)))
    exact = np.einsum("hH,bhwc,wW->bHWc", w.astype(np.float64), pos, w)
    np.testing.assert_allclose(got.detach().numpy(), exact, rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(w.sum(0), 1.0, rtol=1e-6)
    # the kernel's support: 4 taps upsampling, widened downsampling
    taps = (w != 0).sum(0).max()
    assert taps == 4 if out > 14 else taps > 4


# ---------------------------------------------------------------- the MoE FFN

def _moe_params(rng, d=16, m=24, experts=4):
    return {"moe_router": rng.normal(0, 0.3, (d, experts)),
            "moe_w1": rng.normal(0, 0.25, (experts, d, m)),
            "moe_b1": rng.normal(0, 0.1, (experts, m)),
            "moe_w2": rng.normal(0, 0.2, (experts, m, d)),
            "moe_b2": rng.normal(0, 0.1, (experts, d))}


@pytest.mark.parametrize("capacity", [0.5, 1.25])
def test_moe_ffn_matches_jax_with_overflowing_experts(capacity):
    """Switch top-1 routing by index against the JAX dense dispatch: the
    same tokens dropped (an expert past its capacity C contributes 0), the
    same values, and the gradients of the input, the router and the expert
    weights. The router is biased to one expert so that it overflows."""
    rng = np.random.default_rng(12)
    p = {k: v.astype(np.float32) for k, v in _moe_params(rng).items()}
    p["moe_router"][:, 1] += 0.4
    y = rng.normal(size=(3, 20, 16)).astype(np.float32)
    cot = rng.normal(size=y.shape).astype(np.float32)

    def jfn(p, y):
        out = jvit.moe_ffn(p, y, capacity)
        return jnp.sum(out * cot), out
    (_, want), (wgp, wgy) = jax.jit(jax.value_and_grad(
        jfn, argnums=(0, 1), has_aux=True))(p, jnp.asarray(y))
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    ty = torch.from_numpy(y).requires_grad_()
    got = tvit.moe_ffn(tp, ty, capacity)
    (got * torch.from_numpy(cot)).sum().backward()
    want = np.asarray(want)
    dropped = np.all(want == 0.0, axis=-1)
    n, experts = 60, 4
    cap = -(-int(n * capacity) // experts)
    routed = np.bincount(np.argmax(y.reshape(n, 16) @ p["moe_router"], -1),
                         minlength=experts)
    assert dropped.sum() == np.maximum(routed - cap, 0).sum()
    if capacity == 0.5:
        assert dropped.sum() > 0
    np.testing.assert_array_equal(np.all(got.detach().numpy() == 0, -1),
                                  dropped)
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    np.testing.assert_allclose(ty.grad.numpy(), np.asarray(wgy), **TOL)
    for k in p:
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(wgp[k]),
                                   **TOL, err_msg=k)


# ------------------------------------------------------ DropPath in train mode

def test_swin_train_forward_with_drop_path_matches_jax(monkeypatch):
    """Swin in train mode, drop_path_rate 0.5, both packages fed the same
    DropPath draws (the JAX ones, recorded as drawn, two a block, handed
    to the port in call order): the same branches dropped, the maps 1e-5."""
    kw = dict(embed_dim=16, depths=(2, 2), num_heads=(2, 2),
              out_indices=(0, 1), drop_path_rate=0.5)
    jmod = jswin.SwinTransformer(**kw)
    tmod = _seeded(tswin.SwinTransformer(**kw, input_size=(SIZE, SIZE)))
    x = _images(13, batch=4)
    variables = _bridged(jmod, tmod, x, np.random.default_rng(14))
    drawn = []
    orig = jd.drop_path

    def recording(rng, x, rate, deterministic=False):
        drawn.append(jax.random.bernoulli(rng, 1.0 - rate,
                                          (x.shape[0],) + (1,) * (x.ndim - 1)))
        return orig(rng, x, rate, deterministic)
    monkeypatch.setattr(jd, "drop_path", recording)

    def forward(v, x):   # jitted: the recorded draws leave as outputs
        out = jmod.apply(v, x, True, rngs={"dropout": jax.random.key(5)})
        return out, list(drawn)
    want, keeps = jax.jit(forward)(variables, jnp.asarray(x))
    keeps = [np.asarray(k) for k in keeps]
    assert len(keeps) == 2 * 3  # block 0's rate is 0: no draw
    assert any(not k.all() for k in keeps) and any(k.any() for k in keeps)
    feed = iter(torch.from_numpy(k) for k in keeps)
    monkeypatch.setattr(td, "draw_drop_path",
                        lambda gen, x, rate: next(feed))
    with torch.no_grad():
        got = tmod.train()(torch.from_numpy(x).permute(0, 3, 1, 2))
    for g, w in zip(_nhwc(got), want):
        np.testing.assert_allclose(g, np.asarray(w), **TOL)


# ------------------------------------------------------------------ configs

CONFIGS = ("swin_tiny", "swin_small", "swin_base", "swin_large", "vit_tiny",
           "vit_tiny_moe", "restv2_tiny", "mctformer_small")


def _tiny(name):
    """`name`.yaml at narrow widths and depths, its module types kept."""
    cfg = load_config(CONFIG_DIR / "model" / f"{name}.yaml")
    b = cfg["backbone"]
    if name.startswith("swin"):
        b.update(embed_dim=16, depths=[1, 1, 2, 1], num_heads=[2, 2, 4, 4])
        cfg["head"]["channels"] = [16, 32, 64, 128]
    elif name.startswith("vit"):
        b.update(embed_dim=32, depth=2, num_heads=2)
    elif name.startswith("restv2"):
        b.update(depths=[1, 1, 1, 1], embed_dims=[16, 32, 64, 128])
    else:
        b.update(embed_dim=32, depth=2, num_heads=2, num_cls_tokens=5)
        cfg["head"]["channels"] = [16, 32, 32]
    if cfg["neck"]["name"] == "csppafpn":
        cfg["neck"].update(depths=[1, 1, 1, 1], channels=[32, 64, 128])
        cfg["head"]["channels"] = [32, 64, 128]
    cfg["dtype"] = None
    return cfg


@pytest.fixture(scope="module", params=CONFIGS)
def config_pair(request):
    """A config's tiny port model and the flax tree a JAX init would make."""
    cfg = _tiny(request.param)
    tmodel = build_model(copy.deepcopy(cfg), NUM_CLASSES, device="cpu",
                         input_size=(SIZE, SIZE))
    jmodel = jax_build_model(copy.deepcopy(cfg), NUM_CLASSES)
    want = jax.eval_shape(lambda k: jmodel.init(k, input_size=(SIZE, SIZE)),
                          jax.random.key(0))
    return request.param, cfg, tmodel, jax.tree.map(lambda v: v.shape,
                                                    dict(want))


def test_config_builds_and_round_trips_through_the_bridge(config_pair):
    """Every tensor maps to the flax tree's leaf of the same shape, and
    back to the same tensor."""
    name, _, tmodel, want = config_pair
    module = tmodel.module
    variables = bridge.state_dict_to_variables(module.state_dict(), module)
    variables = {k: v for k, v in variables.items() if v}
    assert jax.tree.map(np.shape, variables) == want, name
    back = bridge.variables_to_state_dict(variables, module)
    for key, t in module.state_dict().items():
        assert torch.equal(back[key], t), key
    # and the optimizer state: an SGD momentum trace round trip
    optimizer, _ = build_optimizer(module, {"name": "SGD"}, 10)
    rng = np.random.default_rng(15)
    trace = jax.tree.map(lambda v: rng.normal(size=v.shape).astype(
        np.float32), variables["params"])
    bridge.load_momentum(optimizer, module, trace)
    got = dict(bridge._flatten(bridge.momentum_to_trace(optimizer, module)))
    for path, v in bridge._flatten(trace).items():
        np.testing.assert_array_equal(got[path], v, err_msg=str(path))


def test_decayed_parameters_are_the_flax_kernels(config_pair):
    """The port's decayed group is the bridge image of `_kernel_mask`: the
    dense, conv and transposed-conv kernels; not the stacked towers, the
    position embeddings, class tokens, position tables, temperatures, q / v
    biases or any norm."""
    name, cfg, tmodel, want = config_pair
    module = tmodel.module
    optimizer, _ = build_optimizer(module, cfg["optimizer"], 10)
    decayed, rest = optimizer.param_groups
    assert decayed["weight_decay"] == cfg["optimizer"]["weight_decay"]
    assert rest["weight_decay"] == 0.0
    names = {id(p): n for n, p in module.named_parameters()}
    got = {names[id(p)] for p in decayed["params"]}
    mask = _kernel_mask(jax.tree.map(np.zeros, want["params"]))
    flax_kernels = {"/".join(p) for p, m in
                    bridge._flatten(jax.tree.map(np.asarray, mask)).items()
                    if m}
    assert {n.replace(".", "/")[:-len("/weight")] + "/kernel"
            for n in got} == flax_kernels, name
    assert len(got) + len(rest["params"]) == len(names)
    assert not any("blocks_" in n or "pos_embed" in n for n in got)


def test_jax_transformer_backbones_compute_in_fp32_under_bf16():
    """`dtype: bfloat16` reaches only the JAX package's conv blocks: its
    Swin backbone returns fp32 maps and only the head runs in bf16; the
    port's does the same."""
    cfg = _tiny("swin_tiny")
    cfg["dtype"] = "bfloat16"
    jmodel = jax_build_model(copy.deepcopy(cfg), NUM_CLASSES)
    x = jnp.asarray(_images(16, batch=1))
    feats = jax.eval_shape(lambda k: jmodel.module.init_with_output(
        k, x, False, method=lambda m, x, t: m.backbone(x, t))[0],
        jax.random.key(0))
    assert [f.dtype for f in feats] == [jnp.float32] * 4
    tmodel = build_model(copy.deepcopy(cfg), NUM_CLASSES, device="cpu",
                         input_size=(SIZE, SIZE))
    with torch.no_grad():
        tfeats = tmodel.module.backbone(torch.zeros(1, 3, SIZE, SIZE))
        maps = tmodel.module(torch.zeros(1, SIZE, SIZE, 3))
    assert [f.dtype for f in tfeats] == [torch.float32] * 4
    jmaps = jax.eval_shape(lambda k: jmodel.module.init_with_output(
        k, x, False)[0], jax.random.key(0))
    assert [m.dtype for m in maps] == [
        getattr(torch, jnp.dtype(m.dtype).name) for m in jmaps]


def test_adamw_update_matches_optax_with_the_kernel_mask():
    """AdamW on the tiny MCTformer detector (mctformer_small.yaml's
    optimizer) from the same gradients: the port's param groups against
    `optax.adamw(mask=_kernel_mask)` (the JAX package's `build_optimizer`),
    1e-6. Two updates: the schedule's first rate is 1e-5 of the base, its
    second 0.98 of it; every tensor moves."""
    cfg = _tiny("mctformer_small")
    module = build_model(copy.deepcopy(cfg), NUM_CLASSES, device="cpu",
                         input_size=(SIZE, SIZE)).module
    params = bridge.state_dict_to_variables(module.state_dict(),
                                            module)["params"]
    tx, _ = jax_build_optimizer(cfg["optimizer"], total_steps=10)
    optimizer, _ = build_optimizer(module, cfg["optimizer"], total_steps=10)
    convt = bridge._conv_transposes(module)
    named = dict(module.named_parameters())
    rng = np.random.default_rng(17)
    @jax.jit
    def update(grads, opt_state, p):
        updates, opt_state = tx.update(grads, opt_state, p)
        return optax.apply_updates(p, updates), opt_state
    want, opt_state = params, jax.jit(tx.init)(params)
    for _ in range(2):
        grads = jax.tree.map(lambda p: rng.normal(0, 1, p.shape).astype(
            np.float32), params)
        want, opt_state = update(grads, opt_state, want)
        for path, g in bridge._flatten({"params": grads}).items():
            key, g = bridge._to_torch_key(path, g, convt)
            named[key].grad = torch.from_numpy(np.array(g))
        optimizer.step()
    got = dict(bridge._flatten(bridge.state_dict_to_variables(
        named, module)["params"]))
    init = dict(bridge._flatten(params))
    want = dict(bridge._flatten(jax.device_get(want)))
    assert set(got) == set(want) == set(init)
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, rtol=1e-6, atol=1e-6,
                                   err_msg="/".join(path))
        assert not np.array_equal(w, init[path]), "/".join(path)


# ------------------------------------------- the swin_tiny-shaped detector

def _swin_cfg():
    """swin_tiny.yaml at narrow widths: neck none, the 4-level decoupled
    head, strides 4-32; fp32, no stochastic depth (its draws are tested
    above), YOLOX's test LR of 5e-4."""
    cfg = _tiny("swin_tiny")
    cfg["backbone"]["drop_path_rate"] = 0.0
    cfg["optimizer"]["learning_rate"] = BASE_LR
    return cfg


def _labels(seed=0, batch=2):
    rng = np.random.default_rng(seed)
    labels = np.zeros((batch, 6, 5), np.float32)
    labels[:, :3, 0] = rng.integers(0, NUM_CLASSES, (batch, 3))
    labels[:, :3, 1:3] = rng.uniform(12, 52, (batch, 3, 2))
    labels[:, :3, 3:] = rng.uniform(8, 40, (batch, 3, 2))
    return labels


TOTAL_STEPS, N_STEPS, BASE_LR, SLICE_TOL = 10, 3, 0.0005, 5e-3


@pytest.fixture(scope="module")
def swin_pair():
    """The swin_tiny-shaped detector in both packages from the port's
    seeded init (BN statistics randomised), its eval head maps on one
    batch, and three train steps of each from the same state."""
    jb.set_compute_dtype(None)
    cfg = _swin_cfg()
    jmodel = jax_build_model(copy.deepcopy(cfg), NUM_CLASSES)
    tmodel = build_model(copy.deepcopy(cfg), NUM_CLASSES, device="cpu",
                         input_size=(SIZE, SIZE))
    variables = bridge.state_dict_to_variables(tmodel.module.state_dict(),
                                               tmodel.module)
    want = jax.eval_shape(lambda k: jmodel.init(k, input_size=(SIZE, SIZE)),
                          jax.random.key(0))
    assert (jax.tree.map(lambda v: v.shape, dict(want))
            == jax.tree.map(np.shape, variables))
    rng = np.random.default_rng(1)
    variables["batch_stats"] = jax.tree_util.tree_map_with_path(
        lambda p, v: (rng.uniform(0.5, 1.5, v.shape) if p[-1].key == "var"
                      else rng.normal(0, 0.1, v.shape)).astype(np.float32),
        variables["batch_stats"])
    bridge.load_variables(tmodel.module, variables)
    x, labels = _images(18), _labels()
    jmaps = jax.jit(lambda v, x: jmodel.module.apply(v, x, False))(
        variables, jnp.asarray(x))
    with torch.no_grad():
        tmaps = tmodel.module(torch.from_numpy(x))

    tx, _ = jax_build_optimizer(cfg["optimizer"], total_steps=TOTAL_STEPS)
    jstate = jstate_mod.TrainState.create(jax.tree.map(np.array, variables),
                                          tx)
    jstep = jstate_mod.make_train_step(
        jmodel.module.apply, jmodel.loss.train_loss, donate=False)
    jlosses = []
    for i in range(N_STEPS):
        jstate, losses = jstep(jstate, jnp.asarray(x), jnp.asarray(labels),
                               jax.random.key(i), use_l1=jnp.asarray(1.0))
        jlosses.append(jax.device_get(losses))
    optimizer, _ = build_optimizer(tmodel.module, cfg["optimizer"],
                                   total_steps=TOTAL_STEPS)
    tstate = TrainState.create(tmodel.module, optimizer)
    tstep = make_train_step(tmodel.loss.train_loss)
    tlosses = [tstep(tstate, torch.from_numpy(x), torch.from_numpy(labels),
                     use_l1=torch.tensor(1.0)) for _ in range(N_STEPS)]
    return dict(cfg=cfg, jmodel=jmodel, tmodel=tmodel, init=variables,
                jmaps=[np.asarray(m) for m in jmaps],
                tmaps=[m.numpy() for m in tmaps], labels=labels,
                jstate=jstate, jlosses=jlosses, tstate=tstate,
                tlosses=tlosses)


def test_swin_detector_head_maps_match_jax(swin_pair):
    assert [m.shape for m in swin_pair["tmaps"]] == [
        (2, SIZE // s, SIZE // s, 5 + NUM_CLASSES) for s in (4, 8, 16, 32)]
    for a, b in zip(swin_pair["tmaps"], swin_pair["jmaps"]):
        np.testing.assert_allclose(a, b, **MAPS_TOL)


def test_swin_detector_loss_and_input_gradients_match_jax(swin_pair):
    """The YOLOX loss over 4 levels (A = 340 anchors at 64 px) and the
    gradients of the head maps, from the JAX maps on both sides."""
    maps, labels = swin_pair["jmaps"], swin_pair["labels"]
    loss_fn = swin_pair["jmodel"].loss.train_loss

    def jfn(outs):
        losses = loss_fn(outs, jnp.asarray(labels), use_l1=True)
        return losses["loss"], losses
    (_, jl), jg = jax.jit(jax.value_and_grad(jfn, has_aux=True))(
        [jnp.asarray(m) for m in maps])
    outs = [torch.from_numpy(m).requires_grad_() for m in maps]
    tl = swin_pair["tmodel"].loss.train_loss(outs, torch.from_numpy(labels),
                                             use_l1=True)
    tl["loss"].backward()
    assert float(jl["proportion"]) > 0 and set(tl) == set(jl)
    for k in jl:
        np.testing.assert_allclose(tl[k].detach().numpy(), np.asarray(jl[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    for t, j in zip(outs, jg):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), rtol=1e-5,
                                   atol=1e-7)


def test_swin_detector_train_losses_match_jax_step_by_step(swin_pair):
    for step, (tl, jl) in enumerate(zip(swin_pair["tlosses"],
                                        swin_pair["jlosses"])):
        assert set(tl) == set(jl) and float(jl["proportion"]) > 0
        for k in jl:
            np.testing.assert_allclose(tl[k].numpy(), jl[k], rtol=1e-3,
                                       atol=1e-5, err_msg=f"step {step}: {k}")


@pytest.mark.parametrize("part", ["params", "batch_stats", "ema_params",
                                  "momentum"])
def test_swin_detector_train_state_after_three_steps_matches_jax(swin_pair,
                                                                 part):
    """As tests/test_torch_train.py: each tensor's distance from the JAX
    one within SLICE_TOL of its change since the initial state (+2 ulps);
    the output LayerNorms' biases, whose gradient is 0 but for rounding,
    moved by at most 1e-6 of the largest change on either side."""
    jstate, tstate = swin_pair["jstate"], swin_pair["tstate"]
    module = tstate.module
    assert tstate.step == int(jstate.step) == N_STEPS
    if part == "momentum":
        want = [s for s in jax.tree.leaves(
            jstate.opt_state,
            is_leaf=lambda s: isinstance(s, optax.TraceState))
            if isinstance(s, optax.TraceState)][0].trace
        got = bridge.momentum_to_trace(tstate.optimizer, module)
        init = jax.tree.map(np.zeros_like, swin_pair["init"]["params"])
    elif part == "ema_params":
        want = jstate.ema_params
        got = bridge.state_dict_to_variables(
            tstate.eval_module.state_dict(), module)["params"]
        init = swin_pair["init"]["params"]
    else:
        want = getattr(jstate, part)
        got = bridge.state_dict_to_variables(module.state_dict(),
                                             module)[part]
        init = swin_pair["init"][part]
    got, init = dict(bridge._flatten(got)), dict(bridge._flatten(init))
    want = dict(bridge._flatten(jax.device_get(want)))
    assert set(got) == set(want) == set(init)
    largest = max(np.abs(want[p] - init[p]).max() for p in want)
    moved = 0
    for path in want:
        change = np.abs(want[path] - init[path]).max()
        if path[1].startswith("out_norm") and path[-1] == "bias":
            # the head's stems are conv + train-mode BN, which cancel a
            # per-channel constant: these biases' gradient is 0 but for
            # rounding, so both packages must leave them (all but) put
            assert max(change, np.abs(got[path] - init[path]).max()) \
                <= 1e-6 * largest, "/".join(path)
            continue
        moved += change > 0
        err = np.abs(got[path] - want[path]).max()
        ulps = 2 * np.finfo(np.float32).eps * np.abs(want[path]).max()
        assert err <= SLICE_TOL * change + ulps, (
            f"{part}: {'/'.join(path)} differs by {err:.3e}, "
            f"{err / max(change, 1e-30):.3e} of its change {change:.3e}")
    assert moved > 0.9 * len(want)
