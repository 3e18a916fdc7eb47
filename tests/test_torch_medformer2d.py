"""MedFormer-2D of the PyTorch port vs ``cbim_tpu``'s, on the CPU.

The Flax model is initialised, its BatchNorm parameters and running
statistics are perturbed (seeded numpy), the variables go through
``medformer2d_state_dict_from_jax`` into the port, and both run on the same
input: the eval-mode forward, the slice-batch sliding window, and the
prediction CLI end to end.  On the CPU the port's 3x3 kernel sites run their
plain versions and the JAX model its XLA path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbim_tpu.inference import engines as jax_engines
from cbim_tpu.models import get_model as jax_get_model
from cbim_tpu.models.medformer import SemanticMapFusion as JaxMapFusion
from cbim_tpu.ops.interpolate import resize_linear as jax_resize_linear
from cbim_tpu.utils.torch_import import import_medformer2d
from cbim_tpu_torch import prediction
from cbim_tpu_torch.config import config_from_dict
from cbim_tpu_torch.data.nifti import read_nifti, write_nifti
from cbim_tpu_torch.inference import engines
from cbim_tpu_torch.models import get_model
from cbim_tpu_torch.models.layers.convs import ConvNormAct
from cbim_tpu_torch.models.medformer import SemanticMapFusion
from cbim_tpu_torch.ops.interpolate import resize_linear
from cbim_tpu_torch.ops.kernels.conv2d import Conv2dSame
from cbim_tpu_torch.utils.jax_import import (_bmha_perm, _Walk,
                                             medformer2d_state_dict_from_jax)
from test_torch_threads import few_torch_threads  # noqa: F401

#: a narrow MedFormer-2D with the ACDC recipe's structure and the JAX
#: default's conv blocks in down2/up2 (BatchNorm + ReLU, 3x3 kernels, 2x2
#: downsampling, B-MHA from down2 to up2, aux head)
TINY2D = dict(
    dataset="synthetic", model="medformer", dimension="2d", classes=4,
    in_chan=1, base_chan=8, map_size=2, conv_block="BasicBlock",
    conv_num=[2, 1, 0, 0, 0, 1, 2, 2], trans_num=[0, 1, 1, 1, 1, 1, 0, 0],
    num_heads=[1, 4, 4, 4, 4, 4, 1, 1], expansion=2, fusion_depth=2,
    fusion_dim=64, fusion_heads=4, proj_type="depthwise", aux_loss=True,
    attn_drop=0.0, proj_drop=0.0)

#: the model keys of configs/acdc/medformer_2d.yaml
ACDC = dict(
    dataset="acdc", model="medformer", dimension="2d", classes=4, in_chan=1,
    base_chan=32, conv_block="BasicBlock", map_size=3,
    conv_num=[2, 0, 0, 0, 0, 0, 2, 2], trans_num=[0, 2, 2, 2, 2, 2, 0, 0],
    num_heads=[1, 4, 8, 16, 8, 4, 1, 1], expansion=2, fusion_depth=2,
    fusion_dim=512, fusion_heads=16, attn_drop=0.0, proj_drop=0.0,
    proj_type="depthwise", aux_loss=True, training_size=[256, 256])


def jax_variables(d, hw=32, seed=0):
    """Flax variables {"params", "batch_stats"} as numpy trees, with every
    BatchNorm's scale, bias, mean and variance drawn from seeded numpy (the
    initial 1, 0, 0, 1 would leave the norms' parameters untested)."""
    model = jax_get_model(config_from_dict(d))
    init = jax.jit(lambda k, x: model.init({"params": k}, x, train=False))
    v = init(jax.random.PRNGKey(seed), jnp.zeros((1, hw, hw, 1), jnp.float32))
    v = jax.tree_util.tree_map(np.array, dict(v))
    rng = np.random.default_rng(seed + 100)

    def perturb(tree, kind):
        for k, sub in tree.items():
            if k == "BatchNorm_0":
                for name, arr in sub.items():
                    if kind == "params":
                        base = 1.0 if name == "scale" else 0.0
                        sub[name] = (base + 0.2 * rng.normal(size=arr.shape)
                                     ).astype(np.float32)
                    elif name == "mean":
                        sub[name] = (0.3 * rng.normal(size=arr.shape)
                                     ).astype(np.float32)
                    else:
                        sub[name] = rng.uniform(0.5, 2.0, arr.shape
                                                ).astype(np.float32)
            elif isinstance(sub, dict):
                perturb(sub, kind)

    perturb(v["params"], "params")
    perturb(v["batch_stats"], "batch_stats")
    return model, v


def zero_variables(d, hw=32):
    model = jax_get_model(config_from_dict(d))
    shapes = jax.eval_shape(
        lambda x: model.init({"params": jax.random.PRNGKey(0)}, x,
                             train=False),
        jax.ShapeDtypeStruct((1, hw, hw, 1), jnp.float32))
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                  dict(shapes))


def port_model(d, variables):
    cfg = config_from_dict(d)
    model = get_model(cfg, device="cpu")
    model.load_state_dict(medformer2d_state_dict_from_jax(variables, cfg))
    return cfg, model


def test_tiny_forward_matches_jax():
    jm, v = jax_variables(TINY2D)
    _, model = port_model(TINY2D, v)
    x = np.random.default_rng(0).normal(size=(3, 32, 32, 1)).astype(np.float32)
    j_out, j_aux = jax.jit(lambda v, x: jm.apply(v, x, train=False))(
        v, jnp.asarray(x))
    with torch.inference_mode():
        t_out, t_aux = model(torch.from_numpy(x).movedim(-1, 1))
    # fp32 on both sides, eval-mode BatchNorm with the same running
    # statistics; only the order of sums differs.  Softmax within 1e-4.
    for t, j in ((t_out, j_out), (t_aux, j_aux)):
        np.testing.assert_allclose(
            torch.softmax(t, 1).movedim(1, -1).numpy(),
            np.asarray(jax.nn.softmax(j, -1)), atol=1e-4)
        np.testing.assert_allclose(t.movedim(1, -1).numpy(), np.asarray(j),
                                   rtol=1e-4, atol=1e-4)


def test_state_dict_round_trip_through_import_medformer2d():
    """``import_medformer2d`` of the port's state_dict gives the tree that
    ``medformer2d_state_dict_from_jax`` maps back to the same state_dict."""
    cfg = config_from_dict(TINY2D)
    model = get_model(cfg, device="cpu",
                      generator=torch.Generator().manual_seed(3))
    gen = torch.Generator().manual_seed(4)
    for m in model.modules():            # non-trivial BN state
        if hasattr(m, "running_var"):
            m.running_mean.normal_(generator=gen)
            m.running_var.uniform_(0.5, 2.0, generator=gen)
            m.weight.data.normal_(generator=gen)
    sd = model.state_dict()
    d = TINY2D
    flax = import_medformer2d(sd, zero_variables(d), d["conv_num"],
                              d["trans_num"], d["num_heads"], d["base_chan"],
                              d["fusion_depth"], d["fusion_heads"],
                              d["aux_loss"])
    back = medformer2d_state_dict_from_jax(flax, cfg)
    assert back.keys() == sd.keys()
    for k in sd:
        if k.endswith("num_batches_tracked"):
            continue                      # Flax keeps no such counter
        assert torch.equal(back[k], sd[k].contiguous()), k


def test_full_width_acdc_params_match_flax_tree():
    """Every parameter and running statistic of the full-width ACDC model
    has its Flax counterpart of the same size, and nothing is left over."""
    tree = zero_variables(ACDC, hw=64)
    cfg = config_from_dict(ACDC)
    model = get_model(cfg, device="cpu")
    model.load_state_dict(medformer2d_state_dict_from_jax(tree, cfg))
    n_flax = sum(a.size for a in jax.tree_util.tree_leaves(tree["params"]))
    assert sum(p.numel() for p in model.parameters()) == n_flax
    n_stats = sum(a.size for a in jax.tree_util.tree_leaves(tree["batch_stats"]))
    assert sum(b.numel() for n, b in model.named_buffers()
               if "running" in n) == n_stats


def test_acdc_kernel_sites_are_the_stride1_3x3_convs():
    """At the ACDC recipe with ``conv2d_kernel`` on (the route is opt-in, as
    JAX's ``CBIM_PLCONV2D=1``) the 2D kernel carries 14 ConvNormAct convs:
    2 in inc's block, 4 in down1, 4 each in up3 and up4, every one with
    C_in, C_out <= 192.  inc's first conv is a plain conv in both
    packages."""
    model = get_model(config_from_dict(dict(ACDC, conv2d_kernel=True)),
                      device="cpu")
    sites = [n for n, m in model.named_modules()
             if isinstance(m, ConvNormAct) and m.kernel is Conv2dSame]
    assert len(sites) == 14
    assert {s.split(".")[0] for s in sites} == {"inc", "down1", "up3", "up4"}


@pytest.mark.parametrize("shape", [(5, 48, 40), (3, 20, 28)])
def test_sliding_window_slices_matches_jax(shape):
    """The slice batch through both engines, with the same weights; the
    second volume is smaller than the 32^2 window on both axes (padded and
    cropped back)."""
    d = dict(TINY2D, window_size=[32, 32])
    jm, v = jax_variables(d, seed=5)
    cfg, model = port_model(d, v)
    vol = np.random.default_rng(2).normal(size=(*shape, 1)).astype(np.float32)

    def apply_fn(variables, x):
        return jm.apply(variables, x, train=False)[0]

    ref = jax_engines.InferenceEngine(
        apply_fn, 4, (32, 32), variables=v).sliding_window_slices(
            jnp.asarray(vol))
    got = engines.make_engine(model, cfg).sliding_window_slices(
        torch.from_numpy(vol))
    assert got.shape == (*shape, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)


def test_whole_image_2d_matches_jax():
    jm, v = jax_variables(TINY2D, seed=6)
    cfg, model = port_model(TINY2D, v)
    img = np.random.default_rng(3).normal(size=(2, 32, 32, 1)).astype(np.float32)
    ref = jax_engines.InferenceEngine(
        lambda v, x: jm.apply(v, x, train=False)[0], 4,
        variables=v).whole_image(jnp.asarray(img))
    got = engines.make_engine(model, cfg).whole_image(torch.from_numpy(img))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)


def test_prediction_main_2d_on_the_cpu(tmp_path):
    """2D serving end to end: slice spacing kept, y/x resampled and padded
    to the training size, the slice batch swept, the label map written back
    on the input grid."""
    cfg = dict(TINY2D, training_size=[32, 32], window_size=[32, 32],
               sliding_window=True)
    weights = tmp_path / "w.pth"
    torch.save(get_model(config_from_dict(cfg), device="cpu",
                         generator=torch.Generator().manual_seed(0))
               .state_dict(), weights)
    in_dir, out_dir = tmp_path / "in", tmp_path / "out"
    in_dir.mkdir()
    rng = np.random.default_rng(0)
    vols = {"a.nii.gz": ((4, 30, 26), (5.0, 1.0, 1.0)),     # padded in-plane
            "b.nii.gz": ((3, 40, 52), (6.0, 0.8, 0.8))}     # resampled
    for name, (shape, spacing) in vols.items():
        write_nifti(str(in_dir / name),
                    rng.normal(size=shape).astype(np.float32), spacing=spacing)
    seconds = prediction.main(
        ["--dataset", "synthetic", "--model", "medformer", "--dimension",
         "2d", "--load", str(weights), "--img_path", str(in_dir),
         "--save_path", str(out_dir), "--target_spacing", "1.0,1.0",
         "--device", "cpu"], cfg=config_from_dict(cfg))
    assert sorted(seconds) == sorted(vols)
    for name, (shape, spacing) in vols.items():
        pred = read_nifti(str(out_dir / name))
        assert pred.data.shape == shape and pred.data.dtype == np.uint8
        assert pred.data.max() < cfg["classes"]
        assert pred.spacing == pytest.approx(spacing)


def test_pad_to_training_size_2d_pads_y_and_x_only():
    """The reference's pad, (size + 2 - s) // 2 a side, on y/x only."""
    cfg = config_from_dict(dict(TINY2D, training_size=[32, 32]))
    img = np.zeros((4, 10, 12), np.float32)
    padded, idx = prediction.pad_to_training_size(img, cfg)
    assert padded.shape == (4, 34, 34) and idx == [12, 22, 11, 23]
    assert prediction.unpad(padded, idx, cfg).shape == img.shape


@pytest.mark.parametrize("src,dst", [((5, 7), (10, 14)), ((16, 16), (32, 32)),
                                     ((8, 6), (3, 11))])
def test_resize_linear_2d_matches_jax(src, dst):
    """Bilinear, align_corners=True: the decoder's 2D upsample (and the aux
    head's resize) against the JAX package's separable rule."""
    x = np.random.default_rng(sum(src)).normal(size=(2, *src, 3)).astype(
        np.float32)
    got = resize_linear(torch.from_numpy(x).movedim(-1, 1), dst)
    ref = jax_resize_linear(jnp.asarray(x), dst)
    # fp32 lerps of unit-scale values in another order (the JAX rule
    # resizes one axis at a time): a few ulp of O(1) values
    np.testing.assert_allclose(got.movedim(1, -1).numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)


def test_map_fusion_transformer_on_2d_maps_matches_jax():
    """The cross-scale TransformerBlock on three 2D semantic maps, weights
    through the importer's walk; the dim2 head merge (dim-head-major) is
    the ``to_out`` column permutation."""
    dims, dim, heads = (16, 32, 64), 32, 4
    rng = np.random.default_rng(8)
    maps = [rng.normal(size=(2, 3, 3, d)).astype(np.float32) for d in dims]
    jm = JaxMapFusion(dim=dim, heads=heads, depth=2)
    v = jm.init(jax.random.PRNGKey(1), [jnp.asarray(m) for m in maps])
    walk = _Walk({"SemanticMapFusion_0": jax.tree_util.tree_map(
        np.asarray, v["params"])})
    walk.map_fusion(2, out_perm=_bmha_perm(heads, dim // heads))
    model = SemanticMapFusion(dims, dim, heads, depth=2, nd=2)
    model.load_state_dict({k.removeprefix("map_fusion."): t for k, t in
                           walk.state_dict().items()})
    ref = jm.apply(v, [jnp.asarray(m) for m in maps])
    with torch.inference_mode():
        got = model([torch.from_numpy(m).movedim(-1, 1) for m in maps])
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.movedim(1, -1).numpy(), np.asarray(r),
                                   rtol=1e-4, atol=1e-5)
