"""TransUNet (R50-ViT-B/16) in the PyTorch port vs ``cbim_tpu``'s, on the
CPU, with the 2D zoo's checks (``test_torch_unet2d``), and the official
``.npz`` loader against ``import_transunet_npz``.

The R50 stem keeps its fixed widths; the ViT is cut to hidden 96, 3
heads, MLP 192, at 64^2 (a 4^2 token grid), dropout 0 (the JAX side draws
its masks from another stream).  It keeps 12 layers: ``import_transunet``
walks exactly 12 (``cbim_tpu/utils/torch_import.py:665``), so a shallower
ViT cannot go through the JAX importer or its ``.npz`` loader.  Every
GroupNorm's and LayerNorm's scale and bias and every BatchNorm's
statistics are drawn away from their initial values, so the affine
orientation and the norms' eps are exercised.  The ``.npz`` files are
written by the test with the official keys and random values: one whose
position embedding carries a cls token, one whose 3^2 grid the loader
zooms to 4^2; each loads through ``--pretrain``'s
``training.pretrained.load_init_model`` into the port and through
``import_transunet_npz`` into the JAX variables, and the forwards agree.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbim_tpu.models.transunet import TransUNet as JaxTransUNet
from cbim_tpu.utils import torch_import
from cbim_tpu_torch.config import config_from_dict
from cbim_tpu_torch.models import get_model, transunet
from cbim_tpu_torch.training.pretrained import load_init_model
from cbim_tpu_torch.training.train_state import create_train_state
from cbim_tpu_torch.utils.jax_import import transunet_state_dict_from_jax
from test_torch_unet2d import (PROB_ATOL, SHAPE, ZOO2D, _x,
                               check_eval_forward, check_round_trip,
                               check_step_grads, few_torch_threads,
                               port_variables)  # noqa: F401

D = dict(ZOO2D, model="transunet", hidden_size=96, mlp_dim=192,
         num_layers=12, transunet_num_heads=3, dropout_rate=0.0)
JM = JaxTransUNet(num_classes=4, img_size=64, grid=(4, 4), hidden_size=96,
                  mlp_dim=192, num_layers=12, num_heads=3, dropout=0.0)
#: one jitted forward for every test of the file (one compile)
APPLY = jax.jit(JM.apply)
#: the position embeddings of the two ``.npz`` files: 1 + 16 tokens (the
#: cls token dropped) and 1 + 9 (3^2 zoomed to the model's 4^2)
NPZ_TOKENS = {"cls": 17, "zoom": 10}


def perturb_norms(variables, seed):
    """Every GroupNorm's and LayerNorm's scale 1 + N(0, 0.2^2) and bias
    N(0, 0.2^2), drawn with numpy, in place."""
    rng = np.random.default_rng(seed)

    def walk(tree):
        for k, sub in tree.items():
            if k.startswith(("GN_", "LayerNorm_")):
                for name, arr in sub.items():
                    base = 1.0 if name == "scale" else 0.0
                    sub[name] = (base + 0.2 * rng.normal(size=arr.shape)
                                 ).astype(np.float32)
            elif isinstance(sub, dict):
                walk(sub)

    walk(variables["params"])
    return variables


@pytest.fixture(scope="module")
def case():
    def to_jax(sd, tmpl):
        return torch_import.import_transunet(sd, tmpl)

    return D, JM, to_jax, transunet_state_dict_from_jax


@pytest.fixture(scope="module")
def variables(case):
    return perturb_norms(port_variables(case, 1), 7)


def test_keys_round_trip_through_import_transunet(case):
    """The stem, the ViT (q, k, v fused in Flax and split back), the
    decoder's BatchNorms with their statistics, the head."""
    check_round_trip(case)


def test_eval_forward_matches_jax(case, variables, monkeypatch):
    """Plain convs only, as in JAX: no kernel wrapper call."""
    got = check_eval_forward(case, variables, monkeypatch, apply=APPLY)
    assert got == dict(conv2d=0, inorm=0, routed_conv=0, routed_norm=0)


def two_layers(variables):
    """The Flax variables with the ViT cut to its first two layers (the
    encoder norm renumbered): the gradient check's model, whose tracing
    the other ten layers would only lengthen."""
    params = {k: v for k, v in variables["params"].items()
              if not (k.startswith(("Attention_", "Mlp_"))
                      and int(k.split("_")[1]) >= 2)
              and not (k.startswith("LayerNorm_")
                       and int(k.split("_")[1]) >= 4)}
    params["LayerNorm_4"] = variables["params"]["LayerNorm_24"]
    return {"params": params, "batch_stats": variables["batch_stats"]}


def test_step_gradients_match_jax(variables):
    """One step of the 2-layer ViT (the 12-layer tree cut), batch 1."""
    jm = JaxTransUNet(num_classes=4, img_size=64, grid=(4, 4),
                      hidden_size=96, mlp_dim=192, num_layers=2, num_heads=3,
                      dropout=0.0)
    case = (dict(D, num_layers=2), jm, None, transunet_state_dict_from_jax)
    check_step_grads(case, two_layers(variables), shape=(1, 64, 64))


def _official_npz(path, tokens, seed):
    """An R50+ViT-B_16-layout ``.npz`` for the test's widths, random values
    (seeded numpy): HWIO convs, per-head (hidden, heads, dim_head)
    query/key/value and (heads, dim_head, hidden) out kernels, the
    position embedding of ``tokens`` tokens."""
    rng = np.random.default_rng(seed)
    hidden, heads, mlp = 96, 3, 192
    w = {}

    def put(key, *shape, scale=0.05, base=0.0):
        w[key] = (base + scale * rng.normal(size=shape)).astype(np.float32)

    put("embedding/kernel", 1, 1, 1024, hidden)
    put("embedding/bias", hidden)
    put("Transformer/encoder_norm/scale", hidden, base=1.0)
    put("Transformer/encoder_norm/bias", hidden)
    put("Transformer/posembed_input/pos_embedding", 1, tokens, hidden)
    for i in range(12):
        src = f"Transformer/encoderblock_{i}"
        attn = f"{src}/MultiHeadDotProductAttention_1"
        for name in ("query", "key", "value"):
            put(f"{attn}/{name}/kernel", hidden, heads, hidden // heads)
            put(f"{attn}/{name}/bias", heads, hidden // heads)
        put(f"{attn}/out/kernel", heads, hidden // heads, hidden)
        put(f"{attn}/out/bias", hidden)
        put(f"{src}/MlpBlock_3/Dense_0/kernel", hidden, mlp)
        put(f"{src}/MlpBlock_3/Dense_0/bias", mlp)
        put(f"{src}/MlpBlock_3/Dense_1/kernel", mlp, hidden)
        put(f"{src}/MlpBlock_3/Dense_1/bias", hidden)
        for j in (0, 2):
            put(f"{src}/LayerNorm_{j}/scale", hidden, base=1.0)
            put(f"{src}/LayerNorm_{j}/bias", hidden)
    put("conv_root/kernel", 7, 7, 3, 64)
    put("gn_root/scale", 64, base=1.0)
    put("gn_root/bias", 64)
    cin = 64
    for b, (units, cout, cmid) in enumerate(((3, 256, 64), (4, 512, 128),
                                             (9, 1024, 256))):
        for u in range(1, units + 1):
            src = f"block{b + 1}/unit{u}"
            for c, (k, ci, co) in enumerate(((1, cin, cmid), (3, cmid, cmid),
                                             (1, cmid, cout))):
                put(f"{src}/conv{c + 1}/kernel", k, k, ci, co)
                put(f"{src}/gn{c + 1}/scale", co, base=1.0)
                put(f"{src}/gn{c + 1}/bias", co)
            if u == 1:
                put(f"{src}/conv_proj/kernel", 1, 1, cin, cout)
                put(f"{src}/gn_proj/scale", cout, base=1.0)
                put(f"{src}/gn_proj/bias", cout)
            cin = cout
    np.savez(path, **w)


@pytest.mark.parametrize("posemb", ["cls", "zoom"])
def test_npz_pretrain_matches_import_transunet_npz(posemb, case, variables,
                                                   tmp_path):
    """``--pretrain`` with the official ``.npz``: the port
    (``load_init_model``, non-strict) and JAX (``import_transunet_npz``)
    from the same starting weights and file give the same eval softmax
    within 1e-4; the stem and the ViT come from the file, the decoder and
    the head keep their values."""
    path = str(tmp_path / "R50+ViT-B_16.npz")
    _official_npz(path, NPZ_TOKENS[posemb], seed=11)
    with np.load(path) as npz:
        ref_vars = torch_import.import_transunet_npz(npz, variables)
    cfg = config_from_dict(D)
    model = get_model(cfg, device="cpu")
    start = transunet_state_dict_from_jax(variables)
    model.load_state_dict(start)
    load_init_model(path, model, cfg)
    got = model.state_dict()
    assert torch.equal(got["decoder.conv_more.1.running_var"],
                       start["decoder.conv_more.1.running_var"])
    assert torch.equal(got["segmentation_head.0.weight"],
                       start["segmentation_head.0.weight"])
    assert not torch.equal(got["transformer.embeddings.position_embeddings"],
                           start["transformer.embeddings.position_embeddings"])
    want = transunet_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, ref_vars))
    for k in ("transformer.embeddings.position_embeddings",
              "transformer.encoder.layer.11.attn.value.weight",
              "transformer.embeddings.hybrid_model.body.block3.unit9.conv2"
              ".weight"):
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    x = _x((*SHAPE, 1), 3)
    ref = jax.nn.softmax(APPLY(ref_vars, jnp.asarray(x)), -1)
    with torch.inference_mode():
        out = torch.softmax(model(torch.from_numpy(x).movedim(-1, 1)), 1)
    np.testing.assert_allclose(out.movedim(1, -1).numpy(), np.asarray(ref),
                               rtol=0, atol=PROB_ATOL)


def test_npz_for_another_model_raises(tmp_path):
    from cbim_tpu_torch.training.checkpoint import read_state_dict
    path = str(tmp_path / "backbone.npz")
    np.savez(path, a=np.zeros(2, np.float32))
    cfg = config_from_dict(dict(ZOO2D, model="unet", block="SingleConv"))
    with pytest.raises(NotImplementedError, match="TransUNet"):
        load_init_model(path, get_model(cfg, device="cpu"), cfg)
    with pytest.raises(NotImplementedError, match="TransUNet"):
        read_state_dict(path)


def test_resnet_geometry_and_norms():
    """At 256^2 the unpadded max-pool turns the 128 map into 63, so the
    skips are zero-padded at the bottom and right to 64 and 32; the ViT
    reads a 16^2 grid.  ``gn_proj`` is GroupNorm(C, C) at eps 1e-5, the
    other GroupNorms 32 groups at 1e-6; another window raises."""
    stem = transunet.ResNetV2().eval()
    x = torch.randn(1, 3, 256, 256, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        feat, skips = stem(x)
        block1 = stem.body[0](torch.nn.functional.max_pool2d(
            stem.root(x), 3, stride=2))
    assert block1.shape[2:] == (63, 63)
    assert [tuple(s.shape[1:]) for s in skips] == [
        (512, 32, 32), (256, 64, 64), (64, 128, 128)]
    assert feat.shape[1:] == (1024, 16, 16)
    assert torch.equal(skips[1][:, :, :63, :63], block1)
    assert not skips[1][:, :, 63:].any() and not skips[1][:, :, :, 63:].any()
    for name, m in stem.named_modules():
        if isinstance(m, torch.nn.GroupNorm):
            want = ((m.num_channels, 1e-5) if name.endswith("gn_proj")
                    else (32, 1e-6))
            assert (m.num_groups, m.eps) == want, name
    model = get_model(config_from_dict(D), device="cpu")
    with pytest.raises(ValueError, match="training_size"):
        model(torch.zeros(1, 1, 96, 96))


def test_dropout_draws_from_the_train_state():
    """``dropout_rate`` (default 0.1) on the embeddings and each MLP: JAX's
    formula, where(u < 1 - p, x / (1 - p), 0) per element, drawn from the
    generator ``create_train_state`` seeds; none in eval mode."""
    cfg = config_from_dict({k: v for k, v in D.items()
                            if k != "dropout_rate"} | dict(num_layers=1))
    model = get_model(cfg, device="cpu", train=True)
    drops = [m for m in model.modules() if isinstance(m, transunet.Dropout)]
    assert len(drops) == 2 and all(m.p == 0.1 for m in drops)
    state = create_train_state(model, cfg, seed=5)
    assert all(m.generator is state.generator for m in drops)
    x = torch.randn(2, 16, 96, generator=torch.Generator().manual_seed(1))
    keep = drops[0].keep_mask(x)
    state.generator.manual_seed(5)
    y = drops[0](x)
    torch.testing.assert_close(
        y, torch.where(keep, x / 0.9, torch.zeros(())), rtol=0, atol=0)
    assert 0.85 < float(keep.float().mean()) < 0.95
    assert torch.equal(drops[0].eval()(x), x)
    assert transunet.TransUNet(1, 4, (4, 4)).transformer.embeddings \
        .dropout.p == 0.1


def test_acdc_transunet_matches_the_chip_smoke_recipe():
    """``chip_smoke.py``'s ACDC_TRANSUNET dict carries
    configs/acdc/transunet_2d.yaml's model keys (the model it builds:
    ``test_torch_unet2d.py::test_shipped_acdc_recipes_build``)."""
    pytest.importorskip("yaml")
    import os
    import runpy
    from cbim_tpu_torch.config import load_config
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    smoke = runpy.run_path(os.path.join(repo, "chip_smoke.py"))
    cfg = load_config("acdc", "transunet", "2d")
    for key, value in smoke["ACDC_TRANSUNET"].items():
        assert cfg.get(key) == value, key
