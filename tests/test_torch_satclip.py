"""The port's SatCLIP-conditioned routes against the JAX package, on the CPU
in f32 (the tower in float64) at a small size: spherical harmonics, the
location encoder and its wrapper, the bicubic resize, the inject generator
in every style, the concat route's input, one fused step on each route,
serving with coordinates, and the training CLI."""

import json
import os

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from nirgan_tpu.config import load_config
from nirgan_tpu.inference import synthesize_dataset as jax_synthesize_dataset
from nirgan_tpu.losses import gan_loss as jax_gan_loss
from nirgan_tpu.losses import l1_loss as jax_l1_loss
from nirgan_tpu.models import generator as jax_generator
from nirgan_tpu.models.satclip import SatClipWrapper as JaxSatClipWrapper
from nirgan_tpu.models.satclip.location_encoder import LocationEncoder as JaxLocationEncoder
from nirgan_tpu.models.satclip.spherical_harmonics import sh_features as jax_sh_features
from nirgan_tpu.ops.resize import resize_bicubic as jax_resize_bicubic
from nirgan_tpu.ops.resize import resize_bilinear as jax_resize_bilinear
from nirgan_tpu.tasks import Px2PxTask as JaxPx2PxTask
from nirgan_tpu.train.torch_convert import export_resnet_generator
from nirgan_tpu_torch.inference import synthesize_dataset
from nirgan_tpu_torch.models import define_G_inject
from nirgan_tpu_torch.models.generator import ResnetGenerator
from nirgan_tpu_torch.models.satclip import (
    LocationEncoder,
    SatClipWrapper,
    get_satclip_loc_encoder,
)
from nirgan_tpu_torch.models.satclip.spherical_harmonics import embedding_dim, sh_features
from nirgan_tpu_torch.ops.resize import resize_bicubic
from nirgan_tpu_torch.tasks import Px2PxTask
from nirgan_tpu_torch.tasks.px2px import LOSS_KEYS
from nirgan_tpu_torch.train import cli
from nirgan_tpu_torch.weights import (
    d_params_from_jax,
    load_reference_weights,
    params_from_jax,
)
from tests.conftest import REPO_ROOT
from tests.test_inference import _TinySRDataset
from tests.test_torch_train import _assert_grads_close

SIZE, PAD = 32, 4


def _coords(n, seed=0):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(-180, 180, n), rng.uniform(-90, 90, n)],
                    axis=1).astype(np.float32)


# ------------------------------------------------------------------ the tower
@pytest.mark.parametrize("convention", ["analytic", "closed-form"])
def test_sh_features_match_jax_package(convention):
    c = _coords(16, seed=1).astype(np.float64)
    ref = jax_sh_features(c, 10, convention, xp=np)
    got = sh_features(torch.from_numpy(c), 10, convention)
    assert got.dtype == torch.float64 and got.shape == (16, embedding_dim(10))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-12)


def test_location_encoder_from_a_seed_matches_jax_package():
    """Both packages draw the seeded fallback from the same numpy stream:
    the same weights, and float64 outputs within 1e-12."""
    ref_enc = JaxLocationEncoder.create(seed=4)
    enc = LocationEncoder.create(seed=4)
    for i, (w, b) in enumerate(ref_enc.weights):
        np.testing.assert_array_equal(getattr(enc, f"weight{i}").numpy(), w)
        np.testing.assert_array_equal(getattr(enc, f"bias{i}").numpy(), b)
    assert enc.param_count() == ref_enc.param_count()
    assert enc.embed_dim == ref_enc.embed_dim == 256
    c = _coords(8, seed=2)
    feats = jax_sh_features(c.astype(np.float64), 10, "analytic", xp=np)
    ref64 = ref_enc._forward(feats, np)
    got64 = enc.forward64(torch.from_numpy(c))
    assert got64.dtype == torch.float64
    np.testing.assert_allclose(got64.numpy(), ref64, rtol=0, atol=1e-12)
    got = enc.encode(c)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, ref_enc.encode(c))
    assert not list(enc.parameters())  # frozen: buffers only
    # the JAX package's weights go across as numpy arrays
    carried = LocationEncoder(ref_enc.weights, convention=ref_enc.convention)
    np.testing.assert_array_equal(carried.encode(c), got)


def _satclip_ckpt(tmp_path, seed=9, convention="analytic"):
    """A Lightning-format SatCLIP .ckpt of a seeded encoder, as
    tests/test_satclip.py builds one."""
    enc = JaxLocationEncoder.create(seed=seed, convention=convention)
    sd = {}
    for i, (w, b) in enumerate(enc.weights[:-1]):
        sd[f"model.location.nnet.layers.{i}.weight"] = torch.from_numpy(w.T.copy())
        sd[f"model.location.nnet.layers.{i}.bias"] = torch.from_numpy(b.copy())
    sd["model.location.nnet.last_layer.weight"] = torch.from_numpy(enc.weights[-1][0].T.copy())
    sd["model.location.nnet.last_layer.bias"] = torch.from_numpy(enc.weights[-1][1].copy())
    path = str(tmp_path / "satclip-test-l10.ckpt")
    torch.save({"hyper_parameters": {"harmonics_calculation": convention,
                                     "legendre_polys": 10, "embed_dim": 256},
                "state_dict": sd}, path)
    return path, enc


@pytest.mark.parametrize("convention", ["analytic", "closed-form"])
def test_wrapper_loads_a_torch_ckpt(tmp_path, convention):
    path, enc = _satclip_ckpt(tmp_path, convention=convention)
    wrapper = SatClipWrapper(path)
    assert wrapper.loaded_from == path and wrapper.embed_dim == 256
    assert wrapper.encoder.convention == convention
    c = _coords(8, seed=10)
    np.testing.assert_array_equal(wrapper.predict(c), enc.encode(c))
    np.testing.assert_array_equal(JaxSatClipWrapper(path).predict(c), wrapper.predict(c))
    np.testing.assert_array_equal(wrapper.embed(c).numpy(), wrapper.predict(c))
    assert get_satclip_loc_encoder(path).embed_dim == 256


def test_wrapper_falls_back_with_a_warning_and_refuses_a_directory(tmp_path):
    with pytest.warns(UserWarning, match="not found"):
        wrapper = SatClipWrapper(str(tmp_path / "missing.ckpt"), seed=2)
    assert wrapper.loaded_from is None
    c = _coords(4, seed=3)
    np.testing.assert_array_equal(wrapper.predict(c),
                                  JaxSatClipWrapper(None, seed=2).predict(c))
    with pytest.raises(NotImplementedError, match="orbax"):
        SatClipWrapper(str(tmp_path))


# ------------------------------------------------------------------ resizing
@pytest.mark.parametrize("out", [(23, 11), (8, 40), (16, 16)])
def test_resize_bicubic_matches_jax_package_and_torch(out):
    x = np.random.default_rng(0).standard_normal((2, 16, 16, 2)).astype(np.float32)
    got = resize_bicubic(torch.from_numpy(x), *out).numpy()
    ref = np.asarray(jax_resize_bicubic(jnp.asarray(x), *out))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    lib = torch.nn.functional.interpolate(
        torch.from_numpy(x).permute(0, 3, 1, 2), size=out, mode="bicubic",
        align_corners=False).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, lib, rtol=0, atol=1e-5)


# ------------------------------------------------------- the inject generator
def _jax_inject(style, scaling, post, ngf=8, n_blocks=1, size=32):
    G = jax_generator.ResnetGenerator(
        3, 1, ngf, n_blocks=n_blocks, inject=True, inject_style=style,
        scaling_param=scaling, scaling_param_init=0.3, post_correction=post,
        post_correction_init=0.7)
    params = G.init(jax.random.key(1), jnp.zeros((1, size, size, 3)),
                    jnp.zeros((1, 256)))["params"]
    return G, jax.device_get(params)


@pytest.mark.parametrize("post", [False, True], ids=["", "post_correction"])
@pytest.mark.parametrize("style,scaling", [("add", True), ("multiply", True),
                                           ("multiply", False)])
def test_inject_generator_matches_jax(style, scaling, post):
    """f32 on the CPU with the JAX weights through ``params_from_jax``:
    atol 2e-5, the plain generator's bound."""
    G, params = _jax_inject(style, scaling, post)
    rng = np.random.default_rng(5)
    x = rng.random((2, 32, 32, 3), dtype=np.float32)
    e = rng.standard_normal((2, 256)).astype(np.float32)
    ref = np.asarray(G.apply({"params": params}, jnp.asarray(x), jnp.asarray(e)))
    port = ResnetGenerator(3, 1, 8, n_blocks=1, inject=True, inject_style=style,
                           scaling_param=scaling, post_correction=post)
    sd = params_from_jax(params)
    assert set(sd) == set(port.state_dict())
    assert ("scale_param" in sd) == scaling and ("post_correction_param" in sd) == post
    assert tuple(sd["fc.weight"].shape) == (128 * 128, 256)
    port.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(e)).numpy()
    assert got.shape == ref.shape == (2, 32, 32, 1)
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5)
    with pytest.raises(ValueError, match="location embedding"):
        port(torch.from_numpy(x))


def test_location_plane_takes_the_swapped_size():
    """The reference resizes the plane to size=(W, H): for a 6 x 10 feature
    map the plane is (B, 10, 6, 1), the JAX package's resize of the same
    dense layer's output."""
    G, params = _jax_inject("multiply", True, False)
    port = ResnetGenerator(3, 1, 8, n_blocks=1, inject=True)
    port.load_state_dict(params_from_jax(params), strict=True)
    e = np.random.default_rng(6).standard_normal((2, 256)).astype(np.float32)
    with torch.no_grad():
        got = port.location_plane(torch.from_numpy(e), 6, 10).numpy()
    fc = params["fc"]
    plane = (e @ fc["kernel"] + fc["bias"]).reshape(2, 128, 128, 1)
    ref = np.asarray(jax_resize_bilinear(jnp.asarray(plane), 10, 6))
    assert got.shape == (2, 10, 6, 1)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_inject_generator_refuses_what_the_reference_does_not_define():
    with pytest.raises(NotImplementedError, match="inject style"):
        ResnetGenerator(3, 1, 8, n_blocks=1, inject=True, inject_style="gate")
    with pytest.raises(ValueError, match="scaling_param"):
        ResnetGenerator(3, 1, 8, n_blocks=1, inject=True, inject_style="add",
                        scaling_param=False)


# ------------------------------------------------------------- the task routes
def _config(style, size=SIZE, **satclip):
    cfg = load_config(os.path.join(REPO_ROOT, "configs/config_px2px_SatCLIP.yaml"))
    bc = cfg.base_configs
    bc.ngf, bc.ndf = 8, 8
    if style == "concat":
        bc.netG = "resnet_6blocks"
    cfg.satclip.satclip_style = style
    cfg.satclip.satclip_path = None
    for k, v in satclip.items():
        cfg.satclip[k] = v
    cfg.Data.padding_amount = PAD
    cfg.tpu.compute_dtype = "float32"
    cfg.tpu.train_metrics_every = 2
    cfg.tpu.shape_buckets = [size]
    return cfg


def _batch(seed, dn=False):
    rng = np.random.default_rng(seed)
    base = rng.random((2, 3, SIZE // 8, SIZE // 8)).astype(np.float32)
    rgb = torch.nn.functional.interpolate(
        torch.from_numpy(base), size=(SIZE, SIZE), mode="bicubic",
        align_corners=False).clamp(0, 1)
    nir = (0.6 * rgb[:, 1:2] + 0.4 * rgb[:, 2:3]).clamp(0, 1)
    batch = {"rgb": rgb.numpy(), "nir": nir.numpy(), "coords": _coords(2, seed)}
    if dn:
        batch["rgb"] = (batch["rgb"] * 10000).astype(np.uint16)
        batch["nir"] = (batch["nir"] * 10000).astype(np.uint16)
    return batch


@pytest.fixture(scope="module", params=["inject", "concat"])
def pair(request):
    """(config, the JAX task, its seeded state, the port's task on the same
    weights) for one SatCLIP route; post-correction on, so every learnable
    scalar is on the path."""
    cfg = _config(request.param, post_correction=True, post_correction_init=0.9)
    jt = JaxPx2PxTask(cfg)
    state = jax.device_get(jax.jit(lambda: jt.init_state(seed=0, image_size=SIZE))())
    port = Px2PxTask(cfg, device="cpu", seed=0)
    port.netG.load_state_dict(params_from_jax(state.params_g), strict=True)
    port.netD.load_state_dict(d_params_from_jax(state.params_d), strict=True)
    return cfg, jt, state, port


@pytest.mark.parametrize("dn", [False, True], ids=["reflectance", "uint16_dn"])
def test_extract_batch_matches_jax(pair, dn):
    """The three entries of a step batch; the concat route's plane is a
    float 4th channel beside RGB converted from DN on the way."""
    cfg, jt, _, port = pair
    batch = _batch(1, dn=dn)
    ref = jt.extract_batch(batch)
    got = port.extract_batch(batch)
    assert set(got) == set(ref)
    for k in ref:
        r = np.asarray(ref[k])
        assert tuple(got[k].shape) == r.shape, k
        assert str(got[k].dtype).split(".")[1] == str(r.dtype), k
        np.testing.assert_allclose(got[k].numpy().astype(np.float64),
                                   r.astype(np.float64), rtol=0, atol=2e-6, err_msg=k)
    channels = 4 if cfg.satclip.satclip_style == "concat" else 3
    assert got["rgb"].shape[-1] == channels
    assert port.netD.conv0.weight.shape[1] == channels + 1


def test_embed_coords_runs_the_tower_in_the_loaders_thread(pair):
    """The trainer hands ``embed_coords`` to its loader: with workers the
    tower runs in the producer thread, and a batch that arrives with
    "embeds" extracts to the same tensors, bit for bit, without running the
    tower again."""
    import threading
    from unittest import mock

    from nirgan_tpu_torch.data.pipeline import Loader

    _, _, _, port = pair
    items = [{k: v[i] for k, v in _batch(s).items()} for s in (3, 4) for i in range(2)]
    seen = []

    def embed(batch):
        seen.append(threading.get_ident())
        return port.embed_coords(batch)

    for workers in (0, 2):
        seen.clear()
        plain = list(Loader(items, 2, num_workers=workers))
        batches = list(Loader(items, 2, num_workers=workers, transform=embed))
        assert len(batches) == len(plain) == 2
        assert all((t == threading.get_ident()) == (workers == 0) for t in seen)
        for batch, raw in zip(batches, plain):
            assert set(batch) == set(raw) | {"embeds"}
            assert batch["embeds"].shape == (2, 256) and batch["embeds"].device.type == "cpu"
            want = port.extract_batch(raw)
            with mock.patch.object(port.satclip_model, "embed",
                                   side_effect=AssertionError("the tower ran again")):
                got = port.extract_batch(batch)
            assert set(got) == set(want)
            for k in want:
                assert torch.equal(got[k], want[k]), k
    # the plain route's batches pass through untouched
    cfg = _config("inject")
    cfg.satclip.use_satclip = False
    assert Px2PxTask(cfg, device="cpu", seed=0).embed_coords(plain[0]) is plain[0]


def test_fused_step_matches_jax_on_the_satclip_routes(pair):
    """One fused step from the same weights: the 8 loss terms within rtol
    2e-5 + atol 2e-6, the bar of the plain route's step 1; the conditioning
    scalars the step logs are the updated ones."""
    cfg, jt, state, port = pair
    batch = _batch(0)
    _, ref = jt.make_train_step()(jax.device_put(state), jt.extract_batch(batch))
    ref = {k: float(v) for k, v in jax.device_get(ref).items()}
    snapshot = {k: v.clone() for k, v in port.netG.state_dict().items()}
    snap_d = {k: v.clone() for k, v in port.netD.state_dict().items()}
    got = {k: float(v) for k, v in port.train_step(port.init_state(),
                                                   port.extract_batch(batch)).items()}
    for k in LOSS_KEYS:
        np.testing.assert_allclose(got[k], ref[k], rtol=2e-5, atol=2e-6, err_msg=k)
    if cfg.satclip.satclip_style == "inject":
        for k in ("scale_param", "post_correction_param"):
            np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=1e-6, err_msg=k)
            assert got[k] == pytest.approx(float(getattr(port.netG, k).detach()))
            assert got[k] != pytest.approx(float(snapshot[k]), abs=1e-6)
    else:
        assert "scale_param" not in got and "scale_param" not in ref
    port.netG.load_state_dict(snapshot)
    port.netD.load_state_dict(snap_d)


def test_step_gradients_match_jax_on_the_satclip_routes(pair):
    """G and D gradients of one port step vs jax.grad of the same losses
    (LR 0 keeps D as it was): each tensor within 1e-4 of its largest entry,
    ``fc``, ``scale_param`` and ``post_correction_param`` included."""
    cfg, jt, state, port = pair
    batch = _batch(0)
    ex = jt.extract_batch(batch)
    emb = ex.get("embeds")
    pg0, pd0 = state.params_g, state.params_d

    def g_loss(pg):
        pred = jt.g_apply(pg, ex["rgb"], emb, train=True)
        logits = jt.d_apply(pd0, jnp.concatenate([ex["rgb"], pred], -1))
        return (jax_gan_loss(logits, True, "lsgan") * jt.lambda_gan
                + jax_l1_loss(pred, ex["nir"]) * jt.lambda_l1)

    def d_loss(pd):
        pred = jax.lax.stop_gradient(jt.g_apply(pg0, ex["rgb"], emb, train=True))
        fake = jnp.concatenate([ex["rgb"], pred], -1)
        real = jnp.concatenate([ex["rgb"], ex["nir"]], -1)
        return (jax_gan_loss(jt.d_apply(pd, fake), False, "lsgan")
                + jax_gan_loss(jt.d_apply(pd, real), True, "lsgan"))

    ref = {"G": params_from_jax(jax.device_get(jax.jit(jax.grad(g_loss))(pg0))),
           "D": d_params_from_jax(jax.device_get(jax.jit(jax.grad(d_loss))(pd0)))}
    st = port.init_state()
    st.set_lr(0.0, 0.0)
    port.train_step(st, port.extract_batch(batch))
    for tag, net in (("G", port.netG), ("D", port.netD)):
        grads = {k: p.grad for k, p in net.named_parameters()}
        # fc's bias is ahead of no norm: held like a weight, on its own
        dense = {"fc.bias": grads.pop("fc.bias")} if "fc.bias" in grads else {}
        _assert_grads_close(grads, {k: ref[tag][k] for k in grads}, tag)
        for k, g in dense.items():
            scale = float(ref[tag][k].abs().max())
            assert float((g - ref[tag][k]).abs().max()) <= 1e-4 * scale, (k, scale)
    if cfg.satclip.satclip_style == "inject":
        assert {"fc.weight", "fc.bias", "scale_param",
                "post_correction_param"} <= set(grads := dict(port.netG.named_parameters()))
        assert all(float(grads[k].grad.abs().max()) > 0
                   for k in ("fc.weight", "scale_param", "post_correction_param"))
        in_opt = {id(p) for g in st.opt_g.param_groups for p in g["params"]}
        assert all(id(grads[k]) in in_opt for k in ("fc.weight", "scale_param"))


def test_predict_step_with_coords_matches_jax(pair):
    """Odd 25 x 30 tiles are reflect-padded to bucket 32 (on the concat
    route with the plane attached), so both stacks must pad alike."""
    _, jt, state, port = pair
    jt.bind(state)
    rgb = np.random.default_rng(3).random((2, 3, 25, 30), dtype=np.float32)
    c = _coords(2, seed=7)
    if jt.satclip_style == "concat":
        # the reference's swapped-size resize fits square tiles only
        rgb = rgb[:, :, :, :25]
    ref = jt.predict_step(rgb, c)
    got = port.predict_step(rgb, c)
    assert got.shape == ref.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5)
    with pytest.raises(ValueError, match="requires coords"):
        port.predict_step(rgb)
    other = port.predict_step(rgb, c + np.float32(20.0))
    assert np.abs(other - got).max() > 1e-6  # the coordinates reach the output


class _CoordsSRDataset(_TinySRDataset):
    def __getitem__(self, i):
        item = super().__getitem__(i)
        item["coords"] = _coords(1, seed=100 + i)[0]
        return item


def test_synthesize_dataset_with_coords_matches_jax(tmp_path):
    """The inject route through both bulk pipelines (5 tiles of 32^2, batch
    2: a ragged tail), no histogram matching: fp16 outputs within 1e-3."""
    cfg = _config("inject")
    jt = JaxPx2PxTask(cfg)
    state = jt.init_state(seed=0, image_size=SIZE)
    jt.bind(state)
    port = Px2PxTask(cfg, device="cpu")
    port.bind(params_from_jax(jax.device_get(state.params_g)))
    ds = _CoordsSRDataset(hr=SIZE, lr=SIZE // 4)
    n_ref = jax_synthesize_dataset(jt, ds, str(tmp_path / "jax"), batch_size=2,
                                   match_histograms=False)
    n = synthesize_dataset(port, ds, str(tmp_path / "port"), batch_size=2,
                           match_histograms=False)
    assert n == n_ref == 5
    for name in sorted(os.listdir(tmp_path / "jax")):
        ref = np.load(tmp_path / "jax" / name)["nir"].astype(np.float32)
        got = np.load(tmp_path / "port" / name)["nir"]
        assert got.dtype == np.float16 and got.shape == (1, SIZE, SIZE)
        np.testing.assert_allclose(got.astype(np.float32), ref, rtol=0, atol=1e-3)


# ------------------------------------------------------------------- weights
def test_reference_ckpt_with_inject_extras_loads(tmp_path):
    """A reference Lightning .ckpt with ``netG.fc.*``, ``netG.scale_param``
    and ``netG.post_correction_param`` (as the JAX package exports one)
    loads into the inject generator, the same tensors ``params_from_jax``
    gives."""
    cfg = _config("inject", post_correction=True)
    G, params = _jax_inject("multiply", True, True, n_blocks=9)
    sd = export_resnet_generator(params, prefix="netG.", n_blocks=9)
    assert "netG.fc.weight" in sd and "netG.scale_param" in sd
    path = str(tmp_path / "ref.ckpt")
    torch.save({"state_dict": {k: torch.from_numpy(np.array(v))
                               for k, v in sd.items()}}, path)
    loaded = load_reference_weights(path, cfg)["netG"]
    direct = params_from_jax(params)
    assert set(loaded) == set(direct)
    for k in direct:
        torch.testing.assert_close(loaded[k], direct[k], rtol=0, atol=0, msg=k)
    net = define_G_inject(cfg)
    net.load_state_dict(loaded, strict=True)
    assert float(net.scale_param.detach()) == pytest.approx(0.3)


def test_define_G_inject_is_seeded_and_shares_the_plain_convs():
    from nirgan_tpu_torch.models import define_G

    cfg = _config("inject")
    a = define_G_inject(cfg, generator=torch.Generator().manual_seed(3))
    b = define_G_inject(cfg, generator=torch.Generator().manual_seed(3))
    plain = define_G(3, 1, 8, "resnet_9blocks", "instance",
                     generator=torch.Generator().manual_seed(3))
    assert a.n_blocks == 9 and float(a.scale_param.detach()) == pytest.approx(0.01)
    assert a.post_correction_param is None
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        torch.testing.assert_close(va, vb, rtol=0, atol=0, msg=k)
    for k, v in plain.state_dict().items():
        torch.testing.assert_close(a.state_dict()[k], v, rtol=0, atol=0, msg=k)
    assert float(a.fc.bias.detach().abs().sum()) == 0.0
    assert 0.015 < float(a.fc.weight.detach().std()) < 0.025
    cfg.base_configs.netG = "resnet_6blocks"
    with pytest.raises(NotImplementedError, match="resnet_9blocks"):
        define_G_inject(cfg)


def test_task_refuses_an_unknown_style():
    cfg = _config("inject")
    cfg.satclip.satclip_style = "film"
    with pytest.raises(NotImplementedError, match="concat"):
        Px2PxTask(cfg, device="cpu")


# ------------------------------------------------------------------- the CLI
def _small_satclip_file(tmp_path, style="inject"):
    cfg = _config(style).to_dict()
    cfg["Data"].update(train_batch_size=2, val_batch_size=2, num_workers=0)
    cfg["Data"]["fake_settings"].update(image_size=SIZE, length=4)
    path = tmp_path / f"small_{style}.yaml"
    path.write_text(yaml.safe_dump(cfg, sort_keys=False))
    return str(path)


def test_cli_defaults_train_the_satclip_config(tmp_path, monkeypatch, capsys):
    """``python -m nirgan_tpu_torch.train`` with its default arguments picks
    the SatCLIP config, as the reference CLI (here shrunk where the CLI
    loads it), trains, validates, checkpoints and resumes; the logged rows
    carry ``scale_param``."""
    from nirgan_tpu_torch import config as port_config

    assert cli.parse_args([]).satclip is True and cli.parse_args([]).config is None
    small, asked = _small_satclip_file(tmp_path), []

    def load(path):
        asked.append(path)
        return real(small)

    real = port_config.load_config
    monkeypatch.setattr(port_config, "load_config", load)
    run = str(tmp_path / "run")
    argv = ["--device", "cpu", "--logdir", run, "--log-every", "1"]
    state = cli.main(argv + ["--max-steps", "2"])
    assert asked == ["configs/config_px2px_SatCLIP.yaml"]
    assert "Satclip: True" in capsys.readouterr().out
    assert state.step == 2
    with open(os.path.join(run, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    train = [r for r in rows if "model_loss/generator_total_loss" in r]
    assert [r["step"] for r in train] == [1, 2]
    assert all(np.isfinite(r["scale_param"]) for r in train)
    assert train[0]["scale_param"] != train[1]["scale_param"]
    assert [r["step"] for r in rows if "val/L1" in r] == [2]
    blob = torch.load(os.path.join(run, "last.pt"), weights_only=True)
    assert {"fc.weight", "scale_param"} <= set(blob["G"])
    state = cli.main(argv + ["--resume", run, "--max-steps", "3"])
    assert state.step == 3
    cli.main(["--satclip", "n"] + argv[:2] + ["--logdir", str(tmp_path / "plain"),
                                               "--max-steps", "0"])
    assert asked[-1] == "configs/config_px2px.yaml"


def test_cli_trains_the_concat_route(tmp_path):
    state = cli.main(["--config", _small_satclip_file(tmp_path, "concat"),
                      "--device", "cpu", "--max-steps", "2",
                      "--logdir", str(tmp_path / "run")])
    assert state.step == 2
