"""SatCLIP pretraining on the port against the JAX package, on the CPU at
small sizes: the same numpy inputs and parameters from a seed on both
sides (the JAX package's parameter tree, its shapes from ``eval_shape``,
carried across by ``satclip_params_from_jax``).  The positional encodings
(float64, 1e-12), every vision tower's forward in training and in eval mode
(1e-5 of each output's largest entry), every location network, the loss,
one step's gradients (1e-4 of each tensor's own largest entry, before the
optimizer), the optimizer alone on identical gradients (1e-6) with the
decay set, the frozen set and K = 2 accumulation held to
``optax.MultiSteps``, the batch-norm statistics after a step,
``load_tower_weights`` with a skipped head and a resampled ``pos_embed``,
and the pretrain CLI with its checkpoint read back by ``SatClipWrapper``
and a ``Px2PxTask``.  Dropout draws one shared numpy mask on both sides.
The JAX functions run jitted (eager flax compiles each operation anew).

The CLIP ResNet runs at 32^2: at 16^2 its last stage pools a 1x1 map to
0x0, and both packages give NaN."""

import copy
import functools
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from nirgan_tpu.models.satclip import positional_encoding as jax_pe
from nirgan_tpu.models.satclip.model import SatCLIP as JaxSatCLIP
from nirgan_tpu.models.satclip.model import satclip_loss as jax_satclip_loss
from nirgan_tpu.tasks.satclip_pretrain import SatClipPretrainTask as JaxPretrainTask
from nirgan_tpu.tasks.satclip_pretrain import SatClipTrainState as JaxTrainState
from nirgan_tpu.tasks.satclip_pretrain import _decay_mask, _frozen_tower_mask
from nirgan_tpu.train.torch_convert import convert_timm_resnet, convert_timm_vit
from nirgan_tpu_torch import pretrain_satclip
from nirgan_tpu_torch.config import ConfigNode
from nirgan_tpu_torch.models import layers
from nirgan_tpu_torch.models.satclip import SatClipWrapper
from nirgan_tpu_torch.models.satclip import positional_encoding as pe
from nirgan_tpu_torch.models.satclip.model import SatCLIP, satclip_loss
from nirgan_tpu_torch.models.satclip.timm_towers import resample_pos_embed, triangle_matrix
from nirgan_tpu_torch.tasks import Px2PxTask
from nirgan_tpu_torch.tasks.satclip_pretrain import SatClipPretrainTask, decay_mask
from nirgan_tpu_torch.weights import satclip_params_from_jax
from tests.test_torch_satclip import _config

# (vision_layers, width, patch, side, bands) of each tower at test size
TOWERS = {
    "clip_resnet": ((1, 1, 1, 1), 8, 16, 32, 4),
    "clip_vit": (2, 32, 16, 32, 4),
    "clip_vit_2heads": (2, 128, 16, 32, 4),
    "moco_resnet18": ("moco_resnet18", 64, 16, 32, 13),
    "moco_resnet50": ("moco_resnet50", 64, 16, 32, 13),
    "moco_vit16": ("moco_vit16", 64, 16, 32, 13),
}
EMBED, CAPACITY, POLYS, BATCH = 16, 32, 3, 4
LOC_DIM = POLYS * POLYS
N_MASKS = {"siren": 2, "mlp": 0, "fcnet": 4}  # dropout layers a forward


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The suite runs six workers on the CPU at once; torch's intra-op pool
    on every core in each of them makes these small ops wait on one another
    (tests/test_torch_scene.py measured it), so one thread here."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _coords(n, seed=0):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(-180, 180, n), rng.uniform(-90, 90, n)], axis=1)


def _inputs(tower, seed=1):
    side, bands = TOWERS[tower][3], TOWERS[tower][4]
    rng = np.random.default_rng(seed)
    img = rng.standard_normal((BATCH, side, side, bands)).astype(np.float32)
    feats = rng.standard_normal((BATCH, LOC_DIM)).astype(np.float32)
    return img, feats


def _jax_model(tower, pe_type="siren"):
    vl, width, patch, side, bands = TOWERS[tower]
    return JaxSatCLIP(embed_dim=EMBED, vision_layers=vl, vision_width=width,
                      vision_patch_size=patch, image_resolution=side,
                      in_channels=bands, pe_type=pe_type, capacity=CAPACITY)


def _draw(path, shape, rng):
    """A value for one leaf of the JAX variables, by its name."""
    name = path[-1].key
    if name == "kernel":
        return rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
    if name in ("scale", "var"):
        return rng.uniform(0.5, 1.5, shape)
    if name == "mean":
        return rng.uniform(-0.2, 0.2, shape)
    if name == "logit_scale":
        return np.full(shape, np.log(1 / 0.07))
    return 0.1 * rng.standard_normal(shape)  # biases, embeddings, proj


@functools.lru_cache(maxsize=None)
def _variables(tower, pe_type="siren", seed=0):
    """The JAX model's variables (params and batch statistics) drawn with
    numpy from ``seed`` in the shapes its ``init`` gives."""
    img, feats = _inputs(tower)
    shapes = jax.eval_shape(lambda: _jax_model(tower, pe_type).init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)},
        jnp.asarray(img), jnp.asarray(feats), train=True))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, s: _draw(path, s.shape, rng).astype(np.float32), dict(shapes))


@functools.lru_cache(maxsize=None)
def _carried(tower, pe_type):
    vl, width, patch, side, bands = TOWERS[tower]
    v = _variables(tower, pe_type)
    port = SatCLIP(EMBED, vl, width, patch, side, bands, pe_type, CAPACITY, 2, LOC_DIM,
                   device="cpu")
    port.load_state_dict(satclip_params_from_jax(v["params"], v.get("batch_stats")),
                         strict=True)
    return port


def _port(tower, pe_type="siren"):
    """The port's model carrying ``_variables``' values (a fresh copy)."""
    return copy.deepcopy(_carried(tower, pe_type))


def _port_task(tower, pe_type="siren", k=1, lr=1e-4):
    vl, width, patch, side, _ = TOWERS[tower]
    task = SatClipPretrainTask(EMBED, vision_layers=vl, vision_width=width,
                               vision_patch_size=patch, image_resolution=side,
                               pe_type=pe_type, capacity=CAPACITY,
                               legendre_polys=POLYS, learning_rate=lr,
                               accumulate_grad_batches=k, device="cpu")
    task.model.load_state_dict(_port(tower, pe_type).state_dict())
    return task


def _stats_of(params, batch_stats) -> dict:
    """The running statistics of a JAX ``batch_stats`` tree under the
    port's names, as numpy."""
    mapped = satclip_params_from_jax(params, jax.tree.map(np.asarray, batch_stats))
    return {k: t.numpy() for k, t in mapped.items()
            if k.endswith(("running_mean", "running_var"))}


def _close(got, ref, tol, what=""):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    assert np.isfinite(got).all(), what
    err = float(np.abs(got - ref).max())
    scale = float(np.abs(ref).max())
    assert err <= tol * scale, (what, err, scale)


def _masks(shapes, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.random(s) < 0.5 for s in shapes]


def _shared_masks(monkeypatch, masks):
    """Both stacks draw the given keep-masks in call order: JAX through
    ``jax.random.bernoulli`` (flax's dropout; under ``jit`` it draws while
    tracing), the port through ``layers.keep_mask``."""
    jq, pq = list(masks), list(masks)

    def jax_draw(key, p=0.5, shape=None):
        m = jq.pop(0)
        assert tuple(shape) == m.shape and p == 0.5
        return jnp.asarray(m)

    def port_draw(shape, keep_prob, generator, device):
        m = pq.pop(0)
        assert tuple(shape) == m.shape and keep_prob == 0.5 and generator is not None
        return torch.from_numpy(m).to(device)

    monkeypatch.setattr(jax.random, "bernoulli", jax_draw)
    monkeypatch.setattr(layers, "keep_mask", port_draw)
    return jq, pq


def _ulp_floors(fn, x, rounds=3, seed=0):
    """``fn(x)`` (a dict of arrays from a JAX function) and how far each
    array moves when each entry of ``x`` moves by one f32 ulp: the f32
    noise floor of the JAX function at ``x``."""
    ref = fn(x)
    rng = np.random.default_rng(seed)
    floors = dict.fromkeys(ref, 0.0)
    for _ in range(rounds):
        moved = fn((x * (1 + rng.choice([-1.0, 1.0], x.shape) * 2.0 ** -23))
                   .astype(np.float32))
        for k in ref:
            floors[k] = max(floors[k], float(np.abs(moved[k] - ref[k]).max()))
    return ref, floors


def _floored(tol, floor, ref):
    """``tol``, or 4x the JAX function's one-ulp floor where that is larger
    (relative to the array's largest entry)."""
    return max(tol, 4 * floor / float(np.abs(ref).max()))


# ----------------------------------------------------- positional encodings
_ENCODINGS = [("direct", {}), ("cartesian3d", {}), ("wrap", {}), ("theory", {}),
              ("grid", {}), ("spherec", {}), ("spherecplus", {}), ("spherem", {}),
              ("spheremplus", {}),
              ("sphericalharmonics", {"harmonics_calculation": "analytic"}),
              ("sphericalharmonics", {"harmonics_calculation": "closed-form"}),
              ("sphericalharmonics", {"harmonics_calculation": "discretized",
                                      "legendre_polys": 4})]


@pytest.mark.parametrize("name,kw", _ENCODINGS)
def test_positional_encodings_match_jax(name, kw):
    c = _coords(33, seed=3)
    ours = pe.get_positional_encoding(name, **kw)
    theirs = jax_pe.get_positional_encoding(name, **kw)
    assert type(ours).__name__ == type(theirs).__name__
    assert ours.embedding_dim == theirs.embedding_dim
    got, ref = np.asarray(ours(c)), np.asarray(theirs(c))
    assert got.dtype == np.float64 and got.shape == (33, ours.embedding_dim)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)


def test_weighted_spherical_harmonics_matches_jax():
    """The trainable encoding, its wrap-around ``weight[-l, m]`` rows
    included, on the JAX module's weights (f32, closed form)."""
    jm = jax_pe.WeightedSphericalHarmonics(legendre_polys=4, embedding_dim=6)
    c = _coords(8, seed=4).astype(np.float32)
    v = jm.init(jax.random.key(0), jnp.asarray(c))
    ref = np.asarray(jm.apply(v, jnp.asarray(c)))
    ours = pe.WeightedSphericalHarmonics(4, 6, device="cpu")
    with torch.no_grad():
        ours.weight.copy_(torch.from_numpy(np.array(v["params"]["weight"])))
    _close(ours(torch.from_numpy(c)).detach().numpy(), ref, 1e-5)


# ------------------------------------------------------------ vision towers
@functools.lru_cache(maxsize=None)
def _jax_tower(tower):
    """x -> {"eval": the output in eval mode, "train": in training mode,
    and the running statistics that leaves under the port's names}, from
    one jitted JAX function."""
    jm, v = _jax_model(tower), _variables(tower)
    encode = lambda m, x, t: m.encode_image(x, t)

    @jax.jit
    def fn(x):
        out = {"eval": jm.apply(v, x, False, method=encode)}
        if "batch_stats" in v:
            out["train"], mutated = jm.apply(v, x, True, method=encode,
                                             mutable=["batch_stats"])
            out["stats"] = mutated["batch_stats"]
        else:
            out["train"] = jm.apply(v, x, True, method=encode)
        return out

    def run(x):
        out = jax.tree.map(np.asarray, fn(jnp.asarray(x)))
        stats = _stats_of(v["params"], out.pop("stats")) if "stats" in out else {}
        return {**out, **stats}

    return run


@pytest.mark.parametrize("tower", sorted(TOWERS))
@pytest.mark.parametrize("train", [False, True])
def test_tower_forward_matches_jax(tower, train):
    """The tower's output and, in training mode, the running statistics it
    leaves: 1e-5 of each array's largest entry.  In training mode a
    ResNet's batch norms normalise by the batch's own statistics, over 4
    values a channel in the last stage at 32^2, where E[x^2] - E[x]^2
    (flax's rule, kept by the port) cancels: the JAX forward itself then
    moves by up to 0.3% of its largest entry when its input moves by one
    ulp (ResNet-50 at random init, measured).  There each array is held to
    4x that floor of the JAX function, measured on JAX alone; eval mode
    holds every tower to 1e-5."""
    port = _port(tower)
    img, _ = _inputs(tower, seed=2)
    ref, floors = _ulp_floors(_jax_tower(tower), img)
    port.train(train)
    with torch.no_grad():
        out = port.encode_image(torch.from_numpy(img)).numpy()
    mode = "train" if train else "eval"
    _close(out, ref[mode], _floored(1e-5, floors[mode], ref[mode]) if train else 1e-5,
           f"{tower} {mode}")
    stats = [k for k in ref if k.startswith("visual.")]
    assert bool(stats) == ("resnet" in tower)
    sd = port.state_dict()
    carried = _stats_of(_variables(tower)["params"], _variables(tower).get("batch_stats"))
    for k in stats:  # training moves them alike; eval mode leaves them
        if train:
            _close(sd[k].numpy(), ref[k], _floored(1e-5, floors[k], ref[k]), k)
        else:
            np.testing.assert_array_equal(sd[k].numpy(), carried[k], err_msg=k)


# -------------------------------------------------------- location networks
@pytest.mark.parametrize("pe_type", ["siren", "mlp", "fcnet"])
def test_location_network_matches_jax(monkeypatch, pe_type):
    """Eval mode, then training mode under shared dropout masks (siren
    after each hidden layer, fcnet in each residual layer)."""
    jm, v = _jax_model("clip_vit", pe_type), _variables("clip_vit", pe_type)
    port = _port("clip_vit", pe_type)
    _, feats = _inputs("clip_vit", seed=3)
    enc = lambda m, f, t: m.encode_location(f, t)
    ref = jm.apply(v, jnp.asarray(feats), False, method=enc)
    port.eval()
    with torch.no_grad():
        _close(port.encode_location(torch.from_numpy(feats)).numpy(), ref, 1e-5)
    jq, pq = _shared_masks(monkeypatch, _masks([(BATCH, CAPACITY)] * N_MASKS[pe_type]))
    ref = jm.apply(v, jnp.asarray(feats), True, method=enc,
                   rngs={"dropout": jax.random.key(3)})
    port.train()
    layers.set_dropout_generator(port, torch.Generator())
    with torch.no_grad():
        got = port.encode_location(torch.from_numpy(feats)).numpy()
    assert not jq and not pq
    _close(got, ref, 1e-5)


def test_linear_location_network_weights_carry_across():
    """``linear`` (one dense layer): the JAX package cannot apply it
    (``nn.Dense`` is handed the train flag), so its params are made by
    hand and the port is held to x W + b."""
    rng = np.random.default_rng(0)
    v = _variables("clip_vit")
    nnet = {"kernel": rng.standard_normal((LOC_DIM, EMBED)).astype(np.float32),
            "bias": rng.standard_normal(EMBED).astype(np.float32)}
    port = SatCLIP(EMBED, 2, 32, 16, 32, 4, "linear", CAPACITY, 2, LOC_DIM, device="cpu")
    port.load_state_dict(satclip_params_from_jax({**v["params"], "nnet": nnet}),
                         strict=True)
    x = rng.standard_normal((3, LOC_DIM)).astype(np.float32)
    with torch.no_grad():
        got = port.encode_location(torch.from_numpy(x)).numpy()
    _close(got, x @ nnet["kernel"] + nnet["bias"], 1e-6)


# --------------------------------------------------------------- the loss
def test_loss_matches_jax():
    rng = np.random.default_rng(0)
    lpi = (5 * rng.standard_normal((7, 7))).astype(np.float32)
    ref = float(jax_satclip_loss(jnp.asarray(lpi), jnp.asarray(lpi.T)))
    t = torch.from_numpy(lpi)
    assert abs(float(satclip_loss(t, t.t())) - ref) <= 1e-5 * abs(ref)


def test_model_logits_match_jax():
    jm, v = _jax_model("clip_resnet"), _variables("clip_resnet")
    port = _port("clip_resnet")
    img, feats = _inputs("clip_resnet", seed=4)
    ref = jax.jit(lambda x, f: jm.apply(v, x, f, train=False))(
        jnp.asarray(img), jnp.asarray(feats))
    port.eval()
    with torch.no_grad():
        got = port(torch.from_numpy(img), torch.from_numpy(feats))
    for g, r in zip(got, ref):
        _close(g.numpy(), r, 1e-5)
    fresh = SatCLIP(EMBED, 2, 32, 16, 32, 4, "siren", CAPACITY, 2, LOC_DIM, device="cpu")
    assert float(fresh.logit_scale.detach()) == pytest.approx(np.log(1 / 0.07), abs=1e-6)


# --------------------------------------------------------------- the step
@pytest.mark.parametrize("tower,pe_type", [("clip_resnet", "siren"),
                                           ("clip_vit_2heads", "mlp"),
                                           ("moco_resnet18", "fcnet")])
def test_step_gradients_and_statistics_match_jax(monkeypatch, tower, pe_type):
    """One training forward and backward of ``train_step`` under shared
    dropout masks: the loss, every gradient the port computes (1e-4 of its
    own largest entry; a frozen tower's parameters get none) and the
    running statistics after it (1e-5), each or 4x the JAX function's own
    one-ulp floor, as in the forward test.  ``attnpool.k_proj.bias`` shifts
    every logit of the query alike, which the softmax cancels: its
    gradient is zero in exact arithmetic and is held below 1e-5 of the
    network's largest gradient on both sides."""
    jm, v = _jax_model(tower, pe_type), _variables(tower, pe_type)
    img, _ = _inputs(tower, seed=5)
    feats = np.asarray(jax_pe.SphericalHarmonics(POLYS)(_coords(BATCH, seed=6)),
                       np.float32)
    jq, pq = _shared_masks(monkeypatch, _masks([(BATCH, CAPACITY)] * N_MASKS[pe_type]))

    @jax.jit
    def step(params, x, f):
        def loss_fn(p):
            out, mutated = jm.apply({**v, "params": p}, x, f, train=True,
                                    mutable=["batch_stats"],
                                    rngs={"dropout": jax.random.key(9)})
            return jax_satclip_loss(*out), mutated.get("batch_stats", {})

        return jax.value_and_grad(loss_fn, has_aux=True)(params)

    def run(x):
        (loss, stats), grads = step(v["params"], jnp.asarray(x), jnp.asarray(feats))
        out = {"loss": np.asarray(loss)}
        out.update({k: t.numpy() for k, t in satclip_params_from_jax(
            jax.tree.map(np.asarray, grads)).items()})
        if stats:
            out.update(_stats_of(v["params"], stats))
        return out

    ref, floors = _ulp_floors(run, img)
    assert not jq  # traced once: one mask a dropout layer
    task = _port_task(tower, pe_type, k=2)  # K = 2 keeps the gradients
    state = task.init_state()
    batch = {"image": torch.from_numpy(img), "loc_features": torch.from_numpy(feats)}
    loss = task.train_step(state, batch)["train_loss"]
    assert state.accumulated == 1 and not pq
    _close(loss.numpy(), ref["loss"], _floored(1e-5, floors["loss"], ref["loss"]), "loss")
    got = {k: p.grad for k, p in task.model.named_parameters() if p.grad is not None}
    assert set(got) == {k for k, p in task.model.named_parameters() if p.requires_grad}
    assert set(got) <= set(ref)
    net_max = max(float(np.abs(ref[k]).max()) for k in got)
    for k, g in got.items():
        if k.endswith("k_proj.bias"):
            assert float(np.abs(ref[k]).max()) <= 1e-5 * net_max, k
            assert float(g.abs().max()) <= 1e-5 * net_max, k
            continue
        _close(g.numpy(), ref[k], _floored(1e-4, floors[k], ref[k]), k)
    own = task.model.state_dict()
    moved = [k for k in ref if k.endswith(("running_mean", "running_var"))]
    assert bool(moved) == ("resnet" in tower)
    for k in moved:
        _close(own[k].numpy(), ref[k], _floored(1e-5, floors[k], ref[k]), k)


def _jax_task(tower, pe_type, k):
    """The JAX task at the test's size; its optax chain (``_tx``) is built
    by tracing ``init_state``."""
    vl, width, patch, side, _ = TOWERS[tower]
    jt = JaxPretrainTask(embed_dim=EMBED, vision_layers=vl, vision_width=width,
                         vision_patch_size=patch, image_resolution=side,
                         pe_type=pe_type, capacity=CAPACITY, legendre_polys=POLYS,
                         learning_rate=1e-3, accumulate_grad_batches=k)
    jax.eval_shape(lambda: jt.init_state(seed=0, batch=BATCH))
    return jt


def _flags(tree, params):
    """A tree of booleans as arrays of the parameters' shapes (1.0 / 0.0),
    so the weight map carries it across."""
    return jax.tree.map(lambda flag, p: np.full(np.shape(p), float(flag), np.float32),
                        tree, params)


@pytest.mark.parametrize("tower,pe_type", [("clip_resnet", "siren"),
                                           ("clip_vit_2heads", "mlp"),
                                           ("moco_resnet18", "fcnet"),
                                           ("moco_resnet50", "siren"),
                                           ("moco_vit16", "mlp")])
def test_decay_and_frozen_sets_match_jax(tower, pe_type):
    """The port's names pick the parameters that the flax names pick: the
    weight-decay set (``_decay_mask``) and, for a moco tower, the frozen
    set (``_frozen_tower_mask``, everything of the tower but its head);
    the optimizer's decay group holds exactly the trainable decayed ones."""
    params = _variables(tower, pe_type)["params"]
    mapped = satclip_params_from_jax(_flags(_decay_mask(params), params))
    task = _port_task(tower, pe_type)
    ours = decay_mask(task.model)
    assert set(ours) == set(mapped)
    for k, flag in ours.items():
        assert bool(mapped[k].all()) == flag and bool(mapped[k].any()) == flag, k
    head = {"moco_resnet18": "fc", "moco_resnet50": "fc", "moco_vit16": "head"}.get(tower)
    assert task.pretrained_head == head
    frozen = (satclip_params_from_jax(_flags(_frozen_tower_mask(head)(params), params))
              if head else {})
    for k, p in task.model.named_parameters():
        assert p.requires_grad == (not bool(frozen[k].any()) if head else True), k
    opt = task.init_state().opt
    trainable = {k: p for k, p in task.model.named_parameters() if p.requires_grad}
    assert {id(p) for p in opt.param_groups[0]["params"]} == {
        id(p) for k, p in trainable.items() if ours[k]}
    assert {id(p) for p in opt.param_groups[1]["params"]} == {
        id(p) for k, p in trainable.items() if not ours[k]}
    assert opt.param_groups[0]["weight_decay"] == 0.01
    assert opt.param_groups[1]["weight_decay"] == 0.0


@pytest.mark.parametrize("tower,pe_type,k", [("clip_resnet", "siren", 1),
                                             ("clip_resnet", "siren", 2),
                                             ("moco_resnet18", "fcnet", 2)])
def test_optimizer_on_identical_gradients_matches_optax(tower, pe_type, k):
    """AdamW with the decay set, the frozen set and K-step accumulation:
    the JAX task's optax chain and the port's optimizer, fed the same
    gradients for 2K micro-batches (two updates, lr 1e-3), leave the same
    parameters (1e-6); a frozen tower does not move at all."""
    jt = _jax_task(tower, pe_type, k)
    params = _variables(tower, pe_type)["params"]
    pt = _port_task(tower, pe_type, k, lr=1e-3)
    ps = pt.init_state()
    start = {n: p.detach().clone() for n, p in pt.model.named_parameters()}
    update = jax.jit(jt._tx.update)
    jparams, opt = params, jt._tx.init(params)
    rng = np.random.default_rng(11)
    for _ in range(2 * k):
        g = jax.tree.map(lambda p: rng.standard_normal(np.shape(p)).astype(np.float32),
                         params)
        upd, opt = update(g, opt, jparams)
        jparams = optax.apply_updates(jparams, upd)
        mapped = satclip_params_from_jax(g)
        for n, p in pt.model.named_parameters():
            if p.requires_grad:  # backward adds into .grad
                p.grad = mapped[n].clone() if p.grad is None else p.grad + mapped[n]
        pt.step_optimizer(ps)
    assert ps.accumulated == 0
    assert all(int(s["step"]) == 2 for s in ps.opt.state.values())  # updates
    want = satclip_params_from_jax(jax.tree.map(np.asarray, jparams))
    for n, p in pt.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(), rtol=0,
                                   atol=1e-6, err_msg=n)
        assert torch.equal(p.detach(), start[n]) == (not p.requires_grad), n


def test_accumulation_updates_on_the_kth_micro_batch_and_moves_statistics():
    rng = np.random.default_rng(0)
    task = _port_task("clip_resnet", k=2)
    state = task.init_state()
    batch = task.extract_batch({"image": rng.random((BATCH, 4, 32, 32), np.float32),
                                "point": _coords(BATCH, seed=1)})
    assert batch["image"].shape == (BATCH, 32, 32, 4)
    assert batch["loc_features"].dtype == torch.float32
    w0 = task.model.visual.conv1.weight.detach().clone()
    rm0 = task.model.visual.bn1.running_mean.clone()
    task.train_step(state, batch)
    assert torch.equal(task.model.visual.conv1.weight, w0)        # accumulating
    rm1 = task.model.visual.bn1.running_mean.clone()
    assert not torch.equal(rm1, rm0)                              # statistics move
    task.train_step(state, batch)
    assert not torch.equal(task.model.visual.conv1.weight, w0)    # the K-th updates
    assert not torch.equal(task.model.visual.bn1.running_mean, rm1)
    assert state.step == 2 and state.accumulated == 0
    assert np.isfinite(float(task.eval_step(batch)["val_loss"]))
    assert task.model.training


# ------------------------------------------------------- load_tower_weights
@pytest.mark.parametrize("n_in,n_out", [(14, 2), (14, 16), (2, 4), (7, 3), (3, 7),
                                        (5, 5)])
def test_pos_embed_resample_matches_jax_image_resize(n_in, n_out):
    """``jax.image.resize(..., "bilinear")`` antialiases when it shrinks
    (a widened triangle) and interpolates when it grows."""
    rng = np.random.default_rng(n_in * 31 + n_out)
    pe_in = rng.standard_normal((1, 1 + n_in * n_in, 6)).astype(np.float32)
    grid = pe_in[:, 1:].reshape(1, n_in, n_in, 6)
    ref = np.asarray(jax.image.resize(grid, (1, n_out, n_out, 6), method="bilinear"))
    got = resample_pos_embed(pe_in, n_out * n_out)
    np.testing.assert_array_equal(got[:, :1], pe_in[:, :1])
    np.testing.assert_allclose(got[:, 1:].reshape(ref.shape), ref, rtol=0, atol=1e-6)
    np.testing.assert_allclose(triangle_matrix(n_in, n_out).sum(axis=1), 1.0)


def _timm_of(sd) -> dict:
    return {k[len("visual."):]: v.numpy() for k, v in sd.items()
            if k.startswith("visual.")}


@pytest.mark.parametrize("tower,side", [("moco_resnet18", 32), ("moco_vit16", 32),
                                        ("moco_vit16", 64)])
def test_load_tower_weights_matches_jax(tmp_path, tower, side):
    """A synthetic timm state_dict (the port tower's own names, from
    another seed) with a head of another width (skipped: the fresh head
    stays) and, for the ViT, a 14 x 14 ``pos_embed`` (shrunk to 2 x 2 at
    32^2) or a 2 x 2 one (grown to 4 x 4 at 64^2): the JAX task's
    ``load_tower_weights`` and the port's leave the same tower."""
    donor = SatClipPretrainTask(EMBED, vision_layers=tower, image_resolution=32,
                                capacity=CAPACITY, legendre_polys=POLYS, device="cpu",
                                seed=5)
    sd = {k: v.clone() for k, v in donor.model.visual.state_dict().items()
          if not k.endswith("num_batches_tracked")}
    head = "fc" if "resnet" in tower else "head"
    sd[f"{head}.weight"] = torch.randn(1000, sd[f"{head}.weight"].shape[1])
    sd[f"{head}.bias"] = torch.randn(1000)
    if "vit" in tower:
        grid = 14 if side == 32 else 2
        sd["pos_embed"] = torch.randn(1, 1 + grid * grid, sd["pos_embed"].shape[-1])
    path = str(tmp_path / "ssl4eo.pth")
    torch.save(sd, path)

    task = SatClipPretrainTask(EMBED, vision_layers=tower, image_resolution=side,
                               capacity=CAPACITY, legendre_polys=POLYS, device="cpu")
    fresh = {k: v.clone() for k, v in task.model.state_dict().items()}
    loaded = task.load_tower_weights(path)
    own = task.model.state_dict()
    assert f"{head}.weight" not in loaded and f"{head}.bias" not in loaded
    assert len(loaded) == len(sd) - 2
    assert torch.equal(own[f"visual.{head}.weight"], fresh[f"visual.{head}.weight"])

    # the JAX task starts from the port's fresh tower, so what its load
    # leaves untouched must match too
    jt = JaxPretrainTask(embed_dim=EMBED, vision_layers=tower, image_resolution=side,
                         capacity=CAPACITY, legendre_polys=POLYS)
    if head == "fc":
        params, stats = convert_timm_resnet(
            _timm_of(fresh), layers=(2, 2, 2, 2) if "18" in tower else (3, 4, 6, 3))
        stats = {"visual": stats}
    else:
        params, stats = convert_timm_vit(_timm_of(fresh)), {}
    js = jt.load_tower_weights(JaxTrainState(step=0, params={"visual": params},
                                             batch_stats=stats, opt=None, rng=None),
                               path)
    tree = {"visual": jax.tree.map(np.asarray, js.params["visual"]),
            "nnet": {"kernel": np.zeros((1, 1)), "bias": np.zeros(1)},
            "logit_scale": np.zeros(())}
    want = satclip_params_from_jax(tree, jax.tree.map(np.asarray, js.batch_stats)
                                   if js.batch_stats else None)
    keys = [k for k in own if k.startswith("visual.")
            and not k.endswith("num_batches_tracked")]
    for k in keys:
        tol = 1e-6 if k == "visual.pos_embed" else 0
        np.testing.assert_allclose(own[k].numpy(), want[k].numpy(), rtol=0, atol=tol,
                                   err_msg=k)


def test_load_tower_weights_refuses_a_clip_tower():
    with pytest.raises(ValueError, match="moco"):
        _port_task("clip_resnet").load_tower_weights("ssl4eo.pth")


# ---------------------------------------------------------- the pretrain CLI
def test_pretrain_cli_checkpoint_feeds_the_inject_gan(tmp_path):
    """``python -m nirgan_tpu_torch.pretrain_satclip`` on the CPU: its
    ``satclip.ckpt`` (Lightning layout, ``model.`` prefix,
    ``hyper_parameters``, the JSON sidecar) loads through
    ``SatClipWrapper(<run dir>)``, whose embeddings equal the pretrain
    task's ``location_encoder``'s, and through ``satclip_path`` into a
    small inject ``Px2PxTask`` that trains a step and serves."""
    out = str(tmp_path / "pre")
    argv = ["--fake-geo", "--steps", "3", "--batch-size", "4", "--image-size", "32",
            "--resnet-layers", "1", "1", "1", "1", "--vision-width", "8",
            "--device", "cpu", "--out", out, "--val-every", "2", "--prefetch-depth", "1"]
    path = pretrain_satclip.main(argv)
    assert path == os.path.join(out, "satclip.ckpt")
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    assert ckpt["hyper_parameters"] == {
        "le_type": "sphericalharmonics", "pe_type": "siren", "legendre_polys": 10,
        "harmonics_calculation": "analytic", "embed_dim": 256}
    with open(os.path.join(out, "satclip_hparams.json")) as f:
        assert json.load(f) == ckpt["hyper_parameters"]
    assert "model.location.nnet.layers.0.weight" in ckpt["state_dict"]
    assert "model.visual.attnpool.c_proj.weight" in ckpt["state_dict"]
    rows = [json.loads(line) for line in open(os.path.join(out, "metrics.jsonl"))]
    assert any("val_loss" in r for r in rows) and any("train_loss" in r for r in rows)

    task = SatClipPretrainTask(vision_layers=(1, 1, 1, 1), vision_width=8,
                               image_resolution=32, device="cpu")
    task.model.load_state_dict({k[len("model."):]: v
                                for k, v in ckpt["state_dict"].items()})
    wrapper = SatClipWrapper(out)
    assert wrapper.loaded_from == out and wrapper.embed_dim == 256
    c = _coords(6, seed=8)
    _close(wrapper.predict(c), task.location_encoder()(c), 1e-5)

    cfg = _config("inject").to_dict()
    cfg["satclip"]["satclip_path"] = out
    gan = Px2PxTask(ConfigNode(cfg), device="cpu")
    assert gan.satclip_model.loaded_from == out
    rng = np.random.default_rng(0)
    batch = {"rgb": rng.random((2, 3, 32, 32), dtype=np.float32),
             "nir": rng.random((2, 1, 32, 32), dtype=np.float32),
             "coords": c[:2].astype(np.float32)}
    m = gan.train_step(gan.init_state(), gan.extract_batch(batch))
    assert np.isfinite(float(m["model_loss/generator_total_loss"]))
    pred = gan.predict_step(batch["rgb"], c[:2])
    assert pred.shape == (2, 1, 32, 32) and np.isfinite(pred).all()


@pytest.mark.parametrize("hp,match", [({"le_type": "wrap"}, "wrap"),
                                      ({"pe_type": "mlp"}, "mlp")])
def test_wrapper_refuses_a_run_of_another_family(tmp_path, hp, match):
    task = _port_task("clip_resnet")
    task.hparams.update(hp)
    task.save(str(tmp_path))
    with pytest.raises(NotImplementedError, match=match):
        SatClipWrapper(str(tmp_path))


def test_pretrain_cli_cuda_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pretrain_satclip.main(["--fake", "--steps", "1", "--out", str(tmp_path)])
    assert pretrain_satclip.parse_args([]).device == "cuda"
