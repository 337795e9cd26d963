"""``tpu.param_dtype`` in the port against the JAX package, on the CPU at a
small size: the networks' parameters in bf16 or f16, ``OptaxAdam`` against
optax on bf16 parameters, one fused ``config_px2px.yaml`` step with bf16
parameters against the JAX step, and the checkpoint, resume and export of
a bf16 run."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nirgan_tpu.losses import gan_loss as jax_gan_loss
from nirgan_tpu.losses import l1_loss as jax_l1_loss
from nirgan_tpu.tasks import Px2PxTask as JaxPx2PxTask
from nirgan_tpu_torch.config import load_config
from nirgan_tpu.train.state import adam_for as jax_adam_for
from nirgan_tpu_torch.tasks import Px2PxTask
from nirgan_tpu_torch.train import cli
from nirgan_tpu_torch.train.state import OptaxAdam, adam_for, param_dtype_of
from nirgan_tpu_torch.weights import d_params_from_jax, params_from_jax
from tests.test_torch_train import (
    _ahead_of_a_norm,
    _batch,
    _config,
    _tiny_config_file,
    SIZE,
)


def _ulp(v: np.ndarray, bits: int = 8) -> np.ndarray:
    """The spacing of bf16 (8 significant bits) values at |v|."""
    _, e = np.frexp(np.abs(v.astype(np.float64)))
    return np.ldexp(1.0, e - bits).clip(min=2.0 ** -133)


def _within_ulp(got, ref, what, n=1.0):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    err = np.abs(got - ref) / _ulp(ref)
    assert err.max() <= n, (what, float(err.max()))


@pytest.mark.parametrize("name,dtype", [("float32", torch.float32),
                                        ("bfloat16", torch.bfloat16),
                                        ("float16", torch.float16)])
def test_param_dtype_takes_what_jax_takes(name, dtype):
    cfg = _config(32)
    cfg.tpu.param_dtype = name
    assert param_dtype_of(cfg.tpu) == dtype
    task = Px2PxTask(cfg, device="cpu", seed=0)
    for net in (task.netG, task.netD):
        assert {p.dtype for p in net.parameters()} == {dtype}
    opt = task.init_state().opt_g
    assert isinstance(opt, torch.optim.Adam if dtype == torch.float32 else OptaxAdam)
    cfg.tpu.param_dtype = "float64"
    with pytest.raises(ValueError, match="param_dtype"):
        Px2PxTask(cfg, device="cpu")


def test_batch_norm_statistics_stay_f32():
    """flax keeps a batch norm's running statistics in f32 whatever the
    parameters' dtype: only the parameters are cast."""
    cfg = _config(32)
    cfg.base_configs.norm = "batch"
    cfg.tpu.param_dtype = "bfloat16"
    task = Px2PxTask(cfg, device="cpu", seed=0)
    assert task.netD.norm1.weight.dtype == torch.bfloat16
    assert task.netD.norm1.running_mean.dtype == torch.float32


BITS = {torch.bfloat16: 8, torch.float16: 11, torch.float32: 24}


@pytest.mark.parametrize("dtype,jdtype", [(torch.bfloat16, jnp.bfloat16),
                                          (torch.float16, jnp.float16)],
                         ids=["bf16", "f16"])
def test_optax_adam_matches_optax_on_low_precision_params(dtype, jdtype):
    """``OptaxAdam`` against the JAX step's optimizer: ``scale_by_adam`` +
    ``scale(-1)``, then ``p + u * lr`` with the LR an f32 array, on the same
    gradients in the parameters' dtype over 5 steps, the LR cut after step
    3.  The parameters turn f32 at the first update and the moments at the
    second, on both sides; each moment within one step of its dtype of
    JAX's, each parameter within one step for each update taken (XLA on the
    CPU may fuse ``p + u * lr`` into one rounding where the port makes two,
    and keep more precision inside a fusion than one rounding an
    operation)."""
    rng = np.random.default_rng(0)
    shapes = {"a": (4, 3), "b": (5,)}
    p0 = {k: np.asarray(jnp.asarray(rng.standard_normal(s) * 0.05, jdtype), np.float32)
          for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s) * 10.0 ** -i for k, s in shapes.items()}
             for i in range(5)]
    module = torch.nn.ParameterDict(
        {k: torch.nn.Parameter(torch.from_numpy(v).to(dtype)) for k, v in p0.items()})
    opt = adam_for(module, 2e-4, 0.5)
    assert isinstance(opt, OptaxAdam)
    tx = jax_adam_for(None, 0.5)
    params = {k: jnp.asarray(v, jdtype) for k, v in p0.items()}
    state = tx.init(params)
    for i, g in enumerate(grads):
        lr = 2e-4 if i < 3 else 2e-5
        for group in opt.param_groups:
            group["lr"] = lr
        g = {k: jnp.asarray(v, params[k].dtype) for k, v in g.items()}
        for k, p in module.items():
            p.grad = torch.tensor(np.asarray(g[k], np.float32)).to(p.dtype)
        opt.step()
        upd, state = tx.update(g, state, params)
        params = jax.tree.map(lambda q, u: q + u * jnp.float32(lr), params, upd)
        adam = state[0]
        for k, p in module.items():
            st = opt.state[p]
            for what, got, ref in (("p", p, params[k]), ("exp_avg", st["exp_avg"], adam.mu[k]),
                                   ("exp_avg_sq", st["exp_avg_sq"], adam.nu[k])):
                assert str(got.dtype).split(".")[1] == str(ref.dtype), (i, k, what)
                got = got.detach().double().numpy()
                ref = np.asarray(ref, np.float64)
                err = np.abs(got - ref) / _ulp(ref, BITS[p.dtype if what == "p" else
                                                          st[what].dtype])
                assert err.max() <= (i + 1 if what == "p" else 1), (i, k, what,
                                                                     float(err.max()))
    assert {p.dtype for p in module.values()} == {torch.float32}


def _pair(cfg):
    """The JAX task's seeded state and the port's task on the same bf16
    parameters (handed over as f32 numpy, exact)."""
    jt = JaxPx2PxTask(cfg)
    state = jax.device_get(jax.jit(lambda: jt.init_state(seed=0, image_size=SIZE))())
    port = Px2PxTask(cfg, device="cpu", seed=0)
    to32 = jax.tree.map(lambda a: np.asarray(a, np.float32), (state.params_g, state.params_d))
    port.netG.load_state_dict(params_from_jax(to32[0]), strict=True)
    port.netD.load_state_dict(d_params_from_jax(to32[1]), strict=True)
    return jt, state, port


def params_dtype(tree) -> str:
    (dtype,) = {str(a.dtype) for a in jax.tree.leaves(tree)}
    return dtype


def test_bf16_param_step_matches_jax():
    """One fused ``config_px2px.yaml`` step (small width, f32 activations)
    with ``param_dtype: bfloat16``, port against the JAX step from the same
    bf16 parameters: the loss terms within rtol 1e-4 (the parameters are the
    same bf16 values; the sums run in other orders).  The JAX step's new
    parameter ``p + lr u`` is f32 (its LR is an f32 array), the port's too;
    the moments stay bf16 for this step.

    After the step each parameter lies within one bf16 step, and each Adam
    moment within one bf16 step and its gradient's f32 error (1e-3 of the
    tensor's largest for D, measured 2.4e-4; 1e-2 for G, measured 8e-3: its
    gradient runs through the updated D, whose near-zero gradients' weights
    lie 2 lr apart), of JAX's step or of that step's arithmetic
    (``OptaxAdam``, held to optax above) on JAX's own gradient taken in f32
    (G's through the D the step updated) and rounded once: the two stacks'
    f32 gradients differ by their sums' order, so a gradient near a bf16
    rounding boundary rounds to either neighbour.  The second moment is held
    as its square root, |g| sqrt(1 - b2), within 1.5 steps (g one step
    apart, and the two roundings of nu).  Gradients under 1e-3 of their
    tensor's largest (1e-2 in G; at most 5% of a tensor's elements) may take
    either sign, as may the f32 noise (zero in exact arithmetic) of the conv
    biases ahead of an instance norm: Adam's first step turns each into
    +-lr, so those parameters are held within 2 lr."""
    cfg = _config()
    cfg.tpu.param_dtype = "bfloat16"
    jt, state, port = _pair(cfg)
    assert params_dtype(state.params_g) == "bfloat16"
    batch = _batch(0)
    new, ref = jt.make_train_step()(jax.device_put(state), jt.extract_batch(batch))
    new, ref = jax.device_get((new, ref))
    # JAX's gradients in f32 from the same values: D's from the f32 step's
    # first moment, G's through the D that the bf16 step updated
    ex = jt.extract_batch(batch)
    cfg32 = _config()
    jt32 = JaxPx2PxTask(cfg32)
    state32 = jt32.init_state(seed=0, image_size=SIZE).replace(
        params_g=jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), state.params_g),
        params_d=jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), state.params_d))
    pg32 = jax.device_get(state32.params_g)
    # the step donates the state it is given
    new32, _ = jax.device_get(jt32.make_train_step()(state32, jt32.extract_batch(batch)))

    def g_loss(pg):
        pred = jt.g_apply(pg, ex["rgb"], train=True)
        logits = jt.d_apply(new.params_d, jnp.concatenate([ex["rgb"], pred], -1))
        return (jax_gan_loss(logits, True, "lsgan") * jt.lambda_gan
                + jax_l1_loss(pred, ex["nir"]) * jt.lambda_l1)

    grads32 = {"G": params_from_jax(jax.device_get(jax.jit(jax.grad(g_loss))(pg32))),
               "D": d_params_from_jax(jax.tree.map(
                   lambda a: 2 * np.asarray(a, np.float32), new32.opt_d[0].mu))}
    st = port.init_state()
    got = port.train_step(st, port.extract_batch(batch))
    for k, v in ref.items():
        if np.isfinite(v):
            np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-4, atol=1e-6,
                                       err_msg=k)
    lr = float(cfg.base_configs.lr)
    f32 = lambda tree: jax.tree.map(lambda a: np.asarray(a, np.float32), tree)  # noqa: E731
    for tag, net, opt, params, adam, params0 in (
            ("G", port.netG, st.opt_g, new.params_g, new.opt_g[0], state.params_g),
            ("D", port.netD, st.opt_d, new.params_d, new.opt_d[0], state.params_d)):
        conv = params_from_jax if tag == "G" else d_params_from_jax
        want = {"p": conv(f32(params)), "mu": conv(f32(adam.mu)), "nu": conv(f32(adam.nu))}
        # B: the step's arithmetic on JAX's f32 gradient rounded once
        g32, p0 = grads32[tag], conv(f32(params0))
        module = torch.nn.ParameterDict({k.replace(".", "_"): torch.nn.Parameter(
            p0[k].to(torch.bfloat16)) for k in p0})
        b_opt = OptaxAdam(module.parameters(), lr=lr, betas=(float(cfg.base_configs.beta1),
                                                             0.999))
        for k in p0:
            module[k.replace(".", "_")].grad = g32[k].to(torch.bfloat16)
        b_opt.step()
        for k, p in net.named_parameters():
            assert p.dtype == torch.float32 and params_dtype(params) == "float32", (tag, k)
            assert opt.state[p]["exp_avg"].dtype == torch.bfloat16, (tag, k)
            bp = module[k.replace(".", "_")]
            alt = {"p": bp, "mu": b_opt.state[bp]["exp_avg"], "nu": b_opt.state[bp]["exp_avg_sq"]}
            mine = {"p": p, "mu": opt.state[p]["exp_avg"], "nu": opt.state[p]["exp_avg_sq"]}
            if _ahead_of_a_norm(tag, k):
                assert np.abs(p.detach().numpy() - want["p"][k].numpy()).max() <= 2 * lr * 1.01
                continue
            # the f32 gradient's own error, relative to its tensor's largest:
            # 1e-3 for D, 1e-2 for G, whose
            # gradient runs through the updated D, in which the near-zero
            # gradients' weights lie 2 lr apart.  A gradient under 1e-3 of
            # the largest (1e-2 in G) may take either sign, and Adam's first
            # step moves it by +-lr
            rel = 1e-3 if tag == "D" else 1e-2
            g = g32[k].double().numpy()
            near0 = np.abs(g) < max(rel, 1e-3) * np.abs(g).max()
            assert near0.mean() <= 5e-2, (tag, k, float(near0.mean()))
            for what in ("p", "mu", "nu"):
                x = mine[what].detach().double().numpy()
                a, b = want[what][k].double().numpy(), alt[what].detach().double().numpy()
                if what == "nu":
                    # held as sqrt(nu) = |g| sqrt(1 - b2), like the gradient
                    x, a, b = np.sqrt(x), np.sqrt(a), np.sqrt(b)
                # the moments also carry the f32 gradient's own error
                slack = 0.0 if what == "p" else rel * np.abs(a).max()
                err = np.minimum(np.abs(x - a) / (_ulp(a) + slack),
                                 np.abs(x - b) / (_ulp(b) + slack))
                # sqrt(nu): g a step apart, and the two roundings of nu
                steps = 1.5 if what == "nu" else 1.0
                assert err[~near0].max(initial=0) <= steps, (tag, k, what,
                                                             float(err[~near0].max()))
            assert (np.abs(p.detach().double().numpy() - want["p"][k].double().numpy())
                    [near0].max(initial=0) <= 2 * lr * 1.01), (tag, k)


def test_bf16_run_checkpoints_resumes_and_exports(tmp_path):
    """The train CLI with ``param_dtype: bfloat16``: the checkpoint holds
    parameters made in bf16 and turned f32 by the first update, as the JAX
    step turns them, and bf16 Adam moments after one step, f32 after the
    second; a resume runs on from the checkpoint, and the reference export
    writes f32 (the JAX exporter's dtype).  A restore gives the networks
    the checkpoint's f32 parameters bit for bit, and 2 steps, then a resume
    for 2 more, end where 4 straight steps end, bit for bit."""
    from nirgan_tpu_torch.export_torch_ckpt import main as export_main
    from nirgan_tpu_torch.train.checkpoint import CheckpointManager
    from nirgan_tpu_torch.weights import load_reference_weights

    cfg = _tiny_config_file(tmp_path, param_dtype="bfloat16")
    run = str(tmp_path / "run")
    argv = ["--config", cfg, "--device", "cpu", "--logdir", run, "--log-every", "2"]
    task = Px2PxTask(load_config(cfg), device="cpu", seed=0)
    assert {p.dtype for p in task.netG.parameters()} == {torch.bfloat16}
    state = cli.main(argv + ["--max-steps", "2"])
    assert state.step == 2
    blob = torch.load(os.path.join(run, "last.pt"), weights_only=True)
    assert {v.dtype for v in blob["G"].values()} == {torch.float32}
    moments = blob["opt_g"]["state"][0]
    assert moments["step"] == 2 and moments["exp_avg"].dtype == torch.float32
    # the restore into networks built in bf16
    restored = CheckpointManager(run).restore(task, task.init_state())
    assert restored.step == 2
    for net, tag in ((task.netG, "G"), (task.netD, "D")):
        for k, p in net.named_parameters():
            assert p.dtype == torch.float32 and torch.equal(p, blob[tag][k]), (tag, k)
    resumed = cli.main(argv + ["--resume", run, "--max-steps", "4"])
    assert resumed.step == 4
    whole = str(tmp_path / "whole")
    cli.main(["--config", cfg, "--device", "cpu", "--logdir", whole, "--log-every", "2",
              "--max-steps", "4"])
    a = torch.load(os.path.join(whole, "last.pt"), weights_only=True)
    b = torch.load(os.path.join(run, "last.pt"), weights_only=True)
    assert a["step"] == b["step"] == 4
    for tag in ("G", "D"):
        for k, v in a[tag].items():
            assert v.dtype == b[tag][k].dtype and torch.equal(v, b[tag][k]), (tag, k)
    for opt in ("opt_g", "opt_d"):
        for i, st in a[opt]["state"].items():
            for key in ("exp_avg", "exp_avg_sq"):
                assert torch.equal(st[key], b[opt]["state"][i][key]), (opt, i, key)
    out = str(tmp_path / "x.ckpt")
    export_main(["--config", cfg, "--ckpt", run, "--out", out])
    again = torch.load(os.path.join(run, "last.pt"), weights_only=True)
    ref = load_reference_weights(out, _config(32))["netG"]
    for k, v in again["G"].items():
        assert ref[k].dtype == torch.float32
        assert torch.equal(ref[k].reshape(v.shape), v.float()), k


def test_optax_adam_restores_its_moments_in_their_dtype():
    """After one update of bf16 parameters they are f32 and their moments
    bf16: an optimizer restored from that state keeps the moments bf16 (the
    default ``load_state_dict`` would cast them to the parameters' f32), so
    the next update is the one the first optimizer makes, bit for bit."""
    rng = np.random.default_rng(0)
    p0 = torch.from_numpy(rng.standard_normal((4, 5)).astype(np.float32))
    grads = [torch.from_numpy(rng.standard_normal((4, 5)).astype(np.float32))
             for _ in range(2)]
    a = torch.nn.Parameter(p0.to(torch.bfloat16))
    opt_a = OptaxAdam([a], lr=2e-4, betas=(0.5, 0.999))
    a.grad = grads[0].to(torch.bfloat16)
    opt_a.step()
    assert a.dtype == torch.float32 and opt_a.state[a]["exp_avg"].dtype == torch.bfloat16
    b = torch.nn.Parameter(a.detach().clone())
    opt_b = OptaxAdam([b], lr=2e-4, betas=(0.5, 0.999))
    opt_b.load_state_dict(opt_a.state_dict())
    assert {opt_b.state[b][k].dtype for k in ("exp_avg", "exp_avg_sq")} == {torch.bfloat16}
    for p, opt in ((a, opt_a), (b, opt_b)):
        p.grad = grads[1].clone()
        opt.step()
    assert torch.equal(a, b)
    for k in ("exp_avg", "exp_avg_sq"):
        assert torch.equal(opt_a.state[a][k], opt_b.state[b][k]), k

