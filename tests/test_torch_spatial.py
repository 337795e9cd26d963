"""The H-sharded single tile of the port (``nirgan_tpu_torch/parallel/spatial.py``)
against the JAX package's (``nirgan_tpu/parallel/spatial.py``) and against
the port in one process, on the CPU at a small size (ngf 8,
``resnet_9blocks``, f32).

One spawn of four gloo processes (``file://`` rendezvous) runs, once for
the module, every multi-process case: the 1-D tile of JAX's test
(``(1, 3, 128, 64)``) without and with ``Data.padding`` (pad 10: uneven
shards of 40, 36, 36, 36 rows), the replicate and zero trunks, the int8
trunk on the port's pack and on JAX's, stage 2, and the (2, 2) grid on a
batch of 4 of 64^2; then ``unet_128`` (ngf 8, f32) on a 128^2 tile with
the instance norm (sharded down to level 5, levels 5 to 7 gathered and run
on every rank) and with no norm, and on the (2, 2) grid with a batch of 2
of 128^2 (level 6 gathered) and of 256^2 (sharded to level 7 =
``num_downs``, nothing gathered).  The float cases are held within rtol / atol
2e-5 of JAX's ``predict_large_tile`` / ``predict_tiles_2d`` on the 8 CPU
devices and of the port's one-process ``g_apply``; the int8 cases within
JAX's own bounds for its sharded int8 trunk (``tests/test_int8_trunk.py``).
In one process: the sharded path at a world of one (the ResNet and both
U-Nets with each norm), the halo assembly against the whole map's pads, the
k4 s2 slabs against the whole map's conv and transposed conv, the U-Net's
row ranges, the split norm's and kernel E's plain versions given the tile's
count (and the fault of the shard's count), kernel D's VALID gathers
against JAX's formula, the refusals.  The kernels themselves run on
the card only (``chip_smoke.py --phase spatial``).  This module imports
jax only inside its tests, so that the ranks, which import it, start
without it.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch.nn.functional as F

from nirgan_tpu_torch.config import load_config
from nirgan_tpu_torch.models.layers import Norm
from nirgan_tpu_torch.ops import instance_norm as in_mod
from nirgan_tpu_torch.ops import int8_trunk as port_int8
from nirgan_tpu_torch.ops.pad import reflect_pad2d, replicate_pad2d, zero_pad2d
from nirgan_tpu_torch.parallel import create_mesh
from nirgan_tpu_torch.parallel.mesh import Mesh
from nirgan_tpu_torch.parallel.spatial import (
    Grid,
    Shard,
    assemble,
    create_grid,
    pad_cols,
    predict_large_tile,
    predict_tiles_2d,
    row_ranges,
    shard_ranges,
    unet_depth,
)
from nirgan_tpu_torch.tasks import Px2PxTask

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
TOL = 2e-5
UNET_NORMS = ("instance", "none")
PADS = {"reflect": reflect_pad2d, "replicate": replicate_pad2d, "zero": zero_pad2d}


def _cfg(padding: bool = False):
    """JAX's spatial test config: ngf 8, ndf 8, f32, with or without the
    task's reflect pad (10)."""
    cfg = load_config(os.path.join(REPO, "configs/config_px2px.yaml"))
    cfg.base_configs.ngf = 8
    cfg.base_configs.ndf = 8
    cfg.Data.padding = padding
    cfg.tpu.compute_dtype = "float32"
    return cfg


def _task(state_dict, padding: bool = False, trunk: str = "reflect") -> Px2PxTask:
    task = Px2PxTask(_cfg(padding), device="cpu").bind(state_dict)
    task.netG.padding_type = trunk
    for i in range(task.netG.n_blocks):
        getattr(task.netG, f"r{i}").padding_type = trunk
    return task


def _unet_cfg(netG: str = "unet_128", norm: str = "instance"):
    """The U-Net's config: JAX's spatial test config with ``netG`` and
    ``norm``, unpadded (a U-Net's side divides by 2^num_downs)."""
    cfg = _cfg()
    cfg.base_configs.netG = netG
    cfg.base_configs.norm = norm
    return cfg


def _unet_task(state_dict, norm: str = "instance") -> Px2PxTask:
    return Px2PxTask(_unet_cfg("unet_128", norm), device="cpu").bind(state_dict)


def _tile(seed: int = 0, shape=(1, 3, 128, 64)) -> np.ndarray:
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


def _one(task, rgb, trunk_q=None) -> np.ndarray:
    """The port's one-process ``g_apply`` of the NCHW tile, NCHW f32."""
    with torch.inference_mode():
        y = task.g_apply(torch.from_numpy(rgb.transpose(0, 2, 3, 1)), trunk_q=trunk_q)
    return y.float().permute(0, 3, 1, 2).numpy()


def _psnr(a, b) -> float:
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return np.inf if mse == 0 else 10 * np.log10(4.0 / mse)


# -------------------------------------------------------------- the ranks
def _rank_main(rank: int, init_file: str, inputs_path: str) -> None:
    """One of the four processes: every case, results into ``rank{rank}.pt``
    beside the inputs."""
    from nirgan_tpu_torch.parallel import initialize_multihost

    torch.set_num_threads(1)
    initialize_multihost(init_method=f"file://{init_file}", world_size=WORLD, rank=rank,
                         device="cpu", backend="gloo", timeout_s=240)
    mesh = create_mesh("cpu")
    inp = torch.load(inputs_path, weights_only=False)
    sd, rgb = inp["state_dict"], inp["rgb"]
    out = {}
    for name, padding, trunk in (("plain", False, "reflect"), ("padded", True, "reflect"),
                                 ("replicate", True, "replicate"), ("zero", True, "zero")):
        out[name] = predict_large_tile(_task(sd, padding, trunk), rgb, mesh)
    task = _task(sd)
    for name in ("int8", "int8_jax", "stage2"):
        out[name] = predict_large_tile(task, rgb, mesh, trunk_q=inp[name])
    grid = create_grid(mesh, 2, 2)
    out["grid"] = predict_tiles_2d(task, inp["batch"], grid)
    for norm in UNET_NORMS:
        out[f"unet_{norm}"] = predict_large_tile(_unet_task(inp[f"unet_{norm}"], norm),
                                                 inp["unet_rgb"], mesh)
    out["unet_grid"] = predict_tiles_2d(_unet_task(inp["unet_instance"]), inp["unet_batch"],
                                        grid)
    out["unet_grid_deepest"] = predict_tiles_2d(_unet_task(inp["unet_instance"]),
                                                inp["unet_batch_deepest"], grid)
    torch.save(out, os.path.join(os.path.dirname(inputs_path), f"rank{rank}.pt"))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The JAX task and params, the inputs, and the four ranks' results
    (spawned once for the module)."""
    import jax
    import jax.numpy as jnp

    from nirgan_tpu.config import load_config as jax_load_config
    from nirgan_tpu.tasks import Px2PxTask as JaxPx2PxTask
    from nirgan_tpu.ops import int8_trunk as jax_int8
    from nirgan_tpu_torch.weights import params_from_jax

    def jax_task(netG="resnet_9blocks", norm="instance", side=64, seed=0):
        """The JAX task and G's parameters in the shapes of its init (eager
        flax would compile each operation anew), drawn with numpy: N(0,
        0.02) weights, as the normal init, and small biases.  Without a norm
        the weights are N(0, 2 / fan-in) instead, so that the deepest
        levels' signal reaches the output above the tolerance (at N(0,
        0.02) it shrinks about fourfold a layer)."""
        jcfg = jax_load_config(os.path.join(REPO, "configs/config_px2px.yaml"))
        jcfg.base_configs.ngf = 8
        jcfg.base_configs.ndf = 8
        jcfg.base_configs.netG = netG
        jcfg.base_configs.norm = norm
        jcfg.Data.padding = False
        jcfg.tpu.compute_dtype = "float32"
        jtask = JaxPx2PxTask(jcfg)
        shapes = jax.eval_shape(lambda: jtask.netG.init(
            jax.random.PRNGKey(0), jnp.zeros((1, side, side, 3))))["params"]
        rng = np.random.default_rng(seed)

        def std(shape):
            if len(shape) == 1:
                return 0.01
            return np.sqrt(2.0 / np.prod(shape[:-1])) if norm == "none" else 0.02

        params = jax.tree_util.tree_map(
            lambda v: (rng.standard_normal(v.shape) * std(v.shape)).astype(np.float32), shapes)
        return jtask, params

    jtask, params = jax_task()
    sd = params_from_jax(params)
    unets = {norm: jax_task("unet_128", norm, 128, 1) for norm in UNET_NORMS}
    rgb = _tile()
    x = rgb.transpose(0, 2, 3, 1)
    task = _task(sd)
    qp = jtask.build_trunk_q(params, jnp.asarray(x))
    jcalib = {k: [torch.from_numpy(np.asarray(v)) for v in vs] for k, vs in
              jax_int8.calibrate_trunk(jtask.netG, params, jnp.asarray(x)).items()}
    inputs = {"state_dict": sd, "rgb": rgb, "batch": _tile(1, (4, 3, 64, 64)),
              "int8": task.build_trunk_q(torch.from_numpy(x)),
              "int8_jax": port_int8.quantize_trunk(task.netG.state_dict(),
                                                   task.netG.n_blocks, jcalib),
              "stage2": task.build_trunk_q(torch.from_numpy(x), stage2=True),
              "unet_rgb": _tile(5, (1, 3, 128, 128)), "unet_batch": _tile(6, (2, 3, 128, 128)),
              "unet_batch_deepest": _tile(7, (2, 3, 256, 256)),
              **{f"unet_{norm}": params_from_jax(p) for norm, (_, p) in unets.items()}}
    d = tmp_path_factory.mktemp("torch_spatial")
    path = str(d / "inputs.pt")
    torch.save(inputs, path)
    code = ("import sys; sys.path.insert(0, sys.argv[4]); import test_torch_spatial as t; "
            "t._rank_main(int(sys.argv[1]), sys.argv[2], sys.argv[3])")
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
                        "NIRGAN_MULTIHOST", "NIRGAN_COORDINATOR")}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(rank), str(d / "rendezvous"),
                               path, os.path.join(REPO, "tests")],
                              cwd=str(d), env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for rank in range(WORLD)]
    logs = []
    for p in procs:
        try:
            log, _ = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            log, _ = p.communicate()
        logs.append(log.decode(errors="replace"))
    if any(p.returncode != 0 for p in procs):
        raise AssertionError("a rank failed:\n" + "\n---\n".join(x[-4000:] for x in logs))
    ranks = [torch.load(str(d / f"rank{r}.pt"), weights_only=False) for r in range(WORLD)]
    return {"jtask": jtask, "params": params, "qp": qp, "inputs": inputs, "ranks": ranks,
            "unets": unets}


def _on_every_rank(world, name) -> np.ndarray:
    """The case's prediction, the same on every rank bit for bit."""
    first = world["ranks"][0][name]
    for r in world["ranks"][1:]:
        np.testing.assert_array_equal(r[name], first)
    return first


def _jax_tile(world, padding: bool, trunk_q=None) -> np.ndarray:
    """JAX's ``predict_large_tile`` of the module's tile on its 8-device
    mesh."""
    import jax

    from nirgan_tpu.parallel import create_mesh as jax_create_mesh
    from nirgan_tpu.parallel.spatial import predict_large_tile as jax_predict_large_tile

    task = world["jtask"]
    before = (task.use_padding, task.pad_amount)
    task.use_padding, task.pad_amount = padding, 10 if padding else 0
    try:
        assert len(jax.devices()) == 8
        return jax_predict_large_tile(task, world["params"], world["inputs"]["rgb"],
                                      jax_create_mesh(("data",)), trunk_q=trunk_q)
    finally:
        task.use_padding, task.pad_amount = before


# -------------------------------------------------------- four processes
@pytest.mark.parametrize("padding", [False, True], ids=["no_pad", "pad10"])
def test_sharded_tile_matches_jax_and_one_process(world, padding):
    """Four ranks of the 1-D tile, within 2e-5 of JAX's sharded tile on its
    8-device mesh (JAX's own bound against one device) and of the port's
    one process, the same on every rank; with the pad the shards are
    uneven."""
    got = _on_every_rank(world, "padded" if padding else "plain")
    sd, rgb = world["inputs"]["state_dict"], world["inputs"]["rgb"]
    assert got.shape == (1, 1, 128, 64) and got.dtype == np.float32
    np.testing.assert_allclose(got, _jax_tile(world, padding), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, _one(_task(sd, padding), rgb), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("trunk", ["replicate", "zero"])
def test_sharded_padded_trunks_match_one_process(world, trunk):
    """The replicate and zero trunks (kernel A's VALID mode on slabs with
    that border at the tile's edges), padded tile, within 2e-5 of one
    process."""
    got = _on_every_rank(world, trunk)
    sd, rgb = world["inputs"]["state_dict"], world["inputs"]["rgb"]
    ref = _one(_task(sd, True, trunk), rgb)
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)
    assert not np.allclose(got, _on_every_rank(world, "padded"), atol=1e-3)


def _int8_bounds(sharded, single, flt) -> None:
    """``test_int8_under_spatial_sharding``'s bounds: within quantisation
    noise of one process (max |d| < 0.1, > 40 dB), not the float path but
    > 36 dB from it."""
    assert float(np.max(np.abs(sharded - single))) < 0.1
    assert _psnr(sharded, single) > 40.0
    assert not np.array_equal(sharded, flt)
    assert _psnr(sharded, flt) > 36.0


def test_int8_sharded_meets_jax_bounds(world):
    """The int8 trunk over four ranks, the pack the port calibrates on the
    whole tile, against the port's one-process int8 forward on it."""
    inp = world["inputs"]
    task = _task(inp["state_dict"])
    got = _on_every_rank(world, "int8")
    _int8_bounds(got, _one(task, inp["rgb"], inp["int8"]), _on_every_rank(world, "plain"))


def test_int8_sharded_on_jax_pack_meets_jax_bounds(world):
    """The int8 trunk over four ranks on JAX's pack, against JAX's
    one-device int8 forward and JAX's own sharded int8 tile."""
    import jax

    task, params, qp = world["jtask"], world["params"], world["qp"]
    x = world["inputs"]["rgb"].transpose(0, 2, 3, 1)
    single = np.asarray(jax.jit(lambda p, v: task.g_apply(p, v, train=False, trunk_q=qp))(
        params, x)).transpose(0, 3, 1, 2)
    got = _on_every_rank(world, "int8_jax")
    _int8_bounds(got, single, _on_every_rank(world, "plain"))
    _int8_bounds(got, _jax_tile(world, False, qp), _on_every_rank(world, "plain"))


def test_stage2_sharded_matches_one_process(world):
    """Stage 2 (d1 in int8: kernel D's VALID stride-2 gather on the slab)
    over four ranks against one process's stage-2 forward on the same pack,
    within the int8 bounds; it differs from the trunk-only forward."""
    inp = world["inputs"]
    got = _on_every_rank(world, "stage2")
    _int8_bounds(got, _one(_task(inp["state_dict"]), inp["rgb"], inp["stage2"]),
                 _on_every_rank(world, "plain"))
    assert not np.array_equal(got, _on_every_rank(world, "int8"))


def test_2d_grid_matches_jax_and_one_process(world):
    """The (2, 2) grid on a batch of 4 of 64^2 within 2e-5 of JAX's
    ``predict_tiles_2d`` on its (2, 4) mesh and of one process."""
    from nirgan_tpu.parallel import create_mesh as jax_create_mesh
    from nirgan_tpu.parallel.spatial import predict_tiles_2d as jax_predict_tiles_2d

    batch = world["inputs"]["batch"]
    got = _on_every_rank(world, "grid")
    assert got.shape == (4, 1, 64, 64)
    ref = jax_predict_tiles_2d(world["jtask"], world["params"], batch,
                               jax_create_mesh(("data", "spatial"), shape=(2, 4)))
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, _one(_task(world["inputs"]["state_dict"]), batch),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("norm", UNET_NORMS)
def test_sharded_unet_matches_jax_and_one_process(world, norm):
    """unet_128 over four ranks on a 128^2 tile (shards of 32 rows, sharded
    down to level 5: the blocks of levels 5 and 6 run on every rank on the
    gathered level-5 map), within 2e-5 of JAX's sharded tile on its
    8-device mesh and of the port's one process, the same on every rank."""
    from nirgan_tpu.parallel import create_mesh as jax_create_mesh
    from nirgan_tpu.parallel.spatial import predict_large_tile as jax_predict_large_tile

    got = _on_every_rank(world, f"unet_{norm}")
    inp = world["inputs"]
    assert got.shape == (1, 1, 128, 128) and got.dtype == np.float32
    jtask, params = world["unets"][norm]
    ref = jax_predict_large_tile(jtask, params, inp["unet_rgb"], jax_create_mesh(("data",)))
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, _one(_unet_task(inp[f"unet_{norm}"], norm),
                                         inp["unet_rgb"]), rtol=TOL, atol=TOL)


def test_unet_2d_grid_matches_jax_and_one_process(world):
    """unet_128 on the (2, 2) grid, a batch of 2 of 128^2 (two shards of 64
    rows a sample: level 6 gathered), within 2e-5 of JAX's
    ``predict_tiles_2d`` on its (2, 4) mesh and of one process."""
    from nirgan_tpu.parallel import create_mesh as jax_create_mesh
    from nirgan_tpu.parallel.spatial import predict_tiles_2d as jax_predict_tiles_2d

    inp = world["inputs"]
    got = _on_every_rank(world, "unet_grid")
    assert got.shape == (2, 1, 128, 128)
    jtask, params = world["unets"]["instance"]
    ref = jax_predict_tiles_2d(jtask, params, inp["unet_batch"],
                               jax_create_mesh(("data", "spatial"), shape=(2, 4)))
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, _one(_unet_task(inp["unet_instance"]), inp["unet_batch"]),
                               rtol=TOL, atol=TOL)


def test_unet_2d_grid_sharded_to_num_downs_matches_jax_and_one_process(world):
    """unet_128 on the (2, 2) grid, a batch of 2 of 256^2: two shards of
    128 rows a sample, so ``unet_depth(256, 2, 7)`` is 7 = ``num_downs``
    and nothing is gathered whole (the cut of the 2048^2 tile over two
    ranks on the card, where every k4 s2 conv, transposed conv and norm
    runs on a shard's slab), within 2e-5 of JAX's ``predict_tiles_2d`` on
    its (2, 4) mesh and of one process."""
    from nirgan_tpu.parallel import create_mesh as jax_create_mesh
    from nirgan_tpu.parallel.spatial import predict_tiles_2d as jax_predict_tiles_2d

    inp = world["inputs"]
    batch = inp["unet_batch_deepest"]
    assert unet_depth(batch.shape[2], 2, 7) == 7
    got = _on_every_rank(world, "unet_grid_deepest")
    assert got.shape == (2, 1, 256, 256) and got.dtype == np.float32
    jtask, params = world["unets"]["instance"]
    ref = jax_predict_tiles_2d(jtask, params, batch,
                               jax_create_mesh(("data", "spatial"), shape=(2, 4)))
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, _one(_unet_task(inp["unet_instance"]), batch),
                               rtol=TOL, atol=TOL)


# ---------------------------------------------------------- one process
@pytest.fixture(scope="module")
def weights():
    return Px2PxTask(_cfg(), device="cpu", seed=3).netG.state_dict()


def _unet_world_task(netG: str, norm: str) -> Px2PxTask:
    """A seeded U-Net task; a batch norm's running statistics drawn away
    from (0, 1), so that eval mode normalises.  Without the instance norm
    the weights are N(0, 2 / fan-in), so that the deepest levels' signal
    reaches the output above the tolerance."""
    task = Px2PxTask(_unet_cfg(netG, norm), device="cpu", seed=3)
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for m in task.netG.modules():
            if isinstance(m, Norm) and m.norm_type == "batch":
                m.running_mean.normal_(0.0, 0.1, generator=gen)
                m.running_var.uniform_(0.5, 1.5, generator=gen)
            if norm != "instance" and getattr(m, "weight", None) is not None \
                    and m.weight.dim() == 4:
                # a k4 s2 transposed conv reads a quarter of its kernel an output
                fan = m.weight[0].numel() if not m.transposed else m.weight.shape[0] * 4
                m.weight.normal_(0.0, (2.0 / fan) ** 0.5, generator=gen)
    return task


@pytest.mark.parametrize("netG,padding,trunk,norm", [
    pytest.param("resnet_9blocks", False, "reflect", "instance", id="False-reflect"),
    pytest.param("resnet_9blocks", True, "reflect", "instance", id="True-reflect"),
    pytest.param("resnet_9blocks", True, "zero", "instance", id="True-zero"),
    *[pytest.param(net, False, None, norm, id=f"{net}-{norm}")
      for net in ("unet_128", "unet_256") for norm in ("instance", "batch", "none")]])
def test_world_of_one_matches_forward(weights, netG, padding, trunk, norm):
    """Without a process group the tile is one shard: the slabs (every
    border from the shard itself) and the split norm run, within 2e-5 of
    ``ResnetGenerator.forward`` (with and without the task's pad, reflect
    and zero trunks) and ``UnetGenerator.forward`` (unet_128 at 128^2,
    unet_256 at 256^2; the instance norm, the batch norm in eval mode, no
    norm)."""
    if netG.startswith("unet"):
        side = 128 if netG == "unet_128" else 256
        task, rgb = _unet_world_task(netG, norm), _tile(4, (2, 3, side, side))
    else:
        task, rgb = _task(weights, padding, trunk), _tile(4, (2, 3, 64, 48))
    got = predict_large_tile(task, rgb, create_mesh("cpu"))
    np.testing.assert_allclose(got, _one(task, rgb), rtol=TOL, atol=TOL)


class _SimShard(Shard):
    """Shard ``index`` of the ``ranges`` of a whole map ``whole``, its
    neighbours' edge rows taken from ``whole`` in place of a collective:
    the one-row halo gather of ``Shard.rows``."""

    def __init__(self, ranges, index, whole):
        super().__init__(ranges, index, distributed=True)
        self.map = whole

    def gather(self, t):
        assert t.shape[1] == 2  # one row below, one above
        return [torch.cat([self.map[:, lo:lo + 1], self.map[:, hi - 1:hi]], 1)
                for lo, hi in self.ranges]


@pytest.mark.parametrize("op", ["conv", "convt"])
@pytest.mark.parametrize("ranges", [[(0, 8), (8, 12), (12, 20), (20, 24)],
                                    [(0, 2), (2, 22), (22, 24)]], ids=["four", "three"])
def test_k4_slabs_equal_whole_map_convs(op, ranges):
    """Each uneven shard's k4 s2 p1 slab, its halo from the neighbours and
    zero rows at the map's edges: the VALID stride-2 conv of
    ``down4_slab`` gives the shard's rows [lo / 2, hi / 2) of the whole
    map's ``F.conv2d``; the transposed conv (padding 1) of ``up4_slab``,
    cropped to rows [2, 2 h + 2), the rows [2 lo, 2 hi) of the whole map's
    ``F.conv_transpose2d``."""
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((2, 24, 10, 6)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((5, 6, 4, 4)).astype(np.float32))
    nchw = x.permute(0, 3, 1, 2)
    for i, (lo, hi) in enumerate(ranges):
        shard = _SimShard(ranges, i, x)
        rows = x[:, lo:hi]
        if op == "conv":
            whole = F.conv2d(nchw, w, stride=2, padding=1)[:, :, lo // 2:hi // 2]
            got = F.conv2d(shard.down4_slab(rows).permute(0, 3, 1, 2), w, stride=2)
        else:
            wt = w.transpose(0, 1)  # (Cin 6, Cout 5, 4, 4)
            whole = F.conv_transpose2d(nchw, wt, stride=2, padding=1)[:, :, 2 * lo:2 * hi]
            got = F.conv_transpose2d(shard.up4_slab(rows).permute(0, 3, 1, 2), wt,
                                     stride=2, padding=1)[:, :, 2:2 * (hi - lo) + 2]
        torch.testing.assert_close(got, whole, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n_rows,n,num_downs,k", [(128, 4, 7, 5), (512, 4, 8, 7),
                                                  (2048, 2, 8, 8), (128, 1, 7, 7)])
def test_unet_row_ranges(n_rows, n, num_downs, k):
    """The deepest level k <= num_downs at which every shard holds a row:
    JAX's 128^2 test tile with unet_128 over 4 shards k = 5, 512^2 with
    unet_256 over 4 k = 7, 2048^2 over 2 k = 8, one shard ``num_downs``;
    ``row_ranges`` with a unit of 2^k cuts there, one level deeper it
    leaves a shard no row."""
    assert unet_depth(n_rows, n, num_downs) == k
    ranges = row_ranges(n_rows, n, 1 << k, 1 << k)
    assert [hi - lo for lo, hi in ranges] == [n_rows // n] * n
    if k < num_downs:
        with pytest.raises(ValueError, match="fewer than"):
            row_ranges(n_rows, n, 2 << k, 2 << k)
    task = Px2PxTask(_unet_cfg("unet_256" if num_downs == 8 else "unet_128"), device="cpu")
    assert shard_ranges(task, n_rows, n) == ranges


@pytest.mark.parametrize("border", ["reflect", "replicate", "zero"])
@pytest.mark.parametrize("r", [1, 3])
def test_halo_assembly_equals_whole_map_pad(border, r):
    """``assemble`` of each shard's rows with its neighbours' edge rows
    gives the rows of the whole map's pad (``reflect_pad2d`` and its
    siblings) around the shard, at interior and global edges; ``pad_cols``
    gives its columns."""
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((2, 24, 7, 3))
                         .astype(np.float32))
    whole = PADS[border](x, r)
    ranges = [(0, 8), (8, 12), (12, 20), (20, 24)]
    for i, (lo, hi) in enumerate(ranges):
        above = x[:, lo - r:lo] if i > 0 else None
        below = x[:, hi:hi + r] if i < len(ranges) - 1 else None
        slab = assemble(x[:, lo:hi], above, below, r, r, border, i == 0,
                        i == len(ranges) - 1)
        torch.testing.assert_close(pad_cols(slab, r, border), whole[:, lo:hi + 2 * r],
                                   rtol=0, atol=0)


@pytest.mark.parametrize("pieces", [2, 3, 4])
@pytest.mark.parametrize("relu,skip", [(False, False), (True, False), (False, True)])
def test_split_norm_plain_equals_instance_norm_plain(pieces, relu, skip):
    """B's split plain versions: each piece's sums, gathered in order, then
    each piece normalised with the tile's count, equal the whole map's
    ``instance_norm_plain`` within f32 summation noise (1e-5)."""
    rng = np.random.default_rng(pieces)
    x = torch.from_numpy((rng.standard_normal((2, 30, 9, 16)) * 2 + 0.5).astype(np.float32))
    res = torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32)) if skip else None
    cuts = np.linspace(0, 30, pieces + 1).astype(int)
    rows = [slice(a, b) for a, b in zip(cuts[:-1], cuts[1:])]
    parts = torch.stack([in_mod.instance_norm_sums_plain(x[:, s]) for s in rows], 1)
    assert tuple(parts.shape) == (2, pieces, 4, 16)
    got = torch.cat([in_mod.instance_norm_apply_plain(
        x[:, s], parts, 30 * 9, relu=relu, residual=None if res is None else res[:, s])
        for s in rows], 1)
    want = in_mod.instance_norm_plain(x, relu=relu, residual=res)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_shard_count_is_the_tiles():
    """The guard of the pixel count: B's apply and E (plain) given the
    tile's sums and the tile's count normalise a shard as the whole tile
    does; with the shard's own count (the local HW) they do not."""
    rng = np.random.default_rng(8)
    x = torch.from_numpy((rng.standard_normal((1, 16, 8, 8)) * 3 + 1).astype(np.float32))
    parts = torch.stack([in_mod.instance_norm_sums_plain(x[:, :8]),
                         in_mod.instance_norm_sums_plain(x[:, 8:])], 1)
    want = in_mod.instance_norm_plain(x)[:, :8]
    torch.testing.assert_close(in_mod.instance_norm_apply_plain(x[:, :8], parts, 16 * 8),
                               want, rtol=1e-5, atol=1e-5)
    assert not torch.allclose(in_mod.instance_norm_apply_plain(x[:, :8], parts, 8 * 8),
                              want, atol=1e-2)
    hb = x.to(torch.bfloat16)
    a32 = hb.float()
    moments = torch.stack([a32.sum(dim=(1, 2)), a32.square().sum(dim=(1, 2))], 1)
    eps = torch.full((8,), 1e-5)
    whole = port_int8.norm_from_moments(hb, moments, eps)[:, :8]
    for norm in (lambda c: port_int8.norm_from_moments(hb[:, :8], moments, eps, c),
                 lambda c: port_int8.norm_quant_plain(
                     3, hb[:, :8], torch.full((8,), 0.05), moments, eps,
                     dtype=torch.float32, count=c)[0]):
        assert not torch.allclose(norm(16 * 8), norm(None), atol=1e-2)
    torch.testing.assert_close(port_int8.norm_from_moments(hb[:, :8], moments, eps, 128),
                               whole, rtol=0, atol=0)
    torch.testing.assert_close(port_int8.norm_quant_plain(
        3, hb[:, :8], torch.full((8,), 0.05), moments, eps, dtype=torch.float32,
        count=128)[0], torch.relu(whole), rtol=0, atol=0)


def test_norm_count_matches_jax():
    """E's plain norm with a count equals JAX's ``_norm_from_moments`` with
    that n: the moments of a tile of 12 x 12, one shard's 6 x 12 rows."""
    import jax.numpy as jnp

    from nirgan_tpu.ops import int8_trunk as jax_int8

    rng = np.random.default_rng(3)
    acc = rng.integers(-3000, 3000, (2, 12, 12, 16)).astype(np.float32)
    hb = torch.from_numpy(acc).to(torch.bfloat16)
    a32 = torch.from_numpy(acc)
    m = torch.stack([a32.sum(dim=(1, 2)), a32.square().sum(dim=(1, 2))], 1)
    eps = torch.from_numpy((1e-5 / (1 + rng.random(16)) ** 2).astype(np.float32))
    got = port_int8.norm_from_moments(hb[:, :6], m, eps, 144)
    ref = jax_int8._norm_from_moments(jnp.asarray(hb[:, :6].float().numpy()).astype(jnp.bfloat16),
                                      jnp.asarray(m[:, 0].numpy()), jnp.asarray(m[:, 1].numpy()),
                                      jnp.asarray(eps.numpy()), 144)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-6, atol=5e-7)


@pytest.mark.parametrize("stride,shape", [(1, (2, 9, 7, 32)), (2, (2, 9, 7, 32)),
                                          (2, (1, 10, 12, 64))])
def test_valid_gathers_are_jax_valid_convs(stride, shape):
    """D's plain version without a border (``"valid"``) equals JAX's VALID
    int32 convolution at stride 1 and 2, output sides n - 2 and
    (n - 3) // 2 + 1; a whole map's zero-border stride-2 conv is the VALID
    one of its zero-padded slab."""
    import jax.numpy as jnp
    from jax import lax

    rng = np.random.default_rng(stride)
    x8 = rng.integers(-127, 128, shape).astype(np.int8)
    w8 = rng.integers(-127, 128, (16, shape[3], 3, 3)).astype(np.int8)
    ref = np.asarray(lax.conv_general_dilated(
        jnp.asarray(x8), jnp.asarray(w8.transpose(2, 3, 1, 0)), (stride, stride), "VALID",
        dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.int32))
    got = port_int8.conv_i8_plain(torch.from_numpy(x8), torch.from_numpy(w8), "valid",
                                  stride)
    sides = tuple(port_int8.out_side(n, stride, "valid") for n in shape[1:3])
    assert tuple(got.shape) == (shape[0], *sides, 16) == ref.shape
    np.testing.assert_array_equal(got.numpy(), ref)
    if stride == 2:
        t8 = torch.from_numpy(x8)
        np.testing.assert_array_equal(
            port_int8.conv_i8_plain(zero_pad2d(t8, 1), torch.from_numpy(w8), "valid", 2),
            port_int8.conv_i8_plain(t8, torch.from_numpy(w8), "zero", 2))


@pytest.mark.parametrize("border,stride", [("reflect", 1), ("zero", 1), ("zero", 2)])
def test_shards_int8_moments_add_up_to_the_whole_maps(border, stride):
    """D's plain version on each shard's slab (the neighbours' rows, the
    border at the map's edges, VALID): the staged accumulators are the whole
    map's rows and the shards' f64 moments, added, are the whole map's
    moments bit for bit (exact integer sums)."""
    rng = np.random.default_rng(stride)
    x8 = torch.from_numpy(rng.integers(-127, 128, (2, 24, 9, 32)).astype(np.int8))
    w8 = torch.from_numpy(rng.integers(-127, 128, (16, 32, 3, 3)).astype(np.int8))
    hb, m = port_int8.conv_moments_plain(x8, w8, border, stride)
    ranges = [(0, 8), (8, 16), (16, 24)]
    parts, total = [], None
    for i, (lo, hi) in enumerate(ranges):
        first, last = i == 0, i == len(ranges) - 1
        if stride == 1:
            slab = assemble(x8[:, lo:hi], None if first else x8[:, lo - 1:lo],
                            None if last else x8[:, hi:hi + 1], 1, 1, border, first, last)
        else:
            slab = assemble(x8[:, lo:hi], None if first else x8[:, lo - 1:lo], None,
                            1, 0, "zero", first, last)
        hk, mk = port_int8.conv_moments_plain(pad_cols(slab, 1, border), w8, "valid", stride)
        parts.append(hk)
        total = mk if total is None else total + mk
    assert total.dtype == torch.float64
    assert torch.equal(torch.cat(parts, 1), hb)
    assert torch.equal(total, m)


def test_row_ranges():
    """Boundaries on multiples of 4, as equal as that allows, larger first;
    too many shards for the rows refused."""
    assert row_ranges(2068, 2) == [(0, 1036), (1036, 2068)]
    assert row_ranges(148, 4) == [(0, 40), (40, 76), (76, 112), (112, 148)]
    assert row_ranges(64, 1) == [(0, 64)]
    for n_rows, n in ((2068, 3), (532, 8), (150, 4)):
        cuts = [lo for lo, _ in row_ranges(n_rows, n)]
        sizes = [hi - lo for lo, hi in row_ranges(n_rows, n)]
        assert all(c % 4 == 0 for c in cuts) and sum(sizes) == n_rows
        assert max(sizes) - min(sizes) <= 4 + n_rows % 4
    with pytest.raises(ValueError, match="fewer than 8 rows"):
        row_ranges(32, 8)


def test_refusals():
    """JAX's refusals with its messages (H not a multiple of 4 n; B not a
    multiple of the data size), a U-Net tile whose H does not divide by
    2^num_downs (the side check, and the forward's check in
    ``forward_rows`` before any collective: the shard's group does not
    exist), the inject route without embeddings."""
    task = _task(Px2PxTask(_cfg(), device="cpu").netG.state_dict())
    eight = Mesh(0, 8, torch.device("cpu"))
    with pytest.raises(ValueError, match="H=100 must be a multiple of 32"):
        predict_large_tile(task, np.zeros((1, 3, 100, 64), np.float32), eight)
    grid = Grid(eight, 2, 4)
    with pytest.raises(ValueError, match="B=3 must be a multiple of"):
        predict_tiles_2d(task, np.zeros((3, 3, 64, 64), np.float32), grid)
    with pytest.raises(ValueError, match="H=40 must be a multiple of 16"):
        predict_tiles_2d(task, np.zeros((2, 3, 40, 64), np.float32), grid)
    unet = Px2PxTask(_unet_cfg(), device="cpu")
    with pytest.raises(ValueError, match="divisible by 128, got 96"):
        predict_large_tile(unet, np.zeros((1, 3, 96, 128), np.float32), eight)
    shard = Shard(row_ranges(96, 4), 0, distributed=True)
    with pytest.raises(ValueError, match="divisible by 128, got \\(96, 128\\)"):
        unet.netG.forward_rows(torch.zeros((1, 24, 128, 3)), shard)
    whole = Shard([(0, 128), (128, 256)], 0, distributed=True)
    with pytest.raises(ValueError, match="ResNet generators only"):
        unet.netG.forward_rows(torch.zeros((1, 128, 128, 3)), whole, trunk_q={})
    cfg = load_config(os.path.join(REPO, "configs/config_px2px_SatCLIP.yaml"))
    cfg.base_configs.ngf, cfg.base_configs.ndf = 8, 8
    cfg.satclip.satclip_path = None
    cfg.tpu.compute_dtype = "float32"
    inject = Px2PxTask(cfg, device="cpu")
    with pytest.raises(ValueError, match="requires a location embedding"):
        predict_large_tile(inject, np.zeros((1, 3, 64, 64), np.float32), create_mesh("cpu"))
    with pytest.raises(ValueError, match="grid needs 4 processes"):
        create_grid(create_mesh("cpu"), 2, 2)


def test_shard_gathers_nothing_alone():
    """A world of one: ``gather`` and ``add`` are the tensor itself, and a
    shard's slab is the whole map's pad."""
    shard = Shard([(0, 16)], 0)
    t = torch.arange(6.0).reshape(2, 3)
    assert shard.gather(t)[0] is t and shard.add(t) is t
    x = torch.randn(1, 16, 5, 2)
    torch.testing.assert_close(shard.slab(x, 3, 3, "reflect", 3), reflect_pad2d(x, 3),
                               rtol=0, atol=0)
