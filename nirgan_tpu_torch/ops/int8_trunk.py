"""The int8 residual trunk for serving, counterpart of
``nirgan_tpu/ops/int8_trunk.py`` (``tpu.serving_quant: int8``), and its two
hand-written kernels, D and E.

The formulation is the JAX package's:

  * Affine-free instance norm is invariant to a per-output-channel scale
    and shift, so the int8 conv's int32 accumulator is normalised directly
    in accumulator units, with ``eps' = eps / k^2`` per output channel, and
    the conv bias drops out.
  * Per-input-channel activation scales are folded into the weights, which
    are then quantised per output channel (symmetric, +-127).
  * The accumulator is staged in bf16; its f32 moments (sum and sum of
    squares per image and channel) come from the unrounded accumulator.
  * The residual stream stays in the float compute dtype: only the conv
    inputs are quantised, so the error does not compound along the skips.
  * ``calibrate_trunk`` is one float forward with hooks that keeps the
    per-channel absolute maximum of every block input and of every block's
    inner activation; only (C,) vectors leave the device.

**Kernel D** (``csrc/int8_conv.cu``) replaces ``_conv_moments(_pad2d(x8),
w8)`` (``nirgan_tpu/ops/int8_trunk.py:103-108``) and the conv of
``int8_d1_forward`` (``:130-136``), XLA convolutions with an int32 result,
not Pallas kernels: the 3x3 conv of int8 NHWC x8 with its border gathered
in the kernel (the trunk's reflect, replicate or zero border at stride 1;
d1's zero border at stride 2; none, ``"valid"``, on one shard's slab of an
H-sharded tile), exact s8 x s8 -> s32 sums on the tensor cores, and in the
epilogue the accumulator rounded to bf16 and Sigma a, Sigma a^2 per (image,
channel) of the unrounded one, exact sums kept in f64 (kernel E rounds them
to f32 as it reads them; a shard's are first added to the others').  At the serving
trunk's shape (4, 133^2, 256) it is 83.5 G int8 operations against 55 MB
moved: bound by the tensor cores, 0.042 ms at the H100's 1,979 TOPS; d1 at
(4, 266^2, 128) -> (4, 133^2, 256) is 41.7 G operations against 72 MB,
about 0.022 ms either way.
The generator's trunk (``takes_wgmma``: Cin % 128 == 0, Cout 128 or 256)
runs the s8 kernel of kernel A's wgmma engine (``csrc/igemm_wgmma.cu``: the
same gather and ring, 128 int8 channels a 128-byte row, ``wgmma`` s8), the
weight packed by ``pack_weight``, one CTA an SM walking an equal run of
64-row grains (``grain_runs``, ``tile_walk``: the last round balanced to
half a tile); other widths an implicit GEMM on ``mma.sync.m16n8k32``.  The
wgmma kernel keeps each image's column sums as running integer sums and
writes one f64 slot a (CTA, image) (``image_slots``), the mma.sync kernel
one a tile; a second launch adds them in a fixed order, so a batch repeats
bit for bit.  Its plain version convolves the int8
values in float64, which is exact (|acc| <= 127^2 * 9 * C, 3.7e7 at C =
256, far below 2^53; f32 would not be, 3.7e7 > 2^24).

**Kernel E** (``csrc/int8_norm.cu``) replaces ``_norm_from_moments`` and the
``_q8`` after it (``int8_trunk.py:94-100,148-154``): an elementwise pass
over the staged accumulator with the mean and rstd of each (image, channel)
from the moments.  Mode 0 quantises the trunk's input stream, mode 1 (after
conv1) applies the ReLU, divides by ``s_mid`` and quantises, mode 2 (after
conv2) adds the skip in the stream's dtype, writes the stream and, where a
next block exists, its quantised input; mode 3 ends stage 2's d1: the ReLU'd
norm written as the stream and, quantised from that rounded stream, the
trunk's first input (so the trunk's leading mode-0 pass goes).  Bound by
memory: 54 MB in mode 1, 127 MB in mode 2 and 91 MB in mode 3 at the
serving shape, 0.016, 0.038 and 0.027 ms.  Its quotient is the true f32
division's (``x / s`` is one in JAX), rounded half to even and clipped to
+-127, as ``_q8`` does: it multiplies by the channel's rounded reciprocal
and settles exactly, from the residual v - h s, only the elements whose
product lies within 2^-21 of its size from a half-integer h, the only place
the two can round apart (the argument is in the kernel's header).  Its grid
is one wave (``norm_blocks``: the instance's resident blocks times the SMs,
``norm_slots``, shared among the images), each block a run of one image's
pixels, runs as equal as the pixels allow, each thread loading a pass of
``norm_pass`` pixels of its eight channels before any arithmetic on them,
the next pass's loads ahead of this one's arithmetic, and the first passes
(one; four in mode 3) into shared memory before the block
computes its image's constants.

Each is one operator (``_registry``), ``torch.ops.nirgan.int8_conv_moments``
and ``torch.ops.nirgan.int8_norm_quant``, and dispatches as the port's
other kernels do: a CPU tensor takes the plain version, a CUDA tensor
launches the kernel or raises.  Torch has
no int8 convolution on a card, so there is no library route.  Stage 2
(``int8_d1_forward``, the d1 conv in int8) is opt-in, as in the JAX package
(``Px2PxTask.build_trunk_q(stage2=True)``).
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F

from nirgan_tpu_torch.ops import _lib, _registry
from nirgan_tpu_torch.ops._pack import laid_out, pack_b128
from nirgan_tpu_torch.ops.pad import reflect_pad2d, replicate_pad2d, zero_pad2d

CONV_NAME = "int8_conv"
NORM_NAME = "int8_norm"
IN_EPS = 1e-5  # torch InstanceNorm2d's default, as ops/instance_norm.py
CALIB_ROWS = 16  # the rows of a batch that calibrate (build_trunk_q)
# kernel D's gathers (igemm::Gather): the trunk's border at stride 1, the
# zero border at stride 2, and no border ("valid": a slab that carries its
# own, one shard's rows with its halo) at stride 1 and 2
GATHERS = {("reflect", 1): 0, ("replicate", 1): 3, ("zero", 1): 4, ("zero", 2): 2,
           ("valid", 1): 1, ("valid", 2): 5}
PADS = {"reflect": reflect_pad2d, "replicate": replicate_pad2d, "zero": zero_pad2d}


# ------------------------------------------------------------ quantisation
def q8(v: torch.Tensor) -> torch.Tensor:
    """Round half to even, clip to +-127, int8 (``_q8``)."""
    return torch.clamp(torch.round(v), -127, 127).to(torch.int8)


def quant_folded(w: torch.Tensor, s_in: torch.Tensor,
                 eps: float = IN_EPS) -> tuple[torch.Tensor, torch.Tensor]:
    """Fold the per-input-channel scales ``s_in`` into a (Cout, Cin, 3, 3)
    weight, quantise per output channel, and return (w8, eps') for the norm
    in accumulator units (``_quant_folded``)."""
    wf = w.float() * s_in.float()[None, :, None, None]
    k = torch.clamp(wf.abs().amax(dim=(1, 2, 3)) / 127.0, min=1e-12)
    # a true division, as JAX divides: a Python number over a tensor would
    # be its reciprocal times the number in torch
    return q8(wf / k[:, None, None, None]), torch.tensor(eps, dtype=torch.float32, device=k.device) / k.square()


def quantize_trunk(state_dict, n_blocks: int, calib: dict) -> dict:
    """The int8 trunk pack from a generator's state_dict (``r{i}.conv1`` and
    ``conv2`` weights) and the scales of ``calibrate_trunk``: per block w1,
    w2 (Cout, Cin, 3, 3) int8, eps1, eps2, s_in and s_mid (C,) f32, on the
    weights' device; with ``calib["d1_in"]`` (stage 2) also ``pack["d1"] =
    {"w", "eps", "s_in"}`` for ``int8_d1_forward``."""
    pack = {key: [] for key in ("w1", "w2", "eps1", "eps2", "s_in", "s_mid")}
    for i in range(n_blocks):
        w1 = state_dict[f"r{i}.conv1.weight"]
        si = torch.as_tensor(calib["in"][i], dtype=torch.float32, device=w1.device)
        sm = torch.as_tensor(calib["mid"][i], dtype=torch.float32, device=w1.device)
        w1q, e1 = quant_folded(w1, si)
        w2q, e2 = quant_folded(state_dict[f"r{i}.conv2.weight"], sm)
        for key, v in (("w1", w1q), ("w2", w2q), ("eps1", e1), ("eps2", e2),
                       ("s_in", si), ("s_mid", sm)):
            pack[key].append(v)
    if "d1_in" in calib:
        w = state_dict["d1.weight"]
        sd1 = torch.as_tensor(calib["d1_in"], dtype=torch.float32, device=w.device)
        wd1, ed1 = quant_folded(w, sd1)
        pack["d1"] = {"w": wd1, "eps": ed1, "s_in": sd1}
    return pack


@torch.no_grad()
def calibrate_trunk(netG, x_padded: torch.Tensor,
                    embeds: Optional[torch.Tensor] = None,
                    margin: float = 1.2, stage2: bool = False) -> dict:
    """One float forward of ``netG`` with hooks -> the per-channel
    quantisation scales (absmax * margin / 127) of each block's input stream
    and of each block's inner activation (``calibrate_trunk``): {"in":
    [(C,)] * n_blocks, "mid": [(C,)] * n_blocks} as f32 CPU tensors.

    ``x_padded`` carries the serving reflect padding.  The inputs are the
    output of ``nd1`` (which applies its ReLU) and of blocks 0 .. n-2, the
    inner activations the outputs of each block's ``norm1`` (ReLU fused).
    Each hook reduces its tensor to a (C,) vector on the device at once, so
    no activation is kept.  A channel dead on the calibration batch gets a
    floor of 1e-3 of the tensor's largest scale (its folded weights are
    about 0 anyway).  With ``stage2`` also ``"d1_in"``: the scale of the
    input of ``d1``, the ReLU'd stream after ``nd0`` (and after the inject
    combination)."""
    nb = netG.n_blocks
    found: dict = {}

    def keep(name, absolute):
        def hook(module, args, out):
            v = out.float().abs() if absolute else out.float()
            found[name] = v.amax(dim=(0, 1, 2))
        return hook

    taps = [(netG.nd1, "in0", False)]
    taps += [(getattr(netG, f"r{i}"), f"in{i + 1}", True) for i in range(nb - 1)]
    taps += [(getattr(netG, f"r{i}").norm1, f"mid{i}", False) for i in range(nb)]
    handles = [m.register_forward_hook(keep(name, a)) for m, name, a in taps]
    if stage2:
        d1_in = keep("d1_in", True)
        handles.append(netG.d1.register_forward_pre_hook(
            lambda module, args: d1_in(module, args, args[0])))
    try:
        netG(x_padded, *(() if embeds is None else (embeds,)))
    finally:
        for h in handles:
            h.remove()
    k = margin / 127.0

    def clamp(v):
        v = v.cpu()
        return (v * k).clamp(min=max(float(v.max()) * k * 1e-3, 1e-12))

    out = {"in": [clamp(found[f"in{i}"]) for i in range(nb)],
           "mid": [clamp(found[f"mid{i}"]) for i in range(nb)]}
    if stage2:
        out["d1_in"] = clamp(found["d1_in"])
    return out


# ---------------------------------------------------------------- kernel D
def out_side(n: int, stride: int, border: str = "reflect") -> int:
    """The output side of kernel D's 3x3 conv over a side of n: n at stride
    1, (n - 1) // 2 + 1 at stride 2 (k3 s2 p1); without a border
    (``"valid"``) n - 2 and (n - 3) // 2 + 1."""
    if border == "valid":
        return n - 2 if stride == 1 else (n - 3) // 2 + 1
    return n if stride == 1 else (n - 1) // 2 + 1


def conv_i8_plain(x8: torch.Tensor, w8: torch.Tensor, border: str = "reflect",
                  stride: int = 1) -> torch.Tensor:
    """The int32 accumulator of the 3x3 conv of int8 NHWC x8 with a
    (Cout, Cin, 3, 3) int8 weight: at stride 1 with the trunk's ``border``
    (``_conv_i8`` on ``_pad2d``'s input), at stride 2 with the zero border
    (``int8_d1_forward``'s conv), or without a border (``"valid"``) at
    either stride; float64 sums of integers, exact."""
    xp = x8.double() if border == "valid" else PADS[border](x8.double(), 1)
    acc = F.conv2d(xp.permute(0, 3, 1, 2), w8.double(), stride=stride)
    return acc.permute(0, 2, 3, 1).to(torch.int32)


def conv_moments_plain(x8: torch.Tensor, w8: torch.Tensor, border: str = "reflect",
                       stride: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """``_conv_moments``: (the accumulator rounded to bf16, NHWC; its f64
    moments (B, 2, Cout): Sigma a and Sigma a^2 over the pixels of each
    image, of the accumulator before the bf16 rounding), the conv of
    ``conv_i8_plain``.  The moments are exact (for sums under 2^53) as kernel
    D's are, so that one shard of an H-sharded tile can add its own to the
    other shards'; kernel E rounds them to f32 (JAX sums in f32)."""
    acc = conv_i8_plain(x8, w8, border, stride)
    a = acc.double()
    moments = torch.stack([a.sum(dim=(1, 2)), a.square().sum(dim=(1, 2))], 1)
    return acc.float().to(torch.bfloat16), moments


def kernel_weight(w8: torch.Tensor) -> torch.Tensor:
    """(Cout, Cin, 3, 3) -> (3, 3, Cout, Cin): kernel D's B operand, each
    output channel's Cin values of a tap contiguous (K-major, as the
    ``mma.sync`` fragment of B reads them)."""
    return w8.permute(2, 3, 0, 1).contiguous()


def pack_weight(w8: torch.Tensor) -> torch.Tensor:
    """(Cout, Cin, 3, 3) int8 -> the wgmma kernel's B images: tap-major,
    then 128-channel slices of Cin, each (Cout rows, 128 bytes) in the
    128-byte swizzle, packed as kernel A's bf16 images are with two int8
    channels as one 16-bit element."""
    co, ci = w8.shape[:2]
    w16 = w8.permute(2, 3, 0, 1).reshape(9, co, ci).contiguous().view(torch.int16)
    return pack_b128(w16)


def tile_rows(co: int) -> int:
    """The output pixels of a tile of the wgmma kernel (igemm::tile_rows)."""
    return 128 * (256 // co)


def takes_wgmma(ci: int, co: int, hw: int) -> bool:
    """The shapes that go to the wgmma kernel (igemm::takes_s8): Cin % 128
    == 0, Cout 128 or 256, and images of at least a tile's pixels, so that
    no tile spans three images.  The rule is written here only: the C entry
    runs the kernel ``packed`` names and refuses a shape it cannot take."""
    return ci > 0 and ci % 128 == 0 and co in (128, 256) and hw >= tile_rows(co)


def takes_conv(ci: int, co: int) -> bool:
    """The channel counts kernel D is built for: Cin % 32 == 0 (its K step
    is 32 bytes), Cout % 8 == 0 (two channels a store, eight a fragment).
    Every trunk of an ngf that is a multiple of 8 qualifies."""
    return ci > 0 and co > 0 and ci % 32 == 0 and co % 8 == 0


def conv_tiles(hw: int) -> int:
    """The row tiles of one image (128 pixels each, never two images')."""
    return -(-hw // 128)


UNIT_ROWS = 64  # a consumer warpgroup's rows of the wgmma kernel, and a half tile's


def grain_rows(co: int) -> int:
    """The rows of a grain of the wgmma kernel's walk (igemm::s8_grain): a
    64-row unit at Cout 256, where a CTA may end its run on a half tile,
    else a whole tile."""
    return UNIT_ROWS if co == 256 else tile_rows(co)


def s8_ctas(m: int, co: int, sms: int) -> int:
    """The wgmma kernel's CTAs for m output pixels: one an SM (its shared
    memory fills one), and no more than there are whole tiles."""
    return max(1, min(sms, -(-m // tile_rows(co))))


def grain_runs(m: int, co: int, ctas: int) -> list[tuple[int, int]]:
    """The grains [g0, g1) each CTA walks, in order (igemm's grain_run): as
    equal runs as the grains allow, the longer ones first, so the last
    round is balanced to a grain (553 tiles of 128 on 132 CTAs: runs of 8
    or 9 grains of 64, four tiles and at most a half tile, where whole
    tiles alone take five)."""
    q, r = divmod(-(-m // grain_rows(co)), ctas)
    return [(i * q + min(i, r), i * q + min(i, r) + q + (i < r)) for i in range(ctas)]


def tile_walk(m: int, co: int, ctas: int) -> list:
    """The tiles each CTA walks, as the kernel does: (first pixel, pixels),
    whole tiles of ``tile_rows`` and, where a run leaves one grain over, a
    half tile of 64 at its end."""
    gr, bm = grain_rows(co), tile_rows(co)
    walk = []
    for g0, g1 in grain_runs(m, co, ctas):
        mine = []
        for g in range(g0, g1, bm // gr):
            rows = bm if g + bm // gr <= g1 else UNIT_ROWS
            mine.append((g * gr, min(rows, m - g * gr)))
        walk.append(mine)
    return walk


def image_slots(m: int, co: int, ctas: int, hw: int) -> list[list[int]]:
    """The scratch slots each image's sums lie in: CTA i writes the images
    its run touches, image b at slot i + b (and a slot holds one sum a
    consumer warpgroup), so each image's slots, in CTA order, are the
    moments' order of addition."""
    gr = grain_rows(co)
    spans = [(g0 * gr, min(g1 * gr, m)) for g0, g1 in grain_runs(m, co, ctas)]
    return [[i + b for i, (r0, r1) in enumerate(spans) if r0 // hw <= b <= (r1 - 1) // hw]
            for b in range(-(-m // hw))]


def scratch_shape(b: int, ho: int, wo: int, co: int, packed: bool,
                  ctas: int = 1) -> tuple:
    """The f64 scratch of kernel D's column sums: the wgmma kernel's (ctas +
    B - 1 slots, 2 warpgroups, 2 sums, Cout) (``image_slots``), the mma.sync
    kernel's (B, tiles of 128 pixels an image, 2, Cout)."""
    if packed:
        return (ctas + b - 1, 2, 2, co)
    return (b, conv_tiles(ho * wo), 2, co)


@functools.lru_cache(maxsize=None)
def sm_count(device: int) -> int:
    """The card's SMs: the wgmma kernel's most CTAs."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def _launch(x8: torch.Tensor, w8: torch.Tensor, packed: bool,
            border: str = "reflect", stride: int = 1,
            ctas: Optional[int] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """One call of kernel D, the wgmma kernel (``packed``, on ``ctas`` CTAs,
    by default ``s8_ctas``') or the mma.sync kernel; the C entry refuses a
    shape the one named cannot take."""
    req = _lib.require
    req((border, stride) in GATHERS, CONV_NAME,
        f"no gather for border {border!r} at stride {stride}")
    req(x8.is_cuda and x8.dtype == torch.int8 and x8.dim() == 4
        and x8.is_contiguous(), CONV_NAME, "x8 must be a contiguous int8 "
        "(B, H, W, C) CUDA tensor")
    b, h, w, ci = x8.shape
    co = w8.shape[0]
    req(w8.dtype == torch.int8 and tuple(w8.shape) == (co, ci, 3, 3), CONV_NAME,
        f"w8 must be int8 (Cout, {ci}, 3, 3), got {w8.dtype} {tuple(w8.shape)}")
    req(takes_conv(ci, co), CONV_NAME,
        f"channels {ci}->{co}: the kernel needs Cin % 32 == 0 and Cout % 8 == 0")
    least = {"reflect": 2, "valid": 3}.get(border, 1)
    req(h >= least and w >= least and b > 0, CONV_NAME,
        f"the {border} border needs H, W >= {least}")
    req(b * h * w * max(ci, co) < 2 ** 31, CONV_NAME, "tensor too large")
    wk = laid_out(w8, x8.device, torch.int8, pack_weight if packed else kernel_weight)
    ho, wo = out_side(h, stride, border), out_side(w, stride, border)
    if packed:
        ctas = ctas or s8_ctas(b * ho * wo, co, sm_count(x8.device.index))
        scratch = scratch_shape(b, ho, wo, co, True, ctas)
        tiles = ctas
    else:
        scratch = scratch_shape(b, ho, wo, co, False)
        tiles = scratch[1]
    hb = torch.empty((b, ho, wo, co), device=x8.device, dtype=torch.bfloat16)
    part = torch.empty(scratch, device=x8.device, dtype=torch.float64)
    moments = torch.empty((b, 2, co), device=x8.device, dtype=torch.float64)
    req(_lib.aligned(x8, wk, hb), CONV_NAME, "tensors must be 16-byte aligned")
    err = _lib.library().nirgan_int8_conv(
        x8.device.index, x8.data_ptr(), wk.data_ptr(), hb.data_ptr(),
        part.data_ptr(), moments.data_ptr(), b, h, w, ci, co, tiles, int(packed),
        GATHERS[(border, stride)], _lib.stream_of(x8))
    _lib.check(err, CONV_NAME)
    return hb, moments


def conv_moments_cuda(x8: torch.Tensor, w8: torch.Tensor, border: str = "reflect",
                      stride: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch kernel D on contiguous int8 NHWC x8 on a card, the wgmma
    kernel where ``takes_wgmma`` (counted in output pixels): the arguments
    and results of ``conv_moments_plain``."""
    _lib.require(x8.dim() == 4, CONV_NAME, "x8 must be (B, H, W, C)")
    hw = out_side(x8.shape[1], stride, border) * out_side(x8.shape[2], stride, border)
    out = _launch(x8, w8, takes_wgmma(x8.shape[3], w8.shape[0], hw), border, stride)
    conv_moments_cuda.launches += 1
    key = (border, stride)
    conv_moments_cuda.by_gather[key] = conv_moments_cuda.by_gather.get(key, 0) + 1
    return out


conv_moments_cuda.launches = 0
conv_moments_cuda.by_gather = {}  # the launches by (border, stride)


def _routed_conv(x8, w8, border, stride):
    """``nirgan::int8_conv_moments``'s CPU and CUDA implementation."""
    fwd = conv_moments_cuda if _lib.route(x8, CONV_NAME) else conv_moments_plain
    return fwd(x8, w8, border, stride)


def _fake_conv(x8, w8, border, stride):
    _lib.route(x8, CONV_NAME)
    b, h, w, _ = x8.shape
    co = w8.shape[0]
    return (x8.new_empty((b, out_side(h, stride, border), out_side(w, stride, border), co),
                         dtype=torch.bfloat16),
            x8.new_empty((b, 2, co), dtype=torch.float64))


_registry.define("int8_conv_moments(Tensor x8, Tensor w8, str border, int stride) "
                 "-> (Tensor, Tensor)", _routed_conv, _fake_conv)


def conv_moments(x8: torch.Tensor, w8: torch.Tensor, border: str = "reflect",
                 stride: int = 1):
    """Kernel D on a card, its plain version on the CPU: the arguments and
    results of ``conv_moments_plain``."""
    return torch.ops.nirgan.int8_conv_moments(x8, w8, border, stride)


# ---------------------------------------------------------------- kernel E
def norm_from_moments(hb: torch.Tensor, moments: torch.Tensor,
                      eps_adj: torch.Tensor, count: Optional[int] = None) -> torch.Tensor:
    """``_norm_from_moments``: (hb - mean) * rsqrt(var + eps') in f32, with
    mean and var of each (image, channel) from the moments (D's f64, rounded
    to f32 first, as kernel E reads them) over ``count`` pixels: H W by
    default, the tile's where hb is one shard of an H-sharded tile and the
    moments are the tile's."""
    moments = moments.float()
    # a true division, as JAX's and kernel E's: torch divides a CUDA tensor
    # by a Python number through its reciprocal
    n = torch.full_like(moments[:, 0], count or hb.shape[1] * hb.shape[2])
    mean = moments[:, 0] / n
    var = moments[:, 1] / n - mean.square()
    rstd = torch.rsqrt(var + eps_adj)
    return (hb.float() - mean[:, None, None, :]) * rstd[:, None, None, :]


def quantize_plain(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Mode 0: the stream quantised, ``q8(x.f32 / s)``."""
    return q8(x.float() / s)


def norm_relu_quant_plain(hb: torch.Tensor, moments: torch.Tensor,
                          eps_adj: torch.Tensor, s_mid: torch.Tensor,
                          count: Optional[int] = None) -> torch.Tensor:
    """Mode 1, after conv1: ``q8(relu(norm) / s_mid)``, the norm kept in f32
    up to the division."""
    return q8(torch.relu(norm_from_moments(hb, moments, eps_adj, count)) / s_mid)


def norm_skip_quant_plain(hb: torch.Tensor, moments: torch.Tensor,
                          eps_adj: torch.Tensor, x: torch.Tensor,
                          s_next: Optional[torch.Tensor], count: Optional[int] = None):
    """Mode 2, after conv2: the stream ``x + norm.to(x.dtype)`` in x's dtype,
    and, where a next block exists (``s_next``), its quantised input
    ``q8(stream.f32 / s_next)``, else None."""
    out = x + norm_from_moments(hb, moments, eps_adj, count).to(x.dtype)
    return out, (quantize_plain(out, s_next) if s_next is not None else None)


def norm_relu_stream_quant_plain(hb: torch.Tensor, moments: torch.Tensor,
                                 eps_adj: torch.Tensor, s: torch.Tensor,
                                 dtype: torch.dtype, count: Optional[int] = None):
    """Mode 3, after stage 2's d1 conv: the stream ``relu(norm).to(dtype)``
    (``int8_d1_forward(...).astype(compute_dtype)``) and the trunk's first
    input ``q8(stream.f32 / s)``, quantised from the rounded stream."""
    out = torch.relu(norm_from_moments(hb, moments, eps_adj, count)).to(dtype)
    return out, quantize_plain(out, s)


def norm_quant_plain(mode: int, src: torch.Tensor, s: Optional[torch.Tensor],
                     moments: Optional[torch.Tensor] = None,
                     eps_adj: Optional[torch.Tensor] = None,
                     x: Optional[torch.Tensor] = None,
                     dtype: Optional[torch.dtype] = None,
                     count: Optional[int] = None):
    """Kernel E's plain version under the kernel wrapper's signature: mode 0
    ``quantize_plain``, 1 ``norm_relu_quant_plain``, 2
    ``norm_skip_quant_plain``, 3 ``norm_relu_stream_quant_plain``."""
    if mode == 0:
        return quantize_plain(src, s)
    if mode == 1:
        return norm_relu_quant_plain(src, moments, eps_adj, s, count)
    if mode == 3:
        return norm_relu_stream_quant_plain(src, moments, eps_adj, s, dtype, count)
    return norm_skip_quant_plain(src, moments, eps_adj, x, s, count)


NORM_THREADS = 256  # kernel E's most threads a block (THREADS in int8_norm.cu)
NORM_LOAD_BYTES = 64  # the bytes a thread of E loads for a pass of pixels (LOAD_BYTES)


def norm_rows(c: int) -> int:
    """The pixels a block of kernel E takes at once: its threads are C / 8
    channel groups by these rows."""
    return max(1, NORM_THREADS // (c // 8))


def norm_pass(mode: int, code: int) -> int:
    """The pixels a thread of E's instance for (mode, dtype code) takes in a
    pass: those of ``NORM_LOAD_BYTES`` loaded bytes, 16 a pixel of the bf16
    accumulator or stream (32 of an f32 stream in mode 0), plus the stream's
    16 or 32 in mode 2; at least 1."""
    src = 32 if mode == 0 and code == 0 else 16
    stream = (16 if code else 32) if mode == 2 else 0
    return max(1, NORM_LOAD_BYTES // (src + stream))


def norm_blocks(b: int, hw: int, c: int, slots: int, pass_pixels: int) -> int:
    """Kernel E's blocks an image: the card's ``slots`` (the blocks of the
    instance resident at once, blocks an SM times the SMs) shared among the
    B images, so that the grid is one wave (B blocks where B exceeds it),
    and no more than an image has passes of ``pass_pixels`` a thread."""
    return max(1, min(slots // b, -(-hw // (pass_pixels * norm_rows(c)))))


@functools.lru_cache(maxsize=None)
def norm_slots(device: int, mode: int, code: int, c: int) -> int:
    """The blocks of E's instance for (mode, dtype code) at C channels that
    the card holds at once: the occupancy query times the SMs."""
    per_sm = _lib.library().nirgan_int8_norm_blocks_per_sm(device, mode, code, c)
    _lib.require(per_sm > 0, NORM_NAME, f"no block of mode {mode} at C = {c} fits an SM "
                 f"({per_sm})")
    return per_sm * sm_count(device)


def _launch_norm(mode: int, src: torch.Tensor, s: Optional[torch.Tensor],
                 moments: Optional[torch.Tensor] = None,
                 eps_adj: Optional[torch.Tensor] = None,
                 x: Optional[torch.Tensor] = None,
                 dtype: Optional[torch.dtype] = None,
                 count: Optional[int] = None, blocks: Optional[int] = None):
    """One call of kernel E (``norm_quant_cuda``'s arguments and results) on
    ``blocks`` blocks an image, by default ``norm_blocks``' plan; the C
    entry refuses a plan it cannot take."""
    req = _lib.require
    req(mode in (0, 1, 2, 3), NORM_NAME, f"mode must be 0 to 3, got {mode}")
    req(src.is_cuda and src.dim() == 4 and src.is_contiguous(), NORM_NAME,
        "src must be a contiguous (B, H, W, C) CUDA tensor")
    b, h, w, c = src.shape
    req(c % 8 == 0 and c <= 2048 and b * h * w > 0, NORM_NAME,
        f"C = {c} must be a multiple of 8 and at most 2048")
    if mode == 0:
        code = _lib.dtype_code(src, NORM_NAME)
    else:
        req(src.dtype == torch.bfloat16, NORM_NAME, "the staged accumulator is bf16")
        req(moments is not None and moments.dtype == torch.float64
            and tuple(moments.shape) == (b, 2, c) and moments.is_contiguous()
            and eps_adj is not None and tuple(eps_adj.shape) == (c,), NORM_NAME,
            f"moments must be D's ({b}, 2, {c}) f64 and eps_adj ({c},)")
        code = 1
    if mode == 2:
        req(x is not None and x.shape == src.shape and x.is_contiguous(),
            NORM_NAME, "x must be a contiguous stream of src's shape")
        code = _lib.dtype_code(x, NORM_NAME)
    else:
        req(s is not None, NORM_NAME, f"mode {mode} needs a scale")
    if mode == 3:
        req(dtype in (torch.float32, torch.bfloat16), NORM_NAME,
            f"mode 3 writes an f32 or bf16 stream, not {dtype}")
        code = 1 if dtype == torch.bfloat16 else 0

    def f32(t):
        return None if t is None else t.to(device=src.device, dtype=torch.float32).contiguous()

    s32, eps32 = f32(s), f32(eps_adj)
    q = torch.empty(src.shape, device=src.device, dtype=torch.int8) if s is not None else None
    out = (torch.empty_like(x) if mode == 2 else
           torch.empty(src.shape, device=src.device, dtype=dtype) if mode == 3 else None)
    tensors = [t for t in (src, x, q, out) if t is not None]
    req(_lib.aligned(*tensors), NORM_NAME, "tensors must be 16-byte aligned")
    if blocks is None:
        blocks = norm_blocks(b, h * w, c, norm_slots(src.device.index, mode, code, c),
                             norm_pass(mode, code))

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = _lib.library().nirgan_int8_norm(
        src.device.index, mode, code, src.data_ptr(), ptr(moments), ptr(eps32),
        ptr(s32), ptr(x), ptr(out), ptr(q), b, h * w, c, int(count or h * w), blocks,
        _lib.stream_of(src))
    _lib.check(err, NORM_NAME)
    return (out, q) if mode in (2, 3) else q


def norm_quant_cuda(mode: int, src: torch.Tensor, s: Optional[torch.Tensor],
                    moments: Optional[torch.Tensor] = None,
                    eps_adj: Optional[torch.Tensor] = None,
                    x: Optional[torch.Tensor] = None,
                    dtype: Optional[torch.dtype] = None,
                    count: Optional[int] = None):
    """Launch kernel E in ``mode`` (0 to 3) on a card.  ``src``: the
    stream (mode 0, bf16 or f32) or the staged bf16 accumulator (modes 1 to
    3), contiguous NHWC; ``s``: the (C,) scale the quantised output is
    divided by (None in mode 2 after the last block); ``moments`` (B, 2, C)
    and ``eps_adj`` (C,) f32 in modes 1 to 3; ``x`` the stream the skip
    adds to, in mode 2; ``dtype`` the stream's (bf16 or f32) in mode 3;
    ``count`` the pixels the moments sum over (H W by default).  Returns the
    int8 output (mode 0, 1) or (stream, int8 or None) (modes 2, 3)."""
    out = _launch_norm(mode, src, s, moments, eps_adj, x, dtype, count)
    norm_quant_cuda.launches += 1
    norm_quant_cuda.by_mode[mode] = norm_quant_cuda.by_mode.get(mode, 0) + 1
    return out


norm_quant_cuda.launches = 0
norm_quant_cuda.by_mode = {}  # the launches by mode


def _routed_norm(mode, src, s, moments, eps_adj, x, dtype, count=None):
    """``nirgan::int8_norm_quant``'s CPU and CUDA implementation: (stream,
    int8) in every mode, the stream None in modes 0 and 1."""
    fwd = norm_quant_cuda if _lib.route(src, NORM_NAME) else norm_quant_plain
    out = fwd(mode, src, s, moments, eps_adj, x, dtype, count)
    return out if mode in (2, 3) else (None, out)


def _fake_norm(mode, src, s, moments, eps_adj, x, dtype, count=None):
    _lib.route(src, NORM_NAME)
    q = src.new_empty(src.shape, dtype=torch.int8) if s is not None else None
    if mode == 2:
        return x.new_empty(x.shape), q
    if mode == 3:
        return src.new_empty(src.shape, dtype=dtype), q
    return None, q


_registry.define("int8_norm_quant(int mode, Tensor src, Tensor? s, Tensor? moments, "
                 "Tensor? eps_adj, Tensor? x, ScalarType? dtype, int? count=None) "
                 "-> (Tensor?, Tensor?)",
                 _routed_norm, _fake_norm)


def norm_quant(mode: int, src: torch.Tensor, s: Optional[torch.Tensor],
               moments: Optional[torch.Tensor] = None,
               eps_adj: Optional[torch.Tensor] = None,
               x: Optional[torch.Tensor] = None,
               dtype: Optional[torch.dtype] = None,
               count: Optional[int] = None):
    """Kernel E on a card, its plain version on the CPU (the arguments and
    results of ``norm_quant_cuda``)."""
    out, q = torch.ops.nirgan.int8_norm_quant(mode, src, s, moments, eps_adj, x, dtype,
                                              count)
    return (out, q) if mode in (2, 3) else q


# ------------------------------------------------------------------ trunk
def int8_d1_forward(x: torch.Tensor, qd1: dict, s_next: torch.Tensor,
                    dtype: Optional[torch.dtype] = None, shard=None,
                    count: Optional[int] = None) -> tuple:
    """Stage 2 (``int8_d1_forward``): the d1 downsample conv (3x3, stride
    2, zero border, 2 ngf -> 4 ngf) with its affine-free norm and ReLU in
    accumulator units.  x (B, H, W, 2 ngf) is the ReLU'd stream after
    ``nd0``; returns (the stream (B, (H - 1) // 2 + 1, ..., 4 ngf) in
    ``dtype``, x's by default, and its quantisation by ``s_next``, the
    trunk's first input).  Three launches: E (mode 0) quantises x by
    ``qd1["s_in"]``, D convolves at stride 2, E (mode 3) ends it.  On one
    shard of an H-sharded tile (``shard``, ``parallel/spatial.Shard``) D
    runs VALID at stride 2 on the shard's slab, the moments are the tile's
    (the shards' exact sums added in shard order) and E divides by the
    tile's ``count`` pixels."""
    x = x.contiguous()
    x8 = norm_quant(0, x, qd1["s_in"])
    if shard is None:
        hb, m = conv_moments(x8, qd1["w"], "zero", 2)
    else:
        hb, m = conv_moments(shard.down_slab(x8), qd1["w"], "valid", 2)
        m = shard.add(m)
    return norm_quant(3, hb, s_next, m, qd1["eps"], dtype=dtype or x.dtype, count=count)


def int8_trunk_forward(x: torch.Tensor, pack: dict, padding_type: str = "reflect",
                       x8: Optional[torch.Tensor] = None, shard=None,
                       count: Optional[int] = None) -> torch.Tensor:
    """The residual trunk in int8 (``int8_trunk_forward``): x (B, H, W, C)
    the float stream after ``nd1`` (or stage 2's d1), each conv with the
    trunk's ``padding_type`` border; returns the stream after the last
    block, in x's dtype.  A forward is one launch of E to quantise the input
    (none where ``x8``, that quantisation, is given), then per block D, E
    (mode 1), D, E (mode 2): 2n launches of D, 2n + 1 of E.  On one shard
    of an H-sharded tile (``shard``) each D runs VALID on the shard's slab
    (one halo row each side, the border at the tile's edges and columns),
    the moments are the tile's (the shards' exact sums added) and E divides
    by its ``count`` pixels."""
    n_blocks = len(pack["w1"])
    x = x.contiguous()
    if x8 is None:
        x8 = norm_quant(0, x, pack["s_in"][0])

    def conv(v8, w8):
        if shard is None:
            return conv_moments(v8, w8, padding_type)
        hb, m = conv_moments(shard.slab(v8, 1, 1, padding_type, 1), w8, "valid")
        return hb, shard.add(m)

    for i in range(n_blocks):
        hb, m = conv(x8, pack["w1"][i])
        h8 = norm_quant(1, hb, pack["s_mid"][i], m, pack["eps1"][i], count=count)
        hb, m = conv(h8, pack["w2"][i])
        s_next = pack["s_in"][i + 1] if i + 1 < n_blocks else None
        x, x8 = norm_quant(2, hb, s_next, m, pack["eps2"][i], x, count=count)
    return x
