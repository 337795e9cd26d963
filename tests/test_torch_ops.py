"""The port's plain ops against the JAX package's, in f32 on the CPU, with
the same seeded numpy inputs: reflect padding and its adjoint, conv and
transposed conv, the matrix-form bilinear resize and skimage-exact
histogram matching."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nirgan_tpu.inference.histogram import histogram_match as jax_histogram_match
from nirgan_tpu.ops.conv import conv2d as jax_conv2d
from nirgan_tpu.ops.conv import conv_transpose2d as jax_conv_transpose2d
from nirgan_tpu.ops.pad import reflect_pad2d as jax_reflect_pad2d
from nirgan_tpu.ops.resize import resize_bilinear as jax_resize_bilinear
from nirgan_tpu_torch.inference.histogram import histogram_match
from nirgan_tpu_torch.ops.conv import conv2d, conv_transpose2d
from nirgan_tpu_torch.ops.initializers import get_initializer
from nirgan_tpu_torch.ops.pad import reflect_pad2d, reflect_pad2d_adjoint, reflect_pad_to
from nirgan_tpu_torch.ops.resize import resize_bilinear
from tests.test_inference import _skimage_match_cumulative_cdf


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("pad", [1, 3, 10])
def test_reflect_pad2d_matches_jax(pad):
    x = np.random.default_rng(pad).standard_normal((2, 13, 17, 3)).astype(np.float32)
    got = reflect_pad2d(_t(x), pad)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jax_reflect_pad2d(jnp.asarray(x), pad)))
    assert got.is_contiguous()


@pytest.mark.parametrize("pad", [1, 3, 10])
def test_reflect_pad2d_adjoint_matches_jax_vjp(pad):
    """The trunk conv's backward folds the padded cotangent back with it:
    against jax.vjp of the JAX reflect pad; a corner entry sums up to four
    terms in another order, so atol 1e-6."""
    rng = np.random.default_rng(pad)
    x = rng.standard_normal((2, 13, 17, 3)).astype(np.float32)
    g = rng.standard_normal((2, 13 + 2 * pad, 17 + 2 * pad, 3)).astype(np.float32)
    _, vjp = jax.vjp(lambda a: jax_reflect_pad2d(a, pad), jnp.asarray(x))
    ref = np.asarray(vjp(jnp.asarray(g))[0])
    got = reflect_pad2d_adjoint(_t(g), pad)
    assert tuple(got.shape) == x.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("hw,size", [((50, 60), 64), ((64, 64), 256),
                                     ((3, 7), 20)])
def test_reflect_pad_to_matches_jnp_pad(hw, size):
    """Bucket padding, incl. pads longer than the side (64 -> 256), where
    jnp.pad reflects repeatedly."""
    h, w = hw
    x = np.random.default_rng(0).standard_normal((1, h, w, 3)).astype(np.float32)
    ref = jnp.pad(jnp.asarray(x), ((0, 0), (0, size - h), (0, size - w), (0, 0)),
                  mode="reflect")
    np.testing.assert_array_equal(reflect_pad_to(_t(x), size, size).numpy(),
                                  np.asarray(ref))


@pytest.mark.parametrize("k,stride,padding", [(7, 1, 0), (3, 2, 1), (3, 1, 1)])
def test_conv2d_matches_jax(k, stride, padding):
    rng = np.random.default_rng(k + stride)
    x = rng.standard_normal((2, 15, 12, 6)).astype(np.float32)
    w = (0.1 * rng.standard_normal((k, k, 6, 5))).astype(np.float32)
    b = rng.standard_normal(5).astype(np.float32)
    ref = jax_conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), stride, padding)
    got = conv2d(_t(x), _t(w.transpose(3, 2, 0, 1)), _t(b), stride, padding)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=2e-5)


@pytest.mark.parametrize("h,w", [(8, 8), (7, 10)])
def test_conv_transpose2d_exact_2x_matches_jax(h, w):
    rng = np.random.default_rng(h * w)
    x = rng.standard_normal((2, h, w, 8)).astype(np.float32)
    k = (0.1 * rng.standard_normal((3, 3, 8, 4))).astype(np.float32)
    b = rng.standard_normal(4).astype(np.float32)
    ref = np.asarray(jax_conv_transpose2d(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b)))
    # JAX (kh, kw, Cin, Cout) -> torch (Cin, Cout, kh, kw), no flip
    got = conv_transpose2d(_t(x), _t(k.transpose(2, 3, 0, 1)), _t(b)).numpy()
    assert got.shape == (2, 2 * h, 2 * w, 4)
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5)


@pytest.mark.parametrize("shape,out", [((2, 16, 16, 1), (64, 64)),
                                       ((1, 64, 64, 1), (50, 60)),
                                       ((1, 9, 7, 2), (9, 21))])
def test_resize_bilinear_matches_jax(shape, out):
    x = np.random.default_rng(1).random(shape, dtype=np.float32)
    ref = jax_resize_bilinear(jnp.asarray(x), *out)
    got = resize_bilinear(_t(x), *out)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-6)


def _hist_cases():
    rng = np.random.default_rng(0)
    cases = []
    for q in (None, 1e-4, 1 / 255):  # continuous, DN-quantised, heavy ties
        src = rng.uniform(0, 1, (2, 32, 32, 1)).astype(np.float32)
        ref = rng.beta(2, 5, (2, 32, 32, 1)).astype(np.float32)
        if q is not None:
            src = (np.round(src / q) * q).astype(np.float32)
            ref = (np.round(ref / q) * q).astype(np.float32)
        cases.append((src, ref))
    cases.append((rng.uniform(0, 1, (2, 40, 40, 1)).astype(np.float32),
                  rng.uniform(0, 1, (2, 10, 10, 1)).astype(np.float32)))
    return cases


@pytest.mark.parametrize("case", range(4))
def test_histogram_match_matches_jax_and_skimage(case):
    """Batched torch matcher vs the JAX one and the skimage transcription,
    incl. heavy ties and a reference of another size: f32 rounding only."""
    src, ref = _hist_cases()[case]
    got = histogram_match(_t(src), _t(ref)).numpy()
    jax_out = np.asarray(jax_histogram_match(jnp.asarray(src), jnp.asarray(ref)))
    np.testing.assert_allclose(got, jax_out, rtol=0, atol=1e-6)
    for b in range(src.shape[0]):
        oracle = _skimage_match_cumulative_cdf(src[b, ..., 0], ref[b, ..., 0])
        np.testing.assert_allclose(got[b, ..., 0], oracle, rtol=0, atol=1e-6)


def test_normal_initializer_is_seeded_and_device_independent():
    init = get_initializer("normal", 0.02)
    a = init(torch.empty(64, 32, 3, 3), torch.Generator().manual_seed(5))
    b = init(torch.empty(64, 32, 3, 3), torch.Generator().manual_seed(5))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert abs(float(a.std()) - 0.02) < 1e-3 and abs(float(a.mean())) < 1e-3
    # xavier, kaiming and orthogonal are ported (tests/test_torch_variants.py);
    # an unknown name is refused
    assert get_initializer("xavier") is not None
    with pytest.raises(NotImplementedError):
        get_initializer("uniform")


def test_resize_matrix_kept_from_inference_mode_serves_autograd():
    """A resize matrix is kept for its device.  One first made while serving
    under ``torch.inference_mode`` must still be usable in a train step's
    graph (an inference tensor cannot be saved for backward)."""
    from nirgan_tpu_torch.ops import resize

    resize._on_device.cache_clear()
    x = torch.randn(1, 6, 6, 1)
    with torch.inference_mode():
        served = resize.resize_bilinear(x, 9, 9)
        resize.resize_bicubic(x, 9, 9)
    xg = x.clone().requires_grad_(True)
    y = resize.resize_bilinear(xg, 9, 9)
    resize.resize_bicubic(xg, 9, 9).sum().backward()
    y.sum().backward()
    torch.testing.assert_close(y.detach(), served, rtol=0, atol=0)
    assert xg.grad is not None and bool(torch.isfinite(xg.grad).all())


# the trunk backward's adjoint kernel (csrc/reflect_pad.cu): its terms, in
# the order its source adds them
_ADJOINT_SOURCE = Path(__file__).resolve().parent.parent / "nirgan_tpu_torch/csrc/reflect_pad.cu"
_EDGES = {"TOP": ("i", 1), "BOTTOM": ("i", -2), "LEFT": ("j", 1), "RIGHT": ("j", -2)}


def _adjoint_terms() -> list:
    """[(edges, rows, cols)]: each mirror term of the adjoint kernel, the
    edges an element must lie on to take it and the term's offset from the
    element's own cotangent in padded rows and columns."""
    src = _ADJOINT_SOURCE.read_text()
    terms = []
    for cond, off in re.findall(r"if \(([^;]*?)\) a\.add\(__ldg\(s ([^)]*)\)\);", src):
        edges = re.findall(r"e & (TOP|BOTTOM|LEFT|RIGHT)", cond)
        rows = cols = 0
        for sign, what in re.findall(r"([-+]) (rows2|cols2)", off):
            step = 2 if sign == "+" else -2
            rows, cols = (rows + step, cols) if what == "rows2" else (rows, cols + step)
        terms.append((edges, rows, cols))
    return terms


def _gather_adjoint(g: torch.Tensor) -> torch.Tensor:
    """The adjoint kernel's arithmetic on the CPU: every element of dx
    starts from its own cotangent and adds, term by term in the source's
    order, each mirror term its position takes, rounding each sum to g's
    dtype as the kernel does."""
    b, hp, wp, c = g.shape
    h, w = hp - 2, wp - 2
    i = torch.arange(h).view(h, 1).expand(h, w)
    j = torch.arange(w).view(1, w).expand(h, w)
    pos = {"i": i, "j": j}
    side = {"i": h, "j": w}

    def at(dr, dc):
        return g[:, (i + 1 + dr).clamp(0, hp - 1), (j + 1 + dc).clamp(0, wp - 1)]

    v = at(0, 0).clone()
    for edges, dr, dc in _adjoint_terms():
        mask = torch.ones(h, w, dtype=torch.bool)
        for e in edges:
            axis, k = _EDGES[e]
            mask &= pos[axis] == (k if k > 0 else side[axis] + k)
        v = torch.where(mask[None, :, :, None], v + at(dr, dc), v)
    return v


def test_adjoint_kernel_source_states_the_plain_order():
    """The source adds the top, bottom, left and right mirrors, then the
    corners top-left, top-right, bottom-left, bottom-right: the plain
    version's order."""
    assert _adjoint_terms() == [
        (["TOP"], -2, 0), (["BOTTOM"], 2, 0), (["LEFT"], 0, -2), (["RIGHT"], 0, 2),
        (["TOP", "LEFT"], -2, -2), (["TOP", "RIGHT"], -2, 2),
        (["BOTTOM", "LEFT"], 2, -2), (["BOTTOM", "RIGHT"], 2, 2)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float16],
                         ids=["bf16", "f32", "f16"])
@pytest.mark.parametrize("shape", [(2, 2, 2, 8), (1, 3, 3, 16), (2, 2, 5, 8), (1, 3, 7, 4),
                                   (3, 13, 15, 8), (1, 9, 2, 24), (2, 6, 3, 8)])
@pytest.mark.parametrize("seed", range(3))
def test_adjoint_gather_equals_reflect_pad2d_adjoint(dtype, shape, seed):
    """The kernel's per-element gather (index map and order of additions
    as ``csrc/reflect_pad.cu`` states them) equals ``reflect_pad2d_adjoint``
    at pad 1 bit for bit, in bf16, f32 and f16, H and W down to 2 and 3 (where a
    row or column takes both of its side's mirrors).  Wide values make
    every rounding count."""
    b, h, w, c = shape
    gen = torch.Generator().manual_seed(seed)
    g = (torch.randn((b, h + 2, w + 2, c), generator=gen)
         * torch.exp2(torch.randint(-8, 9, (b, h + 2, w + 2, c), generator=gen))).to(dtype)
    want = reflect_pad2d_adjoint(g, 1)
    got = _gather_adjoint(g)
    assert got.dtype == want.dtype and torch.equal(got, want)
