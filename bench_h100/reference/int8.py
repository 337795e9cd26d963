"""Plain integer serving trunk, after the program's stated semantics
(``tpu.serving_quant: int8``): calibrated once on the first 16 rows served,
each residual block's input and inner activation quantised per channel by
``absmax * 1.2 / 127`` of a float forward (a channel dead on the batch
floored at 1e-3 of the largest scale), each conv weight folded with its
input's scales and quantised per output channel, the conv exact in
integers with the trunk's reflect border, its affine-free norm over the
accumulator with eps in accumulator units (eps / k^2), the ReLU, the skip
added in float.  ``bits`` 8 is the configuration's; 4 is the control."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from bench_h100.reference import pix2pix

MARGIN = 1.2
CALIB_ROWS = 16


def calibrate(p: dict, x: torch.Tensor, cfg: dict, bits: int = 8, embeds=None) -> dict:
    """Per-channel scales {"in": [(C,)] * n, "mid": [(C,)] * n} from the
    padded float forward of ``x`` (reflectance, NCHW, its first 16 rows)."""
    top = 2 ** (bits - 1) - 1
    taps: dict = {}

    def record(q, h):
        return pix2pix.blocks(q, h, cfg, taps=taps)

    x = x[:CALIB_ROWS]
    pad = pix2pix.pad_amount(cfg)
    with torch.no_grad():
        pix2pix.generator(p, F.pad(x, (pad,) * 4, mode="reflect") if pad else x, cfg,
                          embeds=None if embeds is None else embeds[:CALIB_ROWS],
                          trunk=record)

    def scale(t):
        v = t.abs().amax(dim=(0, 2, 3)) * (MARGIN / top)
        return v.clamp(min=max(float(v.max()) * 1e-3, 1e-12))

    n = pix2pix.n_blocks(cfg)
    return {"in": [scale(taps[f"in{b}"]) for b in range(n)],
            "mid": [scale(taps[f"mid{b}"]) for b in range(n)], "bits": bits}


def _q(v: torch.Tensor, bits: int) -> torch.Tensor:
    top = 2 ** (bits - 1) - 1
    return torch.clamp(torch.round(v), -top, top)


def _conv_norm(x_q: torch.Tensor, w: torch.Tensor, s_in: torch.Tensor,
               bits: int) -> torch.Tensor:
    """The folded, quantised conv of the quantised input, exact in float64,
    and its affine-free norm with eps in accumulator units."""
    top = 2 ** (bits - 1) - 1
    wf = w.double() * s_in.double()[None, :, None, None]
    k = (wf.abs().amax(dim=(1, 2, 3)) / top).clamp(min=1e-12)
    w_q = _q(wf / k[:, None, None, None], bits)
    acc = F.conv2d(F.pad(x_q, (1, 1, 1, 1), mode="reflect"), w_q)
    mean = acc.mean(dim=(2, 3), keepdim=True)
    var = acc.square().mean(dim=(2, 3), keepdim=True) - mean.square()
    eps = (pix2pix.IN_EPS / k.square())[None, :, None, None]
    return (acc - mean) * torch.rsqrt(var + eps)


def trunk(scales: dict):
    """``trunk(p, h)`` for ``pix2pix.generator``: the quantised blocks."""
    bits = scales["bits"]

    def run(p: dict, h: torch.Tensor) -> torch.Tensor:
        h = h.double()
        for b, (s_in, s_mid) in enumerate(zip(scales["in"], scales["mid"])):
            x_q = _q(h / s_in.double()[None, :, None, None], bits)
            t = torch.relu(_conv_norm(x_q, p[f"r{b}.conv1.weight"], s_in, bits))
            t_q = _q(t / s_mid.double()[None, :, None, None], bits)
            h = h + _conv_norm(t_q, p[f"r{b}.conv2.weight"], s_mid, bits)
        return h.float()

    return run
