"""The one content generator: a pool of 4:2:0 8-bit frames from a seed and
a traffic file's parameters (hevc_bench/traffic/<name>.json).

A frame is a crop of a periodic canvas of 1/f amplitude spectrum (natural
images fall off so), moved by a global pan at quarter-sample positions (a
phase ramp on the canvas's spectrum: an exact band-limited shift, with no
blur that would come and go with the fraction), with textured elliptical
objects pasted over it at integer positions, each moving at its own
velocity and bouncing off the picture's edges, and fresh Gaussian noise on
every frame. Every motion is one of the 8 mirror images of a 30-degree
heading (both components move) at a speed from a fixed set; the seed
draws which, the phase of the speeds, the positions, the textures and
the noise, so every seed makes the same amount of motion.

Parameters (all required):
  pool_frames    frames in the pool (played forward, then backward)
  canvas_scale   canvas side over picture side (new content at the edges)
  luma_std, chroma_std   contrast of the canvases
  pan_speeds     samples per frame, taken in turn from a phase the seed
                 draws
  objects, object_area   count and picture share of each object
  object_speeds  samples per frame, one per object in a permutation the
                 seed draws
  noise_sigma    Gaussian noise per sample, in levels of the 8-bit range
"""
from __future__ import annotations

import math

import numpy as np
import torch

KEYS = ("pool_frames", "canvas_scale", "luma_std", "chroma_std",
        "pan_speeds", "objects", "object_area", "object_speeds",
        "noise_sigma")


def _one_over_f(gen, h, w, std, device):
    """An (h, w) periodic float32 texture of 1/f amplitude spectrum, zero
    mean, standard deviation `std`. Only the phases are random: every
    seed's texture has the same spectrum, so the same detail to code."""
    noise = torch.randn((h, w), generator=gen, device=device)
    spec = torch.fft.rfft2(noise)
    fy = torch.fft.fftfreq(h, device=device)[:, None]
    fx = torch.fft.rfftfreq(w, device=device)[None, :]
    f = torch.sqrt(fy * fy + fx * fx)
    spec = spec / spec.abs().clamp_min(1e-12) / (f + 1.0 / max(h, w))
    spec[0, 0] = 0
    t = torch.fft.irfft2(spec, s=(h, w))
    return t * (std / t.std())


def _shifter(canvas):
    """A function (sy, sx) -> the canvas moved so that its sample
    (y + sy, x + sx) lands at (y, x), for any real shift."""
    h, w = canvas.shape
    spec = torch.fft.rfft2(canvas)
    ky = torch.fft.fftfreq(h, device=canvas.device)[:, None]
    kx = torch.fft.rfftfreq(w, device=canvas.device)[None, :]

    def at(sy, sx):
        ramp = torch.exp(2j * math.pi * (ky * sy + kx * sx))
        return torch.fft.irfft2(spec * ramp, s=(h, w))
    return at


def _bounce(x0, v, t, span):
    """Position at frame t of a point starting at x0 with velocity v,
    reflected inside [0, span]."""
    if span <= 0:
        return 0
    p = (x0 + v * t) % (2 * span)
    return int(p if p <= span else 2 * span - p)


def _heading(rng) -> np.ndarray:
    """(dy, dx) of unit length: one of the 8 mirror images of a 30-degree
    heading, so that both components move."""
    d = np.array([0.5, math.sqrt(3) / 2])
    if rng.integers(2):
        d = d[::-1]
    return d * rng.choice([-1.0, 1.0], size=2)


def make_pool(params: dict, width: int, height: int, seed: int,
              device) -> list:
    """The pool's frames, each [y, cb, cr] int16 numpy planes of 8-bit
    samples, made on `device` from `seed`."""
    missing = [k for k in KEYS if k not in params]
    if missing:
        raise ValueError(f"traffic parameters missing: {missing}")
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    rng = np.random.default_rng(seed)
    n = int(params["pool_frames"])
    hc = int(round(height * params["canvas_scale"])) // 2 * 2
    wc = int(round(width * params["canvas_scale"])) // 2 * 2
    luma = _shifter(_one_over_f(gen, hc, wc, params["luma_std"], device))
    chroma = [_shifter(_one_over_f(gen, hc // 2, wc // 2,
                                   params["chroma_std"], device))
              for _ in range(2)]

    # the pan: the speeds in turn from a phase the seed draws, along one
    # of the 8 mirror images of a 30-degree heading, so that every seed
    # pans alike over any few frames
    speeds = np.asarray(params["pan_speeds"], float)
    speeds = np.roll(speeds, -int(rng.integers(len(speeds))))
    speeds = np.resize(speeds, n - 1)
    steps = np.round(4 * speeds[:, None] * _heading(rng)) / 4
    pos = np.vstack([[0.0, 0.0], np.cumsum(steps, 0)])
    pos += rng.uniform(0, [hc, wc])

    objects = []
    area = params["object_area"] * width * height
    obj_speeds = rng.permutation(np.asarray(params["object_speeds"], float))
    for i in range(int(params["objects"])):
        b = max(2, int(math.sqrt(area / (math.pi * 1.5))))
        a = max(2, int(1.5 * b))
        b, a = min(b, height // 2 - 1), min(a, width // 2 - 1)
        yy = torch.arange(2 * b + 1, device=device)[:, None] - b
        xx = torch.arange(2 * a + 1, device=device)[None, :] - a
        mask = (yy / b) ** 2 + (xx / a) ** 2 <= 1
        tex = _one_over_f(gen, 2 * b + 1, 2 * a + 1, params["luma_std"],
                          device)
        tex = tex + float(rng.choice([-35, 35]))
        vy, vx = np.round(obj_speeds[i % len(obj_speeds)] * _heading(rng))
        objects.append(dict(
            mask=mask, tex=tex, h=2 * b + 1, w=2 * a + 1,
            y0=rng.uniform(0, height - 2 * b - 1),
            x0=rng.uniform(0, width - 2 * a - 1),
            vy=int(vy), vx=int(vx),
            cb=float(rng.uniform(-30, 30)), cr=float(rng.uniform(-30, 30))))

    sigma = float(params["noise_sigma"])
    frames = []
    for t in range(n):
        sy, sx = pos[t]
        y = luma(sy, sx)[:height, :width] + 128
        cb = chroma[0](sy / 2, sx / 2)[:height // 2, :width // 2] + 128
        cr = chroma[1](sy / 2, sx / 2)[:height // 2, :width // 2] + 128
        for o in objects:
            oy = _bounce(o["y0"], o["vy"], t, height - o["h"])
            ox = _bounce(o["x0"], o["vx"], t, width - o["w"])
            reg = y[oy:oy + o["h"], ox:ox + o["w"]]
            reg[:] = torch.where(o["mask"], o["tex"] + 128, reg)
            cm = o["mask"][::2, ::2]
            cy, cx = oy // 2, ox // 2
            for plane, off in ((cb, o["cb"]), (cr, o["cr"])):
                reg = plane[cy:cy + cm.shape[0], cx:cx + cm.shape[1]]
                cmask = cm[:reg.shape[0], :reg.shape[1]]
                reg[:] = torch.where(cmask, torch.full_like(reg, 128 + off),
                                     reg)
        planes = []
        for p in (y, cb, cr):
            if sigma:
                p = p + sigma * torch.randn(p.shape, generator=gen,
                                            device=device)
            planes.append(p.round().clamp(0, 255).to(torch.int16))
        frames.append(planes)
    return [[p.cpu().numpy() for p in f] for f in frames]


def play_order(pool_len: int, count: int, start: int = 0) -> list:
    """Pool indices of `count` frames played forward, then backward, from
    position `start` of that cycle: 0, 1, ..., n-1, n-2, ..., 1, 0, 1, ..."""
    cycle = list(range(pool_len)) + list(range(pool_len - 2, 0, -1))
    return [cycle[(start + i) % len(cycle)] for i in range(count)]
