"""Inter-picture overlap in the port (EncoderConfig.frame_overlap): the
dependent pictures of a low-delay chain encode concurrently, each row of
a picture waiting on its references' published rows, and each picture's
CTU rows shared among its own row threads. The bytes must not depend on
how many pictures are in flight, nor on how the rows fell to threads."""
import hashlib

import numpy as np

from turingcodec_tpu_torch.encode.encoder import Encoder, EncoderConfig


def _frames(w, h, n):
    """n 4:2:0 frames: a textured picture panning by (2, 3) samples a
    frame, with noise, and noisy chroma."""
    rng = np.random.default_rng(5)
    base = rng.integers(0, 256, (h, w))
    out = []
    for i in range(n):
        y = np.roll(base, (2 * i, 3 * i), (0, 1)) \
            + rng.integers(-4, 5, (h, w))
        c = rng.integers(100, 156, (2, h // 2, w // 2))
        out.append([np.clip(y, 0, 255).astype(np.int16),
                    c[0].astype(np.int16), c[1].astype(np.int16)])
    return out


def _encode(monkeypatch, frames, in_flight):
    monkeypatch.setenv("TURING_TPU_FRAME_THREADS", str(in_flight))
    monkeypatch.setenv("TURING_TPU_ENC_THREADS", "4")
    enc = Encoder(EncoderConfig(width=192, height=192, ctb_log2=5, qp=32,
                                rd_candidates=1, search_range=32, gop_m=1,
                                sao=False, frame_overlap=True, device=None))
    assert enc._overlap_on()
    out = [enc.headers()]
    for f in frames:
        out += [nal for (_i, nal, _r) in enc.push_frame(
            [p.copy() for p in f])]
    out += [nal for (_i, nal, _r) in enc.flush()]
    return hashlib.md5(b"".join(out)).hexdigest()


def test_overlap_in_flight_invariance(monkeypatch):
    """1 and 4 pictures in flight (4 and 2 row threads a picture, over 6
    CTU rows) give the same bytes."""
    frames = _frames(192, 192, 6)
    assert _encode(monkeypatch, frames, 4) == _encode(monkeypatch, frames, 1)
