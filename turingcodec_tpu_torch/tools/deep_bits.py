"""CLI: the decoder's device pipeline on deep (13..16-bit) inter streams.

Builds a stream from a seed, with no file: three 128x96 frames of seeded
noise (as tests/test_torch_encode.py makes them) shifted left to the bit
depth, encoded on the host path (device=None) at QP 32 with RDOQ and SDH,
low delay with one reference (gop_m=1). At 13 bits the stream is 17266
bytes, and the JAX package's device pipeline (TURING_TPU_DEVICE_PIPELINE=1,
JAX on the CPU) decodes it with 0 hash failures to planes whose md5 over
int32 samples is JAX_MD5_13, equal to both packages' host decoders
(tests/test_torch_deep_bits.py recomputes it through JAX). The pipeline's
first inter picture takes the MC and residual kernels at 13 bits, every
picture the deblocking kernel. At 14 and 16 bits the reference pipeline
raises ValueError("negative shift count") from
decode/device_recon.py::_combine_uni_bi (the shift 14 - bd), and the
port raises the same error from its twin (ops/inter.py, which mc_picture
checks the depths through).

Usage: python -m turingcodec_tpu_torch.tools.deep_bits
           [--device {cuda,cpu}]

Any failed check raises.
"""
from __future__ import annotations

import argparse
import hashlib
import sys

import numpy as np

from turingcodec_tpu_torch.tools.device_enc_check import check

JAX_MD5_13 = "0290cca115dfa625414e6b6bea5acd8a"
CFG = dict(width=128, height=96, qp=32, gop_m=1, sao=False, rdoq=True,
           sdh=True, rd_candidates=2)


def frames(bd: int, n: int = 3, seed: int = 11) -> list:
    """n frames of [Y, Cb, Cr] int16 planes at bit depth bd: 8-bit seeded
    noise shifted left by bd - 8 (above 15 bits the int16 samples wrap, as
    the encoder holds them)."""
    w, h = CFG["width"], CFG["height"]
    rng = np.random.RandomState(seed)
    base = (rng.randint(0, 256, (h + 16, w + 16)).astype(np.int64)
            << (bd - 8)).astype(np.uint16).view(np.int16)
    return [[np.ascontiguousarray(base[i:i + h, i * 2:i * 2 + w]),
             np.ascontiguousarray(base[:h // 2, :w // 2]),
             np.ascontiguousarray(base[8:8 + h // 2, :w // 2])]
            for i in range(n)]


def stream(bd: int) -> bytes:
    """The bd-bit stream of `frames(bd)`, encoded on the host path."""
    from turingcodec_tpu_torch.encode.encoder import Encoder, EncoderConfig
    enc = Encoder(EncoderConfig(**CFG, bit_depth=bd, device=None))
    out = [enc.headers()]
    for f in frames(bd):
        out += [nal for (_i, nal, _r) in enc.push_frame(
            [p.copy() for p in f])]
    out += [nal for (_i, nal, _r) in enc.flush()]
    return b"".join(out)


def planes_md5(decoded) -> str:
    """md5 over every decoded picture's planes as int32 samples."""
    md5 = hashlib.md5()
    for f in decoded:
        for p in f.planes:
            md5.update(np.ascontiguousarray(p, np.int32).tobytes())
    return md5.hexdigest()


def decode(data: bytes, device):
    """(md5, pictures, hash failures, pictures through the pipeline)."""
    import turingcodec_tpu_torch.decode.device_pipeline as dp
    from turingcodec_tpu_torch.decode.decoder import Decoder
    dec = Decoder(device=device)
    before = dp.pictures
    got = list(dec.decode_stream(data))
    return planes_md5(got), len(got), dec.hash_failures, dp.pictures - before


def check_13(device, log=print) -> None:
    """The 13-bit stream through the pipeline on `device`: JAX_MD5_13, 0
    hash failures, every picture through the pipeline."""
    md5, n, fails, piped = decode(stream(13), device)
    check(md5 == JAX_MD5_13 and n == piped == 3 and fails == 0,
          f"13-bit decode on {device}: md5 {md5}, {n} pictures, {piped} "
          f"through the pipeline, {fails} hash failures; the JAX "
          f"pipeline gives {JAX_MD5_13} over 3, 0 failures")
    log(f"13-bit stream on {device}: md5 {md5} equal to the JAX "
        f"pipeline's, 3 pictures through the pipeline, 0 hash failures")


def check_raises(device, log=print) -> None:
    """The 14- and 16-bit streams on `device` raise the reference's
    ValueError("negative shift count") from _combine_uni_bi."""
    for bd in (14, 16):
        try:
            decode(stream(bd), device)
        except ValueError as e:
            check(str(e) == "negative shift count"
                  and raised_in(e) == "_combine_uni_bi",
                  f"{bd}-bit decode raised {e!r} from {raised_in(e)}")
        else:
            check(False, f"{bd}-bit decode on {device} did not raise")
        log(f"{bd}-bit stream on {device}: ValueError('negative shift "
            f"count') from _combine_uni_bi, as the reference raises")


def raised_in(exc) -> str:
    """The name of the function an exception was raised in."""
    tb = exc.__traceback__
    while tb.tb_next is not None:
        tb = tb.tb_next
    return tb.tb_frame.f_code.co_name


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device")
    from turingcodec_tpu_torch.ops import inter, transform
    inter.picture_launches = transform.launches = 0
    check_13(args.device)
    if args.device == "cuda":
        check(inter.picture_launches and transform.launches,
              f"the 13-bit decode launched mc_picture "
              f"{inter.picture_launches} and dequant_idct "
              f"{transform.launches} times")
    check_raises(args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
