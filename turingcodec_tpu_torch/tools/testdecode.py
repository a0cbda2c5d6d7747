"""CLI: conformance-corpus decode runner (`turing testdecode` analogue,
turing/testdecode.cpp:130-152).

Decodes every .hevc/.bin/.bit stream in a directory; if a sibling .md5 /
.yuv.md5 file exists, verifies the output YUV md5 against it. With no
corpus (none is bundled) it decodes every stream of tests/streams and
verifies each against tests/streams/GOLDEN.json, md5s cross-checked
against the reference decoder.

Usage: python -m turingcodec_tpu_torch.tools.testdecode [--corpus DIR]
           [--frames N] [--device {cuda,none,cpu}]

--device cuda (the default) decodes through the device pipeline on the
GPU and raises without one; none is the host path; cpu is the pipeline
through the kernels' plain versions. Exits 1 on any failure.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import pathlib
import re
import sys

STREAMS = pathlib.Path(__file__).resolve().parents[2] / "tests" / "streams"

# streams using tools the decoder does not implement yet (RExt etc.)
BLACKLIST = re.compile(r"(RExt|HIGHTHROUGHPUT|GENERAL_16b|WPP_[A-F]_hhi)",
                       re.IGNORECASE)


def decode_md5(path: pathlib.Path, frames=None, device="cuda") -> tuple:
    """(md5 of the decoded YUV, frames, picture-hash failures)."""
    import numpy as np

    from turingcodec_tpu_torch.decode.decoder import Decoder

    dec = Decoder(device=device)
    md5 = hashlib.md5()
    n = 0
    bd = None
    for f in dec.decode_stream(path.read_bytes(), max_frames=frames):
        if bd is None:
            bd = 8 if all(int(p.max(initial=0)) < 256 for p in f.planes) \
                else 10
        for p in f.planes:
            md5.update(p.astype(np.uint8).tobytes() if bd == 8
                       else p.astype("<u2").tobytes())
        n += 1
    return md5.hexdigest(), n, dec.hash_failures


def main(argv=None):
    ap = argparse.ArgumentParser(prog="turingcodec_tpu_torch testdecode")
    ap.add_argument("--corpus", default=None,
                    help="directory of conformance streams (+ .md5 files)")
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--device", choices=["cuda", "none", "cpu"],
                    default="cuda",
                    help="cuda (the default) = the device pipeline on the "
                         "GPU (raises without a GPU), none = host path, cpu "
                         "= the pipeline through the kernels' plain torch "
                         "versions")
    args = ap.parse_args(argv)
    device = None if args.device == "none" else args.device
    if device is not None:
        from turingcodec_tpu_torch.encode.device_analysis import (
            resolve_device)
        resolve_device(device)

    golden = {}
    if args.corpus:
        d = pathlib.Path(args.corpus)
        streams = []
        for ext in ("*.hevc", "*.bin", "*.bit"):
            streams += sorted(d.rglob(ext))
        streams = [s for s in streams if not BLACKLIST.search(s.name)]
    else:
        streams = sorted(STREAMS.glob("*.hevc"))
        golden = json.loads((STREAMS / "GOLDEN.json").read_text())

    failed = 0
    for s in streams:
        want = None
        for cand in (s.with_suffix(".md5"), s.with_suffix(s.suffix + ".md5"),
                     s.with_suffix(".yuv.md5")):
            if cand.exists():
                want = cand.read_text().strip().split()[0].lower()
                break
        if want is None:
            want = golden.get(s.name)
        try:
            got, n, hash_fail = decode_md5(s, args.frames, device)
        except Exception as e:
            print(f"FAIL  {s.name}: exception {type(e).__name__}: {e}")
            failed += 1
            continue
        if hash_fail:
            print(f"FAIL  {s.name}: {hash_fail} picture-hash mismatches")
            failed += 1
        elif want is None:
            print(f"?     {s.name}: {n} frames, md5 {got} (no golden)")
        elif got == want and (args.frames is None):
            print(f"ok    {s.name}: {n} frames")
        elif got == want:
            print(f"ok    {s.name}: {n} frames (truncated run)")
        else:
            print(f"FAIL  {s.name}: md5 {got} != {want}")
            failed += 1
    print(f"{len(streams) - failed}/{len(streams)} streams OK")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
