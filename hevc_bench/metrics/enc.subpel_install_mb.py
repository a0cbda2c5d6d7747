"""Bytes the encode copies into the native core's subpel cache, MB (10^6
bytes) per coded picture: the 15 subpel planes of each list's reference
that the analysis stage computed (EncNative.install_subpel, counted by
the core as it copies them: enc.subpel.install_bytes), over the trace's
enc.docket pictures, in the profiled part of a traced encode. A program
without the counter reads nothing."""
from hevc_bench.program_trace import per_picture


def read(run):
    v = per_picture(("enc.subpel.install_bytes",), "enc.docket")
    return None if not v else v / 1e6
