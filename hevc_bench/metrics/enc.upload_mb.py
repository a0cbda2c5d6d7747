"""Bytes the analysis stage sends to the card, MB (10^6 bytes) per coded
picture: the trace's enc.upload.pageable_bytes and .pinned_bytes over its
enc.docket pictures, in the profiled part of a traced encode."""
from hevc_bench.program_trace import per_picture


def read(run):
    v = per_picture(("enc.upload.pageable_bytes",
                     "enc.upload.pinned_bytes"), "enc.docket")
    return None if not v else v / 1e6
