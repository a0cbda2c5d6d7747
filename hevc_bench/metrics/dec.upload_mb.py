"""Bytes the decode sends to the card, MB (10^6 bytes) per decoded
picture: the trace's dec.upload.pageable_bytes (planes) and
.pinned_bytes (the loop filters' packed maps) over its dec.finish
pictures, in the profiled part of a traced decode."""
from hevc_bench.program_trace import per_picture


def read(run):
    v = per_picture(("dec.upload.pageable_bytes",
                     "dec.upload.pinned_bytes"), "dec.finish")
    return None if not v else v / 1e6
