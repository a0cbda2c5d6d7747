"""The encode's serial host work, ms per coded picture: each picture's
enc.docket span less its CTU walk (enc.ctu_walk) and the analysis
stage's device fields and rank tables (enc.fields, enc.rank_tables):
preparing the picture, the loop filters, writing the slices, the MD5
SEI and finishing, in the profiled part of a traced encode."""
from hevc_bench.program_trace import ms_per_picture


def read(run):
    whole = ms_per_picture(("enc.docket",), "enc.docket")
    if whole is None:
        return None
    return whole - (ms_per_picture(("enc.ctu_walk", "enc.fields",
                                    "enc.rank_tables"), "enc.docket") or 0.0)
