"""Analysis stage, ms per picture: the spans around the encoder's three
analysis entry points (install_seed_fields, install_subpel_fields,
rank_satd_tables_device), each ending in a synchronise, over the traced
window's pictures."""


def read(run):
    pics = run.spans.get("enc.picture")
    if not pics:
        return None
    return 1e3 * run.total("enc.analysis") / len(pics)
