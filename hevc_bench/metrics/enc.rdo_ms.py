"""Host RDO and entropy coding, ms per picture: each traced picture's
push_frame less its analysis spans."""


def read(run):
    pics = run.spans.get("enc.picture")
    if not pics:
        return None
    return 1e3 * (run.total("enc.picture") - run.total("enc.analysis")) \
        / len(pics)
