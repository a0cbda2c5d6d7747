"""Device pipeline stages, ms per picture: the pipeline trace's mc,
residual, deblock, sao and pull stages (the card synchronised at each)
over the pictures through the pipeline."""

STAGES = ("mc", "residual", "deblock", "sao", "pull")


def read(run):
    st = getattr(run, "state", None)
    stages = getattr(st, "stages", None)
    if not stages or not st.pipeline_pictures:
        return None
    return 1e3 * sum(stages.get(s, 0.0) for s in STAGES) \
        / st.pipeline_pictures
