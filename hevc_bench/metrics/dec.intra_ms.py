"""Host intra with its pull and push, ms per picture: the pipeline
trace's intra stage over the pictures through the pipeline."""


def read(run):
    st = getattr(run, "state", None)
    stages = getattr(st, "stages", None)
    if not stages or not st.pipeline_pictures:
        return None
    return 1e3 * stages.get("intra", 0.0) / st.pipeline_pictures
