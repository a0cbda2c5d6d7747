"""Parse and dispatch, ms per picture: each traced picture's decode call
less the device pipeline's traced stages (mc, residual, intra, deblock,
sao, pull)."""


def read(run):
    st = getattr(run, "state", None)
    stages = getattr(st, "stages", None)
    if not stages or not st.times:
        return None
    return 1e3 * (sum(st.times) - sum(stages.values())) / len(st.times)
