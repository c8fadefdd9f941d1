"""Device operations per replay chunk: every kernel, copy and memset that
starts in the traced window over the chunks (one K-step launch each) the
window replayed. The replay loop and the batched runtime add the rest to
K2's one launch (the control sequence's clone and target write)."""


def read(r):
    chunks = r.work.get("chunks")
    return r.digest["device_ops"] / chunks if chunks else None
