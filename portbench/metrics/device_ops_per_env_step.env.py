"""Device operations per env step: every kernel, copy and memset that
starts in the traced window over the env steps the window ran (resets
included in the operations, not in the steps)."""


def read(r):
    steps = r.work.get("env_steps")
    return r.digest["device_ops"] / steps if steps else None
