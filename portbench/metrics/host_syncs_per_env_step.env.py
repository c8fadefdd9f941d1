"""The host's synchronisations with the card per env step: every
synchronising CUDA call (PyTorch's sync debug mode) the program's
``flygym.*`` spans made in the traced window, over the env steps the window
ran (resets' syncs included). None where the program keeps no spans."""


def read(r):
    try:
        from flygym_tpu_torch.utils.profiling import spans
    except ImportError:
        return None
    steps = r.work.get("env_steps")
    if not steps:
        return None
    return sum(o.syncs for s in spans().values() for o in s["recorded"]) / steps
