"""Set-up's seconds in loading and building the program's objects: the
self time (child spans, the kernels' builds among them, left out) of the
program's ``flygym.setup.*`` spans (the world's load, the simulation's and
the env's construction) before the traced window. None where the program
keeps no spans."""


def read(r):
    try:
        from flygym_tpu_torch.utils.profiling import spans
    except ImportError:
        return None
    ns = sum(s["self_ns"] - sum(o.self_ns for o in s["recorded"])
             for name, s in spans().items() if name.startswith("flygym.setup."))
    return ns * 1e-9
