"""Set-up's seconds in the kernels' loaders: the host time of the
program's ``flygym.build.*`` spans (a kernel's hash, its nvcc build if it
is missing, its load) before the traced window, that is every call less the
window's own. None where the program keeps no spans."""


def read(r):
    try:
        from flygym_tpu_torch.utils.profiling import spans
    except ImportError:
        return None
    ns = sum(s["host_ns"] - sum(o.end_ns - o.start_ns for o in s["recorded"])
             for name, s in spans().items() if name.startswith("flygym.build."))
    return ns * 1e-9
