"""The card's time per env step after the physics: the mean over the
traced window's ``flygym.env.step`` spans of the stream's time (CUDA events
the program records) from its ``flygym.env.advance`` child's exit to its own
exit: reward, observations, odor and vision, and the waits between them.
None without those events (the CPU, or a program that keeps no spans)."""


def read(r):
    try:
        from flygym_tpu_torch.utils.profiling import elapsed_ms, spans
    except ImportError:
        return None
    s = spans()
    advance = {id(o.parent): o for o in s.get("flygym.env.advance", {}).get("recorded", ())}
    ms = []
    for step in s.get("flygym.env.step", {}).get("recorded", ()):
        adv = advance.get(id(step))
        t = None if adv is None else elapsed_ms(adv.end_event, step.end_event)
        if t is None:
            return None
        ms.append(t)
    return sum(ms) / len(ms) if ms else None
