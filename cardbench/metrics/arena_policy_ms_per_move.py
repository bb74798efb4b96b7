"""Host milliseconds an arena move spends in the span ``nuzero.arena.policy``
(both seats' policy calls, ``Arena.play``), its self time over every arena
move of the run that no profiler recorded (``nuzero.arena.move`` calls)."""


def read(ctx):
    try:
        from nuzero_tpu_torch.utils.profiling import snapshot
    except ImportError:  # a program without spans
        return None
    spans = snapshot()
    units = spans.get("nuzero.arena.move", {}).get("calls", 0)
    if not units:
        return None
    return spans.get("nuzero.arena.policy", {}).get("self_s", 0.0) * 1e3 / units
