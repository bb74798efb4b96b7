"""Host milliseconds an arena move spends in the span ``nuzero.arena.env``
(the eager SCS step, the frozen games' select, the lengths and the
terminal flags, ``Arena.play``), its self time over every arena move of
the run that no profiler recorded (``nuzero.arena.move`` calls)."""


def read(ctx):
    try:
        from nuzero_tpu_torch.utils.profiling import snapshot
    except ImportError:  # a program without spans
        return None
    spans = snapshot()
    units = spans.get("nuzero.arena.move", {}).get("calls", 0)
    if not units:
        return None
    return spans.get("nuzero.arena.env", {}).get("self_s", 0.0) * 1e3 / units
