"""Host milliseconds a self-play move spends in the span
``nuzero.selfplay.settle`` (``AlphaZero._settle``: the host read of a
move-batch's finished count, which waits for the card), its self time over
every move of the run that no profiler recorded
(``nuzero.selfplay.launch`` calls)."""


def read(ctx):
    try:
        from nuzero_tpu_torch.utils.profiling import snapshot
    except ImportError:  # a program without spans
        return None
    spans = snapshot()
    units = spans.get("nuzero.selfplay.launch", {}).get("calls", 0)
    if not units:
        return None
    return spans.get("nuzero.selfplay.settle", {}).get("self_s", 0.0) * 1e3 / units
