"""Host milliseconds a self-play move spends in the span
``nuzero.selfplay.replay`` (``AlphaZero._launch`` around ``move()``: on
the card the replay of the move's CUDA graph, ``cudaGraphLaunch``), its
self time over every move of the run that no profiler recorded
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
    return spans.get("nuzero.selfplay.replay", {}).get("self_s", 0.0) * 1e3 / units
