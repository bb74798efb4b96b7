"""Host milliseconds a self-play move spends in the span
``nuzero.replay.add_games`` (the finished games' insert into the replay
ring, ``AlphaZero._launch``), its self time over every move of the run
that no profiler recorded (``nuzero.selfplay.launch`` calls)."""


def read(ctx):
    try:
        from nuzero_tpu_torch.utils.profiling import snapshot
    except ImportError:  # a program without spans
        return None
    spans = snapshot()
    units = spans.get("nuzero.selfplay.launch", {}).get("calls", 0)
    if not units:
        return None
    return spans.get("nuzero.replay.add_games", {}).get("self_s", 0.0) * 1e3 / units
