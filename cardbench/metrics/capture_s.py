"""Seconds of set-up spent capturing the self-play move's CUDA graph
(``training/selfplay.py:capture_selfplay_step`` through
``AlphaZero._mover``), its warm-up move included."""


def read(ctx):
    return ctx.get("capture_s")
