"""Seconds of set-up inside the span ``nuzero.selfplay.capture``
(``AlphaZero._mover`` around ``capture_selfplay_step``: the warm-up move
and the capture of the move's CUDA graph), its total over the run."""


def read(ctx):
    try:
        from nuzero_tpu_torch.utils.profiling import snapshot
    except ImportError:  # a program without spans
        return None
    capture = snapshot().get("nuzero.selfplay.capture", {})
    if not capture.get("calls"):
        return None
    return capture["total_s"]
