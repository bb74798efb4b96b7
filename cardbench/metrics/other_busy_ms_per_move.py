"""Device-busy milliseconds per self-play move outside the hex-conv kernels:
search, tree, env and the network's glue (``search/``, ``envs/scs/``,
``networks/blocks.py``)."""


def read(ctx):
    t = ctx.get("trace", {})
    if not t.get("kernels"):
        return None
    return (t["busy_s"] - t["hexconv_busy_s"]) * 1e3 / ctx["traced"]["units"]
