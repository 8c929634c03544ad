"""The trainer's ``update`` section (``Trainer._ring_step``: the host's
enqueue of draw, gather and update, and whatever it blocks on) per
step, over the measured window."""


def read(ctx):
    (s0, n0), (s1, n1) = ctx["opened"]["update"], ctx["closed"]["update"]
    if n1 <= n0:
        return None
    return {"value": 1e3 * (s1 - s0) / (n1 - n0)}
