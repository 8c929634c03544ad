"""Trained samples (windows x forward_steps, burn-in excluded) of the
steps the device finished in the window, over the window's wall time."""


def read(ctx):
    return {"value": ctx["steps"] * ctx["samples_per_step"]
            / ctx["window_s"]}
