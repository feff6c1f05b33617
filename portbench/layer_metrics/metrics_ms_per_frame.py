"""The port's "metrics" stage, ms a frame: its StageTimer seconds over the
stage-timed clip (the card synchronized at the end of every stage)."""


def read(ctx):
    stages = ctx.get("stages") or {}
    if "metrics" not in stages:
        return None
    return stages["metrics"] / ctx["frames"] * 1e3
