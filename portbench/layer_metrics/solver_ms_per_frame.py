"""The port's "solver" stage, ms a frame: its StageTimer seconds over the
stage-timed clip (the card synchronized at the end of every stage)."""


def read(ctx):
    stages = ctx.get("stages") or {}
    if "solver" not in stages:
        return None
    return stages["solver"] / ctx["frames"] * 1e3
