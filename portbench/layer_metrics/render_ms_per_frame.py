"""The port's "warp+crop" stage, ms a frame: its StageTimer seconds over the
stage-timed clip (the card synchronized at the end of every stage)."""


def read(ctx):
    stages = ctx.get("stages") or {}
    if "warp+crop" not in stages:
        return None
    return stages["warp+crop"] / ctx["frames"] * 1e3
