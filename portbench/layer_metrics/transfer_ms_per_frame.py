"""Host-to-card upload plus card-to-host copy of a clip's frames and
scores, ms a frame (host clock, the card synchronized around each)."""


def read(ctx):
    if "transfer_s" not in ctx:
        return None
    return ctx["transfer_s"] / ctx["frames"] * 1e3
