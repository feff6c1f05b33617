"""Device memory the stabilizer's CUDA graph pool holds after the window
(``GraphRunner.pool_bytes()``), GiB."""


def read(ctx):
    pool = ctx.get("pool_bytes")
    if pool is None:
        return None
    return pool / 2**30
