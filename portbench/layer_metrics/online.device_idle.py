"""The card's idle share inside the traced online frames' spans (each
``process`` call, start to return; the gaps between arrivals not
counted), in %."""


def read(ctx):
    summary = ctx.get("summary")
    if summary is None or ctx["loop"] != "open" or summary["region_s"] <= 0:
        return None
    return 100.0 * (1.0 - summary["region_busy_s"] / summary["region_s"])
