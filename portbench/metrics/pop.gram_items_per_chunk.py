"""pop.gram_items_per_chunk: the items of a chunk of Grams in the
population program (``grams.items`` over ``grams.chunks``, counted in
``models/fit._cell_grams`` inside ``collect_spans``) over the untraced
requests of a traced run: how many (cell, trial) items one batched
launch holds under ``ladder_items``' memory budget.  Layer: the
population's chunks of Grams (``parallel/population.ladder_items``).
Moves ``fit_s``."""

UNIT = "items"


def read(ctx):
    spans = ctx.get("spans", {})
    chunks, items = spans.get("grams.chunks"), spans.get("grams.items")
    if not ctx.get("requests") or not chunks or items is None:
        return None
    return items / chunks
