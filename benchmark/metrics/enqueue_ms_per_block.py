"""Host milliseconds a block in the dispatch layer: the batched
receiver's `_dispatch_batch` without the preparation nested in it (the
packed upload and the enqueue of the correlator, the coherent sums, the
scorer and the fetch), from the harness's wrappers, over the blocks of the
traced window."""


def read(ctx):
    blocks = ctx.counts.get("blocks")
    if not blocks or not ctx.span_count("receiver._dispatch_batch"):
        return None
    return 1e3 * (ctx.span_s("receiver._dispatch_batch")
                  - ctx.span_s("receiver._prepare_batch")) / blocks
