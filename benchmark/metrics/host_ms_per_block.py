"""Host milliseconds a block in the receiver layer: the batched
receiver's float64 preparation (`_prepare_batch`) and drain
(`_drain_batch`, the measurement updates and the steering, with its wait
for the fetch), from the harness's wrappers, over the blocks of the traced
window."""


def read(ctx):
    blocks = ctx.counts.get("blocks")
    if not blocks or not ctx.span_count("receiver._prepare_batch"):
        return None
    return 1e3 * (ctx.span_s("receiver._prepare_batch")
                  + ctx.span_s("receiver._drain_batch")) / blocks
