"""The least time the roofline allows for the whole traced steps'
paged-attention calls (one a layer; each distinct K/V page read once, q in
and the context out, 4 x rows x context x head_dim x heads operations)
over the paged-attention kernels' device time in the same steps, in
percent.  A step is whole when the trace holds a device record for every
launch it made (``harness.read_events``)."""
from perfbench import yardstick


def read(ctx):
    if ctx.trace is None or ctx.peak is None or not ctx.trace["steps"]:
        return None
    kernel_s = sum(e - s for name, s, e in ctx.trace["kernels"]
                   if yardstick.family(name) == "paged_attention") / 1e6
    if not kernel_s:
        return None
    bound = 0.0
    for st in ctx.trace["steps"]:
        flops, nbytes = yardstick.paged_attention_call(
            ctx.model, st.positions, st.row_of, st.block_tables,
            ctx.page_size)
        bound += (ctx.model["num_hidden_layers"]
                  * yardstick.roofline_s(flops, nbytes, ctx.peak))
    return 100.0 * bound / kernel_s
