"""The decode loop's share of the chip's bf16 peak: model FLOPs of every
request the window completed (2 FLOPs a multiply-add of the active
parameters, attention over the cache, the LM head where its logits are
used), over the window's wall time, in percent."""


def read(ctx):
    if ctx["window_s"] <= 0:
        return None
    return 100.0 * ctx["window_flops"] / ctx["window_s"] / ctx["bf16_flops_per_s"]
