"""The whole step's share of the chips' float32 peak over the profiled
part of the traced window: XFeat's conv FLOPs for each of its frames plus
the matcher's valid-pair products, over its length and the peak of every
chip used, in %."""

from benchmark import counts


def read(rec):
    r = rec.ranks[0] if rec.ranks else None
    if not r or not rec.counts:
        return None
    done = rec.counts[:r["batches"]]
    flops = (len(done) * rec.batch * counts.conv_flops(rec.net_hw)
             + sum(counts.match_ops(c) for c in done))
    return 100.0 * flops / r["window_s"] / (rec.chips
                                             * rec.peaks["fp32_flops"])
