"""Device ms per batch of the NCCL kernels (the mesh's gathers) in rank
0's trace."""


def read(rec):
    r = rec.ranks[0] if rec.ranks else None
    if rec.chips < 2 or not r:
        return None
    return 1e3 * r["nccl_s"] / r["batches"]
