"""Faults planted under the timed path, each a hook that the harness calls
with a rank's session (``"benchmark.tests.faults:<name>"``)."""

import torch


def _wrap(sess, make):
    sess.entry.step = make(sess.entry.step)
    real = sess.entry.traced_step
    sess.entry.traced_step = lambda x, mark: make(lambda y: real(y, mark))(x)


def stale(sess):
    """Each batch gets the answers of the batch before it: a step that
    hands back its state unchanged."""
    last = {}

    def make(fn):
        def step(x):
            out = fn(x)
            prev = last.get("out", out)
            last["out"] = out
            return prev
        return step
    _wrap(sess, make)


def half(sess):
    """Only the first half of each batch is run; the rest come back empty."""
    def make(fn):
        def step(x):
            h = x.shape[0] // 2
            out = fn(x[:h])
            full = {}
            for k, v in out.items():
                n = x.shape[0] - (1 if k.startswith("match") else 0)
                fill = {"match_idx": -1, "match_dist": float("inf")}.get(k, 0)
                pad = torch.full((n - v.shape[0],) + v.shape[1:], fill,
                                 dtype=v.dtype, device=v.device)
                full[k] = torch.cat([v, pad])
            return full
        return step
    _wrap(sess, make)


def altered(sess):
    """One match of each batch points at another keypoint: the first
    matched row of the first pair that has one, sent to the valid column
    least like it."""
    def make(fn):
        def step(x):
            out = fn(x)
            p, i = torch.nonzero(out["match_mask"])[0].tolist()
            sim = out["desc"][p + 1] @ out["desc"][p, i]
            sim = sim.masked_fill(~out["valid"][p + 1].bool(), float("inf"))
            idx = out["match_idx"].clone()
            idx[p, i] = int(sim.argmin())
            out["match_idx"] = idx
            return out
        return step
    _wrap(sess, make)


def no_exchange(sess):
    """The mesh's gathers left out: each rank keeps its own rows in their
    place and zeros for the other ranks'."""
    mesh = sess.entry.mesh

    def gather(x):
        n, r, b = mesh.shape["data"], mesh.coords[0], x.shape[0]
        out = torch.zeros((n * b,) + x.shape[1:], dtype=x.dtype,
                          device=x.device)
        out[r * b:(r + 1) * b] = x
        return out
    mesh.gather_batch = gather
