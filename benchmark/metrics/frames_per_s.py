"""Frames whose answers reached the host, over the whole window."""


def read(rec):
    return rec.frames / rec.window_s
