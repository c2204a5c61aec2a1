"""Pose optimization and the per-frame tracking step."""
