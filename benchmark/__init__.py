"""The benchmark of xfeatslam_tpu_torch (see README.md)."""
