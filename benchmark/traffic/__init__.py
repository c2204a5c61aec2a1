"""The benchmark's traffic generator."""
