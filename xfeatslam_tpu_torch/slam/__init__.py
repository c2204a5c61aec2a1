"""SLAM host: map, tracking, local mapping, system."""
