"""Version of ray_tpu_torch.

Reference analog: python/ray/_version.py (version string consumed by
python/ray/__init__.py:82).
"""

version = "0.1.0"
